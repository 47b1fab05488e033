"""Wire protocol: the generated protobuf modules of the forward path.

The .proto files under protos/ are wire-compatible twins of the
reference's schemas (tdigest/tdigest.proto,
samplers/metricpb/metric.proto, forwardrpc/forward.proto,
protocol/dogstatsd/grpc.proto).  The generated Python in gen/ is the
JAX package's, with its package-rooted imports pointed here; the
serialized descriptors keep the wire's own file names and proto
packages, so both packages' copies register alike in protobuf's
default pool and can load into one process.  The SSF schemas come
with SSF ingest.
"""

from veneur_tpu_torch.protocol.gen.tdigest import tdigest_pb2
from veneur_tpu_torch.protocol.gen.metricpb import metric_pb2
from veneur_tpu_torch.protocol.gen.forwardrpc import forward_pb2
from veneur_tpu_torch.protocol.gen.dogstatsd import grpc_pb2 as dogstatsd_grpc_pb2

__all__ = ["tdigest_pb2", "metric_pb2", "forward_pb2", "dogstatsd_grpc_pb2"]
