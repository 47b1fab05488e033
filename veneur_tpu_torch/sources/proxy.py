"""gRPC import source: the global tier's receive path.

Counterpart of `veneur_tpu.sources.proxy` (the reference's
`sources/proxy/server.go`): a `forwardrpc.Forward` service whose
`SendMetricsV2` recv-loop feeds each metric into the aggregator
(`server.go:144-162`), registered when `grpc_address` is set
(`server.go:673-682`).  `SendMetrics` (V1), which the reference leaves
UNIMPLEMENTED (`server.go:138-142`), takes a whole MetricList in one
call, through the dedup ledger when the sender names the chunk: the
fleet-internal batch path, a strict superset, since reference senders
only call V2.  Also served: dogstatsd `SendPacket`
(`networking.go:347`) and the gRPC health check.  `SendSpan` (SSF over
gRPC) is not registered and answers UNIMPLEMENTED until SSF ingest is
ported (ROADMAP A15).

gRPC's default 4 MiB receive limit is kept, as the JAX package keeps
it; the port's client sizes its V1 chunks under it (ROADMAP C14).
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import logging
import threading
import time
from typing import Callable, Optional

import grpc
from google.protobuf import empty_pb2

from veneur_tpu_torch.forward import convert
from veneur_tpu_torch.forward.client import CHUNK_ID_KEY, parse_chunk_id
from veneur_tpu_torch.protocol import dogstatsd_grpc_pb2, metric_pb2

logger = logging.getLogger("veneur_tpu_torch.sources.proxy")

# worker threads of the import server: each long-lived client stream
# pins one for its life, so the pool is sized for a fleet of senders,
# not for short RPCs
MAX_WORKERS = 64


class DedupLedger:
    """Bounded per-source ledger of imported chunk identities: a chunk
    delivered twice (a retry after an ambiguous timeout, a spool replay
    after a crash on either side) merges once.

    `run_once(ident, import_fn)` reserves the identity under the ledger
    lock, runs the import outside it (concurrent V1 payloads keep
    parsing in parallel) and releases the reservation if the import
    fails, so a failed delivery can retry.  A second delivery of a chunk
    whose first is still importing waits for it.  The checkpoint writer
    takes `paused()` around its cut: new imports block and the ones in
    flight drain first, so a checkpoint never holds a chunk's data
    without its identity, or the reverse.  `snapshot()` and `restore()`
    carry the ledger through the checkpoint.  The window is a
    per-source FIFO of `window` identities, oldest evicted."""

    def __init__(self, window: int = 4096):
        self.window = max(16, int(window))
        self._cond = threading.Condition()
        # source -> (deque of idents in arrival order, set of them)
        self._sources: dict = {}
        self._active = 0            # imports between reserve and finish
        self._inflight: set = set()     # reserved, not yet settled
        self._paused = False        # a checkpoint cut in progress
        self.recorded = 0
        self.duplicates = 0

    def _seen_locked(self, ident: tuple) -> bool:
        entry = self._sources.get(ident[0])
        return entry is not None and ident in entry[1]

    def _record_locked(self, ident: tuple) -> None:
        entry = self._sources.get(ident[0])
        if entry is None:
            entry = self._sources[ident[0]] = (collections.deque(), set())
        dq, seen = entry
        if ident in seen:
            return
        dq.append(ident)
        seen.add(ident)
        if len(dq) > self.window:
            seen.discard(dq.popleft())
        self.recorded += 1

    def _unrecord_locked(self, ident: tuple) -> None:
        entry = self._sources.get(ident[0])
        if entry is None or ident not in entry[1]:
            return
        entry[1].discard(ident)
        try:
            entry[0].remove(ident)
        except ValueError:
            pass
        self.recorded -= 1

    def run_once(self, ident: Optional[tuple], import_fn):
        """Run `import_fn()` once per identity.  Returns (result,
        duplicate); on a duplicate the import is skipped and result is
        None.  ident None (an unidentified sender) always imports, after
        any checkpoint cut in progress."""
        with self._cond:
            if ident is None:
                while self._paused:
                    self._cond.wait()
            else:
                # wait out a checkpoint cut and an import of the same
                # identity in flight: a duplicate must not be acked
                # while the original could still fail
                while self._paused or ident in self._inflight:
                    self._cond.wait()
                if self._seen_locked(ident):
                    self.duplicates += 1
                    logger.info("dedup: skipping duplicate chunk %s",
                                ident)
                    return None, True
                self._record_locked(ident)
                self._inflight.add(ident)
            self._active += 1
        try:
            result = import_fn()
        except BaseException:
            with self._cond:
                if ident is not None:
                    self._unrecord_locked(ident)
                    self._inflight.discard(ident)
                self._active -= 1
                self._cond.notify_all()
            raise
        with self._cond:
            if ident is not None:
                self._inflight.discard(ident)
            self._active -= 1
            self._cond.notify_all()
        return result, False

    @contextlib.contextmanager
    def paused(self):
        """The checkpoint cut: block new imports and drain the ones in
        flight, so the ledger and the aggregator snapshot as one."""
        with self._cond:
            while self._paused:         # one cut at a time
                self._cond.wait()
            self._paused = True
            while self._active > 0:
                self._cond.wait()
        try:
            yield
        finally:
            with self._cond:
                self._paused = False
                self._cond.notify_all()

    def snapshot(self) -> dict:
        """JSON-able state for the checkpoint (the JAX package's layout).
        A coherent cut takes it inside `paused()`, with the aggregator's
        snapshot."""
        with self._cond:
            return {
                "window": self.window,
                "sources": {
                    src: [[s, int(e), int(i)] for (s, e, i) in dq]
                    for src, (dq, _) in self._sources.items()},
            }

    def restore(self, state: dict) -> None:
        with self._cond:
            for idents in (state.get("sources") or {}).values():
                for s, e, i in idents:
                    self._record_locked((str(s), int(e), int(i)))

    def stats(self) -> dict:
        with self._cond:
            return {"recorded": self.recorded,
                    "duplicates": self.duplicates,
                    "sources": len(self._sources), "window": self.window}


class GrpcImportServer:
    """Hosts forwardrpc.Forward, dogstatsd.DogstatsdGRPC and the health
    check on one grpc.Server.

    `import_metric(ForwardMetric)` takes each V2 message;
    `import_payload(bytes) -> (imported, failed)` takes a whole V1
    MetricList's bytes in one call.  A metric that fails to import is
    counted in `import_errors` and never ends its stream or batch."""

    def __init__(self, address: str,
                 import_metric: Callable[[object], None],
                 import_payload: Callable[[bytes], tuple],
                 handle_packet: Optional[Callable[[bytes], None]] = None,
                 dedup: Optional[DedupLedger] = None):
        self.import_metric = import_metric
        self.import_payload = import_payload
        self.handle_packet = handle_packet
        self.dedup = dedup
        self.imported_count = 0
        self.import_errors = 0
        # seconds in import_payload (decode and import of V1 batches,
        # summed over concurrent RPCs)
        self.import_s = 0.0
        self._count_lock = threading.Lock()
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=MAX_WORKERS, thread_name_prefix="grpc-import")
        self.server = grpc.server(self._executor)
        self.server.add_generic_rpc_handlers(self._handlers())
        self.port = self.server.add_insecure_port(address)
        if self.port == 0:
            # grpc returns 0 instead of raising (server.go:673-682 fails
            # startup here)
            raise OSError(f"could not bind gRPC import server to {address}")

    def _count(self, imported: int, failed: int) -> None:
        with self._count_lock:
            self.imported_count += imported
            self.import_errors += failed

    def _import_v1(self, request: bytes) -> int:
        t0 = time.perf_counter()
        count, failed = self.import_payload(request)
        if failed:
            logger.error("failed to import %d metrics of a V1 batch",
                         failed)
        with self._count_lock:
            self.import_errors += failed
            self.import_s += time.perf_counter() - t0
        return count

    def _send_metrics(self, request: bytes, context):
        ident = None
        for key, value in context.invocation_metadata() or ():
            if key == CHUNK_ID_KEY:
                ident = parse_chunk_id(value)
        count, duplicate = (
            (self._import_v1(request), False) if self.dedup is None
            else self.dedup.run_once(ident,
                                     lambda: self._import_v1(request)))
        if not duplicate:
            self._count(count, 0)
        return empty_pb2.Empty()

    def _send_metrics_v2(self, request_iterator, context):
        count = failed = 0
        for pb in request_iterator:
            try:
                self.import_metric(convert.from_pb(pb))
                count += 1
            except Exception as e:   # noqa: BLE001 - one metric fails alone
                failed += 1
                logger.error("failed to import metric %s: %s", pb.name, e)
        self._count(count, failed)
        return empty_pb2.Empty()

    def _send_packet(self, request, context):
        self.handle_packet(request.packetBytes)
        return dogstatsd_grpc_pb2.Empty()

    @staticmethod
    def _health_check(request: bytes, context) -> bytes:
        """grpc.health.v1 Health/Check (the reference serves "veneur",
        networking.go:377-384): request field 1 is the service name, a
        SERVING response is field 1 varint 1; another name gets
        NOT_FOUND."""
        service = ""
        if len(request) >= 2 and request[0] == 0x0A:
            n, shift, i = 0, 0, 1
            while i < len(request):
                b = request[i]
                n |= (b & 0x7F) << shift
                i += 1
                if not b & 0x80:
                    break
                shift += 7
            service = request[i:i + n].decode(errors="replace")
        if service not in ("", "veneur"):
            context.abort(grpc.StatusCode.NOT_FOUND,
                          f"unknown service {service!r}")
        return b"\x08\x01"

    def _handlers(self) -> list:
        empty = empty_pb2.Empty.SerializeToString
        handlers = [
            grpc.method_handlers_generic_handler("forwardrpc.Forward", {
                "SendMetrics": grpc.unary_unary_rpc_method_handler(
                    self._send_metrics, request_deserializer=lambda b: b,
                    response_serializer=empty),
                "SendMetricsV2": grpc.stream_unary_rpc_method_handler(
                    self._send_metrics_v2,
                    request_deserializer=metric_pb2.Metric.FromString,
                    response_serializer=empty)}),
            grpc.method_handlers_generic_handler("grpc.health.v1.Health", {
                "Check": grpc.unary_unary_rpc_method_handler(
                    self._health_check, request_deserializer=lambda b: b,
                    response_serializer=lambda b: b)})]
        if self.handle_packet is not None:
            handlers.append(grpc.method_handlers_generic_handler(
                "dogstatsd.DogstatsdGRPC", {
                    "SendPacket": grpc.unary_unary_rpc_method_handler(
                        self._send_packet,
                        request_deserializer=(
                            dogstatsd_grpc_pb2.DogstatsdPacket.FromString),
                        response_serializer=(
                            dogstatsd_grpc_pb2.Empty.SerializeToString))}))
        return handlers

    def start(self) -> None:
        self.server.start()

    def stop(self) -> None:
        """Stop serving, give in-flight RPCs a second to finish, and
        release the worker threads."""
        self.server.stop(1.0).wait()
        self._executor.shutdown(wait=False)
