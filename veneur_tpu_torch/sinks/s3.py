"""S3 sink: one (optionally gzipped) TSV object per flush.

Capability twin of `sinks/s3/s3.go` (`s3.go:33,104`): each flush encodes
all InterMetrics with the shared TSV encoder (`util/csv.go`, here
`sinks.simple.encode_tsv_row`) and uploads one object keyed
`<prefix>/<hostname>/<date>/<timestamp>.tsv[.gz]`.

The port's copy of `veneur_tpu.sinks.s3`.  Like cloudwatch, the
uploader is an injection point: `put_object(bucket, key, body_bytes)`
(tests inject a recorder).  Without one, start() builds SigV4-signed PUTs
over the standard library (`util/awsauth.py`) from the sink config's
credentials or the AWS_* environment, to `aws_endpoint` when it is set.
The JAX package first tries boto3's credential chain when the config
names neither credentials nor an endpoint; the port uses no boto3.
Encoding — the testable contract — is transport-independent.
"""

from __future__ import annotations

import datetime
import gzip
import io
import logging
import time
from typing import Callable, Optional

from veneur_tpu_torch import sinks as sink_mod
from veneur_tpu_torch.sinks.simple import encode_tsv_row
from veneur_tpu_torch.util import awsauth

logger = logging.getLogger("veneur_tpu_torch.sinks.s3")


def _sigv4_uploader(cfg: dict):
    """Build a `put_object(bucket, key, body)` doing SigV4-signed HTTP
    PUTs straight to S3 (or an `aws_endpoint` override for minio/tests).
    Returns None without credentials."""
    creds = awsauth.Credentials.resolve(cfg)
    if creds is None:
        return None
    region = cfg.get("aws_region") or "us-east-1"
    endpoint = (cfg.get("aws_endpoint") or "").rstrip("/")
    sessions = sink_mod.ParallelPoster(max_workers=1)

    def put(bucket, key, body):
        base = endpoint or f"https://{bucket}.s3.{region}.amazonaws.com"
        path_prefix = f"/{bucket}" if endpoint else ""
        url = f"{base}{path_prefix}/{key}"
        headers = awsauth.sign_request(
            "PUT", url, {"content-type": "application/octet-stream"},
            body, creds, region, "s3")
        resp = sessions.session().put(url, data=body, headers=headers,
                                      timeout=30)
        resp.raise_for_status()

    return put


@sink_mod.register_metric_sink("s3")
class S3MetricSink(sink_mod.BaseMetricSink):
    KIND = "s3"

    def __init__(self, spec: Optional[sink_mod.SinkSpec] = None,
                 server_config=None, put_object: Optional[Callable] = None):
        spec = spec or sink_mod.SinkSpec(kind=self.KIND)
        super().__init__(spec.name, spec.config)
        cfg = self.config
        self.bucket = cfg.get("aws_s3_bucket", "")
        self.prefix = cfg.get("key_prefix", "veneur").strip("/")
        self.compress = bool(cfg.get("compress", True))
        self.hostname = getattr(server_config, "hostname", "") or ""
        self.interval_s = float(
            getattr(server_config, "interval", 10.0) or 10.0)
        self.put_object = put_object
        self._warned = False

    def start(self, trace_client=None) -> None:
        if self.put_object is not None:
            return
        # the real path: SigV4-signed PUTs (util/awsauth.py)
        self.put_object = _sigv4_uploader(self.config)
        if self.put_object is None and not self._warned:
            logger.warning(
                "s3 sink %s: no uploader injected and no AWS credentials "
                "configured; metrics will be dropped", self._name)
            self._warned = True

    def object_key(self, now: Optional[float] = None) -> str:
        now = now if now is not None else time.time()
        dt = datetime.datetime.fromtimestamp(now, datetime.timezone.utc)
        ext = "tsv.gz" if self.compress else "tsv"
        return (f"{self.prefix}/{self.hostname or 'unknown'}/"
                f"{dt:%Y-%m-%d}/{int(now)}.{ext}")

    def encode(self, metrics, now: Optional[float] = None) -> bytes:
        now = now if now is not None else time.time()
        date = datetime.datetime.fromtimestamp(
            now, datetime.timezone.utc).strftime("%Y-%m-%d")
        buf = io.StringIO()
        for m in metrics:
            buf.write(encode_tsv_row(m, self.hostname, self.interval_s,
                                     date))
            buf.write("\n")
        body = buf.getvalue().encode()
        return gzip.compress(body) if self.compress else body

    def flush(self, metrics):
        if not metrics:
            return sink_mod.MetricFlushResult()
        if self.put_object is None:
            return sink_mod.MetricFlushResult(dropped=len(metrics))
        now = time.time()
        try:
            self.put_object(self.bucket, self.object_key(now),
                            self.encode(metrics, now))
        except Exception as e:
            logger.warning("s3 put_object failed: %s", e)
            return sink_mod.MetricFlushResult(dropped=len(metrics))
        return sink_mod.MetricFlushResult(flushed=len(metrics))

