"""Cortex sink: Prometheus remote-write (snappy + protobuf WriteRequest).

The port's copy of `veneur_tpu.sinks.cortex`, posting through the
standard library (`sinks.ParallelPoster`'s per-thread sessions;
`session=` injects one for tests).  Capability twin of `sinks/cortex/cortex.go` (`cortex.go:43,194`): each flush
serializes the InterMetrics into a `prometheus.WriteRequest`, snappy-
compresses it, and POSTs with the remote-write headers; supports basic
auth, bearer token, and custom headers.

The WriteRequest protobuf (public prometheus/prompb schema) is tiny, so we
hand-encode it rather than generating stubs:

    WriteRequest { repeated TimeSeries timeseries = 1; }
    TimeSeries   { repeated Label labels = 1; repeated Sample samples = 2; }
    Label        { string name = 1; string value = 2; }
    Sample       { double value = 1; int64 timestamp = 2; }  // ms epoch

Label names are sanitized to the Prometheus charset and duplicate labels
deduplicated last-wins, matching the reference's sanitation pass.
"""

from __future__ import annotations

import logging
import re
import struct
from typing import Optional

from veneur_tpu_torch import sinks as sink_mod
from veneur_tpu_torch.util import snappy

logger = logging.getLogger("veneur_tpu_torch.sinks.cortex")

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_FIRST_RE = re.compile(r"^[^a-zA-Z_:]")


def sanitize_label(name: str) -> str:
    name = _NAME_RE.sub("_", name)
    if _FIRST_RE.match(name):
        name = "_" + name[1:]
    return name


def _tag_field(field_num: int, data: bytes) -> bytes:
    out = bytearray()
    key = (field_num << 3) | 2  # length-delimited
    while key >= 0x80:
        out.append((key & 0x7F) | 0x80)
        key >>= 7
    out.append(key)
    n = len(data)
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out) + data


def _varint_field(field_num: int, value: int) -> bytes:
    out = bytearray([(field_num << 3) | 0])
    if value < 0:
        value += 1 << 64
    while value >= 0x80:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def _label(name: str, value: str) -> bytes:
    return _tag_field(1, name.encode()) + _tag_field(2, value.encode())


def encode_write_request(metrics, default_labels: dict[str, str]) -> bytes:
    """InterMetrics -> serialized prometheus WriteRequest."""
    body = bytearray()
    for m in metrics:
        labels: dict[str, str] = {"__name__": sanitize_label(m.name)}
        labels.update(default_labels)
        for t in m.tags:
            if ":" in t:
                k, v = t.split(":", 1)
            else:
                k, v = t, "true"
            labels[sanitize_label(k)] = v
        if m.hostname and "hostname" not in labels:
            labels["hostname"] = m.hostname
        ts = bytearray()
        # prometheus requires labels sorted by name — bytewise over ALL
        # labels ("Foo" sorts before "__name__")
        for k in sorted(labels):
            ts += _tag_field(1, _label(k, labels[k]))
        # Sample.value: field 1, wire type 1 (fixed64 double)
        sample = bytes([(1 << 3) | 1]) + struct.pack("<d", float(m.value))
        sample += _varint_field(2, int(m.timestamp) * 1000)
        ts += _tag_field(2, sample)
        body += _tag_field(1, bytes(ts))
    return bytes(body)


@sink_mod.register_metric_sink("cortex")
class CortexMetricSink(sink_mod.BaseMetricSink):
    KIND = "cortex"

    def __init__(self, spec: Optional[sink_mod.SinkSpec] = None,
                 server_config=None, session=None):
        spec = spec or sink_mod.SinkSpec(kind=self.KIND)
        super().__init__(spec.name, spec.config)
        cfg = self.config
        self.url = cfg.get("url", "")
        self.timeout = float(cfg.get("remote_timeout", 30.0))
        self.headers = {
            "Content-Encoding": "snappy",
            "Content-Type": "application/x-protobuf",
            "X-Prometheus-Remote-Write-Version": "0.1.0",
            "User-Agent": "veneur-tpu/cortex",
        }
        self.headers.update(cfg.get("headers", {}))
        auth = cfg.get("authorization", {})
        if auth.get("type", "").lower() in ("bearer", "basic") and \
                auth.get("credential"):
            self.headers["Authorization"] = (
                f"{auth['type'].title()} {auth['credential']}")
        self.basic_auth = None
        ba = cfg.get("basic_auth", {})
        if ba.get("username"):
            self.basic_auth = (ba["username"], ba.get("password", ""))
        self.batch_write_size = int(cfg.get("batch_write_size", 0))
        self.default_labels = dict(cfg.get("labels", {}))
        self._sessions = sink_mod.ParallelPoster(
            max_workers=1, injected_session=session)

    def flush(self, metrics):
        if not metrics:
            return sink_mod.MetricFlushResult()
        batches = [metrics]
        if self.batch_write_size and len(metrics) > self.batch_write_size:
            batches = [metrics[i:i + self.batch_write_size]
                       for i in range(0, len(metrics), self.batch_write_size)]
        flushed = dropped = 0
        for batch in batches:
            body = snappy.compress(
                encode_write_request(batch, self.default_labels))
            try:
                resp = self._sessions.session().post(
                    self.url, data=body, headers=self.headers,
                    auth=self.basic_auth, timeout=self.timeout)
                if resp.status_code >= 400:
                    logger.warning("cortex write -> %d: %.200s",
                                   resp.status_code, resp.text)
                    dropped += len(batch)
                else:
                    flushed += len(batch)
            except sink_mod.HTTP_ERRORS as e:
                logger.warning("cortex write failed: %s", e)
                dropped += len(batch)
        return sink_mod.MetricFlushResult(flushed=flushed, dropped=dropped)

