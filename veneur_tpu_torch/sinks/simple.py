"""Built-in simple sinks: blackhole, channel, debug, jsonl, localfile.

blackhole (`sinks/blackhole/blackhole.go`) drops everything — the
benchmark baseline.  channel is the test fixture sink from
`server_test.go:184-218` (delivers each flush's metrics to a queue).
debug (`sinks/debug/debug.go`) logs everything.  jsonl appends each
flush as JSON lines, the cross-process counterpart of channel.
localfile (`sinks/localfile/localfile.go`) appends TSV rows
(`util/csv.go`), with the encoder the s3 sink shares.
"""

from __future__ import annotations

import datetime
import io
import json
import logging
import os
import queue
import threading
from typing import Optional

from veneur_tpu_torch import sinks as sink_mod
from veneur_tpu_torch.samplers.samplers import InterMetric

logger = logging.getLogger("veneur_tpu_torch.sinks")


@sink_mod.register_metric_sink("blackhole")
class BlackholeMetricSink(sink_mod.BaseMetricSink):
    KIND = "blackhole"

    def __init__(self, spec: Optional[sink_mod.SinkSpec] = None,
                 server_config=None):
        spec = spec or sink_mod.SinkSpec(kind=self.KIND)
        super().__init__(spec.name, spec.config)

    def flush(self, metrics):
        return sink_mod.MetricFlushResult(flushed=len(metrics))


@sink_mod.register_metric_sink("channel")
class ChannelMetricSink(sink_mod.BaseMetricSink):
    """Delivers each flush's InterMetric list to a queue — the in-process
    test fixture pattern (server_test.go:184-218)."""

    KIND = "channel"

    def __init__(self, spec: Optional[sink_mod.SinkSpec] = None,
                 server_config=None, out: Optional[queue.Queue] = None):
        spec = spec or sink_mod.SinkSpec(kind=self.KIND)
        super().__init__(spec.name, spec.config)
        self.queue: queue.Queue = out if out is not None else queue.Queue()
        self.other_samples: list = []

    def flush(self, metrics):
        self.queue.put(list(metrics))
        return sink_mod.MetricFlushResult(flushed=len(metrics))

    def flush_other_samples(self, samples):
        self.other_samples.extend(samples)


@sink_mod.register_metric_sink("debug")
class DebugMetricSink(sink_mod.BaseMetricSink):
    """Logs every metric and every event or service check at INFO."""

    KIND = "debug"

    def __init__(self, spec: Optional[sink_mod.SinkSpec] = None,
                 server_config=None):
        spec = spec or sink_mod.SinkSpec(kind=self.KIND)
        super().__init__(spec.name, spec.config)

    def flush(self, metrics):
        for m in metrics:
            logger.info("debug sink metric: %s", m)
        return sink_mod.MetricFlushResult(flushed=len(metrics))

    def flush_other_samples(self, samples):
        for s in samples:
            logger.info("debug sink sample: %s", s)


@sink_mod.register_metric_sink("jsonl")
class JsonLinesMetricSink(sink_mod.BaseMetricSink):
    """Appends each flush's metrics to `config.path` as JSON lines, then
    one `{"flush": true, "metrics": n}` frame record, so that a harness
    in another process can attribute rows to intervals.  One write and
    one fsync a flush; the frame's newline commits it (a torn tail is a
    line without one)."""

    KIND = "jsonl"

    def __init__(self, spec: Optional[sink_mod.SinkSpec] = None,
                 server_config=None):
        spec = spec or sink_mod.SinkSpec(kind=self.KIND)
        super().__init__(spec.name, spec.config)
        self.path = self.config.get("path", "/tmp/veneur_tpu_emit.jsonl")
        self._lock = threading.Lock()

    def flush(self, metrics):
        rows = [json.dumps({
            "name": m.name, "type": m.type, "value": m.value,
            "tags": list(m.tags), "timestamp": m.timestamp,
            "hostname": m.hostname}) for m in metrics]
        rows.append(json.dumps({"flush": True, "metrics": len(metrics)}))
        with self._lock:
            with open(self.path, "a") as f:
                f.write("\n".join(rows) + "\n")
                f.flush()
                os.fsync(f.fileno())
        return sink_mod.MetricFlushResult(flushed=len(metrics))


def encode_tsv_row(m: InterMetric, hostname: str, interval_s: float,
                   partition_date: str) -> str:
    """One TSV row (util/csv.go): name, tags, type, hostname, timestamp,
    value (a counter as its rate over the interval), partition date."""
    value = m.value
    if m.type == "counter" and interval_s > 0:
        value = m.value / interval_s
    return "\t".join([
        m.name, ",".join(m.tags), m.type, hostname or m.hostname,
        str(m.timestamp), repr(value), partition_date])


@sink_mod.register_metric_sink("localfile")
class LocalFileMetricSink(sink_mod.BaseMetricSink):
    """Appends each flush to `config.flush_file` as TSV rows."""

    KIND = "localfile"

    def __init__(self, spec: Optional[sink_mod.SinkSpec] = None,
                 server_config=None):
        spec = spec or sink_mod.SinkSpec(kind=self.KIND)
        super().__init__(spec.name, spec.config)
        self.path = self.config.get("flush_file", "/tmp/veneur_tpu_flush.tsv")
        self.hostname = getattr(server_config, "hostname", "") or ""
        self.interval_s = float(getattr(server_config, "interval", 10.0)
                                or 10.0)

    def flush(self, metrics):
        date = datetime.datetime.now(datetime.timezone.utc).strftime(
            "%Y-%m-%d")
        buf = io.StringIO()
        for m in metrics:
            buf.write(encode_tsv_row(m, self.hostname, self.interval_s, date))
            buf.write("\n")
        with open(self.path, "a") as f:
            f.write(buf.getvalue())
        return sink_mod.MetricFlushResult(flushed=len(metrics))
