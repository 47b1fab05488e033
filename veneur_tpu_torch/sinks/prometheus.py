"""Prometheus repeater sink: re-emit statsd lines to a statsd_exporter.

The port's copy of `veneur_tpu.sinks.prometheus`.

Capability twin of `sinks/prometheus/prometheus.go` (`prometheus.go:25-40`):
each InterMetric becomes one DogStatsD line
`name:value|type|#tag1,tag2` sent to the configured repeater address over
UDP or TCP, batched (200 lines per write, the reference's batch size).
"""

from __future__ import annotations

import logging
import socket
from typing import Optional
from urllib.parse import urlparse

from veneur_tpu_torch import sinks as sink_mod

logger = logging.getLogger("veneur_tpu_torch.sinks.prometheus")

BATCH_SIZE = 200  # statements per write (prometheus.go batch constant)


def statsd_line(m) -> str:
    mtype = {"counter": "c", "gauge": "g", "status": "g"}.get(m.type, "g")
    # repr() is shortest-round-trip for floats; %g would corrupt values
    # needing more than 6 significant digits
    value = repr(m.value) if isinstance(m.value, float) else str(m.value)
    line = f"{m.name}:{value}|{mtype}"
    if m.tags:
        line += "|#" + ",".join(m.tags)
    return line


@sink_mod.register_metric_sink("prometheus")
class PrometheusMetricSink(sink_mod.BaseMetricSink):
    KIND = "prometheus"

    def __init__(self, spec: Optional[sink_mod.SinkSpec] = None,
                 server_config=None):
        spec = spec or sink_mod.SinkSpec(kind=self.KIND)
        super().__init__(spec.name, spec.config)
        addr = self.config.get("repeater_address", "udp://127.0.0.1:9125")
        if "//" not in addr:
            addr = "udp://" + addr
        u = urlparse(addr)
        self.network = u.scheme or "udp"
        self.host, self.port = u.hostname or "127.0.0.1", u.port or 9125

    def flush(self, metrics):
        if not metrics:
            return sink_mod.MetricFlushResult()
        lines = [statsd_line(m) for m in metrics]
        flushed = dropped = 0
        try:
            if self.network == "tcp":
                with socket.create_connection(
                        (self.host, self.port), timeout=10.0) as s:
                    for i in range(0, len(lines), BATCH_SIZE):
                        chunk = lines[i:i + BATCH_SIZE]
                        s.sendall(("\n".join(chunk) + "\n").encode())
                        flushed += len(chunk)
            else:
                s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                try:
                    for i in range(0, len(lines), BATCH_SIZE):
                        chunk = lines[i:i + BATCH_SIZE]
                        s.sendto(("\n".join(chunk) + "\n").encode(),
                                 (self.host, self.port))
                        flushed += len(chunk)
                finally:
                    s.close()
        except OSError as e:
            logger.warning("prometheus repeater send failed: %s", e)
            dropped = len(lines) - flushed
        return sink_mod.MetricFlushResult(flushed=flushed, dropped=dropped)
