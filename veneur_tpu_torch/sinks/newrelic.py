"""New Relic sink: metrics via the public telemetry HTTP API.

The metric half of `veneur_tpu.sinks.newrelic` (`sinks/newrelic/
newrelic.go`, which wraps the NR telemetry SDK; the Trace API span sink
comes with the span pipeline, ROADMAP A15): metrics POST to the Metric
API (`https://metric-api.newrelic.com/metric/v1`) as
`[{"common": {...}, "metrics": [...]}]`.  Counters are emitted as NR
`count` with `interval.ms`, everything else as `gauge` — the same mapping
the SDK performs.  Posts go through the standard library
(`sinks.ParallelPoster`'s per-thread sessions; `session=` injects one).
"""

from __future__ import annotations

import json
import logging
from typing import Optional

from veneur_tpu_torch import sinks as sink_mod

logger = logging.getLogger("veneur_tpu_torch.sinks.newrelic")


def _tags_to_attrs(tags) -> dict:
    attrs = {}
    for t in tags:
        if ":" in t:
            k, v = t.split(":", 1)
        else:
            k, v = t, "true"
        attrs[k] = v
    return attrs


def metrics_payload(metrics, interval_s: float, common_attrs: dict) -> list:
    out = []
    for m in metrics:
        attrs = _tags_to_attrs(m.tags)
        if m.hostname:
            attrs.setdefault("host", m.hostname)
        entry = {
            "name": m.name,
            "value": m.value,
            "timestamp": int(m.timestamp) * 1000,
            "attributes": attrs,
        }
        if m.type == "counter":
            entry["type"] = "count"
            entry["interval.ms"] = int(interval_s * 1000)
        else:
            entry["type"] = "gauge"
        out.append(entry)
    return [{"common": {"attributes": common_attrs}, "metrics": out}]


@sink_mod.register_metric_sink("newrelic")
class NewRelicMetricSink(sink_mod.BaseMetricSink):
    KIND = "newrelic"

    def __init__(self, spec: Optional[sink_mod.SinkSpec] = None,
                 server_config=None, session=None):
        spec = spec or sink_mod.SinkSpec(kind=self.KIND)
        super().__init__(spec.name, spec.config)
        cfg = self.config
        self.insert_key = cfg.get("account_insert_key", "")
        self.metric_url = cfg.get(
            "metric_url", "https://metric-api.newrelic.com/metric/v1")
        self.common_attrs = _tags_to_attrs(cfg.get("tags", []))
        if cfg.get("service_check_event_type"):
            self.common_attrs["eventType"] = cfg["service_check_event_type"]
        self.interval_s = float(
            getattr(server_config, "interval", 10.0) or 10.0)
        self._sessions = sink_mod.ParallelPoster(
            max_workers=1, injected_session=session)

    def flush(self, metrics):
        if not metrics:
            return sink_mod.MetricFlushResult()
        payload = metrics_payload(metrics, self.interval_s,
                                  self.common_attrs)
        try:
            resp = self._sessions.session().post(
                self.metric_url, data=json.dumps(payload),
                headers={"Content-Type": "application/json",
                         "Api-Key": self.insert_key},
                timeout=10.0)
            if resp.status_code >= 400:
                logger.warning("newrelic metric POST -> %d: %.200s",
                               resp.status_code, resp.text)
                return sink_mod.MetricFlushResult(dropped=len(metrics))
        except sink_mod.HTTP_ERRORS as e:
            logger.warning("newrelic metric POST failed: %s", e)
            return sink_mod.MetricFlushResult(dropped=len(metrics))
        return sink_mod.MetricFlushResult(flushed=len(metrics))
