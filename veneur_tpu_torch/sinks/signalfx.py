"""SignalFx sink: datapoint submission with per-tag API-key fan-out.

The port's copy of `veneur_tpu.sinks.signalfx`, posting through the
standard library (`sinks.ParallelPoster`'s per-thread sessions;
`session=` injects one for tests).  Capability twin of `sinks/signalfx/signalfx.go` (`signalfx.go:168,491`):
metrics become SignalFx datapoints (`gauge`/`counter`/`cumulative_counter`)
with tags as dimensions; `vary_key_by` routes each metric to a per-tag-value
API token (the reference's per-key client fan-out); events submit via
`/v2/event`.

Wire protocol: `application/x-protobuf` DataPointUploadMessage /
EventUploadMessage by default — the same bytes the reference's sfxclient
HTTPSink puts on the wire (vendored com_signalfx_metrics_protobuf field
numbers, mirrored in protocol/protos/signalfxpb/signalfx.proto) — with
the documented JSON protocol available via `protocol: json`.  The
generated module is the port's copy (`protocol/gen/signalfxpb`).
"""

from __future__ import annotations

import json
import logging
import time
from typing import Optional

from veneur_tpu_torch import sinks as sink_mod
from veneur_tpu_torch.samplers import parser as parser_mod

logger = logging.getLogger("veneur_tpu_torch.sinks.signalfx")


def datapoint(m, hostname: str, tag_prefixes: Optional[list[str]] = None
              ) -> tuple[str, dict]:
    """InterMetric -> (category, datapoint dict)."""
    dims = {}
    for t in m.tags:
        if ":" in t:
            k, v = t.split(":", 1)
        else:
            k, v = t, ""
        if tag_prefixes and any(k.startswith(p) for p in tag_prefixes):
            continue
        dims[k] = v
    if hostname and "host" not in dims:
        dims["host"] = hostname
    category = "counter" if m.type == "counter" else "gauge"
    return category, {
        "metric": m.name,
        "value": m.value,
        "dimensions": dims,
        "timestamp": int(m.timestamp) * 1000,  # ms epoch
    }


@sink_mod.register_metric_sink("signalfx")
class SignalFxMetricSink(sink_mod.BaseMetricSink):
    KIND = "signalfx"

    def __init__(self, spec: Optional[sink_mod.SinkSpec] = None,
                 server_config=None, session=None):
        spec = spec or sink_mod.SinkSpec(kind=self.KIND)
        super().__init__(spec.name, spec.config)
        cfg = self.config
        self.api_key = cfg.get("api_key", "")
        self.endpoint = cfg.get(
            "endpoint_base", "https://ingest.signalfx.com").rstrip("/")
        # vary_key_by: tag key whose value selects a per-key token
        # (signalfx.go per-tag-value client map)
        self.vary_key_by = cfg.get("vary_key_by", "")
        self.per_tag_keys: dict[str, str] = dict(
            cfg.get("per_tag_api_keys", {}))
        self.hostname = getattr(server_config, "hostname", "") or ""
        self.exclude_prefixes = list(cfg.get("metric_tag_prefix_drops", []))
        # reference parity: drop whole metrics by name prefix
        # (metricNamePrefixDrops, signalfx.go)
        self.name_prefix_drops = list(cfg.get("metric_name_prefix_drops",
                                              []))
        # wire protocol: protobuf (sfxclient parity) or json
        self.protocol = cfg.get("protocol", "protobuf")
        self.max_per_batch = int(cfg.get("flush_max_per_body", 10_000))
        self._sessions = sink_mod.ParallelPoster(
            max_workers=1, injected_session=session)

    def _pb(self):
        from veneur_tpu_torch.protocol.gen.signalfxpb import signalfx_pb2
        return signalfx_pb2

    def _token_for(self, m) -> str:
        if self.vary_key_by:
            prefix = self.vary_key_by + ":"
            for t in m.tags:
                if t.startswith(prefix):
                    return self.per_tag_keys.get(t[len(prefix):],
                                                 self.api_key)
        return self.api_key

    def flush(self, metrics):
        if not metrics:
            return sink_mod.MetricFlushResult()
        # group by token so each POST authenticates correctly
        # (clientsByTagValue, signalfx.go:168-191)
        by_token: dict[str, list] = {}
        skipped = 0
        for m in metrics:
            if self.name_prefix_drops and any(
                    m.name.startswith(p) for p in self.name_prefix_drops):
                skipped += 1
                continue
            tok = self._token_for(m)
            cat, dp = datapoint(m, self.hostname, self.exclude_prefixes)
            by_token.setdefault(tok, []).append((cat, dp))
        flushed = dropped = 0
        for tok, points in by_token.items():
            for i in range(0, len(points), self.max_per_batch):
                chunk = points[i:i + self.max_per_batch]
                if self._post_datapoints(tok, chunk):
                    flushed += len(chunk)
                else:
                    dropped += len(chunk)
        return sink_mod.MetricFlushResult(flushed=flushed,
                                          dropped=dropped,
                                          skipped=skipped)

    def _post_datapoints(self, tok: str, points: list) -> bool:
        if self.protocol == "json":
            body: dict[str, list] = {}
            for cat, dp in points:
                body.setdefault(cat, []).append(dp)
            data = json.dumps(body)
            ctype = "application/json"
        else:
            pb = self._pb()
            msg = pb.DataPointUploadMessage()
            for cat, dp in points:
                p = msg.datapoints.add()
                p.metric = dp["metric"]
                p.timestamp = dp["timestamp"]
                p.value.doubleValue = float(dp["value"])
                p.metricType = (pb.COUNTER if cat == "counter"
                                else pb.GAUGE)
                for k in sorted(dp["dimensions"]):
                    d = p.dimensions.add()
                    d.key = k
                    d.value = dp["dimensions"][k]
            data = msg.SerializeToString()
            ctype = "application/x-protobuf"
        try:
            resp = self._sessions.session().post(
                f"{self.endpoint}/v2/datapoint", data=data,
                headers={"Content-Type": ctype, "X-SF-Token": tok},
                timeout=10.0)
            if resp.status_code >= 400:
                logger.warning("signalfx POST -> %d: %.200s",
                               resp.status_code, resp.text)
                return False
            return True
        except sink_mod.HTTP_ERRORS as e:
            logger.warning("signalfx POST failed: %s", e)
            return False

    def flush_other_samples(self, samples):
        events = []
        for s in samples:
            tags = dict(s.tags) if s.tags else {}
            if parser_mod.EVENT_IDENTIFIER_KEY not in tags:
                continue  # signalfx sink only forwards events
            tags.pop(parser_mod.EVENT_IDENTIFIER_KEY, None)
            events.append({
                "category": "USER_DEFINED",
                "eventType": s.name,
                "dimensions": tags,
                "properties": {"description": s.message},
                "timestamp": (s.timestamp or int(time.time())) * 1000,
            })
        if not events:
            return
        if self.protocol == "json":
            data = json.dumps(events)
            ctype = "application/json"
        else:
            pb = self._pb()
            msg = pb.EventUploadMessage()
            for e in events:
                ev = msg.events.add()
                ev.eventType = e["eventType"]
                ev.category = pb.USER_DEFINED
                ev.timestamp = e["timestamp"]
                for k in sorted(e["dimensions"]):
                    d = ev.dimensions.add()
                    d.key = k
                    d.value = e["dimensions"][k]
                for k, v in e["properties"].items():
                    p = ev.properties.add()
                    p.key = k
                    p.value.strValue = str(v)
            data = msg.SerializeToString()
            ctype = "application/x-protobuf"
        try:
            self._sessions.session().post(
                f"{self.endpoint}/v2/event", data=data,
                headers={"Content-Type": ctype,
                         "X-SF-Token": self.api_key},
                timeout=10.0)
        except sink_mod.HTTP_ERRORS as e:
            logger.warning("signalfx event POST failed: %s", e)

