"""Datadog sink: metric series, events and service checks.

The metric half of `veneur_tpu.sinks.datadog` (`sinks/datadog/
datadog.go`); the trace-agent span sink comes with the span pipeline
(ROADMAP A15):

  * metrics  -> JSON POST `{"series": [...]}` to `/api/v1/series`
    (`datadog.go:158` flush path), counters emitted as `rate` divided by
    the flush interval, `host:`/`device:` tags hoisted into fields,
    batched by `flush_max_per_body` (`datadog.go:48`) and posted in
    parallel; status metrics are service checks at this boundary;
  * events   -> `/intake` payload keyed by aggregation key
    (`FlushOtherSamples`, `datadog.go:451`), service checks ->
    `/api/v1/check_run`.

Bodies are gzipped JSON, posted through the standard library
(`sinks.ParallelPoster`); `session=` injects a session for tests.
"""

from __future__ import annotations

import gzip
import json
import logging
import time
from typing import Optional

from veneur_tpu_torch import sinks as sink_mod
from veneur_tpu_torch.samplers import parser as parser_mod
from veneur_tpu_torch.samplers.samplers import InterMetric

logger = logging.getLogger("veneur_tpu_torch.sinks.datadog")

DEFAULT_FLUSH_MAX_PER_BODY = 25_000


def _post_json(session, url: str, payload, timeout: float = 10.0,
               headers: Optional[dict] = None, retries: int = 0,
               backoff_s: float = 0.2) -> bool:
    """gzip JSON POST with bounded retry.  Transient failures (connection
    errors, 5xx, 429) retry with exponential backoff; other 4xx are
    permanent client errors and fail immediately (the classification of
    flusher.go:553-566 applied to the sink transport)."""
    body = gzip.compress(json.dumps(payload).encode())
    hdrs = {"Content-Type": "application/json",
            "Content-Encoding": "gzip"}
    if headers:
        hdrs.update(headers)
    for attempt in range(retries + 1):
        try:
            resp = session.post(url, data=body, headers=hdrs,
                                timeout=timeout)
            if resp.status_code < 400:
                return True
            transient = resp.status_code >= 500 or resp.status_code == 429
            logger.warning("datadog POST %s -> %d (%s): %.200s", url,
                           resp.status_code,
                           "transient" if transient else "permanent",
                           resp.text)
            if not transient:
                return False
        except sink_mod.HTTP_ERRORS as e:
            logger.warning("datadog POST %s failed: %s", url, e)
        if attempt < retries:
            time.sleep(backoff_s * (2 ** attempt))
    return False


def split_status_checks(metrics, hostname: str) -> tuple[list, list]:
    """Partition flush metrics into (series metrics, DDServiceCheck
    dicts): a status-type InterMetric IS a service check at the Datadog
    boundary (finalizeMetrics, datadog.go:371-383), posted to
    /api/v1/check_run instead of riding the series body."""
    plain, checks = [], []
    for m in metrics:
        if m.type != "status":
            plain.append(m)
            continue
        host = hostname or m.hostname
        tags = []
        for t in m.tags:
            if t.startswith("host:"):
                host = t[len("host:"):]
            else:
                tags.append(t)
        checks.append({
            "check": m.name,
            "status": int(m.value),
            "host_name": host,
            "timestamp": int(m.timestamp),
            "tags": tags,
            "message": m.message,
        })
    return plain, checks


def series_payload(metrics: list[InterMetric], hostname: str,
                   interval_s: float, tags: list[str]) -> dict:
    """Build the `/api/v1/series` body (datadog.go flush conversion)."""
    series = []
    for m in metrics:
        host = hostname or m.hostname
        device = ""
        mtags = []
        for t in list(m.tags) + list(tags):
            if t.startswith("host:"):
                host = t[len("host:"):]
            elif t.startswith("device:"):
                device = t[len("device:"):]
            else:
                mtags.append(t)
        value = m.value
        mtype = "gauge"
        entry = {
            "metric": m.name,
            "points": [[m.timestamp, value]],
            "tags": mtags,
            "host": host,
        }
        if m.type == "counter" and interval_s > 0:
            mtype = "rate"
            entry["points"] = [[m.timestamp, value / interval_s]]
            entry["interval"] = int(interval_s) or 1
        entry["type"] = mtype
        if device:
            entry["device"] = device
        series.append(entry)
    return {"series": series}


@sink_mod.register_metric_sink("datadog")
class DatadogMetricSink(sink_mod.BaseMetricSink):
    KIND = "datadog"

    def __init__(self, spec: Optional[sink_mod.SinkSpec] = None,
                 server_config=None, session=None):
        spec = spec or sink_mod.SinkSpec(kind=self.KIND)
        super().__init__(spec.name, spec.config)
        cfg = self.config
        self.api_key = cfg.get("api_key", "")
        self.api_url = cfg.get("api_hostname",
                               "https://app.datadoghq.com").rstrip("/")
        self.flush_max_per_body = int(
            cfg.get("flush_max_per_body", DEFAULT_FLUSH_MAX_PER_BODY))
        self.hostname = getattr(server_config, "hostname", "") or ""
        self.interval_s = float(
            getattr(server_config, "interval", 10.0) or 10.0)
        self.extra_tags = list(cfg.get("tags", []))
        self.flush_retries = int(cfg.get("flush_retries", 2))
        self.validate_on_start = bool(cfg.get("validate_on_start", False))
        self._poster = sink_mod.ParallelPoster(
            max_workers=8, thread_name_prefix="dd-flush",
            injected_session=session)

    def close(self) -> None:
        self._poster.close()

    def start(self, trace_client=None) -> None:
        """Optional API-key validation against /api/v1/validate — a bad
        key is surfaced at startup instead of as silent flush drops."""
        if not self.validate_on_start:
            return
        try:
            resp = self._poster.session().get(
                f"{self.api_url}/api/v1/validate",
                headers={"DD-API-KEY": self.api_key}, timeout=5.0)
            if resp.status_code == 403:
                logger.error("datadog API key rejected (403) — metrics "
                             "will be dropped until the key is fixed")
            elif resp.status_code >= 400:
                logger.warning("datadog key validation returned %d",
                               resp.status_code)
        except sink_mod.HTTP_ERRORS as e:
            logger.warning("datadog key validation unreachable: %s", e)

    def flush(self, metrics):
        if not metrics:
            return sink_mod.MetricFlushResult()
        # key rides the DD-API-KEY header, never the (logged) URL
        url = f"{self.api_url}/api/v1/series"
        auth = {"DD-API-KEY": self.api_key}
        metrics, checks = split_status_checks(metrics, self.hostname)
        n_checks = 0
        if checks:
            # status metrics are service checks at this boundary
            # (flush_checks, datadog.go:164-180)
            ok = _post_json(self._poster.session(),
                            f"{self.api_url}/api/v1/check_run", checks,
                            headers=auth, retries=self.flush_retries)
            n_checks = len(checks) if ok else 0
        if not metrics:
            return sink_mod.MetricFlushResult(
                flushed=n_checks, dropped=len(checks) - n_checks)
        chunks = [metrics[i:i + self.flush_max_per_body]
                  for i in range(0, len(metrics), self.flush_max_per_body)]

        def post(chunk, session) -> bool:
            payload = series_payload(chunk, self.hostname, self.interval_s,
                                     self.extra_tags)
            return _post_json(session, url, payload, headers=auth,
                              retries=self.flush_retries)

        # chunk posts run concurrently (flushPart goroutines,
        # datadog.go:158-233); short results = not-posted (drop-counted)
        results = self._poster.map(post, chunks)
        results += [False] * (len(chunks) - len(results))
        flushed = sum(len(c) for c, ok in zip(chunks, results) if ok)
        dropped = len(metrics) - flushed
        return sink_mod.MetricFlushResult(
            flushed=flushed + n_checks,
            dropped=dropped + len(checks) - n_checks)

    def flush_other_samples(self, samples):
        """Events + service checks (datadog.go:451 FlushOtherSamples)."""
        events, checks = [], []
        for s in samples:
            tags = dict(s.tags) if s.tags else {}
            if parser_mod.EVENT_IDENTIFIER_KEY in tags:
                tags.pop(parser_mod.EVENT_IDENTIFIER_KEY, None)
                ev = {
                    "title": s.name,
                    "text": s.message,
                    "date_happened": s.timestamp or int(time.time()),
                }
                for tag_key, field in (
                        (parser_mod.EVENT_AGGREGATION_KEY_TAG,
                         "aggregation_key"),
                        (parser_mod.EVENT_PRIORITY_TAG, "priority"),
                        (parser_mod.EVENT_SOURCE_TYPE_TAG, "source_type_name"),
                        (parser_mod.EVENT_ALERT_TYPE_TAG, "alert_type"),
                        (parser_mod.EVENT_HOSTNAME_TAG, "host")):
                    if tag_key in tags:
                        ev[field] = tags.pop(tag_key)
                ev["tags"] = [f"{k}:{v}" for k, v in sorted(tags.items())] \
                    + self.extra_tags
                events.append(ev)
            else:
                checks.append({
                    "check": s.name,
                    "status": int(s.status),
                    "timestamp": s.timestamp or int(time.time()),
                    "message": s.message,
                    "host_name": tags.pop("host", self.hostname),
                    "tags": [f"{k}:{v}" for k, v in sorted(tags.items())]
                    + self.extra_tags,
                })
        auth = {"DD-API-KEY": self.api_key}
        session = self._poster.session()
        if events:
            _post_json(session, f"{self.api_url}/intake",
                       {"events": {"api": events}}, headers=auth)
        if checks:
            _post_json(session, f"{self.api_url}/api/v1/check_run",
                       checks, headers=auth)
