"""Metric sink interface, plugin registry and central per-sink filtering.

Counterpart of `veneur_tpu.sinks` (`sinks/sinks.go:42-106`, the registry
maps of `server.go:62-90`): a sink kind registers a factory; instances
are configured from the YAML `metric_sinks` list, and the egress plane
(`egress/`) applies each sink's routing allowlist, name and tag limits
and the server's `tags_exclude` keys centrally before the sink sees a
flush (`flusher.go:124-247`).

The kinds are the JAX package's metric sinks: blackhole, channel, debug,
jsonl and localfile (`sinks/simple.py`), and cloudwatch, cortex,
datadog, kafka, mock, newrelic, prometheus, s3 and signalfx, each in its
own module.  The span halves of datadog, kafka, mock and newrelic and
the span-only kinds come with the span pipeline (ROADMAP A15).

HTTP sinks post through `ParallelPoster`, which uses the standard
library's `http.client` (one keep-alive connection per worker thread and
destination) and times each request's connect, first byte and total.
"""

from __future__ import annotations

import base64
import concurrent.futures
import dataclasses
import http.client
import threading
import time
import urllib.parse
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from veneur_tpu_torch.samplers.samplers import (InterMetric, MetricBatch,
                                                MetricSegment)
from veneur_tpu_torch.util.matcher import TagMatcher


@dataclass
class MetricFlushResult:
    """sinks.MetricFlushResult: accounting reported by each flush."""
    flushed: int = 0
    skipped: int = 0
    dropped: int = 0


# Standardized sink self-metric names (sinks/sinks.go:18-80)
METRICS_FLUSHED_TOTAL = "sink.metrics_flushed_total"
METRICS_DROPPED_TOTAL = "sink.metrics_dropped_total"

# what a failed request raises: a transport error, or a malformed or
# cut response
HTTP_ERRORS = (OSError, http.client.HTTPException)


class HttpResponse:
    """A read response: `status_code`, `content` (bytes), `headers`."""

    __slots__ = ("status_code", "content", "headers")

    def __init__(self, status_code: int, content: bytes, headers: dict):
        self.status_code = status_code
        self.content = content
        self.headers = headers

    @property
    def text(self) -> str:
        return self.content.decode("utf-8", "replace")

    def raise_for_status(self) -> None:
        if self.status_code >= 400:
            raise http.client.HTTPException(
                f"HTTP {self.status_code}: {self.text[:200]}")


class HttpSession:
    """Keep-alive HTTP/1.1 over `http.client`: one connection per
    (scheme, host, port), for one thread at a time.  Each request's
    phases (connect when it opened the connection, time to the response
    headers, total with the body) go to `on_phases`.  A request on a
    reused connection that the server has closed meanwhile is sent once
    more on a fresh one."""

    def __init__(self, on_phases: Optional[Callable[[dict], None]] = None):
        self._on_phases = on_phases
        self._conns: dict[tuple, http.client.HTTPConnection] = {}

    def _connection(self, scheme: str, host: str, port: Optional[int],
                    timeout: float) -> http.client.HTTPConnection:
        key = (scheme, host, port)
        conn = self._conns.get(key)
        if conn is None:
            if scheme == "https":
                conn = http.client.HTTPSConnection(host, port,
                                                   timeout=timeout)
            else:
                conn = http.client.HTTPConnection(host, port,
                                                  timeout=timeout)
            self._conns[key] = conn
        conn.timeout = timeout
        if conn.sock is not None:
            conn.sock.settimeout(timeout)
        return conn

    def request(self, method: str, url: str, data=None,
                headers: Optional[dict] = None, timeout: float = 10.0,
                auth: Optional[tuple] = None) -> HttpResponse:
        u = urllib.parse.urlsplit(url)
        path = (u.path or "/") + (f"?{u.query}" if u.query else "")
        hdrs = dict(headers or {})
        if auth is not None:
            token = base64.b64encode(
                f"{auth[0]}:{auth[1]}".encode("latin-1")).decode()
            hdrs["Authorization"] = f"Basic {token}"
        body = data.encode("utf-8") if isinstance(data, str) else data
        conn = self._connection(u.scheme or "http", u.hostname, u.port,
                                timeout)
        for attempt in (0, 1):
            reused = conn.sock is not None
            t0 = time.perf_counter()
            connect_ms = None
            try:
                if not reused:
                    conn.connect()
                    connect_ms = (time.perf_counter() - t0) * 1e3
                conn.request(method, path, body=body, headers=hdrs)
                resp = conn.getresponse()
                ttfb_ms = (time.perf_counter() - t0) * 1e3
                content = resp.read()
            except (http.client.RemoteDisconnected, BrokenPipeError,
                    ConnectionResetError):
                conn.close()
                if reused and attempt == 0:
                    continue
                raise
            except BaseException:
                conn.close()
                raise
            if resp.will_close:
                conn.close()
            if self._on_phases is not None:
                self._on_phases({
                    "total_ms": (time.perf_counter() - t0) * 1e3,
                    "ttfb_ms": ttfb_ms,
                    "connect_ms": connect_ms,
                    "reused": connect_ms is None,
                })
            return HttpResponse(resp.status, content,
                                dict(resp.getheaders()))
        raise AssertionError("unreachable")

    def post(self, url: str, data=None, **kw) -> HttpResponse:
        return self.request("POST", url, data=data, **kw)

    def put(self, url: str, data=None, **kw) -> HttpResponse:
        return self.request("PUT", url, data=data, **kw)

    def get(self, url: str, **kw) -> HttpResponse:
        return self.request("GET", url, **kw)

    def close(self) -> None:
        conns, self._conns = self._conns, {}
        for conn in conns.values():
            conn.close()


class ParallelPoster:
    """Shared HTTP fan-out for sinks with per-flush body chunks (the
    reference's flushPart goroutines): a persistent pool whose workers
    each hold one long-lived `HttpSession`, with a close() that shuts
    the pool and the sessions.

    Every session records per-POST phases — the analog of the
    reference's `net/http/httptrace` client tracer (`http/http.go:
    23-100`): connect (absent on a reused connection), time to first
    byte and total wall time.  `drain_phase_stats()` hands the records
    to whoever emits self-metrics.  `injected_session` (any object with
    the session's `post`/`get`/`put`) replaces every worker's session.
    """

    def __init__(self, max_workers: int = 8,
                 thread_name_prefix: str = "sink-post",
                 injected_session=None):
        self._injected_session = injected_session
        # eager: spawns no threads until first submit
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix=thread_name_prefix)
        self._tls = threading.local()
        self._sessions: list[HttpSession] = []
        self._sessions_lock = threading.Lock()
        self._phase_lock = threading.Lock()
        self._phase_records: list[dict] = []

    def _record_phases(self, rec: dict) -> None:
        with self._phase_lock:
            # bounded: a sink that never drains must not leak; keep the
            # most recent window
            if len(self._phase_records) >= 4096:
                del self._phase_records[:2048]
            self._phase_records.append(rec)

    def drain_phase_stats(self) -> list[dict]:
        """All phase records since the last drain, each
        {total_ms, ttfb_ms, connect_ms|None, reused: bool}."""
        with self._phase_lock:
            out, self._phase_records = self._phase_records, []
        return out

    def session(self):
        """One long-lived session per calling thread; an injected test
        session is honored."""
        if self._injected_session is not None:
            return self._injected_session
        s = getattr(self._tls, "session", None)
        if s is None:
            s = HttpSession(self._record_phases)
            self._tls.session = s
            with self._sessions_lock:
                self._sessions.append(s)
        return s

    def map(self, fn: Callable, items: list) -> list:
        """fn(item, session) over items; serial for one item, pooled
        otherwise.  A close() racing a straggler flush yields a SHORT
        result list (missing entries = not posted) instead of an
        escaping CancelledError."""
        if len(items) <= 1:
            return [fn(item, self.session()) for item in items]
        try:
            return list(self._pool.map(
                lambda item: fn(item, self.session()), items))
        except (concurrent.futures.CancelledError, RuntimeError):
            # close() raced (cancelled futures) or preceded (submit after
            # shutdown) this flush; unposted items are the caller's drops
            return []

    def close(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)
        with self._sessions_lock:
            sessions, self._sessions = self._sessions, []
        for s in sessions:
            try:
                s.close()
            except Exception:
                pass


class BaseMetricSink:
    """Convenience base with no-op hooks."""

    KIND = "base"

    def __init__(self, name: str = "", config: Optional[dict] = None):
        self._name = name or self.KIND
        self.config = config or {}

    def name(self) -> str:
        return self._name

    def kind(self) -> str:
        return self.KIND

    def start(self, trace_client=None) -> None:
        pass

    def flush(self, metrics: list[InterMetric]) -> MetricFlushResult:
        return MetricFlushResult()

    def flush_other_samples(self, samples: list) -> None:
        pass


@dataclass
class SinkSpec:
    """One entry of metric_sinks (config.go:95-104), with the per-sink
    limits the egress plane applies (`filter_metrics_for_sink`)."""
    kind: str
    name: str = ""
    config: dict = field(default_factory=dict)
    max_name_length: int = 0
    max_tag_length: int = 0
    max_tags: int = 0
    strip_tags: list[TagMatcher] = field(default_factory=list)
    add_tags: dict[str, str] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: dict) -> "SinkSpec":
        strip = [TagMatcher(**t) if isinstance(t, dict) else t
                 for t in d.get("strip_tags", [])]
        return cls(
            kind=d["kind"], name=d.get("name", d["kind"]),
            config=d.get("config") or {},
            max_name_length=d.get("max_name_length", 0),
            max_tag_length=d.get("max_tag_length", 0),
            max_tags=d.get("max_tags", 0),
            strip_tags=strip,
            add_tags=d.get("add_tags") or {})


# plugin registry: kind -> factory(spec, server_config) -> sink instance
# (the reference's Create funcs receive the server Config too,
# server.go:62-90)
METRIC_SINK_TYPES: dict[str, Callable[..., Any]] = {}


def register_metric_sink(kind: str):
    def deco(factory):
        METRIC_SINK_TYPES[kind] = factory
        return factory
    return deco


def create_metric_sink(spec: SinkSpec, server_config=None):
    factory = METRIC_SINK_TYPES.get(spec.kind)
    if factory is None:
        raise ValueError(f"unknown metric sink kind {spec.kind!r}")
    return factory(spec, server_config)


def _transform_tags(spec: SinkSpec, excluded_tags: Optional[set],
                    tags: list[str]):
    """One row's tag pipeline (flusher.go:156-213): excluded-key drop,
    strip_tags, max_tag_length, add_tags (exclusion wins; no duplicate
    keys), max_tags.  Returns (new_tags, drop_reason) — new_tags is the
    ORIGINAL list object when nothing changed; drop_reason is None or the
    counts key to increment for a dropped metric."""
    out = tags
    if spec.strip_tags or spec.max_tag_length or excluded_tags:
        out = []
        for tag in tags:
            if excluded_tags and tag.split(":", 1)[0] in excluded_tags:
                continue
            if any(tm.match(tag) for tm in spec.strip_tags):
                continue
            if spec.max_tag_length and len(tag) > spec.max_tag_length:
                return None, "max_tag_length"
            out.append(tag)
    if spec.add_tags:
        out = list(out)
        for k, v in spec.add_tags.items():
            if excluded_tags and k in excluded_tags:
                # exclusion wins over add_tags (the reference strips
                # excluded keys at serialization, after adds)
                continue
            tag = f"{k}:{v}"
            if spec.max_tag_length and len(tag) > spec.max_tag_length:
                return None, "max_tag_length"
            if not any(ft == k or ft.startswith(k + ":") for ft in out):
                out.append(tag)
    if spec.max_tags and len(out) > spec.max_tags:
        return None, "max_tags"
    return out, None


def _filter_loose(spec: SinkSpec, routing_enabled: bool, metrics,
                  excluded_tags: Optional[set], counts: dict,
                  out: list) -> None:
    for m in metrics:
        if routing_enabled and (m.sinks is not None
                                and spec.name not in m.sinks):
            counts["skipped"] += 1
            continue
        if spec.max_name_length and len(m.name) > spec.max_name_length:
            counts["max_name_length"] += 1
            continue
        tags, reason = _transform_tags(spec, excluded_tags, m.tags)
        if reason is not None:
            counts[reason] += 1
            continue
        if tags is not m.tags:
            m = dataclasses.replace(m, tags=tags)
        counts["flushed"] += 1
        out.append(m)


def _filter_batch(spec: SinkSpec, routing_enabled: bool,
                  batch: MetricBatch, excluded_tags: Optional[set],
                  counts: dict) -> MetricBatch:
    """Columnar filtering: per-ROW work (tag transforms, name lengths) is
    computed once per shared column set and reused across every aggregate
    segment, so a 100k-key × 7-aggregate flush pays 100k tag transforms,
    not 700k."""
    import numpy as np

    out = MetricBatch()
    tag_cache: dict[int, tuple] = {}
    len_cache: dict[int, "np.ndarray"] = {}
    need_tagwork = bool(spec.strip_tags or spec.max_tag_length
                        or excluded_tags or spec.add_tags or spec.max_tags)
    for seg in batch.segments:
        n = len(seg)
        keep = np.ones(n, bool)
        if routing_enabled and seg.sinks is not None:
            for i, s in enumerate(seg.sinks):
                if s is not None and spec.name not in s:
                    keep[i] = False
            counts["skipped"] += int(n - keep.sum())
        if spec.max_name_length:
            lens = len_cache.get(id(seg.bases))
            if lens is None:
                lens = np.fromiter((len(b) for b in seg.bases), np.int32,
                                   len(seg.bases))
                len_cache[id(seg.bases)] = lens
            row_lens = lens if seg.sel is None else lens[seg.sel]
            too_long = (row_lens + len(seg.suffix)
                        > spec.max_name_length) & keep
            counts["max_name_length"] += int(too_long.sum())
            keep &= ~too_long
        new_tags = seg.tags
        if need_tagwork:
            cached = tag_cache.get(id(seg.tags))
            if cached is None:
                transformed = []
                reasons = []
                for row_tags in seg.tags:
                    t, reason = _transform_tags(spec, excluded_tags,
                                                row_tags)
                    transformed.append(t)
                    reasons.append(reason)
                cached = (transformed, reasons)
                tag_cache[id(seg.tags)] = cached
            new_tags, reasons = cached
            for i in np.nonzero(keep)[0].tolist():
                reason = reasons[seg.row(i)]
                if reason is not None:
                    counts[reason] += 1
                    keep[i] = False
        kept = int(keep.sum())
        counts["flushed"] += kept
        if kept == 0:
            continue
        if kept == n and new_tags is seg.tags:
            out.segments.append(seg)
            continue
        sel = (np.nonzero(keep)[0] if seg.sel is None
               else seg.sel[keep])
        sinks = (None if seg.sinks is None
                 else [seg.sinks[i] for i in np.nonzero(keep)[0].tolist()])
        out.segments.append(MetricSegment(
            seg.bases, new_tags, seg.suffix, seg.values[keep], seg.type,
            seg.timestamp, sel=sel, sinks=sinks))
    _filter_loose(spec, routing_enabled, batch.loose, excluded_tags,
                  counts, out.loose)
    return out


def filter_metrics_for_sink(spec: SinkSpec, routing_enabled: bool,
                            metrics,
                            excluded_tags: Optional[set] = None
                            ):
    """Central per-sink filtering (flusher.go:138-213): routing allowlist,
    max name length, strip/length-check/add tags, max tag count, plus the
    server-level `tags_exclude` keys (setSinkExcludedTags,
    server.go:1456-1463 — tag KEYS dropped for this sink).  Accepts a
    list[InterMetric] or a columnar MetricBatch (filtered segment-wise
    without materializing records).  Returns (filtered metrics, drop
    counters)."""
    counts = {"skipped": 0, "max_name_length": 0, "max_tags": 0,
              "max_tag_length": 0, "flushed": 0}
    if not routing_enabled and not excluded_tags and not (
            spec.max_name_length or spec.max_tag_length or spec.max_tags
            or spec.strip_tags or spec.add_tags):
        counts["flushed"] = len(metrics)
        return metrics, counts

    if isinstance(metrics, MetricBatch):
        return _filter_batch(spec, routing_enabled, metrics,
                             excluded_tags, counts), counts
    out: list[InterMetric] = []
    _filter_loose(spec, routing_enabled, metrics, excluded_tags, counts,
                  out)
    return out, counts


# Register the built-in sinks (imports at the bottom: each module
# decorates with the registry defined above).
from veneur_tpu_torch.sinks import simple as _simple  # noqa: E402,F401
from veneur_tpu_torch.sinks import cloudwatch as _cloudwatch  # noqa: E402,F401
from veneur_tpu_torch.sinks import cortex as _cortex  # noqa: E402,F401
from veneur_tpu_torch.sinks import datadog as _datadog  # noqa: E402,F401
from veneur_tpu_torch.sinks import kafka as _kafka  # noqa: E402,F401
from veneur_tpu_torch.sinks import mock as _mock  # noqa: E402,F401
from veneur_tpu_torch.sinks import newrelic as _newrelic  # noqa: E402,F401
from veneur_tpu_torch.sinks import prometheus as _prometheus  # noqa: E402,F401
from veneur_tpu_torch.sinks import s3 as _s3  # noqa: E402,F401
from veneur_tpu_torch.sinks import signalfx as _signalfx  # noqa: E402,F401
