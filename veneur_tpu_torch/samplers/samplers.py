"""Flush-ready metric records and histogram aggregate configuration.

Mirrors `samplers/samplers.go:34-94` (InterMetric, metric type constants)
and the HistogramAggregates bitmask (`samplers/samplers.go` aggregates +
config parsing).  The samplers themselves (Counter/Gauge/Set/Histo/Status)
are not per-key objects here — their state lives in the batched device
arenas (veneur_tpu_torch/core/arena.py); this module defines the shared value
types both sides exchange.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional

# Metric type constants (samplers/samplers.go:50-60).
COUNTER = "counter"
GAUGE = "gauge"
STATUS = "status"

# Sampler type names used in MetricKey.Type (worker.go Upsert switch).
TYPE_COUNTER = "counter"
TYPE_GAUGE = "gauge"
TYPE_HISTOGRAM = "histogram"
TYPE_SET = "set"
TYPE_TIMER = "timer"
TYPE_STATUS = "status"


class Aggregate(enum.IntFlag):
    """Histogram aggregate selection bitmask (samplers/samplers.go)."""
    MAX = 1
    MIN = 2
    SUM = 4
    AVERAGE = 8
    COUNT = 16
    MEDIAN = 32
    HARMONIC_MEAN = 64


AGGREGATE_NAMES = {
    "max": Aggregate.MAX,
    "min": Aggregate.MIN,
    "sum": Aggregate.SUM,
    "avg": Aggregate.AVERAGE,
    "count": Aggregate.COUNT,
    "median": Aggregate.MEDIAN,
    "hmean": Aggregate.HARMONIC_MEAN,
}

# config.go:106-112 default aggregates
DEFAULT_AGGREGATES = Aggregate.MIN | Aggregate.MAX | Aggregate.COUNT


def parse_aggregates(names: list[str]) -> "HistogramAggregates":
    value = Aggregate(0)
    for n in names:
        agg = AGGREGATE_NAMES.get(n)
        if agg is not None:
            value |= agg
    return HistogramAggregates(value)


@dataclass(frozen=True)
class HistogramAggregates:
    value: Aggregate = DEFAULT_AGGREGATES

    @property
    def count(self) -> int:
        return bin(self.value).count("1")


@dataclass(slots=True)
class InterMetric:
    """The flush-ready record handed to sinks (samplers/samplers.go:34-47).

    Slotted: a high-cardinality flush constructs hundreds of thousands of
    these per interval; slots cut both per-object memory and init time."""
    name: str
    timestamp: int
    value: float
    tags: list[str]
    type: str  # counter | gauge | status
    message: str = ""
    hostname: str = ""
    # sink routing allowlist; None = all sinks (RouteInformation)
    sinks: Optional[set[str]] = None


@dataclass
class ForwardMetric:
    """A metric exported for forwarding to the global tier — the neutral
    in-memory twin of metricpb.Metric (samplers/metricpb/metric.proto).

    kind/scope are strings to keep this independent of generated protobuf;
    the gRPC layer converts to/from real protos.
    """
    name: str
    tags: list[str]
    kind: str                    # counter|gauge|histogram|timer|set
    scope: int                   # MetricScope value
    counter_value: int = 0
    gauge_value: float = 0.0
    # histogram payload (digest centroids + scalars)
    digest_means: Optional[list[float]] = None
    digest_weights: Optional[list[float]] = None
    digest_min: float = 0.0
    digest_max: float = 0.0
    digest_sum: float = 0.0
    digest_rsum: float = 0.0
    digest_compression: float = 100.0
    # moments-family histogram payload (sketches/moments.py vector;
    # mutually exclusive with the digest fields — a histogram/timer
    # ForwardMetric carries exactly one sketch family and the importer
    # routes by which is present)
    moments: Optional[list[float]] = None
    # compactor-family histogram payload (sketches/compactor.py wire
    # vector: self-describing header + level items; same exactly-one-
    # sketch-family contract as `moments`)
    compactor: Optional[list[float]] = None
    # set payload
    hll: bytes = b""


class MetricSegment:
    """A column-oriented run of flush-ready metrics: one (suffix, type)
    over a shared row set.

    This is the batched answer to the reference's generateInterMetrics
    cost center (`flusher.go:342-415`): instead of constructing one
    InterMetric struct per emitted value, the flush keeps each aggregate
    column (`.max`, `.count`, `.50percentile`, ...) as a numpy value
    array plus SHARED per-row name/tag columns.  `bases` and `tags` are
    the same list objects across every segment of a family, so a
    100k-key flush builds them once; per-row Python work is deferred to
    the consumer that actually needs record objects (a sink encoder).

    `sel` selects the subset of rows this column emits for (sparse
    emission guards, `samplers/samplers.go:359-514`); None means every
    row.  `values` is aligned with `sel` (or with the full row set when
    `sel` is None).  `sinks` (routing allowlists) is aligned the same
    way when present.
    """

    __slots__ = ("bases", "tags", "suffix", "values", "type", "sel",
                 "timestamp", "sinks")

    def __init__(self, bases, tags, suffix, values, type, timestamp,
                 sel=None, sinks=None):
        self.bases = bases
        self.tags = tags
        self.suffix = suffix
        self.values = values
        self.type = type
        self.timestamp = timestamp
        self.sel = sel
        self.sinks = sinks

    def __len__(self) -> int:
        return len(self.values)

    def row(self, i: int) -> int:
        return int(self.sel[i]) if self.sel is not None else i

    def metric(self, i: int) -> InterMetric:
        r = self.row(i)
        base = self.bases[r]
        return InterMetric(
            name=base + self.suffix if self.suffix else base,
            timestamp=self.timestamp, value=float(self.values[i]),
            tags=self.tags[r], type=self.type,
            sinks=self.sinks[i] if self.sinks is not None else None)

    def __iter__(self):
        bases, tags, suffix, values = (self.bases, self.tags, self.suffix,
                                       self.values)
        ts, typ, sinks = self.timestamp, self.type, self.sinks
        rows = (range(len(values)) if self.sel is None
                else map(int, self.sel))
        for i, r in enumerate(rows):
            base = bases[r]
            yield InterMetric(
                name=base + suffix if suffix else base, timestamp=ts,
                value=float(values[i]), tags=tags[r], type=typ,
                sinks=sinks[i] if sinks is not None else None)


class MetricBatch:
    """The flush-ready metric collection handed to sinks: columnar
    segments (high-cardinality families) plus a loose list of individual
    InterMetrics (status checks, odd one-offs).

    Behaves like a sequence of InterMetric — iteration, len, indexing and
    slicing all work — so sink encoders consume it unchanged and pay for
    per-record materialization only when they iterate.  Columnar-aware
    consumers read `segments` directly.
    """

    __slots__ = ("segments", "loose")

    def __init__(self, segments=None, loose=None):
        self.segments: list[MetricSegment] = segments or []
        self.loose: list[InterMetric] = loose if loose is not None else []

    def append(self, m: InterMetric) -> None:
        self.loose.append(m)

    def add_segment(self, seg: MetricSegment) -> None:
        if len(seg):
            self.segments.append(seg)

    def __len__(self) -> int:
        return sum(len(s) for s in self.segments) + len(self.loose)

    def __iter__(self):
        for seg in self.segments:
            yield from seg
        yield from self.loose

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            start, stop, step = idx.indices(len(self))
            if step != 1:
                return list(self)[idx]
            return self._slice(start, stop)
        if idx < 0:
            idx += len(self)
        got = self._slice(idx, idx + 1)
        if not got:
            raise IndexError(idx)
        return got[0]

    def _slice(self, start: int, stop: int) -> list[InterMetric]:
        out: list[InterMetric] = []
        off = 0
        for seg in self.segments:
            n = len(seg)
            lo, hi = max(start - off, 0), min(stop - off, n)
            for i in range(lo, hi):
                out.append(seg.metric(i))
            off += n
        lo, hi = max(start - off, 0), max(stop - off, 0)
        out.extend(self.loose[lo:hi])
        return out

    def __eq__(self, other):
        if isinstance(other, MetricBatch):
            return list(self) == list(other)
        if isinstance(other, list):
            return list(self) == other
        return NotImplemented

    def apply_routing(self, rules, match_fn) -> None:
        """Compute per-metric sink allowlists (flusher.go:97-113) across
        every segment row and loose metric.  `match_fn(rule.match, name,
        tags) -> bool`; a metric's allowlist is the union of `matched`
        lists of hitting rules plus `not_matched` of missing ones."""
        for seg in self.segments:
            sinks = []
            for i in range(len(seg)):
                r = seg.row(i)
                name = (seg.bases[r] + seg.suffix if seg.suffix
                        else seg.bases[r])
                allow: set = set()
                for rc in rules:
                    hit = match_fn(rc.match, name, seg.tags[r])
                    allow.update(rc.matched if hit else rc.not_matched)
                sinks.append(allow)
            seg.sinks = sinks
        for m in self.loose:
            allow = set()
            for rc in rules:
                hit = match_fn(rc.match, m.name, m.tags)
                allow.update(rc.matched if hit else rc.not_matched)
            m.sinks = allow
