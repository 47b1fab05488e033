"""Metric sink interface (`sinks/sinks.go:42-106`).

The sinks this package ships are the simple ones (`sinks/simple.py`):
blackhole, channel (each flush to an in-process queue), debug (to the
log), jsonl (JSON lines for a harness in another process) and localfile
(TSV rows).  Sinks receive each flush's `MetricBatch` synchronously
from `Server.flush`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from veneur_tpu_torch.samplers.samplers import InterMetric


@dataclass
class MetricFlushResult:
    """sinks.MetricFlushResult: accounting reported by each flush."""
    flushed: int = 0
    skipped: int = 0
    dropped: int = 0


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
    """One entry of metric_sinks (config.go:95-104).  The per-sink
    limits after `config` are the JAX package's fields, which its egress
    plane applies (ROADMAP A10): accepted at their defaults, refused
    (NotImplementedError) at any other value."""
    kind: str
    name: str = ""
    config: dict = field(default_factory=dict)
    max_name_length: int = 0
    max_tag_length: int = 0
    max_tags: int = 0
    strip_tags: list = field(default_factory=list)
    add_tags: dict = field(default_factory=dict)

    def __post_init__(self) -> None:
        for opt in ("max_name_length", "max_tag_length", "max_tags",
                    "strip_tags", "add_tags"):
            if getattr(self, opt):
                raise NotImplementedError(
                    f"sink option {opt}={getattr(self, opt)!r} of sink "
                    f"{self.name!r} is not supported here (per-sink "
                    "limits, ROADMAP A10)")

    @classmethod
    def from_dict(cls, d: dict) -> "SinkSpec":
        return cls(kind=d["kind"], name=d.get("name", d["kind"]),
                   config=d.get("config") or {},
                   max_name_length=d.get("max_name_length", 0),
                   max_tag_length=d.get("max_tag_length", 0),
                   max_tags=d.get("max_tags", 0),
                   strip_tags=d.get("strip_tags", []),
                   add_tags=d.get("add_tags") or {})


def create_metric_sink(spec: SinkSpec, server_config=None):
    from veneur_tpu_torch.sinks import simple
    factory = simple.METRIC_SINK_TYPES.get(spec.kind)
    if factory is None:
        raise NotImplementedError(
            f"metric sink kind {spec.kind!r} is not ported "
            f"(available: {sorted(simple.METRIC_SINK_TYPES)})")
    return factory(spec, server_config)
