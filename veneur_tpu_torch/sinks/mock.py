"""Recording metric sink double for tests (`veneur_tpu.sinks.mock`'s
metric half; its span half comes with the span pipeline, ROADMAP A15).

A plain recorder: it captures every call so tests assert on exact
payloads.
"""

from __future__ import annotations

from typing import Optional

from veneur_tpu_torch import sinks as sink_mod


@sink_mod.register_metric_sink("mock")
class MockMetricSink(sink_mod.BaseMetricSink):
    KIND = "mock"

    def __init__(self, spec: Optional[sink_mod.SinkSpec] = None,
                 server_config=None, fail: bool = False):
        spec = spec or sink_mod.SinkSpec(kind=self.KIND)
        super().__init__(spec.name, spec.config)
        self.started = False
        self.fail = fail
        self.flushes: list[list] = []
        self.other_samples: list = []

    def start(self, trace_client=None) -> None:
        self.started = True

    def flush(self, metrics):
        if self.fail:
            return sink_mod.MetricFlushResult(dropped=len(metrics))
        self.flushes.append(list(metrics))
        return sink_mod.MetricFlushResult(flushed=len(metrics))

    def flush_other_samples(self, samples):
        self.other_samples.extend(samples)

    @property
    def metrics(self) -> list:
        return [m for fl in self.flushes for m in fl]
