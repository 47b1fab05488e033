"""ForwardMetric <-> metricpb.Metric conversion.

Counterpart of `veneur_tpu.forward.convert`: the neutral in-memory
ForwardMetric (`samplers/samplers.py`) maps onto the reference's wire
schema (samplers/metricpb/metric.proto): digests as MergingDigestData
centroid lists (`Histo.Metric()`, samplers/samplers.go:524-535), sets
as encoded HLL bytes (`Set.Metric()`, samplers.go:279-295),
counters/gauges as raw values.  The moments and compactor families
ride the histogram oneof behind a negative compression marker: -k for
a moments vector, -1024 - cap for a compactor ladder, their f64
vectors carried exactly as centroid means.  `to_pb` serializes to the
JAX package's bytes for every kind and family.
"""

from __future__ import annotations

from veneur_tpu_torch.protocol import metric_pb2, tdigest_pb2
from veneur_tpu_torch.samplers import samplers as sm
from veneur_tpu_torch.samplers.metric_key import MetricScope
from veneur_tpu_torch.sketches import compactor as comp
from veneur_tpu_torch.sketches import moments as mo

_KIND_TO_PB = {
    sm.TYPE_COUNTER: metric_pb2.Counter,
    sm.TYPE_GAUGE: metric_pb2.Gauge,
    sm.TYPE_HISTOGRAM: metric_pb2.Histogram,
    sm.TYPE_SET: metric_pb2.Set,
    sm.TYPE_TIMER: metric_pb2.Timer,
}
_PB_TO_KIND = {v: k for k, v in _KIND_TO_PB.items()}

_SCOPE_TO_PB = {
    MetricScope.MIXED: metric_pb2.Mixed,
    MetricScope.LOCAL_ONLY: metric_pb2.Local,
    MetricScope.GLOBAL_ONLY: metric_pb2.Global,
}
_PB_TO_SCOPE = {v: k for k, v in _SCOPE_TO_PB.items()}

# compression at or below this marks a compactor ladder (-1024 - cap);
# any other negative compression a moments vector (-k)
COMPACTOR_MARKER = -1024.0


def _vector_digest(vec: list, compression: float, idx_min: int,
                   idx_max: int, idx_rsum: int):
    """A family vector as a MergingDigestData: each element a centroid
    mean of weight 1; min/max/reciprocalSum mirror the vector's scalars
    for wire debuggers."""
    td = tdigest_pb2.MergingDigestData(
        compression=compression, min=vec[idx_min], max=vec[idx_max],
        reciprocalSum=vec[idx_rsum])
    for x in vec:
        td.main_centroids.add(mean=x, weight=1.0)
    return td


def to_pb(fm: sm.ForwardMetric) -> metric_pb2.Metric:
    m = metric_pb2.Metric(
        name=fm.name, tags=list(fm.tags),
        type=_KIND_TO_PB[fm.kind],
        scope=_SCOPE_TO_PB[MetricScope(fm.scope)])
    if fm.kind == sm.TYPE_COUNTER:
        m.counter.value = int(fm.counter_value)
    elif fm.kind == sm.TYPE_GAUGE:
        m.gauge.value = float(fm.gauge_value)
    elif fm.kind == sm.TYPE_SET:
        m.set.hyper_log_log = fm.hll
    elif fm.compactor is not None:      # histogram / timer, compactor
        vec = [float(x) for x in fm.compactor]
        cap, _, _ = comp.params_from_vector(vec)
        m.histogram.t_digest.CopyFrom(_vector_digest(
            vec, COMPACTOR_MARKER - float(cap), comp.IDX_MIN,
            comp.IDX_MAX, comp.IDX_RSUM))
    elif fm.moments is not None:        # histogram / timer, moments
        vec = [float(x) for x in fm.moments]
        m.histogram.t_digest.CopyFrom(_vector_digest(
            vec, -float(mo.k_from_len(len(vec))), mo.IDX_MIN, mo.IDX_MAX,
            mo.IDX_RSUM))
    else:                               # histogram / timer, t-digest
        td = tdigest_pb2.MergingDigestData(
            compression=fm.digest_compression,
            min=fm.digest_min, max=fm.digest_max,
            reciprocalSum=fm.digest_rsum)
        for mean, weight in zip(fm.digest_means or [],
                                fm.digest_weights or []):
            td.main_centroids.add(mean=float(mean), weight=float(weight))
        m.histogram.t_digest.CopyFrom(td)
    return m


def from_pb(m: metric_pb2.Metric) -> sm.ForwardMetric:
    fm = sm.ForwardMetric(
        name=m.name, tags=list(m.tags), kind=_PB_TO_KIND[m.type],
        scope=int(_PB_TO_SCOPE[m.scope]))
    which = m.WhichOneof("value")
    if which == "counter":
        fm.counter_value = m.counter.value
    elif which == "gauge":
        fm.gauge_value = m.gauge.value
    elif which == "set":
        fm.hll = m.set.hyper_log_log
    elif which == "histogram":
        td = m.histogram.t_digest
        if td.compression <= COMPACTOR_MARKER:
            fm.compactor = [c.mean for c in td.main_centroids]
        elif td.compression < 0:
            fm.moments = [c.mean for c in td.main_centroids]
        else:
            fm.digest_means = [c.mean for c in td.main_centroids]
            fm.digest_weights = [c.weight for c in td.main_centroids]
            fm.digest_compression = td.compression or 100.0
            fm.digest_min = td.min
            fm.digest_max = td.max
            fm.digest_rsum = td.reciprocalSum
    else:
        raise ValueError("can't import a metric with a nil value")
    return fm
