"""MetricAggregator: ingest/import/flush over the batched arenas.

Counterpart of `veneur_tpu.core.aggregator`: the fusion of the
reference's Worker (`worker.go:348-459`: ProcessMetric / ImportMetric
scope dispatch) and flusher (`flusher.go:26-122,286-415`:
tally + InterMetric generation with the local/global flush duality).

Flush duality (`flusher.go:57-74`):
  - a *local* instance emits histogram aggregates from local-sample
    scalars and NO percentiles for mixed-scope keys (those forward their
    digests to the global tier), but full percentiles for local-only keys;
  - a *global* instance emits percentiles (and digest-derived aggregates
    for global-scope keys), plus sets and global counters/gauges.

Sketch families: histogram and timer samples land in the t-digest arena
or, per key by `sketch_family_default` / `sketch_family_rules`, in the
moments arena (`MomentsArena`, flushed by B5 and the maxent solver of
`ops/moments_eval.py`) or the compactor arena (`CompactorArena`, whose
flush folds the interval into the ladders with B6 and reads quantiles
off them, `ops/compactor_eval.py`); an imported moments or compactor
vector merges into its family's arena whatever the rules say.

Cardinality guard (`core/cardinality.py`): with
`cardinality_key_budget`, every tenanted key of the ingest and import
edges resolves through the guard before its family is chosen; an
over-budget tenant's tail lands in its rollup key (routed by
`cardinality_rollup_family`), and each flush's cut runs the guard's
eviction pass, releasing evicted rows, before the cube maintainer's.

Group-by cubes (`cubes/`): with `cube_dimensions`, each histogram/timer
sample also lands in its cube groups' rows (ordinary keys of the arena
its family picks); the maintainer's promotion pass runs after each
snapshot and releases evicted group rows.  The live query plane
(`query/`): with `query_window_slots`, every flush cut rotates each
family's snapshot part into a window ring, which `QueryEngine` reads.

Meshed flush (`mesh=`, `parallel/mesh.py`): the t-digest, set, counter
and unique-timeseries families evaluate in ONE program over the mesh
(`serving.make_serving_flush(mesh)`): the dense build takes the mesh's
row layout and is placed block by block on its devices, the set
registers and counters are device lanes reduced over the replica axis,
and the host reads back one flat buffer (plus the merged set registers
a local tier forwards).  The moments arena stays unmeshed and its
solve splits over the key axis of every mesh device
(`make_moments_flush(mesh=)`); the compactor family runs on the mesh's
home device, as it runs single-device in the JAX package.

Concurrency: ingest appends to host staging under `lock`; a flush holds
the lock only to sync staging, snapshot the touched rows and reset.  The
dense builds, uploads and kernel launches run outside the lock
(`flush_dispatch`, asynchronous on the current CUDA stream); the one
wait is the readback in `PendingFlush.emit`.
"""

from __future__ import annotations

import fnmatch
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from veneur_tpu_torch import ingest, resolve_device
from veneur_tpu_torch.config import (SKETCH_FAMILIES, check_mesh_families,
                                     parse_family_rules)
from veneur_tpu_torch.core import arena as arena_mod
from veneur_tpu_torch.core.cardinality import ROLLUP_TAG, CardinalityGuard
from veneur_tpu_torch.cubes import CubeMaintainer, parse_dimensions
from veneur_tpu_torch.forward import convert
from veneur_tpu_torch.ops import compactor_eval as ce
from veneur_tpu_torch.ops import moments_eval as me
from veneur_tpu_torch.parallel import serving
from veneur_tpu_torch.protocol import forward_pb2, metric_pb2
from veneur_tpu_torch.query.rings import WindowRing
from veneur_tpu_torch.samplers import samplers as sm
from veneur_tpu_torch.samplers.metric_key import (MetricKey, MetricScope,
                                                  UDPMetric)
from veneur_tpu_torch.sketches import hll as hll_mod
from veneur_tpu_torch.sketches import moments as mo
from veneur_tpu_torch.sketches import tdigest as td

# ceiling for the [rows, depth] block of one digest_export chunk
# (elements); keeps the compress intermediates bounded on a large
# forwarding tier
_EXPORT_ELEM_BUDGET = 1 << 26


@dataclass
class FlushResult:
    metrics: sm.MetricBatch = field(default_factory=sm.MetricBatch)
    forward: list[sm.ForwardMetric] = field(default_factory=list)
    processed: int = 0
    imported: int = 0
    # HLL estimate of distinct timeseries this interval, or None when
    # count_unique_timeseries is off (flusher.go:42-44)
    unique_ts: Optional[int] = None


class PendingFlush:
    """A dispatched-but-not-yet-emitted flush: the snapshot is taken, the
    dense staging uploaded and the kernel launched, but nothing has
    waited on the device.  emit() reads back and generates the
    InterMetric batch; call it exactly once."""

    def __init__(self, agg, snap, pend, res, is_local, now):
        self._args = (snap, pend, res, is_local, now)
        self._agg = agg
        self._done = False

    def emit(self) -> FlushResult:
        if self._done:
            raise RuntimeError("PendingFlush.emit() called twice")
        self._done = True
        return self._agg._emit_pending(*self._args)


class MetricAggregator:
    def __init__(self,
                 percentiles: Optional[list[float]] = None,
                 aggregates: sm.HistogramAggregates = sm.HistogramAggregates(),
                 compression: float = td.DEFAULT_COMPRESSION,
                 set_precision: int = hll_mod.DEFAULT_PRECISION,
                 count_unique_timeseries: bool = False,
                 is_local: bool = True, initial_capacity: int = 0,
                 set_initial_capacity: int = 0,
                 hll_legacy_migration: bool = False,
                 sketch_family_default: str = "tdigest",
                 sketch_family_rules: Optional[list] = None,
                 sketch_moments_k: int = mo.DEFAULT_K,
                 sketch_compactor_cap: int = 0,
                 sketch_compactor_levels: int = 0,
                 sketch_compactor_seed: int = 0,
                 digest_bf16_staging: bool = False,
                 query_window_slots: int = 0,
                 query_slot_seconds: float = 0.0,
                 cube_dimensions: Optional[list] = None,
                 cube_group_budget: int = 0,
                 cube_seed: int = 0,
                 cardinality_key_budget: int = 0,
                 cardinality_tenant_tag: str = "tenant",
                 cardinality_seed: int = 0,
                 cardinality_rollup_family: str = "tdigest",
                 mesh=None, ingest_lanes: Optional[int] = None,
                 device=None):
        # ingest_lanes is accepted for configuration compatibility, as
        # the JAX package accepts it: the stateless digest design has no
        # ingest lanes (depth splits over the replica axis instead)
        del ingest_lanes
        self.mesh = mesh
        if mesh is not None:
            if (device is not None
                    and torch.device(device).type != mesh.home.type):
                raise ValueError(f"device {device} does not match the "
                                 f"mesh's devices ({mesh.home})")
            self.device = mesh.home
        else:
            self.device = resolve_device(device)
        self.percentiles = percentiles if percentiles is not None else [0.5]
        self.aggregates = aggregates
        self.lock = threading.Lock()
        kw, set_kw = {}, {}
        if initial_capacity > arena_mod._INITIAL_CAPACITY:
            cap = arena_mod._pow2(initial_capacity)
            kw = {"capacity": cap}
            set_kw = {"capacity": min(cap, 8192)}
        if set_initial_capacity > arena_mod._INITIAL_CAPACITY:
            set_kw = {"capacity": arena_mod._pow2(set_initial_capacity)}
        # bf16 staging narrows the t-digest dense values only; the
        # moments family ignores it, as in the JAX package
        self.digests = arena_mod.DigestArena(
            compression=compression, device=self.device,
            bf16_staging=digest_bf16_staging, mesh=mesh, **kw)
        # sketch-family dispatch: rules match at ingest, first hit wins
        # (name glob or tenant tag); imports route by their payload
        # (rollup identities of the cardinality guard route by
        # cardinality_rollup_family)
        self._fam_default = sketch_family_default
        self._fam_rules = parse_family_rules(sketch_family_default,
                                             sketch_family_rules or [])
        if cardinality_rollup_family not in SKETCH_FAMILIES:
            raise ValueError(f"unknown sketch family "
                             f"{cardinality_rollup_family!r} "
                             "(tdigest | moments | compactor)")
        self._rollup_family = cardinality_rollup_family
        if mesh is not None:
            check_mesh_families(
                {sketch_family_default}
                | {fam for _, _, fam in self._fam_rules}
                | ({cardinality_rollup_family}
                   if cardinality_key_budget > 0 else set()))
        self.family_dispatch = bool(
            self._fam_rules or self._fam_default != "tdigest"
            or (cardinality_key_budget > 0
                and cardinality_rollup_family != "tdigest"))
        self._fam_cache: dict = {}
        # pre-sized only when the rules can route keys here (the ivec
        # plane is f64 and capacity-sized)
        self.moments = arena_mod.MomentsArena(
            k=sketch_moments_k, device=self.device,
            **(kw if self.family_dispatch else {}))
        # the arena stays unmeshed; a mesh splits the solve over the
        # key axis (bitwise the unmeshed program)
        self.moments_fn = me.make_moments_flush(self.moments.k, self.device,
                                                mesh=mesh)
        self.last_moments_resid = 0.0
        # the compactor arena always exists too (imports may deliver
        # ladders whatever the rules say), pre-sized as the moments one
        self.compactors = arena_mod.CompactorArena(
            cap=sketch_compactor_cap, levels=sketch_compactor_levels,
            seed=sketch_compactor_seed, device=self.device,
            **(kw if self.family_dispatch else {}))
        self.compactor_fn = ce.make_compactor_flush(
            self.compactors.cc_cap, self.compactors.cc_levels, self.device)
        self.sets = arena_mod.SetArena(precision=set_precision,
                                       legacy_migration=hll_legacy_migration,
                                       mesh=mesh, **set_kw)
        self.counters = arena_mod.CounterArena(mesh=mesh, **kw)
        self.gauges = arena_mod.GaugeArena(**kw)
        self.status = arena_mod.StatusArena(**kw)
        # the per-tenant key budget and tail rollup (None: off).  It
        # applies at the ingest edge (the Python path and the native
        # drain) and at the import edge, where a local's rollup keys
        # arrive as ordinary keys
        self.cardinality = (
            CardinalityGuard(cardinality_key_budget,
                             tenant_tag=cardinality_tenant_tag,
                             seed=cardinality_seed)
            if cardinality_key_budget > 0 else None)
        # group-by sketch cubes (cubes/): config-declared dimensions
        # mirror each histogram/timer sample into per-group rollup rows,
        # ordinary arena keys that flush, forward and window like any
        # other.  Ingest edge only: forwarded cube rows come back through
        # the import path as ordinary keys (materializing there would
        # double-count)
        self.cubes = None
        if cube_dimensions and cube_group_budget > 0:
            self.cubes = CubeMaintainer(parse_dimensions(cube_dimensions),
                                        cube_group_budget, seed=cube_seed)
        # the live query plane (query/): a bounded ring of per-interval
        # sub-sketches per histogram family.  A slot IS the flush cut's
        # snapshot part (no copies, no lock on the ingest path); rings
        # are not checkpointed, so a restore starts them empty
        self.query_rings = None
        if query_window_slots > 0:
            self.query_rings = {
                fam: WindowRing(query_window_slots, query_slot_seconds)
                for fam in ("tdigest", "moments", "compactor")}
        self.processed = 0
        self.imported = 0
        # (name, tags, kind) -> row of the batched V1 import's counters
        # and gauges; cleared at every flush cut, before the idle GC can
        # recycle a row
        self._import_row_cache: dict = {}
        self.count_unique_timeseries = count_unique_timeseries
        self.unique_ts = (hll_mod.HLLSketch() if count_unique_timeseries
                          else None)
        self.is_local = is_local
        # unmeshed: the digest evaluation alone (sets, counters and
        # unique-ts resolve on the host); meshed: the full-family program
        self.flush_fn = serving.make_serving_flush(mesh, self.device)
        self._uts_m = (self.unique_ts.m if self.unique_ts is not None
                       else 1 << hll_mod.DEFAULT_PRECISION)
        self._pct = serving.percentile_tensor(self.percentiles, self.device)
        # measured segments of the last flush (seconds; kernel_ms from
        # CUDA events on the device)
        self.last_flush_segments: dict = {}
        # seconds the last checkpoint_state held the lock
        self.last_capture_s = 0.0

    # -- sketch-family dispatch ----------------------------------------------

    _FAM_CACHE_CAP = 65536

    def _card_resolve(self, key, scope, tags, n: int = 1):
        """The cardinality guard at the ingest and import edges: an
        under-budget (or untenanted) key passes through; an over-budget
        tenant's tail rewrites to its rollup identity."""
        g = self.cardinality
        if g is None:
            return key, scope, tags
        rolled = g.resolve(key, scope, tags, n)
        return (key, scope, tags) if rolled is None else rolled

    def _family_of(self, key: MetricKey, tags) -> str:
        """Family of one histogram/timer key: rollup identities take the
        rollup family, then the first matching rule (name glob / tenant
        tag), then the default.  Memoized on the key identity
        (bounded)."""
        ck = (key.name, key.joined_tags)
        hit = self._fam_cache.get(ck)
        if hit is not None:
            return hit
        if ROLLUP_TAG in tags:
            fam = self._rollup_family
        else:
            fam = next((rfam for pattern, tenant, rfam in self._fam_rules
                        if (fnmatch.fnmatchcase(key.name, pattern)
                            if pattern is not None
                            else f"tenant:{tenant}" in tags)),
                       self._fam_default)
        if len(self._fam_cache) < self._FAM_CACHE_CAP:
            self._fam_cache[ck] = fam
        return fam

    def _histo_arena(self, key: MetricKey, tags):
        """The arena a histogram/timer key's raw samples land in (call
        after _card_resolve, so a rollup identity routes by the rollup
        family)."""
        if not self.family_dispatch:
            return self.digests
        fam = self._family_of(key, tags)
        if fam == "moments":
            return self.moments
        if fam == "compactor":
            return self.compactors
        return self.digests

    # -- ingest (ProcessMetric, worker.go:348-396) ---------------------------

    def process_metric(self, m: UDPMetric) -> None:
        with self.lock:
            self._process_locked(m)

    def process_batch(self, ms: list[UDPMetric]) -> None:
        with self.lock:
            for m in ms:
                self._process_locked(m)

    def _process_locked(self, m: UDPMetric) -> None:
        self.processed += 1
        if self.unique_ts is not None:
            self._sample_timeseries(m)
        t = m.type
        if t == sm.TYPE_COUNTER:
            scope = (MetricScope.GLOBAL_ONLY
                     if m.scope == MetricScope.GLOBAL_ONLY
                     else MetricScope.MIXED)
            key, scope, tags = self._card_resolve(m.key, scope, m.tags)
            row = self.counters.row_for(key, scope, tags)
            self.counters.sample(row, m.value, m.sample_rate)
        elif t == sm.TYPE_GAUGE:
            scope = (MetricScope.GLOBAL_ONLY
                     if m.scope == MetricScope.GLOBAL_ONLY
                     else MetricScope.MIXED)
            key, scope, tags = self._card_resolve(m.key, scope, m.tags)
            row = self.gauges.row_for(key, scope, tags)
            self.gauges.sample(row, m.value)
        elif t in (sm.TYPE_HISTOGRAM, sm.TYPE_TIMER):
            key, scope, tags = self._card_resolve(m.key, m.scope, m.tags)
            arena = self._histo_arena(key, tags)
            row = arena.row_for(key, scope, tags)
            arena.sample(row, m.value, m.sample_rate)
            if self.cubes is not None:
                # the sample ALSO lands in each matching group's row
                # (family by the cube key, so like groups merge
                # family-coherently across tiers); an over-budget group
                # lands in the accounted veneur.cube.other row instead
                for ck, cscope, ctags in self.cubes.rollups(key, scope,
                                                            tags):
                    carena = self._histo_arena(ck, ctags)
                    crow = carena.row_for(ck, cscope, ctags)
                    carena.sample(crow, m.value, m.sample_rate)
        elif t == sm.TYPE_SET:
            scope = (MetricScope.LOCAL_ONLY
                     if m.scope == MetricScope.LOCAL_ONLY
                     else MetricScope.MIXED)
            key, scope, tags = self._card_resolve(m.key, scope, m.tags)
            row = self.sets.row_for(key, scope, tags)
            self.sets.sample(row, str(m.value))
        elif t == sm.TYPE_STATUS:
            row = self.status.row_for(m.key, MetricScope.LOCAL_ONLY, m.tags)
            self.status.sample(row, float(m.value), m.message, m.hostname)
        # unknown types are silently skipped, as in worker.go:393-395

    def _sample_timeseries(self, m: UDPMetric) -> None:
        """Unique-timeseries HLL counting (worker.go:301-345): sample iff
        the series is finalized on this instance — always on a global
        instance, else only non-forwarded types."""
        if not self.is_local:
            self.unique_ts.insert(m.digest.to_bytes(8, "little"))
            return
        local_types = {
            sm.TYPE_COUNTER: m.scope != MetricScope.GLOBAL_ONLY,
            sm.TYPE_GAUGE: m.scope != MetricScope.GLOBAL_ONLY,
            sm.TYPE_HISTOGRAM: m.scope == MetricScope.LOCAL_ONLY,
            sm.TYPE_SET: m.scope == MetricScope.LOCAL_ONLY,
            sm.TYPE_TIMER: m.scope == MetricScope.LOCAL_ONLY,
            sm.TYPE_STATUS: True,
        }
        if local_types.get(m.type, False):
            self.unique_ts.insert(m.digest.to_bytes(8, "little"))

    # -- import (ImportMetric, worker.go:402-459) ----------------------------

    def import_metric(self, fm: sm.ForwardMetric) -> None:
        with self.lock:
            self._import_locked(fm, None)

    def import_metrics(self, fms) -> tuple[int, int]:
        """Batched import of a forwarded list: one lock for the whole
        list, and its moments vectors merged in bulk
        (`_merge_staged_moments`: bit-identical to one import_metric
        each).  A metric that import_metric refuses fails alone.
        Returns (imported, failed)."""
        ok = failed = 0
        staged: list = []
        with self.lock:
            for fm in fms:
                try:
                    self._import_locked(fm, staged)
                    ok += 1
                except (ValueError, NotImplementedError):
                    failed += 1
            self._merge_staged_moments(staged)
        return ok, failed

    def _merge_staged_moments(self, staged: list) -> None:
        """Merge (row, vector) pairs into the moments arena
        (`MomentsArena.merge_moments_batch`) in rounds of distinct rows,
        so each row takes its vectors in arrival order.  Under
        self.lock."""
        if not staged:
            return
        rows = np.fromiter((r for r, _ in staged), np.int64, len(staged))
        vecs = np.stack([v for _, v in staged])
        # the r-th vector of each row merges in round r
        order = np.argsort(rows, kind="stable")
        first = np.searchsorted(rows[order], rows[order])
        rnd = np.empty(len(rows), np.int64)
        rnd[order] = np.arange(len(rows)) - first
        for r in range(int(rnd.max()) + 1):
            sel = rnd == r
            self.moments.merge_moments_batch(rows[sel], vecs[sel])

    def _import_locked(self, fm: sm.ForwardMetric, staged) -> None:
        """One import under self.lock; moments vectors are checked and
        appended to `staged` as (row, vector) when it is a list, else
        merged now."""
        scope = self._import_scope(fm)
        self.imported += 1
        self._merge_locked(fm, scope, staged)

    @staticmethod
    def _import_scope(fm: sm.ForwardMetric) -> MetricScope:
        """The scope an import lands in (worker.go:402-459): counters and
        gauges are global; a local-only metric is refused."""
        scope = MetricScope(fm.scope)
        if fm.kind in (sm.TYPE_COUNTER, sm.TYPE_GAUGE):
            scope = MetricScope.GLOBAL_ONLY
        if scope == MetricScope.LOCAL_ONLY:
            raise ValueError("gRPC import does not accept local metrics")
        return scope

    def _merge_locked(self, fm: sm.ForwardMetric, scope: MetricScope,
                      staged) -> None:
        """Route one forwarded metric into its arena (the payload names
        its sketch family) and merge it, its identity through the
        cardinality guard first."""
        key = MetricKey(fm.name, fm.kind, ",".join(sorted(fm.tags)))
        if fm.kind == sm.TYPE_COUNTER:
            key, cls, tags = self._card_resolve(
                key, MetricScope.GLOBAL_ONLY, fm.tags)
            row = self.counters.row_for(key, cls, tags)
            self.counters.merge(row, fm.counter_value)
        elif fm.kind == sm.TYPE_GAUGE:
            key, cls, tags = self._card_resolve(
                key, MetricScope.GLOBAL_ONLY, fm.tags)
            row = self.gauges.row_for(key, cls, tags)
            self.gauges.merge(row, fm.gauge_value)
        elif fm.kind == sm.TYPE_SET:
            key, cls, tags = self._card_resolve(key, MetricScope.MIXED,
                                                fm.tags)
            row = self.sets.row_for(key, cls, tags)
            self.sets.merge(row, fm.hll)
        elif fm.kind in (sm.TYPE_HISTOGRAM, sm.TYPE_TIMER):
            cls = (MetricScope.GLOBAL_ONLY
                   if scope == MetricScope.GLOBAL_ONLY
                   else MetricScope.MIXED)
            key, cls, tags = self._card_resolve(key, cls, fm.tags)
            if fm.moments is not None:
                # the payload describes itself: a moments vector
                # merges into the moments arena whatever the rules
                row = self.moments.row_for(key, cls, tags)
                if staged is None:
                    self.moments.merge_moments(row, fm.moments)
                else:
                    staged.append(
                        (row, self.moments.checked_vector(fm.moments)))
            elif fm.compactor is not None:
                # the same payload routing for a ladder: concatenate,
                # then one host compaction pass
                row = self.compactors.row_for(key, cls, tags)
                self.compactors.merge_compactor(row, fm.compactor)
            else:
                row = self.digests.row_for(key, cls, tags)
                self.digests.merge_digest(
                    row, fm.digest_means or [],
                    fm.digest_weights or [], fm.digest_min,
                    fm.digest_max, fm.digest_rsum)
        else:
            raise ValueError(f"unknown metric kind {fm.kind!r}")

    # value oneof -> the wire `type` values it may carry
    # (metricpb/metric.proto).  The batched import dispatches on the
    # oneof and rejects a metric whose `type` contradicts it (type=Timer
    # carrying a CounterValue), as the JAX package's does
    _ONEOF_LEGAL_TYPES = {
        "counter": (0,),        # metric_pb2.Counter
        "gauge": (1,),          # metric_pb2.Gauge
        "set": (3,),            # metric_pb2.Set
        "histogram": (2, 4),    # metric_pb2.Histogram / Timer
    }

    def import_pb_batch(self, pbs) -> tuple[int, int]:
        """Batched V1 import (`veneur_tpu/core/aggregator.py:609`): one
        lock for the whole MetricList, the protobuf fields read
        directly, counter and gauge rows found through an identity
        cache (cleared every flush; off while the cardinality guard is
        armed, since every record must reach the guard for its touch
        count) and merged vectorized; sets,
        digests, moments vectors and ladders take import_metric's
        routing.  Scope and nil semantics are import_metric's; a metric
        whose `type` contradicts its value oneof is refused.  A refused
        metric fails alone.  Returns (imported, failed)."""
        ok = failed = 0
        cache = self._import_row_cache
        cached = self.cardinality is None
        legal = self._ONEOF_LEGAL_TYPES
        c_rows: list = []
        c_vals: list = []
        g_rows: list = []
        g_vals: list = []
        staged: list = []
        with self.lock:
            for pb in pbs:
                try:
                    which = pb.WhichOneof("value")
                    if which is None:
                        raise ValueError("nil value")
                    if pb.type not in legal[which]:
                        raise ValueError(
                            f"type/value mismatch: type={pb.type} "
                            f"carrying {which}")
                    if which in ("counter", "gauge"):
                        kind = (sm.TYPE_COUNTER if which == "counter"
                                else sm.TYPE_GAUGE)
                        ck = (pb.name, tuple(pb.tags), kind)
                        row = cache.get(ck) if cached else None
                        if row is None:
                            tags = list(pb.tags)
                            arena = (self.counters if which == "counter"
                                     else self.gauges)
                            row = arena.row_for(*self._card_resolve(
                                MetricKey(pb.name, kind,
                                          ",".join(sorted(tags))),
                                MetricScope.GLOBAL_ONLY, tags))
                            if cached:
                                cache[ck] = row
                        if which == "counter":
                            c_rows.append(row)
                            c_vals.append(pb.counter.value)
                        else:
                            g_rows.append(row)
                            g_vals.append(pb.gauge.value)
                    else:
                        fm = convert.from_pb(pb)
                        self._merge_locked(fm, self._import_scope(fm),
                                           staged)
                    self.imported += 1
                    ok += 1
                except Exception:   # noqa: BLE001 - wire input: fails alone
                    failed += 1
            self._merge_staged_moments(staged)
            if c_rows:
                self.counters.merge_batch(np.asarray(c_rows, np.int64),
                                          np.asarray(c_vals, np.float64))
            if g_rows:
                self.gauges.merge_batch(np.asarray(g_rows, np.int64),
                                        np.asarray(g_vals, np.float64))
        return ok, failed

    # the value oneof codes of the native wire scan (`ingest.import_scan`)
    _SCAN_WHICH = {1: "counter", 2: "gauge", 3: "set", 4: "histogram"}

    def import_payload(self, payload: bytes) -> tuple[int, int]:
        """V1 import from a MetricList's bytes
        (`veneur_tpu/core/aggregator.py:741-852`): the native wire scan
        (`ingest.import_scan`) yields each record's identity hash, value
        oneof, type and counter or gauge value, so a counter or gauge
        whose identity was seen this interval costs one cache lookup,
        and each family merges vectorized; set and histogram records
        parse alone from their byte ranges and take import_metric's
        routing.  Type/oneof agreement, scope and refusals are
        import_pb_batch's.  A payload that fails the wire scan goes to
        import_pb_batch, which imports or raises as for any malformed
        bytes; an engine that cannot build or load raises.  The scan
        never materializes tags, which the cardinality guard classifies
        on, so while the guard is armed every payload takes
        import_pb_batch.  Returns (imported, failed)."""
        scan = (ingest.import_scan(payload) if self.cardinality is None
                else None)
        if scan is None:
            return self.import_pb_batch(
                forward_pb2.MetricList.FromString(payload).metrics)
        n = scan["n"]
        if n == 0:
            return 0, 0
        h_lo = scan["h_lo"].tolist()
        h_hi = scan["h_hi"].tolist()
        which = scan["which"].tolist()
        mtypes = scan["mtype"].tolist()
        vals = scan["value"].tolist()
        offs = scan["rec_off"].tolist()
        lens = scan["rec_len"].tolist()
        cache = self._import_row_cache
        legal = self._ONEOF_LEGAL_TYPES
        c_rows: list = []
        c_vals: list = []
        g_rows: list = []
        g_vals: list = []
        staged: list = []
        ok = failed = 0
        with self.lock:
            for i in range(n):
                kind = self._SCAN_WHICH.get(which[i])
                # a nil value, or a type its value oneof cannot carry,
                # fails before any parse (and before the row cache)
                if kind is None or mtypes[i] not in legal[kind]:
                    failed += 1
                    continue
                try:
                    if kind in ("counter", "gauge"):
                        ck = (h_lo[i], h_hi[i], which[i])
                        row = cache.get(ck)
                        if row is None:
                            pb = metric_pb2.Metric.FromString(
                                payload[offs[i]:offs[i] + lens[i]])
                            tags = list(pb.tags)
                            mkind = (sm.TYPE_COUNTER if kind == "counter"
                                     else sm.TYPE_GAUGE)
                            arena = (self.counters if kind == "counter"
                                     else self.gauges)
                            row = cache[ck] = arena.row_for(
                                MetricKey(pb.name, mkind,
                                          ",".join(sorted(tags))),
                                MetricScope.GLOBAL_ONLY, tags)
                        if kind == "counter":
                            c_rows.append(row)
                            c_vals.append(vals[i])
                        else:
                            g_rows.append(row)
                            g_vals.append(vals[i])
                    else:
                        fm = convert.from_pb(metric_pb2.Metric.FromString(
                            payload[offs[i]:offs[i] + lens[i]]))
                        self._merge_locked(fm, self._import_scope(fm),
                                           staged)
                    self.imported += 1
                    ok += 1
                except Exception:   # noqa: BLE001 - wire input: fails alone
                    failed += 1
            self._merge_staged_moments(staged)
            if c_rows:
                self.counters.merge_batch(np.asarray(c_rows, np.int64),
                                          np.asarray(c_vals, np.float64))
            if g_rows:
                self.gauges.merge_batch(np.asarray(g_rows, np.int64),
                                        np.asarray(g_vals, np.float64))
        return ok, failed

    def sync_staged(self, min_samples: int = 0) -> bool:
        """Consolidate staged samples now if the backlog is worth it (the
        drain loop's per-tick sync), so flush-time sync covers only the
        final partial tick."""
        with self.lock:
            if (self.digests.staged_count() + self.moments.staged_count()
                    + self.compactors.staged_count()
                    + self.sets.staged_count()
                    < (min_samples if min_samples > 0 else 4096)):
                return False
            self.digests.sync()
            self.moments.sync()
            self.compactors.sync()
            self.sets.sync()
            return True

    # -- checkpoint ----------------------------------------------------------

    _FAMILIES = ("digests", "moments", "compactors", "sets", "counters",
                 "gauges", "status")

    def checkpoint_state(self) -> tuple[dict, dict]:
        """One coherent cut of every arena (plus unique-ts registers and
        the cardinality guard's quota ledger), in the JAX package's
        (meta, arrays) layout.  Under the lock it syncs the staging and
        takes each arena's `checkpoint_capture` (copies only); the
        per-key rendering runs after the lock is released, so ingest
        never queues behind it.  `last_capture_s` is the lock's hold."""
        with self.lock:
            t0 = time.perf_counter()
            self.digests.sync()
            self.moments.sync()
            self.compactors.sync()
            self.sets.sync()
            meta: dict = {"processed": self.processed,
                          "imported": self.imported, "families": {}}
            arrays: dict = {}
            caps = {name: getattr(self, name).checkpoint_capture()
                    for name in self._FAMILIES}
            if self.unique_ts is not None:
                arrays["unique_ts/regs"] = self.unique_ts.regs.copy()
            if self.cardinality is not None:
                # bounded by the budget, not by the key space
                meta["cardinality"] = self.cardinality.checkpoint_state()
            self.last_capture_s = time.perf_counter() - t0
        for name, cap in caps.items():
            fmeta, farr = getattr(self, name).checkpoint_render(cap)
            meta["families"][name] = fmeta
            for k, v in farr.items():
                arrays[f"{name}/{k}"] = v
        return meta, arrays

    def restore_state(self, meta: dict, arrays: dict) -> None:
        """Rebuild the arenas from a checkpoint (fresh aggregator): rows,
        registers and staged points restore exactly, so the next flush
        emits what the checkpointed aggregator's next flush would have.
        Accepts the `checkpoint_state()` of either package, with the
        cardinality guard's ledger when this aggregator has a guard.
        Every family prechecks first (CheckpointIncompatible before any
        arena mutates).  A cut that holds retention tiers, which this
        package lacks, raises NotImplementedError before anything
        restores."""
        if "retention" in meta:
            raise NotImplementedError(
                "checkpoint holds retention state; multi-resolution "
                "retention is not supported here")
        with self.lock:
            per_family = {}
            for name in self._FAMILIES:
                if name not in meta["families"]:
                    continue
                prefix = f"{name}/"
                farr = {k[len(prefix):]: v for k, v in arrays.items()
                        if k.startswith(prefix)}
                getattr(self, name).restore_precheck(
                    meta["families"][name], farr)
                per_family[name] = (meta["families"][name], farr)
            for name, (fmeta, farr) in per_family.items():
                getattr(self, name).restore_state(fmeta, farr)
            self.processed = int(meta.get("processed", 0))
            self.imported = int(meta.get("imported", 0))
            uts = arrays.get("unique_ts/regs")
            if (self.unique_ts is not None and uts is not None
                    and uts.shape == self.unique_ts.regs.shape):
                np.maximum(self.unique_ts.regs, uts,
                           out=self.unique_ts.regs)
            if (self.cardinality is not None
                    and meta.get("cardinality") is not None):
                self.cardinality.restore_state(meta["cardinality"])

    # -- flush ---------------------------------------------------------------

    def flush(self, is_local: bool, now: Optional[int] = None) -> FlushResult:
        return self.flush_dispatch(is_local, now).emit()

    def flush_dispatch(self, is_local: bool,
                       now: Optional[int] = None) -> PendingFlush:
        """Phase 1 of a flush: snapshot+reset under the lock, then build,
        upload and LAUNCH the evaluation — no device wait.  Returns a
        PendingFlush whose emit() reads back and renders the metrics."""
        now = int(now if now is not None else time.time())
        res = FlushResult()
        seg = self.last_flush_segments = {}
        t0 = time.perf_counter()
        with self.lock:
            snap = self._snapshot_and_reset()
        res.processed, res.imported = snap.pop("counts")
        uts_raw = snap.pop("uts_raw")
        snap["uts_host"] = (None if uts_raw is None
                            else hll_mod.estimate_np(uts_raw))
        seg["snapshot_s"] = time.perf_counter() - t0
        seg["keys_digest"] = len(snap["digests"]["rows"])
        seg["keys_moments"] = len(snap["moments"]["rows"])
        seg["keys_compactor"] = len(snap["compactors"]["rows"])
        # devices the flush program runs over (1 unmeshed)
        seg["devices"] = serving.mesh_device_count(self.mesh)
        # the window-ring cut is stamped here; the slots are published
        # at emit (_emit_pending)
        snap["query_cut_ts"] = time.time()
        dispatch = (self._dispatch_meshed if self.mesh is not None
                    else self._dispatch_flush)
        pend = {"digests": dispatch(snap, is_local),
                "moments": self._dispatch_moments(snap),
                "compactors": self._dispatch_compactors(snap)}
        return PendingFlush(self, snap, pend, res, is_local, now)

    def _dispatch_flush(self, snap: dict, is_local: bool) -> Optional[dict]:
        """Build, upload and launch the digest evaluation on the snapshot
        (outside the lock; everything asynchronous).  None when no digest
        row was touched."""
        dpart = snap["digests"]
        nd = len(dpart["rows"])
        if nd == 0:
            return None
        seg = self.last_flush_segments
        uniform = dpart["uniform"]
        t0 = time.perf_counter()
        dv, dw, minmax = self.digests.build_dense(
            dpart["staged"], dpart["rows"], dpart["d_min"], dpart["d_max"],
            uniform=uniform)
        seg["build_s"] = time.perf_counter() - t0
        # the bytes that cross to the device: bf16 values where staged so
        seg["upload_bytes"] = dv.nbytes + dw.nbytes + (
            0 if uniform else minmax.nbytes)
        t0 = time.perf_counter()
        if uniform:
            dvd, dwd = self.digests.put_dense_uniform(dv, dw)
        else:
            dvd, dwd, mmd = self.digests.put_dense(dv, dw, minmax)
        seg["upload_s"] = time.perf_counter() - t0
        timed = self.device.type == "cuda"
        if timed:
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
        if uniform:
            out = self.flush_fn.depth_variant(dvd, dwd, self._pct)
        else:
            out = self.flush_fn(dvd, dwd, mmd, self._pct)
        if timed:
            ev1.record()
        seg["dispatch_s"] = time.perf_counter() - t0 - seg["upload_s"]
        return {"nd": nd, "out": out, "uniform": uniform,
                "events": (ev0, ev1) if timed else None,
                # a forwarding tier compresses the staged rows for export
                "dense_dev": (dvd, dwd) if is_local else None}

    def _dispatch_meshed(self, snap: dict,
                         is_local: bool) -> Optional[dict]:
        """Build, place and launch the full-family meshed program on the
        snapshot (outside the lock; asynchronous;
        `aggregator.py:1570-1610` of the JAX package): the dense build in
        the mesh's row layout (the weighted build always, B2 taking the
        all-weight-1 intervals), each device's blocks placed on it, the
        counter planes and unique-timeseries lanes placed, the set lanes
        as the cut copied them.  None for an idle interval (nothing
        touched and no unique-timeseries count to read)."""
        dpart = snap["digests"]
        nd = len(dpart["rows"])
        crows, srows = snap["counters"]["rows"], snap["sets"]["rows"]
        if not (nd or len(crows) or len(srows) or snap["have_uts"]):
            return None
        seg = self.last_flush_segments
        uniform = dpart["uniform"]
        t0 = time.perf_counter()
        dv, dw, minmax = self.digests.build_dense(
            dpart["staged"], dpart["rows"], dpart["d_min"], dpart["d_max"])
        seg["build_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        dvd, dwd, mmd = self.digests.put_dense_sharded(dv, dw, minmax)
        cvals, uts = snap["counters"]["lanes"], snap["uts_lanes"]
        inputs = serving.FlushInputs(
            dense_v=dvd, dense_w=dwd, minmax=mmd,
            hll_regs=snap["sets"]["lanes"],
            counter_planes=self.counters.planes_from(cvals),
            uts_regs=serving.place_replicated(self.mesh, uts))
        seg["layout_s"] = time.perf_counter() - t0
        # the per-flush bytes that cross to the devices: the dense build,
        # the counter planes (2 f32 a row and lane) and the unique-ts
        # lanes; the set registers are device-resident
        seg["upload_bytes"] = (dv.nbytes + dw.nbytes + minmax.nbytes
                               + cvals.size * 8 + uts.nbytes)
        t0 = time.perf_counter()
        timed = self.device.type == "cuda"
        if timed:
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
        flat, set_regs = self.flush_fn(inputs, self._pct, uniform=uniform)
        if timed:
            ev1.record()
        set_regs_dev = None
        if (len(srows) and is_local
                and (snap["sets"]["scopes"] == int(MetricScope.MIXED)).any()):
            set_regs_dev = serving.set_regs_pack(set_regs, srows)
        seg["dispatch_s"] = time.perf_counter() - t0
        return {"meshed": True, "nd": nd, "out": flat,
                "set_regs_dev": set_regs_dev, "k_rows": dv.shape[0],
                "k2": cvals.shape[1],
                "n_sets": sum(row[0].shape[0]
                              for row in snap["sets"]["lanes"]),
                "uniform": False,
                "events": (ev0, ev1) if timed else None,
                "dense_dev": (dvd, dwd) if is_local else None}

    def _dispatch_moments(self, snap: dict) -> Optional[dict]:
        """Build, upload and launch the moments program on the snapshot
        (outside the lock; asynchronous): the dense build of the staged
        samples (depth-vector variant on all-weight-1 intervals), the
        host f64 conversion of the ivec accumulators to Chebyshev
        contributions, and one program call (B5 + the maxent solver).
        None when no moments row was touched."""
        mpart = snap["moments"]
        nm = len(mpart["rows"])
        if nm == 0:
            return None
        seg = self.last_flush_segments
        m = self.moments
        uniform = mpart["uniform"]
        t0 = time.perf_counter()
        dv, dw, _ = m.build_dense(mpart["staged"], mpart["rows"],
                                  mpart["d_min"], mpart["d_max"],
                                  uniform=uniform)
        imp, ab, lab = m.import_contrib(mpart, dv.shape[0])
        seg["m_build_s"] = time.perf_counter() - t0
        seg["upload_bytes"] = (seg.get("upload_bytes", 0) + dv.nbytes
                               + dw.nbytes + imp.nbytes + ab.nbytes
                               + lab.nbytes)
        t0 = time.perf_counter()
        dvd, dwd, abd, labd, impd = (serving.put(x, self.device)
                                     for x in (dv, dw, ab, lab, imp))
        events = (tuple(torch.cuda.Event(enable_timing=True)
                        for _ in range(3))
                  if self.device.type == "cuda" else None)
        fn = (self.moments_fn.depth_variant if uniform
              else self.moments_fn)
        out = fn(dvd, dwd, abd, labd, impd, self._pct, events=events)
        seg["m_dispatch_s"] = time.perf_counter() - t0
        return {"out": out, "nm": nm, "events": events}

    def _dispatch_compactors(self, snap: dict) -> Optional[dict]:
        """Fold the interval into the snapshot ladders and launch the
        read-off (outside the lock): the fold runs in rounds of one B6
        launch each, with the host staging and planning between them
        (`CompactorArena.fold_flush`, cached in the part for the
        forwarding export), then one read-off evaluates every touched
        key's quantiles from the implied `2**level` item weights.
        Counts and sums come exact from the host accumulators.  None
        when no compactor row was touched."""
        part = snap["compactors"]
        nc = len(part["rows"])
        if nc == 0:
            return None
        seg = self.last_flush_segments
        cp = self.compactors
        t0 = time.perf_counter()
        cp.fold_flush(part, part["staged"])
        seg["c_fold_s"] = time.perf_counter() - t0
        u_pad = arena_mod._pow2(max(nc, 2))
        cv, cc, cscale, mm = cp.flush_operands(part, part["staged"], u_pad)
        seg["c_build_s"] = time.perf_counter() - t0
        # the fold's level staging and the read-off's operands
        seg["upload_bytes"] = (seg.get("upload_bytes", 0)
                               + part["cfold_timing"].get("bytes", 0)
                               + cv.nbytes + cc.nbytes + cscale.nbytes
                               + mm.nbytes)
        t0 = time.perf_counter()
        cvd, ccd, csd, mmd = (serving.put(x, self.device)
                              for x in (cv, cc, cscale, mm))
        events = (tuple(torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                  if self.device.type == "cuda" else None)
        if events is not None:
            events[0].record()
        out = self.compactor_fn(cvd, ccd, csd, mmd, self._pct)
        if events is not None:
            events[1].record()
        seg["c_dispatch_s"] = time.perf_counter() - t0
        return {"out": out, "nc": nc, "events": events}

    def _fetch_flush(self, snap: dict, pend: dict) -> dict:
        """Read the dispatched evaluations back — the one place a flush
        waits on the device: every family's output travels in one flat
        buffer.  Unmeshed, digest counts and sums come from the exact f64
        host accumulators (they cover every staged point); meshed, see
        `_unpack_meshed`."""
        host: dict = {"set_ests": snap["sets"].get("estimates")}
        dp, mp, cp = pend["digests"], pend["moments"], pend["compactors"]
        live = [(name, p) for name, p in pend.items() if p is not None]
        if not live:
            return host
        seg = self.last_flush_segments
        outs = [p["out"] for _, p in live]
        t0 = time.perf_counter()
        flat = serving.fetch(outs[0].reshape(-1) if len(outs) == 1
                             else torch.cat([o.reshape(-1) for o in outs]))
        seg["readback_s"] = time.perf_counter() - t0
        seg["readback_bytes"] = flat.nbytes
        n_cols = len(self.percentiles) + 1      # median + percentiles
        parts = dict(zip(
            (name for name, _ in live),
            np.split(flat, np.cumsum([o.numel() for o in outs])[:-1])))
        if cp is not None:
            host["c_qs"] = parts["compactors"].reshape(
                cp["out"].shape)[:cp["nc"], :n_cols]
            timing = snap["compactors"].get("cfold_timing", {})
            seg["c_io_s"] = timing.get("io_s", 0.0)
            if cp["events"] is not None:
                fold_events = timing.get("events", ())
                seg["c_launches"] = len(fold_events)
                seg["c_kernel_ms"] = sum(e0.elapsed_time(e1)
                                         for e0, e1 in fold_events)
                seg["c_readoff_ms"] = cp["events"][0].elapsed_time(
                    cp["events"][1])
                seg["c_device_s"] = (seg["c_kernel_ms"]
                                     + seg["c_readoff_ms"]) / 1e3
        if mp is not None:
            mout = parts["moments"].reshape(mp["out"].shape)
            host["m_qs"] = mout[:mp["nm"], :n_cols]
            host["m_resid"] = mout[:mp["nm"], -1]
            ev = mp["events"]
            if ev is not None:
                seg["m_kernel_ms"] = ev[0].elapsed_time(ev[1])
                seg["m_solver_ms"] = ev[1].elapsed_time(ev[2])
                seg["m_device_s"] = ev[0].elapsed_time(ev[2]) / 1e3
        if dp is None:
            return host
        if dp["events"] is not None:
            seg["kernel_ms"] = dp["events"][0].elapsed_time(dp["events"][1])
        host["dense_dev"] = dp["dense_dev"]
        host["dense_uniform"] = dp["uniform"]
        dpart = snap["digests"]
        if dp.get("meshed"):
            return self._unpack_meshed(snap, dp, parts["digests"], n_cols,
                                       host)
        host["qs"] = parts["digests"].reshape(
            dp["out"].shape)[:dp["nd"], :n_cols]
        host["counts"] = np.asarray(dpart["d_weight"], np.float64)
        host["sums"] = np.asarray(dpart["d_sum"], np.float64)
        return host

    def _unpack_meshed(self, snap: dict, dp: dict, flat: np.ndarray,
                       n_cols: int, host: dict) -> dict:
        """The meshed program's one flat buffer (and, on a local tier,
        the forwarded rows' merged set registers) -> the emitters'
        inputs.  Counters come back as (hi, lo) planes; digest counts
        and sums are the device's float32 totals, as in the JAX
        package's meshed path."""
        ev, chi, clo, ests, uts = serving.unpack_outputs(
            flat, dp["k_rows"], n_cols, dp["k2"], dp["n_sets"])
        host["unique_ts"] = uts
        crows, srows = snap["counters"]["rows"], snap["sets"]["rows"]
        host["c_hi"] = chi.astype(np.float64)[crows]
        host["c_lo"] = clo.astype(np.float64)[crows]
        host["set_ests"] = ests[srows]
        if dp["set_regs_dev"] is not None:
            t0 = time.perf_counter()
            regs = serving.fetch(dp["set_regs_dev"])
            seg = self.last_flush_segments
            seg["readback_s"] += time.perf_counter() - t0
            seg["readback_bytes"] += regs.nbytes
            host["set_regs"] = regs.reshape(len(srows), -1)
        nd = dp["nd"]
        host["qs"] = ev[:nd, :n_cols]
        host["counts"] = ev[:nd, n_cols].astype(np.float64)
        host["sums"] = ev[:nd, n_cols + 1].astype(np.float64)
        return host

    def _emit_pending(self, snap: dict, pend: dict,
                      res: FlushResult, is_local: bool,
                      now: int) -> FlushResult:
        host = self._fetch_flush(snap, pend)
        if snap["uts_host"] is not None:
            res.unique_ts = int(snap["uts_host"])
        elif "unique_ts" in host:
            res.unique_ts = int(host["unique_ts"])
        t0 = time.perf_counter()
        self._emit_counters(res, snap, host, is_local, now)
        self._emit_gauges(res, snap, is_local, now)
        self._emit_status(res, snap, now)
        self._emit_sets(res, snap, host, is_local, now)
        self._emit_digests(res, snap, host, is_local, now)
        self._emit_moments(res, snap, host, is_local, now)
        self._emit_compactors(res, snap, host, is_local, now)
        if len(host.get("m_resid", ())):
            # solver convergence of the interval's worst row
            self.last_moments_resid = float(
                np.max(np.abs(host["m_resid"])))
            self.last_flush_segments["moments_resid"] = \
                self.last_moments_resid
        self.last_flush_segments["emit_s"] = time.perf_counter() - t0
        # window-ring rotation rides the cut: the snapshot parts (the
        # reset swapped in fresh state, so they are immutable) become
        # each family's newest query slot, stamped with the cut's time.
        # Empty intervals rotate too, so answers always cover data up to
        # the last completed cut.  (The JAX package's retention tiers
        # compact the same cut here; this package has no retention.)
        if self.query_rings is not None:
            cut_ts = snap["query_cut_ts"]
            for fam, part in (("tdigest", "digests"), ("moments", "moments"),
                              ("compactor", "compactors")):
                self.query_rings[fam].rotate(snap[part], cut_ts)
        return res

    def _snapshot_and_reset(self) -> dict:
        """Under lock: sync staging, snapshot the touched rows' state and
        metadata, reset."""
        d, s, c, g, st, mm, cp = (self.digests, self.sets, self.counters,
                                  self.gauges, self.status, self.moments,
                                  self.compactors)
        d.sync()
        mm.sync()
        cp.sync()
        s.sync()
        self._import_row_cache.clear()
        snap = {"counts": (self.processed, self.imported)}
        self.processed = 0
        self.imported = 0
        snap["uts_raw"] = None
        snap["have_uts"] = self.unique_ts is not None
        if self.unique_ts is not None:
            snap["uts_raw"] = self.unique_ts.regs
            self.unique_ts = hll_mod.HLLSketch(self.unique_ts.p)
        if self.mesh is not None:
            # [R, m] lanes, this process's tally in lane 0: the program
            # unions them over both mesh axes
            lanes = np.zeros((self.sets.n_lanes, self._uts_m), np.uint8)
            if snap["uts_raw"] is not None:
                lanes[0] = snap["uts_raw"]
            snap["uts_raw"] = None
            snap["uts_lanes"] = lanes

        for name, ar in (("gauges", g), ("status", st)):
            rows = ar.touched_rows()
            snap[name] = {"rows": rows, "names": ar.name_col[rows],
                          "tags": ar.tags_col[rows],
                          "scopes": ar.scope_col[rows].copy(),
                          "values": ar.values[rows].copy()}
        snap["status"]["messages"] = [st.messages.get(int(r), "")
                                      for r in snap["status"]["rows"]]
        snap["status"]["hostnames"] = [st.hostnames.get(int(r), "")
                                       for r in snap["status"]["rows"]]

        crows = c.touched_rows()
        snap["counters"] = {"rows": crows, "names": c.name_col[crows],
                            "tags": c.tags_col[crows],
                            "scopes": c.scope_col[crows].copy()}
        if self.mesh is None:
            # the float64 host stripes total exactly below 2^53
            snap["counters"]["values"] = c.values.sum(axis=0)[crows]
        else:
            # the lanes upload as planes and sum over the replicas
            snap["counters"]["values"] = None
            snap["counters"]["lanes"] = c.snapshot_values()

        srows = s.touched_rows()
        scopes = s.scope_col[srows].copy()
        snap["sets"] = {"rows": srows, "names": s.name_col[srows],
                        "tags": s.tags_col[srows], "scopes": scopes,
                        "legacy_ests": s.legacy_estimates(srows)}
        if self.mesh is not None:
            # the flush reads a copy of the device lanes taken here
            snap["sets"]["lanes"] = s.snapshot_lanes()
        else:
            snap["sets"]["estimates"] = s.host_estimates(srows)
            if (scopes == int(MetricScope.MIXED)).any():
                # Set.Metric marshal needs the registers after the reset
                snap["sets"]["host_regs"] = s.host_regs_copy(srows)

        drows = d.touched_rows()
        # uniform is captured BEFORE take_staged resets the tracking
        uniform = d.staged_uniform
        snap["digests"] = {
            "rows": drows, "names": d.name_col[drows],
            "name_hashes": d.name_hash_col[drows].copy(),
            "tags": d.tags_col[drows], "kinds": d.kind_col[drows],
            "scopes": d.scope_col[drows].copy(),
            "uniform": uniform, "staged": d.take_staged(),
            **{name: getattr(d, name)[drows].copy()
               for name in ("l_weight", "l_min", "l_max", "l_sum",
                            "l_rsum", "d_min", "d_max", "d_rsum",
                            "d_weight", "d_sum")}}

        mrows = mm.touched_rows()
        m_uniform = mm.staged_uniform
        snap["moments"] = {
            "rows": mrows, "names": mm.name_col[mrows],
            "name_hashes": mm.name_hash_col[mrows].copy(),
            "tags": mm.tags_col[mrows], "kinds": mm.kind_col[mrows],
            "scopes": mm.scope_col[mrows].copy(),
            "uniform": m_uniform, "staged": mm.take_staged(),
            **{name: getattr(mm, name)[mrows].copy()
               for name in ("l_weight", "l_min", "l_max", "l_sum",
                            "l_rsum", "d_min", "d_max", "d_rsum",
                            "d_weight", "d_sum", "d_logn", "ivec", "iv_a",
                            "iv_b")}}

        # the staged points fold into the SNAPSHOT ladder copies at
        # dispatch (outside the lock); the live ladders reset below
        prows = cp.touched_rows()
        snap["compactors"] = {
            "rows": prows, "names": cp.name_col[prows],
            "name_hashes": cp.name_hash_col[prows].copy(),
            "tags": cp.tags_col[prows], "kinds": cp.kind_col[prows],
            "scopes": cp.scope_col[prows].copy(),
            "staged": cp.take_staged(),
            **{name: getattr(cp, name)[prows].copy()
               for name in ("cvals", "ccnt", "ccomps", "cclip", "l_weight",
                            "l_min", "l_max", "l_sum", "l_rsum", "d_min",
                            "d_max", "d_rsum", "d_weight", "d_sum")}}

        for ar, rows in ((c, crows), (g, snap["gauges"]["rows"]),
                         (st, snap["status"]["rows"]), (s, srows),
                         (d, drows), (mm, mrows), (cp, prows)):
            ar.reset_rows(rows)
            ar.end_interval()
        # the guard's eviction pass first, then the cubes' (the JAX
        # package's order)
        if self.cardinality is not None:
            self._cardinality_end_interval()
        if self.cubes is not None:
            self._cube_end_interval()
        return snap

    def _cardinality_end_interval(self) -> None:
        """The guard's count-ordered eviction pass, after the snapshot
        copied its rows and the arenas reset: each evicted key's row is
        released from the arena that actually holds it (a payload-routed
        import can land a histogram key in the moments or compactor
        arena whatever the rules say).  A failure aborts the pass with
        the quota state untouched; idle GC still bounds the rows."""
        by_type = {sm.TYPE_COUNTER: self.counters,
                   sm.TYPE_GAUGE: self.gauges, sm.TYPE_SET: self.sets}

        def release(dks):
            by_arena: dict = {}
            for dk in dks:
                arena = by_type.get(dk[0].type) or next(
                    (a for a in (self.moments, self.compactors,
                                 self.digests) if dk in a.kdict), None)
                if arena is not None:       # else never materialized
                    by_arena.setdefault(id(arena), (arena, []))[1] \
                        .append(dk)
            for arena, lst in by_arena.values():
                arena.release_keys(lst)

        try:
            self.cardinality.end_interval(release)
        except Exception as e:   # noqa: BLE001 - retried next interval
            logging.getLogger("veneur_tpu_torch.aggregator").warning(
                "cardinality eviction pass aborted (%s); retrying next "
                "interval", e)

    def _cube_end_interval(self) -> None:
        """The cube maintainer's promotion pass, after the snapshot
        copied its rows and the arenas reset: evicted group rows are
        released from the arena that actually holds each key (family
        rules may have changed since it registered).  A failure aborts
        the pass with the cube membership untouched."""
        def release(dks):
            by_arena: dict = {}
            for dk in dks:
                for arena in (self.moments, self.compactors, self.digests):
                    if dk in arena.kdict:
                        by_arena.setdefault(id(arena), (arena, []))[1] \
                            .append(dk)
                        break
                # else: never materialized (a pure candidate)
            for arena, lst in by_arena.values():
                arena.release_keys(lst)

        try:
            self.cubes.end_interval(release)
        except Exception as e:
            logging.getLogger("veneur_tpu_torch.aggregator").warning(
                "cube eviction pass aborted (%s); retrying next interval",
                e)

    # -- emitters ------------------------------------------------------------

    @staticmethod
    def _scalar_family(res, part, vals, is_local, now, mtype, fwd):
        """Shared counter/gauge emission: forward global-only rows when
        local, emit the rest as one columnar segment."""
        bases = part["names"].tolist()
        tags = part["tags"].tolist()
        vals = np.asarray(vals, np.float64)
        if is_local:
            glob = part["scopes"] == int(MetricScope.GLOBAL_ONLY)
            if glob.any():
                for i in np.nonzero(glob)[0].tolist():
                    res.forward.append(fwd(bases[i], tags[i], vals[i]))
                sel = np.nonzero(~glob)[0]
                res.metrics.add_segment(sm.MetricSegment(
                    bases, tags, "", vals[sel], mtype, now, sel=sel))
                return
        res.metrics.add_segment(sm.MetricSegment(
            bases, tags, "", vals, mtype, now))

    def _emit_counters(self, res, snap, host, is_local, now):
        part = snap["counters"]
        if len(part["rows"]) == 0:
            return
        vals = part["values"]
        if vals is None:
            # meshed: the replica-summed (hi, lo) planes
            vals = host["c_hi"] * serving.COUNTER_SPLIT + host["c_lo"]
        self._scalar_family(
            res, part, vals, is_local, now, sm.COUNTER,
            lambda name, tags, v: sm.ForwardMetric(
                name=name, tags=tags, kind=sm.TYPE_COUNTER,
                scope=MetricScope.GLOBAL_ONLY, counter_value=int(v)))

    def _emit_gauges(self, res, snap, is_local, now):
        part = snap["gauges"]
        if len(part["rows"]) == 0:
            return
        self._scalar_family(
            res, part, part["values"], is_local, now, sm.GAUGE,
            lambda name, tags, v: sm.ForwardMetric(
                name=name, tags=tags, kind=sm.TYPE_GAUGE,
                scope=MetricScope.GLOBAL_ONLY, gauge_value=float(v)))

    def _emit_status(self, res, snap, now):
        part = snap["status"]
        for name, tags, val, msg, host in zip(
                part["names"], part["tags"], part["values"],
                part["messages"], part["hostnames"]):
            res.metrics.append(sm.InterMetric(
                name=name, timestamp=now, value=float(val), tags=tags,
                type=sm.STATUS, message=msg, hostname=host))

    def _emit_sets(self, res, snap, host, is_local, now):
        part = snap["sets"]
        if len(part["rows"]) == 0:
            return
        ests = host["set_ests"]
        if part["legacy_ests"] is not None:
            # migration lane: the emitted estimate is max(primary, legacy)
            ests = np.maximum(np.asarray(ests, np.float64),
                              part["legacy_ests"])
        bases = part["names"].tolist()
        tags = part["tags"].tolist()
        if is_local:
            mixed = part["scopes"] == int(MetricScope.MIXED)
            if mixed.any():
                regs = (host["set_regs"] if self.mesh is not None
                        else part["host_regs"])
                for i in np.nonzero(mixed)[0].tolist():
                    res.forward.append(sm.ForwardMetric(
                        name=bases[i], tags=tags[i], kind=sm.TYPE_SET,
                        scope=MetricScope.MIXED,
                        hll=hll_mod.marshal(regs[i])))
                sel = np.nonzero(~mixed)[0]
                res.metrics.add_segment(sm.MetricSegment(
                    bases, tags, "", ests[sel], sm.GAUGE, now, sel=sel))
                return
        res.metrics.add_segment(sm.MetricSegment(
            bases, tags, "", ests, sm.GAUGE, now))

    def _export_digests(self, host, fidx: np.ndarray):
        """Wire centroids of the forwarded rows: one bounded compress per
        chunk of rows (MergingDigest.Data, merging_digest.go:474-483)."""
        dvd, dwd = host["dense_dev"]
        if self.mesh is not None:
            dvd = serving.gather_dense(self.mesh, dvd)
            dwd = serving.gather_dense(self.mesh, dwd)
        compression = self.digests.compression
        ccap = self.digests.ccap
        depth = int(dvd.shape[1])
        max_rows = max(8, _EXPORT_ELEM_BUDGET // max(1, depth * ccap))
        export = (serving.digest_export_uniform if host["dense_uniform"]
                  else serving.digest_export)
        m_parts, w_parts = [], []
        for off in range(0, len(fidx), max_rows):
            rows = serving.put(fidx[off:off + max_rows], self.device)
            m, w = serving.fetch(export(dvd, dwd, rows, compression, ccap))
            m_parts.append(m)
            w_parts.append(w)
        return np.concatenate(m_parts), np.concatenate(w_parts)

    def _emit_digests(self, res, snap, host, is_local, now):
        part = snap["digests"]
        n = len(part["rows"])
        if n == 0:
            return
        sums = host["sums"]
        if is_local:
            forwarded = part["scopes"] != int(MetricScope.LOCAL_ONLY)
        else:
            forwarded = np.zeros(n, bool)
        if forwarded.any():
            fidx = np.nonzero(forwarded)[0]
            t0 = time.perf_counter()
            sel_mean, sel_weight = self._export_digests(host, fidx)
            self.last_flush_segments["export_s"] = time.perf_counter() - t0
            # one conversion per column, then plain list slicing per row:
            # a forwarding tier renders one ForwardMetric per key
            occ = sel_weight > 0
            ends = np.cumsum(occ.sum(axis=1)).tolist()
            flat_m = sel_mean[occ].tolist()
            flat_w = sel_weight[occ].tolist()
            cols = [part[c][fidx].tolist()
                    for c in ("names", "tags", "kinds", "d_min", "d_max",
                              "d_rsum")]
            scope_of = {int(s): s for s in MetricScope}
            scopes = [scope_of[s] for s in part["scopes"][fidx].tolist()]
            compression = self.digests.compression
            start = 0
            for (end, name, tg, kind, dmin, dmax, drsum, scope,
                 dsum) in zip(ends, *cols, scopes, sums[fidx].tolist()):
                res.forward.append(sm.ForwardMetric(
                    name=name, tags=tg, kind=kind, scope=scope,
                    digest_means=flat_m[start:end],
                    digest_weights=flat_w[start:end], digest_min=dmin,
                    digest_max=dmax, digest_sum=dsum, digest_rsum=drsum,
                    digest_compression=compression))
                start = end
        self._emit_histo_aggregates(res, part, host["qs"], host["counts"],
                                    sums, now, forwarded)

    def _emit_moments(self, res, snap, host, is_local, now):
        """Moments-family emission: the digest family's aggregate and
        percentile surface, with forwarding as wire moments VECTORS."""
        part = snap["moments"]
        n = len(part["rows"])
        if n == 0:
            return
        if is_local:
            forwarded = part["scopes"] != int(MetricScope.LOCAL_ONLY)
        else:
            forwarded = np.zeros(n, bool)
        if forwarded.any():
            fidx = np.nonzero(forwarded)[0]
            t0 = time.perf_counter()
            vecs = self.moments.assemble_vectors(part, part["staged"], fidx)
            self.last_flush_segments["m_export_s"] = time.perf_counter() - t0
            cols = [part[c][fidx].tolist() for c in ("names", "tags",
                                                     "kinds")]
            scope_of = {int(s): s for s in MetricScope}
            scopes = [scope_of[s] for s in part["scopes"][fidx].tolist()]
            for name, tg, kind, scope, vec in zip(*cols, scopes,
                                                  vecs.tolist()):
                res.forward.append(sm.ForwardMetric(
                    name=name, tags=tg, kind=kind, scope=scope,
                    moments=vec))
        self._emit_histo_aggregates(
            res, part, host["m_qs"], np.asarray(part["d_weight"], np.float64),
            np.asarray(part["d_sum"], np.float64), now, forwarded)

    def _emit_compactors(self, res, snap, host, is_local, now):
        """Compactor-family emission: the digest family's aggregate and
        percentile surface, with forwarding as wire ladder VECTORS (the
        header's exact scalars and the folded flush state, shared with
        the read-off through `fold_flush`'s cache)."""
        part = snap["compactors"]
        n = len(part["rows"])
        if n == 0:
            return
        if is_local:
            forwarded = part["scopes"] != int(MetricScope.LOCAL_ONLY)
        else:
            forwarded = np.zeros(n, bool)
        if forwarded.any():
            fidx = np.nonzero(forwarded)[0]
            t0 = time.perf_counter()
            vecs = self.compactors.assemble_vectors(part, part["staged"],
                                                    fidx)
            self.last_flush_segments["c_export_s"] = \
                time.perf_counter() - t0
            cols = [part[c][fidx].tolist() for c in ("names", "tags",
                                                     "kinds")]
            scope_of = {int(s): s for s in MetricScope}
            scopes = [scope_of[s] for s in part["scopes"][fidx].tolist()]
            for name, tg, kind, scope, vec in zip(*cols, scopes,
                                                  vecs.tolist()):
                res.forward.append(sm.ForwardMetric(
                    name=name, tags=tg, kind=kind, scope=scope,
                    compactor=vec))
        self._emit_histo_aggregates(
            res, part, host["c_qs"], np.asarray(part["d_weight"], np.float64),
            np.asarray(part["d_sum"], np.float64), now, forwarded)

    def _emit_histo_aggregates(self, res, part, qs, counts, sums, now,
                               forwarded):
        """The aggregate/percentile emission: sparse-emission guards per
        aggregate mirror Histo.Flush (samplers/samplers.go:359-514) as
        column masks over the snapshot's host scalar copies."""
        l_weight, l_min, l_max = (part["l_weight"], part["l_min"],
                                  part["l_max"])
        l_sum, l_rsum = part["l_sum"], part["l_rsum"]
        d_min, d_max, d_rsum = part["d_min"], part["d_max"], part["d_rsum"]
        bases = part["names"].tolist()
        tags = part["tags"].tolist()
        use_global = part["scopes"] == int(MetricScope.GLOBAL_ONLY)
        # a forwarded global-only row emits nothing here (flusher.go:57-74)
        alive = ~(forwarded & use_global)
        aggs = self.aggregates.value
        A = sm.Aggregate
        inf = np.inf
        batch = res.metrics

        def seg(mask, values, suffix, mtype=sm.GAUGE):
            if mask.all():
                batch.add_segment(sm.MetricSegment(
                    bases, tags, suffix, values, mtype, now))
                return
            sel = np.nonzero(mask)[0]
            if sel.size:
                batch.add_segment(sm.MetricSegment(
                    bases, tags, suffix, values[sel], mtype, now, sel=sel))

        with np.errstate(divide="ignore", invalid="ignore"):
            if aggs & A.MAX:
                seg(alive & (use_global | ((l_max > -inf) & (l_max < inf))),
                    np.where(use_global, d_max, l_max), ".max")
            if aggs & A.MIN:
                seg(alive & (use_global | ((l_min > -inf) & (l_min < inf))),
                    np.where(use_global, d_min, l_min), ".min")
            if aggs & A.SUM:
                seg(alive & ((l_sum != 0) | use_global),
                    np.where(use_global, sums, l_sum), ".sum")
            if aggs & A.AVERAGE:
                seg(alive & (use_global | ((l_sum != 0) & (l_weight != 0))),
                    np.where(use_global, sums / counts, l_sum / l_weight),
                    ".avg")
            if aggs & A.COUNT:
                seg(alive & ((l_weight != 0) | use_global),
                    np.where(use_global, counts, l_weight), ".count",
                    sm.COUNTER)
            if aggs & A.MEDIAN:
                seg(alive, qs[:, 0], ".median")
            if aggs & A.HARMONIC_MEAN:
                g_hmean = np.where(d_rsum != 0, counts / d_rsum, np.nan)
                seg(alive & (use_global | ((l_rsum != 0) & (l_weight != 0))),
                    np.where(use_global, g_hmean, l_weight / l_rsum),
                    ".hmean")
            # reference percentile naming: int(p*100), samplers.go:495-507
            emit_pcts = alive & ~forwarded
            for j, p in enumerate(self.percentiles):
                seg(emit_pcts, qs[:, j + 1], f".{int(p * 100)}percentile")
