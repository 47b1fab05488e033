"""The port's cardinality guard (`core/cardinality.py`) and its wiring,
held against the JAX package's on the CPU:

  * the guard replayed against `veneur_tpu.core.cardinality.
    CardinalityGuard` on seeded streams of sightings and interval ends:
    every resolve result, epoch, eviction list, checkpoint dict and
    snapshot equal, across a checkpoint restored into the other
    package's guard too; `tests/test_cardinality.py`'s cases through the
    port (its `arena.evict` failpoint and `diagnostics` gauges are
    ROADMAP A16);
  * a guarded aggregator's flushes equal the JAX aggregator's over
    intervals with evictions, for each rollup family, local and global
    (t-digest percentiles bitwise on integer samples; moments quantiles
    within FLUSH_RULE of the tenant's span and compactor quantiles within
    READOFF_REL relative, the family tests' rules; everything else
    exact); the rollup merges across tiers as the JAX fleet's does;
  * the quota ledger rides the checkpoint both ways; the import edge's
    budget (import_metric, the batched V1 import and the payload path,
    which bypasses the native wire scan while the guard is armed);
  * the native drain under the guard flushes, and leaves the guard in,
    what the Python path does;
  * the configuration: the rollup family's validation and its refusal of
    a mesh for the compactor family.
"""

import json

import numpy as np
import pytest

from veneur_tpu import config as jconfig
from veneur_tpu import ingest as jingest
from veneur_tpu.core import cardinality as jcard
from veneur_tpu.core.aggregator import MetricAggregator as JAggregator
from veneur_tpu.protocol import forward_pb2 as jforward_pb2
from veneur_tpu.protocol import metric_pb2 as jmetric_pb2
from veneur_tpu.samplers import metric_key as jmk
from veneur_tpu.samplers import parser as jparser
from veneur_tpu.samplers import samplers as jsm
from veneur_tpu_torch import config as tconfig
from veneur_tpu_torch import ingest
from veneur_tpu_torch.core import arena as tarena
from veneur_tpu_torch.core import cardinality as tcard
from veneur_tpu_torch.core.aggregator import MetricAggregator
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.samplers import metric_key as tmk
from veneur_tpu_torch.samplers import parser as tparser
from veneur_tpu_torch.samplers import samplers as tsm

PCTS = [0.5, 0.9, 0.99]
# the family tests' rules (test_torch_moments.py, test_torch_compactor.py)
FLUSH_RULE = 1e-3
READOFF_REL = 1e-6
SCOPES = (0, 1, 2)
TYPES = ("counter", "gauge", "histogram", "timer", "set")


@pytest.fixture(autouse=True)
def _no_jax_engine(monkeypatch):
    """The JAX package's engine fails to build here; keep its build_dense
    and import_payload on their Python paths without a g++ attempt
    each."""
    def refuse():
        raise RuntimeError("the JAX engine is not built in these tests")
    monkeypatch.setattr(jingest, "load_library", refuse)


# ---------------------------------------------------------------------------
# the guard against the JAX guard
# ---------------------------------------------------------------------------

def _view(rolled):
    """A resolve result as plain data, whichever package made it."""
    if rolled is None:
        return None
    key, scope, tags = rolled
    return (key.name, key.type, key.joined_tags, int(scope), list(tags))


def _dks(dks):
    return [(k.name, k.type, k.joined_tags, int(s)) for k, s in dks]


class _Twin:
    """A JAX guard and a port guard fed the same operations."""

    def __init__(self, budget, seed, tenant_tag="tenant"):
        self.j = jcard.CardinalityGuard(budget, tenant_tag=tenant_tag,
                                        seed=seed)
        self.t = tcard.CardinalityGuard(budget, tenant_tag=tenant_tag,
                                        seed=seed)

    def resolve(self, name, mtype, tags, scope, n):
        joined = ",".join(sorted(tags))
        want = self.j.resolve(jmk.MetricKey(name, mtype, joined),
                              jmk.MetricScope(scope), tags, n)
        got = self.t.resolve(tmk.MetricKey(name, mtype, joined),
                             tmk.MetricScope(scope), tags, n)
        assert _view(got) == _view(want), (name, tags, n)
        return got

    def end_interval(self):
        ev_j, ev_t = [], []
        nj = self.j.end_interval(lambda dks: ev_j.extend(dks))
        nt = self.t.end_interval(lambda dks: ev_t.extend(dks))
        assert nt == nj and _dks(ev_t) == _dks(ev_j)
        self.check()
        return _dks(ev_t)

    def check(self):
        assert self.t.epoch == self.j.epoch
        assert self.t.checkpoint_state() == self.j.checkpoint_state()
        assert self.t.snapshot() == self.j.snapshot()
        assert self.t.over_budget_tenants() == self.j.over_budget_tenants()


def _stream(rng, twin, n_ops, n_tenants, n_keys, tag="tenant"):
    """Seeded sightings (skewed key popularity, untenanted keys, every
    type and scope, batch counts) with interval ends between them."""
    pop = rng.zipf(1.3, n_ops) % n_keys
    evicted = 0
    for i in range(n_ops):
        k = int(pop[i])
        tenant = k % n_tenants
        tags = ([f"{tag}:t{tenant}"] if k % 11 else []) + [f"az:{k % 3}"]
        twin.resolve(f"k{k}", TYPES[k % len(TYPES)], tags,
                     SCOPES[k % 3], int(rng.integers(1, 5)))
        if i % 97 == 96:
            evicted += len(twin.end_interval())
    twin.end_interval()
    return evicted


@pytest.mark.parametrize("budget,seed,n_tenants,n_keys", [
    (1, 0, 1, 50), (3, 7, 2, 200), (8, 1, 3, 400), (16, 99, 4, 3000),
    (64, 5, 2, 2000), (2, 3, 12, 300)])
def test_guard_replays_the_jax_guards_decisions(budget, seed, n_tenants,
                                                n_keys):
    rng = np.random.default_rng(seed * 31 + budget)
    twin = _Twin(budget, seed)
    evicted = _stream(rng, twin, 3000, n_tenants, n_keys)
    assert twin.t.keys_evicted_total > 0
    # idle decay to the end: every tenant pruned in both
    for _ in range(tcard.IDLE_EXACT_INTERVALS + 1):
        twin.end_interval()
    assert twin.t.tenants == {} and evicted >= 0


@pytest.mark.parametrize("direction", ["jax->torch", "torch->jax"])
def test_a_guard_restored_from_the_other_packages_state_replays_on(
        direction):
    """A checkpointed ledger (through JSON, as the checkpoint carries it)
    restores into a fresh guard of the other package, and the two go on
    deciding alike."""
    rng = np.random.default_rng(17)
    twin = _Twin(4, 11, tenant_tag="team")
    _stream(rng, twin, 800, 3, 300, tag="team")
    for i in range(40):
        twin.resolve(f"mid{i}", "counter", [f"team:t{i % 3}"], 2, 2)
    src = twin.j if direction == "jax->torch" else twin.t
    state = json.loads(json.dumps(src.checkpoint_state()))
    fresh = _Twin(4, 11, tenant_tag="team")
    fresh.j.restore_state(state)
    fresh.t.restore_state(state)
    fresh.check()
    assert fresh.t.checkpoint_state() == twin.j.checkpoint_state()
    _stream(rng, fresh, 800, 3, 300, tag="team")


def mk(name, mtype="counter", tags=""):
    return tmk.MetricKey(name, mtype, tags)


MIXED = tmk.MetricScope.MIXED


def test_guard_admits_under_budget_and_rolls_tail():
    g = tcard.CardinalityGuard(2, seed=7)
    tags = ["tenant:acme"]
    assert g.resolve(mk("a"), MIXED, tags) is None
    assert g.resolve(mk("b"), MIXED, tags) is None
    rkey, rscope, rtags = g.resolve(mk("c"), MIXED, tags)
    assert rkey.name == tcard.ROLLUP_NAME_PREFIX + "counter"
    assert rscope == MIXED
    assert tcard.ROLLUP_TAG in rtags and "tenant:acme" in rtags
    assert g.resolve(mk("z"), MIXED, ["host:x"]) is None
    snap = g.snapshot()
    assert snap["tenants"]["acme"]["exact_keys"] == 2
    assert snap["keys_evicted"] == 1 and snap["tenants_over_budget"] == 1


def test_guard_rollup_identity_per_type_and_scope():
    g = tcard.CardinalityGuard(1)
    tags = ["tenant:t"]
    g.resolve(mk("a"), MIXED, tags)
    rc = g.resolve(mk("b", "counter"), tmk.MetricScope.GLOBAL_ONLY, tags)
    rh = g.resolve(mk("c", "histogram"), MIXED, tags)
    assert rc[0].name == "veneur.rollup.counter"
    assert rc[1] == tmk.MetricScope.GLOBAL_ONLY
    assert (rh[0].name, rh[0].type) == ("veneur.rollup.histogram",
                                        "histogram")


def test_eviction_is_count_ordered_and_seed_deterministic():
    def run(seed):
        g = tcard.CardinalityGuard(2, seed=seed)
        tags = ["tenant:t"]
        g.resolve(mk("cold"), MIXED, tags)
        g.resolve(mk("warm"), MIXED, tags, n=2)
        for _ in range(5):
            assert g.resolve(mk("hot"), MIXED, tags) is not None
        evicted = []
        g.end_interval(lambda dks: evicted.extend(dks))
        return g, evicted

    g1, ev1 = run(seed=3)
    _, ev2 = run(seed=3)
    assert ev1 == ev2 == [(mk("cold"), MIXED)]
    assert g1.epoch == 1
    assert g1.resolve(mk("hot"), MIXED, ["tenant:t"]) is None
    assert g1.resolve(mk("cold"), MIXED, ["tenant:t"]) is not None


def test_eviction_requires_strict_win():
    g = tcard.CardinalityGuard(1)
    g.resolve(mk("a"), MIXED, ["tenant:t"], n=3)
    g.resolve(mk("b"), MIXED, ["tenant:t"], n=3)
    g.end_interval()
    assert g.epoch == 0
    assert g.resolve(mk("a"), MIXED, ["tenant:t"]) is None


def test_candidate_table_stays_budget_bounded():
    g = tcard.CardinalityGuard(4)
    for i in range(4):
        g.resolve(mk(f"exact{i}"), MIXED, ["tenant:t"])
    for i in range(10_000):
        g.resolve(mk(f"tail{i}"), MIXED, ["tenant:t"])
    st = g.tenants["t"]
    assert len(st.candidates) <= 4 and len(st.exact) == 4
    assert len(st.cand_heap) <= 4 * 4 + 64 + 1
    assert g.rollup_points_total == 10_000


def test_idle_exact_keys_decay_and_ephemeral_tenants_prune():
    g = tcard.CardinalityGuard(1)
    g.resolve(mk("a"), MIXED, ["tenant:t"])
    for i in range(200):
        g.resolve(mk(f"k{i}"), MIXED, [f"tenant:req-{i}"])
    for _ in range(tcard.IDLE_EXACT_INTERVALS + 1):
        g.end_interval()
    assert g.tenants == {}
    assert g.resolve(mk("b"), MIXED, ["tenant:t"]) is None


def test_guard_rejects_nonpositive_budget():
    for budget in (0, -3):
        with pytest.raises(ValueError):
            tcard.CardinalityGuard(budget)


# ---------------------------------------------------------------------------
# the aggregator
# ---------------------------------------------------------------------------

def _udp(pkg, name, typ, value, tags, scope=0):
    mod = jmk if pkg == "jax" else tmk
    m = mod.UDPMetric(name=name, type=typ, value=value,
                      scope=mod.MetricScope(scope))
    m.update_tags(list(tags), None)
    return m


def _pair(budget=3, **kw):
    kw = dict(percentiles=[0.5], is_local=True,
              cardinality_key_budget=budget, **kw)
    return JAggregator(**kw), MetricAggregator(device="cpu", **kw)


def _values(res):
    out: dict = {}
    for m in res.metrics:
        out.setdefault((m.name, tuple(m.tags), m.type), []).append(m.value)
    return {k: sorted(v) for k, v in out.items()}


def test_aggregator_rolls_tail_and_tags_rollup_series():
    jagg, agg = _pair(budget=2)
    for a, pkg in ((jagg, "jax"), (agg, "torch")):
        for k in range(2):
            for _ in range(5):
                a.process_metric(_udp(pkg, f"pin{k}", "counter", 1,
                                      ["tenant:hog"]))
        for k in range(7):
            a.process_metric(_udp(pkg, f"tail{k}", "counter", 3,
                                  ["tenant:hog"]))
    want, res = jagg.flush(is_local=True), agg.flush(is_local=True)
    assert _values(res) == _values(want)
    got = {m.name: m for m in res.metrics}
    assert got["pin0"].value == got["pin1"].value == 5.0
    roll = got["veneur.rollup.counter"]
    assert roll.value == 21.0 and tcard.ROLLUP_TAG in roll.tags
    assert all(f"tail{k}" not in got for k in range(7))
    assert len(agg.counters.kdict) == 3


def test_aggregator_releases_evicted_rows():
    _, agg = _pair(budget=1)
    agg.process_metric(_udp("torch", "cold", "counter", 1, ["tenant:t"]))
    for _ in range(4):
        agg.process_metric(_udp("torch", "hot", "counter", 1, ["tenant:t"]))
    assert (mk("cold", tags="tenant:t"), MIXED) in agg.counters.kdict
    agg.flush(is_local=True)
    assert agg.cardinality.epoch == 1
    assert (mk("cold", tags="tenant:t"), MIXED) not in agg.counters.kdict
    agg.process_metric(_udp("torch", "hot", "counter", 2, ["tenant:t"]))
    got = {m.name: m.value for m in agg.flush(is_local=True).metrics}
    assert got["hot"] == 2.0


def test_an_eviction_pass_that_fails_leaves_the_ledger_untouched(
        monkeypatch):
    """The release raising (the JAX package's `arena.evict` failpoint
    edge, here a fault of the arena) aborts the pass with the quota
    state untouched; the next interval's pass succeeds."""
    _, agg = _pair(budget=1)
    agg.process_metric(_udp("torch", "cold", "counter", 1, ["tenant:t"]))
    for _ in range(4):
        agg.process_metric(_udp("torch", "hot", "counter", 1, ["tenant:t"]))
    real = tarena.CounterArena.release_keys

    def broken(self, dks):
        raise OSError("release failed")
    monkeypatch.setattr(tarena.CounterArena, "release_keys", broken)
    agg.flush(is_local=True)
    assert agg.cardinality.epoch == 0
    monkeypatch.setattr(tarena.CounterArena, "release_keys", real)
    for _ in range(4):
        agg.process_metric(_udp("torch", "hot", "counter", 1, ["tenant:t"]))
    agg.flush(is_local=True)
    assert agg.cardinality.epoch == 1


def test_release_keys_recycles_arena_rows():
    ar = tarena.CounterArena()
    row = ar.row_for(mk("a"), MIXED, [])
    ar.sample(row, 5, 1.0)
    assert ar.release_keys([(mk("a"), MIXED)]) == 1
    assert (mk("a"), MIXED) not in ar.kdict
    assert float(ar.values[:, row].sum()) == 0.0
    assert ar.row_for(mk("b"), MIXED, []) == row
    assert ar.release_keys([(mk("zzz"), MIXED)]) == 0


def _tenant_lines(rng, interval, n_tenants=3, keys=9):
    """Histogram, timer, counter, set and gauge lines of several tenants
    over more keys than the budget; the second interval turns the touch
    counts around, so the guard evicts."""
    out = []
    for t in range(n_tenants):
        for k in range(keys):
            hot = (keys - k) if interval % 2 == 0 else (k + 1)
            tag = b"tenant:t%d,az:%d" % (t, k % 2)
            for x in rng.integers(0, 1000, 3 * hot):
                out.append(b"h.k%d:%d|h|#%s" % (k, x, tag))
            for x in rng.integers(0, 1000, hot):
                out.append(b"h.t%d:%d|ms|#%s" % (k, x, tag))
            out.append(b"c.k%d:%d|c|#%s" % (k, hot, tag))
            out += [b"s.k%d:u%d|s|#%s" % (k, i, tag) for i in range(hot)]
            out.append(b"g.k%d:%d|g|#%s" % (k, hot, tag))
    out += [b"plain.h:%d|h" % x for x in rng.integers(0, 100, 40)]
    order = rng.permutation(len(out))
    return [out[i] for i in order]


def _assert_like_jax(got, want, fam, span):
    g, w = _values(got), _values(want)
    assert g and set(g) == set(w)
    for key, wv in w.items():
        quantile = key[0].endswith(("percentile", ".median"))
        rolled = tcard.ROLLUP_TAG in key[1]
        if quantile and rolled and fam == "moments":
            assert np.allclose(g[key], wv, rtol=0, atol=FLUSH_RULE * span)
        elif quantile and rolled and fam == "compactor":
            assert np.allclose(g[key], wv, rtol=READOFF_REL, atol=0), key
        else:
            assert g[key] == wv, (key, g[key], wv)


@pytest.mark.parametrize("is_local", [True, False])
@pytest.mark.parametrize("fam", ["tdigest", "moments", "compactor"])
def test_guarded_aggregator_flushes_what_jax_flushes(fam, is_local):
    rng = np.random.default_rng(3 + is_local)
    kw = dict(percentiles=PCTS, is_local=is_local,
              cardinality_key_budget=4, cardinality_seed=5,
              cardinality_rollup_family=fam)
    jagg = JAggregator(**kw)
    agg = MetricAggregator(device="cpu", **kw)
    evicted = 0
    for interval in range(3):
        lines = _tenant_lines(rng, interval)
        jp, tp = jparser.Parser(), tparser.Parser()
        for line in lines:
            jp.parse_metric(line, jagg.process_metric)
            tp.parse_metric(line, agg.process_metric)
        want = jagg.flush(is_local=is_local, now=100 + interval)
        got = agg.flush(is_local=is_local, now=100 + interval)
        _assert_like_jax(got, want, fam, 1000.0)
        assert any(tcard.ROLLUP_TAG in m.tags for m in got.metrics)
        if is_local:
            assert len(got.forward) == len(want.forward) > 0
        assert agg.cardinality.checkpoint_state() == \
            jagg.cardinality.checkpoint_state()
        evicted = agg.cardinality.epoch
    assert evicted >= 1
    held = {"tdigest": agg.digests, "moments": agg.moments,
            "compactor": agg.compactors}[fam]
    assert any(k.name == "veneur.rollup.histogram" for k, _ in held.kdict)


def test_rollup_merge_across_tiers_matches_the_jax_fleet():
    """Two locals fold everything of one tenant into its rollups; a
    global merges the forwarded rollups; the JAX fleet does the same:
    counters add, sets union, digests merge."""
    rng = np.random.default_rng(5)
    halves = [rng.integers(0, 500, 300), rng.integers(0, 500, 300)]
    members = [[f"m{i}" for i in range(0, 40)],
               [f"m{i}" for i in range(20, 60)]]
    globs = {"jax": JAggregator(percentiles=PCTS, is_local=False),
             "torch": MetricAggregator(percentiles=PCTS, is_local=False,
                                       device="cpu")}
    for vals, mems, ctr in ((halves[0], members[0], 10),
                            (halves[1], members[1], 15)):
        for pkg, glob in globs.items():
            agg = (JAggregator if pkg == "jax" else MetricAggregator)(
                percentiles=[0.5], is_local=True, cardinality_key_budget=1,
                **({} if pkg == "jax" else {"device": "cpu"}))
            agg.process_metric(_udp(pkg, "pin", "counter", 1, ["tenant:t"],
                                    scope=2))
            for i, v in enumerate(vals):
                agg.process_metric(_udp(pkg, f"h{i}", "histogram",
                                        float(v), ["tenant:t"]))
            for mem in mems:
                agg.process_metric(_udp(pkg, "s.many", "set", mem,
                                        ["tenant:t"]))
            for i in range(ctr):
                agg.process_metric(_udp(pkg, f"c{i}", "counter", 2,
                                        ["tenant:t"], scope=2))
            fwd = agg.flush(is_local=True).forward
            assert sum(f.name.startswith(tcard.ROLLUP_NAME_PREFIX)
                       for f in fwd) == 3
            for f in fwd:
                glob.import_metric(f if pkg == "jax" else f)
    want = globs["jax"].flush(is_local=False, now=7)
    got = globs["torch"].flush(is_local=False, now=7)
    assert _values(got) == _values(want)
    by = {m.name: m.value for m in got.metrics}
    assert by["veneur.rollup.counter"] == 50.0
    assert by["veneur.rollup.set"] == 60.0


@pytest.mark.parametrize("direction", ["jax->torch", "torch->jax"])
def test_rollup_identity_survives_checkpoint_restore(direction):
    """The quota ledger rides the aggregator's cut: a restored guard
    keeps folding new tail keys into the same rollup identity, in
    either package, and the two flush alike."""
    mkj = lambda: JAggregator(percentiles=[0.5], is_local=True,
                              cardinality_key_budget=3)
    mkt = lambda: MetricAggregator(percentiles=[0.5], is_local=True,
                                   cardinality_key_budget=3, device="cpu")
    src_pkg = direction.split("->")[0]
    src = mkj() if src_pkg == "jax" else mkt()
    for i in range(10):
        src.process_metric(_udp(src_pkg, f"ck.k{i}", "counter", 1,
                                ["tenant:hog"]))
    meta, arrays = src.checkpoint_state()
    assert "cardinality" in meta
    meta = json.loads(json.dumps(meta))
    restored = {"jax": mkj(), "torch": mkt()}
    for pkg, agg in restored.items():
        agg.restore_state(meta, arrays)
        assert agg.cardinality.epoch == src.cardinality.epoch
        assert agg.cardinality.snapshot()["tenants"]["hog"][
            "exact_keys"] == 3
        agg.process_metric(_udp(pkg, "ck.k99", "counter", 5,
                                ["tenant:hog"]))
    want = restored["jax"].flush(is_local=True)
    got = restored["torch"].flush(is_local=True)
    assert _values(got) == _values(want)
    rollups = [m for m in got.metrics if m.name == "veneur.rollup.counter"]
    assert rollups and tcard.ROLLUP_TAG in rollups[0].tags
    assert rollups[0].value == 12.0


def test_import_edge_enforces_tenant_budget():
    """Locals straight to a global: the budget applies to imports too."""
    kw = dict(percentiles=[0.5], is_local=False, cardinality_key_budget=3)
    jagg, agg = JAggregator(**kw), MetricAggregator(device="cpu", **kw)
    for a, smod in ((jagg, jsm), (agg, tsm)):
        for i in range(12):
            a.import_metric(smod.ForwardMetric(
                name=f"imp.c{i}", tags=["tenant:hog"], kind="counter",
                scope=2, counter_value=2))
        a.import_metric(smod.ForwardMetric(
            name="imp.h", tags=["tenant:hog"], kind="histogram", scope=0,
            digest_means=[1.0, 2.0], digest_weights=[1.0, 3.0],
            digest_min=1.0, digest_max=2.0, digest_rsum=2.5))
    snap = agg.cardinality.snapshot()
    assert snap == jagg.cardinality.snapshot()
    assert snap["tenants_over_budget"] == 1 and snap["rollup_points"] == 10
    assert len(agg.counters.kdict) == 4
    want, res = jagg.flush(is_local=False), agg.flush(is_local=False)
    assert _values(res) == _values(want)
    got = {m.name: m.value for m in res.metrics if m.type == "counter"}
    assert got["veneur.rollup.counter"] == 18.0
    assert sum(got.values()) == 24.0


@pytest.mark.parametrize("path", ["payload", "pb_batch"])
def test_import_edge_budget_through_the_batched_v1_paths(path, monkeypatch):
    """The raw-bytes payload path and the batched MetricList path apply
    the same defense: no identity cache and no native wire scan while
    the guard is armed."""
    def no_scan(payload):
        raise AssertionError("the wire scan cannot see tags")
    monkeypatch.setattr(ingest, "import_scan", no_scan)
    pbs = []
    for i in range(8):
        pb = jmetric_pb2.Metric(name=f"imp.p{i}", tags=["tenant:hog"],
                                type=jmetric_pb2.Counter)
        pb.counter.value = 1
        pbs.append(pb)
    for i in range(3):
        pb = jmetric_pb2.Metric(name=f"imp.g{i % 2}", tags=["tenant:hog"],
                                type=jmetric_pb2.Gauge)
        pb.gauge.value = 2.5 + i
        pbs.append(pb)
    payload = jforward_pb2.MetricList(metrics=pbs).SerializeToString()
    kw = dict(percentiles=[0.5], is_local=False, cardinality_key_budget=2)
    jagg, agg = JAggregator(**kw), MetricAggregator(device="cpu", **kw)
    jagg._native_import = False
    assert jagg.import_payload(payload) == (11, 0)
    if path == "payload":
        assert agg.import_payload(payload) == (11, 0)
    else:
        from veneur_tpu_torch.protocol import forward_pb2
        assert agg.import_pb_batch(
            forward_pb2.MetricList.FromString(payload).metrics) == (11, 0)
    assert len(agg.counters.kdict) == 3 and not agg._import_row_cache
    assert agg.cardinality.checkpoint_state() == \
        jagg.cardinality.checkpoint_state()
    want, res = jagg.flush(is_local=False), agg.flush(is_local=False)
    assert _values(res) == _values(want)
    got = {m.name: m.value for m in res.metrics if m.type == "counter"}
    assert got["veneur.rollup.counter"] == 6.0


# ---------------------------------------------------------------------------
# the native drain
# ---------------------------------------------------------------------------

def _drain_tenant_lines(rng, interval):
    """One type per tenant (the drain resolves a batch type by type, the
    Python path line by line, so a tenant shared across types would
    admit in another order) and a tail no larger than the budget (no
    space-saving replacement, whose victim depends on arrival order)."""
    out = []
    for t, kind in enumerate((b"h", b"ms", b"c", b"s", b"g")):
        for k in range(7):
            hot = (7 - k) if interval % 2 == 0 else (k + 1)
            tag = b"tenant:t%d" % t
            for x in rng.integers(0, 1000, 2 * hot):
                value = b"u%d" % x if kind == b"s" else b"%d" % x
                out.append(b"n%d.k%d:%s|%s|#%s" % (t, k, value, kind, tag))
    order = rng.permutation(len(out))
    return [out[i] for i in order] + [b"free.h:%d|h" % x
                                      for x in range(20)]


def _ledger(agg) -> dict:
    """The guard's checkpoint state with its lists sorted: a drain
    resolves in engine-id order and the Python path in line order, so
    keys enter the exact and candidate tables in other orders (which no
    decision reads: the eviction pass sorts them)."""
    state = agg.cardinality.checkpoint_state()
    for ts in state["tenants"].values():
        for part in ("exact", "idle", "candidates"):
            ts[part] = sorted(ts[part])
    return state


@pytest.mark.parametrize("is_local", [True, False])
def test_native_drain_under_the_guard_equals_the_python_path(is_local):
    rng = np.random.default_rng(9 + is_local)
    kw = dict(percentiles=PCTS, is_local=is_local, cardinality_key_budget=4,
              cardinality_seed=2, count_unique_timeseries=True)
    pagg = MetricAggregator(device="cpu", **kw)
    nagg = MetricAggregator(device="cpu", **kw)
    nat = ingest.NativeIngest(nagg)
    tid = nat.engine.new_thread()
    try:
        for interval in range(4):
            lines = _drain_tenant_lines(rng, interval)
            p = tparser.Parser()
            for line in lines:
                p.parse_metric(line, pagg.process_metric)
            for n, i in enumerate(range(0, len(lines), 40)):
                nat.engine.ingest(tid, b"\n".join(lines[i:i + 40]))
                if n % 5 == 4:
                    nat.drain_into()
            nat.drain_into()
            assert _ledger(nagg) == _ledger(pagg)
            want = pagg.flush(is_local=is_local, now=200 + interval)
            got = nagg.flush(is_local=is_local, now=200 + interval)
            assert _values(got) == _values(want)
            assert got.unique_ts == want.unique_ts
            assert sorted(f.name for f in got.forward) == \
                sorted(f.name for f in want.forward)
            assert nagg.cardinality.epoch == pagg.cardinality.epoch
        assert nagg.cardinality.epoch >= 2
        assert any(tcard.ROLLUP_TAG in m.tags for m in got.metrics)
    finally:
        nat.close()


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

def test_config_serves_the_guard_and_checks_its_rollup_family():
    cfg = tconfig.Config(cardinality_key_budget=10,
                         cardinality_tenant_tag="team", cardinality_seed=3,
                         cardinality_rollup_family="moments")
    srv = Server(cfg, device="cpu")
    g = srv.aggregator.cardinality
    assert (g.budget, g.tenant_tag, g.seed) == (10, "team", 3)
    assert srv.aggregator.family_dispatch
    assert Server(tconfig.Config(), device="cpu").aggregator.cardinality \
        is None
    for mod in (tconfig, jconfig):
        with pytest.raises(ValueError, match="unknown sketch family"):
            cfg = mod.Config(cardinality_rollup_family="hll")
            cfg.apply_defaults() if mod is jconfig else None
    # a mesh refuses the compactor family only while it is in play
    tconfig.Config(mesh_devices=2, cardinality_rollup_family="compactor")
    for mod in (tconfig, jconfig):
        with pytest.raises(ValueError, match="compactor"):
            cfg = mod.Config(mesh_devices=2, cardinality_key_budget=5,
                             cardinality_rollup_family="compactor")
            cfg.apply_defaults() if mod is jconfig else None
    with pytest.raises(ValueError, match="compactor"):
        from veneur_tpu_torch.parallel.mesh import make_mesh
        MetricAggregator(mesh=make_mesh(2, device="cpu"),
                         cardinality_key_budget=5,
                         cardinality_rollup_family="compactor")
