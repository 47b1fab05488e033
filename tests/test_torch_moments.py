"""The port's moments family held against the JAX package on the CPU.

The same numpy-seeded inputs go through `veneur_tpu` and through
`veneur_tpu_torch` (device="cpu", where kernel B5's wrapper runs its plain
PyTorch version).  The rules, each with its reason:

  * sketch math (sketches/moments.py, host conversions): bitwise — it
    is the same numpy float64 code;
  * B5's raw block on t-grid rows: bitwise.  Every scaled value lies on
    t in {-1, -1/2, 0, 1/2, 1}, so every T_j is in {0, +-1/2, +-1} and,
    with integer weights, every product and sum is exact in any order;
  * B5 on other rows: each raw column within C_RAW * D * 2^-24 * sum|w|
    of the row (the same terms, each |w T_j| <= |w|, summed in another
    order: (D - 1) * 2^-24 * sum|w| for either side); each log column
    within C_LOG * D * 2^-24 * sum|w|, because XLA's and PyTorch's f32
    logarithms differ in the last ulps, which the map onto [-1, 1]
    (2 |ln x| / (lb - la)) and the slope of T_j (up to j^2 = 64 at
    k = 8) amplify.  A lost or doubled point still fails: it moves the
    count column (sum w, exact for integer weights) by its weight >= 1,
    and C_LOG * D * 2^-24 * sum|w| < 1 at every D <= 64 tested here;
  * a numpy model of the CUDA kernel's summation order (`_b5_model`,
    the plain version's per-point terms summed as the kernel's lanes
    and butterfly sum them): bitwise the plain version on t-grid rows,
    within C_RAW * D * 2^-24 * sum|w| of it on gamma rows, and within
    the rule above of the Pallas kernel; a row's bits the same alone
    and inside a batch;
  * the solver fed the SAME sums: quantiles within SOLVE_SAME of the
    row's span (matrix products and cumulative sums add in another
    order; 16 damped Newton steps carry that into the quantiles);
  * whole flushes (B5 then the solver): within FLUSH_RULE of the span —
    sums that differ in their last bits move a quantile by at most a
    few 1e-4 of the span (calibrated on 60,000 rows of 64 samples);
  * host state (counts, min, max, sum, rsum, logn, ivec, forwarded
    vectors): bitwise.

Test rows keep away from the log-domain gate (`use_log` in
`_maxent_quantiles`), where a last-ulp difference flips a row's domain.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from veneur_tpu.core.aggregator import MetricAggregator as JAggregator
from veneur_tpu.ops import moments_eval as jme
from veneur_tpu.samplers import parser as jparser
from veneur_tpu.samplers import samplers as jsm
from veneur_tpu.sketches import moments as jmo
from veneur_tpu_torch import config as tconfig
from veneur_tpu_torch.core import arena as tarena
from veneur_tpu_torch.core.aggregator import MetricAggregator
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.ops import moments_eval as me
from veneur_tpu_torch.samplers import parser as tparser
from veneur_tpu_torch.samplers import samplers as tsm
from veneur_tpu_torch.sinks import simple as tsimple
from veneur_tpu_torch.sketches import moments as mo

C_RAW = 2.0
C_LOG = 512.0
SOLVE_SAME = 1e-4
FLUSH_RULE = 1e-3
PCTS = [0.5, 0.9, 0.99]
RULES = [{"match": "mom.*", "family": "moments"}]
AGGS = ["min", "max", "count", "sum", "avg", "median", "hmean"]


# ---------------------------------------------------------------------------
# sketch math: bitwise
# ---------------------------------------------------------------------------

def _vec(rng, n, dist="gamma", k=8):
    s = mo.MomentsSketch(k)
    vals = (rng.gamma(2.0, 10.0, n) if dist == "gamma"
            else rng.normal(0.0, 5.0, n))
    s.add_batch(vals, rng.integers(1, 4, n).astype(np.float64))
    return s.vec


def test_vector_layout_matches_jax():
    names = ("DEFAULT_K", "LOG_DOMAIN_RATIO", "IDX_COUNT", "IDX_MIN",
             "IDX_MAX", "IDX_SUM", "IDX_RSUM", "IDX_LOGN", "SUMS_OFF")
    assert [getattr(mo, n) for n in names] == \
        [getattr(jmo, n) for n in names]
    for k in (2, 8, 16):
        assert mo.vector_len(k) == jmo.vector_len(k)
        assert mo.k_from_len(mo.vector_len(k)) == k
        np.testing.assert_array_equal(mo.empty_vector(k),
                                      jmo.empty_vector(k))
    with pytest.raises(ValueError):
        mo.k_from_len(7)


@pytest.mark.parametrize("dist", ["gamma", "normal"])
def test_sketch_add_batch_and_merge_are_bitwise(dist):
    rng = np.random.default_rng(1)
    for k in (4, 8):
        vals = [(rng.gamma(2.0, 10.0, 300) if dist == "gamma"
                 else rng.normal(0.0, 5.0, 300)) + 1e3 * i
                for i in range(3)]
        wts = [rng.integers(1, 4, 300).astype(np.float64) for _ in vals]
        ours, theirs = mo.MomentsSketch(k), jmo.MomentsSketch(k)
        for v, w in zip(vals, wts):
            ours.add_batch(v, w)
            theirs.add_batch(v, w)
        np.testing.assert_array_equal(ours.vec, theirs.vec)
        other = _vec(rng, 50, dist, k)
        ours.merge(other)
        theirs.merge(other)
        np.testing.assert_array_equal(ours.vec, theirs.vec)
        # merging with an empty vector is the identity on both sides
        np.testing.assert_array_equal(
            mo.merge_vectors(ours.vec[None], mo.empty_vector(k)[None]),
            jmo.merge_vectors(theirs.vec[None], jmo.empty_vector(k)[None]))


def test_rebase_fold_log_domain_and_cheb_contrib_are_bitwise():
    rng = np.random.default_rng(2)
    n, k = 40, 8
    sums = rng.normal(0.0, 3.0, (n, k + 1))
    a0 = rng.normal(0.0, 10.0, n)
    b0 = a0 + rng.gamma(1.0, 5.0, n)
    b0[:3] = a0[:3]                       # degenerate domains
    a0[3], b0[3] = np.inf, -np.inf        # empty sketch
    a1, b1 = np.minimum(a0, -20.0), np.maximum(b0, 30.0)
    np.testing.assert_array_equal(
        mo.rebase_sums(sums, (a0, b0), (a1, b1)),
        jmo.rebase_sums(sums, (a0, b0), (a1, b1)))
    np.testing.assert_array_equal(mo.log_domain(a0, b0),
                                  jmo.log_domain(a0, b0))
    rows = rng.integers(0, n, 500)
    vals = rng.gamma(2.0, 10.0, 500) - 5.0
    wts = rng.integers(1, 4, 500).astype(np.float64)
    a = np.full(n, -5.0)
    b = np.full(n, 200.0)
    out = []
    for m in (mo, jmo):
        raw, log = np.zeros((n, k + 1)), np.zeros((n, k + 1))
        m.fold_values(raw, log, rows, vals, wts, (a, b),
                      m.log_domain(a + 6.0, b))
        out.append((raw, log))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    np.testing.assert_array_equal(out[0][1], out[1][1])
    vecs = np.stack([_vec(rng, 80) for _ in range(6)])
    ab = (vecs[:, 1] - 1.0, vecs[:, 2] + 2.0)
    lab = mo.log_domain(*ab)
    for ours, theirs in zip(me.cheb_contrib(vecs, ab, lab),
                            jme.cheb_contrib(vecs, ab, lab)):
        np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(me._mono_to_cheb(8), jme._mono_to_cheb(8))
    np.testing.assert_array_equal(me._cheb_basis(8), jme._cheb_basis(8))
    assert (me.QUAD_POINTS, me.NEWTON_ITERS, me.RIDGE) == \
        (jme.QUAD_POINTS, jme.NEWTON_ITERS, jme.RIDGE)


# ---------------------------------------------------------------------------
# B5: plain version against the JAX twin and the Pallas kernel
# ---------------------------------------------------------------------------

def _dense(rng, u, d, uniform, grid=False):
    """Staged dense inputs as numpy: (dv, dw or int16 depths, ab, lab,
    weights).  grid rows take t-grid values (domains [0, 4] over 0..4
    and [-4, 4] over -4, -2, .., 4) and the lab sentinel."""
    if uniform:
        dep = rng.integers(0, d + 1, u)
        dep[0] = 0
        w = (np.arange(d)[None, :] < dep[:, None]).astype(np.float32)
    else:
        w = rng.integers(1, 4, (u, d)).astype(np.float32)
        w *= rng.uniform(0, 1, (u, d)) < 0.7
        w[0] = 0.0
    occ = w > 0
    if grid:
        idx = rng.integers(0, 5, (u, d)).astype(np.float32)
        neg = (np.arange(u) % 2 == 1)[:, None]
        dv = np.where(neg, 2.0 * idx - 4.0, idx).astype(np.float32)
        a = np.where(neg[:, 0], -4.0, 0.0)
        b = np.full(u, 4.0)
        la, lb = np.zeros(u), np.full(u, -1.0)
    else:
        dv = rng.gamma(2.0, 10.0, (u, d)).astype(np.float32)
        has = occ.any(1)
        a = np.where(has, np.where(occ, dv, np.inf).min(1), 0.0)
        b = np.where(has, np.where(occ, dv, -np.inf).max(1), 0.0)
        la, lb = jmo.log_domain(a, b)
    if uniform:
        dv = np.where(occ, dv, 0.0).astype(np.float32)
    ab = np.stack([a, b]).astype(np.float32)
    lab = np.stack([la, lb]).astype(np.float32)
    return dv, (dep.astype(np.int16) if uniform else w), ab, lab, w


def _port_sums(dv, dw, ab, lab, uniform, k=8):
    return me.moments_sums(torch.as_tensor(dv), torch.as_tensor(dw),
                           torch.as_tensor(ab), torch.as_tensor(lab), k,
                           uniform).numpy()


def _jax_twin(dv, dw, ab, lab, uniform, k=8):
    dw = dw.astype(np.int32) if uniform else dw
    return np.asarray(jme._moments_sums_twin(
        jnp.asarray(dv), jnp.asarray(dw), jnp.asarray(ab), jnp.asarray(lab),
        k, uniform))


def _within(got, want, w, k=8):
    """The per-column reordering rule (raw C_RAW, log C_LOG)."""
    d = w.shape[1]
    unit = d * 2.0 ** -24 * np.abs(w).sum(1)[:, None]
    diff = np.abs(got - want)
    assert (diff[:, :k + 1] <= C_RAW * unit).all(), \
        (diff[:, :k + 1] / np.maximum(unit, 1e-30)).max()
    assert (diff[:, k + 1:] <= C_LOG * unit).all(), \
        (diff[:, k + 1:] / np.maximum(unit, 1e-30)).max()


@pytest.mark.parametrize("uniform", [False, True])
def test_b5_plain_is_bitwise_on_t_grid_rows(uniform):
    rng = np.random.default_rng(3)
    for u, d in ((64, 1), (37, 8), (16, 64)):
        dv, dw, ab, lab, _ = _dense(rng, u, d, uniform, grid=True)
        got = _port_sums(dv, dw, ab, lab, uniform)
        want = _jax_twin(dv, dw, ab, lab, uniform)
        np.testing.assert_array_equal(got, want)
        assert got[:, 0].sum() > 0


@pytest.mark.parametrize("uniform", [False, True])
@pytest.mark.parametrize("u,d", [(5, 1), (7, 3), (256, 8), (96, 64)])
def test_b5_plain_matches_jax_twin(u, d, uniform):
    rng = np.random.default_rng(4 + d)
    dv, dw, ab, lab, w = _dense(rng, u, d, uniform)
    _within(_port_sums(dv, dw, ab, lab, uniform),
            _jax_twin(dv, dw, ab, lab, uniform), w)


@pytest.mark.parametrize("uniform", [False, True])
def test_b5_plain_matches_pallas_interpret(uniform):
    rng = np.random.default_rng(5)
    dv, dw, ab, lab, w = _dense(rng, 256, 8, uniform)
    pal = np.asarray(jme._moments_sums_pallas(
        jnp.asarray(dv), jnp.asarray(dw), jnp.asarray(ab), jnp.asarray(lab),
        8, uniform, interpret=True))
    _within(_port_sums(dv, dw, ab, lab, uniform), pal, w)


def test_b5_wrapper_takes_the_plain_version_only_on_the_cpu():
    """A CPU tensor runs the plain version and counts no launch; the
    depth variant equals the general one on 0/1 weights."""
    rng = np.random.default_rng(6)
    me.reset_launches()
    dv, dep, ab, lab, w = _dense(rng, 33, 16, True)
    by_depth = _port_sums(dv, dep, ab, lab, True)
    general = _port_sums(dv, w, ab, lab, False)
    np.testing.assert_array_equal(by_depth, general)
    assert me.launches == {"moments_sums": 0, "moments_sums_depth": 0}
    with pytest.raises(ValueError, match="several devices"):
        me.moments_sums(torch.as_tensor(dv), torch.as_tensor(dep),
                        torch.as_tensor(ab), torch.as_tensor(lab).to("meta"),
                        8, True)


# ---------------------------------------------------------------------------
# a numpy model of B5's kernel (ops/csrc/moments_eval.cu): the plain
# version's per-point terms, summed in the kernel's split and combine order
# ---------------------------------------------------------------------------

_B5_SRC = Path(me.__file__).parent / "csrc" / "moments_eval.cu"


def _b5_lane_points() -> int:
    """The kernel's kLanePoints, read from its source."""
    return int(re.search(r"constexpr int kLanePoints = (\d+);",
                         _B5_SRC.read_text()).group(1))


def _b5_lanes(d: int) -> int:
    """Lanes a row, G = min(32, the largest power of two <= max(1,
    D / kLanePoints)): a function of D alone."""
    g, pts = 1, _b5_lane_points()
    while g < 32 and pts * 2 * g <= d:
        g *= 2
    return g


def _b5_model(dv, dw, ab, lab, uniform, k=8):
    """B5 as the kernel sums: each point's 2(k+1) terms from the plain
    version (a one-column row a point, so its sum is the term), then
    lane l of the row's G lanes adds its quads l, l + G, ... (four
    columns each, in column order) from 0.0 in float32, and an xor
    butterfly (offsets G/2 .. 1) adds the lanes' partials."""
    u, d = dv.shape
    if uniform:
        w = (np.arange(d)[None, :] < dw.astype(np.int64)[:, None])
        w = w.astype(np.float32)
    else:
        w = dw
    rep = lambda x: np.ascontiguousarray(np.repeat(x, d, axis=1))
    terms = me.moments_sums_plain(
        torch.as_tensor(dv.reshape(-1, 1)), torch.as_tensor(
            w.reshape(-1, 1)), torch.as_tensor(rep(ab)),
        torch.as_tensor(rep(lab)), k, False).numpy().reshape(u, d, -1)
    g = _b5_lanes(d)
    part = np.zeros((g, u, terms.shape[2]), np.float32)
    for lane in range(g):
        for q in range(lane, (d + 3) // 4, g):
            for c in range(4 * q, min(4 * q + 4, d)):
                part[lane] = part[lane] + terms[:, c]
    off = g // 2
    while off:
        part = part + part[np.arange(g) ^ off]
        off //= 2
    return part[0]


def test_b5_lane_groups_depend_on_depth_alone():
    """About kLanePoints points a lane: G = 1 up to D = 31, 4 at the
    flush's D = 64, 32 from D = 512 on."""
    assert _b5_lane_points() == 16
    got = {d: _b5_lanes(d) for d in (1, 3, 16, 31, 32, 63, 64, 100, 512,
                                     1024)}
    assert got == {1: 1, 3: 1, 16: 1, 31: 1, 32: 2, 63: 2, 64: 4, 100: 4,
                   512: 32, 1024: 32}


@pytest.mark.parametrize("uniform", [False, True])
@pytest.mark.parametrize("k", [2, 8, 16])
def test_b5_kernel_order_is_bitwise_on_t_grid_rows(k, uniform):
    """Exact sums: the kernel's order gives the plain version's bits at
    every depth the lane split treats apart."""
    rng = np.random.default_rng(20 + k)
    for d in (1, 2, 3, 4, 5, 8, 16, 64, 512):
        dv, dw, ab, lab, _ = _dense(rng, 24, d, uniform, grid=True)
        want = _port_sums(dv, dw, ab, lab, uniform, k)
        got = _b5_model(dv, dw, ab, lab, uniform, k)
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
        assert want[:, 0].sum() > 0


@pytest.mark.parametrize("uniform", [False, True])
@pytest.mark.parametrize("d", [3, 5, 64, 512])
def test_b5_kernel_order_within_the_reorder_bound(d, uniform):
    """Gamma rows: every column within C_RAW * D * 2^-24 * sum|w| of
    the plain version (chip_smoke's C_REORDER rule), at k = 2, 8, 16."""
    rng = np.random.default_rng(30 + d)
    for k in (2, 8, 16):
        dv, dw, ab, lab, w = _dense(rng, 40, d, uniform)
        got = _b5_model(dv, dw, ab, lab, uniform, k)
        want = _port_sums(dv, dw, ab, lab, uniform, k)
        unit = d * 2.0 ** -24 * np.abs(w).sum(1)[:, None]
        assert (np.abs(got - want) <= C_RAW * unit).all()


@pytest.mark.parametrize("uniform", [False, True])
def test_b5_kernel_order_matches_pallas_interpret(uniform):
    rng = np.random.default_rng(7)
    dv, dw, ab, lab, w = _dense(rng, 256, 64, uniform)
    pal = np.asarray(jme._moments_sums_pallas(
        jnp.asarray(dv), jnp.asarray(dw), jnp.asarray(ab), jnp.asarray(lab),
        8, uniform, interpret=True))
    _within(_b5_model(dv, dw, ab, lab, uniform), pal, w)


@pytest.mark.parametrize("uniform", [False, True])
def test_b5_row_bits_do_not_depend_on_the_batch(uniform):
    """A row alone gives the bits it gets inside a 300-row batch, in
    the kernel's order and in the plain version the CPU path runs (the
    meshed moments flush solves slices of rows)."""
    rng = np.random.default_rng(8)
    for d in (3, 64):
        dv, dw, ab, lab, _ = _dense(rng, 300, d, uniform)
        model = _b5_model(dv, dw, ab, lab, uniform)
        plain = _port_sums(dv, dw, ab, lab, uniform)
        for i in (0, 1, 150, 299):
            one = (dv[i:i + 1], dw[i:i + 1], np.ascontiguousarray(
                ab[:, i:i + 1]), np.ascontiguousarray(lab[:, i:i + 1]))
            np.testing.assert_array_equal(
                _b5_model(*one, uniform)[0].view(np.int32),
                model[i].view(np.int32))
            np.testing.assert_array_equal(
                _port_sums(*one, uniform)[0].view(np.int32),
                plain[i].view(np.int32))


# ---------------------------------------------------------------------------
# the solver and the flush program
# ---------------------------------------------------------------------------

def _solver_inputs(rng, u=48, k=8):
    """Sums of raw-domain rows (gamma) and log-domain rows (lognormal,
    far past the gate), plus an empty row and a single-point row."""
    d = 64
    vals = np.concatenate([rng.gamma(2.0, 10.0, (u // 2, d)),
                           rng.lognormal(2.0, 1.5, (u - u // 2, d))])
    vals = vals.astype(np.float32)
    w = np.ones((u, d), np.float32)
    w[0] = 0.0
    vals[1] = 3.5
    occ = w > 0
    a = np.where(occ.any(1), np.where(occ, vals, np.inf).min(1), 0.0)
    b = np.where(occ.any(1), np.where(occ, vals, -np.inf).max(1), 0.0)
    la, lb = jmo.log_domain(a, b)
    ab = np.stack([a, b]).astype(np.float32)
    lab = np.stack([la, lb]).astype(np.float32)
    sums = _port_sums(vals, w, ab, lab, False, k)
    return sums, ab, lab, vals


def test_solver_matches_jax_on_the_same_sums():
    rng = np.random.default_rng(7)
    sums, ab, lab, _ = _solver_inputs(rng)
    pct = np.asarray([0.5, 0.5, 0.9, 0.99], np.float32)
    jq, jr = jme._maxent_quantiles(
        jnp.asarray(sums[:, :9]), jnp.asarray(sums[:, 9:]), jnp.asarray(ab),
        jnp.asarray(lab), jnp.asarray(pct), 8)
    t = torch.as_tensor
    tq, tr = me._maxent_quantiles(t(sums[:, :9]), t(sums[:, 9:]), t(ab),
                                  t(lab), t(pct), 8)
    use_log = me.use_log_domain(t(sums[:, :9]), t(sums[:, 9:]), t(ab), t(lab))
    assert 0 < int(use_log.sum()) < len(use_log)       # both domains
    span = np.maximum(ab[1] - ab[0], 1e-30)[:, None]
    assert (np.abs(tq.numpy() - np.asarray(jq)) / span).max() <= SOLVE_SAME
    assert tq[0].eq(0).all() and (tq[1] == 3.5).all()  # empty, one point
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-4)


def test_chol_solve_matches_jax():
    rng = np.random.default_rng(8)
    m = rng.normal(0.0, 1.0, (20, 9, 9)).astype(np.float32)
    h = m @ m.transpose(0, 2, 1) + 9 * np.eye(9, dtype=np.float32)
    g = rng.normal(0.0, 1.0, (20, 9)).astype(np.float32)
    got = me._chol_solve(torch.as_tensor(h), torch.as_tensor(g)).numpy()
    want = np.asarray(jme._chol_solve(jnp.asarray(h), jnp.asarray(g)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    exact = np.linalg.solve(h, g[..., None])[..., 0]
    np.testing.assert_allclose(got, exact, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("uniform", [False, True])
def test_flush_program_matches_jax(uniform):
    """make_moments_flush: staged samples plus imported contributions
    -> [U, P+1] against the JAX program on the same inputs."""
    rng = np.random.default_rng(9)
    u, d = 16, 64
    dv, dw, ab, lab, _ = _dense(rng, u, d, uniform)
    imp = np.zeros((u, 18), np.float32)
    vecs = np.stack([_vec(rng, 40) for _ in range(u)])
    vecs[:, 1], vecs[:, 2] = ab[0], ab[1]         # inside the row domain
    raw, log = me.cheb_contrib(vecs, (ab[0].astype(np.float64),
                                      ab[1].astype(np.float64)),
                               (lab[0].astype(np.float64),
                                lab[1].astype(np.float64)))
    imp[:, :9], imp[:, 9:] = raw, log
    pct = np.asarray([0.5, 0.5, 0.9, 0.99], np.float32)
    jfn = jme.make_moments_flush(8)
    jfn = jfn.depth_variant if uniform else jfn
    want = np.asarray(jfn(*(jnp.asarray(x) for x in (
        dv, dw.astype(np.int32) if uniform else dw, ab, lab, imp, pct))))
    tfn = me.make_moments_flush(8, device="cpu")
    tfn = tfn.depth_variant if uniform else tfn
    got = tfn(*(torch.as_tensor(x) for x in (dv, dw, ab, lab, imp,
                                             pct))).numpy()
    assert got.shape == want.shape == (u, 5)
    span = np.maximum(ab[1] - ab[0], 1e-30)[:, None]
    assert (np.abs(got[:, :4] - want[:, :4]) / span).max() <= FLUSH_RULE
    assert np.isfinite(got).all()


def test_quantiles_from_vectors_matches_jax():
    rng = np.random.default_rng(10)
    vecs = np.stack([_vec(rng, int(n)) for n in rng.integers(50, 400, 9)]
                    + [mo.empty_vector()])
    qs = [0.1, 0.5, 0.99]
    got = me.quantiles_from_vectors(vecs, qs, device="cpu")
    want = jme.quantiles_from_vectors(vecs, qs)
    span = np.maximum(vecs[:, 2] - vecs[:, 1], 1e-30)
    span[-1] = 1.0
    assert (np.abs(got - want) / span[:, None]).max() <= FLUSH_RULE
    assert (got[-1] == 0).all()
    s = mo.MomentsSketch()
    s.vec = vecs[0]
    assert s.quantile(0.5, device="cpu") == pytest.approx(got[0, 1])


def test_solver_refuses_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        z = torch.zeros((1, 18))
        with pytest.raises(RuntimeError, match="allow_tf32"):
            me.solve_sums(z, torch.zeros((2, 1)), torch.zeros((2, 1)), z,
                          torch.tensor([0.5]), 8)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


# ---------------------------------------------------------------------------
# MomentsArena and the aggregator against the JAX package
# ---------------------------------------------------------------------------

def _lines(rng) -> tuple[list[bytes], dict]:
    """One interval: moments histograms of every scope (one sampled),
    a t-digest histogram beside them, and counters.  -> (lines,
    {name: values})."""
    out, vals = [], {}
    for i, scope in enumerate((b"", b"|#veneurlocalonly",
                               b"|#veneurglobalonly", b"|#az:b")):
        v = np.floor(rng.gamma(2.0, 20.0, int(rng.integers(40, 300)))) + 1
        name = f"mom.h{i}"
        vals[name] = v
        kind = b"h" if i % 2 == 0 else b"ms"
        out += [b"%s:%d|%s%s" % (name.encode(), x, kind, scope) for x in v]
    v = np.floor(rng.gamma(2.0, 20.0, 120)) + 1
    vals["mom.sampled"] = v
    out += [b"mom.sampled:%d|h|@0.5" % x for x in v]
    out += [b"dig.h:%d|h" % x for x in rng.integers(1, 100, 50)]
    out += [b"t.hits:%d|c" % x for x in rng.integers(1, 9, 20)]
    return out, vals


def _aggs(is_local, **kw):
    common = dict(percentiles=PCTS, is_local=is_local,
                  sketch_family_rules=RULES, **kw)
    return (JAggregator(aggregates=jsm.parse_aggregates(AGGS), **common),
            MetricAggregator(aggregates=tsm.parse_aggregates(AGGS),
                             device="cpu", **common))


def _feed(pair, lines):
    for agg, p in zip(pair, (jparser.Parser(), tparser.Parser())):
        for line in lines:
            p.parse_metric(line, agg.process_metric)


def _by_key(metrics):
    return {(m.name, tuple(m.tags), m.type): m.value for m in metrics}


def _assert_same(got, want, vals):
    """Quantiles within FLUSH_RULE of the key's span, the rest exact."""
    got, want = _by_key(got.metrics), _by_key(want.metrics)
    assert set(got) == set(want) and got
    for key, w in want.items():
        g = got[key]
        base = key[0].rsplit(".", 1)[0]
        if key[0].endswith(("percentile", ".median")) and base in vals:
            span = vals[base].max() - vals[base].min()
            assert abs(g - w) <= FLUSH_RULE * span, (key, g, w)
        else:
            assert g == w or (np.isnan(g) and np.isnan(w)), (key, g, w)


def _assert_same_forwards(got, want):
    assert sorted((f.name, f.kind) for f in got) == \
        sorted((f.name, f.kind) for f in want)
    by = {(f.name, f.kind): f for f in want}
    n_mom = 0
    for f in got:
        j = by[(f.name, f.kind)]
        assert (f.tags, int(f.scope)) == (j.tags, int(j.scope))
        assert (f.moments is None) == (j.moments is None)
        if f.moments is not None:
            assert f.moments == j.moments, f.name          # bitwise
            n_mom += 1
    return n_mom


@pytest.mark.parametrize("is_local", [False, True])
def test_aggregator_emits_and_forwards_what_jax_does(is_local):
    rng = np.random.default_rng(11 + is_local)
    pair = _aggs(is_local)
    lines, vals = _lines(rng)
    _feed(pair, lines)
    want = pair[0].flush(is_local=is_local, now=100)
    got = pair[1].flush(is_local=is_local, now=100)
    _assert_same(got, want, vals)
    assert pair[1].last_moments_resid > 0
    if is_local:
        # mixed, global-only and tagged keys forward as vectors
        assert _assert_same_forwards(got.forward, want.forward) == 4
    # the moments rows went to the moments arena, the digest to digests
    assert len(pair[1].moments.kdict) == 5
    assert len(pair[1].digests.kdict) == 1


def test_local_to_global_hop_through_the_in_process_forwarder():
    """Port servers wired local -> global in-process, beside the JAX
    aggregators doing the same hop: the global emits what JAX's does."""
    rng = np.random.default_rng(13)
    lines, vals = _lines(rng)
    sink = tsimple.ChannelMetricSink()
    glob = Server(tconfig.Config(percentiles=PCTS, aggregates=AGGS,
                                 sketch_family_rules=RULES),
                  extra_metric_sinks=[sink], device="cpu")
    local = Server(tconfig.Config(percentiles=PCTS, aggregates=AGGS,
                                  sketch_family_rules=RULES,
                                  forward_address="in-process"),
                   forwarder=glob.aggregator.import_metrics, device="cpu")
    jl, _ = _aggs(True)
    jg, _ = _aggs(False)
    _feed((jl, local.aggregator), lines)
    for f in jl.flush(is_local=True).forward:
        jg.import_metric(f)
    local.flush()
    assert local.wait_forwards(10.0)
    want = jg.flush(is_local=False, now=5)
    got = glob.aggregator.flush(is_local=False, now=5)
    _assert_same(got, want, vals)
    assert any(m.name == "mom.h0.99percentile" for m in got.metrics)


def test_hot_row_pre_reduction_matches_jax():
    """A key past DENSE_DEPTH_CAP folds into ivec on the host: the ivec
    state and the forwarded vector are bitwise JAX's."""
    rng = np.random.default_rng(14)
    n = tarena.DENSE_DEPTH_CAP * 3 + 17
    v = np.floor(rng.gamma(2.0, 30.0, n)) + 1
    lines = [b"mom.hot:%d|h" % x for x in v]
    lines += [b"mom.cold:%d|h" % x for x in v[:40]]
    pair = _aggs(True)
    _feed(pair, lines)
    for agg in pair:
        agg.sync_staged(min_samples=1)
    jm, tm = pair[0].moments, pair[1].moments
    for name in ("ivec", "iv_a", "iv_b", "d_logn", "d_weight", "d_min",
                 "d_max", "d_sum", "d_rsum"):
        np.testing.assert_array_equal(getattr(tm, name)[:2],
                                      getattr(jm, name)[:2], err_msg=name)
    assert tm.iv_a[0] == v.min() and tm._depth[0] == 0
    want = pair[0].flush(is_local=True, now=7)
    got = pair[1].flush(is_local=True, now=7)
    assert _assert_same_forwards(got.forward, want.forward) == 2
    _assert_same(got, want, {"mom.hot": v, "mom.cold": v[:40]})


def _imports(rng) -> list[dict]:
    """Forwarded moments vectors for five keys, most keys more than once
    (later vectors widen or sit inside the domain), one vector of another
    k, and NaN bounds: a NaN min on a key with state and on a fresh key,
    a NaN max on a key with state."""
    out = []
    for i in range(14):
        vec = _vec(rng, int(rng.integers(1, 100))) + 0.0
        if i == 9:
            vec[mo.IDX_MIN] = np.nan
        if i == 11:
            vec[mo.IDX_MAX] = np.nan
        out.append(dict(name=f"mom.i{i % 5}", tags=["az:a"],
                        kind="histogram", scope=0, moments=list(vec)))
    fresh = _vec(rng, 40)
    fresh[mo.IDX_MIN] = np.nan
    out.append(dict(name="mom.nan", tags=[], kind="timer", scope=2,
                    moments=list(fresh)))
    out.insert(4, dict(name="mom.i2", tags=["az:a"], kind="histogram",
                       scope=0, moments=list(_vec(rng, 30, k=4))))
    return out


@pytest.mark.parametrize("is_local", [False, True])
def test_moments_imports_match_jax_one_by_one_and_batched(is_local):
    """The same forwarded vectors into the JAX aggregator and into the
    port, once through import_metric each and once through the batched
    import_metrics: the moments host state is bitwise JAX's (NaN bounds
    included: an incoming NaN min or max leaves the row's bound as it
    was), the vector of another k fails alone, and a local tier forwards
    the bitwise same vectors."""
    fms = _imports(np.random.default_rng(15))
    jagg, one = _aggs(is_local)
    many = _aggs(is_local)[1]
    for f in fms:
        for agg, cls in ((jagg, jsm), (one, tsm)):
            if len(f["moments"]) == mo.vector_len(8):
                agg.import_metric(cls.ForwardMetric(**f))
            else:
                with pytest.raises(ValueError, match="mixed-k"):
                    agg.import_metric(cls.ForwardMetric(**f))
    assert many.import_metrics(
        [tsm.ForwardMetric(**f) for f in fms]) == (len(fms) - 1, 1)
    n = len(jagg.moments.kdict)
    assert n == len(one.moments.kdict) == len(many.moments.kdict) == 6
    for name in ("ivec", "iv_a", "iv_b", "d_logn", "d_weight", "d_min",
                 "d_max", "d_sum", "d_rsum"):
        want = getattr(jagg.moments, name)[:n]
        for port in (one, many):
            np.testing.assert_array_equal(getattr(port.moments, name)[:n],
                                          want, err_msg=name)
    assert one.imported == many.imported == jagg.imported
    # no NaN reached a bound (the fresh key's min stays +inf, as JAX's)
    assert not np.isnan(many.moments.d_min[:n]).any()
    assert not np.isnan(many.moments.d_max[:n]).any()
    want = jagg.flush(is_local=is_local, now=3)
    for port in (one, many):
        got = port.flush(is_local=is_local, now=3)
        assert sorted(_by_key(got.metrics)) == sorted(_by_key(want.metrics))
        if is_local:
            by = {f.name: f.moments for f in want.forward}
            assert len(got.forward) == len(by) == 6
            for f in got.forward:
                np.testing.assert_array_equal(f.moments, by[f.name])


@pytest.mark.parametrize("is_local", [False, True])
def test_restore_of_jax_checkpoint_with_moments_rows(is_local):
    """A JAX cut holding moments rows (staged samples, an imported
    vector's ivec, an untouched row) restores into the port, whose next
    flush emits what the JAX aggregator's does."""
    rng = np.random.default_rng(16 + is_local)
    src, ref = _aggs(is_local)[0], _aggs(is_local)[0]
    lines, vals = _lines(rng)
    p = jparser.Parser()
    for agg in (src, ref):
        for line in lines + [b"mom.once:4|h"]:
            p.parse_metric(line, agg.process_metric)
        agg.flush(is_local=is_local)
        for line in lines:
            p.parse_metric(line, agg.process_metric)
        agg.import_metric(jsm.ForwardMetric(
            name="mom.imp", tags=["x:1"], kind="histogram", scope=0,
            moments=list(_vec(np.random.default_rng(3), 90))))
    meta, arrays = src.checkpoint_state()
    assert len(arrays["moments/key_rows"]) == 7
    assert not arrays["moments/key_touched"].all()
    port = MetricAggregator(percentiles=PCTS, is_local=is_local,
                            aggregates=tsm.parse_aggregates(AGGS),
                            sketch_family_rules=RULES, device="cpu")
    port.restore_state(meta, arrays)
    want = ref.flush(is_local=is_local, now=9)
    got = port.flush(is_local=is_local, now=9)
    vals["mom.imp"] = np.asarray([_vec(np.random.default_rng(3), 90)[1],
                                  _vec(np.random.default_rng(3), 90)[2]])
    _assert_same(got, want, vals)
    if is_local:
        assert _assert_same_forwards(got.forward, want.forward) == 5
    # and the port's own cut restores into a fresh port aggregator
    again = MetricAggregator(percentiles=PCTS, sketch_family_rules=RULES,
                             device="cpu")
    again.restore_state(*port.checkpoint_state())


def test_restore_refuses_another_moments_k():
    src = JAggregator(percentiles=PCTS, sketch_family_rules=RULES,
                      sketch_moments_k=6)
    p = jparser.Parser()
    p.parse_metric(b"mom.a:3|h", src.process_metric)
    port = MetricAggregator(percentiles=PCTS, sketch_family_rules=RULES,
                            device="cpu")
    with pytest.raises(tarena.CheckpointIncompatible, match="k 6"):
        port.restore_state(*src.checkpoint_state())


def test_compactor_family_still_raises():
    """The compactor family is served; what it still refuses is what the
    JAX package refuses: a ladder geometry outside the config's ranges,
    a malformed vector, a vector or a checkpoint of other params, and an
    unknown family."""
    with pytest.raises(ValueError, match="sketch_compactor_cap"):
        tconfig.Config(sketch_compactor_cap=12)
    with pytest.raises(ValueError, match="sketch_compactor_levels"):
        tconfig.Config(sketch_compactor_levels=3)
    with pytest.raises(ValueError, match="unknown sketch family"):
        tconfig.Config(sketch_family_default="kll")
    agg = MetricAggregator(device="cpu")
    with pytest.raises(ValueError, match="not a compactor vector"):
        agg.import_metric(tsm.ForwardMetric(
            name="c", tags=[], kind="histogram", scope=0,
            compactor=[1.0, 2.0]))
    from veneur_tpu.sketches import compactor as jcs
    other = jcs.CompactorSketch(cap=16, levels=6)
    other.add_batch(np.arange(1.0, 50.0))
    with pytest.raises(ValueError, match="do not match"):
        agg.import_metric(tsm.ForwardMetric(
            name="c", tags=[], kind="histogram", scope=0,
            compactor=list(other.to_vector())))
    src = JAggregator(percentiles=PCTS, sketch_family_default="compactor",
                      sketch_compactor_cap=16)
    jparser.Parser().parse_metric(b"c.h:3|h", src.process_metric)
    port = MetricAggregator(sketch_family_default="compactor", device="cpu")
    with pytest.raises(tarena.CheckpointIncompatible, match="compactor"):
        port.restore_state(*src.checkpoint_state())
    assert not port.compactors.kdict


def test_mixed_k_import_raises():
    agg = MetricAggregator(sketch_family_rules=RULES, device="cpu")
    vec = list(_vec(np.random.default_rng(4), 30, k=4))
    with pytest.raises(ValueError, match="mixed-k"):
        agg.import_metric(tsm.ForwardMetric(
            name="mom.x", tags=[], kind="histogram", scope=0, moments=vec))


@pytest.mark.parametrize("k,ok", [(1, False), (2, True), (16, True),
                                  (17, False)])
def test_config_validates_sketch_moments_k(k, ok):
    if ok:
        cfg = tconfig.Config(sketch_moments_k=k,
                             sketch_family_default="moments")
        srv = Server(cfg, device="cpu")
        assert srv.aggregator.moments.k == k
        srv.process_packet_buffer(b"a:1|h\na:4|h\na:9|h")
        res = srv.flush()
        assert {m.name: m.value for m in res.metrics}["a.count"] == 3.0
    else:
        with pytest.raises(ValueError, match="sketch_moments_k"):
            tconfig.Config(sketch_moments_k=k)


def test_moments_entry_points_refuse_cpu_fallback_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        me.make_moments_flush()
    with pytest.raises(RuntimeError, match="CUDA"):
        me.quantiles_from_vectors(mo.empty_vector()[None], [0.5])
    with pytest.raises(RuntimeError, match="CUDA"):
        tarena.MomentsArena()
