"""bf16 staging (`digest_bf16_staging`) in the port, held against the
JAX package on identical numpy-seeded inputs.

With the option on, the flush stages its dense VALUE matrix as bfloat16:
uniform intervals take B3 on bf16 values, general ones B4 (the stable
packed-key network) at depth <= 64 and B1 on bf16 values deeper.  On the
CPU the wrappers run their plain versions, which widen bf16 to float32
first, as the JAX twin does; `chip_smoke.py` holds the CUDA kernels to
these plain versions on the card.

Tolerances:
  * BITWISE (`_same_bits`: every float32 compared as its 32 bits; only
    the weighted-sum column by value, since the sign of an all-zero sum
    depends on the reduction's starting value) for B4's plain version
    against the JAX twin and the Pallas kernel in interpret mode on
    integer-valued rows with ties, holes, empty and one-point rows; for
    the staged bf16 bits against the JAX arena's; for the emitted
    percentiles and aggregates and the forwarded centroids of a
    JAX/port server pair.
  * B1 and B3 on bf16 input: the rules of their float32 tests
    (test_torch_sorted_eval.py): bitwise on tie-free integer rows;
    gamma rows with integer weights within rtol 1e-6 / atol 1e-5 of the
    twin through B1, bitwise through B3 (unit weights), and within
    rtol 1e-6 of B3's Pallas kernel, which skips the clamp.
  * Accuracy: quantiles within 1% of numpy's Hazen percentile, as the
    JAX package's own bf16 staging test holds it
    (tests/test_precision.py).
"""

import ml_dtypes
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from veneur_tpu.core.aggregator import MetricAggregator as JAggregator
from veneur_tpu.core import arena as jarena
from veneur_tpu.ops import sorted_eval as jse
from veneur_tpu.sketches import tdigest as jtd
from veneur_tpu_torch import config as tconfig
from veneur_tpu_torch.core import arena as tarena
from veneur_tpu_torch.core.aggregator import MetricAggregator
from veneur_tpu_torch.ops import sorted_eval as se
from veneur_tpu_torch.parallel import serving
from veneur_tpu_torch.samplers import samplers as tsm
from veneur_tpu_torch.samplers.metric_key import MetricKey, MetricScope
from veneur_tpu_torch.sketches import tdigest as td
from tests.test_torch_server import PCTS, _Pair, _by_key

PCT = (0.1, 0.5, 0.9, 0.99, 0.0, 1.0)
# bf16-exact integers, distinct: +-(128..255) * 2^e for e < 4 (1024 of
# them, |v| <= 2040, so sums of v * w with w < 4 stay below 2^24)
_TIE_FREE = np.sort(np.concatenate([
    s * np.arange(128, 256) * 2.0 ** e for s in (-1, 1)
    for e in range(4)])).astype(np.float32)


def _same_bits(got, want, what=""):
    """Bitwise equality of `[U, P+2]` outputs: every quantile and total
    as its 32 bits, the weighted-sum column (last) by value."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_array_equal(got[:, :-1].view(np.int32),
                                  want[:, :-1].view(np.int32), err_msg=what)
    np.testing.assert_array_equal(got[:, -1], want[:, -1], err_msg=what)


def _rows(u, d, rng, vmax=250, pm_zero=False):
    """Integer-valued bf16-exact rows with ties (values < vmax, as
    tests/test_sorted_eval_sweep.py `_edge_case_inputs`) and integer
    weights 1..3 with ~30% holes; edge rows: whole-row tie, empty, one
    point.  pm_zero: values from {-2, -1, -0, +0, 1, 2}, so rows mix
    -0 and +0 with unequal weights."""
    if pm_zero:
        m = rng.choice(np.asarray([-2.0, -1.0, -0.0, 0.0, 1.0, 2.0],
                                  np.float32), (u, d))
    else:
        m = rng.integers(-vmax, vmax, (u, d)).astype(np.float32)
    w = ((rng.random((u, d)) < 0.7)
         * rng.integers(1, 4, (u, d))).astype(np.float32)
    m[1, :] = 5.0                    # whole-row tie
    w[2, :] = 0.0                    # empty row
    w[3, :] = 0.0
    w[3, d // 2] = 2.0               # one point
    return m, w


def _bounds(m, w):
    occ = w > 0
    has = occ.any(axis=1)
    dmin = np.where(has, np.where(occ, m, np.inf).min(1), 0.0)
    dmax = np.where(has, np.where(occ, m, -np.inf).max(1), 0.0)
    return dmin.astype(np.float32), dmax.astype(np.float32)


def _jax_args(m, w, dmin, dmax):
    return (jnp.asarray(m.astype(ml_dtypes.bfloat16)), jnp.asarray(w),
            jnp.asarray(dmin), jnp.asarray(dmax),
            jnp.asarray(PCT, jnp.float32))


def _port_args(m, w, dmin, dmax):
    return (torch.from_numpy(m).to(torch.bfloat16), torch.from_numpy(w),
            torch.from_numpy(dmin), torch.from_numpy(dmax),
            torch.tensor(PCT, dtype=torch.float32))


# ---------------------------------------------------------------------------
# (a) B4's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("u,d", [(128, 4), (128, 8), (64, 64)])
def test_b4_plain_bitwise_on_ties_and_edge_rows(u, d):
    """compact=True on bf16 rows with ties and unequal weights: the
    port's plain version (a stable sort) equals the JAX twin and the
    Pallas compact network in interpret mode bit for bit."""
    rng = np.random.default_rng(100 + d)
    m, w = _rows(u, d, rng)
    dmin, dmax = _bounds(m, w)
    got = se.weighted_eval(*_port_args(m, w, dmin, dmax), compact=True)
    assert got.dtype == torch.float32 and got.shape == (u, len(PCT) + 2)
    twin = jtd.weighted_eval(*_jax_args(m, w, dmin, dmax))
    kern = jse.weighted_eval(*_jax_args(m, w, dmin, dmax), interpret=True,
                             compact=True)
    _same_bits(got.numpy(), twin, "port plain vs JAX twin")
    _same_bits(got.numpy(), kern, "port plain vs Pallas compact")
    # ... and is td.weighted_eval, the plain version B4 is held to
    _same_bits(got.numpy(), td.weighted_eval(
        *_port_args(m, w, dmin, dmax)).numpy())


def test_b4_plain_orders_signed_zeros_as_the_twin():
    """Rows mixing -0 and +0 with unequal weights.  The stable f32 sort
    (JAX twin, port) holds -0 == +0 and keeps their column order, and
    B4's kernel keys -0 as +0 to do the same; the port equals the twin
    bit for bit, signs of zero included (clip_signed).  The TPU kernel
    sorts -0 below +0 (its 16-bit map is strictly monotone), so it
    equals the twin only on rows that do not hold both (ROADMAP C)."""
    rng = np.random.default_rng(7)
    m, w = _rows(128, 8, rng, pm_zero=True)
    dmin, dmax = _bounds(m, w)
    got = se.weighted_eval(*_port_args(m, w, dmin, dmax), compact=True)
    twin = np.asarray(jtd.weighted_eval(*_jax_args(m, w, dmin, dmax)))
    _same_bits(got.numpy(), twin)
    kern = np.asarray(jse.weighted_eval(*_jax_args(m, w, dmin, dmax),
                                        interpret=True, compact=True))
    occ = w > 0
    mixed = ((occ & (m == 0) & np.signbit(m)).any(1)
             & (occ & (m == 0) & ~np.signbit(m)).any(1))
    assert mixed.sum() > 20
    _same_bits(kern[~mixed], twin[~mixed])
    assert not np.array_equal(kern[mixed], twin[mixed])


def _b4_word(v, w, col, nan_last=True):
    """B4's 32-bit sort word in numpy, from bf16 values widened to f32:
    `compact_sort_word` of `ops/csrc/sort_network.cuh` (nan_last), or
    `compact_word`, H3's c0 and the JAX kernel's `_pack_compact` order
    (not nan_last).  The bf16 bits (v's top half; a hole, w <= 0, keys
    +inf; -0 as +0) through the monotone map in the high half, the
    column in the low half; nan_last keys every NaN above +inf."""
    b = (np.asarray(v, np.float32).view(np.uint32) >> 16).astype(np.uint32)
    b = np.where(w > 0, b, np.uint32(0x7F80)).astype(np.uint32)
    b[b == 0x8000] = 0
    if nan_last:
        b[(b & 0x7FFF) > 0x7F80] = 0x7FFF
    m16 = np.where(b & 0x8000, 0xFFFF - b, b | 0x8000).astype(np.uint32)
    return (m16 << 16) | np.asarray(col, np.uint32)


def test_b4_words_sort_in_the_plain_versions_stable_order():
    """Sorting B4's words is the plain version's stable `torch.sort` of
    the widened keys, BITWISE as a permutation, on ties, zeros of both
    signs, holes, infinities and NaN of both signs (every NaN last,
    after the holes, in column order).  H3's compact_word, the JAX
    kernel's order, differs exactly on the rows holding an occupied
    negative-signed NaN, which it sorts first (ROADMAP C10)."""
    rng = np.random.default_rng(41)
    u, d = 256, 64
    m, w = _rows(u, d, rng)
    pm = _rows(u, d, rng, pm_zero=True)[0]
    m = np.where(np.arange(u)[:, None] % 2 == 1, pm, m)
    nan, neg_nan = (np.asarray([0x7FC00000, 0xFFC00000], np.uint32)
                    .view(np.float32))
    special = np.asarray([nan, neg_nan, np.inf, -np.inf], np.float32)
    m = np.where(rng.random((u, d)) < 0.1,
                 special[rng.integers(0, 4, (u, d))], m).astype(np.float32)
    w = np.where(rng.random((u, d)) < 0.05, np.float32(-1.0), w)
    wide = m.astype(ml_dtypes.bfloat16).astype(np.float32)
    col = np.broadcast_to(np.arange(d), (u, d))
    key = torch.where(torch.from_numpy(w) > 0, torch.from_numpy(wide),
                      torch.tensor(float("inf")))
    want = torch.sort(key, dim=1, stable=True).indices.numpy()
    np.testing.assert_array_equal(
        np.argsort(_b4_word(wide, w, col), axis=1), want)
    old = np.argsort(_b4_word(wide, w, col, nan_last=False), axis=1)
    neg = ((w > 0) & np.isnan(wide) & np.signbit(wide)).any(axis=1)
    assert 20 < neg.sum() < u
    np.testing.assert_array_equal(old[~neg], want[~neg])
    assert all(not np.array_equal(old[r], want[r])
               for r in np.flatnonzero(neg))


def test_b4_plain_orders_negative_nan_as_the_twin():
    """ROADMAP C10, the smallest input on which it shows: one row of
    D = 4, values [1, 2, -NaN, 0], weights [1, 1, 1, 0].  The twin and
    the port (plain version and B4's word) sort -NaN last, so the
    median interpolates between 1 and 2 and is 2; the JAX compact
    kernel sorts it first and gives NaN.  The port equals the twin
    exactly, NaN in the same places."""
    neg_nan = np.asarray([0xFFC00000], np.uint32).view(np.float32)[0]
    m = np.asarray([[1.0, 2.0, neg_nan, 0.0]], np.float32)
    w = np.asarray([[1.0, 1.0, 1.0, 0.0]], np.float32)
    dmin, dmax = np.asarray([1.0], np.float32), np.asarray([2.0], np.float32)
    got = se.weighted_eval(*_port_args(m, w, dmin, dmax), compact=True)
    twin = np.asarray(jtd.weighted_eval(*_jax_args(m, w, dmin, dmax)))
    np.testing.assert_array_equal(got.numpy(), twin)
    kern = np.asarray(jse.weighted_eval(*_jax_args(m, w, dmin, dmax),
                                        interpret=True, compact=True))
    med = PCT.index(0.5)
    assert got[0, med] == 2.0 and np.isnan(kern[0, med])
    order = np.argsort(_b4_word(m, w, np.arange(4)), axis=1)
    np.testing.assert_array_equal(order, [[0, 1, 3, 2]])


def test_plain_clip_keeps_jax_signed_zeros():
    """The plain version's [min, max] clamp gives jnp.clip's zero: a +0
    quantile of a row whose max is -0 comes out -0, as in the twin
    (torch.clamp kept +0)."""
    m = np.asarray([[-1.0, -0.0, 0.0, 0.0]], np.float32)
    w = np.asarray([[1.0, 1.0, 0.0, 0.0]], np.float32)
    dmin = np.asarray([-1.0], np.float32)
    dmax = np.asarray([-0.0], np.float32)
    got = se.weighted_eval(*_port_args(m, w, dmin, dmax)).numpy()
    twin = np.asarray(jtd.weighted_eval(*_jax_args(m, w, dmin, dmax)))
    assert np.signbit(twin[0, PCT.index(1.0)])
    _same_bits(got, twin)


# ---------------------------------------------------------------------------
# (b) B1 and B3 plain versions on bf16 input
# ---------------------------------------------------------------------------

def _tie_free_rows(u, d, rng):
    m = np.stack([rng.choice(_TIE_FREE, d, replace=False)
                  for _ in range(u)]).astype(np.float32)
    w = ((rng.random((u, d)) < 0.7)
         * rng.integers(1, 4, (u, d))).astype(np.float32)
    w[2, :] = 0.0
    w[3, :] = 0.0
    w[3, 0] = 2.0
    return m, w


@pytest.mark.parametrize("d", [128])
def test_b1_plain_on_bf16_values(d):
    """B1 at the bf16 depths it serves (D > 64): tie-free integer rows
    bitwise against the twin and the Pallas kernel in interpret mode
    (both reading bf16); gamma rows, whose bf16 values tie, against the
    twin (stable, as the plain version) within rtol 1e-6."""
    rng = np.random.default_rng(200 + d)
    m, w = _tie_free_rows(64, d, rng)
    dmin, dmax = _bounds(m, w)
    got = se.weighted_eval(*_port_args(m, w, dmin, dmax)).numpy()
    _same_bits(got, jtd.weighted_eval(*_jax_args(m, w, dmin, dmax)))
    _same_bits(got, jse.weighted_eval(*_jax_args(m, w, dmin, dmax),
                                      interpret=True))
    g = rng.gamma(2.0, 50.0, (64, d)).astype(np.float32)
    gb = g.astype(ml_dtypes.bfloat16).astype(np.float32)
    dmin, dmax = _bounds(gb, w)
    got = se.weighted_eval(*_port_args(g, w, dmin, dmax)).numpy()
    twin = np.asarray(jtd.weighted_eval(*_jax_args(g, w, dmin, dmax)))
    np.testing.assert_allclose(got, twin, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("d", [8, 128])
def test_b3_plain_on_bf16_values(d):
    """B3 on bf16 values: bitwise against the twin (unit weights), and
    within rtol 1e-6 of the Pallas depth kernel reading bf16 (no clamp:
    ROADMAP C)."""
    rng = np.random.default_rng(300 + d)
    u = 128
    m = rng.gamma(2.0, 50.0, (u, d)).astype(np.float32)
    depths = rng.integers(0, d + 1, u).astype(np.int16)
    depths[0], depths[1], depths[2] = 0, 1, d
    occ = np.arange(d)[None, :] < depths[:, None]
    m = np.where(occ, m, 0.0).astype(np.float32)
    mb = m.astype(ml_dtypes.bfloat16)
    pct = np.asarray(PCT, np.float32)
    got = se.uniform_eval(torch.from_numpy(m).to(torch.bfloat16),
                          torch.from_numpy(depths),
                          torch.from_numpy(pct)).numpy()
    wide = mb.astype(np.float32)
    w = occ.astype(np.float32)
    dmin = np.where(depths > 0, np.where(occ, wide, np.inf).min(1), 0.0)
    dmax = np.where(depths > 0, np.where(occ, wide, -np.inf).max(1), 0.0)
    twin = np.asarray(jtd.weighted_eval(
        jnp.asarray(mb), jnp.asarray(w), jnp.asarray(dmin, jnp.float32),
        jnp.asarray(dmax, jnp.float32), jnp.asarray(pct)))[:, :len(PCT)]
    np.testing.assert_array_equal(got.view(np.int32), twin.view(np.int32))
    kern = np.asarray(jse.uniform_eval(jnp.asarray(mb), jnp.asarray(depths),
                                       jnp.asarray(pct), interpret=True))
    np.testing.assert_allclose(got, kern, rtol=1e-6)


def test_digest_eval_routes_bf16_by_depth(monkeypatch):
    """serving.digest_eval: bf16 rows of depth <= 64 take B4 (stable),
    deeper ones B1; float32 rows B1 at every depth."""
    calls = []
    real = se.weighted_eval

    def spy(*a, compact=False):
        calls.append((a[0].dtype, a[0].shape[1], compact))
        return real(*a, compact=compact)

    monkeypatch.setattr(se, "weighted_eval", spy)
    rng = np.random.default_rng(3)
    for d in (2, 64, 128):
        m, w = _rows(8, d, rng)
        args = _port_args(m, w, *_bounds(m, w))
        serving.digest_eval(*args)
        serving.digest_eval(args[0].float(), *args[1:])
    assert calls == [(torch.bfloat16, 2, True), (torch.float32, 2, False),
                     (torch.bfloat16, 64, True), (torch.float32, 64, False),
                     (torch.bfloat16, 128, False),
                     (torch.float32, 128, False)]


# ---------------------------------------------------------------------------
# (c) the staged bits
# ---------------------------------------------------------------------------

def _tie_adjacent(rng, n):
    """float64 values at and beside bf16 rounding ties: midpoints of
    neighbouring bf16 values, nudged by 2^-40 and 2^-25 relative (the
    first vanishes in float32, the second does not), both signs."""
    bits = rng.integers(0x3C00, 0x4700, n).astype(np.uint16)
    lo = bits.view(ml_dtypes.bfloat16).astype(np.float64)
    hi = (bits + 1).view(ml_dtypes.bfloat16).astype(np.float64)
    mid = (lo + hi) / 2
    out = np.concatenate([mid, mid * (1 + 2.0 ** -40),
                          mid * (1 - 2.0 ** -40), mid * (1 + 2.0 ** -25),
                          mid * (1 - 2.0 ** -25), lo])
    return np.concatenate([out, -out])


@pytest.mark.parametrize("uniform", [True, False])
def test_build_dense_stages_the_jax_bf16_bits(uniform):
    """DigestArena.build_dense(bf16_staging=True): the staged value bits
    equal the JAX arena's ml_dtypes matrix on the same staged data, tie
    neighbours included (both round float64 through float32); depths,
    weights and min/max keep their types."""
    rng = np.random.default_rng(11 + uniform)
    vals = rng.permutation(_tie_adjacent(rng, 40))
    n = len(vals)
    rows = rng.integers(0, 16, n).astype(np.int64)
    wts = (np.ones(n) if uniform
           else rng.integers(1, 5, n).astype(np.float64))
    touched = np.unique(rows)
    dmin = np.asarray([vals[rows == r].min() for r in touched])
    dmax = np.asarray([vals[rows == r].max() for r in touched])
    ja = jarena.DigestArena(capacity=64, bf16_staging=True)
    ta = tarena.DigestArena(capacity=64, device="cpu", bf16_staging=True)
    assert ta.stage_dtype == torch.bfloat16 and ta.compact_general
    staged = (rows, vals, wts)
    jv, jw, jmm = ja.build_dense(staged, touched, dmin, dmax,
                                 uniform=uniform)
    tv, tw, tmm = ta.build_dense(staged, touched, dmin, dmax,
                                 uniform=uniform)
    assert jv.dtype == ml_dtypes.bfloat16 and tv.dtype == torch.bfloat16
    np.testing.assert_array_equal(tv.view(torch.int16).numpy(),
                                  jv.view(np.int16))
    np.testing.assert_array_equal(tw, jw)
    if not uniform:
        np.testing.assert_array_equal(tmm, jmm)
    # the bytes that cross to the device: half the float32 matrix
    assert tv.nbytes == jv.nbytes == tv.numel() * 2


# ---------------------------------------------------------------------------
# (d) the slice: JAX and port servers with bf16 staging
# ---------------------------------------------------------------------------

def _values(rng, n):
    return [b"%.3f" % x for x in rng.gamma(2.0, 30.0, n)]


def _slice_lines(rng, sampled):
    """Histograms of <= 40 samples per key (each point then keeps a
    bucket of its own in the forward export's compress, so the
    forwarded centroids are the staged values on both sides): 9 keys,
    the deepest 39 points, so the dense build is 16 x 64.  `sampled`
    adds a key at rate 0.5, which makes the interval non-uniform."""
    out = []
    for i, n in enumerate((39, 5, 12, 33, 1, 20)):
        scope = (b"", b"|#veneurlocalonly")[i % 2]
        out += [b"b.lat%d:%s|h%s" % (i, v, scope) for v in _values(rng, n)]
    out += [b"b.neg:-%s|ms" % v for v in _values(rng, 20)]
    out += [b"b.zero:%s|h" % v for v in (b"-0", b"0", b"-0", b"1", b"-1")]
    out += [b"b.samp:%s|h%s" % (v, b"|@0.5" if sampled else b"")
            for v in _values(rng, 30)]
    out += [b"b.hits:1|c"] * 7
    return out


def _same_emitted(got, want):
    """The same metrics (name, tags, type) with the same float64 bits."""
    got = {k: v for k, v in _by_key(got).items() if k[0].startswith("b.")}
    want = {k: v for k, v in _by_key(want).items() if k[0].startswith("b.")}
    assert set(got) == set(want) and got
    for key, w in want.items():
        g = got[key]
        assert np.float64(g).tobytes() == np.float64(w).tobytes(), \
            (key, g, w)


@pytest.mark.parametrize("sampled", [False, True], ids=["uniform", "general"])
def test_local_tier_emits_and_forwards_what_jax_does(sampled):
    """Local tier: a uniform interval (B3 on bf16) or a general one (B4
    at depth <= 64) emits the same metrics bit for bit, and forwards
    the same centroids, as the JAX package with bf16 staging."""
    rng = np.random.default_rng(40 + sampled)
    pair = _Pair(local=True, digest_bf16_staging=True)
    try:
        assert pair.tsrv.aggregator.digests.stage_dtype == torch.bfloat16
        pair.feed(_slice_lines(rng, sampled))
        jm, tm = pair.flush()
        _same_emitted(tm, jm)
        seg = pair.tsrv.aggregator.last_flush_segments
        # bf16 values on the link: 2 bytes a point (+ weights and
        # min/max on the general build, + int16 depths on the uniform)
        assert seg["upload_bytes"] == (16 * 64 * (2 + 4) + 2 * 16 * 4
                                       if sampled else 16 * 64 * 2 + 16 * 2)
        assert pair.tfwd and len(pair.tfwd) == len(pair.jfwd)
        jby = {(f.name, f.kind): f for f in pair.jfwd}
        for f in pair.tfwd:
            j = jby[(f.name, f.kind)]
            for a, b in ((f.digest_means, j.digest_means),
                         (f.digest_weights, j.digest_weights)):
                assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), \
                    f.name
            scalars = ("digest_min", "digest_max", "digest_sum",
                       "digest_rsum")
            assert (np.asarray([getattr(f, a) for a in scalars]).tobytes()
                    == np.asarray([getattr(j, a) for a in scalars]).tobytes())
    finally:
        pair.close()


@pytest.mark.parametrize("points", [40, 100], ids=["b4", "b1_bf16"])
def test_global_tier_emits_what_jax_emits(points):
    """Global tier importing weighted digests: D = 64 (B4) or D = 128
    (B1 on bf16 values); the same metrics bit for bit."""
    rng = np.random.default_rng(50 + points)
    pair = _Pair(local=False, digest_bf16_staging=True)
    fwds = []
    for i in range(4):
        means = np.sort(rng.gamma(2.0, 20.0, points))
        w = rng.integers(1, 30, points).astype(np.float64)
        fwds.append(dict(
            name=f"b.fwd{i}", tags=["az:a"], kind="histogram", scope=0,
            digest_means=means.tolist(), digest_weights=w.tolist(),
            digest_min=float(means[0]), digest_max=float(means[-1]),
            digest_sum=float((means * w).sum()),
            digest_rsum=float((w / means).sum()), digest_compression=100.0))
    try:
        pair.feed(_slice_lines(rng, sampled=True), fwds)
        jm, tm = pair.flush()
        _same_emitted(tm, jm)
    finally:
        pair.close()


# ---------------------------------------------------------------------------
# (e) checkpoints, (f) accuracy, configuration
# ---------------------------------------------------------------------------

def test_restore_of_jax_bf16_checkpoint_flushes_identically():
    """A JAX aggregator's cut with bf16 staging restores into the port
    (host f64 staging, so nothing was narrowed), flushes identically,
    and the port's own cut stamps the same resident_stage_dtype."""
    rng = np.random.default_rng(60)
    from veneur_tpu.samplers import parser as jparser
    kw = dict(percentiles=PCTS, digest_bf16_staging=True)
    src, ref = JAggregator(**kw), JAggregator(**kw)
    p = jparser.Parser()
    for agg in (src, ref):
        for line in _slice_lines(np.random.default_rng(61), sampled=True):
            p.parse_metric(line, agg.process_metric)
    meta, arrays = src.checkpoint_state()
    assert meta["families"]["digests"]["resident_stage_dtype"] == "bfloat16"
    port = MetricAggregator(percentiles=PCTS, digest_bf16_staging=True,
                            device="cpu")
    port.restore_state(meta, arrays)
    tmeta, _ = port.checkpoint_state()
    for fam in ("digests", "moments"):
        assert (tmeta["families"][fam]["resident_stage_dtype"]
                == meta["families"][fam]["resident_stage_dtype"])
    now = 1_700_000_000 + int(rng.integers(0, 100))
    _same_emitted(list(port.flush(is_local=False, now=now).metrics),
                  list(ref.flush(is_local=False, now=now).metrics))


def test_bf16_staging_bounded_error():
    """tests/test_precision.py's envelope, mirrored: 8,000 gamma samples
    on one key (pre-reduced into weighted centroids, then B4's plain
    version at depth <= 64 or B1's deeper) give the exact count and
    quantiles within 1% of numpy's Hazen percentile."""
    agg = MetricAggregator(percentiles=[0.5, 0.99],
                           digest_bf16_staging=True, device="cpu")
    rng = np.random.default_rng(5)
    vals = rng.gamma(3.0, 20.0, 8000)
    with agg.lock:
        row = agg.digests.row_for(
            MetricKey("lat", tsm.TYPE_HISTOGRAM, ""), MetricScope.MIXED, [])
        agg.digests.sample_batch(
            np.full(len(vals), row), vals, np.ones(len(vals)))
    res = agg.flush(is_local=False)
    by = {m.name: m.value for m in res.metrics}
    assert by["lat.count"] == float(len(vals))
    for q, name in ((0.5, "lat.50percentile"), (0.99, "lat.99percentile")):
        want = np.percentile(vals, q * 100, method="hazen")
        assert abs(by[name] - want) / want < 0.01, (name, by[name], want)


def test_config_accepts_bf16_staging_and_keeps_the_order_of_errors():
    """The option is served; with digest_float64 or another unported
    option the unported option raises first, as NotImplementedError.
    With mesh_devices (served) the JAX package's contradiction raises,
    as ValueError."""
    assert tconfig.Config(digest_bf16_staging=True).digest_bf16_staging
    for other in ({"digest_float64": True},
                  {"distributed_num_processes": 2}):
        with pytest.raises(NotImplementedError):
            tconfig.Config(digest_bf16_staging=True, **other)
    with pytest.raises(ValueError, match="device mesh"):
        tconfig.Config(digest_bf16_staging=True, mesh_devices=2)


def test_moments_family_ignores_bf16_staging():
    """The moments family stages float32 whatever the option, as in the
    JAX package (its arena drops the option)."""
    agg = MetricAggregator(percentiles=PCTS, digest_bf16_staging=True,
                           sketch_family_default="moments", device="cpu")
    assert agg.moments.stage_dtype == torch.float32
    assert agg.digests.stage_dtype == torch.bfloat16
    jagg = JAggregator(percentiles=PCTS, digest_bf16_staging=True,
                       sketch_family_default="moments")
    assert str(np.dtype(jagg.moments.stage_dtype)) == "float32"
    with agg.lock:
        row = agg.moments.row_for(
            MetricKey("m", tsm.TYPE_HISTOGRAM, ""), MetricScope.MIXED, [])
        agg.moments.sample_batch(np.full(3, row), np.asarray([1.0, 2, 3]),
                                 np.ones(3))
        agg.moments.sync()
    dv, _, _ = agg.moments.build_dense(
        agg.moments.take_staged(), np.asarray([row]),
        np.asarray([1.0]), np.asarray([3.0]), uniform=True)
    assert dv.dtype == np.float32
