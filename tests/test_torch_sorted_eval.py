"""The port's sorted evaluation (B1 weighted, B2 key-only on 0/1
weights, B3 depth-vector) held against the JAX package on identical
numpy-seeded inputs.

On the CPU the wrappers in `veneur_tpu_torch.ops.sorted_eval` run their
plain PyTorch versions, so these tests pin the arithmetic the CUDA
kernels are compared with on the card (`chip_smoke.py`).

Tolerances:
  * integer-valued, tie-free rows (with the edge rows: empty, single
    point, zero-weight holes): BITWISE.  Every sum is exact in any
    order and the two products the JAX twin pins against contraction
    round once in PyTorch's eager ops, so nothing is left to differ.
  * float (gamma) values with integer weights through B1: rtol 1e-6 /
    atol 1e-5.  XLA and PyTorch sum the weighted sum in different
    orders, which moves its last ulps.  Fractional weights make the
    prefix sums inexact too; see test_b1_plain_close_on_fractional_weights.
  * B3 on float rows: BITWISE against the JAX twin.  Unit weights make
    every position, cumulative weight and total an exact small integer,
    and ties in a key-only sort are the same value, so no summation
    order enters.  Against the Pallas kernel, rtol 1e-6: the kernel
    skips the [min, max] clamp (see test_b3_plain_bitwise).
  * B2 (weights in {0, 1}, holes anywhere in the row): BITWISE against
    the Pallas kernel in interpret mode and the XLA twin on integer
    rows, and BITWISE against B1's plain version on every row (by
    value: an empty row's sum is +0 here and may be -0 there, from
    0 * a negative hole).  On float rows the quantile and total
    columns are bitwise the JAX package's too (unit weights make every
    cumulative position exact, and B2 clamps as the JAX B2 does: it
    goes through _eval_tail with the min/max operand, unlike B3); the
    sum column is within rtol 1e-6, since XLA adds the sorted values in
    another order.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from veneur_tpu.ops import sorted_eval as jse
from veneur_tpu.parallel import serving as jserving
from veneur_tpu.sketches import tdigest as jtd
from veneur_tpu_torch.ops import sorted_eval as se
from veneur_tpu_torch.parallel import serving
from veneur_tpu_torch.sketches import tdigest as td

PCT = (0.5, 0.1, 0.9, 0.99, 0.0, 1.0)


def _edge_rows(u, d, rng, float_values=False, max_w=4):
    """Rows of weighted points with the kernels' edge rows: an empty
    row, a single-point row, a full row, and zero-weight holes
    everywhere else.  Values are distinct within a row (tie-free)."""
    if float_values:
        m = rng.gamma(2.0, 50.0, (u, d)).astype(np.float32)
    else:
        m = np.stack([rng.choice(1 << 16, d, replace=False)
                      for _ in range(u)]).astype(np.float32)
        m -= 1 << 15                       # negatives too
    w = ((rng.random((u, d)) < 0.7)
         * rng.integers(1, max_w, (u, d))).astype(np.float32)
    if float_values == "fractional":
        w = (w * rng.gamma(1.0, 1.0, (u, d))).astype(np.float32)
    w[0, :] = 0.0                         # empty row
    w[1, :] = 0.0
    w[1, d // 2] = 3.0                     # single point, mid-row
    w[2, :] = 1.0                          # full row
    occ = w > 0
    has = occ.any(axis=1)
    dmin = np.where(has, np.where(occ, m, np.inf).min(1), 0.0)
    dmax = np.where(has, np.where(occ, m, -np.inf).max(1), 0.0)
    return (m, w, dmin.astype(np.float32), dmax.astype(np.float32),
            np.asarray(PCT, np.float32))


def _depth_rows(u, d, rng, float_values=False):
    """Depth-vector rows: the first depths[k] columns are real points
    (weight 1); the rest is zero padding.  Edge rows: empty, single
    point, full."""
    if float_values:
        m = rng.gamma(2.0, 50.0, (u, d)).astype(np.float32)
    else:
        m = np.stack([rng.choice(1 << 16, d, replace=False)
                      for _ in range(u)]).astype(np.float32)
    depths = rng.integers(0, d + 1, u).astype(np.int16)
    depths[0], depths[1], depths[2] = 0, 1, d
    occ = np.arange(d)[None, :] < depths[:, None]
    m = np.where(occ, m, 0.0).astype(np.float32)
    return m, depths, np.asarray(PCT, np.float32)


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _tied_rows(u, d, rng):
    """Integer rows with tied runs (values drawn per row from [-r, r],
    r in {1, 4, 2D}), zeros of both signs, integer weights 1..3 with
    ~30% zero-weight holes, and the edge rows (empty, single point,
    full, whole-row tie).  Every sum is exact."""
    r = rng.choice([1, 4, 2 * d], (u, 1))
    m = rng.integers(-r, r + 1, (u, d)).astype(np.float32)
    m = np.where((m == 0) & (rng.random((u, d)) < 0.5), np.float32(-0.0),
                 m).astype(np.float32)
    w = ((rng.random((u, d)) < 0.7)
         * rng.integers(1, 4, (u, d))).astype(np.float32)
    w[0, :] = 0.0
    w[1, :] = 0.0
    w[1, d // 2] = 3.0
    w[2, :] = 1.0
    m[3, :] = 7.0
    occ = w > 0
    has = occ.any(axis=1)
    dmin = np.where(has, np.where(occ, m, np.inf).min(1), 0.0)
    dmax = np.where(has, np.where(occ, m, -np.inf).max(1), 0.0)
    pct = np.arange(33, dtype=np.float32) / 32
    return (m, w, dmin.astype(np.float32), dmax.astype(np.float32), pct)


@pytest.mark.parametrize("d", [2, 16, 64, 512])
def test_b1_plain_is_the_stable_order_of_the_jax_twin(d):
    """The order B1's packed-word network reproduces on the card: tied
    values keep their column order and -0 sorts as +0, so a quantile
    that straddles a tied run of unequal weights, or a run of zeros of
    both signs, is the JAX twin's (`lax.sort`, stable) bit for bit.  The
    sum column by value: its sign on an all-zero row depends on where
    the summation starts."""
    rng = np.random.default_rng(9000 + d)
    args = _tied_rows(64, d, rng)
    got = se.weighted_eval(*_t(*args)).numpy()
    twin = np.asarray(jtd.weighted_eval(*_j(*args)))
    n = len(args[4])
    np.testing.assert_array_equal(got[:, :n + 1].view(np.int32),
                                  twin[:, :n + 1].view(np.int32))
    np.testing.assert_array_equal(got[:, n + 1], twin[:, n + 1])
    m, w = args[0], args[1]
    zero = (m == 0) & (w > 0)
    assert (zero & np.signbit(m)).any() and (zero & ~np.signbit(m)).any()


def _sort_word(v, w, col):
    """`sort_word` of `ops/csrc/sort_network.cuh` in numpy: the key (v
    where w > 0, else +inf; -0 as +0; any NaN above +inf) through the
    monotone IEEE map in the high 32 bits, the column in the low 32."""
    b = np.where(w > 0, v, np.float32(np.inf)).astype(np.float32)
    b = b.view(np.uint32).copy()
    b[b == 0x80000000] = 0
    b[(b & 0x7FFFFFFF) > 0x7F800000] = 0x7FFFFFFF
    key = np.where(b & 0x80000000, ~b, b | 0x80000000).astype(np.uint64)
    return (key << np.uint64(32)) | col.astype(np.uint64)


def test_packed_words_sort_in_the_plain_versions_stable_order():
    """Sorting B1's words is the plain version's stable sort of the
    keys, on ties, zeros of both signs, holes, negative weights,
    infinities and NaN values (both sort last, after the holes, in
    column order), so the kernel's order is the plain version's on
    every row."""
    rng = np.random.default_rng(31)
    u, d = 256, 32
    m, w = _tied_rows(u, d, rng)[:2]
    special = np.array([np.nan, -np.nan, np.inf, -np.inf], np.float32)
    pick = rng.random((u, d)) < 0.1
    m = np.where(pick, special[rng.integers(0, 4, (u, d))], m)
    m = m.astype(np.float32)
    w = np.where(rng.random((u, d)) < 0.05, np.float32(-1.0), w)
    col = np.broadcast_to(np.arange(d), (u, d))
    order = np.argsort(_sort_word(m, w, col), axis=1)
    key = torch.where(torch.from_numpy(w) > 0, torch.from_numpy(m),
                      torch.tensor(float("inf")))
    want = torch.sort(key, dim=1, stable=True).indices.numpy()
    np.testing.assert_array_equal(order, want)


def _rank_uniform(n, d, tq):
    """`rank_uniform` of `ops/csrc/sorted_eval.cu` in Python: B2's
    closed-form count of the cmids (c + 0.5 for c < n, 3e38 after) below
    tq."""
    x = float(tq) - 0.5
    rank = 0 if not x > 0.0 else (n if x >= n else int(np.ceil(x)))
    return rank + (d - n if np.float32(3.0e38) < tq else 0)


def test_b2_closed_form_rank_is_the_count():
    """B2's tail takes the rank in closed form; it must be the plain
    version's count #{cmid < tq} on every tq, half-integers (where a
    cmid equals tq) and non-finite values included."""
    d = 64
    for n in (0, 1, 2, 3, 17, 63, 64):
        cmid = np.where(np.arange(d) < n, np.arange(d) + 0.5,
                        3.0e38).astype(np.float32)
        tqs = np.concatenate([
            np.arange(-1.0, n + 2.0, 0.5, dtype=np.float32),
            np.nextafter(np.arange(0.5, n + 1.0, 1.0, dtype=np.float32),
                         np.float32(np.inf)),
            np.nextafter(np.arange(0.5, n + 1.0, 1.0, dtype=np.float32),
                         np.float32(-np.inf)),
            np.array([np.nan, np.inf, -np.inf, 3.0e38, 3.4e38],
                     np.float32)])
        for tq in tqs:
            assert _rank_uniform(n, d, tq) == int((cmid < tq).sum()), (n, tq)


def _b3_cmid(n, d):
    """B3's cmid over a row of depth n, as the block kernel built it
    point by point: c + 0.5 for c < n, 3e38 after."""
    return np.where(np.arange(d) < n, np.arange(d) + 0.5,
                    3.0e38).astype(np.float32)


@pytest.mark.parametrize("d", [2, 8, 64, 1024])
def test_b3_closed_form_rank_over_the_depth_is_the_count(d):
    """B3's warp kernel takes each rank in closed form over the row's
    depth (`rank_uniform(n = depth, d, tq)`, tq = q * depth rounded to
    f32 as the kernel rounds it); it must equal the point count
    #{cmid < tq} that the block kernel took, BITWISE as an integer, at
    every depth from 0 to D, on a percentile grid whose tq falls on
    half-integers (a cmid itself), just beside them, and on NaN tq."""
    depths = sorted({0, 1, 2, d - 1, d}
                    | set(range(0, d + 1, max(1, d // 16))))
    grid = np.concatenate([np.arange(65, dtype=np.float32) / 64,
                           np.asarray([np.nan, 1e-30, 0.999999], np.float32)])
    for n in depths:
        cmid = _b3_cmid(n, d)
        qs = grid
        if n:
            # q with q * n a half-integer, and its f32 neighbours
            half = (np.arange(n, dtype=np.float32) + np.float32(0.5)) / n
            qs = np.concatenate([
                grid, half, np.nextafter(half, np.float32(np.inf)),
                np.nextafter(half, np.float32(-np.inf))]).astype(np.float32)
        tqs = qs * np.float32(n)
        assert np.isnan(tqs).any()
        if n:
            assert (tqs == np.floor(tqs) + np.float32(0.5)).any()
        for tq in tqs:
            assert _rank_uniform(n, d, tq) == int((cmid < tq).sum()), (n, tq)


def _lane_points(d):
    """`lane_points` of `ops/csrc/sort_network.cuh`: E, the points a
    lane holds in rows of depth d."""
    return d if d <= 8 else (d // 2 if d <= 32 else 32)


def _exchange(lo, hi, asc):
    """bitonic_rows' compare-exchange rule, elementwise: swap only where
    the lower key is strictly greater (ascending) or strictly less
    (descending)."""
    swap = np.where(asc, lo > hi, lo < hi)
    return np.where(swap, hi, lo), np.where(swap, lo, hi)


def _bitonic_rows(key):
    """`bitonic_rows<false>` in numpy: the block network's stages, every
    compare-exchange of a stage at once, on each row of `key`."""
    key = key.copy()
    d = key.shape[1]
    idx = np.arange(d)
    k = 2
    while k <= d:
        j = k >> 1
        while j > 0:
            i = idx[(idx & j) == 0]
            key[:, i], key[:, i + j] = _exchange(
                key[:, i], key[:, i + j], (i & k) == 0)
            j >>= 1
        k <<= 1
    return key


def _warp_bitonic(key):
    """`warp_bitonic<E>` in numpy, step for step: the rows of `key`,
    row-major, cut into warp chunks of 32 lanes x E points (lane l holds
    a chunk's points l E .. l E + E - 1); the in-lane merges of runs
    shorter than E, then from k = E on the strides of E and more
    between lanes l and l ^ (j / E) (every lane of a stage reading its
    partner's value from before the stage, as a shuffle does) and the
    strides below E inside each lane."""
    u, d = key.shape
    e = _lane_points(d)
    x = key.reshape(-1, 32, e).copy()
    lane = np.arange(32)[None, :]
    k = 2
    while k < e:
        j = k >> 1
        while j > 0:
            for r in range(e):
                if r & j == 0:
                    x[:, :, r], x[:, :, r | j] = _exchange(
                        x[:, :, r], x[:, :, r | j], (r & k) == 0)
            j >>= 1
        k <<= 1
    first = (lane * e) & (d - 1)
    k = e
    while k <= d:
        asc = (first & k) == 0
        j = k >> 1
        while j >= e:
            other = x[:, lane[0] ^ (j // e), :]
            lower = ((lane & (j // e)) == 0)[:, :, None]
            lo = np.where(lower, x, other)
            hi = np.where(lower, other, x)
            take = np.where(asc[:, :, None], lo > hi, lo < hi)
            x = np.where(take, other, x)
            j >>= 1
        j = e >> 1
        while j > 0:
            for r in range(e):
                if r & j == 0:
                    x[:, :, r], x[:, :, r | j] = _exchange(
                        x[:, :, r], x[:, :, r | j], asc)
            j >>= 1
        k <<= 1
    return x.reshape(u, d)


@pytest.mark.parametrize("d", [2, 4, 8, 16, 32, 64, 128, 256, 512, 1024])
def test_warp_network_makes_the_block_networks_exchanges(d):
    """B3's sorted keys are the block network's bits: `warp_bitonic`,
    at the points a lane holds at this depth (every E of lane_points
    across the grid), gives `bitonic_rows`' output BITWISE on B3's keys
    (values below the depth, +inf after) with ties, zeros of both signs,
    infinities and NaN, whose order neither network fixes by value."""
    rng = np.random.default_rng(4100 + d)
    u = max(8, 32 * _lane_points(d) // d * 2)
    m = _tied_rows(u, d, rng)[0]
    special = np.array([np.nan, -np.inf, np.inf, -0.0, 0.0], np.float32)
    m = np.where(rng.random((u, d)) < 0.05,
                 special[rng.integers(0, 5, (u, d))], m).astype(np.float32)
    depths = rng.integers(0, d + 1, u)
    depths[:2] = (0, d)
    key = np.where(np.arange(d)[None, :] < depths[:, None], m,
                   np.float32(np.inf)).astype(np.float32)
    want = _bitonic_rows(key)
    got = _warp_bitonic(key)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    zero = want == 0
    assert (zero & np.signbit(want)).any() and (zero & ~np.signbit(want)).any()


def _tied_depth_rows(u, d, rng):
    """B3 inputs with tied runs: _tied_rows' integer values (zeros of
    both signs) in the first depths[k] columns, depths over [0, D] with
    the edge rows (empty, single point, full, full whole-row tie), and
    the smallest rows of C11 and C12 ([-0, +0] and [-0, -0] at depth 2)
    as rows 4 and 5."""
    m, _, _, _, pct = _tied_rows(u, d, rng)
    depths = rng.integers(0, d + 1, u).astype(np.int16)
    depths[:6] = (0, 1, d, d, 2, 2)
    m[4, :2] = (-0.0, 0.0)
    m[5, :2] = (-0.0, -0.0)
    m = np.where(np.arange(d)[None, :] < depths[:, None], m,
                 np.float32(0.0)).astype(np.float32)
    return m, depths, pct


def _b3_model(m, depths, pct):
    """B3's CUDA kernel in numpy, step for step: the keys (value below
    the depth, +inf after) sorted by `warp_bitonic`, the closed-form
    rank over the depth, tail_value's f32 interpolation with its unit
    step, no [min, max] clamp (ROADMAP C1), and 0 on an empty row."""
    u, d = m.shape
    key = np.where(np.arange(d)[None, :] < depths[:, None], m,
                   np.float32(np.inf)).astype(np.float32)
    srt = _warp_bitonic(key)
    out = np.zeros((u, len(pct)), np.float32)
    for r in range(u):
        n = int(depths[r])
        for c, q in enumerate(pct):
            if n <= 1:
                out[r, c] = srt[r, 0] if n else 0.0
                continue
            tq = np.float32(q) * np.float32(n)
            ii = min(max(_rank_uniform(n, d, tq), 1), n - 1)
            tt = np.float32(np.clip(tq - np.float32(ii - 0.5), 0, 1))
            out[r, c] = srt[r, ii - 1] + np.float32(
                (srt[r, ii] - srt[r, ii - 1]) * tt)
    return out


@pytest.mark.parametrize("d", [2, 8, 64])
def test_b3_plain_takes_signed_zero_bounds_as_the_twin(d):
    """ROADMAP C11: B3's plain version rebuilds each row's [min, max]
    with -0 below +0, as the twin's `jnp.min` / `jnp.max` do, so on tied
    rows with zeros of both signs it is the twin BITWISE.  Smallest
    input (row 4): [-0, +0] at depth 2, where `torch.amax` gave a -0
    max and every quantile read -0; the twin reads +0."""
    rng = np.random.default_rng(4200 + d)
    m, depths, pct = _tied_depth_rows(64, d, rng)
    got = se.uniform_eval(*_t(m, depths, pct)).numpy()
    twin = np.asarray(jserving.digest_eval_uniform(*_j(m, depths, pct)))
    np.testing.assert_array_equal(got.view(np.int32), twin.view(np.int32))
    assert not np.signbit(got[4]).any() and np.signbit(got[5]).all()


@pytest.mark.parametrize("d", [2, 8, 64])
def test_b3_kernel_reads_plus_zero_where_the_plain_clamps_to_minus_zero(d):
    """ROADMAP C12, the rule `chip_smoke.py`'s check_uniform holds B3
    to on integer rows: B3's kernel (modelled step for step) is the
    JAX kernel's output BITWISE on tied rows with zeros of both signs,
    and its plain version's bitwise except where the plain version
    clamps a zero quantile to a -0 bound: there the kernel reads +0 (or
    a single point's -0).  Smallest input (row 5): [-0, -0] at depth 2 reads +0 in both
    kernels and -0 in the plain version and the twin."""
    rng = np.random.default_rng(4300 + d)
    m, depths, pct = _tied_depth_rows(64, d, rng)
    model = _b3_model(m, depths, pct)
    pallas = np.asarray(jse.uniform_eval(*_j(m, depths, pct),
                                         interpret=True))
    np.testing.assert_array_equal(model.view(np.int32),
                                  pallas.view(np.int32))
    plain = se.uniform_eval(*_t(m, depths, pct)).numpy()
    neg0 = (plain == 0) & np.signbit(plain)
    np.testing.assert_array_equal(np.where(neg0, 0, model).view(np.int32),
                                  np.where(neg0, 0, plain).view(np.int32))
    assert (model[neg0] == 0).all()
    assert neg0[5].all() and not np.signbit(model[5]).any()


@pytest.mark.parametrize("u,d", [(256, 4), (128, 8), (64, 64), (5, 2)])
def test_b1_plain_bitwise_on_integer_rows(u, d):
    rng = np.random.default_rng(1000 + d)
    args = _edge_rows(u, d, rng)
    got = se.weighted_eval(*_t(*args)).numpy()
    twin = np.asarray(jtd.weighted_eval(*_j(*args)))
    np.testing.assert_array_equal(got, twin)
    if u % 64 == 0:
        pallas = np.asarray(jse.weighted_eval(*_j(*args), interpret=True))
        np.testing.assert_array_equal(got, pallas)
    # edge rows: empty -> zeros, single point -> the point itself
    assert not got[0].any()
    np.testing.assert_array_equal(got[1, :len(PCT)], args[0][1, d // 2])


@pytest.mark.parametrize("u,d", [(256, 16), (64, 64)])
def test_b1_plain_close_on_float_rows(u, d):
    """Gamma values with integer weights, as staged points carry them
    (sample counts, 1/rate for integer rates, centroid counts)."""
    rng = np.random.default_rng(2000 + d)
    args = _edge_rows(u, d, rng, float_values=True)
    got = se.weighted_eval(*_t(*args)).numpy()
    twin = np.asarray(jtd.weighted_eval(*_j(*args)))
    np.testing.assert_allclose(got, twin, rtol=1e-6, atol=1e-5)


def test_b1_plain_close_on_fractional_weights():
    """Fractional weights make the prefix sums inexact: XLA and PyTorch
    accumulate them in different orders, so a cumulative midpoint can
    move by an ulp, and a quantile that interpolates across a narrow
    cumulative gap moves by that ulp times (m_hi - m_lo) / gap.  Totals
    and sums stay within rtol 1e-6; quantiles within rtol 1e-4."""
    rng = np.random.default_rng(2100)
    args = _edge_rows(256, 16, rng, float_values="fractional")
    got = se.weighted_eval(*_t(*args)).numpy()
    twin = np.asarray(jtd.weighted_eval(*_j(*args)))
    n = len(PCT)
    np.testing.assert_allclose(got[:, n:], twin[:, n:], rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(got[:, :n], twin[:, :n], rtol=1e-4,
                               atol=1e-5)


def test_b1_plain_tied_rows_agree_on_totals():
    """Tied values: both sides sort stably (as the kernel does), so
    totals, sums and every quantile agree, also those that straddle a
    tied run."""
    rng = np.random.default_rng(7)
    u, d = 64, 16
    m = rng.integers(0, 4, (u, d)).astype(np.float32)
    w = rng.integers(0, 3, (u, d)).astype(np.float32)
    occ = w > 0
    dmin = np.where(occ.any(1), np.where(occ, m, np.inf).min(1), 0.0)
    dmax = np.where(occ.any(1), np.where(occ, m, -np.inf).max(1), 0.0)
    args = (m, w, dmin.astype(np.float32), dmax.astype(np.float32),
            np.asarray(PCT, np.float32))
    got = se.weighted_eval(*_t(*args)).numpy()
    twin = np.asarray(jtd.weighted_eval(*_j(*args)))
    np.testing.assert_array_equal(got, twin)


@pytest.mark.parametrize("u,d", [(256, 4), (128, 8), (64, 64)])
@pytest.mark.parametrize("float_values", [False, True])
def test_b3_plain_bitwise(u, d, float_values):
    rng = np.random.default_rng(3000 + d + int(float_values))
    m, depths, pct = _depth_rows(u, d, rng, float_values)
    got = se.uniform_eval(*_t(m, depths, pct)).numpy()
    assert got.shape == (u, len(PCT))
    twin = np.asarray(jserving.digest_eval_uniform(*_j(m, depths, pct)))
    np.testing.assert_array_equal(got, twin)
    pallas = np.asarray(jse.uniform_eval(*_j(m, depths, pct),
                                         interpret=True))
    if float_values:
        # the depth-vector kernels skip the [min, max] clamp, and
        # m_lo + (m_hi - m_lo) * 1 may round one ulp past m_hi, which
        # the plain version's clamp pulls back
        np.testing.assert_allclose(got, pallas, rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(got, pallas)
    assert not got[0].any()
    np.testing.assert_array_equal(got[1], m[1, 0])


def test_b3_matches_b1_on_unit_weights():
    """B3 is B1's quantile columns for w = (col < depth)."""
    rng = np.random.default_rng(11)
    m, depths, pct = _depth_rows(128, 32, rng, float_values=True)
    occ = np.arange(32)[None, :] < depths[:, None].astype(np.int64)
    w = occ.astype(np.float32)
    has = depths > 0
    dmin = np.where(has, np.where(occ, m, np.inf).min(1), 0.0)
    dmax = np.where(has, np.where(occ, m, -np.inf).max(1), 0.0)
    b1 = se.weighted_eval(*_t(m, w, dmin.astype(np.float32),
                              dmax.astype(np.float32), pct)).numpy()
    b3 = se.uniform_eval(*_t(m, depths, pct)).numpy()
    np.testing.assert_array_equal(b3, b1[:, :len(PCT)])


def _unit_rows(u, d, rng, float_values=False):
    """_edge_rows with every nonzero weight 1: holes anywhere."""
    m, w, dmin, dmax, pct = _edge_rows(u, d, rng, float_values, max_w=2)
    return m, (w > 0).astype(np.float32), dmin, dmax, pct


@pytest.mark.parametrize("u,d", [(256, 4), (128, 8), (64, 64), (64, 2),
                                 (5, 16)])
def test_b2_plain_bitwise_on_integer_rows(u, d):
    rng = np.random.default_rng(4000 + d + u)
    args = _unit_rows(u, d, rng)
    got = se.weighted_eval(*_t(*args), uniform=True).numpy()
    assert got.shape == (u, len(PCT) + 2)
    twin = np.asarray(jserving.digest_eval(*_j(*args)))
    np.testing.assert_array_equal(got, twin)
    if u % 64 == 0:
        pallas = np.asarray(jse.weighted_eval(*_j(*args), uniform=True,
                                              interpret=True))
        np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(
        got, se.weighted_eval_plain(*_t(*args)).numpy())
    assert not got[0].any()
    np.testing.assert_array_equal(got[1, :len(PCT)], args[0][1, d // 2])


@pytest.mark.parametrize("u,d", [(128, 16), (64, 64)])
def test_b2_plain_on_float_rows(u, d):
    rng = np.random.default_rng(4100 + d)
    args = _unit_rows(u, d, rng, float_values=True)
    got = se.weighted_eval(*_t(*args), uniform=True).numpy()
    n = len(PCT)
    pallas = np.asarray(jse.weighted_eval(*_j(*args), uniform=True,
                                          interpret=True))
    twin = np.asarray(jserving.digest_eval(*_j(*args)))
    for ref in (pallas, twin):
        np.testing.assert_array_equal(got[:, :n + 1], ref[:, :n + 1])
        np.testing.assert_allclose(got[:, n + 1], ref[:, n + 1],
                                   rtol=1e-6)
    # the clamp holds: no quantile leaves its row's [min, max]
    has = args[1].any(axis=1)
    assert (got[has, :n] <= args[3][has, None]).all()
    assert (got[has, :n] >= args[2][has, None]).all()
    b1 = se.weighted_eval_plain(*_t(*args)).numpy()
    np.testing.assert_array_equal(got[:, :n + 1], b1[:, :n + 1])
    np.testing.assert_allclose(got[:, n + 1], b1[:, n + 1], rtol=1e-6)


def test_b2_plain_equals_b1_plain_on_tied_unit_rows():
    """Ties in a key-only sort are one value, so B2 and B1 agree on tied
    rows too."""
    rng = np.random.default_rng(8)
    u, d = 64, 16
    m = rng.integers(0, 4, (u, d)).astype(np.float32)
    w = (rng.random((u, d)) < 0.6).astype(np.float32)
    occ = w > 0
    dmin = np.where(occ.any(1), np.where(occ, m, np.inf).min(1), 0.0)
    dmax = np.where(occ.any(1), np.where(occ, m, -np.inf).max(1), 0.0)
    args = _t(m, w, dmin.astype(np.float32), dmax.astype(np.float32),
              np.asarray(PCT, np.float32))
    np.testing.assert_array_equal(
        se.weighted_eval(*args, uniform=True).numpy(),
        se.weighted_eval_plain(*args).numpy())


def test_b2_refuses_bf16_values_and_compact():
    rng = np.random.default_rng(6)
    m, w, dmin, dmax, pct = _t(*_unit_rows(8, 4, rng))
    with pytest.raises(ValueError, match="float32"):
        se.weighted_eval(m.bfloat16(), w, dmin, dmax, pct, uniform=True)
    with pytest.raises(ValueError, match="exclude"):
        se.weighted_eval(m.bfloat16(), w, dmin, dmax, pct, uniform=True,
                         compact=True)


def test_cpu_tensors_never_count_a_launch():
    se.reset_launches()
    rng = np.random.default_rng(5)
    m, w, dmin, dmax, pct = _t(*_edge_rows(8, 4, rng))
    se.weighted_eval(m, w, dmin, dmax, pct)
    se.weighted_eval(m.bfloat16(), w, dmin, dmax, pct)
    se.weighted_eval(m.bfloat16(), w, dmin, dmax, pct, compact=True)
    se.weighted_eval(m, (w > 0).float(), dmin, dmax, pct, uniform=True)
    m, depths, pct = _t(*_depth_rows(8, 4, rng))
    se.uniform_eval(m, depths, pct)
    se.uniform_eval(m.bfloat16(), depths, pct)
    m, w = _t(*_edge_rows(8, 4, rng))[:2]
    for cut in se.STAGE_CUTS:
        se.stage_slice(m, w, cut)
    assert se.launches == {
        "weighted_eval": 0, "uniform_eval": 0, "weighted_eval_compact": 0,
        "weighted_eval_bf16": 0, "uniform_eval_bf16": 0,
        "weighted_eval_uniform": 0, "stage_slice": 0,
        "stage_slice_wide": 0}


def test_wrappers_refuse_other_devices_and_mixes():
    m = torch.zeros((4, 4), device="meta")
    w = torch.zeros((4, 4), device="meta")
    v = torch.zeros(4, device="meta")
    pct = torch.zeros(2, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        se.weighted_eval(m, w, v, v, pct)
    with pytest.raises(ValueError, match="several devices"):
        se.uniform_eval(torch.zeros((4, 4)), torch.zeros(4, dtype=torch.int16,
                                                         device="meta"),
                        torch.zeros(2))


@pytest.mark.parametrize("d", [1, 3, 12, 2048])
def test_kernel_input_check_refuses_bad_depths(d):
    m = torch.zeros((4, d))
    with pytest.raises(ValueError, match="power of two"):
        se._check_kernel_inputs("weighted_eval", m, (m,), ((m, (4, d)),))


def test_kernel_input_check_refuses_dtype_shape_layout():
    m = torch.zeros((4, 8))
    # values: float32 or bf16 (bf16 staging); weights and the rest float32
    se._check_kernel_inputs("weighted_eval", m.bfloat16(), (m,), ())
    for bad in (m.half(), m.double()):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            se._check_kernel_inputs("weighted_eval", bad, (m,), ())
    for bad in (m.bfloat16(), m.double()):
        with pytest.raises(ValueError, match="expected float32"):
            se._check_kernel_inputs("weighted_eval", m, (bad,), ())
    # B4 (compact=True) takes bf16 values of depth <= 64 only, on any
    # device
    w, v, pct = torch.ones((4, 8)), torch.zeros(4), torch.zeros(2)
    with pytest.raises(ValueError, match="bfloat16"):
        se.weighted_eval(m, w, v, v, pct, compact=True)
    deep = torch.zeros((4, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="depth 128 > 64"):
        se.weighted_eval(deep, torch.ones((4, 128)), v, v, pct,
                         compact=True)
    with pytest.raises(ValueError, match="shape"):
        se._check_kernel_inputs("weighted_eval", m, (m,),
                                ((torch.zeros(3), (4,)),))
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros((8, 4)).T
        se._check_kernel_inputs("weighted_eval", m, (t,), ((t, (4, 8)),))


def test_serving_flush_routes_to_both_kernels_on_cpu():
    """make_serving_flush(None): the general program is B1, its
    depth_variant B3; a mesh must be a parallel.mesh.Mesh (the meshed
    program is tests/test_torch_mesh.py's)."""
    rng = np.random.default_rng(9)
    m, w, dmin, dmax, pct = _edge_rows(16, 8, rng)
    fn = serving.make_serving_flush(None, "cpu")
    mm = np.stack([dmin, dmax])
    got = fn(*_t(m, w, mm, pct)).numpy()
    np.testing.assert_array_equal(got, td.weighted_eval(
        *_t(m, w, dmin, dmax, pct)).numpy())
    md, depths, pct = _depth_rows(16, 8, rng)
    np.testing.assert_array_equal(
        fn.depth_variant(*_t(md, depths, pct)).numpy(),
        se.uniform_eval_plain(*_t(md, depths, pct)).numpy())
    with pytest.raises(TypeError, match="Mesh"):
        serving.make_serving_flush(object(), "cpu")
    with pytest.raises(ValueError, match="got a tensor on"):
        fn.depth_variant(torch.zeros((4, 4), device="meta"),
                         torch.zeros(4, dtype=torch.int16), pct)
