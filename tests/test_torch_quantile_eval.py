"""The port's t-digest quantiles of stored centroid rows (B9) held
against the JAX package on identical numpy-seeded digests.

On the CPU `veneur_tpu_torch.ops.quantile_eval.quantile` runs its plain
PyTorch version (`sketches/tdigest.py quantile`), the arithmetic the
CUDA kernel is held to on the card (`chip_smoke.py`).

Tolerances:
  * against the Pallas kernel in interpret mode and the XLA twin:
    rtol 1e-5 / atol 1e-4, as tests/test_ops.py holds the two JAX
    versions to each other.  The digests come from `td.ingest`, whose
    centroid weights are integers, so the prefix sums are exact; the
    Pallas kernel takes them as a triangular matmul and XLA may
    contract lo + prop * (up - lo) into a fused multiply-add, where
    PyTorch rounds the product on its own, which moves the last ulps.
  * empty rows: NaN on every side.
  * integer-valued centroids with integer weights: bitwise against a
    float32 numpy transcription of merging_digest.go:304-332 (numpy,
    like PyTorch and the kernel built with -fmad=false, rounds every
    add, product and quotient on its own; every prefix sum is exact),
    and within the first item's rtol 1e-5 / atol 1e-4 of the XLA twin,
    which contracts on the CPU.
  * a numpy model of the CUDA kernel's lane-segmented scan and count
    (`_b9_model`): bitwise the plain version on integer weights at every
    C tested (every prefix sum exact), and within the first item's
    tolerance of the Pallas kernel on gamma means.
  * sampled weights (integer counts over a rate of 0.1 .. 0.9): the
    prefix sums round, differently in each order; the model and the XLA
    twin each stay within `_prefix_bound` of the plain version, the
    largest quantile move that two orders' rounding of the prefix sums
    can make on that row.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from veneur_tpu.ops import quantile_eval as jqe
from veneur_tpu.sketches import tdigest as jtd
from veneur_tpu_torch.ops import quantile_eval as qe
from veneur_tpu_torch.sketches import tdigest as td

QS = np.asarray([0.0, 0.1, 0.5, 0.9, 0.99, 1.0], np.float32)


def _states(k, rng, sparse_every=3):
    """A JAX TDigestState of k rows: gamma samples ingested per row,
    every `sparse_every`-th row with a handful of samples only, the last
    row empty."""
    cap = jtd.centroid_capacity(100.0)
    state = jtd.empty(k, 100.0)
    for row in range(k - 1):
        n = (int(rng.integers(1, 6)) if row % sparse_every == 0
             else int(rng.integers(50, 2000)))
        vals = rng.gamma(2.0, 10.0, n).astype(np.float32)
        vv = np.zeros((k, n), np.float32)
        ww = np.zeros((k, n), np.float32)
        vv[row] = vals
        ww[row] = 1.0
        state = jtd.ingest(state, jnp.asarray(vv), jnp.asarray(ww), 100.0)
    assert state.mean.shape == (k, cap)
    return [np.asarray(x) for x in (state.mean, state.weight, state.min,
                                    state.max)]


def _port(mean, weight, dmin, dmax, qs=QS):
    return qe.quantile(*(torch.from_numpy(np.ascontiguousarray(a))
                         for a in (mean, weight, dmin, dmax, qs))).numpy()


@pytest.mark.parametrize("k", [1, 13, 40])
def test_quantile_plain_matches_pallas_and_xla(k):
    mean, weight, dmin, dmax = _states(k, np.random.default_rng(5 + k))
    got = _port(mean, weight, dmin, dmax)
    qs = jnp.asarray(QS)
    jstate = jtd.TDigestState(*(jnp.asarray(a) for a in
                                (mean, weight, dmin, dmax)),
                              rsum=jnp.zeros(k, jnp.float32))
    xla = np.asarray(jtd.quantile(jstate, qs))
    pallas = np.asarray(jqe.quantile(*(jnp.asarray(a) for a in
                                       (mean, weight, dmin, dmax)), qs,
                                     interpret=True))
    assert got.shape == xla.shape == pallas.shape == (k, len(QS))
    assert np.isnan(got[-1]).all() and np.isnan(xla[-1]).all() \
        and np.isnan(pallas[-1]).all()
    np.testing.assert_allclose(got[:-1], xla[:-1], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got[:-1], pallas[:-1], rtol=1e-5, atol=1e-4)


def _np_quantile(mean, weight, dmin, dmax, qs):
    """merging_digest.go:304-332 row by row in float32 numpy."""
    f = np.float32
    k, c = mean.shape
    out = np.full((k, len(qs)), np.nan, np.float32)
    for r in range(k):
        n = int((weight[r] > 0).sum())
        if n == 0:
            continue
        cum = np.cumsum(weight[r], dtype=np.float32)

        def upper(j):
            if j >= n - 1:
                return dmax[r]
            nxt = mean[r, j + 1] if j + 1 < c else mean[r, c - 1]
            return f(0.5) * (mean[r, j] + nxt)

        for p, q in enumerate(qs):
            target = f(q) * cum[-1]
            i = min(int((cum < target).sum()), max(n - 1, 0))
            lo = dmin[r] if i == 0 else upper(i - 1)
            before = f(0.0) if i == 0 else cum[i - 1]
            w_i = weight[r, i]
            prop = (target - before) / w_i if w_i > 0 else f(0.0)
            prop = min(max(prop, f(0.0)), f(1.0))
            out[r, p] = lo + prop * (upper(i) - lo)
    return out


def test_quantile_plain_bitwise_on_integer_centroids():
    """Integer means and weights, sorted rows with empty tails, one
    single-centroid row and one empty row."""
    rng = np.random.default_rng(17)
    k, c = 32, 152
    mean = np.zeros((k, c), np.float32)
    weight = np.zeros((k, c), np.float32)
    for row in range(k - 1):
        n = 1 if row == 0 else int(rng.integers(2, c + 1))
        mean[row, :n] = np.sort(rng.choice(1 << 12, n, replace=False))
        weight[row, :n] = rng.integers(1, 50, n)
    occ = weight > 0
    dmin = np.where(occ.any(1), np.where(occ, mean, np.inf).min(1) - 1,
                    np.inf).astype(np.float32)
    dmax = np.where(occ.any(1), np.where(occ, mean, -np.inf).max(1) + 1,
                    -np.inf).astype(np.float32)
    got = _port(mean, weight, dmin, dmax)
    jstate = jtd.TDigestState(*(jnp.asarray(a) for a in
                                (mean, weight, dmin, dmax)),
                              rsum=jnp.zeros(k, jnp.float32))
    xla = np.asarray(jtd.quantile(jstate, jnp.asarray(QS)))
    np.testing.assert_array_equal(got, _np_quantile(mean, weight, dmin,
                                                    dmax, QS))
    np.testing.assert_allclose(got, xla, rtol=1e-5, atol=1e-4)
    # a single centroid interpolates between min and max
    assert got[0, 0] == dmin[0] and got[0, -1] == dmax[0]


def test_bounds_match_the_jax_package():
    mean, weight, dmin, dmax = _states(9, np.random.default_rng(2))
    state = td.TDigestState(*(torch.from_numpy(a) for a in
                              (mean, weight, dmin, dmax)),
                            rsum=torch.zeros(9))
    jstate = jtd.TDigestState(*(jnp.asarray(a) for a in
                                (mean, weight, dmin, dmax)),
                              rsum=jnp.zeros(9, jnp.float32))
    for got, want in zip(td._bounds(state), jtd._bounds(jstate)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cpu_tensors_never_count_a_launch_and_bad_inputs_raise():
    qe.reset_launches()
    z = torch.zeros((2, 8))
    v = torch.zeros(2)
    qe.quantile(z, z, v, v, torch.tensor([0.5]))
    assert qe.launches == {"quantile": 0}
    with pytest.raises(ValueError, match="one \\[K, C\\] shape"):
        qe.quantile(z, torch.zeros((2, 4)), v, v, torch.tensor([0.5]))
    with pytest.raises(ValueError, match="min/max"):
        qe.quantile(z, z, torch.zeros(3), v, torch.tensor([0.5]))
    with pytest.raises(ValueError, match="unsupported device"):
        m = torch.zeros((2, 8), device="meta")
        qe.quantile(m, m, v.to("meta"), v.to("meta"),
                    torch.tensor([0.5], device="meta"))


# ---------------------------------------------------------------------------
# a numpy model of B9's kernel (ops/csrc/quantile_eval.cu): one scan a row
# over lane-owned runs of columns, then a count a quantile
# ---------------------------------------------------------------------------

def _b9_cum(weight):
    """The kernel's prefix sums in float32: lane l (of 32) owns the m =
    ceil(C / 32) | 1 columns [m*l, m*l + m) and sums them in order from
    0.0; a shuffle scan (x += x of lane - o for o = 1, 2, .., 16) of the
    32 lane totals gives lane l the total of the lanes before it; each
    column's prefix sum is that offset + the lane's running sum."""
    f = np.float32
    k, c = weight.shape
    m = ((c + 31) // 32) | 1
    tot = np.zeros((k, 32), f)
    local = np.zeros((k, c), f)
    for lane in range(32):
        run = np.zeros(k, f)
        for col in range(min(m * lane, c), min(m * lane + m, c)):
            run = run + weight[:, col]
            local[:, col] = run
        tot[:, lane] = run
    incl = tot.copy()
    for o in (1, 2, 4, 8, 16):
        prev = incl.copy()
        incl[:, o:] = prev[:, o:] + prev[:, :-o]
    offset = np.concatenate([np.zeros((k, 1), f), incl[:, :-1]], axis=1)
    owner = np.minimum(np.arange(c) // m, 31)
    return offset[:, owner] + local


def _b9_model(mean, weight, dmin, dmax, qs):
    """B9 as the kernel computes it: _b9_cum's prefix sums, then for
    each quantile the count of columns below q * total (total = the
    last column's prefix sum) and merging_digest.go's interpolation."""
    f = np.float32
    k, c = mean.shape
    cum = _b9_cum(weight)
    out = np.full((k, len(qs)), np.nan, f)
    for r in range(k):
        n = int((weight[r] > 0).sum())
        if n == 0:
            continue

        def upper(j):
            if j >= n - 1:
                return dmax[r]
            nxt = mean[r, j + 1] if j + 1 < c else mean[r, c - 1]
            return f(0.5) * (mean[r, j] + nxt)

        for p, q in enumerate(qs):
            target = f(q) * cum[r, -1]
            i = min(int((cum[r] < target).sum()), max(n - 1, 0))
            lo = dmin[r] if i == 0 else upper(i - 1)
            before = f(0.0) if i == 0 else cum[r, i - 1]
            w_i = weight[r, i]
            prop = (target - before) / w_i if w_i > 0 else f(0.0)
            prop = min(max(prop, f(0.0)), f(1.0))
            out[r, p] = lo + prop * (upper(i) - lo)
    return out


def _integer_rows(rng, k, c):
    """Sorted distinct integer means with integer weights 1..50: row 0
    empty, row 1 one centroid, row 2 full, the rest 0..C centroids."""
    mean = np.zeros((k, c), np.float32)
    weight = np.zeros((k, c), np.float32)
    for row in range(1, k):
        n = {1: 1, 2: c}.get(row, int(rng.integers(0, c + 1)))
        mean[row, :n] = np.sort(rng.choice(4 * c + 8, n, replace=False))
        weight[row, :n] = rng.integers(1, 51, n)
    occ = weight > 0
    dmin = np.where(occ.any(1), np.where(occ, mean, np.inf).min(1) - 0.5,
                    np.inf).astype(np.float32)
    dmax = np.where(occ.any(1), np.where(occ, mean, -np.inf).max(1) + 0.5,
                    -np.inf).astype(np.float32)
    return mean, weight, dmin, dmax


def _same_bits(a, b):
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_array_equal(np.where(np.isnan(a), 0, a).view(np.int32),
                                  np.where(np.isnan(b), 0, b).view(np.int32))


@pytest.mark.parametrize("c", [1, 3, 31, 32, 33, 152, 1024])
def test_b9_lane_scan_is_bitwise_on_integer_weights(c):
    """Every prefix sum is exact, so the kernel's association gives the
    plain version's bits, C below, at and above a lane's worth of
    columns and at the default compression's 152."""
    mean, weight, dmin, dmax = _integer_rows(np.random.default_rng(c), 12,
                                             c)
    np.testing.assert_array_equal(_b9_cum(weight),
                                  np.cumsum(weight, axis=1,
                                            dtype=np.float32))
    _same_bits(_b9_model(mean, weight, dmin, dmax, QS),
               _port(mean, weight, dmin, dmax))


def test_b9_lane_scan_matches_pallas_interpret_on_gamma_means():
    mean, weight, dmin, dmax = _states(24, np.random.default_rng(11))
    got = _b9_model(mean, weight, dmin, dmax, QS)
    pallas = np.asarray(jqe.quantile(*(jnp.asarray(a) for a in
                                       (mean, weight, dmin, dmax)),
                                     jnp.asarray(QS), interpret=True))
    assert np.isnan(got[-1]).all() and np.isnan(pallas[-1]).all()
    np.testing.assert_allclose(got[:-1], pallas[:-1], rtol=1e-5, atol=1e-4)


def _sampled_rows(rng, k, c):
    """_integer_rows' occupancy with gamma(2, 10) means (sorted) and the
    weights a sampled DogStatsD line stages, an integer count 1..50 over
    a rate of 0.1, 0.3, 0.7 or 0.9: the prefix sums round."""
    _, count, _, _ = _integer_rows(rng, k, c)
    occ = count > 0
    rate = rng.choice(np.asarray([0.1, 0.3, 0.7, 0.9], np.float32), (k, c))
    mean = np.sort(np.where(occ, rng.gamma(2.0, 10.0, (k, c)), np.inf), 1)
    mean = np.where(occ, mean, 0).astype(np.float32)
    weight = np.where(occ, count / rate, 0).astype(np.float32)
    dmin = np.where(occ.any(1), np.where(occ, mean, np.inf).min(1) - 0.5,
                    np.inf).astype(np.float32)
    dmax = np.where(occ.any(1), np.where(occ, mean, -np.inf).max(1) + 0.5,
                    -np.inf).astype(np.float32)
    return mean, weight, dmin, dmax


def _prefix_bound(mean, weight, dmin, dmax):
    """Per row, the largest quantile difference two association orders
    of the prefix sums can make.  Each order's prefix sum is within
    (adds) * 2^-24 * W of the exact one, W the row's total: C adds for
    the plain version's cumsum, m + 6 for the kernel's (m in the lane,
    5 scan steps, the offset), so the two differ by at most delta =
    (C + m + 6) 2^-24 W.  A quantile's target and the prefix sum before
    its centroid each move by delta, so its proportion moves by 2 delta
    / w_i and the output by 2 delta span_i / w_i (span_i = upper(i) -
    lo(i)); where the two orders pick neighbouring centroids the output
    moves by at most the sum for both.  Plus 2 ulp of the row's range
    for the interpolation's own rounding."""
    k, c = mean.shape
    m = ((c + 31) // 32) | 1
    out = np.zeros(k)
    for r in range(k):
        n = int((weight[r] > 0).sum())
        if n == 0:
            continue
        mid = 0.5 * (mean[r, :n - 1].astype(np.float64) + mean[r, 1:n])
        up = np.append(mid, dmax[r])
        lo = np.insert(mid, 0, dmin[r])
        delta = (c + m + 6) * 2.0 ** -24 * weight[r].astype(np.float64).sum()
        out[r] = (4 * delta * ((up - lo) / weight[r, :n]).max()
                  + 2 * np.spacing(np.float32(max(abs(dmin[r]),
                                                  abs(dmax[r])))))
    return out


@pytest.mark.parametrize("c", [33, 152])
def test_b9_lane_scan_on_sampled_weights_within_the_prefix_bound(c):
    """On weights count / rate the kernel's order (`_b9_model`), the
    plain version's cumsum and the JAX package's XLA twin round the
    prefix sums differently: the model and the twin each agree with the
    plain version within `_prefix_bound` (ROADMAP C13)."""
    mean, weight, dmin, dmax = _sampled_rows(np.random.default_rng(c),
                                             100, c)
    qs = np.linspace(0.0, 1.0, 21).astype(np.float32)
    plain = _port(mean, weight, dmin, dmax, qs)
    model = _b9_model(mean, weight, dmin, dmax, qs)
    jstate = jtd.TDigestState(*(jnp.asarray(a) for a in
                                (mean, weight, dmin, dmax)),
                              rsum=jnp.zeros(len(mean), jnp.float32))
    xla = np.asarray(jtd.quantile(jstate, jnp.asarray(qs)))
    bound = _prefix_bound(mean, weight, dmin, dmax)[:, None]
    empty = ~(weight > 0).any(1)
    for got in (model, xla):
        assert np.isnan(got[empty]).all() and not np.isnan(got[~empty]).any()
        assert (np.abs(got - plain)[~empty] <= bound[~empty]).all()
