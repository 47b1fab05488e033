"""Kernel B7 (segmented reduce) of veneur_tpu_torch against veneur_tpu.

On the CPU the port's `segment_sums` runs its plain version; the JAX
side runs its Pallas kernel in interpret mode (strict row order by
construction) and its XLA twin (`.at[seg].add`).  Tolerances:

  * plain B7 vs the Pallas kernel and vs the twin: BITWISE.  All three
    add each group's rows in row order from 0.0 in float32.
  * `coarsen_moments_vectors` vs the JAX package's: count, min and max
    exactly (the count is an integer sum in float32, the envelope is
    host f64), the rest within rtol = atol = 5e-4 (the bar of
    tests/test_cubes.py for the union sketch), because the JAX package
    pads the addable block to 128 lanes and both reduce it in float32;
    the sums of the real columns are in fact bitwise equal, which is
    asserted too.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from veneur_tpu.ops import segmented_reduce as jsr
from veneur_tpu.sketches import moments as jmo
from veneur_tpu_torch.ops import segmented_reduce as sr
from veneur_tpu_torch.sketches import moments as mo


def _seg_case(u, c, g, seed, adversarial=False, empty=()):
    """Seeded rows and sorted ids in [0, g) (the JAX tests' `_seg_case`;
    `adversarial` mixes magnitudes so any reassociation shows, `empty`
    lists group ids that get no rows)."""
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(u, c))
    if adversarial:
        vals = vals * 10.0 ** rng.integers(-3, 4, size=(u, c))
    pool = np.setdiff1d(np.arange(g), np.asarray(empty, np.int64))
    seg = np.sort(rng.choice(pool, size=u)).astype(np.int32)
    return vals.astype(np.float32), seg


def _port(vals, seg, g):
    return sr.segment_sums(torch.from_numpy(vals), torch.from_numpy(seg),
                           g).numpy()


def _g_pad(g):
    return max(8, (g + 7) // 8 * 8)


def _bits(x):
    return np.ascontiguousarray(x, np.float32).view(np.int32)


CASES = [(8, 128, 3), (64, 128, 9), (96, 256, 17), (1, 1, 1), (7, 1, 4),
         (50, 20, 60), (300, 20, 16), (200, 1, 1)]


@pytest.mark.parametrize("u,c,g", CASES)
def test_b7_plain_bitwise_pallas_interpret_and_twin(u, c, g):
    vals, seg = _seg_case(u, c, g, seed=u + c, adversarial=True)
    got = _port(vals, seg, g)
    interp = np.asarray(jsr._segment_sums_pallas(
        jnp.asarray(vals), jnp.asarray(seg), _g_pad(g),
        interpret=True))[:g]
    twin = np.asarray(jsr._segment_sums_twin(
        jnp.asarray(vals), jnp.asarray(seg), _g_pad(g)))[:g]
    assert got.shape == (g, c) and got.dtype == np.float32
    assert np.array_equal(_bits(got), _bits(interp))
    assert np.array_equal(_bits(got), _bits(twin))


def test_b7_plain_empty_groups_are_zero():
    vals, seg = _seg_case(40, 20, 12, seed=3, empty=(0, 5, 11))
    got = _port(vals, seg, 12)
    want = np.asarray(jsr._segment_sums_pallas(
        jnp.asarray(vals), jnp.asarray(seg), 16, interpret=True))[:12]
    assert np.array_equal(_bits(got), _bits(want))
    assert (got[[0, 5, 11]] == 0).all()
    assert not np.signbit(got[[0, 5, 11]]).any()


def test_b7_plain_bit_identical_across_jax_tilings(monkeypatch):
    """The tiling-invariance contract of tests/test_cubes.py on its
    adversarial values: every row tile of the TPU kernel gives the
    plain version's bits."""
    rng = np.random.default_rng(11)
    vals = (rng.normal(size=(64, 128))
            * 10.0 ** rng.integers(-3, 4, size=(64, 128))).astype(np.float32)
    seg = np.sort(rng.integers(0, 5, size=64)).astype(np.int32)
    got = _port(vals, seg, 5)
    for tile in (8, 16, 32, 64):
        monkeypatch.setattr(jsr, "_row_tile", lambda u, t=tile: t)
        want = np.asarray(jsr.segment_sums(
            jnp.asarray(vals), jnp.asarray(seg), 5, interpret=True))
        assert np.array_equal(_bits(got), _bits(want))


def test_b7_plain_is_row_order_not_another_order():
    """Sums whose float32 result depends on the order: the plain
    version gives the sequential row-order result, which differs from a
    pairwise or reversed sum."""
    vals = np.asarray([[1e8], [1.0], [-1e8], [1.0]], np.float32)
    seg = np.zeros(4, np.int32)
    got = _port(vals, seg, 1)[0, 0]
    acc = np.float32(0.0)
    for x in vals[:, 0]:
        acc = np.float32(acc + x)
    assert got == acc == np.float32(1.0)
    assert np.float32(np.float32(1e8 + 1.0) + np.float32(-1e8 + 1.0)) != got


@pytest.mark.parametrize("seg,g,match", [
    ([0, 2, 1, 3], 4, "sorted"), ([1, 0], 2, "sorted"),
    ([-1, 0], 2, "outside"), ([0, 4], 4, "outside")])
def test_b7_refuses_unsorted_or_out_of_range_ids(seg, g, match):
    vals = torch.ones((len(seg), 3))
    with pytest.raises(ValueError, match=match):
        sr.segment_sums(vals, torch.tensor(seg, dtype=torch.int32), g)


def test_b7_refuses_bad_shapes_and_types():
    with pytest.raises(ValueError, match="float32"):
        sr.segment_sums(torch.ones((2, 3), dtype=torch.float64),
                        torch.zeros(2, dtype=torch.int32), 1)
    with pytest.raises(ValueError, match="int32"):
        sr.segment_sums(torch.ones((2, 3)), torch.zeros(2), 1)
    with pytest.raises(ValueError, match=">= 1"):
        sr.segment_sums(torch.ones((2, 3)), torch.zeros(2,
                                                        dtype=torch.int32), 0)
    with pytest.raises(ValueError, match=r"\[U, C\]"):
        sr.segment_sums(torch.ones((3, 3)), torch.zeros(2,
                                                        dtype=torch.int32), 1)


def test_b7_cpu_runs_plain_and_counts_no_launch():
    sr.reset_launches()
    vals, seg = _seg_case(16, 4, 3, seed=1)
    _port(vals, seg, 3)
    assert sr.launches["segment_sums"] == 0


# ---------------------------------------------------------------------------
# coarsen_moments_vectors against the JAX package's
# ---------------------------------------------------------------------------

def _assert_coarsen_matches(vecs, hashes):
    uniq, out, g = sr.coarsen_moments_vectors(vecs, hashes, device="cpu")
    juniq, jout, jg = jsr.coarsen_moments_vectors(vecs, hashes)
    assert g == jg and np.array_equal(uniq, juniq)
    for idx in (mo.IDX_COUNT, mo.IDX_MIN, mo.IDX_MAX):
        assert np.array_equal(out[:, idx], jout[:, idx])
    np.testing.assert_allclose(out, jout, rtol=5e-4, atol=5e-4)
    # the 128-lane padding does not change a real column's sum
    fin = np.isfinite(jout)
    assert np.array_equal(out[fin], jout[fin])
    return uniq, out


def test_coarsen_matches_jax_on_the_union_case():
    """tests/test_cubes.py's union case: 2 coarse groups x 3 members."""
    rng = np.random.default_rng(5)
    k = mo.DEFAULT_K
    hashes, vecs, want = [], [], {}
    for gh in (np.uint64(7), np.uint64(9)):
        union = jmo.MomentsSketch(k)
        for j in range(3):
            s = jmo.MomentsSketch(k)
            s.add_batch(rng.gamma(2.0, 10.0 * (j + 1), 50))
            union.merge(s)
            vecs.append(s.vec)
            hashes.append(gh)
        want[int(gh)] = union.vec
    uniq, out = _assert_coarsen_matches(np.stack(vecs),
                                        np.asarray(hashes, np.uint64))
    assert list(uniq) == [7, 9]
    for i, gh in enumerate(uniq):
        np.testing.assert_allclose(out[i], want[int(gh)], rtol=5e-4,
                                   atol=5e-4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coarsen_matches_jax_on_random_groups(seed):
    """Random fine groups (some empty, some with samples at or below
    zero, so log domains collapse) under random coarse hashes."""
    rng = np.random.default_rng(seed)
    k = mo.DEFAULT_K
    n = int(rng.integers(5, 60))
    vecs = []
    for i in range(n):
        s = mo.MomentsSketch(k)
        if i % 7 != 3:
            x = rng.gamma(2.0, float(rng.uniform(1, 50)),
                          int(rng.integers(1, 80)))
            if i % 5 == 1:
                x = x - float(rng.uniform(0, 30))
            s.add_batch(x)
        vecs.append(s.vec)
    hashes = rng.choice(np.asarray([3, 11, 2 ** 63 + 5, 2 ** 64 - 1],
                                   np.uint64), size=n)
    _assert_coarsen_matches(np.stack(vecs), hashes)


# ---------------------------------------------------------------------------
# numpy models of B7's kernel (ops/csrc/segmented_reduce.cu)
# ---------------------------------------------------------------------------

_CSRC = (Path(__file__).resolve().parents[1] / "veneur_tpu_torch" / "ops"
         / "csrc" / "segmented_reduce.cu")


def _k_rows() -> int:
    """The kernel's load batch, kRows, read from its source."""
    return int(re.search(r"constexpr int kRows = (\d+);",
                         _CSRC.read_text()).group(1))


def _warp_bounds(seg, keys):
    """`bounds`' 32-way search, every lane of a round at once, for each
    key of `keys` (both ends of a group are two keys): lane i probes the
    last point of piece i of the interval [lo, hi] holding the first
    r with seg[r] >= key (every point when it holds 32 or fewer), and
    the ballot's count t drops the t pieces below key.  Returns the
    ends and each key's number of rounds of loads."""
    u = len(seg)
    lane = np.arange(32)[None, :]
    lo = np.zeros(len(keys), np.int64)
    hi = np.full(len(keys), u, np.int64)
    rounds = np.zeros(len(keys), np.int64)
    while (lo < hi).any():
        live = lo < hi
        n = (hi - lo)[:, None]
        short = n <= 32
        p = np.where(short, np.where(lane < n, lo[:, None] + lane, -1),
                     lo[:, None] + ((lane + 1) * n >> 5) - 1)
        below = (p >= 0) & (seg[np.clip(p, 0, u - 1)] < keys[:, None])
        t = below.sum(axis=1)
        n = n[:, 0]
        a = np.where(n <= 32, lo + t,
                     np.where(t == 32, hi, lo + (t * n >> 5)))
        b = np.where(n <= 32, lo + t,
                     np.where(t == 32, hi, lo + ((t + 1) * n >> 5) - 1))
        lo = np.where(live, a, lo)
        hi = np.where(live, b, hi)
        rounds += live
    return lo, rounds


@pytest.mark.parametrize("u", [1, 8, 100, 4096, 131072])
def test_b7_warp_search_finds_every_groups_rows(u):
    """The 32-way boundary search equals np.searchsorted on every group
    (empty groups and a single group holding every row included), in
    at most ceil(log32 U) + 1 rounds of loads (3 at U = 4096, 4 at
    U = 131072, where a binary search takes 12 and 17)."""
    rng = np.random.default_rng(u)
    most = 0
    for g in sorted({1, 16, 256, u}):
        pool = np.arange(g) if g < 16 else np.setdiff1d(
            np.arange(g), np.arange(3, g, 7))      # every 7th group empty
        cases = [np.sort(rng.choice(pool, size=u)),
                 np.full(u, g - 1), np.zeros(u, np.int64)]
        for seg in cases:
            seg = seg.astype(np.int32)
            keys = np.arange(g + 1)
            got, rounds = _warp_bounds(seg, keys)
            np.testing.assert_array_equal(
                got, np.searchsorted(seg, keys, side="left"))
            most = max(most, int(rounds.max()))
    assert most <= int(np.ceil(np.log(u) / np.log(32))) + 1
    if u >= 4096:
        assert most == {4096: 3, 131072: 4}[u]


def _row_loop(vals, seg, g, k_rows):
    """`Column::sum` in numpy: each group's rows in batches of k_rows,
    batch b + 1 loaded (copied) before batch b is added, the adds one
    float32 add a row in row order from 0.0."""
    lo = np.searchsorted(seg, np.arange(g + 1), side="left")
    out = np.zeros((g, vals.shape[1]), np.float32)
    for grp in range(g):
        rows = vals[lo[grp]:lo[grp + 1]]
        acc = np.zeros(vals.shape[1], np.float32)
        cur = rows[:k_rows].copy()
        for r in range(0, len(rows), k_rows):
            nxt = rows[r + k_rows:r + 2 * k_rows].copy()
            for k in range(min(k_rows, len(rows) - r)):
                acc = (acc + cur[k]).astype(np.float32)
            cur = nxt
        out[grp] = acc
    return out


@pytest.mark.parametrize("c", [1, 20, 129, 128])
def test_b7_loads_ahead_row_loop_is_bitwise_plain(c):
    """The batched row loop adds in the plain version's order: bitwise
    `segment_sums_plain` on adversarial magnitudes, with groups whose
    size is below, at, between and above multiples of the batch (and
    empty ones), at the kernel's kRows and at 8."""
    k = _k_rows()
    sizes = [k - 1, k, k + 1, 2 * k, 2 * k + 3, 0, 1, 3, 0, 5 * k + 7]
    seg = np.repeat(np.arange(len(sizes)), sizes).astype(np.int32)
    rng = np.random.default_rng(c)
    vals = (rng.normal(size=(len(seg), c))
            * 10.0 ** rng.integers(-3, 4, size=(len(seg), c))
            ).astype(np.float32)
    want = _port(vals, seg, len(sizes))
    for k_rows in (k, 8):
        np.testing.assert_array_equal(
            _bits(_row_loop(vals, seg, len(sizes), k_rows)), _bits(want))
