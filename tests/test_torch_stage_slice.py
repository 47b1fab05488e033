"""The profiling cuts of B1 (H1 `stage_slice`, H2 `stage_slice_wide`)
held against the JAX package's `stage_slice_kernel`.

The JAX kernel runs through `pl.pallas_call(..., interpret=True)` with
`bench.py:560`'s grid and specs (`[tile, D]` blocks in, a `[1, tile]`
row out); the port's plain version takes the same numpy-seeded rows.

Tolerances:
  * integer rows whose sums stay below 2^24: bitwise (every sum exact
    in any order);
  * gamma float values: rtol 1e-6 for the read and sort cuts (the JAX
    kernel's `jnp.sum` and the port's pairwise tree add in different
    orders); the cumsum cut sums integer weights, so it stays bitwise;
  * a row with a hole (weight 0) is NaN in the read and sort cuts
    (+inf * 0) on both sides, in the same places.
H2 has no JAX body to hold it to (ROADMAP C7): its plain version is
checked against its stated definition, and its bytes against B1's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from veneur_tpu.ops import sorted_eval as jse
from veneur_tpu_torch.ops import sorted_eval as se
from veneur_tpu_torch.scripts import profile_flush_kernel as pfk

CUTS = ("read", "sort", "cumsum")


@functools.lru_cache(maxsize=None)
def _jax_slice(mode, u, d):
    tile = jse._lane_tile(u, d)
    return jax.jit(lambda m, w: pl.pallas_call(
        jse.stage_slice_kernel(mode), grid=(u // tile,),
        in_specs=[pl.BlockSpec((tile, d), lambda i: (i, 0)),
                  pl.BlockSpec((tile, d), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((1, tile), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((1, u), jnp.float32),
        interpret=True)(m, w)[0])


def _rows(u, d, seed, integer, holes):
    rng = np.random.default_rng(seed)
    if integer:
        vals = rng.integers(0, 100, (u, d)).astype(np.float32)
    else:
        vals = rng.gamma(2.0, 10.0, (u, d)).astype(np.float32)
    wts = rng.integers(1, 4, (u, d)).astype(np.float32)
    if holes:
        # every 7th row gets holes (weight 0) in a random third of it
        rows = np.arange(0, u, 7)
        wts[rows] *= rng.random((len(rows), d)) > 0.33
    return vals, wts


def _both(mode, vals, wts):
    u, d = vals.shape
    want = np.asarray(_jax_slice(mode, u, d)(vals, wts))
    got = se.stage_slice_plain(torch.from_numpy(vals),
                               torch.from_numpy(wts), mode).numpy()
    return got, want


@pytest.mark.parametrize("mode", CUTS)
@pytest.mark.parametrize("u", [128, 256])
@pytest.mark.parametrize("d", [2, 8, 64, 256])
def test_h1_plain_bitwise_on_integer_rows(mode, u, d):
    got, want = _both(mode, *_rows(u, d, 1, True, False))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", CUTS)
@pytest.mark.parametrize("u,d", [(128, 8), (256, 64), (256, 256)])
def test_h1_plain_on_gamma_rows(mode, u, d):
    got, want = _both(mode, *_rows(u, d, 2, False, False))
    if mode == "cumsum":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("mode", CUTS)
@pytest.mark.parametrize("d", [2, 64])
def test_h1_plain_holes_nan_in_the_same_places(mode, d):
    vals, wts = _rows(256, d, 3, True, True)
    got, want = _both(mode, vals, wts)
    assert np.isnan(want).any() == (mode != "cumsum")
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("integer", [True, False])
def test_h1_plain_sort_cut_is_the_stable_order(integer):
    """The sort cut sums key * w over rows sorted as B1 sorts them:
    stably, tied keys in column order, each keeping its own weight.  On
    rows of tied runs with unequal weights (integer, or gamma floats
    drawn with replacement) it is the fixed pairwise tree over numpy's
    stable sort, bit for bit."""
    rng = np.random.default_rng(77)
    u, d = 64, 32
    if integer:
        vals = rng.integers(-3, 4, (u, d)).astype(np.float32)
    else:
        pool = rng.gamma(2.0, 10.0, (u, d)).astype(np.float32)
        vals = np.take_along_axis(pool, rng.integers(0, d, (u, d)), axis=1)
    wts = rng.integers(1, 4, (u, d)).astype(np.float32)
    order = np.argsort(vals, axis=1, kind="stable")
    prod = (np.take_along_axis(vals, order, axis=1)
            * np.take_along_axis(wts, order, axis=1))
    want = se.tree_row_sums(torch.from_numpy(prod)).numpy()
    got = se.stage_slice_plain(torch.from_numpy(vals), torch.from_numpy(wts),
                               "sort").numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert (np.diff(np.sort(vals, axis=1), axis=1) == 0).any()


def _wide_args(u=128, d=16, n_pct=3):
    vals, wts = _rows(u, d, 4, False, True)
    t = [torch.from_numpy(x) for x in (vals, wts)]
    lo, hi = t[0].amin(1), t[0].amax(1)
    pct = torch.tensor([0.5, 0.9, 0.99][:n_pct])
    return t[0], t[1], lo, hi, pct


@pytest.mark.parametrize("mode,cut", [("dma", "read"), ("sort", "sort")])
def test_h2_plain_is_its_stated_definition(mode, cut):
    m, w, lo, hi, pct = _wide_args()
    out = se.stage_slice_wide_plain(m, w, lo, hi, pct, mode)
    s = se.stage_slice_plain(m, w, cut)
    assert out.shape == (m.shape[0], pct.shape[0] + 2)
    for p in range(pct.shape[0]):
        torch.testing.assert_close(out[:, p], s * pct[p], rtol=0, atol=0,
                                   equal_nan=True)
    assert torch.equal(out[:, -2], lo) and torch.equal(out[:, -1], hi)
    assert torch.equal(se.stage_slice_wide(m, w, lo, hi, pct, mode)
                       .nan_to_num(7.0), out.nan_to_num(7.0))


def test_h2_moves_b1s_bytes():
    """H2 reads every operand B1 reads and writes B1's output shape, so
    `full - sort` in the in-loop script is the tail's own cost."""
    args = _wide_args(64, 32)
    b1 = se.weighted_eval(*args)
    h2 = se.stage_slice_wide(*args, "sort")
    nin = sum(t.numel() * t.element_size() for t in args)
    assert (nin + h2.numel() * h2.element_size()
            == nin + b1.numel() * b1.element_size())
    assert h2.shape == b1.shape and h2.dtype == b1.dtype
    k, d = args[0].shape
    assert pfk.mode_bytes("dma", k, d) == pfk.mode_bytes("full", k, d) \
        == args[0].nbytes + args[1].nbytes


def test_unknown_modes_raise_and_cpu_counts_no_launch():
    m, w, lo, hi, pct = _wide_args(8, 4)
    se.reset_launches()
    for mode in CUTS:
        se.stage_slice(m, w, mode)
    for mode in ("dma", "sort"):
        se.stage_slice_wide(m, w, lo, hi, pct, mode)
    assert se.launches["stage_slice"] == 0
    assert se.launches["stage_slice_wide"] == 0
    with pytest.raises(ValueError, match="unknown stage slice"):
        se.stage_slice(m, w, "full")
    with pytest.raises(ValueError, match="unknown stage slice"):
        se.stage_slice_plain(m, w, "dma")
    with pytest.raises(ValueError, match="unknown stage slice"):
        se.stage_slice_wide(m, w, lo, hi, pct, "cumsum")
    with pytest.raises(ValueError, match="unknown stage slice"):
        jse.stage_slice_kernel("dma")


def test_tree_row_sums_is_the_kernel_order():
    """The plain versions' row sum is the kernels' pairwise tree: at
    each step the first half of the columns adds the second."""
    x = torch.tensor([[1e8, 1.0, -1e8, 1.0]])
    # tree: (1e8 + -1e8) + (1 + 1) = 2; left to right would give 1
    assert se.tree_row_sums(x).item() == 2.0
    rng = np.random.default_rng(5)
    y = torch.from_numpy(rng.gamma(2.0, 10.0, (16, 32)).astype(np.float32))
    ref = y.clone()
    s = 16
    while s:
        ref[:, :s] = ref[:, :s] + ref[:, s:2 * s]
        s //= 2
    assert torch.equal(se.tree_row_sums(y), ref[:, 0])
