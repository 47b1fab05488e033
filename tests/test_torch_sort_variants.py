"""The compare-exchange formulations (H3, `ops/sort_variants.py`) held
against the JAX package's harness kernels (`scripts/sort_variants.py`
`make_kernel(mode)`), run through `pl.pallas_call(..., interpret=True)`
with `run`'s grid and specs on the transposed `[D, U]` operands.

Tolerance: bitwise, on the harness's kind of input (bf16-exact values,
here integers below 256, weights 1): the sorted keys are unique up to
ties of equal weight, and every sum is exact below 2^24 in any order.
Every port mode is also bitwise v0's on the script's own gamma input,
since all of them emit through the same fixed tree order; numpy models
of the kernels' emits, lane by lane, are bitwise that tree.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from scripts import sort_variants as jsv
from veneur_tpu.ops import sorted_eval as jse
from veneur_tpu_torch.ops import sort_variants as sv
from veneur_tpu_torch.ops import sorted_eval as se
from veneur_tpu_torch.scripts import sort_variants as script

MODES = ["v0", "v1", "v2", "v3", "v5", "v6", "c0", "c1"]


@functools.lru_cache(maxsize=None)
def _jax_run(mode, d, u):
    tile = jse._lane_tile(u, d)
    return jax.jit(lambda mt, wt: pl.pallas_call(
        jsv.make_kernel(mode), grid=(u // tile,),
        in_specs=[pl.BlockSpec((d, tile), lambda i: (0, i)),
                  pl.BlockSpec((d, tile), lambda i: (0, i))],
        out_specs=pl.BlockSpec((3, tile), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((3, u), jnp.float32),
        interpret=True)(mt, wt))


def _integer_rows(u, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (u, d)).astype(np.float32),
            np.ones((u, d), np.float32))


@pytest.mark.parametrize("mode,d", [(m, d) for d in (8, 64, 256)
                                    for m in MODES
                                    if not (m == "c0" and d > 64)])
def test_plain_bitwise_the_jax_kernel(mode, d):
    """c0 at D <= 64 only, as the JAX script runs it."""
    u = 256
    vals, wts = _integer_rows(u, d)
    want = np.asarray(_jax_run(mode, d, u)(vals.T.copy(), wts.T.copy())).T
    got = sv.sort_variant_plain(torch.from_numpy(vals),
                                torch.from_numpy(wts), mode).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("d", [2, 8, 64, 256, 1024])
def test_every_mode_bitwise_v0_on_the_script_input(d):
    mean, weight = script.inputs(300, d, torch.device("cpu"))
    ref = sv.sort_variant(mean, weight, "v0")
    for mode in MODES:
        if mode == "c0" and d > 64:
            continue
        out = sv.sort_variant(mean, weight, mode)
        assert torch.equal(out.view(torch.int32), ref.view(torch.int32)), mode


def test_modes_refuse_and_cpu_counts_no_launch():
    mean, weight = script.inputs(16, 128, torch.device("cpu"))
    sv.reset_launches()
    sv.sort_variant(mean, weight, "v3")
    assert sv.launches["sort_variant"] == 0
    with pytest.raises(ValueError, match="unknown sort variant"):
        sv.sort_variant(mean, weight, "v4")
    with pytest.raises(ValueError, match="D <= 64"):
        sv.sort_variant(mean, weight, "c0")
    assert set(sv.MODES) == set(jsv.STAGES) | set(jsv.COMPACT_MODES)


# ---------------------------------------------------------------------------
# numpy models of the kernels' emit (ops/csrc/sort_variants.cu): each
# lane's share of row_sums' tree, in the lane and by shuffles
# ---------------------------------------------------------------------------

def _shuffle_steps(v, steps):
    """`x += __shfl_down_sync(x, s)` for each s of `steps` over the lanes
    (last axis), a lane past the warp reading its own value."""
    for s in steps:
        nxt = v.copy()
        nxt[..., :-s] = v[..., :-s] + v[..., s:]
        v = nxt
    return v


def _emit_shared(x):
    """v0, v1, c1 (`row_sums`): D >= 32, lane l owns columns l + 32 r and
    runs the steps s >= 32 in place, then shuffles 16 .. 1; D < 32, a
    lane a column, every step a shuffle."""
    u, d = x.shape
    if d < 32:
        return _shuffle_steps(x, [d >> i for i in range(1, d.bit_length())
                                  ])[:, 0]
    y = x.reshape(u, d // 32, 32)                # [row, r, lane]
    h = d // 64
    while h >= 1:
        y = np.concatenate([y[:, :h] + y[:, h:2 * h], y[:, h:]], axis=1)
        h //= 2
    return _shuffle_steps(y[:, 0], [16, 8, 4, 2, 1])[:, 0]


def _emit_registers(x, e):
    """v3 (E = min(D, 16)) and c0 (E = 2): lane l holds columns l E ..
    l E + E - 1; where a row spans more than a warp (D > 32 E) the steps
    s >= 32 E add across warps first; then `warp_tree_sum`: the steps
    s >= E by shuffles of s / E lanes, the rest inside the lane."""
    u, d = x.shape
    y = x.reshape(u, d // e, e)                  # [row, lane, r]
    s = d // 2
    while s >= 32 * e:
        y = np.concatenate([y[:, :s // e] + y[:, s // e:2 * s // e],
                            y[:, s // e:]], axis=1)
        s //= 2
    w = min(d, 32 * e)
    lanes = np.moveaxis(y[:, :w // e], 2, 1)     # [row, r, lane]
    lanes = _shuffle_steps(lanes, [t // e for t in
                                   (w >> i for i in range(1, 6))
                                   if t >= e])
    z = lanes[:, :, 0]
    t = e // 2
    while t >= 1:
        z = np.concatenate([z[:, :t] + z[:, t:2 * t], z[:, t:]], axis=1)
        t //= 2
    return z[:, 0]


def test_emit_orders_are_row_sums_tree():
    """Every kernel's emit, lane by lane, is bitwise `tree_row_sums` on
    float products at every D (the shuffles and in-lane steps are the
    tree's own steps in another layout)."""
    rng = np.random.default_rng(17)
    for d in [1 << i for i in range(1, 11)]:
        x = (rng.gamma(2.0, 10.0, (6, d)) * rng.integers(1, 4, (6, d))
             ).astype(np.float32)
        want = se.tree_row_sums(torch.from_numpy(x)).numpy()
        got = [_emit_shared(x), _emit_registers(x, min(d, 16))]
        if d <= 64:
            got.append(_emit_registers(x, 2))
        for g in got:
            np.testing.assert_array_equal(g.view(np.int32),
                                          want.view(np.int32))
