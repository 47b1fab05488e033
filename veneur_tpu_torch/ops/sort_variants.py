"""Formulations of the bitonic compare-exchange stage (H3).

`sort_variant(mean, weight, mode)` is the port's counterpart of
`scripts/sort_variants.py`'s `run(mode, ...)`: it sorts every row of
`[U, D]` float32 values (keyed +inf where the weight is not positive)
with its weights by the formulation `mode` and returns `[U, 3]`
float32: key[0], key[D/2] and the sum over the row of
key * (key != +inf ? w : 0).  The TPU harness takes and returns the
transposed `[D, U]` / `[3, U]` layouts; the port keeps its row-major
`[U, D]` / `[U, ·]` layout, as its B1 does.

The TPU's formulations differ in how a stage finds its partner (roll,
flip or concatenated slices) and in the shape of its masks, which mean
nothing on Hopper.  Each mode runs the Hopper formulation that carries
its idea (`ops/csrc/sort_variants.cu`):

  v0          the paired network in shared memory (B1's formulation
              before its packed-word network): one barrier a stage, a
              conditional swap moving a key and a weight;
  v1, v2      the min/max + moved-mask stage (`_cmp_exchange` of
              `veneur_tpu/ops/sorted_eval.py`), branch-free, in shared
              memory; v2 (the `[D, 1]` masks) is the same on this card;
  v3, v5, v6  the partner by xor: points in registers, one a thread,
              strides below 32 exchanged by warp shuffles with no
              barrier, only the wider ones through shared memory; the
              three partner formulations are one on this card;
  c0          B4's packed bf16-key|column word network, D <= 64;
  c1          B3's key-only network on the keys rounded to bf16.

c0 and c1 round the values to bf16 at load; on the harness's
bf16-exact input every mode gives v0's bits (the sum runs in the same
fixed tree order everywhere, `sorted_eval.tree_row_sums`).

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor it runs `sort_variant_plain`.  `launches["sort_variant"]`
counts kernel launches.
"""

from __future__ import annotations

import torch

from veneur_tpu_torch.ops import sorted_eval as se

# mode -> the formulation code of vn_sort_variant
MODES = {"v0": 0, "v1": 1, "v2": 1, "v3": 2, "v5": 2, "v6": 2,
         "c0": 3, "c1": 4}
COMPACT_MODES = ("c0", "c1")

launches = {"sort_variant": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _check_mode(mode: str, d: int) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown sort variant {mode!r} "
                         f"({' | '.join(MODES)})")
    if mode == "c0" and d > se.MAX_COMPACT_DEPTH:
        raise ValueError(f"sort variant c0 needs D <= "
                         f"{se.MAX_COMPACT_DEPTH} (got {d})")


def sort_variant_plain(mean: torch.Tensor, weight: torch.Tensor,
                       mode: str) -> torch.Tensor:
    """The plain version of every mode: `torch.sort` of the keys with
    the weights gathered (c1 emits the weights in column order, as its
    kernel does), the emit's sum by `tree_row_sums`.  c0 and c1 round
    the values to bf16 first."""
    _check_mode(mode, mean.shape[1])
    if mode in COMPACT_MODES:
        mean = mean.to(torch.bfloat16).to(torch.float32)
    key, w = se._sorted_pairs(mean, weight)
    if mode == "c1":
        w = weight
    d = key.shape[1]
    inf = float("inf")
    s = se.tree_row_sums(key * torch.where(key != inf, w,
                                           torch.zeros_like(w)))
    return torch.stack([key[:, 0], key[:, d // 2], s], dim=1)


def sort_variant(mean: torch.Tensor, weight: torch.Tensor,
                 mode: str) -> torch.Tensor:
    """H3: `[U, D]` f32 values and weights, sorted by the formulation
    `mode` -> `[U, 3]` f32.  D a power of two in [2, 1024] (c0: at most
    64), both contiguous on one device."""
    _check_mode(mode, mean.shape[1])
    if not se._on_cuda("sort_variant", mean, weight):
        return sort_variant_plain(mean, weight, mode)
    u, d = se._check_slice_inputs("sort_variant", mean, weight)
    out = torch.empty((u, 3), dtype=torch.float32, device=mean.device)
    if u == 0:
        return out
    from veneur_tpu_torch.ops import _build
    se.launch("sort_variant", mean.device,
              _build.load("sort_variants").vn_sort_variant,
              mean.data_ptr(), weight.data_ptr(), out.data_ptr(), u, d,
              MODES[mode])
    launches["sort_variant"] += 1
    return out
