"""Compactor-family flush: the wrapper of kernel B6 and the ladder read-off.

Counterpart of `veneur_tpu.ops.compactor_eval` (the `:N` marks are its
line numbers):

  compact  `compact_batch` runs one bottom-up compaction pass for every
           staged key in one launch of B6 (`ops/csrc/compactor_eval.cu`):
           `[U, levels, 2*cap]` level staging, occupancies and the
           host-planned coin offsets in, the compacted `[U, levels, cap]`
           state out.  The count dynamics (which levels compact, every
           coin) are planned on the host by `compactor.plan_pass`; the
           device replays only the value movement, a warp per key: per
           level it sorts only the staged keys (the shared warp network
           of `csrc/sort_network.cuh`) and merges the already sorted
           carry by rank, then selects by index.  On a CPU tensor it
           runs `compact_batch_plain`, step for step the JAX package's
           twin (`_compact_twin`, :171).
  eval     `make_compactor_flush` reads quantiles off compacted states
           (:196-248): implied `2**level` item weights from the
           occupancies, then the flush's evaluation core
           (`tdigest.weighted_eval`).  States are `levels*cap` deep
           (1792 at the defaults, past the sort network's MAX_DEPTH), so
           the JAX package runs this read-off outside any Pallas kernel,
           and here it is plain PyTorch.

Order of signed zeros: every sort here is under the IEEE total order
(-0 below +0), in the kernel and in its plain version alike, so the two
agree bitwise on every input.  The JAX package's sorts leave -0 and +0
in no fixed order; on rows without both they all agree bitwise.

`launches` counts B6 launches, so a run can show that its folds went
through the kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from veneur_tpu_torch import resolve_device
from veneur_tpu_torch.ops.sorted_eval import launch
from veneur_tpu_torch.sketches import compactor as cs
from veneur_tpu_torch.sketches import tdigest as td

launches = {"compact_batch": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------------
# Plain version (the CPU path, and the yardstick the kernel is held to)
# ---------------------------------------------------------------------------

def _flip(k: torch.Tensor) -> torch.Tensor:
    """float32 bits as int32 <-> keys whose signed order is the IEEE
    total order (an involution: negative values flip their magnitude
    bits)."""
    return k ^ ((k >> 31) & 0x7FFFFFFF)


def sort_total(x: torch.Tensor) -> torch.Tensor:
    """Values-only ascending sort of float32 rows (last axis) under the
    IEEE total order: -0 sorts below +0, so equal keys are equal bits
    and the result does not depend on the sort's stability."""
    keys = torch.sort(_flip(x.contiguous().view(torch.int32)), dim=-1).values
    return _flip(keys).view(torch.float32)


def compact_batch_plain(stage_v: torch.Tensor, stage_n: torch.Tensor,
                        off: torch.Tensor) -> torch.Tensor:
    """B6's plain version: the twin's pass body (`_pass_tile`) on the
    key-major layout, with `sort_total` for the values-only sort.  As
    the kernel does, it reads only each level's occupied prefix (the
    contract's +inf padding beyond it) and the low bit of each coin
    offset."""
    u, levels, s2 = stage_v.shape
    cap = s2 // cs.STAGE_MUL
    keep = cs.keep_of(cap)
    dev = stage_v.device
    pad = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    idx = torch.arange(cs.BUF_MUL * cap, device=dev)[None, :]
    n = stage_n.to(torch.int64).clamp(0, s2)
    off = off.to(torch.int64) & 1
    stage = torch.where(torch.arange(s2, device=dev)[None, None, :]
                        < n[:, :, None], stage_v.to(torch.float32), pad)
    carry = pad.expand(u, s2)
    carry_n = torch.zeros((u, 1), dtype=torch.int64, device=dev)
    out = []
    for lvl in range(levels):
        buf = sort_total(torch.cat([stage[:, lvl], carry], dim=1))
        occ = n[:, lvl:lvl + 1] + carry_n
        if lvl < levels - 1:
            do = occ > cap
            sec = occ - keep
            m = torch.where(do, sec - (sec & 1), 0)
            o = off[:, lvl:lvl + 1]
            surv = do & (idx < m) & ((idx & 1) == o)
            retain = torch.where(do, (idx >= m) & (idx < occ), idx < occ)
            carry = sort_total(torch.where(surv, buf, pad))[:, :s2]
            carry_n = m // 2
            out.append(sort_total(torch.where(retain, buf, pad))[:, :cap])
        else:
            top = occ
            for r in range(cs.CLIP_ROUNDS):
                do = top > cap
                m = torch.where(do, top - (top & 1), 0)
                o = off[:, levels + r:levels + r + 1]
                surv = (idx < m) & ((idx & 1) == o)
                keepm = torch.where(do, surv | ((idx >= m) & (idx < top)),
                                    idx < top)
                buf = sort_total(torch.where(keepm, buf, pad))
                top = top - m // 2
            out.append(buf[:, :cap])
    return torch.stack(out, dim=1)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

def _check(stage_v, stage_n, off) -> tuple[int, int, int]:
    if stage_v.dim() != 3:
        raise ValueError(f"compact_batch: stage_v must be [U, levels, "
                         f"2*cap], got {tuple(stage_v.shape)}")
    u, levels, s2 = stage_v.shape
    cap = s2 // cs.STAGE_MUL
    if s2 != cs.STAGE_MUL * cap or cap < 8 or cap > 256 or cap & (cap - 1):
        raise ValueError(f"compact_batch: stage width {s2} must be 2*cap "
                         "with cap a power of two in [8, 256]")
    if not 2 <= levels <= 32:
        raise ValueError(f"compact_batch: levels {levels} not in [2, 32]")
    for t, dtype, shape in ((stage_v, torch.float32, (u, levels, s2)),
                            (stage_n, torch.int32, (u, levels)),
                            (off, torch.int32,
                             (u, levels + cs.CLIP_ROUNDS))):
        if t.dtype != dtype:
            raise ValueError(f"compact_batch: expected {dtype}, got "
                             f"{t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"compact_batch: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("compact_batch: inputs must be contiguous")
    return u, levels, cap


def compact_batch(stage_v: torch.Tensor, stage_n: torch.Tensor,
                  off: torch.Tensor) -> torch.Tensor:
    """B6: one compaction pass over `stage_v [U, levels, 2*cap]` f32
    (each level's items in an occupied prefix, +inf beyond `stage_n
    [U, levels]` i32) with the coin offsets `off [U, levels +
    CLIP_ROUNDS]` i32 of `compactor.plan_pass` -> the compacted state
    `[U, levels, cap]` f32, +inf beyond each level's new occupancy (the
    planner's `cnt_out`).  cap a power of two in [8, 256], levels in
    [2, 32], any U; all on one device and contiguous.  A CPU tensor
    runs the plain version; a CUDA tensor launches B6 or raises."""
    devs = {t.device for t in (stage_v, stage_n, off)}
    if len(devs) != 1:
        raise ValueError(f"compact_batch: inputs on several devices {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return compact_batch_plain(stage_v, stage_n, off)
    if dev.type != "cuda":
        raise ValueError(f"compact_batch: unsupported device {dev}")
    u, levels, cap = _check(stage_v, stage_n, off)
    out = torch.empty((u, levels, cap), dtype=torch.float32, device=dev)
    if u == 0:
        return out
    from veneur_tpu_torch.ops import _build
    lib = _build.load("compactor_eval")
    launch("compact_batch", dev, lib.vn_compact_batch, stage_v.data_ptr(),
           stage_n.data_ptr(), off.data_ptr(), out.data_ptr(), u, levels,
           cap)
    launches["compact_batch"] += 1
    return out


# ---------------------------------------------------------------------------
# The read-off (plain PyTorch, as in the JAX package)
# ---------------------------------------------------------------------------

def make_compactor_flush(cap: int = cs.DEFAULT_CAP,
                         levels: int = cs.DEFAULT_LEVELS, device=None):
    """The per-flush compactor read-off on `device` (None: CUDA):

    `fn(cvals [U, levels*cap] f32, ccnt [U, levels] i32, cscale [U]
    f32, mm [2, U] f32, pct [P] f32) -> [U, P]` quantile columns.  Item
    weights are the implied `2**level * cscale` of each live slot
    (`cscale` is the arena's exact-count renormalization, 1.0 outside
    the clip regime), and the quantiles are `tdigest.weighted_eval`'s
    over the state's weighted points."""
    dev = resolve_device(device)
    lw = torch.as_tensor(2.0 ** np.arange(levels, dtype=np.float32),
                         device=dev)
    slot = torch.arange(cap, device=dev)

    def compactor_flush(cvals, ccnt, cscale, mm, pct):
        u = cvals.shape[0]
        live = slot[None, None, :] < ccnt[:, :, None]
        w = torch.where(live, lw[None, :, None], 0.0)
        w = (w * cscale[:, None, None]).reshape(u, levels * cap)
        # state padding is +inf; 0 * inf would poison the sums
        vals = torch.where(w > 0, cvals, 0.0)
        out = td.weighted_eval(vals, w, mm[0], mm[1], pct)
        return out[:, :pct.shape[0]]

    return compactor_flush
