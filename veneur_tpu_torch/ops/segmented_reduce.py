"""Segmented reduction: the cube sub-rollup, kernel B7.

Counterpart of `veneur_tpu.ops.segmented_reduce` (the `:N` marks are
its line numbers).  Coarsening a cube (``region,endpoint -> region``)
merges every fine group's mergeable vector into its coarse parent.  For
the moments family that merge is ONE vector add once the rows are
rebased to a common domain, so the whole coarsening is a segmented sum:
``vals [U, C]`` row vectors plus a SORTED int32 segment-id column (the
rank of each row's coarse group hash) reduce to ``[G, C]`` per-group
sums in one launch.

  `segment_sums`  on a CUDA tensor launches B7 (`ops/csrc/
                  segmented_reduce.cu`, replacing `_segment_sums_pallas`,
                  :81) or raises; on a CPU tensor it runs
                  `segment_sums_plain`.  Both add each group's rows
                  strictly in row order from 0.0, the TPU kernel's
                  order, so they agree bitwise with each other and with
                  the TPU kernel at every tiling.  The kernel is a
                  warp per group: a 32-way search over the ids finds
                  the group's rows, lanes run over columns, row loads
                  go out in batches ahead of the adds.  Ids must be
                  sorted (the documented contract; the kernel finds
                  each group's rows as one contiguous range): unsorted
                  or out-of-range ids raise ValueError.  Any U, C, G >= 1;
                  the JAX package's `usable()` gate and its
                  VENEUR_TPU_DISABLE_SEGMENTED_REDUCE switch have no
                  counterpart here.
  `coarsen_moments_vectors`  the host f64 rebase of moments vectors to
                  their coarse group's domain (:126-196), then one
                  `segment_sums` of the addable block on `device`.

`launches` counts B7 launches, so a run can show that its coarsened
group-by reads went through the kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from veneur_tpu_torch.ops.sorted_eval import _on_cuda, launch as _launch
from veneur_tpu_torch.sketches import moments as mo

launches = {"segment_sums": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _check(vals: torch.Tensor, seg: torch.Tensor, n_groups: int) -> None:
    """Shapes, types and the sorted-ids contract (one device-to-host
    read of two flags on a CUDA tensor)."""
    if vals.dim() != 2 or seg.dim() != 1 or seg.shape[0] != vals.shape[0]:
        raise ValueError(f"segment_sums: vals must be [U, C] and seg [U], "
                         f"got {tuple(vals.shape)} and {tuple(seg.shape)}")
    u, c = vals.shape
    if u < 1 or c < 1 or n_groups < 1:
        raise ValueError(f"segment_sums: needs U, C and G >= 1, got U={u} "
                         f"C={c} G={n_groups}")
    if vals.dtype != torch.float32 or seg.dtype != torch.int32:
        raise ValueError(f"segment_sums: expected float32 vals and int32 "
                         f"seg, got {vals.dtype} and {seg.dtype}")
    if not (vals.is_contiguous() and seg.is_contiguous()):
        raise ValueError("segment_sums: inputs must be contiguous")
    flags = torch.stack([(seg[1:] < seg[:-1]).any(),
                         (seg[0] < 0) | (seg[-1] >= n_groups)]).tolist()
    if flags[0]:
        raise ValueError("segment_sums: segment ids must be sorted "
                         "ascending")
    if flags[1]:
        raise ValueError(f"segment_sums: segment ids outside [0, "
                         f"{n_groups})")


def segment_sums_plain(vals: torch.Tensor, seg: torch.Tensor,
                       n_groups: int) -> torch.Tensor:
    """B7's plain version: step j adds row lo_g + j of every group g
    that still has rows, vectorized over groups and columns.  That is
    each group's strict row order from 0.0, one float32 add a row, so
    it is bitwise the kernel (and the TPU kernel)."""
    c = vals.shape[1]
    dev = vals.device
    lo = torch.searchsorted(seg, torch.arange(n_groups + 1, device=dev,
                                              dtype=seg.dtype))
    size = lo[1:] - lo[:-1]
    # groups longest first, so the groups still adding at step j are a
    # prefix of this order
    order = torch.argsort(size, descending=True, stable=True)
    start = lo[:-1][order]
    sizes = size[order].tolist()
    acc = torch.zeros((n_groups, c), dtype=torch.float32, device=dev)
    n = n_groups
    for j in range(sizes[0]):
        while sizes[n - 1] <= j:
            n -= 1
        acc[:n] += vals[start[:n] + j]
    out = torch.empty_like(acc)
    out[order] = acc
    return out


def launch(vals: torch.Tensor, seg: torch.Tensor,
           n_groups: int) -> torch.Tensor:
    """One B7 launch on checked CUDA inputs (counted)."""
    u, c = vals.shape
    out = torch.empty((n_groups, c), dtype=torch.float32, device=vals.device)
    from veneur_tpu_torch.ops import _build
    lib = _build.load("segmented_reduce")
    _launch("segment_sums", vals.device, lib.vn_segment_sums,
            vals.data_ptr(), seg.data_ptr(), out.data_ptr(), u, c, n_groups)
    launches["segment_sums"] += 1
    return out


def segment_sums(vals: torch.Tensor, seg: torch.Tensor,
                 n_groups: int) -> torch.Tensor:
    """``[U, C]`` float32 rows + sorted int32 segment ids in
    ``[0, n_groups)`` -> ``[n_groups, C]`` float32 per-group sums, each
    added in row order from 0.0 (empty groups 0).  A CPU tensor runs
    the plain version; a CUDA tensor launches B7 or raises."""
    cuda = _on_cuda("segment_sums", vals, seg)
    _check(vals, seg, n_groups)
    if not cuda:
        return segment_sums_plain(vals, seg, n_groups)
    return launch(vals, seg, n_groups)


# ---------------------------------------------------------------------------
# Moments-vector coarsening on top of the kernel
# ---------------------------------------------------------------------------

def coarsen_moments_vectors(vecs: np.ndarray, group_hashes: np.ndarray,
                            device=None) -> tuple:
    """Merge moments wire vectors ``[U, M]`` into their coarse groups.

    ``group_hashes`` (uint64, one per row: the fnv1a of the row's
    COARSE group identity) is sorted to produce the segment-id column;
    each group's rows are rebased (host f64, ``mo.rebase_sums``) to the
    group's common [min, max] / log domain, the addable components
    reduce through ``segment_sums`` on `device` (None: CUDA) in one
    launch, and min/max, the two non-additive slots, reduce on the
    sorted boundaries (``np.minimum.reduceat``).  Returns
    ``(unique_hashes [G] sorted, group_vecs [G, M] f64, G)``.

    The JAX package pads the addable block to whole 128-lane rows for
    the TPU; the sums of the real columns do not depend on it, so here
    the kernel sees its 4 + 2k real columns."""
    from veneur_tpu_torch import resolve_device
    dev = resolve_device(device)
    vecs = np.asarray(vecs, np.float64)
    u, m = vecs.shape
    k = mo.k_from_len(m)
    order = np.argsort(np.asarray(group_hashes, np.uint64), kind="stable")
    v = vecs[order]
    hs = np.asarray(group_hashes, np.uint64)[order]
    uniq, seg = np.unique(hs, return_inverse=True)
    g = len(uniq)
    starts = np.searchsorted(hs, uniq, side="left")

    a = np.where(np.isfinite(v[:, mo.IDX_MIN]), v[:, mo.IDX_MIN], 0.0)
    b = np.where(np.isfinite(v[:, mo.IDX_MAX]), v[:, mo.IDX_MAX], 0.0)
    occupied = v[:, mo.IDX_COUNT] > 0
    # group domains: the non-additive envelope, exact on the sorted
    # boundaries (empty member rows must not shrink the envelope)
    ga = np.minimum.reduceat(np.where(occupied, a, np.inf), starts)
    gb = np.maximum.reduceat(np.where(occupied, b, -np.inf), starts)
    ga = np.where(np.isfinite(ga), ga, 0.0)
    gb = np.where(np.isfinite(gb), gb, 0.0)
    gla, glb = mo.log_domain(ga, gb)

    raw = np.zeros((u, k + 1))
    raw[:, 0] = v[:, mo.IDX_COUNT]
    raw[:, 1:] = v[:, mo.SUMS_OFF:mo.SUMS_OFF + k]
    raw = mo.rebase_sums(raw, (a, b), (ga[seg], gb[seg]))
    la, lb = mo.log_domain(a, b)
    log = np.zeros((u, k + 1))
    log[:, 0] = v[:, mo.IDX_LOGN]
    log[:, 1:] = v[:, mo.SUMS_OFF + k:mo.SUMS_OFF + 2 * k]
    log = mo.rebase_sums(log, (la, lb), (gla[seg], glb[seg]))
    # a member with positive mass can join a group whose envelope
    # touches zero: the group log domain is the invalid sentinel
    # (glb < gla) and the solver never reads the log block, so zero it
    # rather than rebase into a collapsed domain
    log = np.where((glb > gla)[seg][:, None], log, 0.0)

    # addable block: count, sum, rsum, k raw sums, logn, k log sums
    add = np.concatenate([
        v[:, [mo.IDX_COUNT, mo.IDX_SUM, mo.IDX_RSUM]],
        raw[:, 1:], log[:, 0:1], log[:, 1:]], axis=1).astype(np.float32)
    sums = segment_sums(torch.from_numpy(add).to(dev),
                        torch.from_numpy(seg.astype(np.int32)).to(dev),
                        g).cpu().numpy().astype(np.float64)

    out = np.zeros((g, m))
    out[:, mo.IDX_COUNT] = sums[:, 0]
    out[:, mo.IDX_SUM] = sums[:, 1]
    out[:, mo.IDX_RSUM] = sums[:, 2]
    out[:, mo.SUMS_OFF:mo.SUMS_OFF + k] = sums[:, 3:3 + k]
    out[:, mo.IDX_LOGN] = sums[:, 3 + k]
    out[:, mo.SUMS_OFF + k:mo.SUMS_OFF + 2 * k] = sums[:, 4 + k:4 + 2 * k]
    out[:, mo.IDX_MIN] = np.where(out[:, mo.IDX_COUNT] > 0, ga, np.inf)
    out[:, mo.IDX_MAX] = np.where(out[:, mo.IDX_COUNT] > 0, gb, -np.inf)
    return uniq, out, g
