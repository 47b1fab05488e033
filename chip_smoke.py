#!/usr/bin/env python3
"""Smoke test of veneur_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from `veneur_tpu_torch/ops/csrc`,
holds each against its plain PyTorch version on the card, drives the
port's flush path end to end (a local and a global `Server` wired
in-process, real DogStatsD datagrams over UDP, t-digest, moments and
compactor histograms; a server with group-by cubes answering /query
over HTTP; a meshed server beside an unmeshed one; a local and a
global over real gRPC, held to the in-process hop), then runs the
full-size flushes of the north star (100k digests, and 100k moments
sketches, per interval, and 100k 64-centroid digests forwarded from a
local to a global over gRPC, and from two locals through the proxy
tier, `veneur_tpu_torch/proxy/` as its own process, to two globals), of
the compactor tier (16,384 ladders), the group-by read over 102,400 +
102,400 series in 4,096 cube groups, the
meshed 100k-key global flush (on a one-card mesh, and on 2 x 2 and
2 x 3 meshes over the same card) and the moments global flush on a
2 x 2 one-card mesh beside the unmeshed one, and times them; then one
interval of the global 100k x 64 shape over loopback UDP through the
native ingest engine's C++ readers (`veneur_tpu_torch/ingest/`), its
dense build through the native fill beside the numpy builder; then crash
durability at full width (a global's checkpoint, crash and restore
against an uncrashed twin, the stale-marker skip; a local's 100k-digest
forward spilled to the durable spool, the local crashed and revived,
the spool replayed into a global that came up late; the per-tenant key
budget over 100k keys of 25 tenants through the native UDP readers,
against the CPU); then the
command line (`veneur_tpu_torch/cli/veneur.py`): in this process, two
UDP intervals through the native readers cut by POST /flush and by
SIGTERM, the first again through the Python readers
(`native_ingest: false`), and as two processes that hand a UDP port
over by SIGUSR2; then the three profiling entry points
(`veneur_tpu_torch/scripts/`) with their kernels H1-H3.
Every phase that fails raises, and the script exits non-zero.  The last
line of standard output is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

preceded by one JSON line describing each kernel and the card's name and
power limit as `nvidia-smi` reports them.  Without a CUDA device, or
without the rest of the repository beside it, the script exits non-zero
and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np

PERCENTILES = [0.5, 0.9, 0.99]
SORTED_EVAL = "veneur_tpu_torch/ops/csrc/sorted_eval.cu"
KERNEL_SOURCE = {"weighted_eval": SORTED_EVAL,
                 "uniform_eval": SORTED_EVAL,
                 "weighted_eval_compact": SORTED_EVAL,
                 "weighted_eval_bf16": SORTED_EVAL,
                 "uniform_eval_bf16": SORTED_EVAL,
                 "moments_sums": "veneur_tpu_torch/ops/csrc/moments_eval.cu",
                 "moments_sums_depth":
                     "veneur_tpu_torch/ops/csrc/moments_eval.cu",
                 "compact_batch":
                     "veneur_tpu_torch/ops/csrc/compactor_eval.cu",
                 "segment_sums":
                     "veneur_tpu_torch/ops/csrc/segmented_reduce.cu",
                 "weighted_eval_uniform": SORTED_EVAL,
                 "register_moments":
                     "veneur_tpu_torch/ops/csrc/hll_estimate.cu",
                 "quantile": "veneur_tpu_torch/ops/csrc/quantile_eval.cu",
                 "stage_slice": SORTED_EVAL,
                 "stage_slice_wide": SORTED_EVAL,
                 "sort_variant":
                     "veneur_tpu_torch/ops/csrc/sort_variants.cu"}
REPLACES = {"weighted_eval": "veneur_tpu/ops/sorted_eval.py:699",
            "uniform_eval": "veneur_tpu/ops/sorted_eval.py:619",
            "weighted_eval_compact": "veneur_tpu/ops/sorted_eval.py:699",
            "weighted_eval_bf16": "veneur_tpu/ops/sorted_eval.py:699",
            "uniform_eval_bf16": "veneur_tpu/ops/sorted_eval.py:619",
            "moments_sums": "veneur_tpu/ops/moments_eval.py:198",
            "moments_sums_depth": "veneur_tpu/ops/moments_eval.py:198",
            "compact_batch": "veneur_tpu/ops/compactor_eval.py:155",
            "segment_sums": "veneur_tpu/ops/segmented_reduce.py:81",
            "weighted_eval_uniform": "veneur_tpu/ops/sorted_eval.py:699",
            "register_moments": "veneur_tpu/ops/hll_estimate.py:48",
            "quantile": "veneur_tpu/ops/quantile_eval.py:94",
            "stage_slice": "veneur_tpu/ops/sorted_eval.py:738",
            "stage_slice_wide": "scripts/profile_kernel_inloop.py:38",
            "sort_variant": "scripts/sort_variants.py:213"}
# main-path shapes: the 100k-key global flush (B1) and local flush (B3);
# their bf16-staged counterparts (B4 at 131072 x 64, B3 on bf16 values
# at 131072 x 8) and the deep bf16 global flush (B1 on bf16 values at
# 16384 x 512); B5's general variant in the 100k-key global moments
# flush and its depth variant in the local one; B6 (U x levels x 2cap)
# in the 16,384-key compactor folds at the default geometry; B7
# (U x C -> G) in the cube read's group_by=endpoint coarsening; B2 in
# the meshed 100k-key global flush (64 samples a key, all weight 1),
# B8 on that cell's 10,000 set rows at p = 14 and B9 on its digests
# compressed to centroid_capacity(100) = 152 slots; H1, H2 and H3 at
# the profiling entry points' default K x D
MAIN_SHAPE = {"weighted_eval": (131072, 64), "uniform_eval": (131072, 8),
              "weighted_eval_compact": (131072, 64),
              "weighted_eval_bf16": (16384, 512),
              "uniform_eval_bf16": (131072, 8),
              "moments_sums": (131072, 64),
              "moments_sums_depth": (131072, 64),
              "compact_batch": (16384, 14, 256),
              "segment_sums": (4096, 20, 256),
              "weighted_eval_uniform": (131072, 64),
              "register_moments": (10000, 16384),
              "quantile": (131072, 152),
              "stage_slice": (16384, 256), "stage_slice_wide": (16384, 256),
              "sort_variant": (16384, 256)}
MOMENTS_K = 8
# the compactor rule of the UDP slice, and the (cap, levels) geometries
# B6 is held to its plain version at: the config's extremes and the
# default (128, 14)
COMPACTOR_RULES = [{"match": "c.*", "family": "compactor"}]
B6_GEOMETRIES = ((8, 4), (32, 14), (128, 14), (256, 8))
# the moments rule of the slice and its per-quantile envelope against
# numpy at >= 2,000 samples (tests/test_moments.py)
MOMENT_RULES = [{"match": "mom.*", "family": "moments"}]
MOMENTS_ENVELOPE = 0.02
# the cube slice's and cube cell's dimensions (bench.py's
# bench_cube_query): (endpoint, region) for the t-digest `cq.*` and the
# moments `cqm.*` metrics
CUBE_DIMS = [{"tags": ["endpoint", "region"], "match": "cq.*"},
             {"tags": ["endpoint", "region"], "match": "cqm.*"}]
CUBE_RULES = [{"match": "cqm.*", "family": "moments"}]
# B5 against its plain version: per column within
# C_REORDER * D * 2^-24 * sum|w| of the row (both sum the same terms,
# each |w * T_j| <= |w|, in another order)
C_REORDER = 2.0
# depths B5 is held to its plain version at beside the flush's powers of
# two: a ragged last group of four columns, and row widths whose lane
# group is not D / 16
B5_ODD_DS = (5, 63, 100)
# a flush through B5 against the same flush through its plain version:
# each quantile within this fraction of the row's [min, max] span
SOLVER_RULE = 1e-3
# bf16 staging rounds each value to 8 significant bits: a quantile of
# positive samples interpolated between rounded neighbours is within
# 2^-8 of its magnitude (plus float32 rounding) of numpy's Hazen
# percentile of the unrounded samples
BF16_REL = 2.0 ** -8
# cuda_ms's spin before the opening event: ~0.5 ms at the H100's clocks,
# longer than any wrapper's host work between two launches
HOST_SLACK_CYCLES = 1_000_000
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12            # H100 SXM f32 outside the tensor cores

# the gRPC cell's decode and import, summed over its RPCs, when the
# global parsed every record in Python (call 4 of PR 18, PERF.md)
PR18_IMPORT_MS = 74579.0

CARD = ""                        # "name, power.limit" from nvidia-smi
DEVICE = "cuda"


def require(ok, what) -> None:
    """Fail the run when a check does not hold (unlike assert, also
    under python -O)."""
    if not ok:
        raise AssertionError(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_log(msg: str) -> None:
    log(f"[{CARD}] {msg}")


# ---------------------------------------------------------------------------
# Inputs (made on the card from a seeded generator)
# ---------------------------------------------------------------------------

def _gamma2(shape, gen, dev, scale=50.0):
    """Gamma(2, scale) samples: the sum of two exponentials."""
    import torch
    u1 = torch.rand(shape, generator=gen, device=dev).clamp_min(1e-12)
    u2 = torch.rand(shape, generator=gen, device=dev).clamp_min(1e-12)
    return (-scale * (torch.log(u1) + torch.log(u2))).float()


def weighted_rows(u, d, gen, dev, integer=True):
    """B1 inputs: distinct integer values per row (or gamma floats),
    integer weights 1..3 with ~30% zero-weight holes, and the edge rows
    (empty, single point, full, whole-row tie).  |values| < 2d + 1000
    and weights <= 3 keep every weighted sum below 2^24, so integer
    rows sum exactly in any order."""
    import torch
    if integer:
        perm = torch.rand((u, d), generator=gen, device=dev).argsort(dim=1)
        off = torch.randint(0, 1000, (u, 1), generator=gen, device=dev)
        m = (perm * 2 - d + off).float()
    else:
        m = _gamma2((u, d), gen, dev)
    w = torch.randint(1, 4, (u, d), generator=gen, device=dev).float()
    w = w * (torch.rand((u, d), generator=gen, device=dev) < 0.7)
    if u >= 4:
        w[0] = 0.0                                   # empty row
        w[1] = 0.0
        w[1, d // 2] = 3.0                           # single point
        w[2] = torch.randint(1, 4, (d,), generator=gen, device=dev).float()
        m[3] = 7.0                                   # whole-row tie
    occ = w > 0
    has = occ.any(dim=1)
    inf = torch.tensor(float("inf"), device=dev)
    zero = torch.zeros((), device=dev)
    dmin = torch.where(has, torch.where(occ, m, inf).amin(dim=1), zero)
    dmax = torch.where(has, torch.where(occ, m, -inf).amax(dim=1), zero)
    pct = torch.tensor([0.5] + PERCENTILES + [0.0, 1.0], device=dev)
    return (m.contiguous(), w.contiguous(), dmin.contiguous(),
            dmax.contiguous(), pct)


def depth_rows(u, d, gen, dev, integer=True):
    """B3 inputs: the first depths[k] columns of each row are real
    points; edge rows: empty, single point, full, whole-row tie."""
    import torch
    if integer:
        perm = torch.rand((u, d), generator=gen, device=dev).argsort(dim=1)
        m = (perm * 2 - d).float()
    else:
        m = _gamma2((u, d), gen, dev)
    depths = torch.randint(0, d + 1, (u,), generator=gen, device=dev)
    if u >= 4:
        depths[0], depths[1], depths[2], depths[3] = 0, 1, d, d
        m[3] = 7.0
    col = torch.arange(d, device=dev)[None, :]
    m = torch.where(col < depths[:, None], m, torch.zeros((), device=dev))
    pct = torch.tensor([0.5] + PERCENTILES + [0.0, 1.0], device=dev)
    return m.contiguous(), depths.to(torch.int16), pct


def _tie_free_bf16(u, d, gen, dev):
    """`[U, D]` values, distinct within each row and bf16-exact: D
    consecutive entries, from a random offset, of a random permutation
    of the 1024 integers +-(128..255) * 2^e, e < 4 (|v| <= 2040, so
    integer weights <= 3 keep every weighted sum below 2^24)."""
    import torch
    a = torch.arange(128, 256, device=dev, dtype=torch.float32)
    table = torch.cat([s * a * 2.0 ** e for s in (-1, 1) for e in range(4)])
    table = table[torch.randperm(1024, generator=gen, device=dev)]
    perm = torch.rand((u, d), generator=gen, device=dev).argsort(dim=1)
    off = torch.randint(0, 1024 - d + 1, (u, 1), generator=gen, device=dev)
    return table[(perm + off) % 1024]


def _bounds(m, w):
    """Each row's [min, max] over its occupied points (0 for empty
    rows), on the widened values."""
    import torch
    m = m.float()
    occ = w > 0
    has = occ.any(dim=1)
    inf = torch.tensor(float("inf"), device=m.device)
    zero = torch.zeros((), device=m.device)
    return (torch.where(has, torch.where(occ, m, inf).amin(dim=1), zero),
            torch.where(has, torch.where(occ, m, -inf).amax(dim=1), zero))


def bf16_weighted_rows(u, d, gen, dev, integer=True):
    """B1-on-bf16 inputs: weighted_rows' weights and edge rows, with
    tie-free bf16-exact integer values (or gamma floats rounded to
    bf16, which tie) staged as bf16."""
    import torch
    m, w, _, _, pct = weighted_rows(u, d, gen, dev, integer=False)
    if integer:
        m = _tie_free_bf16(u, d, gen, dev)
    m = m.to(torch.bfloat16)
    if u >= 4:
        m[3] = 7.0                                   # whole-row tie
    dmin, dmax = _bounds(m, w)
    return m.contiguous(), w, dmin.contiguous(), dmax.contiguous(), pct


def compact_rows(u, d, gen, dev, integer=True):
    """B4 inputs: bf16 values with many ties (integers drawn per row
    from [-r, r], r in {1, 4, 2D}), negative values, and zeros of both
    signs; integer weights 1..3 with ~30% zero-weight holes; edge rows
    (empty, single point, full, whole-row tie).  Integer values keep
    every sum exact (|v| <= 128, weights <= 3).  integer=False: gamma
    floats rounded to bf16 (ties where the rounding merges them)."""
    import torch
    if integer:
        r = torch.tensor([1.0, 4.0, 2.0 * d], device=dev)[
            torch.randint(0, 3, (u, 1), generator=gen, device=dev)]
        r = r.clamp_max(128.0)
        m = torch.floor((2 * r + 1) * torch.rand(
            (u, d), generator=gen, device=dev)) - r
        neg0 = torch.rand((u, d), generator=gen, device=dev) < 0.5
        m = torch.where((m == 0) & neg0, torch.full_like(m, -0.0), m)
    else:
        m = _gamma2((u, d), gen, dev) - 60.0
    w = torch.randint(1, 4, (u, d), generator=gen, device=dev).float()
    w = w * (torch.rand((u, d), generator=gen, device=dev) < 0.7)
    if u >= 4:
        w[0] = 0.0                                   # empty row
        w[1] = 0.0
        w[1, d // 2] = 3.0                           # single point
        w[2] = torch.randint(1, 4, (d,), generator=gen, device=dev).float()
        m[3] = 7.0                                   # whole-row tie
    m = m.to(torch.bfloat16)
    dmin, dmax = _bounds(m, w)
    pct = torch.tensor([0.5] + PERCENTILES + [0.0, 1.0], device=dev)
    return (m.contiguous(), w.contiguous(), dmin.contiguous(),
            dmax.contiguous(), pct)


def tied_rows(u, d, gen, dev, bf16=False, integer=True):
    """B1 inputs with tied runs: compact_rows' integer rows (values drawn
    per row from [-r, r], zeros of both signs, holes, the edge rows), or
    gamma floats drawn with replacement from D per row (so they tie) on
    the same weights; as bf16 values (gamma rounded) or float32, with a
    grid of 33 percentiles (k / 32), so many tq = q * total fall on a
    cmid, where a rank one off moves a float row's quantile."""
    import torch
    m, w, _, _, _ = compact_rows(u, d, gen, dev)
    if not integer:
        g = _gamma2((u, d), gen, dev)
        m = torch.gather(g, 1, torch.randint(0, d, (u, d), generator=gen,
                                              device=dev))
        if u >= 4:
            m[3] = 7.0                               # whole-row tie
    m = m.to(torch.bfloat16 if bf16 else torch.float32).contiguous()
    dmin, dmax = _bounds(m, w)
    pct = torch.arange(33, device=dev, dtype=torch.float32) / 32
    return m, w, dmin, dmax, pct


def odd_weight_rows(u, d, gen, dev, bf16=False):
    """B1 inputs outside what a flush stages, their holes holding 0 as
    the dense build leaves them (ROADMAP C9): tied_rows' float32 rows
    with NaN at ~10% of the occupied points of every third row, and
    weight -1 at ~20% of the holes of every other row (its cmid falls,
    so the tail counts that row's ranks).  Each row's [min, max] is over
    its non-NaN points.  bf16: the same values staged as bf16 (B4's
    input; every value is bf16-exact)."""
    import torch
    m, w, _, _, pct = tied_rows(u, d, gen, dev)
    row = torch.arange(u, device=dev)[:, None]
    occ = w > 0
    nan = occ & (row % 3 == 1) & (torch.rand(
        (u, d), generator=gen, device=dev) < 0.1)
    m = torch.where(nan, torch.full_like(m, float("nan")), m)
    neg = ~occ & (row % 2 == 0) & (torch.rand(
        (u, d), generator=gen, device=dev) < 0.2)
    w = torch.where(neg, torch.full_like(w, -1.0), w)
    m = torch.where(w > 0, m, torch.zeros_like(m))
    dmin, dmax = _bounds(torch.where(nan, torch.zeros_like(m), m),
                         w * ~nan)
    if bf16:
        m = m.to(torch.bfloat16)
    return m.contiguous(), w.contiguous(), dmin, dmax, pct


def tied_depth_rows(u, d, gen, dev, bf16=False):
    """B3 inputs with tied runs: compact_rows' integer values (drawn per
    row from [-r, r], zeros of both signs) in the first depths[k]
    columns, depths over [0, D] with the edge rows (empty, single
    point, full, full whole-row tie), as float32 or bf16 values (all
    bf16-exact), with tied_rows' 33 percentiles."""
    import torch
    m = compact_rows(u, d, gen, dev)[0].float()
    depths = torch.randint(0, d + 1, (u,), generator=gen, device=dev)
    if u >= 4:
        depths[0], depths[1], depths[2], depths[3] = 0, 1, d, d
        m[3] = 7.0
    col = torch.arange(d, device=dev)[None, :]
    m = torch.where(col < depths[:, None], m, torch.zeros((), device=dev))
    m = m.to(torch.bfloat16 if bf16 else torch.float32).contiguous()
    pct = torch.arange(33, device=dev, dtype=torch.float32) / 32
    return m, depths.to(torch.int16), pct


def bf16_depth_rows(u, d, gen, dev, integer=True):
    """B3-on-bf16 inputs: depth_rows' depths and edge rows with
    tie-free bf16-exact integer values (or gamma rounded to bf16)."""
    import torch
    m, depths, pct = depth_rows(u, d, gen, dev, integer=False)
    if integer:
        col = torch.arange(d, device=dev)[None, :]
        m = torch.where(col < depths[:, None].long(),
                        _tie_free_bf16(u, d, gen, dev),
                        torch.zeros((), device=dev))
    return m.to(torch.bfloat16).contiguous(), depths, pct


def moment_rows(u, d, gen, dev, grid: bool, depth: bool):
    """B5 inputs (values, weights or int16 depths, ab, lab).  grid rows
    put every scaled value on t in {-1, -1/2, 0, 1/2, 1} (domains
    [0, 4] over 0..4, [-4, 4] over -4, -2, .., 4, and the zero span
    [2, 2]) with the lab sentinel, so every T_j is in {0, +-1/2, +-1}
    and, with integer weights, every sum is exact in any order.  Gamma
    rows carry negative values (every 5th row shifted by -60), zero
    spans (every 5th a constant) and the lab sentinel (a <= 0, and
    every 7th row); each row's domain is its occupied range.  Row 0 is
    empty.  Weights: integers 1..3 with ~30% zero holes; depths: 0..D
    with zeroed padding."""
    import torch
    r = torch.arange(u, device=dev)
    if depth:
        dep = torch.randint(0, d + 1, (u,), generator=gen, device=dev)
        dep[0] = 0
        occ = torch.arange(d, device=dev)[None, :] < dep[:, None]
        w = occ.float()
    else:
        w = torch.randint(1, 4, (u, d), generator=gen, device=dev).float()
        w = w * (torch.rand((u, d), generator=gen, device=dev) < 0.7)
        w[0] = 0.0
        occ = w > 0
    if grid:
        kind = (r % 3)[:, None]
        idx = torch.randint(0, 5, (u, d), generator=gen, device=dev).float()
        v = torch.where(kind == 0, idx, torch.where(
            kind == 1, 2.0 * idx - 4.0, torch.full_like(idx, 2.0)))
        a = torch.where(r % 3 == 2, 2.0, torch.where(r % 3 == 1, -4.0, 0.0))
        b = torch.where(r % 3 == 2, 2.0, 4.0)
        la, lb = torch.zeros_like(a), torch.full_like(a, -1.0)
    else:
        v = _gamma2((u, d), gen, dev)
        v = torch.where((r % 5 == 1)[:, None], v - 60.0, v)
        v = torch.where((r % 5 == 2)[:, None], torch.full_like(v, 7.5), v)
        inf = torch.tensor(float("inf"), device=dev)
        has = occ.any(dim=1)
        a = torch.where(has, torch.where(occ, v, inf).amin(dim=1), 0.0)
        b = torch.where(has, torch.where(occ, v, -inf).amax(dim=1), 0.0)
        ok = (a > 0) & (r % 7 != 3)
        a64, b64 = a.double(), b.double()
        la = torch.where(ok, torch.log(torch.where(ok, a64, 1.0)), 0.0)
        lb = torch.where(ok, torch.log(torch.where(
            ok, torch.maximum(b64, a64), 1.0)), -1.0)
        la, lb = la.float(), lb.float()
    if depth:
        v = torch.where(occ, v, torch.zeros((), device=dev))
        wt = dep.to(torch.int16)
    else:
        wt = w
    return (v.contiguous(), wt.contiguous(), torch.stack([a, b]).contiguous(),
            torch.stack([la, lb]).contiguous(), w)


def check_moments(rows, grid: bool, k: int = MOMENTS_K) -> tuple:
    """B5 against its plain version on the same inputs: bitwise on grid
    rows; else each column within C_REORDER * D * 2^-24 * sum|w| of the
    row.  A lost or doubled point still fails: it moves the count column
    by its weight (>= 1), while the bound stays below 0.1 at D <= 512
    and weights <= 3.  Returns (max |diff|, max diff / bound); raises
    when they disagree."""
    import torch
    from veneur_tpu_torch.ops import moments_eval as me
    dv, dw, ab, lab, w = rows
    uniform = dw.dtype == torch.int16
    got = me.moments_sums(dv, dw, ab, lab, k, uniform)
    ref = me.moments_sums_plain(dv, dw, ab, lab, k, uniform)
    torch.cuda.synchronize()
    diff = (got - ref).abs()
    tol = C_REORDER * dv.shape[1] * 2.0 ** -24 * w.abs().sum(dim=1)[:, None]
    ratio = float((diff / tol.clamp_min(1e-30)).max()) if diff.numel() else 0.
    ok = torch.equal(got, ref) if grid else bool((diff <= tol).all())
    if not ok:
        bad = (diff > (0 if grid else tol)).nonzero()[:5].tolist()
        raise AssertionError(
            f"moments_sums uniform={uniform} {tuple(dv.shape)} k={k} "
            f"grid={grid}: kernel != plain at {bad} (max |diff| "
            f"{float(diff.max())}, {ratio:.3f} of the bound)")
    return float(diff.max()) if diff.numel() else 0.0, ratio


def compactor_rows(u, cap, levels, gen, dev, rng):
    """B6 inputs on the card (stage_v, stage_n, off) plus the planner's
    post-pass occupancies and clip counts.  Row kinds by index mod 6:
    0 mostly empty levels; 1 a full 2*cap staging on every level (the
    carry then forces both clip rounds at the top); 2 integers in
    [0, 8), long runs of ties; 3 -0 and +0 mixed with -1, 1 and 2; 4
    and 5 gamma f32.  Occupancies are random in [0, 2cap] (numpy), the
    coin offsets the port's plan_pass on random compaction counters."""
    import torch
    from veneur_tpu_torch.sketches import compactor as cs
    s2 = 2 * cap
    kind = np.arange(u) % 6
    n = rng.integers(0, s2 + 1, (u, levels))
    sparse = kind == 0
    n[sparse] = np.where(rng.random((int(sparse.sum()), levels)) < 0.7, 0,
                         n[sparse])
    n[kind == 1] = s2
    off, cnt, _, clip = cs.plan_pass(n, rng.integers(0, 1 << 20, u),
                                     np.zeros(u, np.int64), cs.DEFAULT_SEED,
                                     cap)
    shape = (u, levels, s2)
    kd = torch.from_numpy(kind).to(dev)[:, None, None]
    ties = torch.randint(0, 8, shape, generator=gen, device=dev).float()
    zeros = torch.tensor([-0.0, 0.0, -1.0, 1.0, 2.0], device=dev)[
        torch.randint(0, 5, shape, generator=gen, device=dev)]
    v = torch.where(kd == 2, ties, torch.where(kd == 3, zeros,
                                               _gamma2(shape, gen, dev)))
    nd = torch.from_numpy(n.astype(np.int32)).to(dev)
    col = torch.arange(s2, device=dev)
    v = torch.where(col < nd[:, :, None], v, float("inf"))
    args = (v.contiguous(), nd.contiguous(),
            torch.from_numpy(off.astype(np.int32)).to(dev))
    return args, cnt, clip


def check_compact(args, cnt=None, got=None) -> float:
    """B6 against its plain version on the same `args`: bitwise, signs
    of zero included (both sort under the IEEE total order).  With the
    planner's occupancies `cnt`: every live slot finite and every slot
    past it +inf.  `got`: a main-path output to hold to the same rule
    instead of a new launch.  Returns the largest absolute difference
    (0.0: it raises otherwise)."""
    import torch
    from veneur_tpu_torch.ops import compactor_eval as ce
    if got is None:
        got = ce.compact_batch(*args)
    ref = ce.compact_batch_plain(*args)
    torch.cuda.synchronize()
    if not _same_bits(got, ref):
        bad = (got.view(torch.int32) != ref.view(torch.int32)).nonzero()
        raise AssertionError(
            f"compact_batch {tuple(args[0].shape)}: kernel != plain at "
            f"{bad[:5].tolist()} ({len(bad)} values)")
    if cnt is not None:
        cap = got.shape[2]
        live = (torch.arange(cap, device=got.device)[None, None, :]
                < torch.from_numpy(cnt).to(got.device)[:, :, None])
        require(bool(torch.isfinite(got[live]).all())
                and bool((got[~live] == float("inf")).all()),
                f"compact_batch {tuple(args[0].shape)}: occupancy "
                "differs from the planner's")
    return 0.0


# ---------------------------------------------------------------------------
# Timing and bounds
# ---------------------------------------------------------------------------

def cuda_ms(fn, iters: int = 20, slack: int = HOST_SLACK_CYCLES) -> float:
    """Device time of one fn() with its inputs not in the L2 cache: the
    median over `iters` calls, each timed alone by CUDA events after a
    128 MB write has evicted the 50 MB L2, after one warm-up call.  A
    spin of `slack` cycles on the card follows the eviction, so the host
    has queued fn's launch and the closing event before the opening
    event fires: the events then time the device's work alone, not the
    wrapper's host work (tens of microseconds of Python, more than a
    small kernel takes), which a flush meets and `kernel_ms` includes.
    slack=0: no spin, the events open right after the eviction (the
    earlier instrument; veneur_tpu_torch/scripts/kernel_ab.py times
    both)."""
    import torch
    fn()
    evict = torch.empty(32 << 20, dtype=torch.float32, device=DEVICE)
    marks = []
    for _ in range(iters):
        evict.zero_()
        if slack:
            torch.cuda._sleep(slack)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        marks.append((e0, e1))
    torch.cuda.synchronize()
    return float(np.median([e0.elapsed_time(e1) for e0, e1 in marks]))


def bound_moments(name: str, u: int, d: int, k: int,
                  occupied: int) -> tuple[float, str]:
    """B5's least time: its bytes (values, weights or int16 depths, the
    two [2, U] domains, the [U, 2(k+1)] output) over the memory rate, or
    its f32 operations over the f32 rate, the larger: per occupied point
    13 + 10k (scale, clip and log of both domains, the two count adds,
    and per order j the two recurrences and two weighted adds)."""
    wbytes = u * 2 if name == "moments_sums_depth" else u * d * 4
    nbytes = u * d * 4 + wbytes + u * 16 + u * 2 * (k + 1) * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = occupied * (13 + 10 * k) / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_compact(stage_n: np.ndarray, cap: int) -> tuple[float, str]:
    """B6's least time on these inputs: the bytes it must move (each
    level's occupied staging in, 4 bytes a value, the i32 occupancies
    and coin offsets, the whole [U, levels, cap] f32 state out) over the
    memory rate, or its operations over the f32 rate, the larger.
    Operations: a 4cap-value bitonic network per level that holds
    anything (staged or carried), 4cap lg (lg + 1) / 4 compare-exchanges
    with lg = log2(4cap); the selections after it are index arithmetic.
    The carry counts follow plan_pass's integer dynamics.  The kernel
    sorts only the 2cap staged keys and merges the sorted carry by rank,
    fewer operations than counted here, but the bytes term is the larger
    at every shape this script times, so the bound is the same."""
    u, levels = stage_n.shape
    n = np.clip(stage_n, 0, 2 * cap).astype(np.int64)
    carry = np.zeros(u, np.int64)
    sorted_levels = 0
    for lvl in range(levels):
        occ = n[:, lvl] + carry
        sorted_levels += int((occ > 0).sum())
        sec = occ - cap // 2
        carry = np.where(occ > cap, sec - (sec & 1), 0) // 2
    b = 4 * cap
    lg = int(math.log2(b))
    ops = sorted_levels * b * lg * (lg + 1) / 4
    nbytes = 4 * int(n.sum()) + 4 * u * levels + 4 * u * (levels + 2) \
        + 4 * u * levels * cap
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound(name: str, u: int, d: int, n_pct: int) -> tuple[float, str]:
    """Least time the card could take: the larger of the bytes the
    function must move (inputs read once, outputs written once) over
    the memory rate and its operations over the f32 rate.  Values are
    2 bytes for the bf16 variants (B4 and the *_bf16 ones), 4 else.
    Operations: the bitonic network's U*D*log2D*(log2D+1)/4
    compare-exchanges, plus the weighted variants' U*D prefix-sum
    adds."""
    lg = int(math.log2(d))
    cmpx = u * d * lg * (lg + 1) / 4
    vbytes = 2 if name.endswith(("_bf16", "_compact")) else 4
    if name.startswith("weighted_eval"):
        nbytes = (u * d * (vbytes + 4) + u * 8 + n_pct * 4
                  + u * (n_pct + 2) * 4)
        ops = cmpx + u * d
    else:
        nbytes = u * d * vbytes + u * 2 + n_pct * 4 + u * n_pct * 4
        ops = cmpx
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_environment():
    global CARD
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    CARD = smi.stdout.strip().splitlines()[0].strip()
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  devices {torch.cuda.device_count()}")
    log(f"card: {CARD}")


def phase_build():
    """The CUDA kernels (one nvcc each) and, beside them, the native
    ingest engine (g++ after its io_uring header probe)."""
    from veneur_tpu_torch import ingest
    from veneur_tpu_torch.ingest import _build as ingest_build
    from veneur_tpu_torch.ops import _build
    t0 = time.perf_counter()
    engine: dict = {}

    def build_engine():
        try:
            engine.update(ingest_build.build())
        except BaseException as e:      # re-raised below
            engine["error"] = e

    builder = threading.Thread(target=build_engine, name="g++")
    builder.start()
    libs = _build.build()
    took = time.perf_counter() - t0
    builder.join()
    if "error" in engine:
        raise engine["error"]
    ingest.load_library()
    for stem, rec in libs.items():
        log(f"built {stem}: {rec['seconds']:.2f}s -> {rec['path']}")
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  ptxas: {line.strip()}")
    log(f"kernel build: {took:.2f}s")
    card_log(f"ingest engine build (g++): {engine['seconds']:.2f}s, io_uring "
             f"header probe {engine['probe_seconds']:.2f}s -> "
             f"VN_UAPI_HAS_PBUF_RING={int(engine['probe'])}; "
             f"{engine['path']}")


def _float_b1_agrees(args, got, ref, diff) -> bool:
    """B1 and B4 on gamma values with integer weights: the prefix sums
    are exact and both networks are stable, so every row's quantile and
    total columns are the plain version's bits, tied rows included; the
    weighted sums are summed in another order, each within
    (d-1) * 2^-24 * sum|m*w| of the exact sum, so within twice that of
    each other."""
    m, w, _, _, pct = args
    m = m.float()
    n, d = pct.shape[0], m.shape[1]
    tol = 2 * (d - 1) * 2.0 ** -24 * (m * w).abs().sum(dim=1)
    return (_same_bits(got[:, :n + 1], ref[:, :n + 1])
            and bool((diff[:, n + 1] <= tol).all()))


def _same_bits(a, b) -> bool:
    """Bitwise equality of two float32 tensors (signs of zero too)."""
    import torch
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def _variant(m, compact: bool) -> str:
    """The launch-count name of weighted_eval on values `m`."""
    import torch
    if compact:
        return "weighted_eval_compact"
    return ("weighted_eval_bf16" if m.dtype == torch.bfloat16
            else "weighted_eval")


def check_weighted(args, integer: bool, compact: bool = False,
                   got=None) -> float:
    """B1 (compact: B4) against its plain version on the same `args`.
    Both sort stably, so on integer rows every quantile and total column
    is the plain version's bits, ties and signs of zero included, and
    the weighted sum its value (an all-zero sum's sign depends on the
    summation's starting value); gamma rows: _float_b1_agrees.  `got`: a
    main-path output to hold to the same rule instead of a new launch.
    Returns the largest absolute difference; raises when they
    disagree."""
    import torch
    from veneur_tpu_torch.ops import sorted_eval as se
    if got is None:
        got = se.weighted_eval(*args, compact=compact)
    ref = se.weighted_eval_plain(*args)
    torch.cuda.synchronize()
    diff = (got - ref).abs()
    n = args[4].shape[0]
    if integer:
        ok = (_same_bits(got[:, :n + 1], ref[:, :n + 1])
              and torch.equal(got[:, n + 1], ref[:, n + 1]))
    else:
        ok = _float_b1_agrees(args, got, ref, diff)
    if not ok:
        bad = (diff > 0).nonzero()[:5].tolist()
        raise AssertionError(
            f"{_variant(args[0], compact)} {tuple(args[0].shape)} "
            f"integer={integer}: kernel != plain at {bad} (max |diff| "
            f"{float(diff.max())})")
    return float(diff.max())


def check_odd_weights(args, compact: bool = False) -> None:
    """B1 (compact: B4) against its plain version on odd_weight_rows:
    NaN in the same places; elsewhere the quantile and total columns
    bitwise and the weighted sums equal (ROADMAP C9: with holes holding
    0 the two agree on NaN values and negative weights too)."""
    import torch
    from veneur_tpu_torch.ops import sorted_eval as se
    got = se.weighted_eval(*args, compact=compact)
    ref = se.weighted_eval_plain(*args)
    torch.cuda.synchronize()
    n = args[4].shape[0]
    nan = torch.isnan(ref)
    g, r = got.masked_fill(nan, 0.0), ref.masked_fill(nan, 0.0)
    require(torch.equal(torch.isnan(got), nan)
            and _same_bits(g[:, :n + 1], r[:, :n + 1])
            and torch.equal(g[:, n + 1], r[:, n + 1]),
            f"{_variant(args[0], compact)} {tuple(args[0].shape)} on NaN "
            f"values and negative weights: kernel != plain at "
            f"{(g != r).nonzero()[:5].tolist()}")


def check_uniform(args, integer: bool, got=None) -> float:
    """B3 against its plain version on the same `args`: on integer rows,
    tie-free or tied, bitwise but where the plain version's quantile is
    -0: B3 skips the [min, max] clamp (ROADMAP C1), so where the plain
    version clamps a zero quantile to a -0 bound B3 reads +0 (C12), and
    must read a zero there; on gamma rows within one ulp (the
    interpolation can round one ulp past the top point, which the clamp
    pulls back).  `got`: a main-path output to hold to the same rule
    instead of a new launch.  Returns the largest absolute difference;
    raises when they disagree."""
    import torch
    from veneur_tpu_torch.ops import sorted_eval as se
    if got is None:
        got = se.uniform_eval(*args)
    ref = se.uniform_eval_plain(*args)
    torch.cuda.synchronize()
    diff = (got - ref).abs()
    if integer:
        neg0 = (ref == 0) & torch.signbit(ref)
        ok = (_same_bits(got.masked_fill(neg0, 0.0),
                         ref.masked_fill(neg0, 0.0))
              and bool((got[neg0] == 0).all()))
    else:
        ulp = torch.nextafter(ref.abs(), torch.tensor(
            float("inf"), device=ref.device)) - ref.abs()
        ok = bool((diff <= ulp).all())
    if not ok:
        bad = (got.view(torch.int32) != ref.view(torch.int32)).nonzero()
        raise AssertionError(
            f"uniform_eval {tuple(args[0].shape)} integer={integer}: "
            f"kernel != plain at {bad[:5].tolist()} (max |diff| "
            f"{float(diff.max())})")
    return float(diff.max())


def b5_checks(us, mds, gen, dev, err: dict) -> None:
    """B5 (both variants) against its plain version (check_moments:
    t-grid rows bitwise, gamma rows within the C_REORDER bound): at k =
    MOMENTS_K at every U x D of the grid; at k = 2 and 16 at every D of
    the grid and B5_ODD_DS, and at k = 8 on B5_ODD_DS (4096 rows); then
    a row's bits alone (its own launch) and inside a 300-row batch, and
    rows that start off a 16-byte boundary (the kernel's 4-byte load
    path) against the same rows aligned.  Raises `err` per variant."""
    import torch
    from veneur_tpu_torch.ops import moments_eval as me
    worst_ratio = 0.0
    for u in us:
        for d in mds:
            for grid in (True, False):
                for depth in (False, True):
                    diff, ratio = check_moments(
                        moment_rows(u, d, gen, dev, grid, depth), grid)
                    name = "moments_sums_depth" if depth else "moments_sums"
                    err[name] = max(err[name], diff)
                    worst_ratio = max(worst_ratio, ratio)
        log(f"B5 == plain at U={u} D={d} for D in {mds} (t-grid bitwise, "
            f"gamma within {C_REORDER} D 2^-24 sum|w|)")
    odd = tuple(d for d in B5_ODD_DS if d not in mds)
    for k, kds in ((2, mds + odd), (8, B5_ODD_DS), (16, mds + odd)):
        for d in kds:
            for grid in (True, False):
                for depth in (False, True):
                    _, ratio = check_moments(
                        moment_rows(4096, d, gen, dev, grid, depth), grid, k)
                    worst_ratio = max(worst_ratio, ratio)
    log(f"B5 == plain at k = 2 and 16 (4096 x D for D in {mds + odd}) and "
        f"k = 8 (D in {B5_ODD_DS}); largest gamma difference "
        f"{worst_ratio:.4f} of its bound")
    for d in (3, 64, 512):
        for depth in (False, True):
            dv, dw, ab, lab, _ = moment_rows(300, d, gen, dev, False, depth)
            with _not_counted():
                batch = me.moments_sums(dv, dw, ab, lab, MOMENTS_K, depth)
                for i in (0, 1, 150, 299):
                    one = me.moments_sums(
                        dv[i:i + 1], dw[i:i + 1],
                        ab[:, i:i + 1].contiguous(),
                        lab[:, i:i + 1].contiguous(), MOMENTS_K, depth)
                    require(_same_bits(one[0], batch[i]),
                            f"B5 row {i} of 300 x {d} (depth={depth}) "
                            f"alone != in its batch")
                # the same values one float off a 16-byte boundary
                store = torch.empty(dv.numel() + 1, device=dev)
                store[1:] = dv.reshape(-1)
                off = store[1:].view(dv.shape)
                require(off.data_ptr() % 16 != 0, "offset view aligned")
                require(_same_bits(me.moments_sums(off, dw, ab, lab,
                                                   MOMENTS_K, depth), batch),
                        f"B5 300 x {d} (depth={depth}): unaligned rows != "
                        f"aligned rows")
    log("B5: a row alone == the row in a 300-row batch, and unaligned "
        "rows == aligned rows, bitwise (D in (3, 64, 512), both variants)")


def phase_kernels(us=(1, 100, 4096, 16384, 131072),
                  ds=(2, 4, 8, 64, 512, 1024),
                  mds=(1, 2, 3, 4, 8, 16, 32, 64, 128, 256, 512),
                  cds=(2, 4, 8, 16, 32, 64),
                  bds=(128, 256, 512, 1024),
                  uds=(2, 4, 8, 16, 32, 64, 128, 256, 512, 1024),
                  tus=(1, 100, 4096, 131072), tds=(2, 64, 128, 512, 1024),
                  seed=0) -> dict:
    """Each kernel against its plain version on the card at every U x D
    (the grids hold the main path's shapes: B3 at 131072 x 8, B1 at
    131072 x 64 and 16384 x 512, B5 at 131072 x 64, B4 at 131072 x 64,
    B1 on bf16 values at 16384 x 512, B3 on bf16 values at 131072 x
    8).  B5's grid holds every depth a flush can give it (the dense
    build pads D to a power of two from 2 to DENSE_DEPTH_CAP = 512), so
    every lane-group size G = min(32, D / 16) of the kernel and both
    output paths, and two odd depths (b5_checks adds the orders 2 and
    16, B5_ODD_DS and the batch and alignment checks); B4's every depth it takes (`cds`), B1's bf16 variant the
    depths digest_eval gives it (`bds`, D > 64), B3's bf16 variant
    every depth (`uds`).  Integer (B5: t-grid) and gamma rows.  Then B1
    (both value types) on tied_rows at every `tus` x `tds` (U = 1
    leaves the last CTA part-filled at every depth, U = 100 at all but
    D = 1024), B1 on odd_weight_rows at every `tds` and B4 at every
    `cds`, and B3 (both value types) on tied_depth_rows at every `tus`
    x `uds`.  Returns the largest absolute difference seen per
    kernel."""
    import torch
    from veneur_tpu_torch.ops import sorted_eval as se
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    err = {name: 0.0 for name in KERNEL_SOURCE}
    b5_checks(us, mds, gen, dev, err)
    for u in us:
        for d in ds:
            for integer in (True, False):
                diffs = (check_weighted(
                    weighted_rows(u, d, gen, dev, integer), integer),
                    check_uniform(
                        depth_rows(u, d, gen, dev, integer), integer))
                for name, diff in zip(("weighted_eval", "uniform_eval"),
                                      diffs):
                    err[name] = max(err[name], diff)
            log(f"kernels == plain at U={u} D={d} (integer bitwise, "
                f"gamma within tolerance)")
    for u in us:
        for integer in (True, False):
            for d in cds:
                err["weighted_eval_compact"] = max(
                    err["weighted_eval_compact"], check_weighted(
                        compact_rows(u, d, gen, dev, integer), integer,
                        compact=True))
            for d in bds:
                err["weighted_eval_bf16"] = max(
                    err["weighted_eval_bf16"], check_weighted(
                        bf16_weighted_rows(u, d, gen, dev, integer),
                        integer))
            for d in uds:
                err["uniform_eval_bf16"] = max(
                    err["uniform_eval_bf16"], check_uniform(
                        bf16_depth_rows(u, d, gen, dev, integer), integer))
        log(f"bf16 kernels == plain at U={u}: B4 at D in {cds} (integer "
            f"rows with ties and +-0 bitwise, gamma quantiles and totals "
            f"bitwise), B1 at D in {bds} and B3 at D in {uds} on bf16 "
            f"values (integer bitwise, gamma within tolerance)")
    for u in tus:
        for d in tds:
            for bf16 in (False, True):
                for integer in (True, False):
                    name = "weighted_eval_bf16" if bf16 else "weighted_eval"
                    err[name] = max(err[name], check_weighted(
                        tied_rows(u, d, gen, dev, bf16, integer), integer))
        log(f"B1 (f32, bf16) == plain at U={u} for D in {tds} on tied "
            f"integer rows with +-0 and tied gamma rows, the edge rows "
            f"and 33 percentiles (quantiles and totals bitwise)")
    for d in tds:
        check_odd_weights(odd_weight_rows(4096, d, gen, dev))
    log(f"B1 == plain on rows with NaN values and negative weights at "
        f"U=4096 for D in {tds} (NaN alike, else bitwise)")
    for d in cds:
        check_odd_weights(odd_weight_rows(4096, d, gen, dev, bf16=True),
                          compact=True)
    log(f"B4 == plain on rows with NaN values and negative weights at "
        f"U=4096 for D in {cds} (NaN alike, else bitwise)")
    for u in tus:
        for d in uds:
            for bf16 in (False, True):
                name = "uniform_eval_bf16" if bf16 else "uniform_eval"
                err[name] = max(err[name], check_uniform(
                    tied_depth_rows(u, d, gen, dev, bf16), True))
        log(f"B3 (f32, bf16) == plain at U={u} for D in {uds} on tied "
            f"integer rows with +-0, depths 0..D and 33 percentiles "
            f"(bitwise, but +0 where the plain version clamps to -0: C12)")
    # no percentiles: B1 still writes each row's total and sum
    m, w, dmin, dmax, pct = weighted_rows(100, 64, gen, dev)
    got = se.weighted_eval(m, w, dmin, dmax, pct[:0])
    ref = se.weighted_eval_plain(m, w, dmin, dmax, pct[:0])
    require(got.shape == (100, 2) and torch.equal(got, ref),
            "weighted_eval with no percentiles != plain")
    check_weighted(compact_rows(100, 64, gen, dev)[:4] + (pct[:0],), True,
                   compact=True)
    m, depths, pct = depth_rows(100, 8, gen, dev)
    require(se.uniform_eval(m, depths, pct[:0]).shape == (100, 0),
            "uniform_eval with no percentiles: wrong shape")
    torch.cuda.synchronize()
    log(f"kernel vs plain max |diff|: {err}")
    return err


def shared_key_rows(u, cap, levels, gen, dev, rng):
    """B6 inputs whose carry and staging share keys at every level: each
    level staged full or nearly (n in [2cap - 3, 2cap], so every level
    promotes into the next), values drawn per row kind by index mod 3
    from 0 tied integers in [0, 4); 1 -0, +0, -1 and 1; 2 those and
    positive NaNs of several payloads and +inf, which the plain version
    sorts behind its +inf padding (6 in 10 staged items, so a full
    staging holds more than cap of them and some reach the carry).
    Coin offsets from plan_pass.  Returns (stage_v, stage_n, off)."""
    import torch
    from veneur_tpu_torch.sketches import compactor as cs
    s2 = 2 * cap
    n = rng.integers(s2 - 3, s2 + 1, (u, levels))
    off, _, _, _ = cs.plan_pass(n, rng.integers(0, 1 << 20, u),
                                np.zeros(u, np.int64), cs.DEFAULT_SEED, cap)
    shape = (u, levels, s2)
    kd = (torch.arange(u, device=dev) % 3)[:, None, None]
    ties = torch.randint(0, 4, shape, generator=gen, device=dev).float()
    zeros = torch.tensor([-0.0, 0.0, -1.0, 1.0], device=dev)[
        torch.randint(0, 4, shape, generator=gen, device=dev)]
    big = torch.tensor([0x7FC00000, 0x7F800001, 0x7FFFFFFF, 0x7F800000],
                       dtype=torch.int32, device=dev)[
        torch.randint(0, 4, shape, generator=gen, device=dev)]
    odd = torch.rand(shape, generator=gen, device=dev) < 0.6
    v = torch.where(kd == 0, ties, zeros)
    v = torch.where((kd == 2) & odd, big.view(torch.float32), v)
    nd = torch.from_numpy(n.astype(np.int32)).to(dev)
    v = torch.where(torch.arange(s2, device=dev) < nd[:, :, None], v,
                    float("inf"))
    return (v.contiguous(), nd.contiguous(),
            torch.from_numpy(off.astype(np.int32)).to(dev))


def first_fold_rows(u, cap, levels, gen, dev, rng):
    """A stand-in for the compactor flush's first B6 launch (the first
    fold round of fresh keys, each staging 512 samples: compactor_cells'
    local cell): level 0's staging full (2cap gamma(2, 20) + 10
    latencies), every other level empty, so level 0 promotes its lowest
    items into level 1 and the rest stay empty.  Returns (stage_v,
    stage_n, off)."""
    import torch
    from veneur_tpu_torch.sketches import compactor as cs
    s2 = 2 * cap
    n = np.zeros((u, levels), np.int64)
    n[:, 0] = s2
    off, _, _, _ = cs.plan_pass(n, rng.integers(0, 1 << 20, u),
                                np.zeros(u, np.int64), cs.DEFAULT_SEED, cap)
    v = torch.full((u, levels, s2), float("inf"), device=dev)
    v[:, 0] = _gamma2((u, s2), gen, dev, 20.0) + 10.0
    return (v.contiguous(), torch.from_numpy(n.astype(np.int32)).to(dev),
            torch.from_numpy(off.astype(np.int32)).to(dev))


def phase_b6(us=(1, 100, 4096, 16384), geometries=B6_GEOMETRIES,
             seed=0) -> float:
    """B6 against its plain version on the card, bitwise, at every U x
    (cap, levels), on compactor_rows' row kinds (empty levels, full
    staging with both clip rounds, tied integers, +-0, gamma) and on
    shared_key_rows (tied integers, +-0 and positive NaNs at every level,
    so carry and staging share keys); at U = 100 also against the host
    reference `compactor.apply_pass` (numpy float64) on compactor_rows:
    bitwise on rows without -0, and with -0 == +0 on the others (np.sort
    fixes no order between them).  Returns the largest absolute
    difference (0.0)."""
    import torch
    from veneur_tpu_torch.ops import compactor_eval as ce
    from veneur_tpu_torch.sketches import compactor as cs
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rng = np.random.default_rng(seed)
    err = 0.0
    for cap, levels in geometries:
        for u in us:
            args, cnt, clip = compactor_rows(u, cap, levels, gen, dev, rng)
            if u >= 2:
                require(int(clip.max()) == 2, "no row took both clip rounds")
            err = max(err, check_compact(args, cnt))
            err = max(err, check_compact(
                shared_key_rows(u, cap, levels, gen, dev, rng)))
            if u == 100:
                with _not_counted():
                    got = ce.compact_batch(*args).cpu().numpy()
                host = cs.apply_pass(args[0].cpu().double().numpy(),
                                     args[1].cpu().numpy(),
                                     args[2].cpu().numpy(),
                                     cap).astype(np.float32)
                no_neg0 = np.arange(u) % 6 != 3
                require(np.array_equal(got[no_neg0].view(np.int32),
                                       host[no_neg0].view(np.int32))
                        and np.array_equal(got, host),
                        f"compact_batch {cap}x{levels}: kernel != "
                        "apply_pass")
        log(f"B6 == plain bitwise at cap={cap} levels={levels} for U in "
            f"{us}, mixed and shared-key rows (and == apply_pass at "
            "U=100)")
    return err


def _lines_in(srv) -> int:
    """The lines a server has taken in: with the native engine the
    values its readers have parsed and published, which a flush's cut
    drains; with the Python readers the aggregator's count (which a
    flush resets)."""
    if srv.native is None:
        return srv.aggregator.processed
    return sum(v for _, _, v in srv.native.engine.thread_counts())


def _readers(srv) -> str:
    """The receive backend each native reader resolved, and the SIMD
    mode, once every reader has started."""
    deadline = time.monotonic() + 10
    while "none" in srv.native.stage_stats()["readers"].values():
        require(time.monotonic() < deadline, "a native reader never started")
        time.sleep(0.01)
    st = srv.native.stage_stats()
    return (f"readers {sorted(st['readers'].values())}, SIMD "
            f"{st['simd']}")


def _udp_send(addr, lines, srv, expect_total, counts=None):
    """Send DogStatsD lines in datagrams of <= 1400 bytes, waiting for
    the server to catch up (`_lines_in`) every few datagrams so none is
    dropped.  `counts[i]` is the number of metrics line i carries (a
    multi-value line `name:v1:v2|h` carries one a value; default 1)."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    buf, sent = [], 0
    n_of = (lambda i: 1) if counts is None else counts.__getitem__
    start = _lines_in(srv)

    def wait_for(n, timeout=60.0):
        deadline = time.time() + timeout
        while _lines_in(srv) - start < n:
            if time.time() > deadline:
                raise TimeoutError(
                    f"server processed {_lines_in(srv) - start}"
                    f" of {n} lines")
            time.sleep(0.002)

    size, dgrams, pending = 0, 0, 0
    for i, line in enumerate(lines):
        if size + len(line) + 1 > 1400:
            sock.sendto(b"\n".join(buf), addr)
            sent += pending
            buf, size, dgrams, pending = [], 0, dgrams + 1, 0
            if dgrams % 32 == 0:
                wait_for(sent)
        buf.append(line)
        size += len(line) + 1
        pending += n_of(i)
    if buf:
        sock.sendto(b"\n".join(buf), addr)
    sock.close()
    wait_for(expect_total)


def _slice_lines(rng) -> dict:
    """phase_slice's interval: ten t-digest histograms of 500 samples at
    weight 1 and a local-only one, a sampled counter, a global-only
    counter, a set, moments keys (`mom.*`, two past DENSE_DEPTH_CAP, one
    local-only, one sampled) and a gauge written in order; the lines
    shuffled but for the gauge.  Returns the lines and the samples the
    checks hold the output to."""
    lines, hist = [], {}
    # <= DENSE_DEPTH_CAP samples per key: deeper keys pre-reduce
    # into weighted centroids, and the local flush would be B1's
    for k in range(10):
        vals = rng.gamma(2.0, 20.0, 500)
        kind = "h" if k % 2 == 0 else "ms"
        hist[f"slice.lat{k}"] = vals
        lines += [b"slice.lat%d:%.4f|%s|#svc:web" % (k, v, kind.encode())
                  for v in vals]
    loc = rng.gamma(2.0, 20.0, 300)
    lines += [b"slice.loc:%.4f|h|#veneurlocalonly" % v for v in loc]
    hist = {k: np.asarray([float("%.4f" % x) for x in v])
            for k, v in hist.items()}
    loc = np.asarray([float("%.4f" % x) for x in loc])
    n_counter = 3000
    lines += [b"slice.hits:1|c|@0.5"] * n_counter        # weight 2
    lines += [b"slice.bytes:3|c|#veneurglobalonly"] * 500
    n_members = 2000
    lines += [b"slice.users:u%d|s" % i for i in range(n_members)]
    lines += [b"slice.users:u%d|s" % i for i in range(0, n_members, 7)]
    # moments keys: 2,400 and 2,000 samples (folded into the row's
    # ivec on the host past DENSE_DEPTH_CAP), four keys of 300
    # samples staged for B5, one of them sampled at rate 0.5
    mom = {"mom.lat": rng.gamma(2.0, 20.0, 2400),
           "mom.loc": rng.gamma(2.0, 20.0, 2000)}
    lines += [b"mom.lat:%.4f|h" % v for v in mom["mom.lat"]]
    lines += [b"mom.loc:%.4f|h|#veneurlocalonly" % v
              for v in mom["mom.loc"]]
    for i in range(4):
        vals = rng.gamma(2.0, 20.0, 300)
        mom[f"mom.s{i}"] = vals
        rate = b"|@0.5" if i == 0 else b""
        lines += [b"mom.s%d:%.4f|ms%s" % (i, v, rate) for v in vals]
    mom = {k: np.asarray([float("%.4f" % x) for x in v])
           for k, v in mom.items()}
    lines = [lines[i] for i in rng.permutation(len(lines))]
    # one reader keeps datagram order: the last gauge write wins
    lines += [b"slice.temp:%d|g" % i for i in range(10)]
    return {"lines": lines, "hist": hist, "loc": loc, "mom": mom,
            "n_counter": n_counter, "n_members": n_members}


def _check_slice(lm: dict, gm: dict, sl: dict) -> dict:
    """Hold a local's (`lm`) and a global's (`gm`) emitted values of
    `_slice_lines`' interval to numpy: counters and the gauge exact, the
    set within 4 HLL standard errors, histogram count/min/max exact on
    the local, global percentiles within 1% of numpy's Hazen, local-only
    percentiles (B3, no compression) within 1e-5, moments count/min/max
    exact and quantiles within MOMENTS_ENVELOPE of the span.  Returns
    the set estimate and the worst errors."""
    hist, loc, mom = sl["hist"], sl["loc"], sl["mom"]
    n_members = sl["n_members"]
    require(lm["slice.hits"] == 2 * sl["n_counter"], lm["slice.hits"])
    require(gm["slice.bytes"] == 1500, gm["slice.bytes"])
    require(lm["slice.temp"] == 9.0, lm["slice.temp"])
    est = gm["slice.users"]
    # 4 standard errors of HLL at precision 14 (1.04 / sqrt(2^14))
    require(abs(est - n_members) <= 4 * 1.04 / 128 * n_members, est)
    worst = 0.0
    for name, vals in hist.items():
        require(lm[f"{name}.count"] == len(vals), name)
        require(abs(lm[f"{name}.min"] - vals.min()) < 1e-3, name)
        require(abs(lm[f"{name}.max"] - vals.max()) < 1e-3, name)
        for p in PERCENTILES:
            want = np.percentile(vals, 100 * p, method="hazen")
            got = gm[f"{name}.{int(p * 100)}percentile"]
            rel = abs(got - want) / want
            worst = max(worst, rel)
            require(rel <= 0.01, (name, p, got, want))
    # no compression on the local: B3's quantiles are numpy's Hazen
    # percentiles of the f32 samples, up to f32 rounding
    require(not any(k.startswith("slice.loc") for k in gm),
            "a local-only histogram reached the global")
    for p in PERCENTILES:
        want = np.percentile(loc, 100 * p, method="hazen")
        got = lm[f"slice.loc.{int(p * 100)}percentile"]
        require(abs(got - want) <= 1e-5 * abs(want), (p, got, want))
    # moments: count/min/max exact on the local; quantiles within
    # the family's envelope of numpy's at >= 2,000 samples (the
    # local-only key on the local, the forwarded one on the global)
    for name, vals in mom.items():
        weight = 2.0 if name == "mom.s0" else 1.0
        require(lm[f"{name}.count"] == weight * len(vals), name)
        require(lm[f"{name}.min"] == vals.min(), name)
        require(lm[f"{name}.max"] == vals.max(), name)
    m_worst = 0.0
    for name, out in (("mom.lat", gm), ("mom.loc", lm)):
        vals = mom[name]
        span = vals.max() - vals.min()
        for p in PERCENTILES:
            err = abs(out[f"{name}.{int(p * 100)}percentile"]
                      - np.quantile(vals, p)) / span
            m_worst = max(m_worst, err)
            require(err < MOMENTS_ENVELOPE, (name, p, err))
    require(not any(k.startswith("mom.loc") for k in gm),
            "a local-only moments histogram reached the global")
    return {"est": est, "worst": worst, "m_worst": m_worst}


def phase_slice(seed=1):
    """A local and a global Server on the card, wired in-process, both
    with the moments rule `mom.*`; real DogStatsD datagrams over UDP to
    the local; local flush (B3, and B5's general variant for the
    moments keys, one of which is sampled) emits the percentiles of the
    local-only histograms and forwards the rest (digests and moments
    vectors) to the global, whose flush (B1, B5's depth variant over the
    imported vectors) emits their percentiles."""
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.core.server import Server
    from veneur_tpu_torch.ops import moments_eval as me
    from veneur_tpu_torch.ops import sorted_eval as se
    from veneur_tpu_torch.sinks.simple import ChannelMetricSink

    rng = np.random.default_rng(seed)
    gsink, lsink = ChannelMetricSink(), ChannelMetricSink()
    glob = Server(Config(percentiles=PERCENTILES, hostname="global",
                         sketch_family_rules=MOMENT_RULES),
                  extra_metric_sinks=[gsink], device=DEVICE)
    local = Server(
        Config(statsd_listen_addresses=["udp://127.0.0.1:0"],
               forward_address="in-process", percentiles=PERCENTILES,
               hostname="local", sketch_family_rules=MOMENT_RULES),
        extra_metric_sinks=[lsink], device=DEVICE,
        forwarder=glob.aggregator.import_metrics)
    caps = {}
    for tier, srv in (("local", local), ("global", glob)):
        caps[tier] = _Capture(srv.aggregator.moments_fn)
        srv.aggregator.moments_fn = caps[tier]
    local.start()
    try:
        addr = local.statsd_addrs[0][1]
        sl = _slice_lines(rng)
        _udp_send(addr, sl["lines"], local, len(sl["lines"]))

        se.reset_launches()
        me.reset_launches()
        local.flush()
        b3_local = se.launches["uniform_eval"]
        b5_local = me.launches["moments_sums"]
        # the forward runs on the local's forward pool: the global's
        # flush reads the imports once it has landed
        require(local.wait_forwards(60.0), "the in-process forward hung")
        glob.flush()
        b1_global = se.launches["weighted_eval"]
        b5_global = me.launches["moments_sums_depth"]
        require(min(b3_local, b5_local, b1_global, b5_global) >= 1,
                f"slice flush missed a kernel: B3 {b3_local} and B5 "
                f"{b5_local} on the local, B1 {b1_global} and B5 (depth "
                f"variant) {b5_global} on the global")
        # each tier's B5 launch (6 moments keys on the local, 5 on the
        # global) against its plain version on the same inputs
        for tier, nm in (("local", 6), ("global", 5)):
            caps[tier].check_against_plain(nm, f"slice {tier} moments")
        shapes = sorted(caps["local"].shapes | caps["global"].shapes)
        lm = {m.name: m.value for m in lsink.queue.get(timeout=5)}
        gm = {m.name: m.value for m in gsink.queue.get(timeout=5)}
        c = _check_slice(lm, gm, sl)
        log(f"slice over UDP: counters exact, set estimate {c['est']:.0f} "
            f"of {sl['n_members']}, histogram count/min/max exact on the "
            f"local, local-only percentiles (B3) equal to numpy hazen "
            f"within 1e-5, global percentiles within {c['worst']:.4%} of "
            f"it; moments count/min/max exact, quantiles within "
            f"{c['m_worst']:.4%} of the span of numpy's; launches B3 "
            f"local={b3_local} B5 local={b5_local} B1 global={b1_global} "
            f"B5 global={b5_global}; B5 == plain on the slice's own "
            f"inputs {shapes}")
    finally:
        local.shutdown()
        glob.shutdown()


def phase_slice_bf16(seed=4):
    """A local and a global Server with digest_bf16_staging, wired
    in-process, fed real DogStatsD datagrams over UDP, two intervals:

      A: 6 histogram keys x 500 samples at weight 1, two of them
         local-only: the local's uniform flush is B3 on bf16 values
         (D = 512); the forwarded digests (up to ~150 centroids each)
         take B1 on bf16 values at the global (D = 256).
      B: 6 keys x 40 samples, one at sample rate 0.5 (weight 2), two
         local-only: the local's general flush and the global's are B4
         (D = 64).

    Counts exact, sums exact up to float64 rounding, local-only
    percentiles within BF16_REL of numpy's Hazen percentile, forwarded
    ones within 1% (the t-digest bound after the hop) + BF16_REL; every
    bf16 launch of both tiers held to its plain version."""
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.core.server import Server
    from veneur_tpu_torch.ops import sorted_eval as se
    from veneur_tpu_torch.sinks.simple import ChannelMetricSink

    rng = np.random.default_rng(seed)
    aggs = ["min", "max", "count", "sum"]
    gsink, lsink = ChannelMetricSink(), ChannelMetricSink()
    glob = Server(Config(percentiles=PERCENTILES, hostname="global",
                         aggregates=aggs, digest_bf16_staging=True),
                  extra_metric_sinks=[gsink], device=DEVICE)
    local = Server(
        Config(statsd_listen_addresses=["udp://127.0.0.1:0"],
               forward_address="in-process", percentiles=PERCENTILES,
               hostname="local", aggregates=aggs, digest_bf16_staging=True),
        extra_metric_sinks=[lsink], device=DEVICE,
        forwarder=glob.aggregator.import_metrics)
    caps = {}
    for tier, srv in (("local", local), ("global", glob)):
        caps[tier] = srv.aggregator.flush_fn = _EvalCapture(
            srv.aggregator.flush_fn)
    local.start()
    try:
        addr = local.statsd_addrs[0][1]
        worst = {"local": 0.0, "global": 0.0}
        launched = {}
        for interval, n, sampled in (("A", 500, None), ("B", 40, 0)):
            lines, hist, weight = [], {}, {}
            for k in range(6):
                name = f"sb.{interval}{k}"
                vals = rng.gamma(2.0, 20.0, n)
                hist[name] = np.asarray([float("%.4f" % x) for x in vals])
                weight[name] = 2.0 if k == sampled else 1.0
                tail = (b"|#veneurlocalonly" if k >= 4 else
                        b"|@0.5" if k == sampled else b"")
                lines += [b"%s:%.4f|h%s" % (name.encode(), v, tail)
                          for v in vals]
            lines = [lines[i] for i in rng.permutation(len(lines))]
            _udp_send(addr, lines, local, len(lines))
            before = dict(se.launches)
            local.flush()
            lm = {m.name: m.value for m in lsink.queue.get(timeout=5)}
            mid = dict(se.launches)
            require(local.wait_forwards(60.0),
                    "the in-process forward hung")
            glob.flush()
            gm = {m.name: m.value for m in gsink.queue.get(timeout=5)}
            launched[interval] = {
                tier: {k: b[k] - a[k] for k in a if b[k] > a[k]}
                for tier, a, b in (("local", before, mid),
                                   ("global", mid, dict(se.launches)))}
            for cap in caps.values():
                cap.check_against_plain()
            for k, (name, vals) in enumerate(hist.items()):
                w = weight[name]
                require(lm[f"{name}.count"] == w * len(vals), name)
                require(abs(lm[f"{name}.sum"] - w * vals.sum())
                        <= 1e-12 * w * np.abs(vals).sum(), name)
                require(lm[f"{name}.min"] == vals.min(), name)
                require(lm[f"{name}.max"] == vals.max(), name)
                tier, out = ("local", lm) if k >= 4 else ("global", gm)
                rule = BF16_REL if k >= 4 else 0.01 + BF16_REL
                for p in PERCENTILES:
                    want = np.percentile(vals, 100 * p, method="hazen")
                    got = out[f"{name}.{int(p * 100)}percentile"]
                    rel = abs(got - want) / want
                    worst[tier] = max(worst[tier], rel)
                    require(rel <= rule + 1e-6, (name, p, got, want))
                if k >= 4:
                    require(not any(m.startswith(name) for m in gm),
                            f"{name} is local-only but reached the global")
        want = {"A": {"local": "uniform_eval_bf16",
                      "global": "weighted_eval_bf16"},
                "B": {"local": "weighted_eval_compact",
                      "global": "weighted_eval_compact"}}
        for interval, tiers in want.items():
            for tier, name in tiers.items():
                require(launched[interval][tier].get(name, 0) >= 1,
                        f"bf16 slice interval {interval}: the {tier} flush "
                        f"launched {launched[interval][tier]}, not {name}")
        shapes = sorted(caps["local"].shapes | caps["global"].shapes)
        log(f"bf16 slice over UDP: counts exact, sums within 1e-12, "
            f"local-only percentiles within {worst['local']:.4%} of numpy "
            f"hazen (rule {BF16_REL:.4%}), forwarded within "
            f"{worst['global']:.4%} (rule {0.01 + BF16_REL:.4%}); launches "
            f"{launched}; every bf16 launch == plain on its own inputs "
            f"{shapes}")
    finally:
        local.shutdown()
        glob.shutdown()


class _B6Capture:
    """Stands in for `compactor_eval.compact_batch` while entered and
    keeps each launch's inputs and output, so a check can hold every
    main-path B6 launch to its plain version, and relaunch it (not
    counted) on the same inputs.  Keeps the first launch at
    MAIN_SHAPE's shape for kernel_times."""

    main_args = None

    def __init__(self):
        from veneur_tpu_torch.ops import compactor_eval as ce
        self.ce, self.fn, self.calls = ce, ce.compact_batch, []
        self.shapes: set = set()
        self.checked = 0

    def __enter__(self):
        self.ce.compact_batch = self
        return self

    def __exit__(self, *exc):
        self.ce.compact_batch = self.fn

    def __call__(self, stage_v, stage_n, off):
        out = self.fn(stage_v, stage_n, off)
        args = (stage_v, stage_n, off)
        self.calls.append((args, out))
        if (_B6Capture.main_args is None
                and tuple(stage_v.shape) == MAIN_SHAPE["compact_batch"]):
            _B6Capture.main_args = args
        return out

    def check_against_plain(self) -> int:
        """Every kept launch: its output, and a relaunch on its inputs,
        bitwise equal to the plain version.  Returns the number of
        launches checked and forgets them."""
        n = len(self.calls)
        with _not_counted():
            for args, out in self.calls:
                for got in (out, self.fn(*args)):
                    check_compact(args, got=got)
                self.shapes.add(tuple(args[0].shape))
        self.checked += n
        self.calls = []
        return n


def _require_rank(got, srt, q, cap, levels, what, weight=1.0):
    """A quantile read off a ladder: its rank mass among the sorted
    samples `srt` of equal `weight` (the middle of the run of values
    equal to it) within the family's provable bound
    `rank_error_bound(mass)` of q * mass, plus one sample's weight for
    the half-open rank convention at ties (tests/test_compactor.py).
    Returns the error as a fraction of the mass."""
    from veneur_tpu_torch.sketches import compactor as cs
    mass = weight * len(srt)
    lo = np.searchsorted(srt, got, side="left")
    hi = np.searchsorted(srt, got, side="right")
    err = abs(weight * 0.5 * (lo + hi) - q * mass)
    bound = cs.rank_error_bound(mass, cap, levels) + weight
    require(err <= bound, f"{what}: q={q} value {got} rank error {err} > "
            f"{bound}")
    return err / mass


def phase_slice_compactor(seed=5):
    """A local and a global Server on the card with the compactor rule
    `c.*` beside t-digest keys and the moments rule, wired in-process,
    real DogStatsD datagrams over UDP to the local: the local's flush
    folds the compactor keys with B6 and forwards their ladders as wire
    vectors, which the global imports (host merge); raw compactor
    samples given to the global fold there too.  Checks: counts, min,
    max and sums exact; every compactor percentile within
    rank_error_bound of numpy's rank; the forwarded ladders' counts
    conserved at the global; every B6 launch bitwise its plain
    version."""
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.core.server import Server
    from veneur_tpu_torch.ops import compactor_eval as ce
    from veneur_tpu_torch.sketches import compactor as cs
    from veneur_tpu_torch.sinks.simple import ChannelMetricSink

    rng = np.random.default_rng(seed)
    rules = COMPACTOR_RULES + MOMENT_RULES
    aggs = ["min", "max", "count", "sum"]
    gsink, lsink = ChannelMetricSink(), ChannelMetricSink()
    sent = []
    # no ticker flush in the middle: the flushes are the phase's own
    glob = Server(Config(percentiles=PERCENTILES, aggregates=aggs,
                         hostname="global", sketch_family_rules=rules,
                         interval=3600.0),
                  extra_metric_sinks=[gsink], device=DEVICE)

    def forward(fms):
        sent.extend(fms)
        glob.aggregator.import_metrics(fms)

    local = Server(
        Config(statsd_listen_addresses=["udp://127.0.0.1:0"],
               forward_address="in-process", percentiles=PERCENTILES,
               aggregates=aggs, hostname="local",
               sketch_family_rules=rules, interval=3600.0),
        extra_metric_sinks=[lsink], device=DEVICE, forwarder=forward)
    local.start()
    cap, levels = cs.DEFAULT_CAP, cs.DEFAULT_LEVELS
    try:
        addr = local.statsd_addrs[0][1]
        # compactor keys: 60 samples (no compaction), up to 3,000
        # (four occupied levels); one local-only, one global-only, one
        # sampled at rate 0.5 (its items enter at level 1)
        sizes = {"c.lat0": 3000, "c.lat1": 700, "c.lat2": 200,
                 "c.lat3": 60, "c.loc": 2500, "c.glob": 900, "c.s": 400}
        suffix = {"c.loc": b"|#veneurlocalonly",
                  "c.glob": b"|#veneurglobalonly", "c.s": b"|@0.5"}
        vals = {k: np.asarray([float("%.4f" % x) for x in
                               rng.gamma(2.0, 20.0, n)])
                for k, n in sizes.items()}
        lines, order = [], []
        for k, v in vals.items():
            for x in v:
                lines.append(b"%s:%.4f|h%s" % (k.encode(), x,
                                               suffix.get(k, b"")))
                order.append((k, x))
        d = [float("%.4f" % x) for x in rng.gamma(2.0, 20.0, 400)]
        lines += [b"t.lat:%.4f|ms" % x for x in d]
        order += [("t.lat", x) for x in d]
        m = [float("%.4f" % x) for x in rng.gamma(2.0, 20.0, 300)]
        lines += [b"mom.x:%.4f|h" % x for x in m]
        order += [("mom.x", x) for x in m]
        perm = rng.permutation(len(lines))
        lines = [lines[i] for i in perm]
        order = [order[i] for i in perm]
        _udp_send(addr, lines, local, len(lines))
        # raw samples at the global too: c.lat0 takes them beside its
        # imported ladder, c.g only these
        graw = {"c.lat0": rng.gamma(2.0, 20.0, 500),
                "c.g": rng.gamma(2.0, 20.0, 1200)}
        graw = {k: np.asarray([float("%.4f" % x) for x in v])
                for k, v in graw.items()}
        for k, v in graw.items():
            for x in v:
                glob.handle_metric_packet(b"%s:%.4f|h" % (k.encode(), x))

        with _B6Capture() as cap_b6:
            b6_before = ce.launches["compact_batch"]
            local.flush()
            b6_local = ce.launches["compact_batch"] - b6_before
            require(local.wait_forwards(60.0),
                    "the in-process forward hung")
            n_local = cap_b6.check_against_plain()
            glob.flush()
            b6_global = (ce.launches["compact_batch"] - b6_before
                         - b6_local)
            n_global = cap_b6.check_against_plain()
        require(min(b6_local, b6_global) >= 1,
                f"slice flush missed B6: local {b6_local}, global "
                f"{b6_global}")
        lm = {x.name: x.value for x in lsink.queue.get(timeout=5)}
        gm = {x.name: x.value for x in gsink.queue.get(timeout=5)}
        weight = {k: 2.0 if k == "c.s" else 1.0 for k in sizes}
        # exact sums, in the order the server added them
        sums = {}
        for k, x in order:
            if k in weight:
                sums[k] = sums.get(k, 0.0) + x * weight[k]
        for k, v in vals.items():
            out = gm if k == "c.glob" else lm
            require(out[f"{k}.count"] == weight[k] * len(v), k)
            require(out[f"{k}.min"] == v.min(), k)
            require(out[f"{k}.max"] == v.max(), k)
            require(out[f"{k}.sum"] == sums[k], (k, out[f"{k}.sum"],
                                                 sums[k]))
        require(not any(x.startswith("c.glob") for x in lm),
                "a global-only key was emitted on the local")
        require(not any(x.startswith("c.loc") for x in gm),
                "a local-only key reached the global")
        # forwarded ladders: counts conserved, as the vectors carry them
        ladders = {f.name: f.compactor for f in sent
                   if f.compactor is not None}
        require(set(ladders) == set(sizes) - {"c.loc"},
                f"forwarded ladders {sorted(ladders)}")
        for k, vec in ladders.items():
            require(vec[cs.IDX_COUNT] == weight[k] * len(vals[k]), k)
            require(vec[cs.IDX_MIN] == vals[k].min(), k)
        require(lm["t.lat.count"] == len(d) and lm["mom.x.count"] == len(m),
                "t-digest / moments counts")
        gcount = {"c.glob": len(vals["c.glob"]), "c.g": len(graw["c.g"])}
        for k, n in gcount.items():
            require(gm[f"{k}.count"] == n, (k, gm[f"{k}.count"], n))
        # percentiles: local-only on the local, the rest on the global
        worst = 0.0
        for k in list(sizes) + ["c.g"]:
            if k == "c.loc":
                data, out = vals[k], lm
            else:
                data = np.concatenate([vals.get(k, []), graw.get(k, [])])
                out = gm
            srt = np.sort(data)
            for p in PERCENTILES:
                worst = max(worst, _require_rank(
                    out[f"{k}.{int(p * 100)}percentile"], srt, p, cap,
                    levels, k, weight.get(k, 1.0)))
        log(f"compactor slice over UDP: counts, min, max and sums exact "
            f"on both tiers; ladders of {len(ladders)} keys forwarded and "
            f"imported with counts conserved; percentiles within the "
            f"provable rank bound (worst rank error {worst:.4%} of n); B6 "
            f"launches local={b6_local} global={b6_global}, each == plain "
            f"bitwise ({n_local + n_global} checked, shapes "
            f"{sorted(cap_b6.shapes)})")
    finally:
        local.shutdown()
        glob.shutdown()


def _midpoint_quantiles(vals, wts, qs):
    """Weighted midpoint-rule quantiles of each row in float64 (the
    Hazen convention for unit weights), clamped to the row's range:
    `[U, D]` values and positive weights, D >= 2 -> `[U, len(qs)]`.
    The target rank q * total is rounded to float32 as the kernels
    compute it: its rounding error times the slope between two
    neighbouring points is larger than the float32 rounding of the
    result when the points are far apart."""
    o = np.argsort(vals, axis=1, kind="stable")
    v = np.take_along_axis(vals, o, 1).astype(np.float64)
    w = np.take_along_axis(wts, o, 1).astype(np.float64)
    cum = np.cumsum(w, axis=1)
    cmid = cum - w / 2
    r = np.arange(v.shape[0])
    out = np.empty((v.shape[0], len(qs)))
    for j, q in enumerate(qs):
        tq = (np.float32(q) * cum[:, -1].astype(np.float32)).astype(
            np.float64)
        ii = np.clip((cmid < tq[:, None]).sum(axis=1), 1, v.shape[1] - 1)
        gap = cmid[r, ii] - cmid[r, ii - 1]
        t = (tq - cmid[r, ii - 1]) / np.where(gap > 0, gap, 1.0)
        t = np.where(gap > 0, np.clip(t, 0.0, 1.0), 0.0)
        out[:, j] = v[r, ii - 1] + (v[r, ii] - v[r, ii - 1]) * t
    return np.clip(out, v[:, :1], v[:, -1:])


def _require_quantiles(res, names, want, what):
    """Every name in `names` ([U, P]) was emitted, within 1e-5 relative
    (f32 evaluation against the float64 reference) of `want`."""
    got = {m.name: m.value for m in res.metrics}
    vals = np.asarray([[got.get(n, np.nan) for n in row] for row in names])
    bad = ~(np.abs(vals - want) <= 1e-5 * np.abs(want) + 1e-5)
    if bad.any():
        i, j = np.argwhere(bad)[0]
        raise AssertionError(f"{what}: {names[i][j]} = {vals[i, j]}, "
                             f"reference {want[i, j]} ({int(bad.sum())} "
                             f"of {bad.size} off)")


def _kernel_modules() -> tuple:
    """The port's kernel-wrapper modules, each with its `launches`
    counts and `reset_launches`."""
    from veneur_tpu_torch.ops import compactor_eval as ce
    from veneur_tpu_torch.ops import hll_estimate as he
    from veneur_tpu_torch.ops import moments_eval as me
    from veneur_tpu_torch.ops import quantile_eval as qe
    from veneur_tpu_torch.ops import segmented_reduce as sr
    from veneur_tpu_torch.ops import sort_variants as sv
    from veneur_tpu_torch.ops import sorted_eval as se
    return se, me, ce, sr, he, qe, sv


@contextlib.contextmanager
def _not_counted():
    """Kernel launches made inside are left out of the launch counts:
    a comparison with the plain version is not the main path."""
    saved = [(m.launches, dict(m.launches)) for m in _kernel_modules()]
    try:
        yield
    finally:
        for counts, before in saved:
            counts.update(before)


class _Capture:
    """Stands in for an aggregator's moments program and keeps the
    inputs and output of its last call, so a check can hold that call's
    B5 and the whole flush against B5's plain version."""

    def __init__(self, fn):
        self.fn, self.k, self.last = fn, fn.k, None
        self.shapes: set = set()

    def __call__(self, *args, events=None):
        out = self.fn(*args, events=events)
        self.last = (False, args, out)
        return out

    def depth_variant(self, *args, events=None):
        out = self.fn.depth_variant(*args, events=events)
        self.last = (True, args, out)
        return out

    def check_against_plain(self, nm: int, what: str) -> tuple:
        """The last flush on the card against its plain version: B5 on
        the flush's own inputs (its shape and variant) within
        check_moments' rule, then the flush's quantiles against the
        same flush with B5's plain version, every row within
        SOLVER_RULE of its span.  The kernel's relaunch here is not
        counted.  Returns the kernel flush's [nm, P+1] output and the
        worst quantile difference over the span."""
        import torch
        from veneur_tpu_torch.ops import moments_eval as me
        uniform, (dv, dw, ab, lab, imp, pct), out = self.last
        w = ((torch.arange(dv.shape[1], device=dv.device)[None, :]
              < dw[:, None]).float() if uniform else dw)
        with _not_counted():
            check_moments((dv, dw, ab, lab, w), grid=False, k=self.k)
        self.shapes.add(("depth" if uniform else "general",
                         *dv.shape))
        ref = me.solve_sums(me.moments_sums_plain(dv, dw, ab, lab, self.k,
                                                  uniform),
                            ab, lab, imp, pct, self.k)
        n_pct = pct.shape[0]
        span = (ab[1] - ab[0])[:nm, None]
        err = ((out[:nm, :n_pct] - ref[:nm, :n_pct]).abs()
               / span.clamp_min(1e-30))
        worst = float(err.max())
        if worst > SOLVER_RULE:
            i, j = np.unravel_index(int(err.argmax()), err.shape)
            raise AssertionError(
                f"{what}: row {i} quantile {j}: B5 flush {float(out[i, j])}"
                f", plain flush {float(ref[i, j])} ({worst:.2e} of the "
                f"span)")
        return out[:nm].cpu().numpy(), worst


class _EvalCapture:
    """Stands in for an aggregator's digest flush program and keeps the
    inputs and output of each call on bf16-staged values, so a check
    can hold the main path's B4, B1-on-bf16 and B3-on-bf16 launches to
    their plain versions."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []
        self.shapes: set = set()

    def __call__(self, dv, dw, minmax, pct):
        import torch
        out = self.fn(dv, dw, minmax, pct)
        if dv.dtype == torch.bfloat16:
            self.calls.append((False, (dv, dw, minmax[0], minmax[1], pct),
                               out))
        return out

    def depth_variant(self, dv, depths, pct):
        import torch
        out = self.fn.depth_variant(dv, depths, pct)
        if dv.dtype == torch.bfloat16:
            self.calls.append((True, (dv, depths, pct), out))
        return out

    def check_against_plain(self) -> list:
        """Each kept call's output, and a relaunch of its kernel on the
        same inputs (not counted), against the plain version by
        check_uniform's / check_weighted's rules for float rows (B4:
        quantiles and totals bitwise).  Returns the outputs and forgets
        the calls."""
        from veneur_tpu_torch.ops import sorted_eval as se
        outs = []
        for uniform, args, out in self.calls:
            with _not_counted():
                if uniform:
                    name = "uniform_eval_bf16"
                    for got in (out, None):
                        check_uniform(args, False, got=got)
                else:
                    compact = args[0].shape[1] <= se.MAX_COMPACT_DEPTH
                    name = _variant(args[0], compact)
                    for got in (out, None):
                        check_weighted(args, False, compact, got=got)
            self.shapes.add((name, *args[0].shape))
            outs.append(out)
        self.calls = []
        return outs


def _bf16(x: np.ndarray) -> np.ndarray:
    """float64 values as bf16 staging rounds them (through float32),
    back in float64."""
    import torch
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16).double().numpy()


def _moment_vectors(vals: np.ndarray, k: int = MOMENTS_K) -> np.ndarray:
    """Moments vectors `[n, M]` of the rows of `vals` `[n, m]` (weight
    1), folded in bulk with the port's host fold."""
    from veneur_tpu_torch.sketches import moments as mo
    n, m = vals.shape
    a, b = vals.min(axis=1), vals.max(axis=1)
    lab = mo.log_domain(a, b)
    raw, log = np.zeros((n, k + 1)), np.zeros((n, k + 1))
    flat = vals.ravel()
    mo.fold_values(raw, log, np.repeat(np.arange(n), m), flat,
                   np.ones_like(flat), (a, b), lab)
    vecs = np.zeros((n, mo.vector_len(k)))
    vecs[:, mo.IDX_COUNT] = m
    vecs[:, mo.IDX_MIN], vecs[:, mo.IDX_MAX] = a, b
    vecs[:, mo.IDX_SUM] = vals.sum(axis=1)
    vecs[:, mo.IDX_RSUM] = (1.0 / vals).sum(axis=1)
    vecs[:, mo.IDX_LOGN] = log[:, 0]
    vecs[:, mo.SUMS_OFF:mo.SUMS_OFF + k] = raw[:, 1:]
    vecs[:, mo.SUMS_OFF + k:] = log[:, 1:]
    return vecs


# timed flushes a full-size cell takes after its warm-up (3 until the
# egress phase joined the script; 1 keeps the run well inside its time
# limit)
FULL_SIZE_TIMED = 1


def _run_flushes(label, srv, refill, check, n_timed=FULL_SIZE_TIMED):
    """One warm-up and n_timed timed flushes of `srv`, each after
    refill(); prints the p50 flush and its segments."""
    refill()
    srv.flush()
    check(srv.last_flush)
    lat, segs = [], {}
    for _ in range(n_timed):
        refill()
        t0 = time.perf_counter()
        res = srv.flush()
        lat.append((time.perf_counter() - t0) * 1e3)
        check(res)
        for k, v in srv.aggregator.last_flush_segments.items():
            segs.setdefault(k, []).append(v)
    med = {k: float(np.median(v)) for k, v in segs.items()}
    if "c_fold_s" in med:
        # compactor: the fold (host staging and coin plan, then B6's
        # upload, launch and readback per round), the read-off's
        # operands, upload and dispatch, and its device time
        nan = float("nan")
        fold, io = med["c_fold_s"] * 1e3, med["c_io_s"] * 1e3
        family = (
            f"fold {fold:.1f} ms (host staging and plan {fold - io:.1f} "
            f"ms, B6 upload+launch+readback {io:.1f} ms, B6 kernel "
            f"{med.get('c_kernel_ms', nan):.3f} ms over "
            f"{med.get('c_launches', nan):.0f} launches), read-off "
            f"operands {(med['c_build_s'] - med['c_fold_s']) * 1e3:.1f} ms"
            f", read-off upload+dispatch {med['c_dispatch_s'] * 1e3:.1f} "
            f"ms, read-off device {med.get('c_readoff_ms', nan):.3f} ms; "
            f"{med['upload_bytes'] / 1e6:.1f} MB uploaded (the fold's "
            f"staging and the read-off's operands)")
    elif "m_build_s" in med:
        # moments: build (+ ivec conversion), upload + launch of B5 and
        # the solver's ops, their device times (CUDA events)
        nan = float("nan")
        solver_ms = med.get("m_solver_ms", nan)
        family = (
            f"build {med['m_build_s'] * 1e3:.1f} ms, upload+dispatch "
            f"{med['m_dispatch_s'] * 1e3:.1f} ms ("
            f"{med['upload_bytes'] / 1e6:.1f} MB), device "
            f"{med.get('m_device_s', nan) * 1e3:.1f} ms (B5 "
            f"{med.get('m_kernel_ms', nan):.3f} ms, solver "
            f"{solver_ms:.1f} ms = {solver_ms / np.median(lat):.1%} of "
            f"the flush)")
    elif "layout_s" in med:
        # meshed: the dense build, the placement of every device's
        # blocks and lanes, the program's device time (CUDA events on the
        # home device: B2 or B1, the lane reductions, the estimates)
        family = (
            f"build {med['build_s'] * 1e3:.1f} ms, layout "
            f"{med['layout_s'] * 1e3:.1f} ms ({med['upload_bytes'] / 1e6:.1f}"
            f" MB placed), dispatch {med['dispatch_s'] * 1e3:.1f} ms, "
            f"program {med.get('kernel_ms', float('nan')):.3f} ms (CUDA "
            f"events)")
    else:
        family = (
            f"build {med['build_s'] * 1e3:.1f} ms, upload "
            f"{med['upload_s'] * 1e3:.1f} ms ({med['upload_bytes'] / 1e6:.1f}"
            f" MB), kernel {med.get('kernel_ms', float('nan')):.3f} ms "
            f"(CUDA events)")
    card_log(
        f"{label}: flush p50 {np.median(lat):.1f} ms over {n_timed} "
        f"(min {min(lat):.1f}, max {max(lat):.1f}); segments p50: "
        f"snapshot {med['snapshot_s'] * 1e3:.1f} ms, {family}, "
        f"wait+readback "
        f"{med['readback_s'] * 1e3:.1f} ms, emit {med['emit_s'] * 1e3:.1f}"
        f" ms (digest export {med.get('export_s', 0.0) * 1e3:.1f} ms, "
        f"moments vector fold {med.get('m_export_s', 0.0) * 1e3:.1f} ms, "
        f"ladder vectors {med.get('c_export_s', 0.0) * 1e3:.1f} ms of "
        f"it); {len(res.metrics)} metrics, {len(res.forward)} forwarded")
    return {"label": label, "flush_ms_p50": float(np.median(lat)),
            "flush_ms": lat, **{f"{k}_p50": v for k, v in med.items()}}


def phase_full_size(seed=2, n_keys=100_000, deep_keys=16_384):
    """The north star's scale: 100k digests per interval at the global
    tier (B1, D=64), 100k keys x 8 samples at a local tier (B3, D=8),
    and one deep global flush (16,384 keys x 512 points, B1); then the
    same three with digest_bf16_staging (B4 at D=64, B3 and B1 on bf16
    values), and the moments cells."""
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.core.server import Server
    from veneur_tpu_torch.samplers import samplers as sm
    from veneur_tpu_torch.samplers.metric_key import MetricKey, MetricScope
    from veneur_tpu_torch.sinks.simple import BlackholeMetricSink

    rng = np.random.default_rng(seed)
    results = []
    n_q = len(PERCENTILES) + 1          # the flush's quantile columns

    def imported_digests(n_keys, n_points, prefix, bf16):
        means = np.sort(rng.gamma(2.0, 10.0, (n_keys, n_points)),
                        axis=1).astype(np.float32)
        if not bf16:
            # distinct float32 values in each row: B1's sort is not
            # stable, so two tied points could order their weights
            # either way
            for j in range(1, n_points):
                means[:, j] = np.maximum(means[:, j], np.nextafter(
                    means[:, j - 1], np.float32(np.inf)))
            means = means.astype(np.float64)
        elif n_points > 64:
            # B1 on bf16 values: distinct bf16 values in each row (for
            # positive values the bf16 bits order as the values do)
            import torch
            bits = torch.from_numpy(means).to(torch.bfloat16).view(
                torch.int16).numpy().astype(np.int64)
            step = np.arange(n_points)
            bits = np.maximum.accumulate(bits - step, axis=1) + step
            means = torch.from_numpy(bits.astype(np.int16)).view(
                torch.bfloat16).double().numpy()
        else:
            # B4 (stable): the staged values as they are, ties included
            means = _bf16(means)
        wts = rng.integers(1, 50, (n_keys, n_points)).astype(np.float64)
        fms = [sm.ForwardMetric(
            name=f"{prefix}.k{i}", tags=["az:a"], kind=sm.TYPE_HISTOGRAM,
            scope=MetricScope.MIXED, digest_means=means[i].tolist(),
            digest_weights=wts[i].tolist(), digest_min=float(means[i, 0]),
            digest_max=float(means[i, -1]),
            digest_sum=float((means[i] * wts[i]).sum()),
            digest_rsum=float((wts[i] / means[i]).sum()),
            digest_compression=100.0) for i in range(n_keys)]
        return means, wts, fms

    def global_run(n_keys, n_points, label, bf16=False):
        means, wts, fms = imported_digests(n_keys, n_points, label, bf16)
        srv = Server(Config(percentiles=PERCENTILES, hostname="g",
                            arena_initial_capacity=n_keys,
                            digest_bf16_staging=bf16),
                     extra_metric_sinks=[BlackholeMetricSink()],
                     device=DEVICE)
        cap = _EvalCapture(srv.aggregator.flush_fn)
        srv.aggregator.flush_fn = cap
        want = _midpoint_quantiles(means, wts, PERCENTILES)
        names = [[f"{label}.k{i}.{int(p * 100)}percentile"
                  for p in PERCENTILES] for i in range(n_keys)]

        def refill():
            for fm in fms:
                srv.aggregator.import_metric(fm)
            srv.aggregator.sync_staged(min_samples=1)

        def check(res):
            require(len(res.metrics) == n_keys * len(PERCENTILES),
                    len(res.metrics))
            vals = np.asarray([m.value for m in res.metrics])
            require(np.isfinite(vals).all(), "non-finite output")
            _require_quantiles(res, names, want, label)
            if bf16:
                out, = cap.check_against_plain()
                # the flush's totals are the imported weights, exactly
                require(np.array_equal(
                    np.sort(out[:n_keys, n_q].cpu().numpy()),
                    np.sort(wts.sum(axis=1))), f"{label}: totals")

        kernel = ("B4" if bf16 and n_points <= 64
                  else "B1 on bf16 values" if bf16 else "B1")
        out = _run_flushes(f"{'bf16 ' if bf16 else ''}global flush "
                           f"{n_keys} keys x {n_points} imported points "
                           f"({kernel})", srv, refill, check)
        srv.shutdown()
        return out

    def local_run(label, bf16=False, per=8):
        """A local tier: keys x `per` raw samples, staged in bulk;
        every 16th key is local-only, so the local emits its percentiles
        (B3's output) and forwards the rest."""
        local_only = np.arange(n_keys) % 16 == 0
        n_local = int(local_only.sum())
        forwarded = []
        srv = Server(Config(forward_address="in-process",
                            percentiles=PERCENTILES, hostname="l",
                            arena_initial_capacity=n_keys,
                            digest_bf16_staging=bf16),
                     extra_metric_sinks=[BlackholeMetricSink()],
                     forwarder=lambda fms: forwarded.append(len(fms)),
                     device=DEVICE)
        cap = _EvalCapture(srv.aggregator.flush_fn)
        srv.aggregator.flush_fn = cap
        digests = srv.aggregator.digests
        rows = np.asarray([digests.row_for(
            MetricKey(f"{label}.k{i}", sm.TYPE_HISTOGRAM, ""),
            MetricScope.LOCAL_ONLY if local_only[i] else MetricScope.MIXED,
            []) for i in range(n_keys)], np.int64)
        loc_names = [[f"{label}.k{i}.{int(p * 100)}percentile"
                      for p in PERCENTILES]
                     for i in np.nonzero(local_only)[0]]
        all_rows = np.repeat(rows, per)
        ones = np.ones(n_keys * per)
        state = {}

        def refill():
            vals = rng.gamma(2.0, 10.0, n_keys * per)
            state["vals"] = vals
            with srv.aggregator.lock:
                digests.sample_batch(all_rows, vals, ones)
                digests.touched[rows] = True
            srv.aggregator.sync_staged(min_samples=1)

        def check(res):
            m = {x.name: x.value for x in res.metrics
                 if x.name.startswith((f"{label}.k2.", f"{label}.k3."))}
            for i in (2, 3):
                v = state["vals"][i * per:(i + 1) * per]
                require(m[f"{label}.k{i}.count"] == per, i)
                require(abs(m[f"{label}.k{i}.min"] - v.min()) <= 1e-9, i)
                require(abs(m[f"{label}.k{i}.max"] - v.max()) <= 1e-9, i)
            require(len(res.forward) == n_keys - n_local, len(res.forward))
            require(len(res.metrics)
                    == 3 * n_keys + len(PERCENTILES) * n_local,
                    len(res.metrics))
            v = state["vals"].reshape(n_keys, per)[local_only]
            v = _bf16(v) if bf16 else v.astype(np.float32)
            _require_quantiles(res, loc_names, _midpoint_quantiles(
                v, np.ones_like(v), PERCENTILES), "local-only percentiles")
            if bf16:
                cap.check_against_plain()

        kernel = "B3 on bf16 values" if bf16 else "B3"
        out = _run_flushes(f"{'bf16 ' if bf16 else ''}local flush {n_keys} "
                           f"keys x {per} samples, {n_local} of them "
                           f"local-only ({kernel})", srv, refill, check)
        srv.shutdown()
        return out

    results.append(global_run(n_keys, 64, "g64"))
    results.append(local_run("l8"))
    results.append(global_run(deep_keys, 512, "g512"))
    results.append(global_run(n_keys, 64, "b64", bf16=True))
    results.append(local_run("lb8", bf16=True))
    results.append(global_run(deep_keys, 512, "b512", bf16=True))
    card_log("upload per flush: " + ", ".join(
        f"{r['label'].split(' (')[0]}: {r['upload_bytes_p50'] / 1e6:.1f} MB"
        for r in results))
    results += moments_cells(rng, n_keys)
    # one timed flush a compactor cell (each takes 6-11 s, and the
    # global one 22 s of host imports first) keeps the script's time
    results += compactor_cells(rng, n_timed=1)
    return results


def moments_cells(rng, n_keys, n_timed=FULL_SIZE_TIMED):
    """The moments family at the north star's scale.  Samples are
    latencies in ms, gamma(2, 20) + 10: the rows' dynamic range stays
    far below LOG_DOMAIN_RATIO, so no row sits at the log-domain gate,
    where a last-ulp difference would flip the domain.

      local 100k x 64: 100,000 keys x 64 raw samples at weight 1, every
        16th local-only: B5's depth variant at 131072 x 64; the local
        emits the local-only keys' quantiles and forwards the rest as
        moments vectors.
      global 100k x 64 weighted + imports: each (global-only) key takes
        one imported moments vector of 32 samples and 64 samples at
        sample rate 0.5: B5's general variant at 131072 x 64.

    Every key's quantiles are held to the same flush through B5's plain
    version on the card (SOLVER_RULE); counts are exact."""
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.core.server import Server
    from veneur_tpu_torch.samplers import samplers as sm
    from veneur_tpu_torch.samplers.metric_key import MetricKey, MetricScope
    from veneur_tpu_torch.sinks.simple import BlackholeMetricSink

    per, results = 64, []
    n_q = len(PERCENTILES) + 1

    def server(prefix, scope_of, local):
        srv = Server(Config(percentiles=PERCENTILES, hostname=prefix,
                            arena_initial_capacity=n_keys,
                            sketch_family_default="moments",
                            forward_address="in-process" if local else ""),
                     extra_metric_sinks=[BlackholeMetricSink()],
                     forwarder=(lambda fms: None) if local else None,
                     device=DEVICE)
        arena = srv.aggregator.moments
        rows = np.asarray([arena.row_for(
            MetricKey(f"{prefix}.k{i}", sm.TYPE_HISTOGRAM, ""), scope_of(i),
            []) for i in range(n_keys)], np.int64)
        # a fresh arena hands out rows 0, 1, ...: key i is dense row i
        require(np.array_equal(rows, np.arange(n_keys)), "row layout")
        cap = _Capture(srv.aggregator.moments_fn)
        srv.aggregator.moments_fn = cap
        return srv, arena, rows, cap

    def quantiles_of(res, names):
        got = {m.name: m.value for m in res.metrics}
        return np.asarray([[got[n] for n in row] for row in names])

    # local tier
    local_only = np.arange(n_keys) % 16 == 0
    n_local = int(local_only.sum())
    srv, arena, rows, cap = server(
        "m64", lambda i: (MetricScope.LOCAL_ONLY if i % 16 == 0
                          else MetricScope.MIXED), local=True)
    all_rows = np.repeat(rows, per)
    ones = np.ones(n_keys * per)
    loc_idx = np.nonzero(local_only)[0]
    loc_names = [[f"m64.k{i}.{int(p * 100)}percentile" for p in PERCENTILES]
                 for i in loc_idx]
    state = {"worst": 0.0}

    def refill():
        state["vals"] = rng.gamma(2.0, 20.0, n_keys * per) + 10.0
        with srv.aggregator.lock:
            arena.sample_batch(all_rows, state["vals"], ones)
            arena.touched[rows] = True
        srv.aggregator.sync_staged(min_samples=1)

    def check_local(res):
        out, worst = cap.check_against_plain(n_keys, "moments local")
        state["worst"] = max(state["worst"], worst)
        require(cap.last[0], "the local moments flush took the general "
                "variant")
        require(len(res.forward) == n_keys - n_local, len(res.forward))
        require(all(f.moments[0] == per for f in res.forward),
                "forwarded moments count")
        got = {m.name: m.value for m in res.metrics
               if m.name.endswith(".count")}
        require(len(got) == n_keys and set(got.values()) == {float(per)},
                "local counts")
        require(np.array_equal(quantiles_of(res, loc_names),
                               out[loc_idx, 1:n_q].astype(np.float64)),
                "emitted local-only quantiles != the flush's output")

    results.append(_run_flushes(
        f"moments local flush {n_keys} keys x {per} samples, {n_local} "
        f"local-only (B5 depth variant)", srv, refill, check_local,
        n_timed))
    results[-1]["solver_rule_worst"] = state["worst"]
    srv.shutdown()

    # global tier
    srv, arena, rows, cap = server("mg", lambda i: MetricScope.GLOBAL_ONLY,
                                   local=False)
    vecs = _moment_vectors(rng.gamma(2.0, 20.0, (n_keys, 32)) + 10.0)
    fms = [sm.ForwardMetric(name=f"mg.k{i}", tags=[], kind=sm.TYPE_HISTOGRAM,
                            scope=MetricScope.GLOBAL_ONLY,
                            moments=vecs[i].tolist()) for i in range(n_keys)]
    twos = np.full(n_keys * per, 2.0)
    all_rows = np.repeat(rows, per)
    names = [[f"mg.k{i}.{int(p * 100)}percentile" for p in PERCENTILES]
             for i in range(n_keys)]
    state = {"worst": 0.0}

    def refill_global():
        vals = rng.gamma(2.0, 20.0, (n_keys, per)) + 10.0
        state["min"] = np.minimum(vals.min(axis=1), vecs[:, 1])
        state["max"] = np.maximum(vals.max(axis=1), vecs[:, 2])
        require(srv.aggregator.import_metrics(fms) == (n_keys, 0),
                "moments imports")
        with srv.aggregator.lock:
            arena.sample_batch(all_rows, vals.ravel(), twos)
            arena.touched[rows] = True
        srv.aggregator.sync_staged(min_samples=1)

    def check_global(res):
        out, worst = cap.check_against_plain(n_keys, "moments global")
        state["worst"] = max(state["worst"], worst)
        require(not cap.last[0], "the global moments flush took the "
                "depth variant")
        got = {m.name: m.value for m in res.metrics}
        cnt = np.asarray([got[f"mg.k{i}.count"] for i in range(n_keys)])
        require(np.all(cnt == 32 + 2 * per), "global counts")
        require(np.array_equal(np.asarray([got[f"mg.k{i}.min"] for i in
                                           range(n_keys)]), state["min"]),
                "global min")
        require(np.array_equal(np.asarray([got[f"mg.k{i}.max"] for i in
                                           range(n_keys)]), state["max"]),
                "global max")
        require(np.array_equal(quantiles_of(res, names),
                               out[:, 1:n_q].astype(np.float64)),
                "emitted quantiles != the flush's output")

    results.append(_run_flushes(
        f"moments global flush {n_keys} keys x ({per} samples at weight 2"
        f" + 1 imported vector) (B5 general variant)", srv, refill_global,
        check_global, n_timed))
    results[-1]["solver_rule_worst"] = state["worst"]
    srv.shutdown()
    card_log(f"moments cells: B5 == plain on every flush's own inputs; "
             f"B5 flush within "
             f"{max(r['solver_rule_worst'] for r in results):.2e} of the "
             f"span of the plain-B5 flush (rule {SOLVER_RULE})")
    return results


def compactor_cells(rng, n_keys=16_384, per=512, n_timed=3):
    """The compactor family at its premium tier's scale (README "Sketch
    families"): 16,384 keys at the default geometry (cap 128, levels
    14).  Samples are latencies in ms, gamma(2, 20) + 10.

      local 16,384 x 512: 512 raw samples per key at weight 1, every
        16th key local-only; the flush folds them with B6 (rounds of
        [16384, 14, 256]), emits the local-only keys' quantiles and
        forwards the rest as ladder vectors.
      global 16,384 x (1 import + 512): each (global-only) key imports
        one wire ladder (the port's CompactorSketch over 4,096 samples;
        a pool of 64, reused), merged on the host, then takes 512
        samples, which the flush folds with B6 before the read-off.

    Every B6 launch is held bitwise to its plain version (and
    relaunched, uncounted); counts, min and max are exact; quantiles
    within the provable rank bound of numpy's rank."""
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.core.server import Server
    from veneur_tpu_torch.samplers import samplers as sm
    from veneur_tpu_torch.samplers.metric_key import MetricKey, MetricScope
    from veneur_tpu_torch.sinks.simple import BlackholeMetricSink
    from veneur_tpu_torch.sketches import compactor as cs

    cap, levels = cs.DEFAULT_CAP, cs.DEFAULT_LEVELS
    results = []
    state = {"worst": 0.0}

    def server(prefix, scope_of, local):
        srv = Server(Config(percentiles=PERCENTILES, hostname=prefix,
                            arena_initial_capacity=n_keys,
                            sketch_family_default="compactor",
                            forward_address="in-process" if local else ""),
                     extra_metric_sinks=[BlackholeMetricSink()],
                     forwarder=((lambda fms: state.__setitem__("fwd", fms))
                                if local else None),
                     device=DEVICE)
        arena = srv.aggregator.compactors
        rows = np.asarray([arena.row_for(
            MetricKey(f"{prefix}.k{i}", sm.TYPE_HISTOGRAM, ""), scope_of(i),
            []) for i in range(n_keys)], np.int64)
        require(np.array_equal(rows, np.arange(n_keys)), "row layout")
        return srv, arena, rows

    def column(got, prefix, suffix, idx):
        return np.asarray([got[f"{prefix}.k{i}{suffix}"] for i in idx])

    def ranks(got, prefix, idx, data, weight=1.0):
        for i, row in zip(idx, data):
            srt = np.sort(row)
            for p in PERCENTILES:
                state["worst"] = max(state["worst"], _require_rank(
                    got[f"{prefix}.k{i}.{int(p * 100)}percentile"], srt, p,
                    cap, levels, f"{prefix}.k{i}", weight))

    # local tier
    local_only = np.arange(n_keys) % 16 == 0
    n_local = int(local_only.sum())
    loc_idx = np.nonzero(local_only)[0]
    srv, arena, rows = server(
        "cl", lambda i: (MetricScope.LOCAL_ONLY if i % 16 == 0
                         else MetricScope.MIXED), local=True)
    all_rows = np.repeat(rows, per)
    ones = np.ones(n_keys * per)

    def refill():
        state["vals"] = rng.gamma(2.0, 20.0, n_keys * per) + 10.0
        with srv.aggregator.lock:
            arena.sample_batch(all_rows, state["vals"], ones)
            arena.touched[rows] = True
        srv.aggregator.sync_staged(min_samples=1)

    def check_local(res):
        n_b6 = cap_b6.check_against_plain()
        require(n_b6 >= 1, "the local compactor flush launched no B6")
        v = state["vals"].reshape(n_keys, per)
        got = {m.name: m.value for m in res.metrics}
        every = range(n_keys)
        require(np.all(column(got, "cl", ".count", every) == per),
                "local counts")
        require(np.array_equal(column(got, "cl", ".min", every),
                               v.min(axis=1)), "local min")
        require(np.array_equal(column(got, "cl", ".max", every),
                               v.max(axis=1)), "local max")
        require(srv.wait_forwards(60.0), "the in-process forward hung")
        fwd = {f.name: f.compactor for f in state["fwd"]}
        require(len(fwd) == n_keys - n_local, len(fwd))
        require(all(vec[cs.IDX_COUNT] == per for vec in fwd.values()),
                "forwarded ladder counts")
        # the folded ladders of a few keys against the host reference
        # (numpy, apply_pass) on the same f32-rounded samples
        for i in (1, 2, 17, n_keys - 1):
            ref = cs.CompactorSketch()
            ref.add_batch(v[i].astype(np.float32).astype(np.float64))
            require(np.array_equal(np.asarray(fwd[f"cl.k{i}"])[cs.IDX_COMPS:],
                                   ref.to_vector()[cs.IDX_COMPS:]),
                    f"cl.k{i}: ladder != the host reference's")
        ranks(got, "cl", loc_idx, v[loc_idx])

    with _B6Capture() as cap_b6:
        results.append(_run_flushes(
            f"compactor local flush {n_keys} keys x {per} samples, "
            f"{n_local} local-only (B6 fold + read-off)", srv, refill,
            check_local, n_timed))
    results[-1]["b6_checked"] = cap_b6.checked
    srv.shutdown()

    # global tier
    pool_vals = rng.gamma(2.0, 20.0, (64, 4096)) + 10.0
    pool = []
    for row in pool_vals:
        sk = cs.CompactorSketch()
        sk.add_batch(row)
        pool.append(sk.to_vector().tolist())
    srv, arena, rows = server("cg", lambda i: MetricScope.GLOBAL_ONLY,
                              local=False)
    fms = [sm.ForwardMetric(name=f"cg.k{i}", tags=[], kind=sm.TYPE_HISTOGRAM,
                            scope=MetricScope.GLOBAL_ONLY,
                            compactor=pool[i % 64]) for i in range(n_keys)]
    import_s = []

    def refill_global():
        state["vals"] = rng.gamma(2.0, 20.0, (n_keys, per)) + 10.0
        t0 = time.perf_counter()
        require(srv.aggregator.import_metrics(fms) == (n_keys, 0),
                "compactor imports")
        import_s.append(time.perf_counter() - t0)
        with srv.aggregator.lock:
            arena.sample_batch(all_rows, state["vals"].ravel(), ones)
            arena.touched[rows] = True
        srv.aggregator.sync_staged(min_samples=1)

    def check_global(res):
        n_b6 = cap_b6.check_against_plain()
        require(n_b6 >= 1, "the global compactor flush launched no B6")
        v = state["vals"]
        src = pool_vals[np.arange(n_keys) % 64]
        got = {m.name: m.value for m in res.metrics}
        every = range(n_keys)
        require(np.all(column(got, "cg", ".count", every) == 4096 + per),
                "global counts")
        require(np.array_equal(column(got, "cg", ".min", every),
                               np.minimum(src.min(axis=1), v.min(axis=1))),
                "global min")
        require(np.array_equal(column(got, "cg", ".max", every),
                               np.maximum(src.max(axis=1), v.max(axis=1))),
                "global max")
        idx = np.arange(0, n_keys, 64) + rng.integers(0, 64)
        ranks(got, "cg", idx, np.concatenate([src[idx], v[idx]], axis=1))

    with _B6Capture() as cap_b6:
        results.append(_run_flushes(
            f"compactor global flush {n_keys} keys x (1 imported ladder of "
            f"4096 samples + {per} samples) (host merge, B6 fold + "
            f"read-off)", srv, refill_global, check_global, n_timed))
    results[-1]["b6_checked"] = cap_b6.checked
    results[-1]["import_s"] = import_s
    srv.shutdown()
    card_log(f"compactor cells: every B6 launch == plain bitwise "
             f"({sum(r['b6_checked'] for r in results)} launches); "
             f"quantiles within the provable rank bound (worst "
             f"{state['worst']:.4%} of n); host merge of {n_keys} imported "
             f"ladders p50 {np.median(import_s) * 1e3:.1f} ms")
    return results


# ---------------------------------------------------------------------------
# Cubes and the live query plane (B7)
# ---------------------------------------------------------------------------

def seg_rows(u, c, g, gen, dev):
    """B7 inputs on the card: `[U, C]` float32 values of mixed
    magnitudes (normal times 10^[-3, 3], the adversarial values of
    tests/test_cubes.py, so any reassociation of a group's sum shows in
    its bits) and sorted int32 ids in [0, G), with every 7th group from
    the 4th left empty when G >= 16."""
    import torch
    e = torch.randint(-3, 4, (u, c), generator=gen, device=dev)
    vals = (torch.randn((u, c), generator=gen, device=dev)
            * torch.pow(10.0, e.float()))
    ids = torch.arange(g, device=dev)
    if g >= 16:
        ids = ids[ids % 7 != 3]
    pick = torch.randint(0, len(ids), (u,), generator=gen, device=dev)
    return vals, ids[pick].sort().values.to(torch.int32)


def check_segment_sums(vals, seg, g, got=None) -> float:
    """B7 (a relaunch, not counted, unless `got` is given) against its
    plain version on the same inputs: bitwise, signs of zero included.
    Returns the largest absolute difference (0.0)."""
    from veneur_tpu_torch.ops import segmented_reduce as sr
    if got is None:
        with _not_counted():
            got = sr.launch(vals, seg, g)
    ref = sr.segment_sums_plain(vals, seg, g)
    if not _same_bits(got, ref):
        diff = (got - ref).abs()
        i, j = np.unravel_index(int(diff.argmax()), diff.shape)
        raise AssertionError(
            f"segment_sums {tuple(vals.shape)} -> {g}: group {i} column "
            f"{j}: kernel {float(got[i, j])!r}, plain {float(ref[i, j])!r}")
    return float((got - ref).abs().max()) if got.numel() else 0.0


def phase_b7(us=(1, 8, 100, 4096, 16384, 131072),
             cs=(1, 20, 128, 129, 256), gs=(1, 16, 256, None),
             seed=0) -> float:
    """B7 against its plain version on the card, bitwise, at every
    U x C x G (G = None: G = U) with G <= U, on seg_rows' inputs (empty
    groups included; C = 129 takes the kernel's one-column-a-lane strips
    past C = 32, C = 128 and 256 four columns a lane), then on groups of
    sizes below, at, between and above multiples of the kernel's row
    batch (kRows = 16), empty ones and one group of 1,000 rows.
    Returns the largest absolute difference (0.0)."""
    import torch
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    err, n = 0.0, 0
    t0 = time.perf_counter()
    for u in us:
        for c in cs:
            for g in sorted({u if g is None else g for g in gs}):
                if g > u:
                    continue
                vals, seg = seg_rows(u, c, g, gen, dev)
                err = max(err, check_segment_sums(vals, seg, g))
                n += 1
    sizes = [15, 16, 17, 32, 33, 0, 1, 8, 0, 87, 1000]
    seg = torch.repeat_interleave(
        torch.arange(len(sizes), device=dev),
        torch.tensor(sizes, device=dev)).to(torch.int32)
    for c in (1, 20, 128, 129):
        vals = seg_rows(len(seg), c, 1, gen, dev)[0]
        err = max(err, check_segment_sums(vals, seg, len(sizes)))
        n += 1
    torch.cuda.synchronize()
    log(f"B7 == plain bitwise on {n} shapes: U in {us} x C in {cs} x G in "
        f"{{1, 16, 256, U}} (G <= U, empty groups included), and groups "
        f"of {sizes} rows at C in (1, 20, 128, 129) "
        f"({time.perf_counter() - t0:.1f} s)")
    return err


class _B7Capture:
    """Stands in for `segmented_reduce.launch` while entered and keeps
    each launch's inputs and output, so a check can hold every
    main-path B7 launch (and a relaunch, not counted) to its plain
    version.  Keeps the first launch at MAIN_SHAPE's shape for
    kernel_times."""

    main_args = None

    def __init__(self):
        from veneur_tpu_torch.ops import segmented_reduce as sr
        self.sr, self.fn, self.calls = sr, sr.launch, []

    def __enter__(self):
        self.sr.launch = self
        return self

    def __exit__(self, *exc):
        self.sr.launch = self.fn

    def __call__(self, vals, seg, g):
        out = self.fn(vals, seg, g)
        self.calls.append(((vals, seg, g), out))
        if (_B7Capture.main_args is None
                and (*vals.shape, g) == MAIN_SHAPE["segment_sums"]):
            _B7Capture.main_args = (vals, seg, g)
        return out

    def check_against_plain(self) -> list:
        """Every kept launch: its output and a relaunch on its inputs
        bitwise equal to the plain version.  Returns the shapes checked
        and forgets the launches."""
        shapes = []
        for (vals, seg, g), out in self.calls:
            check_segment_sums(vals, seg, g, got=out)
            check_segment_sums(vals, seg, g)
            shapes.append((*vals.shape, g))
        self.calls = []
        return shapes


def _http_json(port, query):
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/query?{query}",
                                timeout=60) as r:
        return json.loads(r.read())


def _hazen(vals, qs):
    return np.percentile(vals, [100 * q for q in qs], method="hazen")


def phase_slice_cubes(seed=6):
    """Cubes and the query plane over real UDP and a real HttpApi: a
    global Server with two (endpoint, region) cube dimensions (`cq.*`
    t-digest, `cqm.*` moments) and a 4-slot window ring takes integer
    samples over 12 groups x 5 hosts, flushes, and answers /query on
    127.0.0.1: a single key, the exact group-by, the coarsened moments
    group-by (B7), top=8&by=q99 and the ring's range form.  Counts are
    held exactly to a host oracle, t-digest percentiles to numpy's
    Hazen percentiles of the same samples, moments ones within
    MOMENTS_ENVELOPE of the span.  A second server's 8-group budget
    is smaller than the 12 groups: its overflow lands in the
    `veneur.cube.other` rows, and the answers reconcile with
    rollup_points == exact + overflowed."""
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.core.server import Server
    from veneur_tpu_torch.http_api import HttpApi
    from veneur_tpu_torch.ops import segmented_reduce as sr

    rng = np.random.default_rng(seed)
    groups = [(e, r) for e in range(4) for r in range(3)]
    # t-digest groups stay below DENSE_DEPTH_CAP (no pre-reduction, so
    # their quantiles are exact Hazen); moments groups fold past it
    per = {"cq.lat": 500, "cqm.load": 900}
    data = {(name, g): rng.integers(1, 2000, per[name]).astype(np.float64)
            for name in per for g in groups}
    single = rng.integers(1, 5000, 400).astype(np.float64)
    lines = [b"cq.single:%d|h" % v for v in single]
    for (name, (e, r)), vals in data.items():
        lines += [b"%s:%d|h|#endpoint:e%d,region:r%d,host:h%d"
                  % (name.encode(), v, e, r, i % 5)
                  for i, v in enumerate(vals)]
    lines = [lines[i] for i in rng.permutation(len(lines))]
    qs = (0.5, 0.99)

    def boot(budget):
        srv = Server(Config(
            statsd_listen_addresses=["udp://127.0.0.1:0"], interval=3600.0,
            percentiles=PERCENTILES, hostname="cube-slice",
            query_window_slots=4, cube_dimensions=CUBE_DIMS,
            cube_group_budget=budget, sketch_family_rules=CUBE_RULES),
            device=DEVICE)
        api = HttpApi(srv, "127.0.0.1:0")
        srv.start()
        api.start()
        srv.flush()     # an empty first cut: the ring's next slot has a span
        _udp_send(srv.statsd_addrs[0][1], lines, srv, len(lines))
        srv.flush()
        return srv, api

    srv, api = boot(64)
    try:
        port = api.address[1]
        with _B7Capture() as cap:
            got = _http_json(port, "name=cq.single&q=0.5,0.99&slots=1")
            require(got["count"] == len(single) and got["family"] == "tdigest",
                    got)
            for q, want in zip(qs, _hazen(single, qs)):
                require(abs(got["quantiles"][repr(q)] - want)
                        <= 1e-9 * want, (q, got["quantiles"], want))
            # the exact group-by: every group, exact counts, Hazen
            ex = _http_json(port, "name=cq.lat&group_by=endpoint,region"
                                  "&q=0.5,0.99&payload=0")
            require(ex["groups_total"] == 12 and not ex["coarsened"]
                    and ex["other"] is None, ex)
            for ent in ex["groups"]:
                g = (int(ent["group"]["endpoint"][1:]),
                     int(ent["group"]["region"][1:]))
                vals = data[("cq.lat", g)]
                require(ent["count"] == len(vals), ent)
                for q, want in zip(qs, _hazen(vals, qs)):
                    require(abs(ent["quantiles"][repr(q)] - want)
                            <= 1e-9 * want, (g, q, ent["quantiles"], want))
            # the coarsened moments group-by: one B7 launch
            co = _http_json(port, "name=cqm.load&group_by=endpoint"
                                  "&q=0.5,0.99")
            require(co["coarsened"] and co["groups_total"] == 4
                    and co["cube_groups_per_launch"] == 4, co)
            m_worst = 0.0
            for ent in co["groups"]:
                e = int(ent["group"]["endpoint"][1:])
                vals = np.concatenate([data[("cqm.load", (e, r))]
                                       for r in range(3)])
                require(ent["count"] == len(vals) and ent["min"] == vals.min()
                        and ent["max"] == vals.max(), ent)
                span = vals.max() - vals.min()
                for q in qs:
                    err = abs(ent["quantiles"][repr(q)]
                              - np.quantile(vals, q)) / span
                    m_worst = max(m_worst, err)
                    require(err < MOMENTS_ENVELOPE, (e, q, err))
            # top=8 by q99: the oracle's 8 largest Hazen q99s, in order
            top = _http_json(port, "name=cq.lat&group_by=endpoint,region"
                                   "&top=8&by=q99&payload=0")
            q99 = {g: _hazen(data[("cq.lat", g)], (0.99,))[0]
                   for g in groups}
            got_top = [q99[(int(x["group"]["endpoint"][1:]),
                            int(x["group"]["region"][1:]))]
                       for x in top["groups"]]
            require(got_top == sorted(q99.values(), reverse=True)[:8]
                    and top["groups_total"] == 12, (got_top, q99))
            # the ring's range form: both cuts fall in one bin
            rng_body = _http_json(port, f"name=cq.single&q=0.5&since="
                                        f"{time.time() - 30.0!r}&step=60")
            require(rng_body["range"] and rng_body["sources"] == ["ring"]
                    and sum(b["count"] for b in rng_body["series"])
                    == len(single), rng_body)
        shapes = cap.check_against_plain()
        require(len(shapes) >= 1, "the coarsened read launched no B7")
        require(srv.query.stats()["errors"] == 0, srv.query.stats())
    finally:
        api.stop()
        srv.shutdown()

    srv, api = boot(8)
    try:
        port = api.address[1]
        snap = srv.aggregator.cubes.snapshot()
        exact = other = 0.0
        for name in ("cq.lat", "cqm.load"):
            body = _http_json(port, f"name={name}&group_by=endpoint,region"
                                    f"&payload=0")
            require(body["groups_total"] == 8 and body["other"] is not None,
                    body)
            exact += sum(x["count"] for x in body["groups"])
            other += body["other"]["count"]
        require(snap["overflowed"] == other == 4 * sum(per.values())
                and snap["rollup_points"] == exact + other, (snap, exact,
                                                             other))
    finally:
        api.stop()
        srv.shutdown()
    log(f"cube slice over UDP and HTTP: single key and 12 exact groups "
        f"equal to numpy's Hazen percentiles, counts exact; coarsened "
        f"moments group-by (B7 {shapes}) within {m_worst:.4%} of the span "
        f"of numpy's; top=8 by q99 in the oracle's order; range form over "
        f"the ring; budget 8: other rows hold {other:.0f} = overflowed, "
        f"rollup_points {snap['rollup_points']} = exact {exact:.0f} + "
        f"other")


def cube_cell(seed=7, groups=4096, total_series=102_400, iters=25):
    """The group-by read at the shape of bench.py's `bench_cube_query`:
    `total_series` distinct t-digest series (`cq.load`, a `host:` tag
    under every sample) and as many moments series (`cqm.load`) in
    `groups` (endpoint, region) groups, 256 endpoints x 16 regions, all
    exact under a `groups` budget; one flush, then `iters` timed reads
    (after one warm-up) of the exact group-by (payload=0), and the two
    coarsened moments reads: group_by=endpoint (B7 at [4096, 20] ->
    256) and group_by=region (B7 at [4096, 20] -> 16, 256-row chains).
    Every main-path B7 launch and a relaunch are held bitwise to the
    plain version; the coarsened vectors to a host f64 merge of the
    exact groups' vectors (within 5e-4: the f32 sums) and their
    quantiles to the same solve of the merged vectors (SOLVER_RULE)."""
    import torch
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.core.server import Server
    from veneur_tpu_torch.ops import moments_eval as me
    from veneur_tpu_torch.samplers import samplers as sm
    from veneur_tpu_torch.samplers.metric_key import MetricScope, UDPMetric
    from veneur_tpu_torch.sketches import moments as mo

    srv = Server(Config(interval=3600.0, percentiles=PERCENTILES,
                        hostname="cube-cell", query_window_slots=4,
                        cube_dimensions=CUBE_DIMS, cube_group_budget=groups,
                        cube_seed=3, sketch_family_rules=CUBE_RULES),
                 device=DEVICE)
    rng = np.random.default_rng(seed)
    per = total_series // groups
    agg = srv.aggregator
    try:
        t0 = time.perf_counter()
        for name in ("cq.load", "cqm.load"):
            vals = rng.gamma(2.0, 10.0, groups * per)
            batch = []
            for i in range(groups):
                gt = [f"endpoint:e{i // 16}", f"region:r{i % 16}"]
                for j in range(per):
                    tags = sorted(gt + [f"host:h{j}"])
                    batch.append(UDPMetric(
                        name=name, type=sm.TYPE_HISTOGRAM,
                        joined_tags=",".join(tags),
                        value=float(vals[i * per + j]), tags=tags,
                        scope=MetricScope.GLOBAL_ONLY))
            for k in range(0, len(batch), 8192):
                agg.process_batch(batch[k:k + 8192])
        ingest_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        srv.flush()
        flush_ms = (time.perf_counter() - t0) * 1e3
        snap = agg.cubes.snapshot()
        require(snap["overflowed"] == 0 and snap["groups"] == 2 * groups,
                snap)

        def timed(q):
            t = time.perf_counter()
            code, body = srv.query.serve({k: [v] for k, v in q.items()})
            require(code == 200, body)
            return (time.perf_counter() - t) * 1e3, body

        reads = {
            "exact": {"name": "cq.load", "group_by": "endpoint,region",
                      "q": "0.5,0.99", "slots": "1", "payload": "0"},
            "endpoint": {"name": "cqm.load", "group_by": "endpoint",
                         "q": "0.5,0.99", "slots": "1"},
            "region": {"name": "cqm.load", "group_by": "region",
                       "q": "0.5,0.99", "slots": "1"}}
        lat, last = {}, {}
        with _B7Capture() as cap:
            for label, q in reads.items():
                timed(q)
                lat[label] = []
                for _ in range(iters):
                    dt, last[label] = timed(q)
                    lat[label].append(dt)
        n_b7 = len(cap.calls)
        shapes = sorted(set(cap.check_against_plain()))
        require(n_b7 == 2 * (iters + 1) and shapes == sorted(
            [(groups, 20, groups // 16), (groups, 20, 16)]), (n_b7, shapes))
        ex = last["exact"]
        require(ex["groups_total"] == groups and all(
            x["count"] == per for x in ex["groups"]), "exact read counts")
        # the fine groups' vectors, merged on the host in f64
        _, fine = timed({"name": "cqm.load", "group_by": "endpoint,region",
                         "slots": "1"})
        worst = {}
        for label, n_groups in (("endpoint", groups // 16), ("region", 16)):
            body = last[label]
            require(body["coarsened"] and body["groups_total"] == n_groups
                    and body["cube_groups_per_launch"] == n_groups, label)
            merged = {}
            for x in fine["groups"]:
                key = x["group"][label]
                v = np.asarray(x["payload"]["vector"])
                merged[key] = v if key not in merged else mo.merge_vectors(
                    merged[key][None, :], v[None, :])[0]
            vec_err = q_err = 0.0
            for x in body["groups"]:
                want = merged[x["group"][label]]
                got = np.asarray(x["payload"]["vector"])
                require(x["count"] == per * groups / n_groups
                        and got[mo.IDX_COUNT] == want[mo.IDX_COUNT]
                        and got[mo.IDX_MIN] == want[mo.IDX_MIN]
                        and got[mo.IDX_MAX] == want[mo.IDX_MAX], label)
                fin = np.isfinite(want)
                vec_err = max(vec_err, float(np.max(
                    np.abs(got[fin] - want[fin])
                    / np.maximum(np.abs(want[fin]), 1.0))))
                ref = me.quantiles_from_vectors(want[None, :], [0.5, 0.99],
                                                device=DEVICE)[0]
                span = want[mo.IDX_MAX] - want[mo.IDX_MIN]
                for q, r in zip((0.5, 0.99), ref):
                    q_err = max(q_err, abs(x["quantiles"][repr(q)] - r) / span)
            require(vec_err <= 5e-4 and q_err <= SOLVER_RULE,
                    (label, vec_err, q_err))
            worst[label] = (vec_err, q_err)
        torch.cuda.synchronize()
    finally:
        srv.shutdown()
    out = {"label": f"cube read {total_series} + {total_series} series, "
                    f"{groups} groups", "ingest_s": ingest_s,
           "flush_ms": flush_ms, "b7_launches": n_b7}
    for label, v in lat.items():
        out[f"{label}_p50_ms"] = float(np.percentile(v, 50))
        out[f"{label}_p99_ms"] = float(np.percentile(v, 99))
        out[f"{label}_ms"] = v
    card_log(
        f"{out['label']}: ingest {ingest_s:.1f} s, one flush {flush_ms:.1f}"
        f" ms; query p50/p99 over {iters} reads: exact group-by "
        f"{out['exact_p50_ms']:.2f}/{out['exact_p99_ms']:.2f} ms, "
        f"group_by=endpoint (B7 -> {groups // 16}) "
        f"{out['endpoint_p50_ms']:.2f}/{out['endpoint_p99_ms']:.2f} ms, "
        f"group_by=region (B7 -> 16) {out['region_p50_ms']:.2f}/"
        f"{out['region_p99_ms']:.2f} ms; {n_b7} B7 launches == plain "
        f"bitwise; coarsened vectors within "
        f"{max(v for v, _ in worst.values()):.2e} of the host merge, "
        f"quantiles within {max(q for _, q in worst.values()):.2e} of "
        f"its span")
    return out


def bound_segment_sums(u: int, c: int, g: int) -> tuple[float, str]:
    """B7's least time: the bytes it must move, vals and the ids read
    once and the sums written once, (U*C + U + G*C) * 4, over the memory
    rate, or its U*C adds over the f32 rate, the larger."""
    t_bytes = (u * c + u + g * c) * 4 / HBM_BYTES_PER_S * 1e3
    t_ops = u * c / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_times(err: dict) -> list[dict]:
    """Kernel, plain-version and bound times at the flush shapes of
    the full-size phase (and each kernel at the other's depth), on
    fresh seeded gamma inputs, each held against its plain version on
    those inputs before it is timed (the differences raise `err`)."""
    import torch
    from veneur_tpu_torch.ops import moments_eval as me
    from veneur_tpu_torch.ops import sorted_eval as se
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    out = []
    shapes = [("weighted_eval", 131072, 64), ("uniform_eval", 131072, 8),
              ("weighted_eval", 16384, 512), ("weighted_eval", 131072, 8),
              ("uniform_eval", 131072, 64),
              ("weighted_eval_compact", 131072, 64),
              ("uniform_eval_bf16", 131072, 8),
              ("weighted_eval_bf16", 16384, 512),
              ("weighted_eval_compact", 131072, 8)]
    weighted = {"weighted_eval": weighted_rows,
                "weighted_eval_bf16": bf16_weighted_rows,
                "weighted_eval_compact": compact_rows}
    depth = {"uniform_eval": depth_rows, "uniform_eval_bf16": bf16_depth_rows}
    for name, u, d in shapes:
        pct = torch.tensor([0.5] + PERCENTILES, device=dev)
        compact = name == "weighted_eval_compact"
        if name in weighted:
            args = weighted[name](u, d, gen, dev, integer=False)[:4] + (pct,)
            plain = se.weighted_eval_plain
            diff = check_weighted(args, integer=False, compact=compact)

            def kern(*a):
                return se.weighted_eval(*a, compact=compact)
        else:
            args = depth[name](u, d, gen, dev, integer=False)[:2] + (pct,)
            kern, plain = se.uniform_eval, se.uniform_eval_plain
            diff = check_uniform(args, integer=False)
        err[name] = max(err[name], diff)
        ms = cuda_ms(lambda: kern(*args))
        plain_ms = cuda_ms(lambda: plain(*args), 5)
        b_ms, b_by = bound(name, u, d, pct.shape[0])
        card_log(f"{name} U={u} D={d}: kernel {ms:.4f} ms, plain "
                 f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}), "
                 f"kernel at {b_ms / ms:.1%} of bound")
        out.append({"name": name, "shape": [u, d], "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": b_ms,
                    "bound_by": b_by})
    for name, u, d in (("moments_sums", 131072, 64),
                       ("moments_sums_depth", 131072, 64),
                       ("moments_sums", 16384, 512)):
        depth = name == "moments_sums_depth"
        rows = moment_rows(u, d, gen, dev, grid=False, depth=depth)
        diff, _ = check_moments(rows, grid=False)
        err[name] = max(err[name], diff)
        args = rows[:4] + (MOMENTS_K, depth)
        ms = cuda_ms(lambda: me.moments_sums(*args))
        plain_ms = cuda_ms(lambda: me.moments_sums_plain(*args), 5)
        b_ms, b_by = bound_moments(name, u, d, MOMENTS_K,
                                   int((rows[4] > 0).sum()))
        card_log(f"{name} U={u} D={d} k={MOMENTS_K}: kernel {ms:.4f} ms, "
                 f"plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}), "
                 f"kernel at {b_ms / ms:.1%} of bound")
        out.append({"name": name, "shape": [u, d], "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": b_ms,
                    "bound_by": b_by})
    # B6 on the main path's own first fold round (the local compactor
    # cell), then on compactor_rows' mixed rows at the same shape
    from veneur_tpu_torch.ops import compactor_eval as ce
    rng = np.random.default_rng(3)
    main = _B6Capture.main_args
    require(main is not None, "no main-path B6 launch at "
            f"{MAIN_SHAPE['compact_batch']} was kept")
    u, levels, s2 = MAIN_SHAPE["compact_batch"]
    mixed, _, _ = compactor_rows(u, s2 // 2, levels, gen, dev, rng)
    for what, args in (("main path", main), ("mixed rows", mixed)):
        err["compact_batch"] = max(err["compact_batch"],
                                   check_compact(args))
        ms = cuda_ms(lambda: ce.compact_batch(*args))
        plain_ms = cuda_ms(lambda: ce.compact_batch_plain(*args), 5)
        b_ms, b_by = bound_compact(args[1].cpu().numpy(), s2 // 2)
        card_log(f"compact_batch U={u} levels={levels} 2cap={s2} "
                 f"({what}): kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
                 f"bound {b_ms:.4f} ms ({b_by}), kernel at "
                 f"{b_ms / ms:.1%} of bound")
        out.append({"name": "compact_batch", "shape": [u, levels, s2],
                    "input": what, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by})
    return (out + b7_times(err, gen) + b2_b8_b9_times(err, gen)
            + harness_times(err, gen))


def b7_times(err: dict, gen) -> list[dict]:
    """B7 on the cube read's own group_by=endpoint launch, then on
    seg_rows' values at 131072 x 128 -> 1024, each held to its plain
    version first; `index_add_` (float atomics, so not bit-stable)
    computes the same sums as one PyTorch call: the library time."""
    import torch
    from veneur_tpu_torch.ops import segmented_reduce as sr
    dev = torch.device(DEVICE)
    out = []
    main = _B7Capture.main_args
    require(main is not None, "no main-path B7 launch at "
            f"{MAIN_SHAPE['segment_sums']} was kept")
    synth = (*seg_rows(131072, 128, 1024, gen, dev), 1024)
    for what, (vals, seg, g) in (("main path", main), ("synthetic", synth)):
        err["segment_sums"] = max(err["segment_sums"],
                                  check_segment_sums(vals, seg, g))
        u, c = vals.shape
        with _not_counted():
            ms = cuda_ms(lambda: sr.launch(vals, seg, g))
        plain_ms = cuda_ms(lambda: sr.segment_sums_plain(vals, seg, g), 5)
        lib_ms = cuda_ms(lambda: torch.zeros(
            (g, c), device=dev).index_add_(0, seg, vals))
        b_ms, b_by = bound_segment_sums(u, c, g)
        card_log(f"segment_sums U={u} C={c} G={g} ({what}): kernel "
                 f"{ms:.4f} ms, plain {plain_ms:.3f} ms, index_add_ "
                 f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), kernel "
                 f"at {b_ms / ms:.1%} of bound")
        out.append({"name": "segment_sums", "shape": [u, c, g],
                    "input": what, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms})
    return out


# ---------------------------------------------------------------------------
# B2 (the meshed flush's key-only network), B8 (HLL register moments),
# B9 (t-digest quantiles of centroid rows)
# ---------------------------------------------------------------------------

def unit_rows(u, d, gen, dev, integer=True):
    """B2 inputs: weighted_rows' values, edge rows and ~30% holes
    anywhere in the row, with every nonzero weight 1."""
    m, w, dmin, dmax, pct = weighted_rows(u, d, gen, dev, integer)
    return m, (w > 0).float().contiguous(), dmin, dmax, pct


def check_b2(args, integer: bool, got=None) -> float:
    """B2 against its plain version on the same `args`: on integer rows
    the quantile and total columns bitwise, signs of zero included (the
    output does not depend on how a key-only sort orders -0 and +0), and
    the sums by value (every sum exact; an all-zero sum's sign depends
    on the summation's start); on gamma rows the quantile and total
    columns bitwise (unit weights make every position exact and a tie
    in a key-only sort is one value) and the sums within 2 (d-1) 2^-24
    sum|m| of each other (each is within half that of the exact sum;
    the kernel adds in a scan's order, the plain version in
    torch.sum's).  A relaunch also holds B2 to B1's kernel on the same
    inputs, bitwise in every column (the same compares and the same
    scan: the contract of _tile_uniform).  `got`: a main-path output to
    hold instead of a new launch.  Returns the largest absolute
    difference; raises when they disagree."""
    import torch
    from veneur_tpu_torch.ops import sorted_eval as se
    with _not_counted():
        if got is None:
            got = se.weighted_eval(*args, uniform=True)
        b1 = se.weighted_eval(*args)
    ref = se.weighted_eval_uniform_plain(*args)
    torch.cuda.synchronize()
    diff = (got - ref).abs()
    n, d = args[4].shape[0], args[0].shape[1]
    if integer:
        ok = (_same_bits(got[:, :n + 1], ref[:, :n + 1])
              and torch.equal(got[:, n + 1], ref[:, n + 1]))
    else:
        tol = 2 * (d - 1) * 2.0 ** -24 * (args[0] * args[1]).abs().sum(
            dim=1)
        ok = (_same_bits(got[:, :n + 1], ref[:, :n + 1])
              and bool((diff[:, n + 1] <= tol).all()))
    ok = ok and _same_bits(got, b1)
    if not ok:
        bad = (diff > 0).nonzero()[:5].tolist()
        raise AssertionError(
            f"weighted_eval_uniform {tuple(args[0].shape)} integer="
            f"{integer}: kernel != plain or B1 at {bad} (max |diff| "
            f"{float(diff.max())}, B1 same bits {_same_bits(got, b1)})")
    return float(diff.max())


def phase_b2(us=(1, 100, 4096, 16384, 131072),
             ds=(2, 4, 8, 16, 32, 64, 128, 256, 512),
             tus=(1, 100, 4096, 131072), tds=(2, 64, 128, 512, 1024),
             seed=0) -> float:
    """B2 against its plain version (and B1's kernel) on the card at
    every U x D, integer and gamma rows, then on tied_rows' values with
    unit weights (ties, +-0, the edge rows, 33 percentiles) at every
    `tus` x `tds`.  Returns the largest absolute difference."""
    import torch
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    err = 0.0
    for u in us:
        for d in ds:
            for integer in (True, False):
                err = max(err, check_b2(unit_rows(u, d, gen, dev, integer),
                                        integer))
        log(f"B2 == plain at U={u} for D in {ds} (integer bitwise, gamma "
            f"quantiles and totals bitwise, sums within tolerance; "
            f"bitwise B1's kernel)")
    for u in tus:
        for d in tds:
            m, w, dmin, dmax, pct = tied_rows(u, d, gen, dev)
            err = max(err, check_b2((m, (w > 0).float(), dmin, dmax, pct),
                                    True))
        log(f"B2 == plain and B1's kernel at U={u} for D in {tds} on tied "
            f"integer unit rows with +-0 (quantiles and totals bitwise)")
    return err


def hll_rows(s, p, gen, dev):
    """B8 inputs: `[s, 2^p]` registers, each row a random fill of
    geometric ranks (rank r with probability 2^-r, as a hashed member
    sets it) over zeros; row 0 all zero, row 1 full."""
    import torch
    m = 1 << p
    u = torch.rand((s, m), generator=gen, device=dev).clamp_min(2.0 ** -60)
    rank = torch.ceil(-torch.log2(u)).clamp(1, 64 - p + 1)
    fill = torch.rand((s, 1), generator=gen, device=dev)
    keep = torch.rand((s, m), generator=gen, device=dev) < fill
    regs = torch.where(keep, rank, torch.zeros_like(rank)).to(torch.uint8)
    regs[0] = 0
    if s > 1:
        regs[1] = rank[1].to(torch.uint8)
    return regs.contiguous()


def check_b8(regs, got=None) -> float:
    """B8 against its plain version: zero counts exact, the sums of
    2^-r within rtol 1e-6 (the same powers of two added in another
    order; a row whose plain sum is 0, every register >= 150, must read
    0).  Returns the largest absolute difference."""
    import torch
    from veneur_tpu_torch.ops import hll_estimate as he
    if got is None:
        with _not_counted():
            got = he.register_moments(regs)
    ref = he.register_moments_plain(regs)
    torch.cuda.synchronize()
    zero = ref[:, 1] == 0
    rel = float(((got[:, 1] - ref[:, 1]).abs()
                 / torch.where(zero, 1.0, ref[:, 1])).max())
    same_zeros = torch.equal(got[:, 0], ref[:, 0])
    require(same_zeros and rel <= 1e-6
            and torch.equal(got[zero, 1], ref[zero, 1]),
            f"register_moments {tuple(regs.shape)}: zero counts "
            f"{'equal' if same_zeros else 'differ'}, sums off by "
            f"{rel:.3g} relative")
    return float((got - ref).abs().max())


def wide_register_rows(s, m, gen, dev, low=0):
    """B8 inputs outside what a hashed member sets: registers uniform in
    [low, 255], so rows of low = 0 mix 2^-r of every byte, and rows of
    low = 127 (150) sum only denormals (zeros)."""
    import torch
    return torch.randint(low, 256, (s, m), generator=gen, device=dev,
                         dtype=torch.int32).to(torch.uint8)


def phase_b8(ss=(1, 5, 16, 10000), ps=(11, 14), seed=0) -> float:
    """B8 against its plain version (check_b8) on geometric registers at
    every S x p; on registers across 0-255 (127-255: the denormal terms;
    150-255: sums of 0); on rows whose m is not a multiple of 16 (the
    byte path); on rows one byte past 16-byte alignment, which must
    also read bitwise as the aligned copy; and a row alone bitwise the
    same row inside the batch of 10,000."""
    import torch
    from veneur_tpu_torch.ops import hll_estimate as he
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    err = 0.0
    for s in ss:
        for p in ps:
            err = max(err, check_b8(hll_rows(s, p, gen, dev)))
    for low in (0, 127, 150):
        for s, m in ((16, 16384), (5, 2048), (3, 1000)):
            err = max(err, check_b8(wide_register_rows(s, m, gen, dev, low)))
    base = hll_rows(64, 14, gen, dev)
    for m in (1, 15, 17, 100, 1000, 16383):
        err = max(err, check_b8(base[:, :m].contiguous()))
    with _not_counted():
        for s, m in ((1, 16384), (64, 16384), (7, 2048), (3, 1000)):
            regs = base[:s, :m].contiguous()
            buf = torch.zeros(s * m + 16, dtype=torch.uint8, device=dev)
            view = buf[1:1 + s * m].view(s, m)
            view.copy_(regs)
            require(view.data_ptr() % 16 == 1, "B8: the view is aligned")
            got = he.register_moments(view)
            err = max(err, check_b8(view, got))
            require(_same_bits(got, he.register_moments(regs)),
                    f"B8 {s} x {m}: unaligned rows != aligned rows")
        big = hll_rows(10000, 14, gen, dev)
        batch = he.register_moments(big)
        err = max(err, check_b8(big, batch))
        for i in (0, 1, 4999, 9998, 9999):
            require(_same_bits(he.register_moments(big[i:i + 1]),
                               batch[i:i + 1]),
                    f"B8 row {i}: alone != in its batch of 10000")
    log(f"B8 == plain for S in {ss} x p in {ps}, on registers across "
        f"0-255, 127-255 and 150-255, at m in (1, 15, 17, 100, 1000, "
        f"16383) (zero counts exact, sums within rtol 1e-6); unaligned "
        f"rows bitwise aligned ones; rows alone bitwise their batch")
    return err


def centroid_rows(k, c, gen, dev, integer=True):
    """B9 inputs: per row n centroids (n uniform in [0, c], every third
    row sparse: 1..3 centroids, row 0 empty) with ascending means
    (distinct integers, or gamma floats) and integer weights 1..50,
    empty slots at the end; min/max just outside the means."""
    import torch
    n = torch.randint(0, c + 1, (k,), generator=gen, device=dev)
    sparse = torch.randint(1, 4, (k,), generator=gen, device=dev)
    n = torch.where(torch.arange(k, device=dev) % 3 == 1, sparse, n)
    n[0] = 0
    if integer:
        mean = torch.rand((k, c), generator=gen, device=dev).argsort(
            dim=1).float() * 3
    else:
        mean = _gamma2((k, c), gen, dev)
    col = torch.arange(c, device=dev)[None, :]
    occ = col < n[:, None]
    mean = torch.where(occ, mean, torch.full_like(mean, float("inf")))
    mean = mean.sort(dim=1).values
    mean = torch.where(occ, mean, torch.zeros_like(mean)).contiguous()
    weight = torch.randint(1, 51, (k, c), generator=gen, device=dev).float()
    weight = torch.where(occ, weight, torch.zeros_like(weight)).contiguous()
    inf = torch.tensor(float("inf"), device=dev)
    dmin = torch.where(occ, mean, inf).amin(dim=1) - 0.5
    dmax = torch.where(occ, mean, -inf).amax(dim=1) + 0.5
    qs = torch.tensor([0.0, 0.01, 0.5, 0.9, 0.99, 1.0], device=dev)
    return mean, weight, dmin.contiguous(), dmax.contiguous(), qs


def check_b9(args, got=None) -> float:
    """B9 against its plain version: bitwise (integer weights make every
    prefix sum exact, and both round each add, product and quotient on
    its own), NaN in the same places (empty rows).  Returns the largest
    absolute difference of the finite entries (0.0)."""
    import torch
    from veneur_tpu_torch.ops import quantile_eval as qe
    if got is None:
        with _not_counted():
            got = qe.quantile(*args)
    ref = qe.quantile_plain(*args)
    torch.cuda.synchronize()
    nan = torch.isnan(ref)
    same = (torch.equal(nan, torch.isnan(got))
            and _same_bits(torch.where(nan, 0.0, got),
                           torch.where(nan, 0.0, ref)))
    if not same:
        diff = (torch.where(nan, 0.0, got) - torch.where(nan, 0.0, ref))
        bad = (diff != 0).nonzero()[:5].tolist()
        raise AssertionError(f"quantile {tuple(args[0].shape)}: kernel != "
                             f"plain at {bad}")
    return 0.0


def sampled_centroid_rows(k, c, gen, dev):
    """B9 inputs with the weights a sampled DogStatsD line stages:
    centroid_rows' gamma rows with each integer weight over a rate of
    0.1, 0.3, 0.7 or 0.9, so the prefix sums round."""
    import torch
    mean, weight, dmin, dmax, qs = centroid_rows(k, c, gen, dev, False)
    rates = torch.tensor([0.1, 0.3, 0.7, 0.9], device=dev)
    rate = rates[torch.randint(0, 4, (k, c), generator=gen, device=dev)]
    return mean, (weight / rate).contiguous(), dmin, dmax, qs


def b9_prefix_bound(mean, weight, dmin, dmax):
    """Per row, the largest quantile difference two association orders
    of the prefix sums can make (tests/test_torch_quantile_eval.py
    `_prefix_bound`): each order is within (adds) 2^-24 W of the exact
    sums (W the row's total; C adds for the plain version's cumsum, m +
    6 for the kernel's lane scan), so they differ by delta = (C + m + 6)
    2^-24 W; a quantile's proportion then moves by 2 delta / w_i and its
    value by 2 delta span_i / w_i, twice that where the orders pick
    neighbouring centroids; plus 2 ulp of the row's range."""
    import torch
    k, c = mean.shape
    m = ((c + 31) // 32) | 1
    mean, weight = mean.double(), weight.double()
    n = (weight > 0).sum(1, keepdim=True)
    col = torch.arange(c, device=mean.device)[None, :]
    mid = 0.5 * (mean[:, :-1] + mean[:, 1:])
    up = torch.where(col < n - 1, torch.nn.functional.pad(mid, (0, 1)),
                     dmax.double()[:, None])
    lo = torch.where(col == 0, dmin.double()[:, None],
                     torch.nn.functional.pad(mid, (1, 0)))
    ratio = torch.where(col < n, (up - lo) / weight.clamp_min(1e-30), 0.0)
    delta = (c + m + 6) * 2.0 ** -24 * weight.sum(1)
    edge = torch.maximum(dmin.abs(), dmax.abs()).float()
    ulp = (torch.nextafter(edge, torch.full_like(edge, float("inf")))
           - edge).double()
    return 4 * delta * ratio.amax(1) + 2 * ulp


def check_b9_sampled(args) -> tuple[float, float]:
    """B9 on sampled weights against its plain version: NaN in the same
    places (empty rows), every other quantile within b9_prefix_bound of
    its row.  Returns (largest difference, largest share of its
    bound)."""
    import torch
    from veneur_tpu_torch.ops import quantile_eval as qe
    with _not_counted():
        got = qe.quantile(*args)
    ref = qe.quantile_plain(*args)
    torch.cuda.synchronize()
    nan = torch.isnan(ref)
    require(torch.equal(nan, torch.isnan(got)),
            f"quantile {tuple(args[0].shape)} sampled: NaN placement")
    bound = b9_prefix_bound(*args[:4])[:, None].expand_as(ref)[~nan]
    diff = (got.double() - ref.double())[~nan].abs()
    share = float((diff / bound).max()) if diff.numel() else 0.0
    require(share <= 1.0, f"quantile {tuple(args[0].shape)} sampled: "
                          f"{share:.3g} of the prefix-sum bound")
    return (float(diff.max()) if diff.numel() else 0.0), share


def phase_b9(ks=(1, 13, 4096, 131072), cs=(1, 3, 5, 31, 33, 152, 1024),
             seed=0) -> float:
    """B9 against its plain version (check_b9, bitwise) at every K x C
    up to the main path's 131072 x 152 entries (a wider C skips the
    largest K): C % 4 != 0 takes the kernel's 4-byte copies, C = 152
    and 1024 its 16-byte ones, and C = 1, 3, 5, 31, 33 leave the lanes'
    runs of columns ragged.  At each shape also sampled weights
    (check_b9_sampled: within the prefix sums' rounding bound)."""
    import torch
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    k_main, c_main = MAIN_SHAPE["quantile"]
    worst, share = (0.0, 0, 0), 0.0
    for c in cs:
        for k in ks:
            if k * c > k_main * c_main:
                continue
            for integer in (True, False):
                check_b9(centroid_rows(k, c, gen, dev, integer))
            diff, part = check_b9_sampled(sampled_centroid_rows(k, c, gen,
                                                                dev))
            worst, share = max(worst, (diff, k, c)), max(share, part)
    log(f"B9 == plain bitwise for K in {ks} x C in {cs} up to "
        f"{k_main} x {c_main} entries (integer and gamma means, integer "
        f"weights, empty and sparse rows)")
    log(f"B9 on sampled weights (integer / 0.1 .. 0.9) within the "
        f"prefix-sum bound of the plain version: largest difference "
        f"{worst[0]:.6g} at {worst[1]} x {worst[2]}, largest share of a "
        f"row's bound {share:.3g}")
    return 0.0


class _B2Capture:
    """Wraps `serving.digest_eval` while entered and keeps the inputs and
    output of each uniform (B2) call, so a check can hold the main
    path's own B2 launches to the plain version."""

    calls: list = []

    def __enter__(self):
        from veneur_tpu_torch.parallel import serving
        self._orig = orig = serving.digest_eval
        calls = self.calls = []

        def wrapped(dv, dw, d_min, d_max, pct, uniform=False):
            out = orig(dv, dw, d_min, d_max, pct, uniform=uniform)
            if uniform:
                calls.append(((dv, dw, d_min, d_max, pct), out))
            return out

        serving.digest_eval = wrapped
        return self

    def __exit__(self, *exc):
        from veneur_tpu_torch.parallel import serving
        serving.digest_eval = self._orig

    def check(self, integer: bool) -> set:
        """Every kept call against the plain version (check_b2's rules)
        and forget them; returns their shapes."""
        shapes = set()
        for args, out in self.calls:
            check_b2(args, integer, got=out)
            shapes.add(tuple(args[0].shape))
        require(shapes, "the meshed flush launched no B2")
        self.calls = []
        return shapes


def phase_slice_mesh(seed=8, mesh_devices=1):
    """The meshed flush over real UDP: a global Server with
    `mesh_devices` (1: one card) and an unmeshed port Server, fed the same
    datagrams (integer histogram samples at weight 1, so the meshed
    flush takes B2; `mom.*` histograms, which the meshed moments solve
    evaluates; counters whose totals pass 2^24; sets; gauges;
    unique-timeseries counting).  The meshed InterMetrics are held to
    numpy, and to the unmeshed server's: percentiles bitwise, counters
    exact, set estimates within rtol 1e-4 (float32 tensor estimator
    against the host's numpy one), unique-timeseries counts equal; the
    flush's own B2 launches to B2's plain version."""
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.core.server import Server
    from veneur_tpu_torch.ops import sorted_eval as se
    from veneur_tpu_torch.sinks.simple import ChannelMetricSink

    rng = np.random.default_rng(seed)
    hist = {f"mesh.lat{k}": rng.integers(0, 5000, 400) for k in range(12)}
    lines = [b"%s:%d|h" % (k.encode(), v) for k, vals in hist.items()
             for v in vals]
    # two counters: 6 x 3,000,000 = 18,000,000 > 2^24, and one sampled
    lines += [b"mesh.big:3000000|c"] * 6
    lines += [b"mesh.hits:1|c|@0.25"] * 400
    n_members = 3000
    lines += [b"mesh.users:u%d|s" % i for i in range(n_members)]
    lines += [b"mesh.users:u%d|s" % i for i in range(0, n_members, 5)]
    lines += [b"mesh.few:m%d|s" % i for i in range(7)]
    # moments keys: the meshed moments solve (MOMENT_RULES)
    mom = {f"mom.mesh{k}": rng.integers(1, 3000, 2500) for k in range(3)}
    lines += [b"%s:%d|h" % (k.encode(), v) for k, vals in mom.items()
              for v in vals]
    lines = [lines[i] for i in rng.permutation(len(lines))]
    lines += [b"mesh.temp:%d|g" % i for i in range(10)]
    out = {}
    for label, n_dev in (("meshed", mesh_devices), ("unmeshed", 0)):
        sink = ChannelMetricSink()
        srv = Server(Config(statsd_listen_addresses=["udp://127.0.0.1:0"],
                            percentiles=PERCENTILES, hostname="mesh",
                            count_unique_timeseries=True,
                            sketch_family_rules=MOMENT_RULES,
                            mesh_devices=n_dev),
                     extra_metric_sinks=[sink], device=DEVICE)
        srv.start()
        try:
            _udp_send(srv.statsd_addrs[0][1], lines, srv, len(lines))
            n_b2 = se.launches["weighted_eval_uniform"]
            with _B2Capture() as cap:
                srv.flush()
            if n_dev:
                require(se.launches["weighted_eval_uniform"] > n_b2,
                        "the meshed flush launched no B2")
                shapes = cap.check(integer=True)
            out[label] = ({m.name: m.value for m in
                           sink.queue.get(timeout=10)},
                          srv.last_flush.unique_ts)
        finally:
            srv.shutdown()
    mm, uts = out["meshed"]
    um, uuts = out["unmeshed"]
    require(set(mm) == set(um), sorted(set(mm) ^ set(um)))
    require(mm["mesh.big"] == 18_000_000.0, mm["mesh.big"])
    require(mm["mesh.hits"] == 1600.0, mm["mesh.hits"])
    require(mm["mesh.temp"] == 9.0, mm["mesh.temp"])
    require(mm["mesh.few"] == 7.0, mm["mesh.few"])
    est = mm["mesh.users"]
    require(abs(est - n_members) <= 4 * 1.04 / 128 * n_members, est)
    for name, vals in hist.items():
        require(mm[f"{name}.count"] == len(vals), name)
        require(mm[f"{name}.min"] == vals.min(), name)
        require(mm[f"{name}.max"] == vals.max(), name)
        for p in PERCENTILES:
            want = np.percentile(vals.astype(np.float32), 100 * p,
                                 method="hazen")
            got = mm[f"{name}.{int(p * 100)}percentile"]
            require(abs(got - want) <= 1e-6 * abs(want), (name, p, got,
                                                          want))
    for name, vals in mom.items():
        span = float(vals.max() - vals.min())
        require(mm[f"{name}.count"] == len(vals), name)
        for p in PERCENTILES:
            want = np.percentile(vals, 100 * p, method="hazen")
            got = mm[f"{name}.{int(p * 100)}percentile"]
            require(abs(got - want) <= MOMENTS_ENVELOPE * span,
                    (name, p, got, want))
    for k, v in um.items():
        if k in ("mesh.users", "mesh.few"):
            require(abs(mm[k] - v) <= 1e-4 * v, (k, mm[k], v))
        else:
            require(mm[k] == v, (k, mm[k], v))
    require(uts == uuts and uts is not None and uts >= 15, (uts, uuts))
    log(f"meshed slice over UDP (mesh_devices={mesh_devices}): counters "
        f"exact past 2^24, set estimate {est:.0f} of {n_members}, "
        f"percentiles equal "
        f"to numpy hazen and bitwise the unmeshed server's, unique "
        f"timeseries {uts} on both; moments quantiles within "
        f"{MOMENTS_ENVELOPE} of the span of numpy's and bitwise the "
        f"unmeshed server's; B2 == plain on the flush's own launches "
        f"{sorted(shapes)}")


def _grpc_pair(prefix, global_sinks, local_sinks, listen=(), **common):
    """A port global serving gRPC import on 127.0.0.1:0 and a port local
    (statsd on `listen`) forwarding to it over gRPC through its own
    ForwardClient, both configured with `common` and no ticker flush in
    the phase's way."""
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.core.server import Server

    common = dict(percentiles=PERCENTILES, interval=3600.0, **common)
    glob = Server(Config(grpc_address="127.0.0.1:0",
                         hostname=f"{prefix}-global", **common),
                  extra_metric_sinks=global_sinks, device=DEVICE)
    glob.start()
    try:
        local = Server(Config(
            statsd_listen_addresses=list(listen),
            forward_address=f"127.0.0.1:{glob.grpc_import.port}",
            hostname=f"{prefix}-local", forward_timeout=120.0, **common),
            extra_metric_sinks=local_sinks, device=DEVICE)
    except BaseException:
        glob.shutdown()
        raise
    return glob, local


def phase_slice_grpc(seed=11, deep_keys=2000, deep_samples=200):
    """phase_slice over gRPC: a port local (UDP in, forward_address to
    the global, no forwarder callable) and a port global (grpc_address)
    on the card, with the moments rule `mom.*` and the compactor rule
    `c.*`.  Real DogStatsD datagrams carry phase_slice's interval, three
    compactor keys (one global-only) and a group of `deep_keys` keys of
    `deep_samples` samples each (multi-value lines), whose forwarded
    digests hold more than 100 centroids each: one V1 chunk of 2,000 of
    them, bounded by count alone, would pass gRPC's 4 MiB receive limit
    (ROADMAP C14).  Checks: phase_slice's checks on both tiers; ladders
    within rank_error_bound; the deep keys' counts exact; the client
    dropped nothing and sent more than one V1 chunk; and the global's
    InterMetrics equal, value for value, those of a second global that
    imports the same forwarded list in process.  Returns the sizes and
    the worst errors."""
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.core.server import Server
    from veneur_tpu_torch.forward import client as fc
    from veneur_tpu_torch.forward import convert
    from veneur_tpu_torch.sinks.simple import ChannelMetricSink
    from veneur_tpu_torch.sketches import compactor as cs

    rng = np.random.default_rng(seed)
    rules = MOMENT_RULES + COMPACTOR_RULES
    gsink, lsink, isink = (ChannelMetricSink(), ChannelMetricSink(),
                           ChannelMetricSink())
    glob, local = _grpc_pair("grpc", [gsink], [lsink],
                             listen=["udp://127.0.0.1:0"],
                             sketch_family_rules=rules)
    inproc = Server(Config(percentiles=PERCENTILES, hostname="grpc-global",
                           sketch_family_rules=rules, interval=3600.0),
                    extra_metric_sinks=[isink], device=DEVICE)
    local.start()
    try:
        # phase_slice's own lines (its seed), then this phase's
        sl = _slice_lines(np.random.default_rng(1))
        lines = list(sl["lines"])
        counts = [1] * len(lines)
        ladders = {"c.lat0": 3000, "c.lat1": 700, "c.glob": 900}
        ladders = {k: np.asarray([float("%.4f" % x)
                                  for x in rng.gamma(2.0, 20.0, n)])
                   for k, n in ladders.items()}
        for k, v in ladders.items():
            tail = b"|#veneurglobalonly" if k == "c.glob" else b""
            lines += [b"%s:%.4f|h%s" % (k.encode(), x, tail) for x in v]
        counts += [1] * sum(map(len, ladders.values()))
        # the deep group: 100 values a line, so a line fits a datagram
        deep = rng.gamma(2.0, 20.0, (deep_keys, deep_samples))
        for i in range(deep_keys):
            for j in range(0, deep_samples, 100):
                vals = deep[i, j:j + 100]
                lines.append(b"deep.k%d:%s|h" % (
                    i, b":".join(b"%.4f" % x for x in vals)))
                counts.append(len(vals))
        _udp_send(local.statsd_addrs[0][1], lines, local, sum(counts),
                  counts)

        # launch deltas: main() counts the whole path from zero
        before = _read_launches()
        res = local.flush()
        require(local.wait_forwards(120.0), "the gRPC forward hung")
        mid = _read_launches()
        b3_local = mid["uniform_eval"] - before["uniform_eval"]
        b6_local = mid["compact_batch"] - before["compact_batch"]
        inproc.aggregator.import_metrics(res.forward)
        glob.flush()
        inproc.flush()
        after = _read_launches()
        b1_global = after["weighted_eval"] - mid["weighted_eval"]
        b5_global = (after["moments_sums_depth"]
                     - mid["moments_sums_depth"])
        require(min(b3_local, b6_local, b1_global, b5_global) >= 1,
                f"gRPC slice missed a kernel: B3 {b3_local} and B6 "
                f"{b6_local} on the local, B1 {b1_global} and B5 (depth "
                f"variant) {b5_global} on the globals")
        st = local.forwarder.stats()
        deep_fwd = [f for f in res.forward if f.name.startswith("deep.")]
        count_chunk = sum(convert.to_pb(f).ByteSize()
                          for f in res.forward[:fc.BATCH_MAX])
        require(st["dropped"] == 0 and st["sent"] == len(res.forward),
                f"client stats {st}, {len(res.forward)} forwarded")
        require(st["chunks"] > 1, f"one V1 chunk only: {st}")
        require(len(deep_fwd) == deep_keys
                and min(len(f.digest_means) for f in deep_fwd) > 100,
                "the deep keys forwarded 100 centroids or fewer")
        require(count_chunk > 4 * 1024 * 1024,
                f"a count-bounded chunk is {count_chunk} bytes")
        require(glob.grpc_import.import_errors == 0
                and glob.proto_received["grpc"] == len(res.forward),
                f"global imported {glob.proto_received['grpc']} of "
                f"{len(res.forward)}")
        lm = {m.name: m.value for m in lsink.queue.get(timeout=5)}
        gmetrics = gsink.queue.get(timeout=5)
        imetrics = isink.queue.get(timeout=5)
        gm = {m.name: m.value for m in gmetrics}
        c = _check_slice(lm, gm, sl)
        # the hop over gRPC is the in-process hop, value for value
        got = sorted((m.name, tuple(m.tags), m.type, m.value)
                     for m in gmetrics)
        want = sorted((m.name, tuple(m.tags), m.type, m.value)
                      for m in imetrics)
        require(got == want, "the gRPC global differs from the "
                "in-process one: " + str(sorted(set(got) ^ set(want))[:6]))
        for i in range(deep_keys):
            require(lm[f"deep.k{i}.count"] == deep_samples, i)
        d_worst = 0.0
        for i in range(0, deep_keys, 97):
            vals = np.asarray([float("%.4f" % x) for x in deep[i]])
            for p in PERCENTILES:
                want = np.percentile(vals, 100 * p, method="hazen")
                d_worst = max(d_worst, abs(
                    gm[f"deep.k{i}.{int(p * 100)}percentile"] - want) / want)
        cap, levels = cs.DEFAULT_CAP, cs.DEFAULT_LEVELS
        l_worst = 0.0
        for k, v in ladders.items():
            # count on the tier that emits the key's aggregates,
            # percentiles on the global
            require((gm if k == "c.glob" else lm)[f"{k}.count"] == len(v),
                    k)
            for p in PERCENTILES:
                l_worst = max(l_worst, _require_rank(
                    gm[f"{k}.{int(p * 100)}percentile"], np.sort(v), p,
                    cap, levels, k))
        result = {"forwarded": len(res.forward), "chunks": st["chunks"],
                  "bytes_sent": st["bytes_sent"],
                  "count_bounded_chunk_bytes": count_chunk,
                  "deep_centroids_min": min(len(f.digest_means)
                                            for f in deep_fwd),
                  "percentile_worst_rel": c["worst"],
                  "deep_percentile_worst_rel": d_worst,
                  "moments_worst_span": c["m_worst"],
                  "ladder_worst_rank": l_worst}
        log(f"gRPC slice over UDP: phase_slice's checks hold across the "
            f"gRPC hop (global percentiles within {c['worst']:.4%} of "
            f"numpy hazen, moments within {c['m_worst']:.4%} of the span, "
            f"set estimate {c['est']:.0f} of {sl['n_members']}); ladders "
            f"within the rank bound (worst {l_worst:.4%} of n); "
            f"{deep_keys} deep keys forwarded >= "
            f"{result['deep_centroids_min']} centroids each (their "
            f"percentiles within {d_worst:.4%}); {len(res.forward)} "
            f"metrics in {st['chunks']} V1 chunks, {st['bytes_sent']} "
            f"bytes (a count-bounded chunk: {count_chunk} bytes), dropped "
            f"0; the global's {len(got)} InterMetrics equal the "
            f"in-process hop's; launches B3 local={b3_local} B6 "
            f"local={b6_local} B1 global={b1_global} B5 "
            f"global={b5_global}")
        return result
    finally:
        local.shutdown()
        glob.shutdown()
        inproc.shutdown()


def grpc_cell(seed=12, n_keys=100_000, per=64, budget_s=60.0):
    """local 100k x 64 -> gRPC V1 -> global: the north star's shape
    with its 100,000 imported 64-centroid digests arriving over real
    gRPC from a port local.  The local's keys take 64 raw samples each
    at a sampled weight of their own (1/rate in 1..49), staged in bulk
    as the local cells stage them (UDP is measured by the slices); its
    flush (B1) exports 64-centroid digests, its client forwards them in
    V1 chunks to the port global's import server, and the global
    flushes them (B1).  Times the local flush, the forward (from the
    local flush's return until the global's import count reaches
    n_keys) and the global flush, over one warm-up and as many timed
    intervals as the cell's `budget_s` leaves room for (at least one);
    records the bytes and chunks sent.  Checks every interval's counts
    and B1 launches exactly, and the warm-up's global percentiles
    bitwise against a MetricAggregator that imports the same forwarded
    list in process."""
    import torch
    from veneur_tpu_torch.core.aggregator import MetricAggregator
    from veneur_tpu_torch.samplers import samplers as sm
    from veneur_tpu_torch.samplers.metric_key import MetricKey, MetricScope
    from veneur_tpu_torch.sinks.simple import BlackholeMetricSink

    rng = np.random.default_rng(seed)
    t_cell = time.perf_counter()
    glob, local = _grpc_pair("cell", [BlackholeMetricSink()],
                             [BlackholeMetricSink()],
                             arena_initial_capacity=n_keys)
    try:
        digests = local.aggregator.digests
        rows = np.asarray([digests.row_for(
            MetricKey(f"grpc.k{i}", sm.TYPE_HISTOGRAM, ""),
            MetricScope.MIXED, []) for i in range(n_keys)], np.int64)
        all_rows = np.repeat(rows, per)
        client = local.forwarder
        n_q = len(PERCENTILES)

        def interval():
            vals = rng.gamma(2.0, 10.0, n_keys * per)
            # sampled traffic: each key at its own rate, weights 1/rate
            # in 1..49 as the global 100k x 64 cell's imported weights;
            # equal weights in a row keep each sample its own centroid,
            # so a key forwards 64 weighted centroids
            wts = np.repeat(rng.integers(1, 50, n_keys),
                            per).astype(np.float64)
            with local.aggregator.lock:
                digests.sample_batch(all_rows, vals, wts)
                digests.touched[rows] = True
            local.aggregator.sync_staged(min_samples=1)
            st0, imp0 = client.stats(), glob.grpc_import.imported_count
            import_s0 = glob.grpc_import.import_s
            b1 = [_read_launches()["weighted_eval"]]
            t0 = time.perf_counter()
            res = local.flush()
            t1 = time.perf_counter()
            b1.append(_read_launches()["weighted_eval"])
            deadline = t1 + 300.0
            while glob.grpc_import.imported_count < imp0 + n_keys:
                require(time.perf_counter() < deadline,
                        f"the global imported "
                        f"{glob.grpc_import.imported_count - imp0} of "
                        f"{n_keys} forwarded digests")
                time.sleep(0.001)
            t2 = time.perf_counter()
            require(local.wait_forwards(60.0), "the forward never returned")
            gres = glob.flush()
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            b1.append(_read_launches()["weighted_eval"])
            require(np.diff(b1).tolist() == [1, 1],
                    f"B1 launches local, global: {np.diff(b1).tolist()}")
            st = client.stats()
            sent = {k: st[k] - st0[k] for k in st}
            import_ms = (glob.grpc_import.import_s - import_s0) * 1e3
            require(len(res.forward) == n_keys and sent["sent"] == n_keys
                    and sent["dropped"] == 0 and sent["retries"] == 0,
                    f"forward of {len(res.forward)}: {sent}")
            require(gres.imported == n_keys
                    and len(gres.metrics) == n_keys * n_q,
                    f"global imported {gres.imported}, emitted "
                    f"{len(gres.metrics)}")
            require(all(len(f.digest_means) == per for f in res.forward),
                    "a forwarded digest is not 64 centroids")
            vals_out = np.asarray([m.value for m in gres.metrics])
            require(np.isfinite(vals_out).all(), "non-finite percentile")
            return res, gres, {
                "local_flush_ms": (t1 - t0) * 1e3,
                "forward_ms": (t2 - t1) * 1e3,
                "global_flush_ms": (t3 - t2) * 1e3,
                "encode_ms": sent["encode_s"] * 1e3,
                "import_ms": import_ms,
                "bytes_sent": sent["bytes_sent"], "chunks": sent["chunks"],
                "local_segments": dict(local.aggregator.last_flush_segments),
                "global_segments": dict(glob.aggregator.last_flush_segments)}

        res, gres, warm = interval()
        ref = MetricAggregator(percentiles=PERCENTILES, is_local=False,
                               initial_capacity=n_keys, device=DEVICE)
        ok, failed = ref.import_metrics(res.forward)
        require((ok, failed) == (n_keys, 0), (ok, failed))
        rres = ref.flush(is_local=False)
        got = sorted((m.name, m.value) for m in gres.metrics)
        want = sorted((m.name, m.value) for m in rres.metrics)
        require(got == want, "the global over gRPC differs from the "
                "in-process import: " + str([
                    (g, w) for g, w in zip(got, want) if g != w][:4]))
        GRPC_WARM.update(flush=got, shape=(seed, n_keys, per))
        timed, last = [], 0.0
        while not timed or time.perf_counter() - t_cell + last < budget_s:
            t0 = time.perf_counter()
            timed.append(interval()[2])
            last = time.perf_counter() - t0
        med = {k: float(np.median([t[k] for t in timed]))
               for k in timed[0] if not k.endswith("_segments")}
        out = {"label": f"local {n_keys} x {per} -> gRPC V1 -> global",
               "n_keys": n_keys, "per": per, "warm_up": warm,
               "intervals": timed,
               **{f"{k}_p50": v for k, v in med.items()}}
        card_log(
            f"{out['label']}: over {len(timed)} timed interval(s), p50 "
            f"local flush {med['local_flush_ms']:.1f} ms, forward "
            f"{med['forward_ms']:.1f} ms ({med['bytes_sent'] / 1e6:.1f} MB "
            f"in {med['chunks']:.0f} V1 chunks, "
            f"{med['bytes_sent'] / med['forward_ms'] / 1e3:.1f} MB/s; "
            f"encode {med['encode_ms']:.1f} ms, decode+import through "
            f"the native wire scan {med['import_ms']:.1f} ms summed over "
            f"the chunks' RPCs, against {PR18_IMPORT_MS} ms through the "
            f"Python parse in call 4 of PR 18), "
            f"global flush {med['global_flush_ms']:.1f} ms; warm-up "
            f"{warm['local_flush_ms']:.1f} / {warm['forward_ms']:.1f} / "
            f"{warm['global_flush_ms']:.1f} ms; counts exact, the global's "
            f"{len(got)} percentiles bitwise the in-process import's")
        return out
    finally:
        local.shutdown()
        glob.shutdown()


# the proxy phase's cube dimension, on both tiers of its small interval
PROXY_DIMS = [{"tags": ["endpoint"], "match": "cq.*"}]
# the example proxy config's TLS keys, which the port refuses (A15)
PROXY_A15_KEYS = ("grpc_tls_address", "tls_certificate", "tls_key",
                  "tls_authority_certificate")


class _ProxyProcess:
    """The port's proxy as its own process: `python -m
    veneur_tpu_torch.cli.veneur_proxy -f <d>/<name>.yaml -device
    DEVICE` from the repo root, its output to <d>/<name>.log, its ports
    read from its port file."""

    def __init__(self, d: str, name: str, cfg: dict):
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (ROOT, env.get("PYTHONPATH")) if p)
        ports_path = os.path.join(d, f"{name}-ports.json")
        path = os.path.join(d, f"{name}.yaml")
        with open(path, "w") as f:
            json.dump(dict(cfg, port_file=ports_path), f)
        self.name, self.log_path = name, os.path.join(d, f"{name}.log")
        self.log = open(self.log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "veneur_tpu_torch.cli.veneur_proxy",
             "-f", path, "-device", DEVICE], cwd=ROOT, env=env,
            stdout=self.log, stderr=subprocess.STDOUT)
        try:
            _wait_file(ports_path, lambda: self.proc.poll() is None,
                       f"proxy {name}")
            with open(ports_path) as f:
                ports = json.load(f)
            require(ports["pid"] == self.proc.pid, ports)
        except BaseException:
            self.close(failed=True)
            raise
        self.grpc, self.http = ports["grpc"], ports["http"]

    def cpu_s(self) -> float:
        """The process's user + system CPU seconds (/proc/<pid>/stat)."""
        with open(f"/proc/{self.proc.pid}/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        return (int(fields[11]) + int(fields[12])) / os.sysconf(
            "SC_CLK_TCK")

    def debug_vars(self) -> dict:
        code, body = _http(self.http, "/debug/vars")
        require(code == 200, f"proxy {self.name} /debug/vars: {code}")
        return json.loads(body)

    def close(self, failed: bool = False) -> None:
        """SIGTERM, which must end it with exit code 0."""
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self.log.close()
        rc = self.proc.returncode
        if failed or rc != 0:
            with open(self.log_path) as f:
                log(f"proxy {self.name} (exit {rc}) log tail:\n"
                    + "".join(f.readlines()[-30:]))
        if not failed:
            require(rc == 0, f"proxy {self.name} exited {rc}")


def _proxy_globals(n_keys):
    """Two port globals on the card for the proxy phase: gRPC import on
    127.0.0.1:0, the query plane (a 4-slot window ring) over an HttpApi,
    the moments rule and PROXY_DIMS.  Each counts the V1 RPCs it imports
    in `rpcs`.  -> [(server, api, grpc address)]."""
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.core.server import Server
    from veneur_tpu_torch.http_api import HttpApi
    from veneur_tpu_torch.sinks.simple import BlackholeMetricSink

    out = []
    try:
        for i in range(2):
            srv = Server(Config(
                grpc_address="127.0.0.1:0", hostname=f"proxy-g{i}",
                percentiles=PERCENTILES, interval=3600.0,
                arena_initial_capacity=n_keys, query_window_slots=4,
                cube_dimensions=PROXY_DIMS, cube_group_budget=64,
                sketch_family_rules=MOMENT_RULES),
                extra_metric_sinks=[BlackholeMetricSink()], device=DEVICE)
            srv.start()
            imp, lock = srv.grpc_import, threading.Lock()
            srv.rpcs = 0

            def counted(payload, srv=srv, orig=imp.import_payload,
                        lock=lock):
                with lock:
                    srv.rpcs += 1
                return orig(payload)

            imp.import_payload = counted
            api = HttpApi(srv, "127.0.0.1:0")
            api.start()
            out.append((srv, api, f"127.0.0.1:{imp.port}"))
    except BaseException:
        _stop_proxy_globals(out)
        raise
    return out


def _stop_proxy_globals(globs) -> None:
    for srv, api, _ in globs:
        api.stop()
        srv.shutdown()


def _routing_key(f, ignore=()) -> str:
    """The proxy's routing key of a forwarded metric: name, kind, and
    its tags but those starting with a prefix in `ignore`, joined."""
    tags = [t for t in f.tags if not t.startswith(tuple(ignore))]
    return f"{f.name}{f.kind}{','.join(tags)}"


def _await_imports(globs, imp0, want, what, timeout=600.0) -> None:
    """Wait until each global's import count has moved by `want`."""
    def got():
        return [g.grpc_import.imported_count - i0
                for (g, _, _), i0 in zip(globs, imp0)]

    deadline = time.perf_counter() + timeout
    while any(n < w for n, w in zip(got(), want)):
        require(time.perf_counter() < deadline,
                f"{what}: the globals imported {got()} of {want}")
        time.sleep(0.001)
    require(got() == want, f"{what}: the globals imported {got()} of "
            f"{want}")


def proxy_cell(d, globs, seed=15, n_keys=100_000, per=64,
               n_counters=10_000, n_sets=1_000, members=100):
    """local x 2 -> proxy -> global x 2 at the north star's size, the
    proxy its own process (`cli/veneur_proxy.py`) routing through the
    native router (no ignore_tags): 100,000 histogram keys of `per`
    integer samples, each key's samples split half and half over the
    two locals (even values on one, odd on the other), so that every
    global merges two digests a key; `n_counters` global-only counters
    and `n_sets` sets of `members` members (half on each local), staged
    in bulk at the locals.  One warm-up interval at a tenth of the keys,
    then one timed interval.  Checks on the timed one: every emitted key
    on exactly one global, the one ConsistentHash names; both globals
    took keys; the union of their InterMetrics equal, value for value,
    to those of a MetricAggregator that imports both locals' forwarded
    lists; the proxy's /debug/vars with received == routed and nothing
    dropped or without a destination.  Times the locals' flushes, the
    forward (the last local flush's return -> both globals' imports
    complete), each global's flush and the proxy's CPU seconds."""
    import torch
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.core.aggregator import MetricAggregator
    from veneur_tpu_torch.core.server import Server
    from veneur_tpu_torch.proxy.consistent import ConsistentHash
    from veneur_tpu_torch.samplers import samplers as sm
    from veneur_tpu_torch.samplers.metric_key import MetricKey, MetricScope
    from veneur_tpu_torch.sinks.simple import BlackholeMetricSink

    rng = np.random.default_rng(seed)
    addrs = [a for _, _, a in globs]
    ring = ConsistentHash(addrs)
    proxy = _ProxyProcess(d, "proxy-cell", {
        "grpc_address": "127.0.0.1:0", "http_address": "127.0.0.1:0",
        "static_destinations": addrs, "http_enable_profiling": True,
        "discovery_interval": "3600s"})
    locs = []
    failed = True
    try:
        for i in range(2):
            locs.append(Server(Config(
                forward_address=f"127.0.0.1:{proxy.grpc}",
                hostname=f"proxy-l{i}", percentiles=PERCENTILES,
                interval=3600.0, arena_initial_capacity=n_keys,
                forward_timeout=120.0),
                extra_metric_sinks=[BlackholeMetricSink()], device=DEVICE))
        half, m_half = per // 2, members // 2

        def rows_of(agg, nk, nc, ns):
            """The interval's rows (row_for marks a row touched)."""
            with agg.lock:
                return (
                    np.asarray([agg.digests.row_for(MetricKey(
                        f"px.k{i}", sm.TYPE_HISTOGRAM, ""),
                        MetricScope.MIXED, []) for i in range(nk)],
                        np.int64),
                    np.asarray([agg.counters.row_for(MetricKey(
                        f"px.c{i}", sm.TYPE_COUNTER, ""),
                        MetricScope.GLOBAL_ONLY, []) for i in range(nc)],
                        np.int64),
                    np.asarray([agg.sets.row_for(MetricKey(
                        f"px.s{i}", sm.TYPE_SET, ""), MetricScope.MIXED,
                        []) for i in range(ns)], np.int64))

        def interval(frac):
            nk, nc, ns = (n_keys // frac, n_counters // frac,
                          n_sets // frac)
            x = rng.integers(0, 1 << 15, (nk, per)) * 2
            mem = rng.integers(0, 1 << 63, (ns, members), dtype=np.uint64)
            cv = rng.integers(1, 1000, (2, nc)).astype(float)
            for li, loc in enumerate(locs):
                vals = (x[:, li * half:(li + 1) * half] + li).astype(float)
                agg = loc.aggregator
                dr, cr, sr = rows_of(agg, nk, nc, ns)
                with agg.lock:
                    agg.digests.sample_batch(np.repeat(dr, half),
                                             vals.ravel(),
                                             np.ones(nk * half))
                    agg.digests.touched[dr] = True
                    agg.counters.merge_batch(cr, cv[li])
                    agg.sets.stage_hash_batch(
                        np.repeat(sr, m_half),
                        mem[:, li * m_half:(li + 1) * m_half].ravel())
                    agg.sets.touched[sr] = True
                agg.sync_staged(min_samples=1)
            imp0 = [g.grpc_import.imported_count for g, _, _ in globs]
            dv0, cpu0 = proxy.debug_vars(), proxy.cpu_s()
            launches0 = _read_launches()
            t0 = time.perf_counter()
            res = [locs[0].flush()]
            t1 = time.perf_counter()
            res.append(locs[1].flush())
            t2 = time.perf_counter()
            fwd = res[0].forward + res[1].forward
            owner = {}
            want = [0, 0]
            for f in fwd:
                a = owner.setdefault(_routing_key(f),
                                     ring.get(_routing_key(f)))
                want[addrs.index(a)] += 1
            _await_imports(globs, imp0, want, "proxy cell")
            t3 = time.perf_counter()
            require(all(loc.wait_forwards(120.0) for loc in locs),
                    "a local's forward never returned")
            cpu1 = proxy.cpu_s()
            gres, g_ms = [], []
            for g, _, _ in globs:
                tg = time.perf_counter()
                gres.append(g.flush())
                torch.cuda.synchronize()
                g_ms.append((time.perf_counter() - tg) * 1e3)
            launches = {k: n - launches0[k]
                        for k, n in _read_launches().items()
                        if n > launches0[k]}
            dv = proxy.debug_vars()
            moved = {k: dv[k] - dv0[k] for k in ("received", "routed",
                                                  "dropped",
                                                  "no_destination")}
            require(moved["received"] == moved["routed"] == len(fwd)
                    and moved["dropped"] == moved["no_destination"] == 0
                    and dv["destination_totals"]["dropped"] == 0,
                    f"proxy /debug/vars moved {moved}, "
                    f"{dv['destination_totals']}, {len(fwd)} forwarded")
            for loc in locs:
                st = loc.forwarder.stats()
                require(st["dropped"] == 0, f"a local dropped: {st}")
            require(len(res[0].forward) == nk + nc + ns
                    and len(res[1].forward) == nk + nc + ns,
                    f"forwarded {len(res[0].forward)}, "
                    f"{len(res[1].forward)}")
            return res, gres, owner, {
                "keys": nk, "forwarded": len(fwd), "per_global": want,
                "local_flush_ms": [(t1 - t0) * 1e3, (t2 - t1) * 1e3],
                "forward_ms": (t3 - t2) * 1e3,
                "global_flush_ms": g_ms,
                "proxy_cpu_s": cpu1 - cpu0,
                "local_segments": [dict(loc.aggregator.last_flush_segments)
                                   for loc in locs],
                "global_segments": [dict(g.aggregator.last_flush_segments)
                                    for g, _, _ in globs],
                "launches": launches}

        warm = interval(10)[3]
        res, gres, owner, timed = interval(1)
        # one owner a key, the one the ring names
        names = [set() for _ in globs]
        for gi, r in enumerate(gres):
            for m in r.metrics:
                base = m.name.rsplit(".", 1)[0] if m.name.startswith(
                    "px.k") else m.name
                kind = {"px.k": "histogram", "px.c": "counter",
                        "px.s": "set"}[m.name[:4]]
                require(owner[f"{base}{kind}"] == addrs[gi],
                        f"{m.name} on global {gi}, owned by "
                        f"{owner[base + kind]}")
                names[gi].add(m.name)
        require(names[0] and names[1] and not names[0] & names[1],
                "the globals' keys overlap or one took none")
        ref = MetricAggregator(percentiles=PERCENTILES, is_local=False,
                               initial_capacity=n_keys, device=DEVICE)
        for r in res:
            ok, bad = ref.import_metrics(r.forward)
            require(bad == 0 and ok == len(r.forward), (ok, bad))
        rres = ref.flush(is_local=False)
        got = sorted((m.name, tuple(m.tags), m.type, m.value)
                     for r in gres for m in r.metrics)
        want = sorted((m.name, tuple(m.tags), m.type, m.value)
                      for m in rres.metrics)
        require(len(want) == n_keys * len(PERCENTILES) + n_counters
                + n_sets, len(want))
        require(got == want, "the globals behind the proxy differ from "
                "one global importing both locals: " + str(
                    sorted(set(got) ^ set(want))[:6]))
        vals = np.asarray([v for *_, v in got])
        require(np.isfinite(vals).all(), "a non-finite value")
        failed = False
        out = {"label": f"2 locals x {n_keys} x {per // 2} -> proxy "
                        f"process (native router) -> 2 globals",
               "n_keys": n_keys, "per": per, "warm_up": warm, **timed}
        card_log(
            f"{out['label']}: local flushes "
            f"{timed['local_flush_ms'][0]:.1f} / "
            f"{timed['local_flush_ms'][1]:.1f} ms, forward "
            f"{timed['forward_ms']:.1f} ms ({timed['forwarded']} metrics, "
            f"{timed['per_global'][0]} / {timed['per_global'][1]} a "
            f"global), global flushes {timed['global_flush_ms'][0]:.1f} / "
            f"{timed['global_flush_ms'][1]:.1f} ms, proxy CPU "
            f"{timed['proxy_cpu_s']:.2f} s; warm-up at {warm['keys']} "
            f"keys: forward {warm['forward_ms']:.1f} ms; every key on "
            f"its ring owner, the union of {len(got)} InterMetrics equal "
            f"to one global importing both locals; launches "
            f"{timed['launches']}")
        return out
    finally:
        for loc in locs:
            loc.shutdown()
        proxy.close(failed)


def proxy_slice(d, globs, seed=16, deep_keys=2000, deep_samples=200):
    """A second proxy process on `example_proxy.yaml`, its TLS keys
    (A15) removed, its addresses replaced, port file and /debug/vars
    added: its `ignore_tags` (prefix `host`) sends every batch down the
    protobuf path.  Two locals (cube dimension PROXY_DIMS, the moments
    rule) take DogStatsD lines, each with its own `host:` tag: `deep_keys`
    keys of `deep_samples` samples, whose forwarded digests hold 127
    centroids or more (ROADMAP C18: coalesced by count alone, they
    would pass the globals' 4 MiB receive limit), `mom.*` moments keys and `cq.*` keys
    over six endpoints.  Checks: nothing dropped, more than one V1 RPC
    into each global; through the proxy's /query, a t-digest key and a
    moments key against the owning global's own answer (counts exact,
    t-digest quantiles within 1e-9 relative, moments within 1e-6 of the
    span) and a group_by read over both globals with every group's count
    equal to a global that imports both locals' forwards in process."""
    import yaml
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.core.server import Server
    from veneur_tpu_torch.proxy.consistent import ConsistentHash

    rng = np.random.default_rng(seed)
    with open(os.path.join(ROOT, "example_proxy.yaml")) as f:
        cfg = yaml.safe_load(f)
    for k in PROXY_A15_KEYS:
        cfg.pop(k)
    addrs = [a for _, _, a in globs]
    ignore = [t["value"] for t in cfg["ignore_tags"]]
    require(ignore == ["host"], cfg["ignore_tags"])
    cfg.update(grpc_address="127.0.0.1:0", http_address="127.0.0.1:0",
               static_destinations=addrs, http_enable_profiling=True,
               query_destinations={a: f"127.0.0.1:{api.address[1]}"
                                   for (_, api, a) in globs})
    ring = ConsistentHash(addrs)
    common = dict(percentiles=PERCENTILES, interval=3600.0,
                  sketch_family_rules=MOMENT_RULES,
                  cube_dimensions=PROXY_DIMS, cube_group_budget=64)
    proxy = _ProxyProcess(d, "proxy-slice", cfg)
    locs = []
    ref = Server(Config(hostname="proxy-ref", query_window_slots=4,
                        **common), device=DEVICE)
    failed = True
    try:
        for i in range(2):
            locs.append(Server(Config(
                forward_address=f"127.0.0.1:{proxy.grpc}",
                hostname=f"proxy-sl{i}", forward_timeout=120.0, **common),
                device=DEVICE))
        ref.flush()     # an empty first cut, as the globals had theirs
        for li, loc in enumerate(locs):
            tag = b"host:l%d" % li
            deep = rng.gamma(2.0, 20.0, (deep_keys, deep_samples))
            for i in range(deep_keys):
                for j in range(0, deep_samples, 100):
                    loc.handle_metric_packet(b"pdeep.k%d:%s|h|#%s" % (
                        i, b":".join(b"%.4f" % v for v in deep[i, j:j + 100]),
                        tag))
            for k in range(8):
                for v in rng.gamma(2.0, 20.0, 2000):
                    loc.handle_metric_packet(b"mom.plat%d:%.4f|h|#%s"
                                             % (k, v, tag))
            for e in range(6):
                for v in rng.integers(1, 5000, 300):
                    loc.handle_metric_packet(
                        b"cq.plat:%d|h|#endpoint:e%d,%s" % (v, e, tag))
        imp0 = [g.grpc_import.imported_count for g, _, _ in globs]
        rpcs0 = [g.rpcs for g, _, _ in globs]
        dv0 = proxy.debug_vars()
        res = [loc.flush() for loc in locs]
        fwd = res[0].forward + res[1].forward
        per_global = [0, 0]
        for f in fwd:
            per_global[addrs.index(ring.get(_routing_key(f, ignore)))] += 1
        _await_imports(globs, imp0, per_global, "proxy slice")
        require(all(loc.wait_forwards(120.0) for loc in locs),
                "a local's forward never returned")
        deep_c = [len(f.digest_means) for f in fwd
                  if f.name.startswith("pdeep.")]
        require(len(deep_c) == 2 * deep_keys and min(deep_c) >= 127,
                f"{len(deep_c)} deep digests, the least of "
                f"{min(deep_c)} centroids")
        rpcs = [g.rpcs - r0 for (g, _, _), r0 in zip(globs, rpcs0)]
        require(min(rpcs) > 1, f"V1 RPCs into the globals: {rpcs}")
        dv = proxy.debug_vars()
        moved = {k: dv[k] - dv0[k] for k in ("received", "routed",
                                              "dropped", "no_destination")}
        require(moved["received"] == moved["routed"] == len(fwd)
                and moved["dropped"] == moved["no_destination"] == 0
                and dv["destination_totals"]["dropped"] == 0,
                f"proxy /debug/vars moved {moved}, "
                f"{dv['destination_totals']}")
        for g, _, _ in globs:
            g.flush()
        ok, bad = ref.aggregator.import_metrics(fwd)
        require((ok, bad) == (len(fwd), 0), (ok, bad))
        ref.flush()
        http_of = {a: api.address[1] for (_, api, a) in globs}
        qs = "0.5,0.9,0.99"
        worst = {"tdigest": 0.0, "moments": 0.0}
        for name, tags, fam in (("pdeep.k7", "host:l0", "tdigest"),
                                ("mom.plat3", "host:l1", "moments")):
            # type= pinned: one hop, to the histogram key's owner
            q = f"name={name}&tags={tags}&type=histogram&q={qs}&slots=1"
            got = _http_json(proxy.http, q)
            own = _http_json(http_of[ring.get(f"{name}histogram")], q)
            require(got["family"] == own["family"] == fam
                    and got["count"] == own["count"] > 0
                    and len(got["upstreams"]) == 1, (got, own))
            span = own["max"] - own["min"]
            for p, w in own["quantiles"].items():
                err = abs(got["quantiles"][p] - w)
                rel = err / abs(w) if fam == "tdigest" else err / span
                worst[fam] = max(worst[fam], rel)
                require(rel <= (1e-9 if fam == "tdigest" else 1e-6),
                        (name, p, got["quantiles"][p], w))
        q = "name=cq.plat&group_by=endpoint&q=0.5&payload=0"
        got = _http_json(proxy.http, q)
        code, want = ref.query.serve(
            {"name": ["cq.plat"], "group_by": ["endpoint"], "q": ["0.5"]})
        require(code == 200, want)
        require([u.get("error") for u in got["upstreams"]] == [None, None],
                got["upstreams"])
        gc = {e["key"]: e["count"] for e in got["groups"]}
        wc = {e["key"]: e["count"] for e in want["groups"]}
        require(gc == wc and len(gc) == 6
                and set(gc.values()) == {600.0}, (gc, wc))
        failed = False
        out = {"forwarded": len(fwd), "per_global": per_global,
               "rpcs": rpcs, "deep_centroids_min": min(deep_c),
               "query_worst": worst}
        log(f"proxy slice (example_proxy.yaml, ignore_tags): "
            f"{len(fwd)} forwarded metrics routed with nothing dropped, "
            f"{rpcs} V1 RPCs into the globals, deep digests of >= "
            f"{min(deep_c)} centroids; /query through the proxy: "
            f"t-digest within {worst['tdigest']:.2e} relative and moments "
            f"within {worst['moments']:.2e} of the span of the owning "
            f"global's answer, the group_by read over both globals with "
            f"the in-process global's {len(gc)} group counts")
        return out
    finally:
        for loc in locs:
            loc.shutdown()
        ref.shutdown()
        proxy.close(failed)


def phase_proxy(cell=None, slice_=None) -> dict:
    """The proxy tier (`veneur_tpu_torch/proxy/`) on the card: two port
    globals in this process, `proxy_cell` at full size through one
    proxy process, then `proxy_slice` through a second."""
    import tempfile

    cell, slice_ = dict(cell or {}), dict(slice_ or {})
    globs = _proxy_globals(cell.get("n_keys", 100_000))
    try:
        with tempfile.TemporaryDirectory() as d:
            out = {"cell": proxy_cell(d, globs, **cell)}
            out["slice"] = proxy_slice(d, globs, **slice_)
    finally:
        _stop_proxy_globals(globs)
    return out


def mesh_cells(seed=9, n_keys=100_000, per=64, n_sets=10_000,
               n_counters=100_000, n_timed=FULL_SIZE_TIMED, grids=None):
    """The meshed global tier at the north star's scale: 100k histogram
    keys x 64 raw samples at weight 1 (B2 at [131072, 64]), 10,000 set
    keys (1 to 200 members each) and 100,000 counters (every 50th above
    2^25) per interval, through MetricAggregator with a one-card mesh;
    then the same cell on a logical 2 x 2 mesh over the one card (the
    all_to_all, psum and pmax paths run, four B2 launches a flush) and
    on a 2 x 3 mesh over it (three replicas, C6: rows 3 x a power of two
    wide pad to the next power of two before B2), whose outputs must be
    bitwise the mesh-1 run's on the same integer data.
    After the timed flushes of the one-card mesh, one more interval
    runs B8 and B9 on the main path (`_b8_b9_on_cell`).  `grids`:
    (label, devices, replicas) meshes of `make_mesh(devices, replicas)`
    to run in place of the one-card 2 x 2 grid (on a machine with four
    cards: `(("2 x 2 over 4 cards", 4, 2),)`).  Returns the flush rows
    and B8/B9's summary."""
    import torch
    from veneur_tpu_torch.core.aggregator import MetricAggregator
    from veneur_tpu_torch.parallel import mesh as mesh_mod
    from veneur_tpu_torch.samplers import samplers as sm
    from veneur_tpu_torch.samplers.metric_key import MetricKey, MetricScope

    dev = torch.device(DEVICE)
    results, outs = [], {}
    second = (("mesh 2x2 on one card",
               mesh_mod.make_mesh(devices=[dev] * 4)),
              ("mesh 2x3 on one card",
               mesh_mod.make_mesh(devices=[dev] * 6, replicas=3))) \
        if grids is None \
        else tuple((label, mesh_mod.make_mesh(n, r, device=DEVICE))
                   for label, n, r in grids)
    for label, mesh in (("mesh 1", mesh_mod.make_mesh(1, device=DEVICE)),
                        *second):
        rng = np.random.default_rng(seed)
        agg = MetricAggregator(percentiles=PERCENTILES, is_local=False,
                               initial_capacity=n_keys, mesh=mesh)
        d, s, c = agg.digests, agg.sets, agg.counters
        with agg.lock:
            drows = np.asarray([d.row_for(MetricKey(
                f"mc.k{i}", sm.TYPE_HISTOGRAM, ""), MetricScope.MIXED, [])
                for i in range(n_keys)], np.int64)
            srows = np.asarray([s.row_for(MetricKey(
                f"mc.s{i}", sm.TYPE_SET, ""), MetricScope.MIXED, [])
                for i in range(n_sets)], np.int64)
            crows = np.asarray([c.row_for(MetricKey(
                f"mc.c{i}", sm.TYPE_COUNTER, ""),
                MetricScope.GLOBAL_ONLY, []) for i in range(n_counters)],
                np.int64)
        all_rows = np.repeat(drows, per)
        ones = np.ones(n_keys * per)
        state = {}

        def refill():
            vals = rng.integers(0, 1 << 16, n_keys * per).astype(float)
            n_m = rng.integers(1, 201, n_sets)
            members = rng.integers(0, 1 << 63, int(n_m.sum()),
                                   dtype=np.uint64)
            cv = rng.integers(1, 1000, n_counters).astype(float)
            cv[::50] += 1 << 25
            state.update(vals=vals, cv=cv)
            with agg.lock:
                d.sample_batch(all_rows, vals, ones)
                d.touched[drows] = True
                s.stage_hash_batch(np.repeat(srows, n_m), members)
                s.touched[srows] = True
                c.merge_batch(crows, cv)
            agg.sync_staged(min_samples=1)

        names = [[f"mc.k{i}.{int(p * 100)}percentile" for p in PERCENTILES]
                 for i in range(0, n_keys, 97)]

        class _Srv:
            """_run_flushes' view of the aggregator."""
            aggregator = agg
            last_flush = None

            def flush(self):
                with _B2Capture() as cap:
                    self.last_flush = agg.flush(is_local=False)
                state["b2"] = cap.check(integer=True)
                return self.last_flush

        def check(res):
            m = {x.name: x.value for x in res.metrics}
            require(len(m) == (3 + len(PERCENTILES)) * n_keys + n_sets
                    + n_counters, len(m))
            vals = state["vals"].reshape(n_keys, per)
            for i in range(0, n_counters, 997):
                require(m[f"mc.c{i}"] == state["cv"][i], i)
            for i in range(0, n_keys, 97):
                require(m[f"mc.k{i}.count"] == per, i)
            _require_quantiles(res, names, _midpoint_quantiles(
                vals[::97].astype(np.float32), np.ones((len(names), per)),
                PERCENTILES), label)
            state["metrics"] = m

        results.append(_run_flushes(
            f"meshed global flush ({label}): {n_keys} keys x {per} "
            f"samples (B2), {n_sets} sets, {n_counters} counters", _Srv(),
            refill, check, n_timed))
        outs[label] = state["metrics"]
        if label == "mesh 1":
            b8_b9 = _b8_b9_on_cell(agg, refill, state, srows, n_keys, per)
    for label, _ in second:
        require(outs["mesh 1"] == outs[label],
                f"the {label} flush differs from the one-card mesh's")
        card_log(f"meshed cell: the {label} emitted bitwise the one-card "
                 f"mesh's InterMetrics")
    return results, b8_b9


def moments_mesh_cell(seed=10, n_keys=100_000, per=64, n_timed=1):
    """The moments global cell (each global-only key one imported
    vector of 32 samples and 64 samples at weight 2: B5's general
    variant at 131072 x 64) through MetricAggregator unmeshed and on a
    2 x 2 mesh over the one card: the arena stays unmeshed and the solve
    splits into four [32768, 64] slices, four B5 launches and four
    solves a flush.  The meshed InterMetrics must be bitwise the
    unmeshed ones on the same data.  Returns the flush rows."""
    import torch
    from veneur_tpu_torch.core.aggregator import MetricAggregator
    from veneur_tpu_torch.ops import moments_eval as me
    from veneur_tpu_torch.parallel import mesh as mesh_mod
    from veneur_tpu_torch.samplers import samplers as sm
    from veneur_tpu_torch.samplers.metric_key import MetricKey, MetricScope

    dev = torch.device(DEVICE)
    results, outs = [], {}
    grids = (("unmeshed", None),
             ("mesh 2x2 on one card", mesh_mod.make_mesh(devices=[dev] * 4)))
    for label, mesh in grids:
        rng = np.random.default_rng(seed)
        agg = MetricAggregator(percentiles=PERCENTILES, is_local=False,
                               initial_capacity=n_keys, mesh=mesh,
                               sketch_family_default="moments",
                               device=DEVICE)
        arena = agg.moments
        with agg.lock:
            rows = np.asarray([arena.row_for(MetricKey(
                f"mm.k{i}", sm.TYPE_HISTOGRAM, ""),
                MetricScope.GLOBAL_ONLY, []) for i in range(n_keys)],
                np.int64)
        vecs = _moment_vectors(rng.gamma(2.0, 20.0, (n_keys, 32)) + 10.0)
        fms = [sm.ForwardMetric(name=f"mm.k{i}", tags=[],
                                kind=sm.TYPE_HISTOGRAM,
                                scope=MetricScope.GLOBAL_ONLY,
                                moments=vecs[i].tolist())
               for i in range(n_keys)]
        all_rows, twos = np.repeat(rows, per), np.full(n_keys * per, 2.0)
        state = {}

        def refill():
            vals = rng.gamma(2.0, 20.0, n_keys * per) + 10.0
            require(agg.import_metrics(fms) == (n_keys, 0),
                    "moments imports")
            with agg.lock:
                arena.sample_batch(all_rows, vals, twos)
                arena.touched[rows] = True
            agg.sync_staged(min_samples=1)

        class _Srv:
            """_run_flushes' view of the aggregator."""
            aggregator = agg
            last_flush = None

            def flush(self):
                self.last_flush = agg.flush(is_local=False)
                return self.last_flush

        def check(res):
            m = {x.name: x.value for x in res.metrics}
            for i in range(0, n_keys, 97):
                require(m[f"mm.k{i}.count"] == 32 + 2 * per, i)
            state["metrics"] = m

        n_b5 = me.launches["moments_sums"]
        results.append(_run_flushes(
            f"moments global flush ({label}): {n_keys} keys x ({per} "
            f"samples at weight 2 + 1 imported vector)", _Srv(), refill,
            check, n_timed))
        slices = 1 if mesh is None else mesh.size
        require(me.launches["moments_sums"] - n_b5 == slices * (n_timed + 1),
                f"{label}: B5 launches {me.launches['moments_sums'] - n_b5}")
        outs[label] = state["metrics"]
    require(outs["unmeshed"] == outs["mesh 2x2 on one card"],
            "the meshed moments flush differs from the unmeshed one")
    card_log("moments mesh cell: the 2 x 2 one-card mesh (four B5 "
             "launches and solves a flush) emitted bitwise the unmeshed "
             "InterMetrics")
    return results


def _b8_b9_on_cell(agg, refill, state, srows, n_keys, per) -> dict:
    """One more interval of the meshed cell: B8 (`ops.hll_estimate`)
    estimates the set keys from their merged registers as the flush will
    read them (within one of the flush's estimates: the same estimator
    tail on sums of 2^-r added in another order, then a floor), and B9
    (`ops.quantile_eval`) reads the interval's samples compressed into
    digests (`serving.partial_digests`, centroid_capacity(100) = 152
    slots), held bitwise to its plain version and within two sample gaps
    of the flush's percentiles (Quantile()'s interpolation inside
    centroid bounds against the midpoint rule)."""
    import torch
    from veneur_tpu_torch.ops import hll_estimate as he
    from veneur_tpu_torch.ops import quantile_eval as qe
    from veneur_tpu_torch.parallel import serving
    home = agg.mesh.home
    d, s = agg.digests, agg.sets
    refill()
    with agg.lock:
        lanes = s.snapshot_lanes()
    regs = serving.set_gather_rows(lanes, srows, home)
    b8 = he.estimate(regs)
    check_b8(regs)
    res = agg.flush(is_local=False)
    m = {x.name: x.value for x in res.metrics}
    flushed = np.asarray([m[f"mc.s{i}"] for i in range(len(srows))])
    b8 = b8.cpu().numpy()
    require(np.abs(b8 - flushed).max() <= 1.0,
            f"B8 estimates differ from the flush's by "
            f"{np.abs(b8 - flushed).max()}")
    dev = home
    vals = state["vals"].reshape(n_keys, per)
    u = d.dense_block_per_shard(n_keys)
    dv = torch.zeros((u, per), device=dev)
    dv[:n_keys] = torch.from_numpy(vals).float().to(dev)
    dw = torch.zeros((u, per), device=dev)
    dw[:n_keys] = 1.0
    means, wts = serving.partial_digests(dv, dw, d.compression, d.ccap)
    means, wts = means.contiguous(), wts.contiguous()
    lo = torch.zeros(u, device=dev)
    hi = torch.zeros(u, device=dev)
    lo[:n_keys] = torch.from_numpy(vals.min(axis=1)).float().to(dev)
    hi[:n_keys] = torch.from_numpy(vals.max(axis=1)).float().to(dev)
    qs = torch.tensor(PERCENTILES, device=dev)
    b9 = qe.quantile(means, wts, lo, hi, qs)
    check_b9((means, wts, lo, hi, qs), got=b9)
    b9 = b9[:n_keys].cpu().numpy()
    rows = np.arange(0, n_keys, 97)
    srt = np.sort(vals[rows], axis=1)
    gap = np.diff(srt, axis=1).max(axis=1)
    worst = 0.0
    for j, p in enumerate(PERCENTILES):
        flush_q = np.asarray([m[f"mc.k{i}.{int(p * 100)}percentile"]
                              for i in rows])
        off = np.abs(b9[rows, j] - flush_q) / gap
        worst = max(worst, float(off.max()))
        require(np.isfinite(b9[rows, j]).all() and (off <= 2.0).all(),
                f"B9 quantile {p} is {off.max():.2f} sample gaps from the "
                f"flush's")
    log(f"meshed cell: B8 estimates of {len(srows)} sets within 1 of the "
        f"flush's; B9 == plain on {tuple(means.shape)} digests, within "
        f"{worst:.2f} sample gaps of the flush's percentiles")
    return {"label": "B8 and B9 on the meshed cell",
            "b8_shape": list(regs.shape), "b9_shape": list(means.shape),
            "b9_worst_gaps": worst}


def bound_register_moments(s: int, m: int) -> tuple[float, str]:
    """B8's least time: the registers read once and the [S, 2] moments
    written once, S * (m + 8) bytes, over the memory rate, or its 4 S m
    operations (compare, exp2, two adds) over the f32 rate."""
    t_bytes = s * (m + 8) / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * s * m / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_quantile(k: int, c: int, p: int) -> tuple[float, str]:
    """B9's least time: means and weights read once, min and max, the
    quantiles, the [K, P] output written once, K (8C + 8 + 4P) + 4P
    bytes, over the memory rate; or its K (C + P C) operations (the
    prefix sum's adds and each quantile's compares) over the f32
    rate."""
    t_bytes = (k * (8 * c + 8 + 4 * p) + 4 * p) / HBM_BYTES_PER_S * 1e3
    t_ops = k * (c + p * c) / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def b2_b8_b9_times(err: dict, gen) -> list[dict]:
    """B2, B8 and B9 at their main-path shapes on fresh seeded inputs
    (gamma rows for B2, geometric registers for B8, gamma-mean digests
    with integer weights for B9), each held to its plain version first.
    No single PyTorch call computes any of the three; for B8 the two
    calls `(r == 0).sum(1)` and `torch.exp2(-r).sum(1)` are timed
    together and kept as `library_two_calls_ms`."""
    import torch
    from veneur_tpu_torch.ops import hll_estimate as he
    from veneur_tpu_torch.ops import quantile_eval as qe
    from veneur_tpu_torch.ops import sorted_eval as se
    dev = torch.device(DEVICE)
    out = []
    u, d = MAIN_SHAPE["weighted_eval_uniform"]
    args = unit_rows(u, d, gen, dev, integer=False)
    err["weighted_eval_uniform"] = max(err["weighted_eval_uniform"],
                                       check_b2(args, False))
    with _not_counted():
        ms = cuda_ms(lambda: se.weighted_eval(*args, uniform=True))
    plain_ms = cuda_ms(lambda: se.weighted_eval_uniform_plain(*args), 5)
    b_ms, b_by = bound("weighted_eval_uniform", u, d, args[4].shape[0])
    out.append({"name": "weighted_eval_uniform", "shape": [u, d], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None})
    s_rows, m = MAIN_SHAPE["register_moments"]
    regs = hll_rows(s_rows, int(math.log2(m)), gen, dev)
    err["register_moments"] = max(err["register_moments"], check_b8(regs))
    with _not_counted():
        ms = cuda_ms(lambda: he.register_moments(regs))
    plain_ms = cuda_ms(lambda: he.register_moments_plain(regs), 5)
    r = regs.float()
    two_ms = cuda_ms(lambda: ((r == 0).sum(1), torch.exp2(-r).sum(1)))
    b_ms, b_by = bound_register_moments(s_rows, m)
    out.append({"name": "register_moments", "shape": [s_rows, m], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None, "library_two_calls_ms": two_ms})
    k, c = MAIN_SHAPE["quantile"]
    args = centroid_rows(k, c, gen, dev, integer=False)
    err["quantile"] = max(err["quantile"], check_b9(args))
    with _not_counted():
        ms = cuda_ms(lambda: qe.quantile(*args))
    plain_ms = cuda_ms(lambda: qe.quantile_plain(*args), 5)
    b_ms, b_by = bound_quantile(k, c, args[4].shape[0])
    out.append({"name": "quantile", "shape": [k, c], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None})
    for r in out:
        extra = (f", the two PyTorch calls {r['library_two_calls_ms']:.4f}"
                 f" ms" if "library_two_calls_ms" in r else "")
        card_log(f"{r['name']} {r['shape']}: kernel {r['ms']:.4f} ms, "
                 f"plain {r['plain_ms']:.3f} ms{extra}, bound "
                 f"{r['bound_ms']:.4f} ms ({r['bound_by']}), kernel at "
                 f"{r['bound_ms'] / r['ms']:.1%} of bound")
    return out


# ---------------------------------------------------------------------------
# The profiling harness: H1 (stage_slice), H2 (stage_slice_wide), H3
# (sort_variant) and the three entry points that run them
# ---------------------------------------------------------------------------

# the distinct H3 kernels (v2 runs v1's, v5 and v6 run v3's)
SORT_KERNELS = ("v0", "v1", "v3", "c0", "c1")


# the kernels of the profiling path (H1, H2, H3), whose launches the
# script counts on that path alone
HARNESS_KERNELS = ("stage_slice", "stage_slice_wide", "sort_variant")


def _read_launches() -> dict:
    return {k: n for mod in _kernel_modules() for k, n in
            mod.launches.items()}


def slice_rows(u, d, gen, dev, integer=True, tied=False):
    """H1/H2 inputs: weighted_rows' values (distinct integers, a
    whole-row tie in row 3, or gamma floats; tied: tied_rows' integers
    with runs of ties and +-0), integer weights 1..3 with holes in row 0
    alone, each row's min and max, the percentiles."""
    import torch
    m, _, _, _, pct = weighted_rows(u, d, gen, dev, integer)
    if tied:
        m = tied_rows(u, d, gen, dev)[0]
    w = torch.randint(1, 4, (u, d), generator=gen, device=dev).float()
    w[0] = w[0] * (torch.rand(d, generator=gen, device=dev) < 0.67)
    w[0, 0] = 0.0
    dmin, dmax = _bounds(m, w)
    return m, w.contiguous(), dmin, dmax, pct


def variant_rows(u, d, gen, dev, integer=True):
    """H3 inputs, the harness's kind: bf16-exact values (integers below
    256, or gamma rounded to bf16), weights 1."""
    import torch
    if integer:
        m = torch.randint(0, 256, (u, d), generator=gen, device=dev).float()
    else:
        m = _gamma2((u, d), gen, dev, 10.0).bfloat16().float()
    return m.contiguous(), torch.ones((u, d), device=dev)


def _agree(got, ref, what: str) -> float:
    """NaN in the same places; elsewhere the same bits.  Returns the
    largest absolute difference over the finite entries (0.0)."""
    import torch
    torch.cuda.synchronize()
    nan = torch.isnan(ref)
    require(torch.equal(torch.isnan(got), nan), f"{what}: NaN placement")
    g, r = got[~nan], ref[~nan]
    diff = (g - r).abs()
    require(_same_bits(g, r), f"{what}: kernel != plain (max |diff| "
                              f"{float(diff.max()) if diff.numel() else 0.0})")
    return float(diff.max()) if diff.numel() else 0.0


def check_slices(args) -> tuple[float, float]:
    """H1's three cuts and H2's two modes against their plain versions,
    bitwise (`_agree`) on every row: both sort stably and both sum a row
    by the same fixed pairwise tree.  Not counted.  -> (H1 err, H2
    err)."""
    from veneur_tpu_torch.ops import sorted_eval as se
    m, w = args[0], args[1]
    e1 = e2 = 0.0
    shape = tuple(m.shape)
    with _not_counted():
        for cut in se.STAGE_CUTS:
            e1 = max(e1, _agree(se.stage_slice(m, w, cut),
                                se.stage_slice_plain(m, w, cut),
                                f"stage_slice {cut} {shape}"))
        for mode in se.WIDE_MODES:
            e2 = max(e2, _agree(se.stage_slice_wide(*args, mode),
                                se.stage_slice_wide_plain(*args, mode),
                                f"stage_slice_wide {mode} {shape}"))
    return e1, e2


def check_variants(m, w) -> float:
    """Every H3 mode against its plain version and against v0's kernel,
    bitwise.  Not counted.  Returns 0.0 (every entry is equal)."""
    import torch
    from veneur_tpu_torch.ops import sort_variants as sv
    d = m.shape[1]
    with _not_counted():
        v0 = sv.sort_variant(m, w, "v0")
        for mode in sv.MODES:
            if mode == "c0" and d > 64:
                continue
            got = sv.sort_variant(m, w, mode)
            ref = sv.sort_variant_plain(m, w, mode)
            torch.cuda.synchronize()
            require(_same_bits(got, ref) and _same_bits(got, v0),
                    f"sort_variant {mode} {tuple(m.shape)}: kernel != "
                    f"plain ({_same_bits(got, ref)}) or v0 "
                    f"({_same_bits(got, v0)})")
    return 0.0


def phase_harness_kernels(us=(1, 100, 4096, 16384),
                          ds=(2, 8, 64, 256, 1024), seed=0) -> dict:
    """H1, H2 and H3 against their plain versions at every U x D:
    integer and gamma rows.  Returns each kernel's largest absolute
    difference."""
    import torch
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    err = {"stage_slice": 0.0, "stage_slice_wide": 0.0,
           "sort_variant": 0.0}
    for u in us:
        for d in ds:
            for integer, tied in ((True, False), (False, False),
                                  (True, True)):
                e1, e2 = check_slices(slice_rows(u, d, gen, dev, integer,
                                                 tied))
                err["stage_slice"] = max(err["stage_slice"], e1)
                err["stage_slice_wide"] = max(err["stage_slice_wide"], e2)
            for integer in (True, False):
                check_variants(*variant_rows(u, d, gen, dev, integer))
        log(f"H1, H2 == plain bitwise at U={u} for D in {ds} (integer, "
            f"gamma and tied integer rows; NaN rows alike); H3 every "
            f"mode bitwise plain and v0")
    return err


def sort_ms(keys, dev, inner=32, pipeline=8, rounds=4) -> dict:
    """`torch.sort(keys, dim=1)` under both protocols of the harness: a
    reference line for the sort network, used nowhere in the port."""
    import torch
    from veneur_tpu_torch import scripts

    def fn():
        return torch.sort(keys, dim=1)
    return {"pipelined": scripts.pipelined_ms(fn, dev, 25, rounds),
            "inloop": scripts.inloop_ms(fn, dev, inner, pipeline)}


def phase_harness(shapes=((16384, 256), (131072, 64)),
                  variant_shapes=((16384, 256), (131072, 64))) -> dict:
    """The harness's main path: the three entry points as a user runs
    them (default pipelines), at the default shape and at the global
    cell's 131072 x 64, plus torch.sort's time on their keys.  Their
    outputs are printed; `sort_variants` raises if a mode differs from
    v0.  Returns every p50."""
    import torch
    from veneur_tpu_torch.scripts import profile_flush_kernel as pfk
    from veneur_tpu_torch.scripts import profile_kernel_inloop as pki
    from veneur_tpu_torch.scripts import sort_variants as svs
    dev = torch.device(DEVICE)
    out = {}
    for k, d in shapes:
        modes = list(pfk.DEFAULT_MODES)
        if d <= 64:
            modes += ["compact", "moments_sums"]
        pipe = pfk.main([str(k), str(d), "25", "4", ",".join(modes)],
                        device=DEVICE)
        loop = pki.main([str(k), str(d)], device=DEVICE)
        keys = pfk.inputs(k, d, dev)["mean"]
        ref = sort_ms(keys, dev)
        card_log(f"torch.sort(keys, dim=1) at {k} x {d}: pipelined "
                 f"{ref['pipelined']:.4f} ms, in-loop {ref['inloop']:.4f} ms")
        out[f"{k}x{d}"] = {"pipelined": pipe, "inloop": loop,
                           "torch_sort": ref}
    for k, d in variant_shapes:
        out[f"variants {k}x{d}"] = svs.main([str(k), str(d)], device=DEVICE)
    return out


def bound_slice(u: int, d: int, cut: str,
                out_bytes: int) -> tuple[float, str]:
    """H1's, H2's and H3's least time: both [U, D] f32 operands read
    once plus `out_bytes` (the output, and H2's min/max and percentiles)
    over the memory rate; or the network's compare-exchanges (but the
    read cut) plus U*D products or adds over the f32 rate."""
    lg = int(math.log2(d))
    ops = u * d + (0 if cut == "read" else u * d * lg * (lg + 1) / 4)
    t_bytes = (2 * u * d * 4 + out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def harness_times(err: dict, gen) -> list[dict]:
    """H1 (each cut), H2 (each mode) and H3 (each distinct formulation)
    at the harness's default 16384 x 256 (c0 at 16384 x 64, its largest
    depth), on fresh seeded rows held to the plain versions first.
    Library: `weight.sum(1)` computes the cumsum cut's value, the total
    weight (exact on integer weights); no single PyTorch call computes
    the others."""
    import torch
    from veneur_tpu_torch.ops import sort_variants as sv
    from veneur_tpu_torch.ops import sorted_eval as se
    dev = torch.device(DEVICE)
    out = []
    u, d = MAIN_SHAPE["stage_slice"]
    args = slice_rows(u, d, gen, dev, integer=False)
    e1, e2 = check_slices(args)
    err["stage_slice"] = max(err["stage_slice"], e1)
    err["stage_slice_wide"] = max(err["stage_slice_wide"], e2)
    m, w = args[0], args[1]
    n_pct = args[4].shape[0]
    with _not_counted():
        for cut in se.STAGE_CUTS:
            b_ms, b_by = bound_slice(u, d, cut, u * 4)
            lib = (cuda_ms(lambda: w.sum(1)) if cut == "cumsum" else None)
            out.append({"name": "stage_slice", "mode": cut, "shape": [u, d],
                        "ms": cuda_ms(lambda: se.stage_slice(m, w, cut)),
                        "plain_ms": cuda_ms(
                            lambda: se.stage_slice_plain(m, w, cut), 5),
                        "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": lib})
        for mode in se.WIDE_MODES:
            b_ms, b_by = bound_slice(u, d, "read" if mode == "dma" else
                                     mode, u * 8 + n_pct * 4
                                     + u * (n_pct + 2) * 4)
            out.append({"name": "stage_slice_wide", "mode": mode,
                        "shape": [u, d],
                        "ms": cuda_ms(lambda: se.stage_slice_wide(*args,
                                                                  mode)),
                        "plain_ms": cuda_ms(
                            lambda: se.stage_slice_wide_plain(*args, mode),
                            5),
                        "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": None})
        for mode in SORT_KERNELS:
            vd = 64 if mode == "c0" else d
            vm, vw = variant_rows(u, vd, gen, dev, integer=False)
            check_variants(vm, vw)
            b_ms, b_by = bound_slice(u, vd, "sort", u * 3 * 4)
            out.append({"name": "sort_variant", "mode": mode,
                        "shape": [u, vd],
                        "ms": cuda_ms(lambda: sv.sort_variant(vm, vw, mode)),
                        "plain_ms": cuda_ms(
                            lambda: sv.sort_variant_plain(vm, vw, mode), 5),
                        "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": None})
    for r in out:
        lib = (f", library {r['library_ms']:.4f} ms"
               if r["library_ms"] is not None else "")
        card_log(f"{r['name']} {r['mode']} {r['shape']}: kernel "
                 f"{r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms{lib}, "
                 f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), kernel "
                 f"at {r['bound_ms'] / r['ms']:.1%} of bound")
    return out


# ---------------------------------------------------------------------------
# The command line (veneur_tpu_torch/cli/veneur.py)
# ---------------------------------------------------------------------------

CLI_AGGS = ["min", "max", "count", "sum"]
# the senders hold the listener's queued bytes under CLI_QUEUE_HIGH, as
# /proc/net/udp reports them: a Linux host caps SO_RCVBUF at
# net.core.rmem_max (212,992 bytes on the card's host), far below the
# 8 MiB the configs ask for.  Under gVisor /proc/net/udp reports every
# rx_queue as 0, so phase_cli_in_process also holds the lines sent but
# not yet processed under CLI_WINDOW_LINES, by the server's own count
CLI_QUEUE_HIGH = 96 << 10
CLI_WINDOW_LINES = 5_000
CLI_FLOWS = 4           # sender sockets, which SO_REUSEPORT spreads
CLI_RCVBUF = 8 << 20    # read_buffer_size_bytes of the configs
ROOT = os.path.dirname(os.path.abspath(__file__))


def udp_queues(port: int) -> tuple[int, int]:
    """(bytes queued, datagrams dropped) summed over the UDP sockets
    bound to `port`, from /proc/net/udp and /proc/net/udp6."""
    queued = drops = 0
    for name in ("/proc/net/udp", "/proc/net/udp6"):
        try:
            with open(name) as f:
                rows = f.read().splitlines()[1:]
        except FileNotFoundError:
            continue
        for row in rows:
            cols = row.split()
            if int(cols[1].rsplit(":", 1)[1], 16) == port:
                queued += int(cols[4].split(":")[1], 16)
                drops += int(cols[-1])
    return queued, drops


def _wait_queues(port: int, high: int, timeout: float = 300.0) -> None:
    """Wait until the listener on `port` holds at most `high` queued
    bytes."""
    deadline = time.monotonic() + timeout
    while udp_queues(port)[0] > high:
        if time.monotonic() > deadline:
            raise TimeoutError(f"udp port {port}: queues still hold "
                               f"{udp_queues(port)[0]} bytes")
        time.sleep(0.002)


def _datagrams(lines, limit=4096) -> list[bytes]:
    """Lines packed into datagrams of at most `limit` bytes."""
    out, buf, size = [], [], 0
    for line in lines:
        if size + len(line) + 1 > limit and buf:
            out.append(b"\n".join(buf))
            buf, size = [], 0
        buf.append(line)
        size += len(line) + 1
    return out + [b"\n".join(buf)] if buf else out


def _cli_interval(rng, n_hist, per, n_sets, members, n_counters, n_gauges,
                  sampled: bool) -> dict:
    """One interval of phase_cli's traffic, shuffled: `n_hist` histogram
    and timer keys of `per` integer samples (with `sampled`, every
    fifth key's samples all at @0.5, so no key mixes weights and no
    arrival order changes its quantiles), `n_sets` sets of `members`
    members, `n_counters` counters (every fourth sampled @0.5 with
    `sampled`) and `n_gauges` gauges written once.  Returns the
    datagrams, the line count and each counter's expected total."""
    lines, totals = [], {}
    for k in range(n_hist):
        rate = b"|@0.5" if sampled and k % 5 == 0 else b""
        kind = b"h" if k % 2 == 0 else b"ms"
        lines += [b"cli.h%d:%d|%s%s" % (k, v, kind, rate)
                  for v in rng.integers(0, 1000, per)]
    for k in range(n_sets):
        lines += [b"cli.s%d:m%d|s" % (k, m) for m in range(members)]
    for k, v in enumerate(rng.integers(1, 10, n_counters)):
        rate = 0.5 if sampled and k % 4 == 0 else 1.0
        lines.append(b"cli.c%d:%d|c" % (k, v)
                     + (b"|@0.5" if rate != 1.0 else b""))
        totals[f"cli.c{k}"] = v / rate
    lines += [b"cli.g%d:%d|g" % (k, v)
              for k, v in enumerate(rng.integers(-500, 500, n_gauges))]
    lines = [lines[i] for i in rng.permutation(len(lines))]
    return {"dgrams": _datagrams(lines), "lines": len(lines),
            "totals": totals}


def _paced_send(dgrams, addr, processed, check_every: int = 8) -> float:
    """Send `dgrams` to `addr` over CLI_FLOWS sockets in turn, holding
    the lines sent but not yet `processed()` (a count of the server's,
    taken from its value at the call) under CLI_WINDOW_LINES and, every
    `check_every`
    datagrams, the listener's queued bytes under CLI_QUEUE_HIGH; then
    wait until the server has processed every line and the queues are
    empty.  Returns the seconds from the first datagram to then;
    raises when the kernel dropped a datagram."""
    port = addr[1]
    drops0 = udp_queues(port)[1]
    socks = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
             for _ in range(CLI_FLOWS)]
    base = processed()

    def done():
        return processed() - base

    def wait_processed(n, timeout=300.0):
        deadline = time.monotonic() + timeout
        while done() < n:
            if time.monotonic() > deadline:
                raise TimeoutError(f"the server processed {done()} "
                                   f"of {n} lines")
            time.sleep(0.002)

    try:
        t0 = time.perf_counter()
        sent = 0
        for i, d in enumerate(dgrams):
            wait_processed(sent - CLI_WINDOW_LINES)
            if i % check_every == 0:
                _wait_queues(port, CLI_QUEUE_HIGH)
            socks[i % CLI_FLOWS].sendto(d, addr)
            sent += d.count(b"\n") + 1
        wait_processed(sent)
        _wait_queues(port, 0)
        secs = time.perf_counter() - t0
    finally:
        for s in socks:
            s.close()
    require(done() == sent, f"{done()} lines processed of {sent} sent")
    drops = udp_queues(port)[1] - drops0
    require(drops == 0, f"the kernel dropped {drops} datagrams on {port}")
    return secs


def _http(port, path, method="GET") -> tuple[int, bytes]:
    import urllib.error
    import urllib.request
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=b"" if method == "POST" else None,
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _wait_file(path, alive, what, timeout=300.0) -> None:
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        require(alive(), f"{what} ended before writing {path}")
        require(time.monotonic() < deadline, f"no {path} from {what}")
        time.sleep(0.01)


def _jsonl_frames(path) -> list[dict]:
    """The jsonl sink's flushes: one {(name, tags, type): value} dict a
    frame record, each frame's row count checked."""
    frames, rows = [], {}
    with open(path) as f:
        for line in f:
            row = json.loads(line)
            if row.get("flush"):
                require(row["metrics"] == len(rows), "a torn frame")
                frames.append(rows)
                rows = {}
            else:
                key = (row["name"], tuple(row["tags"]), row["type"])
                require(key not in rows, f"{key} twice in a frame")
                rows[key] = row["value"]
    require(not rows, f"{path}: rows after the last frame")
    return frames


def _require_frame(got: dict, want: dict, totals: dict, what: str) -> None:
    """A jsonl frame equal to the reference flush, every value bitwise,
    and its counters equal to the totals sent."""
    require(set(got) == set(want),
            f"{what}: {len(set(got) ^ set(want))} keys differ, e.g. "
            f"{sorted(set(got) ^ set(want))[:4]}")
    bad = [k for k, v in want.items() if got[k] != v]
    require(not bad, f"{what}: {len(bad)} values differ, e.g. "
            f"{[(k, got[k], want[k]) for k in bad[:4]]}")
    sent = {k[0]: v for k, v in got.items()
            if k[0] in totals and k[2] == "counter"}
    require(sent == totals, f"{what}: counter totals differ from what was "
            f"sent ({len(totals)} counters sent, {len(sent)} flushed)")
    require(any(k[0].endswith("99percentile") for k in got),
            f"{what}: no percentile emitted")


def _cli_feeder(st: dict, ports_path: str, iv1: dict, iv2: dict,
                servers: list) -> None:
    """phase_cli's feeder thread: waits for the port file, sends the
    first interval, POSTs /flush, reads /config/json and one /query,
    sends the second interval and signals SIGTERM to this process.
    `servers` holds the Server the CLI started, whose native readers'
    count of parsed lines paces the sends.  Records what it saw in `st`; an exception lands in
    st["error"]."""
    signalled = False
    try:
        _wait_file(ports_path, lambda: not st.get("main_done"), "the CLI")
        st["boot_s"] = time.perf_counter() - st["t0"]
        ports = json.load(open(ports_path))
        require(ports["pid"] == os.getpid() and len(servers) == 1, ports)
        srv = servers[0]
        require(srv.native is not None, "the CLI's UDP is not native")
        st["readers"] = _readers(srv)
        addr = tuple(ports["statsd"][0][1])
        http_port = ports["http"][1]
        st["ingest_s"] = _paced_send(iv1["dgrams"], addr,
                                     lambda: _lines_in(srv))
        t = time.perf_counter()
        st["flush"] = _http(http_port, "/flush", "POST")
        st["flush_ms"] = (time.perf_counter() - t) * 1e3
        st["config_json"] = _http(http_port, "/config/json")
        st["query"] = _http(http_port, "/query?name=cli.h1&q=0.5,0.99")
        st["ingest2_s"] = _paced_send(iv2["dgrams"], addr,
                                      lambda: _lines_in(srv))
    except BaseException as e:      # re-raised by phase_cli
        st["error"] = e
    finally:
        if os.path.exists(ports_path) and not st.get("main_done"):
            signalled = True
            os.kill(os.getpid(), signal.SIGTERM)
        st["signalled"] = signalled


def _query_fields(body: dict) -> dict:
    return {k: body[k] for k in ("name", "quantiles", "count", "sum", "min",
                                 "max", "family", "slots_fused")}


def phase_cli_in_process(d: str, seed=13) -> dict:
    """`cli.veneur.main` in this process's main thread, as the command
    line runs it (signals included), on a YAML with two UDP sockets
    read by the native engine's C++ readers (the default config), the
    HTTP API with /config and POST /flush, a 3600 s interval, the query
    ring and a jsonl sink.  A feeder thread sends two intervals over
    UDP (`_paced_send`: paced by the lines the readers have parsed and
    the listener's queues, and each ended when the readers have parsed
    every line and the queues are empty), and cuts the first with POST
    /flush and the second with SIGTERM (the final flush).  The first
    holds sampled histogram keys, so its flush runs B1; the second has
    unit weights only, so B3.  Each frame must equal a port Server on
    the CPU fed the same datagrams, bitwise, with its counter totals
    equal to what was sent; /config/json must be the loaded config's
    redacted dump, /query the CPU server's answer.  Then the first
    interval goes through the same config with `native_ingest: false`
    (two Python readers), whose flush must equal the same reference."""
    import dataclasses

    from veneur_tpu_torch import config as config_mod
    from veneur_tpu_torch.cli import veneur as cli
    from veneur_tpu_torch.core.server import Server
    from veneur_tpu_torch.sinks.simple import ChannelMetricSink

    rng = np.random.default_rng(seed)
    iv1 = _cli_interval(rng, 10_000, 64, 1_000, 100, 10_000, 1_000,
                        sampled=True)
    iv2 = _cli_interval(rng, 1_000, 64, 100, 100, 1_000, 100, sampled=False)
    ports_path = os.path.join(d, "inproc-ports.json")
    frames_path = os.path.join(d, "inproc.jsonl")
    cfg_path = os.path.join(d, "inproc.yaml")
    with open(cfg_path, "w") as f:
        json.dump({
            "statsd_listen_addresses": ["udp://127.0.0.1:0"],
            "num_readers": 2, "read_buffer_size_bytes": CLI_RCVBUF,
            "http_address": "127.0.0.1:0", "port_file": ports_path,
            "http": {"config": True}, "http_flush_endpoint": True,
            "interval": "3600s", "query_window_slots": 8,
            "flush_on_shutdown": True, "hostname": "cli",
            "percentiles": PERCENTILES, "aggregates": CLI_AGGS,
            "metric_sinks": [{"kind": "jsonl",
                              "config": {"path": frames_path}}]}, f)

    # the Server the CLI starts, for its line count
    servers, start = [], Server.start

    def recording_start(self):
        servers.append(self)
        return start(self)

    for mod in _kernel_modules():
        mod.reset_launches()
    st = {"t0": time.perf_counter()}
    feeder = threading.Thread(target=_cli_feeder, daemon=True,
                              args=(st, ports_path, iv1, iv2, servers),
                              name="cli-feeder")
    Server.start = recording_start
    feeder.start()
    try:
        rc = cli.main(["-f", cfg_path, "-device", DEVICE])
    finally:
        Server.start = start
        st["main_done"] = True
        feeder.join(timeout=600)
    launches = _read_launches()
    require(not feeder.is_alive(), "the CLI feeder hung")
    if "error" in st:
        raise st["error"]
    require(st["signalled"] and rc == 0, f"the CLI returned {rc}")

    cfg = config_mod.read_config(cfg_path)
    sink = ChannelMetricSink()
    ref = Server(dataclasses.replace(cfg, statsd_listen_addresses=[],
                                     metric_sinks=[]),
                 extra_metric_sinks=[sink], device="cpu")
    frames = _jsonl_frames(frames_path)
    require(len(frames) == 2, f"{len(frames)} frames, not 2")
    for i, iv in enumerate((iv1, iv2)):
        for dg in iv["dgrams"]:
            ref.process_packet_buffer(dg)
        ref.flush()
        want = {(m.name, tuple(m.tags), m.type): m.value
                for m in sink.queue.get(timeout=60)}
        _require_frame(frames[i], want, iv["totals"], f"CLI frame {i + 1}")
        if i == 0:
            want1 = want
            code, body = st["query"]
            wcode, wbody = ref.query.serve({"name": ["cli.h1"],
                                            "q": ["0.5,0.99"]})
            require(code == wcode == 200, (code, body[:200]))
            require(_query_fields(json.loads(body)) == _query_fields(
                json.loads(json.dumps(wbody))), "GET /query differs")
    require(st["flush"][0] == 200
            and json.loads(st["flush"][1]) == {"flush_count": 1},
            st["flush"])
    code, body = st["config_json"]
    require(code == 200 and json.loads(body) == json.loads(json.dumps(
        config_mod.redacted_dict(cfg), default=str)),
        "GET /config/json is not the loaded config")
    b1, b3 = launches["weighted_eval"], launches["uniform_eval"]
    require(b1 >= 1 and b3 >= 1,
            f"the CLI's flushes missed a kernel: B1 {b1}, B3 {b3}")
    rate = iv1["lines"] / st["ingest_s"]
    card_log(f"CLI in process: port file {st['boot_s']:.2f} s after "
             f"main(); {iv1['lines']} lines in {len(iv1['dgrams'])} "
             f"datagrams through 2 native UDP readers ({st['readers']}) "
             f"in {st['ingest_s']:.3f} s ({rate:.0f} lines/s, at most "
             f"{CLI_WINDOW_LINES} lines in flight, none lost); POST "
             f"/flush {st['flush_ms']:.1f} ms; both frames (B1 {b1}, "
             f"then B3 {b3} at SIGTERM) bitwise the CPU server's, counter "
             f"totals as sent; /config/json and /query as expected")

    # the first interval again, through the Python readers
    sink = ChannelMetricSink()
    py = Server(dataclasses.replace(
        cfg, native_ingest=False, metric_sinks=[],
        statsd_listen_addresses=["udp://127.0.0.1:0"]),
        extra_metric_sinks=[sink], device=DEVICE)
    py.start()
    try:
        require(py.native is None, "native_ingest: false read natively")
        py_s = _paced_send(iv1["dgrams"], py.statsd_addrs[0][1],
                           lambda: py.aggregator.processed)
        py.flush()
        got = {(m.name, tuple(m.tags), m.type): m.value
               for m in sink.queue.get(timeout=60)}
    finally:
        py.shutdown()
    _require_frame(got, want1, iv1["totals"], "Python readers' flush")
    py_rate = iv1["lines"] / py_s
    card_log(f"CLI interval 1 through 2 UDP readers: native {rate:.0f} "
             f"lines/s, Python (native_ingest: false) {py_rate:.0f} "
             f"lines/s ({py_s:.3f} s); both flushes bitwise the CPU "
             f"server's")
    return {"boot_s": st["boot_s"], "ingest_lines": iv1["lines"],
            "ingest_datagrams": len(iv1["dgrams"]),
            "readers": st["readers"],
            "ingest_s": st["ingest_s"], "ingest_lines_per_s": rate,
            "python_ingest_s": py_s, "python_lines_per_s": py_rate,
            "ingest2_lines_per_s": iv2["lines"] / st["ingest2_s"],
            "flush_ms": st["flush_ms"], "launches": launches}


NATIVE_READERS = 4


def _raw(x):
    """The bytes of a dense-build output (a numpy array, a CPU bfloat16
    tensor or None)."""
    import torch
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.int16).numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


def phase_native_ingest(seed=14, n_keys=100_000, per=64) -> dict:
    """One interval of the global 100k x 64 shape over loopback UDP:
    100,000 histogram keys x 64 integer samples, 6.4M lines in
    datagrams of at most 4,096 bytes, into a port Server on the card
    through NATIVE_READERS C++ readers.  The sender is the engine's
    `blast_udp` (sendmmsg), in bursts no larger than one socket's
    receive buffer, each sent once the readers have parsed every line
    before it.  Checks every line counted and none malformed, the
    flush (B3) bitwise a server whose arena took the same samples in
    bulk (counts, sums, min, max and every percentile), and the dense
    build through the native fill with no fallback, bitwise the numpy
    builder on the same staged arrays, whose time it also takes."""
    import dataclasses

    from veneur_tpu_torch import config as config_mod
    from veneur_tpu_torch import ingest
    from veneur_tpu_torch.core import arena as arena_mod
    from veneur_tpu_torch.core.server import Server
    from veneur_tpu_torch.samplers import samplers as sm
    from veneur_tpu_torch.samplers.metric_key import MetricKey, MetricScope
    from veneur_tpu_torch.sinks.simple import ChannelMetricSink

    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 1000, (per, n_keys))
    t0 = time.perf_counter()
    dgrams = []
    for j in range(per):        # a datagram spans ~250 keys
        dgrams += _datagrams([b"fs.h%d:%d|h" % (k, v)
                              for k, v in enumerate(vals[j].tolist())])
    gen_s = time.perf_counter() - t0
    n_lines = n_keys * per
    cfg = config_mod.Config(
        statsd_listen_addresses=["udp://127.0.0.1:0"],
        num_readers=NATIVE_READERS, read_buffer_size_bytes=CLI_RCVBUF,
        interval=3600.0, percentiles=PERCENTILES, aggregates=CLI_AGGS,
        arena_initial_capacity=n_keys, hostname="fs")
    sink = ChannelMetricSink()
    srv = Server(cfg, extra_metric_sinks=[sink], device=DEVICE)
    built: list = []
    arena = srv.aggregator.digests
    build = arena.build_dense

    def capture(*args, **kw):
        out = build(*args, **kw)
        built.append((args, kw, out))
        return out

    arena.build_dense = capture
    srv.start()
    try:
        readers = _readers(srv)
        host, port = srv.statsd_addrs[0][1][:2]
        rcvbuf = srv._listeners[0].getsockopt(socket.SOL_SOCKET,
                                              socket.SO_RCVBUF)
        # a datagram of <= 4,096 bytes takes at most 8 KiB of a socket's
        # receive buffer
        burst = max(1, rcvbuf // 8192)
        drops0 = udp_queues(port)[1]
        t0 = time.perf_counter()
        sent = 0
        for i in range(0, len(dgrams), burst):
            chunk = dgrams[i:i + burst]
            require(ingest.blast_udp(host, port, len(chunk), chunk)
                    == len(chunk), "blast_udp sent short")
            sent += sum(d.count(b"\n") + 1 for d in chunk)
            deadline = time.monotonic() + 60
            while _lines_in(srv) < sent:
                require(time.monotonic() < deadline,
                        f"the readers parsed {_lines_in(srv)} of {sent} "
                        f"lines")
                time.sleep(0.0001)
        ingest_s = time.perf_counter() - t0
        drops = udp_queues(port)[1] - drops0
        t0 = time.perf_counter()
        res = srv.flush()
        flush_ms = (time.perf_counter() - t0) * 1e3
        seg = dict(srv.aggregator.last_flush_segments)
        totals = srv.native.engine.totals()
        got = sorted((m.name, m.value) for m in sink.queue.get(timeout=60))
    finally:
        srv.shutdown()
    require(sent == n_lines and drops == 0, f"{sent} lines, {drops} drops")
    require(totals == (n_lines, 0, len(dgrams), 0),
            f"engine totals (lines, malformed, datagrams, too long) "
            f"{totals}, sent {n_lines} lines in {len(dgrams)} datagrams")
    require(res.processed == n_lines, f"flushed {res.processed} lines")
    require(arena.dense_fill_native >= 1 and arena.dense_fill_fallbacks == 0,
            f"native fills {arena.dense_fill_native}, fallbacks "
            f"{arena.dense_fill_fallbacks}")

    # the same samples staged in bulk into a server of the same config
    ref_sink = ChannelMetricSink()
    ref = Server(dataclasses.replace(cfg, statsd_listen_addresses=[]),
                 extra_metric_sinks=[ref_sink], device=DEVICE)
    digests = ref.aggregator.digests
    rows = np.asarray([digests.row_for(
        MetricKey(f"fs.h{k}", sm.TYPE_HISTOGRAM, ""), MetricScope.MIXED, [])
        for k in range(n_keys)], np.int64)
    with ref.aggregator.lock:
        digests.sample_batch(np.tile(rows, per),
                             vals.reshape(-1).astype(np.float64),
                             np.ones(n_lines))
        ref.aggregator.processed += n_lines
    ref.flush()
    want = sorted((m.name, m.value) for m in ref_sink.queue.get(timeout=60))
    ref.shutdown()
    require(got == want, "the UDP interval's flush differs from the bulk "
            "one: " + str([(g, w) for g, w in zip(got, want) if g != w][:4]))

    # the numpy builder on the same staged arrays (the fill's threshold
    # raised past them), and the native fill again, each timed alone
    (args, kw, native_out), = built
    times = {}
    for label, limit in (("numpy", 1 << 62), ("native",
                                              arena_mod._NATIVE_FILL_MIN)):
        saved = arena_mod._NATIVE_FILL_MIN
        arena_mod._NATIVE_FILL_MIN = limit
        try:
            t0 = time.perf_counter()
            out = build(*args, **kw)
            times[label] = (time.perf_counter() - t0) * 1e3
        finally:
            arena_mod._NATIVE_FILL_MIN = saved
        require([_raw(a) for a in out] == [_raw(b) for b in native_out],
                f"the {label} build differs from the flush's")
    rate = n_lines / ingest_s
    out = {"lines": n_lines, "datagrams": len(dgrams), "readers": readers,
           "burst_datagrams": burst, "rcvbuf": rcvbuf, "gen_s": gen_s,
           "ingest_s": ingest_s, "lines_per_s": rate,
           "flush_ms": flush_ms,
           "build_ms": seg["build_s"] * 1e3,
           "numpy_build_ms": times["numpy"],
           "native_build_ms": times["native"], "segments": seg}
    card_log(f"native ingest, global {n_keys} x {per}: {n_lines} lines in "
             f"{len(dgrams)} datagrams (bursts of {burst}, SO_RCVBUF "
             f"{rcvbuf}) through {NATIVE_READERS} native UDP readers "
             f"({readers}) in {ingest_s:.3f} s ({rate:.0f} lines/s), every "
             f"line counted, none malformed, no drops; flush build_s "
             f"{seg['build_s'] * 1e3:.1f} ms through the native fill "
             f"(0 fallbacks); the same staged arrays: numpy builder "
             f"{times['numpy']:.1f} ms, native fill {times['native']:.1f} "
             f"ms, bitwise; counts, sums, min, max and {len(got)} values "
             f"bitwise the bulk-staged server's")
    return out



# ---------------------------------------------------------------------------
# Crash durability (core/checkpoint.py, forward/spool.py) and the
# cardinality guard (core/cardinality.py) at full width
# ---------------------------------------------------------------------------

# the gRPC cell's warm-up global flush, (name, value) sorted: the spool
# cell replays the same interval and must flush these bits
GRPC_WARM: dict = {}


def _metric_view(metrics) -> list:
    """A flush's metrics as sorted (name, tags, type, value), the form
    two flushes are held bitwise in."""
    return sorted((m.name, tuple(m.tags), m.type, m.value) for m in metrics)


def _first_diff(got, want) -> str:
    return str([(g, w) for g, w in zip(got, want) if g != w][:4]
               or (len(got), len(want)))


def _launch_delta(before: dict) -> dict:
    return {k: n - before[k] for k, n in _read_launches().items()
            if n != before[k]}


def durability_checkpoint(d, seed=17, n_digests=100_000, centroids=64,
                          n_counters=10_000, n_sets=1_000, members=100,
                          fresh_keys=10_000, fresh_per=16) -> dict:
    """A global with `checkpoint_dir`: `n_digests` imported t-digests of
    `centroids` centroids, `n_counters` counters and `n_sets` sets of
    `members` members (DogStatsD lines), then a mid-interval remainder
    of fresh samples (`fresh_per` each on `fresh_keys` keys, staged in
    bulk).  checkpoint_now(), crash(); a fresh server on the directory
    restores, and its flush (B1) is bitwise that of a twin that took the
    same data and never crashed: every percentile, count and set
    estimate.  Then the stale-marker case on the restored server:
    checkpoint, flush, crash; the next boot skips the arenas and its
    flush emits none of the delivered keys."""
    import torch
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.core.server import Server
    from veneur_tpu_torch.samplers import samplers as sm
    from veneur_tpu_torch.samplers.metric_key import MetricKey, MetricScope
    from veneur_tpu_torch.sinks.simple import ChannelMetricSink

    rng = np.random.default_rng(seed)
    means = np.sort(rng.integers(0, 5000, (n_digests, centroids)),
                    axis=1).astype(np.float64)
    wts = rng.integers(1, 50, (n_digests, centroids)).astype(np.float64)
    fms = [sm.ForwardMetric(
        name=f"ck.h{i}", tags=["az:a"], kind="histogram", scope=0,
        digest_means=means[i].tolist(), digest_weights=wts[i].tolist(),
        digest_min=float(means[i, 0]), digest_max=float(means[i, -1]),
        digest_rsum=float((wts[i] / np.maximum(means[i], 1.0)).sum()))
        for i in range(n_digests)]
    lines = [b"ck.c%d:%d|c" % (i, v) for i, v in
             enumerate(rng.integers(1, 100, n_counters).tolist())]
    for s in range(n_sets):
        lines += [b"ck.s%d:m%d|s" % (s, v)
                  for v in rng.integers(0, 10 * members, members).tolist()]
    dgrams = _datagrams(lines)
    fresh_vals = rng.integers(0, 5000, fresh_keys * fresh_per).astype(
        np.float64)
    tail = _datagrams([b"ck.c%d:1|c" % i for i in range(0, n_counters, 7)])

    def boot(path, sink):
        os.makedirs(path, exist_ok=True)
        srv = Server(Config(interval=3600.0, percentiles=PERCENTILES,
                            aggregates=CLI_AGGS, hostname="ck-global",
                            checkpoint_dir=path,
                            arena_initial_capacity=n_digests + fresh_keys),
                     extra_metric_sinks=[sink], device=DEVICE)
        srv.start()
        return srv

    def feed(srv):
        t0 = time.perf_counter()
        ok, failed = srv.aggregator.import_metrics(fms)
        require((ok, failed) == (n_digests, 0), (ok, failed))
        for dg in dgrams:
            srv.process_packet_buffer(dg)
        agg = srv.aggregator
        rows = np.asarray([agg.digests.row_for(
            MetricKey(f"ck.f{i}", sm.TYPE_HISTOGRAM, ""), MetricScope.MIXED,
            []) for i in range(fresh_keys)], np.int64)
        with agg.lock:
            agg.digests.sample_batch(np.repeat(rows, fresh_per), fresh_vals,
                                     np.ones(len(fresh_vals)))
            agg.processed += len(fresh_vals)
        return time.perf_counter() - t0

    twin_sink, a_sink = ChannelMetricSink(), ChannelMetricSink()
    twin = boot(os.path.join(d, "twin"), twin_sink)
    a = boot(os.path.join(d, "ckpt"), a_sink)
    try:
        feed_s = feed(a)
        feed(twin)
        require(a.checkpoint_now(), "the checkpoint write failed")
        st = dict(a.checkpoint_stats)
    finally:
        a.crash()
    b_sink = ChannelMetricSink()
    t0 = time.perf_counter()
    b = boot(os.path.join(d, "ckpt"), b_sink)
    boot_s = time.perf_counter() - t0
    try:
        require(b.checkpoint_stats["restores"] == 1 and b.flush_count == 0,
                f"restore: {b.checkpoint_stats}")
        for srv in (b, twin):
            for dg in tail:
                srv.process_packet_buffer(dg)
        # the restored cut, checkpointed again before the flush that
        # delivers it: the stale-marker case's checkpoint
        require(b.checkpoint_now(), "the second checkpoint failed")
        st2 = dict(b.checkpoint_stats)
        l0 = _read_launches()
        t0 = time.perf_counter()
        b.flush()
        torch.cuda.synchronize()
        flush_ms = (time.perf_counter() - t0) * 1e3
        launches = _launch_delta(l0)
        seg = dict(b.aggregator.last_flush_segments)
        twin.flush()
        got = _metric_view(b_sink.queue.get(timeout=120))
        want = _metric_view(twin_sink.queue.get(timeout=120))
    finally:
        b.crash()
        twin.shutdown()
    require(len(want) >= (n_digests + fresh_keys) * len(PERCENTILES)
            + n_counters + n_sets, f"the twin emitted {len(want)} metrics")
    require(got == want, "the restored flush differs from the uncrashed "
            "twin's: " + _first_diff(got, want))
    require(launches.get("weighted_eval", 0) == 1,
            f"the restored flush launched {launches}")
    c_sink = ChannelMetricSink()
    c = boot(os.path.join(d, "ckpt"), c_sink)
    try:
        cst = dict(c.checkpoint_stats)
        require(cst["stale_skips"] == 1 and cst["restores"] == 0
                and c.flush_count == 1 and not c.aggregator.digests.kdict,
                f"the stale checkpoint restored: {cst}")
        c.flush()
        stale = c_sink.queue.get(timeout=60)
    finally:
        c.shutdown()
    delivered = {g[0] for g in got}
    require(not [m for m in stale if m.name in delivered],
            "the stale checkpoint's keys were emitted again")
    out = {"digests": n_digests, "centroids": centroids,
           "counters": n_counters, "sets": n_sets, "members": members,
           "fresh_samples": len(fresh_vals), "feed_s": feed_s,
           "checkpoint_bytes": st["last_bytes"],
           "checkpoint_ms": st["last_ms"],
           "capture_ms": st["last_capture_ms"],
           "checkpoint2_bytes": st2["last_bytes"],
           "checkpoint2_ms": st2["last_ms"],
           "checkpoint2_capture_ms": st2["last_capture_ms"],
           "restore_ms": st2["restore_ms"], "boot_s": boot_s,
           "flush_ms": flush_ms, "launches": launches,
           "metrics": len(got), "segments": seg}
    card_log(
        f"checkpoint at {n_digests} imported {centroids}-centroid digests, "
        f"{n_counters} counters, {n_sets} sets of {members}, "
        f"{len(fresh_vals)} fresh samples: {st['last_bytes']} bytes in "
        f"{st['last_ms']:.1f} ms, the aggregator lock held "
        f"{st['last_capture_ms']:.1f} ms of it (sync and capture); crash; "
        f"the "
        f"restore {st2['restore_ms']:.1f} ms (boot {boot_s:.2f} s); the "
        f"restored flush {flush_ms:.1f} ms (B1 {launches}), its {len(got)} "
        f"metrics bitwise the uncrashed twin's (segments: snapshot "
        f"{seg['snapshot_s'] * 1e3:.1f} ms, build "
        f"{seg['build_s'] * 1e3:.1f} ms, kernel "
        f"{seg.get('kernel_ms', 0.0):.3f} ms, emit "
        f"{seg['emit_s'] * 1e3:.1f} ms); the restored cut checkpointed "
        f"again ({st2['last_bytes']} bytes, {st2['last_ms']:.1f} ms), "
        f"flushed, crashed: the next boot skipped the stale arenas and "
        f"emitted none of the {len(delivered)} delivered names")
    return out


def _reserve_port() -> socket.socket:
    """A TCP port held bound (not listening) for a server that starts
    later: a connect is refused until then, and nothing else can take
    the port.  SO_REUSEPORT lets the gRPC server, which sets it too,
    bind beside it."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    s.bind(("127.0.0.1", 0))
    return s


def _late_global(port: int, reserved: socket.socket, sinks, **kw):
    """Start a port global on the reserved port; if the network stack
    refuses the second bind, release the reservation and retry."""
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.core.server import Server

    for attempt in range(50):
        glob = Server(Config(grpc_address=f"127.0.0.1:{port}",
                             interval=3600.0, percentiles=PERCENTILES,
                             **kw), extra_metric_sinks=sinks, device=DEVICE)
        try:
            glob.start()
            break
        except OSError:
            glob.shutdown()
            reserved.close()
            require(attempt < 49, f"port {port} never became free")
            time.sleep(0.05)
    reserved.close()
    return glob


def durability_spool(d, seed=12, n_keys=100_000, per=64) -> dict:
    """The gRPC cell's first interval (its seed and shape: 100,000 keys
    x 64 samples forwarding 64-centroid digests) from a local with
    `spool_dir` to a global address that is not up yet.  Every chunk
    spills and nothing is dropped; the local crashes; a new local on the
    same spool_dir recovers the records; the global comes up and the
    replayer delivers them.  The global's flush (B1) is bitwise the gRPC
    cell's direct forward of the same data; the spool ends with no
    pending record and no segment file; the dedup ledger merged each
    chunk once."""
    import torch
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.core.aggregator import MetricAggregator
    from veneur_tpu_torch.core.server import Server
    from veneur_tpu_torch.samplers import samplers as sm
    from veneur_tpu_torch.samplers.metric_key import MetricKey, MetricScope
    from veneur_tpu_torch.sinks.simple import ChannelMetricSink

    rng = np.random.default_rng(seed)
    spool_dir = os.path.join(d, "spool")
    reserved = _reserve_port()
    port = reserved.getsockname()[1]
    # above the interval's forward (134.0 MB in 50 V1 chunks in the gRPC
    # cell; the default 64 MiB would evict)
    cfg = dict(forward_address=f"127.0.0.1:{port}", interval=3600.0,
               percentiles=PERCENTILES, hostname="spool-local",
               arena_initial_capacity=n_keys, forward_timeout=120.0,
               forward_max_retries=1, forward_retry_backoff=0.05,
               forward_deadline_retry_safe=True, spool_dir=spool_dir,
               spool_max_bytes=1 << 30)
    a = Server(Config(**cfg), device=DEVICE)
    a.start()
    try:
        digests = a.aggregator.digests
        rows = np.asarray([digests.row_for(
            MetricKey(f"grpc.k{i}", sm.TYPE_HISTOGRAM, ""),
            MetricScope.MIXED, []) for i in range(n_keys)], np.int64)
        vals = rng.gamma(2.0, 10.0, n_keys * per)
        wts = np.repeat(rng.integers(1, 50, n_keys), per).astype(np.float64)
        with a.aggregator.lock:
            digests.sample_batch(np.repeat(rows, per), vals, wts)
            digests.touched[rows] = True
        a.aggregator.sync_staged(min_samples=1)
        t0 = time.perf_counter()
        res = a.flush()
        t1 = time.perf_counter()
        require(a.wait_forwards(600.0), "the spilling forward never returned")
        t2 = time.perf_counter()
        cst, sst = a.forwarder.stats(), a.forwarder.spool_stats()
    finally:
        a.crash()
    require(len(res.forward) == n_keys and cst["spilled"] == n_keys
            and cst["dropped"] == 0 and sst["spilled_points"] == n_keys
            and sst["expired"] == 0 and sst["dropped"] == 0,
            f"spill: client {cst}, spool {sst}")
    segs = [f for f in os.listdir(spool_dir) if f.endswith(".seg")]
    sink = ChannelMetricSink()
    b = Server(Config(**cfg), device=DEVICE)
    glob = None
    try:
        b.start()
        rst = b.forwarder.spool_stats()
        require(rst["recovered"] == sst["spilled"]
                and rst["recovered_points"] == n_keys
                and rst["torn_records"] == 0 and rst["crc_rejected"] == 0,
                f"recovery: {rst}")
        t3 = time.perf_counter()
        glob = _late_global(port, reserved, [sink], hostname="spool-global",
                            arena_initial_capacity=n_keys)
        deadline = time.monotonic() + 600.0
        while b.forwarder.spool_stats()["pending_records"] > 0:
            require(time.monotonic() < deadline,
                    f"replay: {b.forwarder.spool_stats()}")
            time.sleep(0.01)
        t4 = time.perf_counter()
        fst, bst = b.forwarder.spool_stats(), b.forwarder.stats()
        ded = glob.dedup.stats()
        imported = glob.grpc_import.imported_count
        l0 = _read_launches()
        t5 = time.perf_counter()
        glob.flush()
        torch.cuda.synchronize()
        gflush_ms = (time.perf_counter() - t5) * 1e3
        launches = _launch_delta(l0)
        got = sorted((m.name, m.value) for m in sink.queue.get(timeout=120))
    finally:
        b.shutdown()
        if glob is not None:
            glob.shutdown()
    left = [f for f in os.listdir(spool_dir) if f.endswith(".seg")]
    require(fst["replayed"] == sst["spilled"]
            and fst["replayed_points"] == n_keys and fst["dropped"] == 0
            and fst["expired"] == 0 and fst["pending_records"] == 0
            and not left, f"replay: {fst}, segment files left {left}")
    require(imported == n_keys and ded["duplicates"] == 0
            and ded["recorded"] == sst["spilled"],
            f"the global imported {imported}, ledger {ded}")
    require(launches.get("weighted_eval", 0) == 1,
            f"the global flush launched {launches}")
    want = GRPC_WARM.get("flush")
    against = "the gRPC cell's direct forward of the same interval"
    if want is None or GRPC_WARM.get("shape") != (seed, n_keys, per):
        ref = MetricAggregator(percentiles=PERCENTILES, is_local=False,
                               initial_capacity=n_keys, device=DEVICE)
        ref.import_metrics(res.forward)
        want = sorted((m.name, m.value)
                      for m in ref.flush(is_local=False).metrics)
        against = "an in-process import of the same forward"
    require(got == want, f"the replayed global differs from {against}: "
            + _first_diff(got, want))
    out = {"keys": n_keys, "per": per, "chunks": sst["spilled"],
           "segments": len(segs), "spill_bytes": sst["pending_bytes"],
           "local_flush_ms": (t1 - t0) * 1e3,
           "spill_ms": (t2 - t1) * 1e3,
           "replay_ms": (t4 - t3) * 1e3,
           "replay_bytes": bst["bytes_sent"],
           "replay_attempts": fst["replay_attempts"],
           "global_flush_ms": gflush_ms, "launches": launches,
           "against": against}
    card_log(
        f"spool: local {n_keys} x {per} -> a global not up yet: "
        f"{sst['spilled']} V1 chunks ({n_keys} digests) spilled, "
        f"{sst['pending_bytes']} bytes in {len(segs)} segment files, "
        f"{(t2 - t1) * 1e3:.1f} ms from the local flush's return "
        f"(encode, 2 refused attempts, the spill), none dropped; crash; a "
        f"new local recovered {rst['recovered']} records; the global came "
        f"up and the replayer delivered {bst['bytes_sent']} bytes in "
        f"{(t4 - t3) * 1e3:.1f} ms ({fst['replay_attempts']} attempts); "
        f"no pending record, no segment file, the ledger recorded "
        f"{ded['recorded']} chunks, 0 duplicates; the global flush "
        f"{gflush_ms:.1f} ms, its {len(got)} percentiles bitwise "
        f"{against}")
    return out


def _guard_lines(rng, tenants, keys, samples, lo, hi, vpl=16):
    """Multi-value DogStatsD lines (`vpl` values a line) giving keys
    `lo`..`hi` of each tenant `samples[j]` integer samples; -> (lines,
    values)."""
    lines, n = [], 0
    for t in range(tenants):
        tag = b"tenant:t%d" % t
        for j in range(lo, hi):
            vals = rng.integers(0, 1000, samples[j]).tolist()
            n += len(vals)
            for i in range(0, len(vals), vpl):
                lines.append(b"dg.k%d:%s|h|#%s" % (
                    j, b":".join(b"%d" % v for v in vals[i:i + vpl]), tag))
    return lines, n


def _ledger(agg) -> dict:
    """The guard's quota ledger with its lists sorted (a drain resolves
    ids in engine order, which differs between engines)."""
    state = agg.cardinality.checkpoint_state()
    for ts in state["tenants"].values():
        for part in ("exact", "idle", "candidates"):
            ts[part] = sorted(ts[part])
    return state


def durability_guard(seed=18, tenants=25, keys=4000, per=64, budget=2000):
    """`tenants` x `keys` histogram keys (`tenant:<t>`) x `per` integer
    samples an interval, `cardinality_key_budget` `budget`, over UDP
    through NATIVE_READERS native readers into a local that forwards to
    a global over gRPC.  The first interval sends each tenant's first
    `budget` keys, drains, then the rest, so each tenant's exact set is
    those keys whatever order the readers take; the second gives the
    exact keys half and the rolled keys 1.5 times `per` samples, so its
    cut evicts every exact key.  Each interval is held against a
    device="cpu" port local fed the same datagrams in the same order
    through its own engine, and a CPU global importing that local's
    forward: the local's metrics and the guard's ledger equal, the
    global's keys, counts and percentiles bitwise (a rollup percentile
    may differ by the device's pre-reduction of its deep row: counted
    and held within 1% of the key's span, the hop tolerance)."""
    import torch
    from veneur_tpu_torch import ingest
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.core.aggregator import MetricAggregator
    from veneur_tpu_torch.core.server import Server
    from veneur_tpu_torch.samplers import samplers as sm
    from veneur_tpu_torch.sinks.simple import ChannelMetricSink

    rng = np.random.default_rng(seed)
    gsink, lsink = ChannelMetricSink(), ChannelMetricSink()
    glob = Server(Config(grpc_address="127.0.0.1:0", interval=3600.0,
                         percentiles=PERCENTILES, aggregates=CLI_AGGS,
                         hostname="guard-global",
                         arena_initial_capacity=tenants * budget + 1024),
                  extra_metric_sinks=[gsink], device=DEVICE)
    glob.start()
    guard = dict(cardinality_key_budget=budget, cardinality_seed=seed)
    local = Server(Config(
        statsd_listen_addresses=["udp://127.0.0.1:0"],
        num_readers=NATIVE_READERS, read_buffer_size_bytes=CLI_RCVBUF,
        forward_address=f"127.0.0.1:{glob.grpc_import.port}",
        forward_timeout=120.0, interval=3600.0, percentiles=PERCENTILES,
        aggregates=CLI_AGGS, hostname="guard-local",
        arena_initial_capacity=tenants * keys, **guard),
        extra_metric_sinks=[lsink], device=DEVICE)
    cpu_local = MetricAggregator(
        percentiles=PERCENTILES, aggregates=sm.parse_aggregates(CLI_AGGS),
        is_local=True, initial_capacity=tenants * keys, device="cpu",
        **guard)
    cpu_glob = MetricAggregator(
        percentiles=PERCENTILES, aggregates=sm.parse_aggregates(CLI_AGGS),
        is_local=False, initial_capacity=tenants * budget + 1024,
        device="cpu")
    nat = ingest.NativeIngest(cpu_local)
    tid = nat.engine.new_thread()
    intervals = []
    try:
        local.start()
        readers = _readers(local)
        host, port = local.statsd_addrs[0][1][:2]
        # a datagram of <= 4,096 bytes takes at most 8 KiB of a socket's
        # receive buffer; one sender's flow lands on one reader's socket,
        # and a burst fills at most half of it
        burst = max(1, local._listeners[0].getsockopt(
            socket.SOL_SOCKET, socket.SO_RCVBUF) // 16384)

        def send(dgrams, dgram_vals):
            """Blast the datagrams, each burst once the readers parsed
            every value before it, and drain; then the same datagrams
            into the CPU engine, drained.  -> (seconds, bytes)."""
            base = _lines_in(local)
            upto = np.cumsum(dgram_vals)
            t0 = time.perf_counter()
            for i in range(0, len(dgrams), burst):
                chunk = dgrams[i:i + burst]
                require(ingest.blast_udp(host, port, len(chunk), chunk)
                        == len(chunk), "blast_udp sent short")
                want = int(upto[i + len(chunk) - 1])
                deadline = time.monotonic() + 60
                while _lines_in(local) - base < want:
                    require(time.monotonic() < deadline,
                            f"the readers parsed {_lines_in(local) - base}"
                            f" of {want} values")
                    time.sleep(0.0001)
            secs = time.perf_counter() - t0
            require(_lines_in(local) - base == int(upto[-1]),
                    f"{_lines_in(local) - base} of {upto[-1]} values")
            local._drain_native()
            for dg in dgrams:
                nat.engine.ingest(tid, dg)
            nat.drain_into()
            return secs, sum(len(dg) for dg in dgrams)

        for it in range(2):
            phases = ([(0, budget), (budget, keys)] if it == 0
                      else [(0, keys)])
            samples = ([per] * keys if it == 0
                       else [per // 2] * budget + [per * 3 // 2]
                       * (keys - budget))
            ingest_s = n_vals = n_bytes = 0
            for lo, hi in phases:
                lines, n = _guard_lines(rng, tenants, keys, samples, lo, hi)
                dgrams = _datagrams(lines)
                dgram_vals = [(dg.count(b":") - dg.count(b"\n") - 1)
                              for dg in dgrams]
                require(sum(dgram_vals) == n, "value count of the datagrams")
                secs, nb = send(dgrams, dgram_vals)
                ingest_s += secs
                n_vals += n
                n_bytes += nb
            require(_ledger(local.aggregator) == _ledger(cpu_local),
                    f"interval {it}: the guard's ledger differs from the CPU "
                    f"port's")
            imp0 = glob.grpc_import.imported_count
            l0 = _read_launches()
            t0 = time.perf_counter()
            res = local.flush()
            torch.cuda.synchronize()
            lflush_ms = (time.perf_counter() - t0) * 1e3
            l_launch = _launch_delta(l0)
            deadline = time.monotonic() + 600
            while glob.grpc_import.imported_count < imp0 + len(res.forward):
                require(time.monotonic() < deadline, "the guard forward")
                time.sleep(0.001)
            require(local.wait_forwards(120.0), "the guard forward")
            l1 = _read_launches()
            t1 = time.perf_counter()
            glob.flush()
            torch.cuda.synchronize()
            gflush_ms = (time.perf_counter() - t1) * 1e3
            g_launch = _launch_delta(l1)
            cres = cpu_local.flush(is_local=True)
            ok, failed = cpu_glob.import_metrics(cres.forward)
            require(failed == 0, f"{failed} CPU imports failed")
            cgres = cpu_glob.flush(is_local=False)
            lgot = _metric_view(lsink.queue.get(timeout=120))
            lwant = _metric_view(cres.metrics)
            # each key's span, from the local's .min and .max rows
            ext = {(m[0], m[1]): m[3] for m in lwant
                   if m[0].endswith((".min", ".max"))}
            require(lgot == lwant, f"interval {it}: the local differs from "
                    "the CPU port's: " + _first_diff(lgot, lwant))
            ggot = {k[:3]: k[3] for k in
                    _metric_view(gsink.queue.get(timeout=120))}
            gwant = {k[:3]: k[3] for k in _metric_view(cgres.metrics)}
            require(set(ggot) == set(gwant),
                    f"interval {it}: the global's keys differ from the CPU "
                    f"port's")
            rolled_diff = worst = 0
            for k, w in gwant.items():
                g = ggot[k]
                if g == w:
                    continue
                pct = k[0].endswith("percentile") or k[0].endswith(".median")
                require("veneur_rollup:true" in k[1] and pct,
                        f"interval {it}: {k}: {g} on the card, {w} on the "
                        f"CPU")
                rolled_diff += 1
                name = k[0].rsplit(".", 1)[0]
                span = ext[(name + ".max", k[1])] - ext[(name + ".min", k[1])]
                worst = max(worst, abs(g - w) / span)
                require(abs(g - w) <= 0.01 * span,
                        f"interval {it}: rollup {k}: {g} against {w}")
            g = local.aggregator.cardinality
            roll = [f for f in res.forward
                    if f.name.startswith("veneur.rollup.")]
            require(len(roll) == tenants
                    and len(res.forward) == tenants * budget + tenants,
                    f"interval {it}: forwarded {len(res.forward)}, "
                    f"{len(roll)} rollups")
            require(_ledger(local.aggregator) == _ledger(cpu_local)
                    and g.epoch == it, f"after interval {it}: epoch "
                    f"{g.epoch}, ledgers equal "
                    f"{_ledger(local.aggregator) == _ledger(cpu_local)}")
            intervals.append({
                "values": n_vals, "bytes": n_bytes, "ingest_s": ingest_s,
                "values_per_s": n_vals / ingest_s,
                "local_flush_ms": lflush_ms, "global_flush_ms": gflush_ms,
                "local_launches": l_launch, "global_launches": g_launch,
                "forwarded": len(res.forward),
                "rollup_points": g.rollup_points_total,
                "keys_evicted": g.keys_evicted_total, "epoch": g.epoch,
                "global_metrics": len(ggot),
                "rollup_percentiles_not_bitwise": rolled_diff,
                "rollup_worst_span_share": worst,
                "local_segments": dict(
                    local.aggregator.last_flush_segments)})
    finally:
        nat.close()
        local.shutdown()
        glob.shutdown()
    last = intervals[-1]
    require(last["epoch"] == 1
            and last["keys_evicted"] - intervals[0]["keys_evicted"]
            == 2 * tenants * budget,
            f"the second interval's cut evicted "
            f"{last['keys_evicted'] - intervals[0]['keys_evicted']}")
    out = {"tenants": tenants, "keys": tenants * keys, "per": per,
           "budget": budget, "readers": readers, "intervals": intervals}
    for it, iv in enumerate(intervals):
        card_log(
            f"guard interval {it}: {tenants} tenants x {keys} keys, budget "
            f"{budget}: {iv['values']} values over UDP ({readers}) in "
            f"{iv['ingest_s']:.2f} s ({iv['values_per_s']:.0f} values/s); "
            f"local flush {iv['local_flush_ms']:.1f} ms "
            f"({iv['local_launches']}), {iv['forwarded']} digests forwarded "
            f"({tenants} rollups), global flush "
            f"{iv['global_flush_ms']:.1f} ms ({iv['global_launches']}); "
            f"rollup points {iv['rollup_points']}, keys evicted "
            f"{iv['keys_evicted']} (rolled sightings and swaps), epoch "
            f"{iv['epoch']}; the local's metrics and the ledger equal the "
            f"CPU port's, the global's {iv['global_metrics']} metrics "
            f"bitwise but {iv['rollup_percentiles_not_bitwise']} rollup "
            f"percentiles (worst {iv['rollup_worst_span_share']:.2e} of "
            f"the span)")
    return out


def phase_durability() -> dict:
    """Checkpoint and crash, the spool, and the guard at full width."""
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        return {"checkpoint": durability_checkpoint(d),
                "spool": durability_spool(d),
                "guard": durability_guard()}


# ---------------------------------------------------------------------------
# the egress plane and the metric sinks (example.yaml's own)
# ---------------------------------------------------------------------------

EXAMPLE_ENV = {"DATADOG_API_KEY": "k", "SPLUNK_HEC_TOKEN": "t"}
EGRESS_SECRET = "egress-test-secret"
# the outage sink's breaker cooldown: long enough that interval 2 finds
# it open, short enough that the replay after the release comes soon
EGRESS_BREAKER_RESET_S = 10.0
# the outage backend answers 503 after this long (under the datadog
# sink's 10 s request timeout): a slow, failing backend that keeps its
# lane busy while the second interval is fed and flushed
EGRESS_OUTAGE_DELAY_S = 5.0


class _StatsdLog:
    """A self-metrics client that keeps every count (the lanes emit the
    cause of each spill as a tag)."""

    def __init__(self):
        self.counts = []
        self.lock = threading.Lock()

    def count(self, name, value, tags=None, rate=1.0):
        with self.lock:
            self.counts.append((name, value, tuple(tags or ())))

    def timing(self, *a, **kw):
        pass

    def gauge(self, *a, **kw):
        pass

    def close(self):
        pass


def _example_egress_config():
    """example.yaml through the port's loader, with the options the port
    refuses (span sinks, listeners, self-telemetry: ROADMAP A15, A16)
    removed one by one as the loader names them.  Returns the loaded
    Config and the removed option names."""
    import tempfile

    import yaml
    from veneur_tpu_torch import config as tconfig
    with open(os.path.join(ROOT, "example.yaml")) as f:
        data = yaml.safe_load(f)
    removed = []
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "example.yaml")
        for _ in range(64):
            with open(path, "w") as f:
                yaml.safe_dump(data, f, sort_keys=False)
            try:
                return tconfig.read_config(path, environ=EXAMPLE_ENV), removed
            except NotImplementedError as e:
                name = str(e).split("config option ", 1)[1].split("=", 1)[0]
            removed.append(name)
            if name in data:
                del data[name]
            else:
                del data["features"][name]
    raise AssertionError(f"example.yaml still refused after {removed}")


class _EgressCapture:
    """A loopback HTTP endpoint for one sink, bound before the server
    starts.  Keeps every request it answered 200; answers `refuse_code`
    (counting them) until release(); with `secret` it recomputes each
    request's SigV4 signature and answers 403 to a mismatch."""

    def __init__(self, refuse_code=None, secret=None, refuse_delay_s=0.0):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        from veneur_tpu_torch.util import awsauth
        cap = self
        self.got, self.refused, self.bad_sig = [], 0, 0
        self.nbytes = 0
        self.refuse_code = refuse_code
        self.lock = threading.Lock()

        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _handle(self):
                body = self.rfile.read(int(self.headers.get(
                    "Content-Length", 0)))
                code = 200
                with cap.lock:
                    refusing = cap.refuse_code is not None
                    if refusing:
                        cap.refused += 1
                if refusing:
                    time.sleep(refuse_delay_s)
                with cap.lock:
                    if refusing:
                        code = cap.refuse_code or 503
                    elif secret is not None and not awsauth.verify_signature(
                            self.command,
                            f"http://{self.headers['Host']}{self.path}",
                            dict(self.headers), body, secret):
                        cap.bad_sig += 1
                        code = 403
                    else:
                        cap.got.append((self.path, dict(self.headers), body))
                        cap.nbytes += len(body)
                self.send_response(code)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"{}")

            do_POST = do_PUT = do_GET = _handle

            def log_message(self, *a):
                pass

        self.srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.srv.daemon_threads = True
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}"
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()

    def release(self):
        with self.lock:
            self.refuse_code = None

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()


def _dd_view(m, interval_s):
    """A metric as the datadog series carries it (name, tags without
    host:/device:, value as a rate for counters)."""
    v = m.value / interval_s if m.type == "counter" else m.value
    return (m.name, tuple(t for t in m.tags
                          if not t.startswith(("host:", "device:"))), v)


def _dd_received(cap) -> list:
    import gzip
    out = []
    for path, _, body in cap.got:
        if path.startswith("/api/v1/series"):
            for s in json.loads(gzip.decompress(body))["series"]:
                out.append((s["metric"], tuple(s["tags"]), s["points"][0][1]))
    return out


def _read_uvarint(b, p):
    r = s = 0
    while True:
        c = b[p]
        p += 1
        r |= (c & 0x7F) << s
        if c < 0x80:
            return r, p
        s += 7


def _pb_fields(b):
    """(field number, value) pairs of one protobuf message: bytes for
    length-delimited fields, ints for varints, 8 raw bytes for fixed64."""
    p, out = 0, []
    while p < len(b):
        key, p = _read_uvarint(b, p)
        wt = key & 7
        if wt == 2:
            n, p = _read_uvarint(b, p)
            out.append((key >> 3, b[p:p + n]))
            p += n
        elif wt == 0:
            v, p = _read_uvarint(b, p)
            out.append((key >> 3, v))
        elif wt == 1:
            out.append((key >> 3, b[p:p + 8]))
            p += 8
        else:
            raise ValueError(f"wire type {wt}")
    return out


def _cortex_received(cap) -> list:
    import struct
    from veneur_tpu_torch.util import snappy
    out = []
    for _, _, body in cap.got:
        for _, ts in _pb_fields(snappy.decompress(body)):
            labels, value = [], None
            for f, v in _pb_fields(ts):
                if f == 1:
                    lf = dict(_pb_fields(v))
                    labels.append((lf[1].decode(), lf[2].decode()))
                else:
                    value = struct.unpack("<d", dict(_pb_fields(v))[1])[0]
            out.append((tuple(labels), value))
    return out


def _cortex_view(m, default_labels):
    from veneur_tpu_torch.sinks.cortex import sanitize_label
    labels = {"__name__": sanitize_label(m.name)}
    labels.update(default_labels)
    for t in m.tags:
        k, v = t.split(":", 1) if ":" in t else (t, "true")
        labels[sanitize_label(k)] = v
    if m.hostname and "hostname" not in labels:
        labels["hostname"] = m.hostname
    return (tuple(sorted(labels.items())), float(m.value))


def _s3_received(cap) -> list:
    import gzip
    rows = []
    for _, _, body in cap.got:
        rows += gzip.decompress(body).decode().splitlines()
    return rows


def phase_egress(seed=19, n_digests=100_000, centroids=64,
                 n_counters=10_000, n_sets=1_000, members=100) -> dict:
    """example.yaml's metric sinks (datadog, cortex, s3-archive,
    blackhole), its `archive-everything` routing rule and its
    `tags_exclude` (nonce everywhere, host_env for datadog), loaded by
    the port's loader with every endpoint on a loopback capture, plus a
    `datadog-outage` sink in the rule whose capture answers 503 until
    released.  Two full-width intervals (`n_digests` imported t-digests
    of `centroids` centroids, `n_counters` counters, `n_sets` sets,
    every row tagged nonce: and host_env:) flush through B1 while the
    outage lasts; then the release.  Each capture decodes what it
    received and must hold exactly what the port's
    `filter_metrics_for_sink` gives that sink on the rendered interval;
    the outage sink retries, trips its breaker, spills interval 1 and
    interval 2 (breaker open) and, after the release, receives each
    interval once; the plane ends with its ledger closed, nothing
    pending and nothing dropped.

    The datadog sink, like the JAX package's, reports a failed post as
    dropped points rather than raising, so a plain datadog sink behind
    an outage drops with accounting and never spills.  The outage sink
    is a datadog sink whose flush raises when it dropped anything, which
    is what a lane retries, trips its breaker on and spools."""
    import datetime
    import tempfile

    import torch
    from veneur_tpu_torch import sinks as sink_mod
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.core.server import Server
    from veneur_tpu_torch.samplers import samplers as sm
    from veneur_tpu_torch.sinks.datadog import DatadogMetricSink
    from veneur_tpu_torch.sinks.simple import encode_tsv_row

    example, removed = _example_egress_config()
    captures = {"datadog": _EgressCapture(),
                "cortex": _EgressCapture(),
                "s3-archive": _EgressCapture(secret=EGRESS_SECRET),
                "datadog-outage": _EgressCapture(
                    refuse_code=503, refuse_delay_s=EGRESS_OUTAGE_DELAY_S)}
    specs = []
    for spec in example.metric_sinks:
        cfg = dict(spec.config)
        if spec.kind == "datadog":
            cfg["api_hostname"] = captures[spec.name].url
        elif spec.kind == "cortex":
            cfg["url"] = captures[spec.name].url + "/api/v1/push"
        elif spec.kind == "s3":
            cfg.update(aws_endpoint=captures[spec.name].url,
                       aws_access_key_id="AKIDEGRESS",
                       aws_secret_access_key=EGRESS_SECRET)
        specs.append(sink_mod.SinkSpec(
            kind=spec.kind, name=spec.name, config=cfg,
            max_name_length=spec.max_name_length,
            max_tag_length=spec.max_tag_length, max_tags=spec.max_tags,
            strip_tags=spec.strip_tags, add_tags=spec.add_tags))
    require([s.name for s in specs] == ["datadog", "cortex", "s3-archive",
                                        "blackhole"],
            f"example.yaml's sinks: {[s.name for s in specs]}")
    # nothing may leave the machine: every endpoint on the loopback
    for s in specs:
        for key in ("api_hostname", "url", "aws_endpoint"):
            url = s.config.get(key)
            require(url is None or url.startswith("http://127.0.0.1:"),
                    f"sink {s.name} {key} {url} is not a loopback capture")
    routing = list(example.metric_sink_routing)
    require(example.enable_metric_sink_routing and len(routing) == 1
            and routing[0].name == "archive-everything",
            f"example.yaml's routing: {routing}")
    routing[0].matched = list(routing[0].matched) + ["datadog-outage"]
    require(example.tags_exclude == ["nonce", "host_env|datadog"],
            f"example.yaml's tags_exclude: {example.tags_exclude}")

    class OutageDatadogSink(DatadogMetricSink):
        """A datadog sink whose flush raises when it dropped points."""

        def flush(self, metrics):
            res = super().flush(metrics)
            if res.dropped:
                raise RuntimeError(f"datadog-outage dropped {res.dropped} "
                                   "points")
            return res

    spool_dir = tempfile.mkdtemp()
    cfg = Config(interval=3600.0, percentiles=[0.99], aggregates=["count"],
                 hostname="egress-global", metric_sinks=specs,
                 enable_metric_sink_routing=True,
                 metric_sink_routing=routing,
                 tags_exclude=list(example.tags_exclude),
                 egress_spool_dir=spool_dir, egress_max_retries=1,
                 egress_retry_backoff=0.05, egress_breaker_threshold=2,
                 egress_breaker_reset=EGRESS_BREAKER_RESET_S,
                 egress_spool_replay_interval=0.2,
                 arena_initial_capacity=n_digests)
    outage = OutageDatadogSink(sink_mod.SinkSpec(
        kind="datadog", name="datadog-outage", config={
            "api_key": "k", "api_hostname": captures["datadog-outage"].url,
            "flush_retries": 1}), cfg)
    rng = np.random.default_rng(seed)

    def interval():
        means = np.sort(rng.integers(0, 5000, (n_digests, centroids)),
                        axis=1).astype(np.float64)
        wts = rng.integers(1, 50, (n_digests, centroids)).astype(np.float64)
        fms = [sm.ForwardMetric(
            name=f"eg.h{i}", tags=[f"nonce:{i}", "host_env:prod", "az:a"],
            kind="histogram", scope=0, digest_means=means[i].tolist(),
            digest_weights=wts[i].tolist(), digest_min=float(means[i, 0]),
            digest_max=float(means[i, -1]),
            digest_rsum=float((wts[i] / np.maximum(means[i], 1.0)).sum()))
            for i in range(n_digests)]
        lines = [b"eg.c%d:%d|c|#nonce:%d,host_env:prod" % (i, v, i)
                 for i, v in enumerate(rng.integers(1, 100,
                                                    n_counters).tolist())]
        for s in range(n_sets):
            lines += [b"eg.s%d:m%d|s|#nonce:%d,host_env:prod" % (s, v, s)
                      for v in rng.integers(0, 10 * members,
                                            members).tolist()]
        return fms, _datagrams(lines)

    t0 = time.perf_counter()
    intervals = [interval(), interval()]
    build_s = time.perf_counter() - t0
    srv = Server(cfg, extra_metric_sinks=[outage], device=DEVICE)
    srv.statsd = statsd = _StatsdLog()
    lanes = {lane.name: lane for lane in srv.egress.lanes}
    olane = lanes["datadog-outage"]
    srv.start()
    out = {"removed_options": removed, "build_s": build_s,
           "kinds_on_card": ["datadog", "cortex", "s3", "blackhole"]}
    rendered = []
    try:
        l0 = _read_launches()
        for k, (fms, dgrams) in enumerate(intervals, 1):
            t0 = time.perf_counter()
            ok, failed = srv.aggregator.import_metrics(fms)
            require((ok, failed) == (n_digests, 0), (ok, failed))
            for dg in dgrams:
                srv.process_packet_buffer(dg)
            feed_s = time.perf_counter() - t0
            busy = srv.egress._pending
            t0 = time.perf_counter()
            res = srv.flush()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            returned_early = not srv.egress.settle(timeout_s=0.0)
            require(returned_early, f"interval {k}: Server.flush returned "
                    "after the lanes had delivered")
            seg = dict(srv.aggregator.last_flush_segments)
            seg_sum = sum(v for key, v in seg.items()
                          if key.endswith("_s") and isinstance(v, float))
            rendered.append(res.metrics)
            out[f"interval{k}"] = {
                "feed_s": feed_s, "flush_ms": wall * 1e3,
                "segments_sum_ms": seg_sum * 1e3,
                "jobs_pending_at_flush": busy,
                "metrics": len(res.metrics)}
            card_log(f"egress interval {k}: {len(res.metrics)} metrics "
                     f"(imported and sent in {feed_s:.2f} s); "
                     f"Server.flush {wall * 1e3:.1f} ms wall against "
                     f"{seg_sum * 1e3:.1f} ms in its segments (routing "
                     f"and the handoff are the rest), {busy} lane jobs "
                     "still open when it began; returned before the lanes "
                     "delivered")
            if k == 1:
                t_flush1 = time.perf_counter()
        launches = _launch_delta(l0)
        require(launches.get("weighted_eval", 0) == 2,
                f"the egress intervals launched {launches}")
        require(out["interval2"]["jobs_pending_at_flush"] > 0,
                "the lanes were idle when the second flush began")
        # the outage lane retries interval 1, trips and spills it; then
        # interval 2 finds the breaker open and spills without a post
        deadline = time.monotonic() + 300
        while olane.spool.stats()["spilled"] < 1:
            require(time.monotonic() < deadline,
                    f"no spill: {olane.stats()}")
            time.sleep(0.02)
        out["spill1_s"] = time.perf_counter() - t_flush1
        t_trip = time.monotonic()
        require(olane.retried >= 1 and olane.breaker.trips == 1,
                f"outage lane: {olane.stats()}")
        deadline = time.monotonic() + 300
        while olane.spool.stats()["spilled"] < 2:
            require(time.monotonic() < deadline,
                    f"interval 2 not spilled: {olane.stats()}")
            time.sleep(0.02)
        out["spilled_within_cooldown_s"] = time.monotonic() - t_trip
        sp = olane.spool.stats()
        require(sp["pending_records"] == 2
                and olane.breaker.state() == "open",
                f"outage spool {sp}, breaker {olane.breaker.snapshot()}")
        causes = [tags for name, _, tags in statsd.counts
                  if name == "egress.spilled_total"
                  and "sink_name:datadog-outage" in tags]
        require([c[-1] for c in causes] == ["cause:retries_exhausted",
                                            "cause:breaker_open"],
                f"outage spills: {causes}")
        # two lane attempts at interval 1, each posting every chunk with
        # the sink's own retry; none at interval 2
        n_chunks = -(-len(rendered[0]) // outage.flush_max_per_body)
        refused = captures["datadog-outage"].refused
        require(refused == 2 * 2 * n_chunks
                and not captures["datadog-outage"].got,
                f"the outage capture refused {refused} posts, not "
                f"2 x 2 x {n_chunks}")
        # the release: once the cooldown runs out, the replayer's
        # half-open probe delivers both spilled intervals, oldest first
        captures["datadog-outage"].release()
        t0 = time.perf_counter()
        require(srv.egress.settle(timeout_s=600.0),
                "the lanes did not settle")
        out["settle_after_release_s"] = time.perf_counter() - t0
        deadline = time.monotonic() + 300
        t_probe = None
        while olane.spool.stats()["pending_records"]:
            require(time.monotonic() < deadline,
                    f"no replay: {olane.spool.stats()}")
            if t_probe is None and olane.breaker.state() != "open":
                t_probe = time.perf_counter()
            time.sleep(0.02)
        out["release_to_replayed_s"] = time.perf_counter() - t0
        out["replay_s"] = time.perf_counter() - (t_probe or t0)
        require(olane.breaker.state() == "closed",
                f"after the replay: {olane.breaker.snapshot()}")
        stats = srv.egress.stats()
    finally:
        srv.shutdown()
        for c in captures.values():
            c.close()
    require(stats["ledger_closed"] and stats["pending"] == 0
            and stats["dropped"] == 0 and stats["queue_dropped"] == 0,
            f"egress ledger: { {k: v for k, v in stats.items() if k != 'per_sink'} }")
    # what each sink received is the port's filter of what was rendered
    date = datetime.datetime.now(datetime.timezone.utc).strftime("%Y-%m-%d")
    want = {}
    t0 = time.perf_counter()
    for name in ("datadog", "cortex", "s3-archive", "blackhole",
                 "datadog-outage"):
        spec = lanes[name].spec
        rows = []
        for batch in rendered:
            filt, counts = sink_mod.filter_metrics_for_sink(
                spec, True, batch, excluded_tags=srv._excluded_tags_for(name))
            rows.extend(filt)
        want[name] = rows
    require(not want["blackhole"] and lanes["blackhole"].flushed_points == 0,
            "the blackhole sink is outside the rule but received "
            f"{lanes['blackhole'].flushed_points} points")
    n_rows = sum(len(b) for b in rendered)
    for name, rows in want.items():
        if name == "blackhole":
            continue
        require(len(rows) == n_rows, f"{name}: the filter kept "
                f"{len(rows)} of {n_rows} rows")
        require(not any(t.startswith("nonce:") for m in rows for t in m.tags),
                f"{name}: nonce survived the filter")
        require(any(t.startswith("host_env:") for m in rows for t in m.tags)
                == (name not in ("datadog",)),
                f"{name}: host_env kept {name != 'datadog'} expected")
    checks = {}
    for name in ("datadog", "datadog-outage"):
        got = sorted(_dd_received(captures[name]))
        exp = sorted(_dd_view(m, cfg.interval) for m in want[name])
        require(got == exp, f"{name}: received {len(got)} series, the "
                f"filter gives {len(exp)}: {_first_diff(got, exp)}")
        checks[name] = len(got)
    got = sorted(_cortex_received(captures["cortex"]))
    exp = sorted(_cortex_view(m, {}) for m in want["cortex"])
    require(got == exp, f"cortex: received {len(got)} series, the filter "
            f"gives {len(exp)}: {_first_diff(got, exp)}")
    checks["cortex"] = len(got)
    s3 = captures["s3-archive"]
    require(s3.bad_sig == 0 and len(s3.got) == 2,
            f"s3: {len(s3.got)} objects, {s3.bad_sig} bad signatures")
    got = sorted(_s3_received(s3))
    exp = sorted(encode_tsv_row(m, cfg.hostname, cfg.interval, date)
                 for m in want["s3-archive"])
    require(got == exp, f"s3: received {len(got)} rows, the filter gives "
            f"{len(exp)}: {_first_diff(got, exp)}")
    checks["s3-archive"] = len(got)
    out["check_s"] = time.perf_counter() - t0
    out["received_rows"] = checks
    out["launches"] = launches
    out["lanes"] = {}
    for name, lane in lanes.items():
        st = stats["per_sink"][lane.label]
        cap = captures.get(name)
        out["lanes"][name] = {
            "last_delivery_s": lane.last_delivery_s,
            "flushed_points": st["flushed_points"],
            "retried": st["retried"], "errors": st["errors"],
            "bytes": cap.nbytes if cap is not None else 0,
            "breaker": st["breaker"], "spool": st.get("spool")}
        card_log(f"egress lane {name}: last delivery "
                 f"{lane.last_delivery_s * 1e3:.1f} ms, "
                 f"{st['flushed_points']} points, "
                 f"{cap.nbytes if cap is not None else 0} bytes received, "
                 f"{st['retried']} retries, {st['errors']} errors")
    card_log(f"egress outage: spilled interval 1 {out['spill1_s']:.2f} s "
             f"after its flush (two attempts, then the breaker), interval "
             f"2 as breaker_open {out['spilled_within_cooldown_s']:.2f} s "
             f"after the trip; after the release the breaker's "
             f"{EGRESS_BREAKER_RESET_S:.0f} s cooldown ran out and the "
             f"replay delivered both in {out['replay_s']:.2f} s "
             f"({out['release_to_replayed_s']:.2f} s after the release); "
             f"every capture held exactly its filter's "
             f"rows ({checks}); ledger closed, nothing pending or dropped; "
             f"the lanes settled {out['settle_after_release_s']:.2f} s "
             f"after the release")
    return out


def _compute_apps() -> list[str]:
    smi = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,"
                          "used_memory", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    return [r.strip() for r in smi.stdout.splitlines() if r.strip()]


class _Handoff:
    """The real command line as processes.  `start()` launches
    `-validate-config` on example.yaml, `-version` and process A
    (`python -m veneur_tpu_torch.cli.veneur`, UDP on port 0), so that
    their boots overlap phase_cli_in_process; `run()` then streams
    counters to A (a datagram of `per` lines every `gap_s`, never more
    than CLI_QUEUE_HIGH queued bytes), boots B on A's UDP port, read
    from A's port file, so it joins the SO_REUSEPORT group, SIGUSR2s A,
    which must drain and exit 0, streams `after` more datagrams, and
    SIGTERMs B, which must exit 0.  The counters across both jsonl files
    must equal what was sent; with A and B up, nvidia-smi must list two
    more compute processes than before; `-validate-config` must exit 1
    naming an unported option and `-version` exit 0."""

    def __init__(self, d: str, per=50, gap_s=0.002, after=1000):
        self.d, self.per, self.gap_s, self.after = d, per, gap_s, after
        self.env = dict(os.environ)
        self.env["PYTHONPATH"] = os.pathsep.join(
            p for p in (ROOT, self.env.get("PYTHONPATH")) if p)
        self.procs, self.logs, self.checks = {}, [], {}
        self.sent = 0
        self.stop = threading.Event()
        self.sender_error = []

    def _cfg(self, name, addr) -> dict:
        return {"statsd_listen_addresses": [f"udp://{addr}"],
                "num_readers": 2, "read_buffer_size_bytes": CLI_RCVBUF,
                "http_address": "127.0.0.1:0",
                "port_file": os.path.join(self.d, f"{name}-ports.json"),
                "interval": "3600s", "flush_on_shutdown": True,
                "hostname": name, "metric_sinks": [{
                    "kind": "jsonl",
                    "config": {"path": os.path.join(self.d,
                                                    f"{name}.jsonl")}}]}

    def _cli(self, args, **kw) -> subprocess.Popen:
        return subprocess.Popen(
            [sys.executable, "-m", "veneur_tpu_torch.cli.veneur"] + args,
            cwd=ROOT, env=self.env, **kw)

    def _boot(self, name, addr) -> dict:
        """Start process `name`, its output to <name>.log; -> its port
        file once written."""
        path = os.path.join(self.d, f"{name}.yaml")
        with open(path, "w") as f:
            json.dump(self._cfg(name, addr), f)
        out = open(os.path.join(self.d, f"{name}.log"), "w")
        self.logs.append(out)
        self.procs[name] = self._cli(["-f", path, "-device", DEVICE],
                                     stdout=out, stderr=subprocess.STDOUT)
        return os.path.join(self.d, f"{name}-ports.json")

    def _ports(self, name, path) -> dict:
        proc = self.procs[name]
        _wait_file(path, lambda: proc.poll() is None, f"process {name}")
        ports = json.load(open(path))
        require(ports["pid"] == proc.pid, ports)
        return ports

    def start(self) -> None:
        self.before = _compute_apps()
        for name, args in (("validate", ["-f", os.path.join(
                ROOT, "example.yaml"), "-validate-config"]),
                           ("version", ["-version"])):
            self.checks[name] = self._cli(args, text=True,
                                          stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE)
        self.t_a = time.time()
        self.a_ports = self._boot("a", "127.0.0.1:0")

    def _sender(self, addr) -> None:
        socks = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                 for _ in range(CLI_FLOWS)]
        dgram = b"\n".join([b"cli.handoff:1|c"] * self.per)
        try:
            i = 0
            while not self.stop.is_set():
                _wait_queues(addr[1], CLI_QUEUE_HIGH)
                socks[i % CLI_FLOWS].sendto(dgram, addr)
                self.sent += self.per
                i += 1
                time.sleep(self.gap_s)
        except BaseException as e:      # re-raised by run()
            self.sender_error.append(e)
        finally:
            for sock in socks:
                sock.close()

    def run(self) -> dict:
        ports = self._ports("a", self.a_ports)
        boot_a = os.path.getmtime(self.a_ports) - self.t_a
        addr = tuple(ports["statsd"][0][1])
        t_send = threading.Thread(target=self._sender, args=(addr,),
                                  daemon=True)
        t_send.start()
        t_b = time.time()
        b_ports = self._boot("b", f"{addr[0]}:{addr[1]}")
        self._ports("b", b_ports)
        boot_b = os.path.getmtime(b_ports) - t_b
        apps = _compute_apps()
        require(len(apps) == len(self.before) + 2,
                f"nvidia-smi lists {apps} with A and B up, {self.before} "
                "before")
        sent_before_usr2 = self.sent
        self.procs["a"].send_signal(signal.SIGUSR2)
        rc_a = self.procs["a"].wait(timeout=120)
        require(rc_a == 0, f"process A exited {rc_a} after SIGUSR2")
        goal = self.sent + self.after * self.per    # to B alone
        deadline = time.monotonic() + 120
        while self.sent < goal and not self.sender_error:
            require(time.monotonic() < deadline, "the sender stalled")
            time.sleep(0.01)
        self.stop.set()
        t_send.join(timeout=60)
        require(not t_send.is_alive() and not self.sender_error,
                f"the sender failed: {self.sender_error}")
        _wait_queues(addr[1], 0)
        self.procs["b"].send_signal(signal.SIGTERM)
        rc_b = self.procs["b"].wait(timeout=120)
        require(rc_b == 0, f"process B exited {rc_b} after SIGTERM")
        got = {}
        for name in ("a", "b"):
            frames = _jsonl_frames(os.path.join(self.d, f"{name}.jsonl"))
            got[name] = sum(f.get(("cli.handoff", (), "counter"), 0.0)
                            for f in frames)
        require(got["a"] > 0 and got["b"] > 0, got)
        require(got["a"] + got["b"] == self.sent,
                f"the handoff lost {self.sent - got['a'] - got['b']} of "
                f"{self.sent} lines (A {got['a']}, B {got['b']})")
        _, err_v = self.checks["validate"].communicate(timeout=120)
        require(self.checks["validate"].returncode == 1
                and "not supported here" in err_v,
                f"-validate-config example.yaml: rc "
                f"{self.checks['validate'].returncode}, {err_v[-300:]}")
        out_ver, _ = self.checks["version"].communicate(timeout=120)
        require(self.checks["version"].returncode == 0
                and out_ver.startswith("veneur-tpu-torch "), out_ver)
        card_log(f"CLI handoff: A's port file {boot_a:.2f} s after its "
                 f"start, B's {boot_b:.2f} s after its start on A's UDP "
                 f"port; nvidia-smi listed two more compute processes "
                 f"({apps}); SIGUSR2 to A (exit 0) after "
                 f"{sent_before_usr2} lines, SIGTERM to B (exit 0): "
                 f"{self.sent} lines sent, A flushed {got['a']:.0f} and B "
                 f"{got['b']:.0f}, none lost; -validate-config "
                 f"example.yaml exit 1 "
                 f"({err_v.strip().splitlines()[-1][:120]}); -version "
                 f"{out_ver.strip()}")
        return {"boot_a_s": boot_a, "boot_b_s": boot_b, "sent": self.sent,
                "a": got["a"], "b": got["b"], "compute_apps": apps}

    def close(self, failed: bool) -> None:
        self.stop.set()
        for p in list(self.procs.values()) + list(self.checks.values()):
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
        for out in self.logs:
            out.close()
            if failed:
                with open(out.name) as f:
                    log(f"--- {out.name}:\n{f.read()[-4000:]}")


def phase_cli() -> dict:
    """The command line on the card: in this process (the launch
    counts), then as processes (the handoff), whose boots overlap."""
    import tempfile

    import torch
    # this process's own context first, so that the count of compute
    # processes before A and B includes it
    torch.empty(1, device=DEVICE)
    with tempfile.TemporaryDirectory() as d:
        handoff = _Handoff(d)
        failed = True
        try:
            handoff.start()
            inproc = phase_cli_in_process(d)
            out = {**inproc, "handoff": handoff.run()}
            failed = False
        finally:
            handoff.close(failed)
    return out


PHASE_S: dict = {}


def _timed(fn, *args):
    """fn(*args), its seconds recorded in PHASE_S under its name."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_S[fn.__name__] = time.perf_counter() - t0
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured",
              file=sys.stderr)
        return 2
    try:
        _kernel_modules()
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    _timed(phase_environment)
    _timed(phase_build)
    err = _timed(phase_kernels)
    err["compact_batch"] = _timed(phase_b6)
    err["segment_sums"] = _timed(phase_b7)
    err["weighted_eval_uniform"] = _timed(phase_b2)
    err["register_moments"] = _timed(phase_b8)
    err["quantile"] = _timed(phase_b9)
    err.update(_timed(phase_harness_kernels))
    # the flush path: counts from zero, read right after it
    for mod in _kernel_modules():
        mod.reset_launches()
    _timed(phase_slice)
    _timed(phase_slice_bf16)
    _timed(phase_slice_compactor)
    _timed(phase_slice_cubes)
    _timed(phase_slice_mesh)
    grpc_slice = _timed(phase_slice_grpc)
    full = _timed(phase_full_size)
    grpc = _timed(grpc_cell)
    proxy = _timed(phase_proxy)
    cube = _timed(cube_cell)
    meshed, b8_b9 = _timed(mesh_cells)
    meshed += _timed(moments_mesh_cell)
    native = _timed(phase_native_ingest)
    launches = _read_launches()
    card_log(f"flush path launches: {launches}")
    # crash durability and the guard, counted on their own and added to
    # the flush path's: their flushes are the same path, restored,
    # replayed and guarded
    for mod in _kernel_modules():
        mod.reset_launches()
    durability = _timed(phase_durability)
    durability_launches = _read_launches()
    card_log(f"durability launches: {durability_launches}")
    for k, n in durability_launches.items():
        launches[k] += n
    # the egress plane and the sinks, counted the same way: two intervals
    # of the flush path handed to example.yaml's sinks
    for mod in _kernel_modules():
        mod.reset_launches()
    egress = _timed(phase_egress)
    egress_launches = _read_launches()
    card_log(f"egress launches: {egress_launches}")
    for k, n in egress_launches.items():
        launches[k] += n
    # the command line, counted on its own and added to the flush path's:
    # its flushes are the same path, driven the way users start it.  It
    # installs the crash hooks, so from here a thread that dies ends the
    # script with exit code 2
    cli = _timed(phase_cli)
    card_log(f"command-line launches: {cli['launches']}")
    for k, n in cli["launches"].items():
        launches[k] += n
    # the profiling path, counted on its own: its entry points launch
    # B1, B3, B4 and B5 hundreds of times, which are not flushes
    for mod in _kernel_modules():
        mod.reset_launches()
    harness = _timed(phase_harness)
    harness_launches = _read_launches()
    card_log(f"profiling path launches: {harness_launches}")
    missing = [k for k, n in launches.items()
               if k not in HARNESS_KERNELS and n < 1]
    missing += [k for k in HARNESS_KERNELS if harness_launches[k] < 1]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    launches.update({k: harness_launches[k] for k in HARNESS_KERNELS})
    timed = _timed(kernel_times, err)
    kernels = [{"name": r["name"], "mode": r.get("mode"), "route": "cuda",
                "source": KERNEL_SOURCE[r["name"]],
                "replaces": REPLACES[r["name"]],
                "launches": launches[r["name"]],
                "max_abs_err": err[r["name"]], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"],
                "library_ms": r.get("library_ms"),
                "shape": r["shape"]}
               for r in timed
               if tuple(r["shape"]) == MAIN_SHAPE[r["name"]]
               and r.get("input", "main path") == "main path"]
    card_log("full-size flush p50s: " + ", ".join(
        f"{r['label']}: {r['flush_ms_p50']:.1f} ms" for r in full + meshed))
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"card": CARD, "torch": torch.__version__,
                   "cuda": torch.version.cuda, "kernel_vs_plain_err": err,
                   "main_path_launches": launches,
                   "profiling_path_launches": harness_launches,
                   "kernel_times": timed,
                   "flushes": full, "cube_cell": cube,
                   "grpc_slice": grpc_slice, "grpc_cell": grpc,
                   "proxy": proxy,
                   "meshed_flushes": meshed, "meshed_b8_b9": b8_b9,
                   "native_ingest": native, "durability": durability,
                   "durability_launches": durability_launches,
                   "egress": egress, "egress_launches": egress_launches,
                   "cli": cli, "phase_s": PHASE_S,
                   "harness": harness}, f,
                  indent=1)
    log("phase seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in PHASE_S.items()))
    log(f"total {time.perf_counter() - t_start:.1f}s; raw numbers in "
        f"chiprun_out/chip_smoke.json")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(CARD, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
