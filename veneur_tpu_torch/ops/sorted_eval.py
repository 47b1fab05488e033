"""The flush's sorted evaluation: wrappers of the B1-B4 CUDA kernels.

`weighted_eval` (B1; B4 with `compact=True`; B2 with `uniform=True`)
and `uniform_eval` (B3) keep the signatures and output layouts of
`veneur_tpu.ops.sorted_eval`'s functions of the same names.  On a CUDA
tensor each launches its kernel from `ops/csrc/sorted_eval.cu` on the
current stream, or raises when the kernel cannot take the input; on a
CPU tensor it runs the plain PyTorch version beside it.  Nothing else
is accepted, and nothing falls back.

Values may be float32 or bfloat16 (`digest_bf16_staging`); the kernels
widen bf16 at load, and the plain versions widen first.  Weights,
min/max and percentiles are float32.

`launches` counts kernel launches per variant, so a run can show that
its flushes went through each kernel: `weighted_eval` and
`uniform_eval` on float32 values, `weighted_eval_bf16` and
`uniform_eval_bf16` on bf16 values, `weighted_eval_compact` for B4 and
`weighted_eval_uniform` for B2 (float32 values only: it runs in the
meshed flush, which is float32-native), and `stage_slice` and
`stage_slice_wide` for the profiling cuts H1 and H2.

`stage_slice` (H1) and `stage_slice_wide` (H2) are the profiling
harness's cuts of B1 (`veneur_tpu.ops.sorted_eval.stage_slice_kernel`
and the `_variant_kernel` that `scripts/profile_kernel_inloop.py`
imports): B1's load, then its sort, then its prefix sum, each ending
in one value per row; see `ops/csrc/sorted_eval.cu`.

B1, B4 and the cuts sort stably (each point's sort word carries its
column; B4's word is 32 bits, B1's 64), so on every row, tied values,
holes, infinities and NaN of either sign included, their order is the
plain versions' stable `torch.sort`.
"""

from __future__ import annotations

import torch

from veneur_tpu_torch.sketches import tdigest as td

MAX_DEPTH = 1024
# B4 (B1's kernel on 32-bit bf16-key|column words) takes rows of at most
# 64 bf16 values
MAX_COMPACT_DEPTH = 64
# cmid of B2's padding: finite, above any cumulative weight
_PAD_CMID = 3.0e38

launches = {"weighted_eval": 0, "uniform_eval": 0,
            "weighted_eval_compact": 0, "weighted_eval_bf16": 0,
            "uniform_eval_bf16": 0, "weighted_eval_uniform": 0,
            "stage_slice": 0, "stage_slice_wide": 0}
# the cuts of H1, by the code its C entry point takes; H2 takes the
# first two under the profiling script's names
STAGE_CUTS = {"read": 0, "sort": 1, "cumsum": 2}
WIDE_MODES = {"dma": 0, "sort": 1}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and the yardstick the kernels are held to)
# ---------------------------------------------------------------------------

def weighted_eval_plain(mean, weight, d_min, d_max, percentiles):
    """B1's and B4's plain version: `td.weighted_eval`, whose stable
    sort is the order both kernels reproduce."""
    return td.weighted_eval(mean, weight, d_min, d_max, percentiles)


def weighted_eval_uniform_plain(mean, weight, d_min, d_max, percentiles):
    """B2's plain version, step for step the JAX package's
    `_tile_uniform` (sorted_eval.py:397-430): the keys alone sort (holes,
    w <= 0, key +inf and sort last), a sorted point i sits at cumulative
    weight i + 1 (cmid i + 0.5), the total is the occupied count and
    the weighted sum adds the sorted occupied values; then B1's tail,
    clamp included.  On weights in {0, 1} it equals
    `weighted_eval_plain` (the contract of sorted_eval.py:408-412).
    -> `[U, P+2]`."""
    mean = mean.to(torch.float32)
    d = mean.shape[1]
    occ0 = weight > 0
    inf = torch.tensor(float("inf"), device=mean.device)
    key = torch.sort(torch.where(occ0, mean, inf), dim=1).values
    n_real = occ0.sum(dim=1, keepdim=True)                      # [U, 1]
    idx = torch.arange(d, device=mean.device)[None, :]
    occ = idx < n_real
    m_clean = torch.where(occ, key, torch.zeros_like(key))
    sums = m_clean.sum(dim=1, keepdim=True)
    total = n_real.to(torch.float32)
    cmid = torch.where(occ, idx.to(torch.float32) + 0.5,
                       torch.full_like(key, _PAD_CMID))
    pct = percentiles.to(torch.float32)
    tq = pct[None, :] * total                                   # [U, P]
    rank = (cmid[:, :, None] < tq[:, None, :]).sum(dim=1)
    ii = torch.minimum(rank.clamp_min(1), (n_real - 1).clamp_min(1))
    m_lo = torch.gather(m_clean, 1, ii - 1)
    m_hi = torch.gather(m_clean, 1, ii)
    c_lo = torch.gather(cmid, 1, ii - 1)
    c_hi = torch.gather(cmid, 1, ii)
    t = torch.where(c_hi > c_lo,
                    (tq - c_lo) / (c_hi - c_lo).clamp_min(1e-30),
                    torch.zeros_like(tq))
    q = m_lo + (m_hi - m_lo) * t.clamp(0.0, 1.0)
    q = torch.where(n_real <= 1, m_clean[:, :1], q)
    q = td.clip_signed(q, d_min.to(torch.float32)[:, None],
                       d_max.to(torch.float32)[:, None])
    q = torch.where(total > 0, q, torch.zeros_like(q))
    return torch.cat([q, total, sums], dim=1)


def uniform_eval_plain(mean, depths, percentiles):
    """B3's plain version: rebuild the 0/1 weights and each row's range
    from the depth vector and evaluate with `td.weighted_eval` (the
    reconstruct-and-evaluate branch of the JAX package's
    `serving.digest_eval_uniform`).  -> `[U, P]`."""
    d = mean.shape[1]
    n_pct = percentiles.shape[0]
    mean = mean.to(torch.float32)
    col = torch.arange(d, device=mean.device)[None, :]
    occ = col < depths.to(torch.int64)[:, None]
    dw = occ.to(torch.float32)
    has = depths > 0
    zero = torch.zeros((), device=mean.device)
    d_min = torch.where(has, _signed_extreme(mean, occ, False), zero)
    d_max = torch.where(has, _signed_extreme(mean, occ, True), zero)
    return td.weighted_eval(mean, dw, d_min, d_max,
                            percentiles)[:, :n_pct]


def _signed_extreme(x, occ, largest: bool):
    """Each row's max (largest) or min over its points where `occ`, with
    -0 below +0 as the twin's `jnp.max` / `jnp.min` order them:
    `torch.amax` / `amin` may return either zero (ROADMAP C11)."""
    inf = torch.tensor(float("inf"), device=x.device)
    zeros = (x == 0) & occ
    if largest:
        e = torch.where(occ, x, -inf).amax(dim=1)
        pick = (zeros & ~torch.signbit(x)).any(dim=1)
        return torch.where((e == 0) & pick, torch.zeros_like(e), e)
    e = torch.where(occ, x, inf).amin(dim=1)
    pick = (zeros & torch.signbit(x)).any(dim=1)
    return torch.where((e == 0) & pick, -torch.zeros_like(e), e)


def tree_row_sums(x: torch.Tensor) -> torch.Tensor:
    """`[U, D]` -> `[U]`: each row's sum by the kernels' fixed pairwise
    tree (`row_sums` in `ops/csrc/sort_network.cuh`): at each step the
    first half of the columns adds the second.  D a power of two."""
    while x.shape[1] > 1:
        h = x.shape[1] // 2
        x = x[:, :h] + x[:, h:]
    return x[:, 0]


def _sorted_pairs(mean, weight):
    """Each row's keys (value where the weight is positive, else +inf)
    sorted ascending and stably, as B1 sorts them, with the weights
    gathered alongside."""
    inf = torch.tensor(float("inf"), device=mean.device)
    key = torch.where(weight > 0, mean, inf)
    key, order = torch.sort(key, dim=1, stable=True)
    return key, torch.gather(weight, 1, order)


def stage_slice_plain(mean, weight, mode: str) -> torch.Tensor:
    """H1's plain version: `[U, D]` f32 values and weights -> `[U]`.
    read: sum(key * w) over the row in column order; sort: the same sum
    over the rows sorted by key (a stable `torch.sort`, weights
    gathered); cumsum: the last column of `torch.cumsum` of the sorted
    weights.  The key
    is the value where w > 0, else +inf, so a row with a hole gives NaN
    in read and sort (inf * 0), as the TPU kernel does."""
    if mode not in STAGE_CUTS:
        raise ValueError(f"unknown stage slice {mode!r}")
    if mode == "read":
        inf = torch.tensor(float("inf"), device=mean.device)
        key, w = torch.where(weight > 0, mean, inf), weight
    else:
        key, w = _sorted_pairs(mean, weight)
    if mode == "cumsum":
        return torch.cumsum(w, dim=1)[:, -1]
    return tree_row_sums(key * w)


def stage_slice_wide_plain(mean, weight, d_min, d_max, percentiles,
                           mode: str) -> torch.Tensor:
    """H2's plain version: B1's operands -> `[U, P+2]`: column p < P
    holds s * q_p (s the `read` cut for mode `dma`, the `sort` cut for
    `sort`), column P the row's min, column P + 1 its max."""
    if mode not in WIDE_MODES:
        raise ValueError(f"unknown stage slice mode {mode!r} "
                         f"(dma | sort)")
    s = stage_slice_plain(mean, weight, "read" if mode == "dma" else mode)
    return torch.cat([s[:, None] * percentiles[None, :],
                      d_min[:, None], d_max[:, None]], dim=1)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _on_cuda(name: str, *tensors) -> bool:
    """True for CUDA inputs (all on one device), False for CPU inputs;
    raises for anything else or a mix."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: inputs on several devices {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    return True


def _check_kernel_inputs(name: str, mean, f32, shapes,
                         max_depth: int = MAX_DEPTH):
    u, d = mean.shape
    if d < 2 or d > max_depth or d & (d - 1):
        raise ValueError(f"{name}: depth {d} must be a power of two in "
                         f"[2, {max_depth}]")
    if mean.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: values must be float32 or bfloat16, "
                         f"got {mean.dtype}")
    for t in f32:
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32, got {t.dtype}")
    for t, shape in shapes:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    return u, d


def _check_compact(mean) -> None:
    """B4 sorts 16-bit keys: its values must be bf16 (so every key is
    exact) and its rows at most MAX_COMPACT_DEPTH deep."""
    if mean.dtype != torch.bfloat16:
        raise ValueError(f"weighted_eval(compact=True): values must be "
                         f"bfloat16, got {mean.dtype}")
    if mean.shape[1] > MAX_COMPACT_DEPTH:
        raise ValueError(f"weighted_eval(compact=True): depth "
                         f"{mean.shape[1]} > {MAX_COMPACT_DEPTH}")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed "
                           f"(cudaError {rc})")


def launch(name: str, device: torch.device, fn, *args) -> None:
    """One kernel launch through its C entry point `fn(*args, stream)` on
    `device`'s current stream, raising on a nonzero cudaError.  The
    device is made current for the call: the CUDA runtime launches on
    the current device and refuses a stream of another one, and a
    meshed flush launches on every device of its grid."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _raise_on(fn(*args, stream), name)


def weighted_eval(mean: torch.Tensor, weight: torch.Tensor,
                  d_min: torch.Tensor, d_max: torch.Tensor,
                  percentiles: torch.Tensor,
                  compact: bool = False,
                  uniform: bool = False) -> torch.Tensor:
    """B1: `[U, D]` weighted points -> `[U, P+2]` (P quantiles, total
    weight, weighted sum).  D must be a power of two in [2, 1024];
    values float32 or bfloat16, every other operand float32, all
    contiguous on one device.  compact=True takes B4 instead: bf16
    values, D <= MAX_COMPACT_DEPTH, and a stable sort (tied values keep
    their column order, as in the plain version).  uniform=True takes
    B2: float32 values whose every nonzero weight is exactly 1 (the
    caller's promise, as in the JAX package), the key-only network."""
    if compact and uniform:
        raise ValueError("weighted_eval: compact and uniform exclude "
                         "each other")
    if compact:
        _check_compact(mean)
    if uniform and mean.dtype != torch.float32:
        raise ValueError(f"weighted_eval(uniform=True): values must be "
                         f"float32 (the meshed flush is float32-native), "
                         f"got {mean.dtype}")
    if not _on_cuda("weighted_eval", mean, weight, d_min, d_max,
                    percentiles):
        if uniform:
            return weighted_eval_uniform_plain(mean, weight, d_min, d_max,
                                               percentiles)
        return weighted_eval_plain(mean, weight, d_min, d_max, percentiles)
    u, d = mean.shape
    n_pct = percentiles.shape[0]
    _check_kernel_inputs(
        "weighted_eval", mean, (weight, d_min, d_max, percentiles),
        ((mean, (u, d)), (weight, (u, d)), (d_min, (u,)), (d_max, (u,)),
         (percentiles, (n_pct,))))
    out = torch.empty((u, n_pct + 2), dtype=torch.float32,
                      device=mean.device)
    if u == 0:
        return out
    from veneur_tpu_torch.ops import _build
    lib = _build.load("sorted_eval")
    if compact:
        variant, fn = "weighted_eval_compact", lib.vn_weighted_eval_compact
    elif uniform:
        variant, fn = "weighted_eval_uniform", lib.vn_weighted_eval_uniform
    elif mean.dtype == torch.bfloat16:
        variant, fn = "weighted_eval_bf16", lib.vn_weighted_eval_bf16
    else:
        variant, fn = "weighted_eval", lib.vn_weighted_eval
    launch(variant, mean.device, fn, mean.data_ptr(), weight.data_ptr(),
           d_min.data_ptr(), d_max.data_ptr(), percentiles.data_ptr(),
           out.data_ptr(), u, d, n_pct)
    launches[variant] += 1
    return out


def uniform_eval(mean: torch.Tensor, depths: torch.Tensor,
                 percentiles: torch.Tensor) -> torch.Tensor:
    """B3: `[U, D]` values whose first depths[k] columns are real
    weight-1 points (`depths` int16, as `build_dense` makes it) ->
    `[U, P]` quantiles; everything else as for `weighted_eval`."""
    if not _on_cuda("uniform_eval", mean, depths, percentiles):
        return uniform_eval_plain(mean, depths, percentiles)
    u, d = mean.shape
    n_pct = percentiles.shape[0]
    if depths.dtype != torch.int16:
        raise ValueError(f"uniform_eval: depths must be int16, got "
                         f"{depths.dtype}")
    _check_kernel_inputs(
        "uniform_eval", mean, (percentiles,),
        ((mean, (u, d)), (depths, (u,)), (percentiles, (n_pct,))))
    out = torch.empty((u, n_pct), dtype=torch.float32, device=mean.device)
    if u == 0:
        return out
    from veneur_tpu_torch.ops import _build
    lib = _build.load("sorted_eval")
    variant, fn = (("uniform_eval_bf16", lib.vn_uniform_eval_bf16)
                   if mean.dtype == torch.bfloat16
                   else ("uniform_eval", lib.vn_uniform_eval))
    launch(variant, mean.device, fn, mean.data_ptr(), depths.data_ptr(),
           percentiles.data_ptr(), out.data_ptr(), u, d, n_pct)
    launches[variant] += 1
    return out


def _check_slice_inputs(name, mean, weight):
    if mean.dtype != torch.float32:
        raise ValueError(f"{name}: values must be float32, got "
                         f"{mean.dtype}")
    return _check_kernel_inputs(name, mean, (weight,),
                                ((mean, tuple(mean.shape)),
                                 (weight, tuple(mean.shape))))


def stage_slice(mean: torch.Tensor, weight: torch.Tensor,
                mode: str) -> torch.Tensor:
    """H1: the cut `mode` (read | sort | cumsum) of B1 on `[U, D]` f32
    values and weights -> `[U]` f32.  D a power of two in [2, 1024], both
    contiguous on one device."""
    if mode not in STAGE_CUTS:
        raise ValueError(f"unknown stage slice {mode!r}")
    if not _on_cuda("stage_slice", mean, weight):
        return stage_slice_plain(mean, weight, mode)
    u, d = _check_slice_inputs("stage_slice", mean, weight)
    out = torch.empty((u,), dtype=torch.float32, device=mean.device)
    if u == 0:
        return out
    from veneur_tpu_torch.ops import _build
    launch("stage_slice", mean.device,
           _build.load("sorted_eval").vn_stage_slice, mean.data_ptr(),
           weight.data_ptr(), out.data_ptr(), u, d, STAGE_CUTS[mode])
    launches["stage_slice"] += 1
    return out


def stage_slice_wide(mean: torch.Tensor, weight: torch.Tensor,
                     d_min: torch.Tensor, d_max: torch.Tensor,
                     percentiles: torch.Tensor, mode: str) -> torch.Tensor:
    """H2: the cut `mode` (dma: B1's load | sort: + its network) reading
    every operand of B1 and writing B1's `[U, P+2]` output shape (see
    `stage_slice_wide_plain` for its columns); inputs as B1's, float32
    values."""
    if mode not in WIDE_MODES:
        raise ValueError(f"unknown stage slice mode {mode!r} "
                         f"(dma | sort)")
    if not _on_cuda("stage_slice_wide", mean, weight, d_min, d_max,
                    percentiles):
        return stage_slice_wide_plain(mean, weight, d_min, d_max,
                                      percentiles, mode)
    u, d = _check_slice_inputs("stage_slice_wide", mean, weight)
    n_pct = percentiles.shape[0]
    _check_kernel_inputs(
        "stage_slice_wide", mean, (d_min, d_max, percentiles),
        ((d_min, (u,)), (d_max, (u,)), (percentiles, (n_pct,))))
    out = torch.empty((u, n_pct + 2), dtype=torch.float32,
                      device=mean.device)
    if u == 0:
        return out
    from veneur_tpu_torch.ops import _build
    launch("stage_slice_wide", mean.device,
           _build.load("sorted_eval").vn_stage_slice_wide, mean.data_ptr(),
           weight.data_ptr(), d_min.data_ptr(), d_max.data_ptr(),
           percentiles.data_ptr(), out.data_ptr(), u, d, n_pct,
           WIDE_MODES[mode])
    launches["stage_slice_wide"] += 1
    return out
