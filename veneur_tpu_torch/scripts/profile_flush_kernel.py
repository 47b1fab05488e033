"""Decompose the flush evaluation's device time, slice by slice.

The port's counterpart of the JAX package's
`scripts/profile_flush_kernel.py`: each mode is timed under the
pipelined protocol (`veneur_tpu_torch.scripts.pipelined_ms`):

  dma / read  H1's read cut: B1's load and a row reduce -> memory floor
  sort        + B1's sort (H1)                          -> sort cost
  cumsum      + B1's prefix sum of the weights (H1)     -> rank-base cost
  full        B1 (`sorted_eval.weighted_eval`)          -> + quantile tail
  compact     B4 on the values rounded to bf16 (D <= 64)
  depth       B3 (`uniform_eval`) on f32 values, int16 depths
  depth_bf16  B3 on bf16 values
  xla         B1's plain PyTorch version, where the JAX script times
              the XLA twin
  moments     the moments flush's depth variant (B5 + the maxent solve)
  moments_sums  B5 alone

`full_nodma` and `full_dma` pick the TPU kernel's DMA pipeline depth,
which the port's B1 has no counterpart of, and `delta` times the
resident delta flush, which is not ported (ROADMAP A12): they raise.

Usage: python -m veneur_tpu_torch.scripts.profile_flush_kernel [K] [D]
       [pipeline] [rounds] [modes]   (defaults 16384 256 25 4)
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from veneur_tpu_torch import resolve_device
from veneur_tpu_torch.ops import moments_eval as me
from veneur_tpu_torch.ops import sorted_eval as se
from veneur_tpu_torch.scripts import arg, device_line, pipelined_ms
from veneur_tpu_torch.sketches import moments as mo

MODES = ("dma", "read", "sort", "cumsum", "full", "compact", "depth",
         "depth_bf16", "xla", "moments", "moments_sums")
DEFAULT_MODES = ["dma", "sort", "cumsum", "full", "depth", "depth_bf16",
                 "xla"]
PERCENTILES = [0.5, 0.9, 0.99]


def check_modes(modes, d: int) -> None:
    """Raise for a mode the port does not run, before anything runs."""
    for mode in modes:
        if mode in ("full_nodma", "full_dma"):
            raise ValueError(
                f"{mode} picks the TPU kernel's DMA pipeline depth (nbuf); "
                "the port's B1 has no such knob")
        if mode == "delta":
            raise NotImplementedError(
                "delta times the resident delta flush, which is not "
                "ported (ROADMAP A12)")
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}")
        if mode == "compact" and d > se.MAX_COMPACT_DEPTH:
            raise ValueError(f"compact needs D <= {se.MAX_COMPACT_DEPTH} "
                             f"(got {d})")


def mode_bytes(mode: str, k: int, d: int) -> int:
    """The operand bytes each mode reads (the eff-BW column): both
    [K, D] f32 operands, but bf16 values (2 bytes) for compact and
    depth_bf16, and int16 depths instead of weights for the depth and
    moments modes."""
    if mode == "compact":
        return k * d * 2 + k * d * 4
    if mode in ("depth", "moments", "moments_sums"):
        return k * d * 4 + k * 2
    if mode == "depth_bf16":
        return k * d * 2 + k * 2
    return 2 * k * d * 4


def inputs(k: int, d: int, dev: torch.device) -> dict:
    """The JAX script's seeded inputs: gamma(2, 10) values from
    default_rng(0), weights 1, each row's min and max, percentiles
    0.5 / 0.9 / 0.99; plus what the depth and moments modes take."""
    rng = np.random.default_rng(0)
    vals = rng.gamma(2.0, 10.0, (k, d)).astype(np.float32)
    mean = torch.from_numpy(vals).to(dev)
    a, b = vals.min(1), vals.max(1)
    la, lb = mo.log_domain(a.astype(np.float64), b.astype(np.float64))
    return {
        "mean": mean,
        "mean_bf16": mean.to(torch.bfloat16),
        "weight": torch.ones((k, d), dtype=torch.float32, device=dev),
        "d_min": torch.from_numpy(a).to(dev),
        "d_max": torch.from_numpy(b).to(dev),
        "pct": torch.tensor(PERCENTILES, dtype=torch.float32, device=dev),
        "depths": torch.full((k,), d, dtype=torch.int16, device=dev),
        "ab": torch.from_numpy(np.stack([a, b])).to(dev),
        "lab": torch.from_numpy(np.stack([la, lb]).astype(np.float32))
        .to(dev),
        "imp": torch.zeros((k, 2 * (mo.DEFAULT_K + 1)), dtype=torch.float32,
                           device=dev),
    }


def variant(mode: str, x: dict, dev: torch.device):
    """A no-argument callable running one launch of `mode`."""
    m, w, lo, hi, pct = (x["mean"], x["weight"], x["d_min"], x["d_max"],
                         x["pct"])
    if mode in ("dma", "read", "sort", "cumsum"):
        cut = "read" if mode == "dma" else mode
        return lambda: se.stage_slice(m, w, cut)
    if mode == "full":
        return lambda: se.weighted_eval(m, w, lo, hi, pct)
    if mode == "compact":
        return lambda: se.weighted_eval(x["mean_bf16"], w, lo, hi, pct,
                                        compact=True)
    if mode in ("depth", "depth_bf16"):
        mv = x["mean_bf16"] if mode == "depth_bf16" else m
        return lambda: se.uniform_eval(mv, x["depths"], pct)
    if mode == "xla":
        return lambda: se.weighted_eval_plain(m, w, lo, hi, pct)
    args = (m, x["depths"], x["ab"], x["lab"])
    if mode == "moments_sums":
        return lambda: me.moments_sums(*args, mo.DEFAULT_K, True)
    fn = me.make_moments_flush(mo.DEFAULT_K, device=dev)
    return lambda: fn.depth_variant(*args, x["imp"], pct)


def main(argv=None, device=None) -> dict:
    """Time every mode; print one line per mode and return {mode: p50
    ms per launch}."""
    argv = sys.argv[1:] if argv is None else argv
    k = arg(argv, 0, 16384)
    d = arg(argv, 1, 256)
    pipeline = arg(argv, 2, 25)
    rounds = arg(argv, 3, 4)
    modes = arg(argv, 4, DEFAULT_MODES, lambda s: s.split(","))
    check_modes(modes, d)
    dev = resolve_device(device)
    print(f"device: {device_line(dev)} K={k} D={d} pipeline={pipeline}",
          flush=True)
    x = inputs(k, d, dev)
    out = {}
    for mode in modes:
        p50 = pipelined_ms(variant(mode, x, dev), dev, pipeline, rounds)
        bw = mode_bytes(mode, k, d) / (p50 * 1e-3) / 1e9
        print(f"{mode:7s} p50={p50:8.3f} ms/flush  eff-BW={bw:7.1f} GB/s",
              flush=True)
        out[mode] = p50
    return out


if __name__ == "__main__":
    main()
