"""Bitonic compare-exchange formulations on the card (H3).

The port's counterpart of the JAX package's `scripts/sort_variants.py`:
every formulation of `ops/sort_variants.py` (v0 the paired network,
v1/v2 min/max + moved mask, v3/v5/v6 the xor partner with warp
shuffles, c0 B4's packed word network, c1 B3's key-only network) sorts
the same `[K, D]` rows of bf16-exact values with weights 1.  First a
correctness pass on a small slice: every mode must give v0's output
bit for bit, and a mismatch is printed and fails the run.  Then each
mode is timed under the in-loop protocol
(`veneur_tpu_torch.scripts.inloop_ms`).  c0 is skipped above
D = 64, as the JAX script skips it.

Usage: python -m veneur_tpu_torch.scripts.sort_variants [K] [D] [inner]
       [pipeline] [modes]   (defaults 16384 256 32 8)
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from veneur_tpu_torch import resolve_device
from veneur_tpu_torch.ops import sort_variants as sv
from veneur_tpu_torch.ops import sorted_eval as se
from veneur_tpu_torch.scripts import arg, device_line, inloop_ms

DEFAULT_MODES = ["v0", "v1", "v2", "v3", "v5", "v6", "c0", "c1"]
# rows of the correctness pass
CHECK_ROWS = 256


def inputs(k: int, d: int, dev: torch.device):
    """The JAX script's input in the port's layout: gamma(2, 10) values
    drawn as its `[D, K]` array from default_rng(0), rounded to bf16 (by
    torch, round to nearest even, as ml_dtypes rounds) and transposed to
    `[K, D]`; weights 1."""
    rng = np.random.default_rng(0)
    vals = torch.from_numpy(rng.gamma(2.0, 10.0, (d, k)).astype(np.float32))
    vals = vals.to(torch.bfloat16).to(torch.float32).T.contiguous()
    return vals.to(dev), torch.ones((k, d), dtype=torch.float32, device=dev)


def main(argv=None, device=None) -> dict:
    """Check every mode against v0, then time each; print one line per
    mode and return {mode: p50 ms per sort}.  Raises if any mode's
    output differs from v0's."""
    argv = sys.argv[1:] if argv is None else argv
    k = arg(argv, 0, 16384)
    d = arg(argv, 1, 256)
    inner = arg(argv, 2, 32)
    pipeline = arg(argv, 3, 8)
    modes = arg(argv, 4, list(DEFAULT_MODES), lambda s: s.split(","))
    for mode in modes:
        if mode not in sv.MODES:
            raise ValueError(f"unknown sort variant {mode!r}")
    dev = resolve_device(device)
    print(f"device: {device_line(dev)} K={k} D={d} inner={inner} "
          f"pipeline={pipeline}", flush=True)
    mean, weight = inputs(k, d, dev)
    if "c0" in modes and d > se.MAX_COMPACT_DEPTH:
        print(f"c0 skipped: d={d} > MAX_COMPACT_DEPTH="
              f"{se.MAX_COMPACT_DEPTH} (the packed word network keeps a "
              f"row inside one warp)", flush=True)
        modes = [m for m in modes if m != "c0"]

    small_m, small_w = mean[:CHECK_ROWS], weight[:CHECK_ROWS]
    ref = sv.sort_variant(small_m, small_w, "v0")
    bad = []
    for mode in modes:
        out = sv.sort_variant(small_m, small_w, mode)
        same = out.view(torch.int32) == ref.view(torch.int32)
        if not bool(same.all()):
            diff = float((out - ref).abs().nan_to_num(float("inf")).max())
            print(f"{mode}: OUTPUT MISMATCH vs v0 ({int((~same).sum())} of "
                  f"{same.numel()} words differ, max diff {diff})",
                  flush=True)
            bad.append(mode)
    if bad:
        raise RuntimeError(f"sort variants {bad} differ from v0")

    out = {}
    for mode in modes:
        p50 = inloop_ms(lambda m=mode: sv.sort_variant(mean, weight, m),
                        dev, inner, pipeline)
        out[mode] = p50
        print(f"{mode:4s} p50={p50:8.4f} ms/sort", flush=True)
    return out


if __name__ == "__main__":
    main()
