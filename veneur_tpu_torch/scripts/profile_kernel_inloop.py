"""Device time of the flush evaluation's cuts with the launch cost out.

The port's counterpart of the JAX package's
`scripts/profile_kernel_inloop.py`, under the in-loop protocol
(`veneur_tpu_torch.scripts.inloop_ms`: `inner` launches captured in a
CUDA graph, replayed `pipeline` times).  Modes:

  dma   H2's read cut: every operand B1 reads, B1's output shape
  sort  + B1's sort (H2)
  full  B1 itself

H2 (`sorted_eval.stage_slice_wide`) is the port's definition of the
`_variant_kernel(mode, n_pct)` that the JAX script imports from a module
that does not define it (ROADMAP C7): its bytes are B1's, so
`full - sort` is the cost of B1's scan and quantile tail alone.

Usage: python -m veneur_tpu_torch.scripts.profile_kernel_inloop [K] [D]
       [inner] [pipeline] [modes]   (defaults 16384 256 32 8)
"""

from __future__ import annotations

import sys

from veneur_tpu_torch import resolve_device
from veneur_tpu_torch.ops import sorted_eval as se
from veneur_tpu_torch.scripts import arg, device_line, inloop_ms
from veneur_tpu_torch.scripts.profile_flush_kernel import inputs

MODES = ("dma", "sort", "full")


def variant(mode: str, x: dict):
    """A no-argument callable running one launch of `mode`."""
    args = (x["mean"], x["weight"], x["d_min"], x["d_max"], x["pct"])
    if mode == "full":
        return lambda: se.weighted_eval(*args)
    return lambda: se.stage_slice_wide(*args, mode)


def main(argv=None, device=None) -> dict:
    """Time every mode; print one line per mode, then the sort-only and
    eval-tail costs, and return {mode: p50 ms per kernel}."""
    argv = sys.argv[1:] if argv is None else argv
    k = arg(argv, 0, 16384)
    d = arg(argv, 1, 256)
    inner = arg(argv, 2, 32)
    pipeline = arg(argv, 3, 8)
    modes = arg(argv, 4, list(MODES), lambda s: s.split(","))
    for mode in modes:
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r} ({' | '.join(MODES)})")
    dev = resolve_device(device)
    print(f"device: {device_line(dev)} K={k} D={d} inner={inner} "
          f"pipeline={pipeline}", flush=True)
    x = inputs(k, d, dev)
    bytes_read = 2 * k * d * 4
    results = {}
    for mode in modes:
        p50 = inloop_ms(variant(mode, x), dev, inner, pipeline)
        bw = bytes_read / (p50 * 1e-3) / 1e9
        results[mode] = p50
        print(f"{mode:7s} p50={p50:8.4f} ms/kernel  eff-BW={bw:7.1f} GB/s",
              flush=True)
    if "dma" in results and "sort" in results:
        print(f"sort-only cost: {results['sort'] - results['dma']:.4f} ms",
              flush=True)
    if "full" in results and "sort" in results:
        print(f"eval-tail cost: {results['full'] - results['sort']:.4f} ms",
              flush=True)
    return results


if __name__ == "__main__":
    main()
