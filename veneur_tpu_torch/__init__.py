"""veneur_tpu_torch: the metrics-aggregation server on PyTorch and CUDA.

The package mirrors `veneur_tpu`'s module layout (samplers, sketches,
ops, parallel, core, forward, sources, protocol) so each module has an
obvious counterpart there.
Its entry points (`core.server.Server`, `core.aggregator.MetricAggregator`,
the arenas, `parallel.serving.make_serving_flush`) run on a CUDA device
unless the caller names another one; the flush's evaluation kernels are
hand-written CUDA (`ops/csrc/`).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: None means "cuda".  A CUDA
    device on a machine without one raises instead of quietly running on
    the CPU; pass device="cpu" to run the plain PyTorch versions."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "veneur_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
