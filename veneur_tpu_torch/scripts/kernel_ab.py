"""Two checkouts' kernels timed side by side on one card.

Times every kernel built from `ops/csrc/sorted_eval.cu`,
`sort_network.cuh` and `sort_variants.cu` (B1-B4, H1-H3), B6
(`compactor_eval.cu`), B7 (`segmented_reduce.cu`), B5
(`moments_eval.cu`), B9 (`quantile_eval.cu`) and B8
(`hll_estimate.cu`), at `chip_smoke.py`'s
shapes, in a parent checkout and in this one, each in processes of its
own in the order parent, change, change, parent.  B7
runs at both of chip_smoke's `b7_times` shapes on `seg_rows` (the cube
read's 4096 x 20 -> 256 and 131072 x 128 -> 1024), each beside
`index_add_` (one PyTorch call of the same sums, the same in both
trees); B6 at 16384 x 14 x 256 on `compactor_rows`' mixed rows and on
`first_fold_rows`, a stand-in for the compactor flush's first launch.
B5 runs both variants at the moments flush's 131072 x 64 (k = 8) and
the weights variant at 16384 x 512, on `moment_rows`' gamma rows; B9 at
131072 x 152 with 6 quantiles on `centroid_rows`' gamma means; B8
(`hll_estimate.cu`) at 10000 x 16384 on `hll_rows`' geometric
registers.
Every kernel is held to its plain version first (chip_smoke's checks),
then timed by chip_smoke's `cuda_ms` both ways: with its spin before the
opening event (the device's work alone) and without it (`slack=0`, the
events open right after the L2 eviction, so a kernel shorter than its
wrapper's host work reads the host's time).  The inputs, checks and
instrument are this checkout's `chip_smoke.py` for both trees; only
`veneur_tpu_torch` (and so the kernels' sources) comes from each tree.

Usage (PARENT a directory holding a parent's `veneur_tpu_torch/`, e.g.
made by `git archive <commit> veneur_tpu_torch | tar -x -C PARENT`):

    python veneur_tpu_torch/scripts/kernel_ab.py --parent PARENT

Prints one line a kernel (each run's time, both instruments) and writes
every number to `chiprun_out/kernel_ab.json`.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]      # holds chip_smoke.py
ORDER = ("parent", "change", "change", "parent")


def _chip_smoke():
    """This checkout's chip_smoke.py as a module."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _cases(cs, se, sv, gen, dev):
    """(name, shape, checked kernel call) of every kernel timed: the
    inputs of chip_smoke's kernel_times and harness_times, gamma rows
    held to the plain versions before they are returned, then B7 and B6
    (`_b6_b7_cases`)."""
    import torch
    pct = torch.tensor([0.5] + cs.PERCENTILES, device=dev)
    out = []
    weighted = (("weighted_eval", 131072, 64, cs.weighted_rows, False),
                ("weighted_eval", 16384, 512, cs.weighted_rows, False),
                ("weighted_eval", 131072, 8, cs.weighted_rows, False),
                ("weighted_eval_bf16", 16384, 512, cs.bf16_weighted_rows,
                 False),
                ("weighted_eval_compact", 131072, 64, cs.compact_rows, True),
                ("weighted_eval_compact", 131072, 8, cs.compact_rows, True))
    for name, u, d, rows, compact in weighted:
        args = rows(u, d, gen, dev, integer=False)[:4] + (pct,)
        cs.check_weighted(args, integer=False, compact=compact)
        out.append((name, [u, d], lambda a=args, c=compact:
                    se.weighted_eval(*a, compact=c)))
    for name, u, d, rows in (("uniform_eval", 131072, 8, cs.depth_rows),
                             ("uniform_eval", 131072, 64, cs.depth_rows),
                             ("uniform_eval_bf16", 131072, 8,
                              cs.bf16_depth_rows)):
        args = rows(u, d, gen, dev, integer=False)[:2] + (pct,)
        cs.check_uniform(args, integer=False)
        out.append((name, [u, d], lambda a=args: se.uniform_eval(*a)))
    u, d = cs.MAIN_SHAPE["weighted_eval_uniform"]
    args = cs.unit_rows(u, d, gen, dev, integer=False)
    cs.check_b2(args, False)
    out.append(("weighted_eval_uniform", [u, d],
                lambda a=args: se.weighted_eval(*a, uniform=True)))
    u, d = cs.MAIN_SHAPE["stage_slice"]
    args = cs.slice_rows(u, d, gen, dev, integer=False)
    cs.check_slices(args)
    for cut in se.STAGE_CUTS:
        out.append((f"stage_slice {cut}", [u, d],
                    lambda c=cut, a=args: se.stage_slice(a[0], a[1], c)))
    for mode in se.WIDE_MODES:
        out.append((f"stage_slice_wide {mode}", [u, d],
                    lambda m=mode, a=args: se.stage_slice_wide(*a, m)))
    for mode in cs.SORT_KERNELS:
        vd = 64 if mode == "c0" else d
        vm, vw = cs.variant_rows(u, vd, gen, dev, integer=False)
        cs.check_variants(vm, vw)
        out.append((f"sort_variant {mode}", [u, vd],
                    lambda m=mode, a=(vm, vw): sv.sort_variant(*a, m)))
    return out + _b6_b7_cases(cs, gen, dev) + _b5_b8_b9_cases(cs, gen, dev)


def _b6_b7_cases(cs, gen, dev):
    """B7 at b7_times' two shapes with index_add_ beside it, and B6 on
    mixed rows and on the first fold round's stand-in, each held to its
    plain version first."""
    import numpy as np
    import torch
    from veneur_tpu_torch.ops import compactor_eval as ce
    from veneur_tpu_torch.ops import segmented_reduce as sr
    out = []
    for u, c, g in (cs.MAIN_SHAPE["segment_sums"], (131072, 128, 1024)):
        vals, seg = cs.seg_rows(u, c, g, gen, dev)
        cs.check_segment_sums(vals, seg, g)
        out.append(("segment_sums", [u, c, g],
                    lambda a=(vals, seg, g): sr.launch(*a)))
        out.append(("segment_sums index_add_", [u, c, g],
                    lambda a=(vals, seg, g): torch.zeros(
                        (a[2], a[0].shape[1]), device=dev).index_add_(
                        0, a[1], a[0])))
    u, levels, s2 = cs.MAIN_SHAPE["compact_batch"]
    rng = np.random.default_rng(3)
    for what, rows in (("mixed", cs.compactor_rows),
                       ("first fold", cs.first_fold_rows)):
        args = rows(u, s2 // 2, levels, gen, dev, rng)
        if what == "mixed":
            args = args[0]
        cs.check_compact(args)
        out.append((f"compact_batch {what}", [u, levels, s2],
                    lambda a=args: ce.compact_batch(*a)))
    return out


def _b5_b8_b9_cases(cs, gen, dev):
    """B5 (both variants) at kernel_times' three shapes, B9 and B8 at
    their main-path shapes, each held to its plain version first."""
    import math
    from veneur_tpu_torch.ops import hll_estimate as he
    from veneur_tpu_torch.ops import moments_eval as me
    from veneur_tpu_torch.ops import quantile_eval as qe
    out = []
    for name, u, d in (("moments_sums", 131072, 64),
                       ("moments_sums_depth", 131072, 64),
                       ("moments_sums", 16384, 512)):
        depth = name == "moments_sums_depth"
        rows = cs.moment_rows(u, d, gen, dev, grid=False, depth=depth)
        cs.check_moments(rows, grid=False)
        out.append((name, [u, d], lambda a=rows[:4] + (cs.MOMENTS_K, depth):
                    me.moments_sums(*a)))
    k, c = cs.MAIN_SHAPE["quantile"]
    args = cs.centroid_rows(k, c, gen, dev, integer=False)
    cs.check_b9(args)
    out.append(("quantile", [k, c], lambda a=args: qe.quantile(*a)))
    s, m = cs.MAIN_SHAPE["register_moments"]
    regs = cs.hll_rows(s, int(math.log2(m)), gen, dev)
    cs.check_b8(regs)
    out.append(("register_moments", [s, m],
                lambda r=regs: he.register_moments(r)))
    return out


def run_tree(tree: Path) -> dict:
    """One process's times: the kernels of `tree`'s veneur_tpu_torch,
    each timed with and without cuda_ms's spin, in turns."""
    sys.path.insert(0, str(tree))
    import torch
    cs = _chip_smoke()
    from veneur_tpu_torch.ops import _build
    from veneur_tpu_torch.ops import sort_variants as sv
    from veneur_tpu_torch.ops import sorted_eval as se
    if not Path(se.__file__).resolve().is_relative_to(tree.resolve()):
        raise RuntimeError(f"{se.__file__} is not under {tree}")
    built = _build.build()
    dev = torch.device(cs.DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    times = {}
    with cs._not_counted():
        for name, shape, fn in _cases(cs, se, sv, gen, dev):
            spin = cs.cuda_ms(fn)
            nospin = cs.cuda_ms(fn, slack=0)
            times[f"{name} {'x'.join(map(str, shape))}"] = {
                "spin_ms": spin, "nospin_ms": nospin}
    return {"tree": str(tree), "times": times,
            "build_s": {k: v["seconds"] for k, v in built.items()}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path,
                    help="directory holding the parent's veneur_tpu_torch")
    ap.add_argument("--tree", type=Path, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.tree is not None:
        print(json.dumps(run_tree(a.tree)), flush=True)
        return 0
    if a.parent is None or not (a.parent / "veneur_tpu_torch").is_dir():
        ap.error("--parent must hold a veneur_tpu_torch/ directory")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    trees = {"parent": a.parent.resolve(), "change": ROOT}
    runs = []
    for label in ORDER:
        p = subprocess.run([sys.executable, __file__, "--tree",
                            str(trees[label])], capture_output=True,
                           text=True, timeout=1800)
        if p.returncode != 0:
            print(p.stdout[-4000:] + p.stderr[-4000:], file=sys.stderr)
            return 1
        runs.append(dict(json.loads(p.stdout.strip().splitlines()[-1]),
                         label=label))
    print(f"card: {card}")
    print("kernel: spin parent / change / change / parent ms; "
          "no spin, the same")
    for key in runs[0]["times"]:
        spin = " / ".join(f"{r['times'][key]['spin_ms']:.4f}" for r in runs)
        nospin = " / ".join(f"{r['times'][key]['nospin_ms']:.4f}"
                            for r in runs)
        print(f"{key}: {spin}; {nospin}")
    out = ROOT / "chiprun_out"
    os.makedirs(out, exist_ok=True)
    with open(out / "kernel_ab.json", "w") as f:
        json.dump({"card": card, "order": ORDER, "runs": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
