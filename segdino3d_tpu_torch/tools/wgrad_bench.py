"""Times the weight-gradient kernels, K4 and K11, at the training path's
shapes on one CUDA card.

    python -m segdino3d_tpu_torch.tools.wgrad_bench [--rounds 3] [--reps 10]

Builds ``chip_smoke.py``'s scene, host plan and hybrid plan, takes its K4
cases (the stem, a level-0 k3 conv, a down and an up conv) and K11 cases
(level-0 k3 and the dense stem), and times each kernel call with CUDA
events, ``reps`` back-to-back calls a sample, the cases taken in turn
``rounds`` times.  Prints the card's name and power limit, then per case
the samples' minimum and median in ms, and each case's bound.  Its lists
(K4's pair lists, K11's row list) are built before the timing, as a
training step builds them once for all its calls.  Run it in two checkouts
within one call to compare two versions of the kernels.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("wgrad_bench: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    from segdino3d_tpu_torch.data.collate import (PadSpec, attach_host_plan,
                                                  collate)
    from segdino3d_tpu_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_build.build_all(("gather_wgrad", "block_wgrad", "block_conv"))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    records = C.make_records()
    spec = PadSpec(C.SCENE["n_points"], C.SCENE["n_superpoints"], 64, 128,
                   200)
    batch = attach_host_plan(collate(records, spec, "cuda"), records, spec,
                             voxel_size=0.02,
                             level_cap_ratios=C.LEVEL_CAP_RATIOS)
    hybrid = attach_host_plan(collate(records, spec, "cuda"), records, spec,
                              level_cap_ratios=C.LEVEL_CAP_RATIOS,
                              **C.plan_layout("hybrid"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    wanted = ("gather_wgrad", "block_wgrad")
    cases = [c for c in C.backward_cases(batch, C.SCENE["n_superpoints"],
                                         gen)
             + C.dense_cases(hybrid.plan, gen) if c[0] in wanted]
    runs = []
    for kernel, name, per in cases:
        kfn, _, _, ops, byts, peak, *_ = per[torch.float32]
        runs.append((kernel, name.split(";")[0].split(",")[0], kfn,
                     C.bound(ops, byts, peak)[0]))
    samples = {i: [] for i in range(len(runs))}
    for _ in range(args.rounds):
        for i, (_, _, fn, _) in enumerate(runs):
            samples[i].append(C.time_ms(fn, args.reps))
    for i, (kernel, name, _, b_ms) in enumerate(runs):
        t = np.array(samples[i])
        print(f"{kernel} [{name}]: min {t.min():.4f} ms, median "
              f"{np.median(t):.4f} ms over {args.rounds} x {args.reps} "
              f"calls; bound {b_ms:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
