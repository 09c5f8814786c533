"""Times K1 (``gather_gemm_conv``) alone in every role it plays on the
gather layout's main path, at each level's real widths, on one CUDA card.

    python -m segdino3d_tpu_torch.tools.conv_bench [--rounds 3] [--reps 10]

Builds ``chip_smoke.py``'s scene and host plan and takes every distinct K1
call of a Res16UNet34C forward and training step: the k5 stem 259 -> 32;
the k3 convs of each level with their widths (levels 0-4, the decoder
blocks' concatenated inputs included) and, in training, the same convs as
dX (the mirror identity: Cin and Cout swapped); the four down convs over
the child tables and the four up convs' dX over them.  Each case is timed
with CUDA events, ``reps`` back-to-back calls a sample, the cases taken in
turn ``rounds`` times, fp32 as the main path runs, and beside it once the
library yardstick (``chip_smoke.conv_library``: a gather and one cuBLAS
GEMM, TF32 off).  Prints the card's name and power limit, then per case
its calls per forward and per step, the samples' minimum and median in ms,
the library's ms and the bound of its live pairs (2 x pairs x Cin x Cout
operations at the fp32 peak, or its bytes at the memory rate, the
larger); then the calls' medians summed per forward and per step.  K1's pair lists (K4's, ``cached_pairs``) are built before the
timing, as a forward builds them once per table.  Run it in two checkouts
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

# (level, Cin, Cout, calls per forward) of the 46 k3 convs: blocks 1-4 on
# the way down, blocks 5-8 on the way up with the skip concatenated
K3_CONVS = ((0, 128, 96, 1), (0, 96, 96, 3),
            (1, 32, 32, 4), (1, 128, 96, 1), (1, 96, 96, 3),
            (2, 32, 64, 1), (2, 64, 64, 5), (2, 192, 128, 1),
            (2, 128, 128, 3),
            (3, 64, 128, 1), (3, 128, 128, 7), (3, 384, 256, 1),
            (3, 256, 256, 3),
            (4, 128, 256, 1), (4, 256, 256, 11))
# (fine level, Cin, Cout) of the down convs and of the up convs (whose dX
# is K1 over the fine level's child table, Cout -> Cin)
DOWN_CONVS = ((0, 32, 32), (1, 32, 32), (2, 64, 64), (3, 128, 128))
UP_CONVS = ((0, 96, 96), (1, 128, 96), (2, 256, 128), (3, 256, 256))


def cases(plan, gen):
    """(name, calls per forward, calls per step, kernel call, library
    call, live pairs, Cin, Cout, bytes)"""
    import chip_smoke as C
    from segdino3d_tpu_torch.ops import sparse_conv as SC

    lv = plan.levels
    out = []

    def case(name, fwd, step, x_rows, nbr, valid, cin, cout):
        x = torch.randn(x_rows, cin, generator=gen, device="cuda")
        w = torch.randn(nbr.shape[0], cin, cout, generator=gen,
                        device="cuda") * (nbr.shape[0] * cin) ** -0.5
        pairs = int((nbr[:, valid] >= 0).sum())
        byts = sum(t.numel() * t.element_size() for t in (x, nbr, w, valid))
        out.append((name, fwd, step, lambda: SC.gather_conv(x, nbr, w, valid),
                    lambda: C.conv_library(x, nbr, w), pairs, cin, cout,
                    byts + nbr.shape[1] * cout * 4))

    v = [t.valid.shape[0] for t in lv]
    case("stem k5 259->32 L0", 1, 1, v[0], plan.stem_nbr, lv[0].valid, 259,
         32)
    for li, cin, cout, n in K3_CONVS:
        case(f"k3 {cin}->{cout} L{li}", n, n, v[li], lv[li].nbr, lv[li].valid,
             cin, cout)
    for li, cin, cout, n in K3_CONVS:
        case(f"k3 dX {cout}->{cin} L{li}", 0, n, v[li], lv[li].nbr,
             lv[li].valid, cout, cin)
    for li, cin, cout in DOWN_CONVS:
        case(f"down {cin}->{cout} L{li}->L{li + 1}", 1, 1, v[li], lv[li].child,
             lv[li + 1].valid, cin, cout)
    for li, cin, cout in UP_CONVS:
        every = torch.ones(v[li + 1], dtype=torch.bool, device="cuda")
        case(f"up dX {cout}->{cin} L{li}->L{li + 1}", 0, 1, v[li],
             lv[li].child, every, cout, cin)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("conv_bench: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    from segdino3d_tpu_torch.data.collate import (PadSpec, attach_host_plan,
                                                  collate)
    from segdino3d_tpu_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_build.build_all(("gather_gemm_conv", "gather_wgrad"))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    records = C.make_records()
    spec = PadSpec(C.SCENE["n_points"], C.SCENE["n_superpoints"], 64, 128,
                   200)
    plan = attach_host_plan(collate(records, spec, "cuda"), records, spec,
                            voxel_size=0.02,
                            level_cap_ratios=C.LEVEL_CAP_RATIOS).plan
    print(f"voxels per level {[int(t.valid.sum()) for t in plan.levels]}, "
          f"caps {[t.valid.shape[0] for t in plan.levels]}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    runs = cases(plan, gen)
    samples = {i: [] for i in range(len(runs))}
    for _ in range(args.rounds):
        for i, run in enumerate(runs):
            samples[i].append(C.time_ms(run[3], args.reps))
    library = [C.time_ms(run[4], args.reps) for run in runs]
    per_fwd = per_step = bound_step = 0.0
    for i, (name, fwd, step, _, _, pairs, cin, cout, byts) in enumerate(runs):
        t = np.array(samples[i])
        med = float(np.median(t))
        b_ms, b_by = C.bound(2.0 * pairs * cin * cout, byts, "fp32")
        per_fwd += fwd * med
        per_step += step * med
        bound_step += step * b_ms
        print(f"{name}: min {t.min():.4f} ms, median {med:.4f} ms over "
              f"{args.rounds} x {args.reps} calls; library {library[i]:.4f} "
              f"ms; {pairs} live pairs, bound {b_ms:.4f} ms ({b_by}); calls "
              f"per forward {fwd}, per step {step}", flush=True)
    print(f"K1 summed over its calls (medians): {per_fwd:.4f} ms per gather "
          f"forward, {per_step:.4f} ms per gather training step (bound "
          f"{bound_step:.4f} ms)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
