"""How far rounding-sized changes in the block conv move a training step.

    python -m segdino3d_tpu_torch.tools.step_sensitivity [--eps 1e-6]
        [--seeds 3]

Runs the small block-dense training step of ``chip_smoke.py`` phase 4c's
card-vs-CPU check (``check_small_train``: the flagship training model with
seeded weights, a sparse 4,000-point scene) on the CPU with the plain
versions, once as it is and then once per seed with every block conv's
output (``dense_subm_conv_plain``, the plain K10) multiplied by
``1 + eps * N(0, 1)``, and prints the gradient norm and the norm of the
stem kernel's clipped gradient (what the check compares per leaf) of each
run beside their relative change.  That check holds
the card's gradient norm to the CPU's at rtol 1e-4, so this says how close
to the plain version's rounding a block conv kernel must stay.  CPU only,
~30 s a run.
"""
from __future__ import annotations

import argparse
import copy
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--eps", type=float, default=1e-6,
                    help="relative noise on each block conv output")
    ap.add_argument("--seeds", type=int, default=3)
    args = ap.parse_args()

    import chip_smoke as C
    from segdino3d_tpu_torch.builder import (Capacities, build_model,
                                             random_init_)
    from segdino3d_tpu_torch.data.collate import (PadSpec, attach_host_plan,
                                                  collate)
    from segdino3d_tpu_torch.data.synthetic import synthetic_scene
    from segdino3d_tpu_torch.ops import block_dense as BD

    caps = Capacities(num_superpoints=C.SCENE["n_superpoints"],
                      num_voxels=92160, level_cap_ratios=C.LEVEL_CAP_RATIOS)
    model, _ = build_model(C.train_cfg(), caps, train=True, device="cpu")
    random_init_(model, seed=0)
    rec = [synthetic_scene(1, n_points=4000, n_instances=6, n_superpoints=128,
                           n_classes=180, feat_dim_2d=256,
                           point_density=500.0)]
    spec = PadSpec(4096, C.SCENE["n_superpoints"], 16, 16, 200)
    plain = BD.dense_subm_conv_plain

    def step(noise_seed):
        if noise_seed is None:
            BD.dense_subm_conv_plain = plain
        else:
            gen = torch.Generator().manual_seed(noise_seed)

            def noisy(*a):
                out = plain(*a)
                return out * (1 + args.eps * torch.randn(out.shape,
                                                         generator=gen))

            BD.dense_subm_conv_plain = noisy
        try:
            m = copy.deepcopy(model)
            batch = attach_host_plan(collate(rec, spec, "cpu"), rec, spec,
                                     level_cap_ratios=(1.0,) * 5,
                                     **C.plan_layout("block-dense"))
            q = C.numpy_queries(batch.num_superpoints.numpy(),
                                C.SCENE["n_superpoints"], seed=5)
            train = C.make_train_step(m, 1, ema=False)
            norm = train.host_metrics(train([batch], queries=[q]))[
                "grad_norm"]
            stem = float(m.backbone.unet.conv0p1s1.kernel.grad.norm())
            return norm, stem
        finally:
            BD.dense_subm_conv_plain = plain

    base = step(None)
    print(f"plain: grad_norm {base[0]:.6f}, stem kernel grad {base[1]:.6f}",
          flush=True)
    for seed in range(args.seeds):
        norm, stem = step(seed)
        print(f"eps {args.eps:g} seed {seed}: grad_norm {norm:.6f} "
              f"({norm / base[0] - 1:+.2e}), stem kernel grad {stem:.6f} "
              f"({stem / base[1] - 1:+.2e})", flush=True)


if __name__ == "__main__":
    main()
