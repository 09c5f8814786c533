"""How far rounding-sized changes in the convs move a training step.

    python -m segdino3d_tpu_torch.tools.step_sensitivity [--eps 1e-6]
        [--seeds 3] [--model flagship|baseline|options] [--points 4000]

Runs the small training step of one of ``chip_smoke.py``'s card-vs-CPU
checks (``check_small_train``: seeded weights, a sparse scene of
``--points`` points at 500 per m^2) on the CPU with the plain versions:
``flagship`` is phase 4c's (the flagship training model, block-dense),
``baseline`` phase 6c's (the rgb-only Baseline, block-dense, the scene
without its 2D features), ``options`` phase 7a's (the decoder options
model with dropout 0, gather).  It runs the step once as it is and then
once per seed with every conv's output (the plain K10 on the block-dense
layouts, the plain K1 on the gather one) multiplied by
``1 + eps * N(0, 1)``, and prints the gradient norm and the norm of the
stem kernel's clipped gradient (what the check compares per leaf) of each
run beside their relative change.  That check holds the card's gradient
norm to the CPU's at rtol 1e-4, so this says how close to the plain
version's rounding a conv kernel must stay, and on which scene the check
can tell a fault from rounding.  CPU only, ~30 s a run at 4,000 points.
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
                    help="relative noise on each conv output")
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--model", choices=("flagship", "baseline", "options"),
                    default="flagship")
    ap.add_argument("--points", type=int, default=4000)
    args = ap.parse_args()

    import chip_smoke as C
    from segdino3d_tpu_torch.builder import (Capacities, build_model,
                                             random_init_)
    from segdino3d_tpu_torch.data.collate import (PadSpec, attach_host_plan,
                                                  collate)
    from segdino3d_tpu_torch.ops import block_dense as BD
    from segdino3d_tpu_torch.ops import sparse_conv as SC

    cfg, layout = {"flagship": (C.train_cfg(), "block-dense"),
                   "baseline": (C.baseline_model_cfg(), "baseline-train"),
                   "options": (C.options_cfg(dropout=0.0), "gather")
                   }[args.model]
    caps = Capacities(num_superpoints=C.SCENE["n_superpoints"],
                      num_voxels=92160, level_cap_ratios=C.LEVEL_CAP_RATIOS)
    model, _ = build_model(cfg, caps, train=True, device="cpu")
    random_init_(model, seed=0)
    rec = C.small_train_records(model, cfg, args.points)
    spec = PadSpec(args.points + 96, C.SCENE["n_superpoints"], 16, 16,
                   cfg["criterion_cfg"]["num_semantic_classes"])
    mod, name = (SC, "gather_conv_plain") if layout == "gather" else \
        (BD, "dense_subm_conv_plain")
    plain = getattr(mod, name)

    def step(noise_seed):
        if noise_seed is not None:
            gen = torch.Generator().manual_seed(noise_seed)

            def noisy(*a):
                out = plain(*a)
                return out * (1 + args.eps * torch.randn(out.shape,
                                                         generator=gen))

            setattr(mod, name, noisy)
        try:
            m = copy.deepcopy(model)
            batch = attach_host_plan(collate(rec, spec, "cpu"), rec, spec,
                                     level_cap_ratios=(1.0,) * 5,
                                     **C.plan_layout(layout))
            q = C.numpy_queries(batch.num_superpoints.numpy(),
                                C.SCENE["n_superpoints"], seed=5)
            train = C.make_train_step(m, 1, ema=False, cfg=cfg)
            norm = train.host_metrics(train([batch], queries=[q]))[
                "grad_norm"]
            stem = float(m.backbone.unet.conv0p1s1.kernel.grad.norm())
            return norm, stem
        finally:
            setattr(mod, name, plain)

    base = step(None)
    print(f"{args.model}, {args.points} points: plain: grad_norm "
          f"{base[0]:.6f}, stem kernel grad {base[1]:.6f}", flush=True)
    for seed in range(args.seeds):
        norm, stem = step(seed)
        print(f"eps {args.eps:g} seed {seed}: grad_norm {norm:.6f} "
              f"({norm / base[0] - 1:+.2e}), stem kernel grad {stem:.6f} "
              f"({stem / base[1] - 1:+.2e})", flush=True)


if __name__ == "__main__":
    main()
