"""How far rounding-sized changes in the convs move a training step.

    python -m segdino3d_tpu_torch.tools.step_sensitivity [--eps 1e-6]
        [--seeds 3] [--model flagship|flagship-bf16|baseline|options]
        [--points 4000] [--leaves 12]

Runs the small training step of one of ``chip_smoke.py``'s card-vs-CPU
checks (``check_small_train``: seeded weights, a sparse scene of
``--points`` points at 500 per m^2) on the CPU with the plain versions:
``flagship`` is phase 4c's (the flagship training model, block-dense),
``flagship-bf16`` phase 10b's (the same with a bf16 backbone; there the
plain conv's bf16 output is scaled and rounded again, so an ``eps`` near
bf16's half ulp, 2e-3, flips roundings as another summation order does),
``baseline`` phase 6c's (the rgb-only Baseline, block-dense, the scene
without its 2D features), ``options`` phase 7a's (the decoder options
model with dropout 0, gather).  It runs the step once as it is and then
once per seed with every conv's output (the plain K10 on the block-dense
layouts, the plain K1 on the gather one) multiplied by
``1 + eps * N(0, 1)``, and prints the gradient norm and the norm of the
stem kernel's clipped gradient and the segmentation and total losses of
each run beside their relative change; then, per gradient leaf (the
clipped gradient's norm), its spread: the largest relative change over
the seeds, the largest spreads first (phase 10b's leaf limits).
That check holds the card's gradient norm to the CPU's at rtol 1e-4 (the
bf16 model's at its own, wider tolerances), so this says how close to
the plain version's rounding a conv kernel must stay, and on which scene
the check can tell a fault from rounding.  CPU only, ~30 s a run at 4,000
points.
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
    ap.add_argument("--model", choices=("flagship", "flagship-bf16",
                                        "baseline", "options"),
                    default="flagship")
    ap.add_argument("--points", type=int, default=4000)
    ap.add_argument("--leaves", type=int, default=12,
                    help="gradient leaves printed, the largest spreads first")
    args = ap.parse_args()

    import chip_smoke as C
    from segdino3d_tpu_torch.builder import (Capacities, build_model,
                                             random_init_)
    from segdino3d_tpu_torch.data.collate import (PadSpec, attach_host_plan,
                                                  collate)
    from segdino3d_tpu_torch.ops import block_dense as BD
    from segdino3d_tpu_torch.ops import sparse_conv as SC

    cfg, layout = {"flagship": (C.train_cfg(), "block-dense"),
                   "flagship-bf16": (C.bf16_cfg(C.train_cfg()),
                                     "block-dense"),
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
            metrics = train.host_metrics(train([batch], queries=[q]))
            stem = float(m.backbone.unet.conv0p1s1.kernel.grad.norm())
            leaves = {n: float(p.grad.norm())
                      for n, p in m.named_parameters()}
            return (metrics["grad_norm"], stem, metrics["seg_loss"],
                    metrics["total_loss"]), leaves
        finally:
            setattr(mod, name, plain)

    base, base_leaves = step(None)
    names = ("grad_norm", "stem kernel grad", "seg_loss", "total_loss")
    print(f"{args.model}, {args.points} points: plain: " + ", ".join(
        f"{n} {v:.6f}" for n, v in zip(names, base)), flush=True)
    spread = dict.fromkeys(base_leaves, 0.0)
    for seed in range(args.seeds):
        run, leaves = step(seed)
        print(f"eps {args.eps:g} seed {seed}: " + ", ".join(
            f"{n} {v:.6f} ({v / b - 1:+.2e})"
            for n, v, b in zip(names, run, base)), flush=True)
        for n, b in base_leaves.items():
            change = abs(leaves[n] - b) / b if b else \
                (0.0 if leaves[n] == 0.0 else float("inf"))
            spread[n] = max(spread[n], change)
    order = sorted(spread, key=spread.get, reverse=True)
    print(f"per leaf: {len(order)} gradient leaves, largest spread over "
          f"{args.seeds} seeds {spread[order[0]]:.3e}, median "
          f"{spread[order[len(order) // 2]]:.3e}", flush=True)
    backbone = [spread[n] for n in order if n.startswith("backbone.")]
    print(f"backbone: {len(backbone)} leaves, largest spread "
          f"{backbone[0]:.3e}, median {backbone[len(backbone) // 2]:.3e}",
          flush=True)
    for n in order[:args.leaves]:
        print(f"  {n}: plain {base_leaves[n]:.6g}, spread {spread[n]:.3e}",
              flush=True)


if __name__ == "__main__":
    main()
