"""Device-time breakdown of the port's main path on one CUDA card.

    python -m segdino3d_tpu_torch.tools.profile_eval [--device-plan]
        [--layout gather|hybrid|block-dense] [--out PATH]

Runs ``chip_smoke.py``'s main path (flagship SegDINO3D, seeded random
weights, the seeded 120,000-point synthetic scene, fp32, batch 1): one
warm-up iteration, then one iteration of backbone + decoder +
post-processing under ``torch.profiler``.  Prints the device time summed by
kernel name (top 25), K1's, K2's and K3's device time
(``chip_smoke.kernel_ms``), the (N, 259) concatenations of the point
features in one more forward (``chip_smoke.concat_shapes``; none: the
voxel mean reads its two sources), the
device busy time against the wall time of the profiled window (the
device's idle share), and the kernel launch count.
The host plan and the AP protocol stay outside the window: they run no
device work.  With ``--device-plan`` the batch carries no host plan and
the backbone builds it on the card inside the window (kernels K6-K8), at
the host plan's capacities.  ``--layout`` picks the host plan's conv layout
(``chip_smoke.plan_layout``): the gather layout (default), the flagship
config's eval layout ``hybrid`` or ``block-dense``; device plans are
gather plans.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write the full key_averages table here")
    ap.add_argument("--device-plan", action="store_true",
                    help="build the plan on the card inside the window")
    ap.add_argument("--layout", default="gather",
                    choices=("gather", "hybrid", "block-dense"),
                    help="the host plan's conv layout")
    args = ap.parse_args()
    if args.device_plan and args.layout != "gather":
        ap.error("device plans run the gather layout")
    if not torch.cuda.is_available():
        print("profile_eval: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    from segdino3d_tpu_torch.builder import Capacities, build_model, \
        random_init_
    from segdino3d_tpu_torch.data.collate import (PadSpec, attach_host_plan,
                                                  collate)
    from segdino3d_tpu_torch.evaluation.evaluate import postprocess

    records = C.make_records()
    spec = PadSpec(C.SCENE["n_points"], C.SCENE["n_superpoints"], 64, 128,
                   200)
    batch = attach_host_plan(collate(records, spec, "cuda"), records, spec,
                             level_cap_ratios=C.LEVEL_CAP_RATIOS,
                             **C.plan_layout(args.layout))
    model, test_cfg = build_model(
        C.model_cfg(), Capacities(
            num_superpoints=C.SCENE["n_superpoints"],
            num_voxels=batch.plan.levels[0].valid.shape[0],
            level_cap_ratios=C.LEVEL_CAP_RATIOS))
    random_init_(model, seed=0)
    if args.device_plan:
        batch = dataclasses.replace(batch, plan=None)

    def device_part():
        with torch.no_grad():
            out = model.decode(batch, model.backbone(batch))
            postprocess(out, batch, test_cfg)
        torch.cuda.synchronize()

    device_part()                            # warm-up (and kernel build)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        device_part()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
    avgs = prof.key_averages()
    table = avgs.table(sort_by="self_device_time_total", row_limit=25)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    print(f"layout: {'device plan' if args.device_plan else args.layout}")
    print(table)
    # one more forward, its concatenations recorded (that slows the host)
    cats = [sh for sh in C.concat_shapes(device_part)
            if sh == (C.SCENE["n_points"], 259)]
    km = C.kernel_ms(events)
    print(f"K1 {km['K1']:.2f}, K2 {km['K2']:.4f}, K3 {km['K3']:.4f} ms of "
          f"device time; (N, 259) concatenations: {len(cats)}")
    print(f"profiled window: wall {wall_ms:.2f} ms, device busy "
          f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%), idle share "
          f"{100 * (1 - busy_ms / wall_ms):.1f}%, {len(events)} device "
          f"kernels/copies")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(avgs.table(sort_by="self_device_time_total",
                               row_limit=200))
    return 0


if __name__ == "__main__":
    sys.exit(main())
