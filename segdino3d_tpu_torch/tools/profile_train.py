"""Device-time breakdown of the port's training step on one CUDA card.

    python -m segdino3d_tpu_torch.tools.profile_train
        [--layout gather|hybrid|block-dense] [--out PATH]

Runs ``chip_smoke.py``'s training path (flagship SegDINO3D and criterion,
seeded random weights, the seeded 120,000-point synthetic scene, fp32,
batch 1, AdamW + clip + EMA): one warm-up step, then one step of forward +
criterion + backward + optimizer under ``torch.profiler``.  Prints the
device time summed by kernel name (top 30), the device time of K1 and of
the weight gradients (K4, its pair lists apart, and K11;
``chip_smoke.kernel_ms``), the device busy time against the wall time of
the profiled window (the device's idle share), and the
kernel launch count.  The host plan stays outside the window: it runs no
device work.  ``--layout`` picks its conv layout (``chip_smoke.plan_layout``):
the gather layout (default) or the flagship config's training layout
``block-dense`` (the k5 stem too), or ``hybrid``.
"""
from __future__ import annotations

import argparse
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
    ap.add_argument("--layout", default="gather",
                    choices=("gather", "hybrid", "block-dense"),
                    help="the host plan's conv layout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    from segdino3d_tpu_torch.builder import Capacities, build_model, \
        random_init_
    from segdino3d_tpu_torch.data.collate import (PadSpec, attach_host_plan,
                                                  collate)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    records = C.make_records()
    spec = PadSpec(C.SCENE["n_points"], C.SCENE["n_superpoints"], 64, 128,
                   200)
    model, _ = build_model(
        C.train_cfg(), Capacities(num_superpoints=C.SCENE["n_superpoints"]),
        train=True)
    random_init_(model, seed=0)
    step = C.make_train_step(model, 1)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = attach_host_plan(collate(records, spec, "cuda"), records, spec,
                             level_cap_ratios=C.LEVEL_CAP_RATIOS,
                             **C.plan_layout(args.layout))

    def device_part():
        step([batch], generator=gen)
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
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    print(f"layout: {args.layout}")
    print(avgs.table(sort_by="self_device_time_total", row_limit=30))
    km = C.kernel_ms(events)
    print(f"K1 {km['K1']:.2f}, K2 {km['K2']:.4f}, K3 {km['K3']:.4f} ms; "
          f"weight gradients: K4 {km['K4']:.2f} ms (+ "
          f"pair lists {km['K4 pair lists']:.2f}), K11 {km['K11']:.2f} ms of "
          f"device time")
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
