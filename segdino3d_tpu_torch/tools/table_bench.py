"""Times K7 (``neighbor_table``) and ``block_dilate`` alone in every role
they play on the main paths, on one CUDA card.

    python -m segdino3d_tpu_torch.tools.table_bench [--rounds 5] [--reps 10]

Builds ``chip_smoke.py``'s scene and, in fp32: the device plan's pyramid
at the host plan's capacities and from it every neighbour table of a
device-plan forward (the k5 stem table and a k3 table per level), the stem
table alone and level 0's k3 table alone, and the whole device plan
(``build_unet_plan``); the hybrid host plan's level-0 block tables and on
them the k3 dilation of the occupancy with its row list as the dX convs
take it, and K10's k3 96 -> 96 conv at level
0 in the forward role (on the occupancy) and the dX role (on the
dilation), each as the backward runs it.  Each case is timed with CUDA
events, ``reps`` back-to-back calls a sample, the cases taken in turn
``rounds`` times; after the samples each case's host time a call (calls
enqueued without a sync, on the host clock) and its device time and
operations on the card in one call (``torch.profiler``, the fullest of
three traces) are read.
Prints the card's name and power limit, an empty launch's time, then per
case the samples' minimum and median in ms, the host ms, the profiled
device ms and operations, the bytes bound (inputs read once, outputs written once at the
memory rate) and the calls per device-plan forward or block-dense step.

It also runs in an older checkout of the port, whose K7 builds one table a
launch and probes every offset, whose dilation writes the mask alone (its
list then takes the two list passes) and whose K10 builds its row list
inside each call: copy it into that checkout's ``tools/`` and run it there too,
parent, new, new, parent in one call.

    python -m segdino3d_tpu_torch.tools.table_bench --dtype bf16

runs the K10 cases in bf16 (the warpgroup path), adds K10's level-3
384 -> 256 forward (where the level's tiles are cut into offset groups,
one more launch for the group sum) and K1 at the flagship's k5 stem at the
bf16 pitch (264), so that each call's operations and host time show
beside the fp32 run's.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def plan_cases(batch):
    """K7 and the device plan: (name, calls per forward, call, bytes)"""
    from segdino3d_tpu_torch.models.backbone.res16unet import build_unet_plan
    from segdino3d_tpu_torch.models.backbone.wrapper import min_shift
    from segdino3d_tpu_torch.ops import sparse_conv as SC
    from segdino3d_tpu_torch.ops import voxelize as TV

    caps = [lv.valid.shape[0] for lv in batch.plan.levels]
    valid = batch.point_valid.reshape(-1)
    pts = batch.points.reshape(-1, 6)
    bidx, shifted = min_shift(pts[:, :3] / torch.full((), 0.02, device="cuda"),
                              batch.point_valid)
    grid = TV.voxelize(bidx, shifted, valid, caps[0])
    pyr = SC.build_conv_plan(grid, 5, caps)

    def level_bytes(lv, k):
        return nbytes(lv.coords_T, lv.hash.keys, lv.hash.vals) + 4 \
            + k ** 3 * lv.coords_T.shape[1] * 4

    if hasattr(SC, "neighbor_tables"):
        every = lambda: SC.neighbor_tables(pyr, 5)  # noqa: E731
    else:
        every = lambda: ([SC.neighbor_table(lv, 3) for lv in pyr],  # noqa: E731
                         SC.neighbor_table(pyr[0], 5))
    every_bytes = sum(level_bytes(lv, 3) for lv in pyr) + \
        pyr[0].coords_T.shape[1] * 125 * 4
    return [
        ("K7 every table of a device plan (stem k5 + k3 of 5 levels)", 1,
         every, every_bytes),
        ("K7 stem k5 table, level 0, alone", 0,
         lambda: SC.neighbor_table(pyr[0], 5), level_bytes(pyr[0], 5)),
        ("K7 k3 table, level 0, alone", 0,
         lambda: SC.neighbor_table(pyr[0], 3), level_bytes(pyr[0], 3)),
        ("device plan (build_unet_plan: K6, K8, K7 and the torch glue)", 1,
         lambda: build_unet_plan(grid, 5, 5, caps), 0),
    ]


def dense_cases(plan, gen, dt=torch.float32):
    """The dilation and K10 at level 0 of the hybrid plan, K10 in ``dt``:
    (name, calls per block-dense step, call, bytes)"""
    from segdino3d_tpu_torch.ops import block_dense as BD
    from segdino3d_tpu_torch.ops.sparse_conv import _transposed

    t = plan.blocks[0]
    occ = BD.occupancy(t)
    n, e = occ.shape[0], t.edge
    cached = hasattr(BD, "dilated_rows")
    mask = BD.occupancy_dilation_plain(occ, t.block_nbr, e, 3)
    listed = int(mask.sum())
    x = torch.where(occ[:, None], torch.randn(n, 96, generator=gen,
                                              device="cuda"), 0.0).to(dt)
    w = (torch.randn(27, 96, 96, generator=gen, device="cuda")
         * 27 ** -0.5).to(dt)
    wt = _transposed(w.flip(0))
    if cached:
        mask_rows = BD.dilated_rows(occ, t.block_nbr, e, 3)[1]
        occ_rows = BD.row_list(t, occ)
        with_list = lambda: BD.dilated_rows(occ, t.block_nbr, e, 3)  # noqa: E731
        dx = lambda: BD.block_conv(x, t.block_nbr, wt, mask, e,  # noqa: E731
                                   mask_rows)
        fwd = lambda: BD.block_conv(x, t.block_nbr, w, occ, e,  # noqa: E731
                                    occ_rows)
    else:   # the older checkout: the mask's kernel, then the list passes
        with_list = lambda: BD.occupied_rows(  # noqa: E731
            BD.occupancy_dilation(occ, t.block_nbr, e, 3))
        dx = lambda: BD.block_conv(x, t.block_nbr, wt, mask, e)  # noqa: E731
        fwd = lambda: BD.block_conv(x, t.block_nbr, w, occ, e)  # noqa: E731
    base = nbytes(occ, t.block_nbr) + n
    conv = nbytes(x, t.block_nbr, w) + n + n * 96 * x.element_size()
    return [
        ("dilation k3, level 0, the mask and its row list", 5, with_list,
         base + 4 * listed + 4),
        ("K10 dX k3 96->96 level 0 under the dilation", 46, dx, conv),
        ("K10 forward k3 96->96 level 0 on the occupancy", 47, fwd, conv),
    ]


def bf16_cases(batch, hybrid, gen):
    """K10's level-3 384 -> 256 forward and K1's k5 stem at the bf16
    pitch: (name, calls per forward, call, bytes)"""
    from segdino3d_tpu_torch.ops import block_dense as BD
    from segdino3d_tpu_torch.ops import sparse_conv as SC

    bf16 = torch.bfloat16
    t = hybrid.blocks[3]
    occ = BD.occupancy(t)
    x = torch.where(occ[:, None], torch.randn(
        occ.shape[0], 384, generator=gen, device="cuda"), 0.0).to(bf16)
    w = (torch.randn(27, 384, 256, generator=gen, device="cuda")
         * (27 * 384) ** -0.5).to(bf16)
    rows = BD.row_list(t, occ) if hasattr(BD, "row_list") else None
    lv = batch.plan.levels
    v0 = lv[0].valid.shape[0]
    xs = torch.randn(v0, 264, generator=gen, device="cuda")
    xs[:, 259:] = 0.0
    xs = xs.to(bf16)
    ws = torch.randn(125, 264, 32, generator=gen, device="cuda") * 0.005
    ws[:, 259:] = 0.0
    ws = ws.to(bf16)
    return [
        ("K10 forward k3 384->256 level 3 on the occupancy (bf16)", 1,
         lambda: BD.block_conv(x, t.block_nbr, w, occ, t.edge, rows),
         nbytes(x, t.block_nbr, w) + occ.shape[0] * (1 + 256 * 2)),
        ("K1 stem k5 264->32 level 0 (bf16 pitch)", 1,
         lambda: SC.gather_conv(xs, batch.plan.stem_nbr, ws, lv[0].valid),
         nbytes(xs, batch.plan.stem_nbr, ws, lv[0].valid) + v0 * 32 * 2),
    ]


def device_split(fn):
    """({operation: summed device ms} of one call of ``fn``, their sum,
    the operations' count), by ``torch.profiler`` after a warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = ({}, 0)
    for _ in range(3):   # the trace may drop an event: keep the fullest
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        split, count = {}, 0
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                count += 1
                name = e.name.replace("(anonymous namespace)::",
                                      "").split("(")[0]
                split[name] = split.get(name, 0.0) + \
                    e.time_range.elapsed_us() / 1e3
        if count > best[1]:
            best = (split, count)
    return best[0], sum(best[0].values()), best[1]


def host_ms(fn, reps):
    """Host time of one call: ``reps`` calls enqueued back to back without
    a sync, on the host clock."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return t


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--dtype", choices=("fp32", "bf16"), default="fp32",
                    help="K10 in bf16, and the bf16 cases of K10 and K1")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("table_bench: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    from segdino3d_tpu_torch.data.collate import (PadSpec, attach_host_plan,
                                                  collate)
    from segdino3d_tpu_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_build.build_all(("coord_hash", "voxel_compact", "neighbor_table",
                          "block_conv", "gather_gemm_conv", "gather_wgrad"))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    lib = cuda_build.library("neighbor_table")
    if hasattr(lib, "empty_launch"):
        anchor = torch.empty(1, device="cuda")

        def empty():
            cuda_build.check(lib.empty_launch(cuda_build.stream_ptr(anchor)),
                             "empty_launch")

        print(f"an empty launch: {C.time_ms(empty, 100):.4f} ms (CUDA "
              f"events), {C.device_ops(empty)[1] / 1e3:.4f} ms of device "
              "time", flush=True)
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
    if args.dtype == "bf16":
        runs = dense_cases(hybrid.plan, gen, torch.bfloat16) + bf16_cases(
            batch, hybrid.plan, gen)
    else:
        runs = plan_cases(batch) + dense_cases(hybrid.plan, gen)
    samples = {i: [] for i in range(len(runs))}
    for _ in range(args.rounds):
        for i, run in enumerate(runs):
            samples[i].append(C.time_ms(run[2], args.reps))
    for i, (name, calls, fn, byts) in enumerate(runs):
        t = np.array(samples[i])
        split, dev_ms, count = device_split(fn)
        host = float(np.median([host_ms(fn, args.reps) for _ in range(3)]))
        parts = ", ".join(f"{k} {v:.4f}" for k, v in sorted(split.items())) \
            if len(split) <= 4 else f"{len(split)} kinds of operation"
        bound = f"{C.bound(0.0, byts, 'fp32')[0]:.4f} ms (bytes)" if byts \
            else "not computed"
        print(f"{name}: min {t.min():.4f} ms, median {float(np.median(t)):.4f}"
              f" ms over {args.rounds} x {args.reps} calls; host {host:.4f} "
              f"ms a call (enqueued, median of 3 x {args.reps}); device "
              f"{dev_ms:.4f} ms in {count} operations ({parts});"
              f" bound {bound}; calls per device-plan forward or block-dense "
              f"step {calls}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
