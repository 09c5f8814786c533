"""Times K6 (``coord_hash``), K7 (``neighbor_table``), K8
(``voxel_compact``) and K5 (``segment_grad``) in the roles they play on
the main paths, on one CUDA card.

    python -m segdino3d_tpu_torch.tools.hash_bench [--rounds 5] [--reps 10]

Builds ``chip_smoke.py``'s scene and, in fp32: each pyramid level's hash
of a device-plan forward (level 0's 120,000 point keys, then each
downsample's voxel keys) as the plan engine runs it, a build and a lookup
of the same keys, and the five together; every neighbour table of the
device plan in K7's one launch; K8's compaction of voxelize and of the
downsample to level 1; the whole device plan (``build_unet_plan``); and
the pool's backward as ``_PoolGathered.backward`` runs it on the
(1,536, 102) superpoint gradient (K5 and whatever glue the backward
launches around it), beside a fill of K5's output alone.  Each case is timed with CUDA events, ``reps``
back-to-back calls a sample, the cases taken in turn ``rounds`` times;
then each case's host time a call and its device time and operations on
the card in one call (``torch.profiler``) are read, as in
``table_bench.py``.
Prints the card's name and power limit, then per case the samples'
minimum and median in ms, the host ms, the profiled device ms and
operations, the bytes bound (inputs read once, outputs written once at
the memory rate) and the calls per device-plan forward or training step.

It also runs in an older checkout of the port, whose K6 builds with two
launches and looks up with a third and whose pool backward divides by the
superpoint counts before K5: copy it into that checkout's ``tools/`` and
run it there too, parent, new, new, parent in one call.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def plan_cases(batch):
    """K6, K7, K8 and the device plan: (name, calls per forward, call,
    bytes)"""
    from segdino3d_tpu_torch.models.backbone.res16unet import build_unet_plan
    from segdino3d_tpu_torch.models.backbone.wrapper import min_shift
    from segdino3d_tpu_torch.ops import hashing as TQ
    from segdino3d_tpu_torch.ops import keys as TK
    from segdino3d_tpu_torch.ops import sparse_conv as SC
    from segdino3d_tpu_torch.ops import voxelize as TV

    caps = [lv.valid.shape[0] for lv in batch.plan.levels]
    valid = batch.point_valid.reshape(-1)
    pts = batch.points.reshape(-1, 6)
    bidx, shifted = min_shift(pts[:, :3] / torch.full((), 0.02, device="cuda"),
                              batch.point_valid)
    cols, key = TV.point_keys(bidx, shifted, valid)
    grid = TV.voxelize(bidx, shifted, valid, caps[0])
    pyr = SC.build_conv_plan(grid, 5, caps)
    # (keys, capacity) of each level's hash, as voxelize and downsample
    # call it
    hashes = [(key, min(caps[0], key.shape[0]))]
    for li in range(1, len(pyr)):
        b, x, y, z = pyr[li - 1].coords_T
        hashes.append((TK.pack_columns_u32(b, x >> 1, y >> 1, z >> 1,
                                           pyr[li - 1].valid),
                       min(caps[li], caps[li - 1])))

    if hasattr(TQ, "build_and_lookup"):
        build = TQ.build_and_lookup
    else:   # the older checkout: a build, then a lookup of the same keys
        def build(k, cap):
            h = TQ.build_hash(k, cap)
            return h, TQ.lookup_hash(h, k)

    def hash_bytes(k, cap):
        return nbytes(k) + k.shape[0] * 4 + TQ.table_size(cap) * 8

    cases = [(f"K6 build + lookup, level {li} ({k.shape[0]} keys, "
              f"{TQ.table_size(cap)} slots)", 1,
              lambda k=k, cap=cap: build(k, cap), hash_bytes(k, cap))
             for li, (k, cap) in enumerate(hashes)]
    cases.append(("K6 every level of a device-plan forward", 1,
                  lambda: [build(k, cap) for k, cap in hashes],
                  sum(hash_bytes(k, cap) for k, cap in hashes)))

    h0, w0 = build(key, hashes[0][1])
    h1, w1 = build(*hashes[1])
    cases += [
        ("K8 voxelize, 120,000 points -> V0", 1,
         lambda: TV.voxel_compact(w0, cols, caps[0], 0, h0),
         nbytes(w0, cols) + 2 * nbytes(h0.vals) + 4 * caps[0] * 4 + caps[0]
         + w0.shape[0] * 4),
        ("K8 downsample L0 -> L1 (parent, kpos)", 1,
         lambda: TV.voxel_compact(w1, grid.coords_T, caps[1], 1, h1, True),
         nbytes(w1, grid.coords_T) + 2 * nbytes(h1.vals) + 4 * caps[1] * 4
         + caps[1] + 2 * w1.shape[0] * 4),
    ]
    every_bytes = sum(nbytes(lv.coords_T, lv.hash.keys, lv.hash.vals) + 4
                      + 27 * lv.coords_T.shape[1] * 4 for lv in pyr) + \
        pyr[0].coords_T.shape[1] * 125 * 4
    cases += [
        ("K7 every table of a device plan (stem k5 + k3 of 5 levels)", 1,
         lambda: SC.neighbor_tables(pyr, 5), every_bytes),
        ("device plan (build_unet_plan: K6, K8, K7 and the torch glue)", 1,
         lambda: build_unet_plan(grid, 5, 5, caps), 0),
    ]
    return cases


def pool_cases(batch, gen):
    """The pool's backward as ``_PoolGathered.backward`` runs it:
    (name, calls per training step, call, bytes)"""
    from segdino3d_tpu_torch.models.backbone.wrapper import \
        superpoint_segment_ids
    from segdino3d_tpu_torch.ops import scatter as SS

    import chip_smoke as C

    v0 = batch.plan.levels[0].valid.shape[0]
    s_cap = C.SCENE["n_superpoints"]
    inverse = batch.plan.inverse
    pvalid = batch.point_valid.reshape(-1)
    seg = superpoint_segment_ids(batch.superpoint_ids, s_cap)
    vox = SS.segment_csr(inverse, v0, pvalid)
    sp_off = SS.segment_csr(seg, s_cap, pvalid)[0]
    dmeans = torch.randn(s_cap, 102, generator=gen, device="cuda")
    ctx = SimpleNamespace(
        saved_tensors=(inverse, seg, pvalid, sp_off, vox[0], vox[1]),
        num_segments=s_cap, vox_cols_dtype=(96, torch.float32),
        needs_input_grad=(True,) + (False,) * 7)
    byts = nbytes(dmeans[:, :96], seg, vox[0], vox[1], sp_off) + v0 * 96 * 4
    return [("K5 the pool's backward, (1,536, 96 of 102) -> (V0, 96)", 1,
             lambda: SS._PoolGathered.backward(ctx, dmeans), byts),
            ("yardstick: K5's output stored alone (torch.zeros (V0, 96) "
             "fp32)", 0,
             lambda: torch.zeros(v0, 96, device="cuda"), v0 * 96 * 4)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("hash_bench: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    from segdino3d_tpu_torch.data.collate import (PadSpec, attach_host_plan,
                                                  collate)
    from segdino3d_tpu_torch.ops import cuda_build
    from segdino3d_tpu_torch.tools.table_bench import device_split, host_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_build.build_all(("coord_hash", "voxel_compact", "neighbor_table",
                          "segment_grad", "segment_mean_gather"))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    records = C.make_records()
    spec = PadSpec(C.SCENE["n_points"], C.SCENE["n_superpoints"], 64, 128,
                   200)
    batch = attach_host_plan(collate(records, spec, "cuda"), records, spec,
                             voxel_size=0.02,
                             level_cap_ratios=C.LEVEL_CAP_RATIOS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    runs = plan_cases(batch) + pool_cases(batch, gen)
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
              f" bound {bound}; calls per device-plan forward or training "
              f"step {calls}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
