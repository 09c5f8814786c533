"""Times K2 (``up_conv``) and K3 (``segment_mean_gather``) alone in every
role they play on the gather layout's main path, on one CUDA card.

    python -m segdino3d_tpu_torch.tools.pool_bench [--rounds 3] [--reps 10]

Builds ``chip_smoke.py``'s scene and host plan and takes, in fp32: the
decoder's four up convs (K2 over each fine level's child table) and, in
training, the four down convs' dX (K2 with transposed W); the voxel mean
of the early-fused point features with fp32 and with fp16 2D features,
timed as the kernel alone (its CSR built) and as the backbone wrapper
runs it (from the points and the 2D features to the voxel features at the
stem's pitch, ``narrow.row_pitch``, the CSR apart); the fused devoxelize +
superpoint pool; and each CSR build
(``segment_csr``).  Each case is timed with CUDA events, ``reps``
back-to-back calls a sample, the cases taken in turn ``rounds`` times.
Prints the card's name and power limit, then per case the samples'
minimum and median in ms, the library yardstick's ms once (``chip_smoke``:
a gather and one cuBLAS GEMM for K2, ``scatter_reduce`` for K3), the
bound (operations at the fp32 peak or bytes at the memory rate, the
larger) and the calls per forward and per step; then K2's and K3's
medians summed per forward and per step.

    python -m segdino3d_tpu_torch.tools.pool_bench --scene headline batched \
        stress

times then the voxel mean alone (kernel and as the wrapper runs it) on
``chip_smoke.py`` phase 12's plans: the batch of 8 headline scenes at its
pinned caps, and the 400,000-point stress scene.

It also runs against an older checkout of the port, whose K2 takes the
fine rows' kpos-sorted order instead of the child table and whose K3
takes one concatenated (N, C) input, so that two versions of the kernels
compare within one call: copy it into that checkout's ``tools/`` and run
it there too.
"""
from __future__ import annotations

import argparse
import inspect
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

# (fine level, Cin, Cout) of the up convs and of the down convs (whose dX
# is K2 with transposed W, Cout -> Cin)
UP_CONVS = ((0, 96, 96), (1, 128, 96), (2, 256, 128), (3, 256, 256))
DOWN_CONVS = ((0, 32, 32), (1, 32, 32), (2, 64, 64), (3, 128, 128))


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def cases(batch, gen):
    """(name, calls per forward, calls per step, call, library call or
    None, operations, bytes)"""
    import chip_smoke as C
    from segdino3d_tpu_torch.models.backbone.wrapper import \
        superpoint_segment_ids
    from segdino3d_tpu_torch.ops import narrow as N
    from segdino3d_tpu_torch.ops import scatter as SS
    from segdino3d_tpu_torch.ops import sparse_conv as SC

    plan = batch.plan
    lv = plan.levels
    child_k2 = "child" in inspect.signature(SC.up_conv_rows).parameters
    sources_k3 = hasattr(SS, "segment_mean_columns")
    out = []

    def up(name, fwd, step, fine, coarse_rows, cin, cout):
        x = torch.randn(coarse_rows, cin, generator=gen, device="cuda")
        w = torch.randn(8, cin, cout, generator=gen,
                        device="cuda") * cin ** -0.5
        if child_k2:
            run = lambda: SC.up_conv_rows(x, fine.child, fine.parent,  # noqa: E731
                                          fine.kpos, w, fine.valid)
        else:
            run = lambda: SC.up_conv_rows(x, fine.parent, fine.kpos,  # noqa: E731
                                          fine.up_order, w, fine.valid)
        live = int((fine.valid & (fine.parent >= 0)).sum())
        out.append((name, fwd, step, run,
                    lambda: C.up_library(x, fine.parent, fine.kpos, w),
                    2.0 * live * cin * cout,
                    nbytes(x, fine.parent, fine.kpos, w, fine.valid)
                    + fine.valid.shape[0] * cout * 4))

    v = [t.valid.shape[0] for t in lv]
    for li, cin, cout in UP_CONVS:
        up(f"K2 up {cin}->{cout} L{li + 1}->L{li}", 1, 1, lv[li], v[li + 1],
           cin, cout)
    for li, cin, cout in DOWN_CONVS:
        up(f"K2 down dX {cout}->{cin} L{li + 1}->L{li}", 0, 1, lv[li],
           v[li + 1], cout, cin)

    inverse = plan.inverse
    n = inverse.shape[0]
    pvalid = inverse >= 0
    v0 = v[0]
    seg_vox = torch.where(inverse >= 0, inverse, v0).contiguous()
    vox_csr = SS.segment_csr(seg_vox, v0, pvalid)
    members = int(pvalid.sum())
    pts = torch.randn(n, 6, generator=gen, device="cuda")
    for fdt in (torch.float32, torch.float16):
        f2d = torch.randn(n, 256, generator=gen, device="cuda").to(fdt)
        fname = str(fdt).replace("torch.", "")
        byts = nbytes(seg_vox, pvalid, f2d) + n * 3 * 4 + v0 * 259 * 4
        lib = (lambda f2d=f2d: C.segment_library(
            seg_vox, v0, pvalid, torch.cat([pts[:, 3:], f2d.float()], 1)))
        if sources_k3:
            srcs = [pts[:, 3:], f2d]
            alone = (lambda srcs=srcs: SS.segment_mean_gather(
                seg_vox, v0, pvalid, d=srcs, csr=vox_csr,
                round_to=torch.float32))
            wrapper = (lambda srcs=srcs: SS.segment_mean_columns(
                srcs, seg_vox, v0, torch.float32, pvalid, vox_csr,
                width=N.row_pitch(259, torch.float32)))
        else:
            feats = torch.cat([pts[:, 3:], f2d.float()], 1).contiguous()
            alone = (lambda feats=feats: SS.segment_mean_gather(
                seg_vox, v0, pvalid, d=feats, csr=vox_csr))
            wrapper = (lambda f2d=f2d: SS.segment_mean(
                torch.cat([pts[:, 3:], f2d.float()], -1).to(
                    torch.float32).contiguous(), seg_vox, v0, pvalid,
                csr=vox_csr))
        out.append((f"K3 voxel mean, 2D {fname}, kernel alone", 1, 1, alone,
                    lib, float(members * 259), byts))
        out.append((f"K3 voxel mean, 2D {fname}, as the wrapper runs it", 0,
                    0, wrapper, None, float(members * 259), byts))
    out.append(("CSR build, voxels (segment_csr)", 1, 1,
                lambda: SS.segment_csr(seg_vox, v0, pvalid), None, 0.0,
                nbytes(seg_vox, pvalid)))

    s_cap = C.SCENE["n_superpoints"]
    seg_sp = superpoint_segment_ids(batch.superpoint_ids, s_cap)
    sp_csr = SS.segment_csr(seg_sp, s_cap, pvalid)
    g = torch.randn(v0, 96, generator=gen, device="cuda")
    q = [torch.randn(n, 3, generator=gen, device="cuda") for _ in range(2)]
    if sources_k3:
        pool = lambda: SS.segment_mean_gather(  # noqa: E731
            seg_sp, s_cap, pvalid, g=g, gather_idx=inverse, d=q, csr=sp_csr)
    else:
        pool = lambda: SS.segment_mean_gather(  # noqa: E731
            seg_sp, s_cap, pvalid, g=g, gather_idx=inverse,
            d=torch.cat(q, 1), csr=sp_csr)

    def pool_library():
        gp = torch.cat([g, g.new_zeros(1, 96)])
        rows = torch.cat([gp[torch.where(inverse < 0, v0, inverse).long()],
                          *q], 1)
        return C.segment_library(seg_sp, s_cap, pvalid, rows)

    out.append(("K3 superpoint pool (V0,96)+2x(N,3)->1536", 1, 1, pool,
                pool_library, float(members * 102),
                nbytes(seg_sp, pvalid, g, inverse, *q) + s_cap * 102 * 4))
    out.append(("CSR build, superpoints (segment_csr)", 1, 1,
                lambda: SS.segment_csr(seg_sp, s_cap, pvalid), None, 0.0,
                nbytes(seg_sp, pvalid)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--scene", choices=("headline", "batched", "stress"),
                    nargs="+", default=["headline"],
                    help="batched / stress: the voxel mean alone on "
                    "chip_smoke.py phase 12's plans")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("pool_bench: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    from segdino3d_tpu_torch.data.collate import (PadSpec, attach_host_plan,
                                                  collate)
    from segdino3d_tpu_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_build.build_all(("up_conv", "segment_mean_gather", "gather_wgrad"))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    for scene in args.scene:
        if scene == "headline":
            records = C.make_records()
            spec = PadSpec(C.SCENE["n_points"], C.SCENE["n_superpoints"], 64,
                           128, 200)
            batch = attach_host_plan(collate(records, spec, "cuda"), records,
                                     spec, voxel_size=0.02,
                                     level_cap_ratios=C.LEVEL_CAP_RATIOS)
            time_runs(cases(batch, gen), args)
        else:
            batch = scale_batch(scene)
            time_runs([r for r in cases(batch, gen)
                       if r[0].startswith("K3 voxel mean")], args, scene)
        del batch
        torch.cuda.empty_cache()
    return 0


def scale_batch(scene):
    """``chip_smoke.py`` phase 12's batch: "batched", 8 headline scenes on
    their hybrid host plan at the pinned caps, or "stress", the
    400,000-point scene at its caps, under its ``SEGDINO_CONV_CHUNK_MB``."""
    import chip_smoke as C
    from segdino3d_tpu_torch.data.collate import (PadSpec, attach_host_plan,
                                                  collate)
    from segdino3d_tpu_torch.data.synthetic import synthetic_scene

    os.environ["SEGDINO_CONV_CHUNK_MB"] = C.SCALE_CHUNK_MB
    if scene == "stress":
        records = [synthetic_scene(0, **C.STRESS_SCENE)]
        spec = PadSpec(*C.STRESS_PAD)
    else:
        records = [synthetic_scene(s, **C.SCENE)
                   for s in range(C.BATCH_SCENES)]
        spec = PadSpec(C.SCENE["n_points"], C.SCENE["n_superpoints"], 64,
                       128, 200)
    for r in records:
        r["points_2dfeats"] = r["points_2dfeats"].astype(np.float16)
    args = C.plan_layout("hybrid")
    level_caps, block_caps = C.probe_caps(
        records, spec, args["block_edges"], len(records),
        pin_blocks=scene == "batched")
    batch = attach_host_plan(collate(records, spec, "cuda"), records, spec,
                             level_caps=level_caps, block_caps=block_caps,
                             **args)
    print(f"{scene}: {batch.points.shape[0]} x {batch.points.shape[1]} "
          f"points, V0 cap {batch.plan.levels[0].valid.shape[0]}",
          flush=True)
    return batch


def time_runs(runs, args, prefix=""):
    """Time ``runs`` (``cases``' tuples) in turn ``args.rounds`` times and
    print each one's line and the sums."""
    import chip_smoke as C

    prefix = f"{prefix} " if prefix else ""
    samples = {i: [] for i in range(len(runs))}
    for _ in range(args.rounds):
        for i, run in enumerate(runs):
            samples[i].append(C.time_ms(run[3], args.reps))
    sums = {"K2": [0.0, 0.0], "K3": [0.0, 0.0], "CSR": [0.0, 0.0]}
    for i, (name, fwd, step, _, lib, ops, byts) in enumerate(runs):
        t = np.array(samples[i])
        med = float(np.median(t))
        lib_text = f"{C.time_ms(lib, args.reps):.4f} ms" if lib else "none"
        b_ms, b_by = C.bound(ops, byts, "fp32")
        key = name.split()[0]
        sums[key][0] += fwd * med
        sums[key][1] += step * med
        print(f"{prefix}{name}: min {t.min():.4f} ms, median {med:.4f} ms over "
              f"{args.rounds} x {args.reps} calls; library {lib_text}; "
              f"bound {b_ms:.4f} ms ({b_by}); calls per forward {fwd}, per "
              f"step {step}", flush=True)
    print(f"{prefix}summed over their calls (medians), per gather forward "
          "/ step: " + ", ".join(f"{k} {f:.4f} / {s:.4f} ms"
                                 for k, (f, s) in sums.items()), flush=True)


if __name__ == "__main__":
    sys.exit(main())
