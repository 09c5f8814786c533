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

    python -m segdino3d_tpu_torch.tools.wgrad_bench --narrow

times instead the Baseline's stem dW (k5, 3 -> 32) in the forms its
training steps run: K4 unmirrored, ``gather_wgrad(x, stem_nbr, dy,
None)`` with dY masked by the level's validity (device plans), and K11 on
the hybrid plan's level-0 blocks over their occupied-row list (block-dense
plans), fp32 and bf16, the wide path and the narrow path forced in turn
(``narrow=``), each held to its plain version (fp32 1e-4, bf16 1e-2 x
max|plain|), with the samples' minimum and median, the bound of the live
pairs (K4: the table's, K11: those with an occupied source) and the
library call (K4: a gather and one batched cuBLAS GEMM; K11:
``conv3d_weight`` of the halo-padded blocks).  In a checkout whose
wrappers take no ``narrow`` the default path alone is timed, so the file
runs in an older checkout too (copy it into that checkout's ``tools/``).
Then a crossing sweep: K4 and K11, wide against narrow, at Cin 1, 2, 3, 4
and 8 into 32 channels, k 3 and 5, fp32 and bf16, medians of ``rounds``
samples; the crossing, where the narrow path stops winning, is the dW
rule's (``ops/narrow.py:narrow_wgrad_path``).

    python -m segdino3d_tpu_torch.tools.wgrad_bench --live

times the flagship's stem dW (k5, 259 -> 32; bf16 at the aligned pitch
264) in the forms its training steps run: K11 on the hybrid plan's level-0
blocks for an input zero outside the occupancy (block-dense plans), on
the live-pair path (the level's live-pair list built before the timing,
as a step builds it once) and on the row-tile path forced (``live=``),
and K4 mirrored with dY gathered on the stem table (gather host plans)
beside them; each path held to its plain version, with the samples'
minimum and median, the library call, the bound of the live pairs, a
digest of the output (fp32 digests of one path match across checkouts)
and the live-pair list's build.  In a checkout whose wrappers take no
``zero_outside`` the default path alone is timed, so the file runs in an
older checkout too (copy it into that checkout's ``tools/``).
"""
from __future__ import annotations

import argparse
import inspect
import itertools
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

NARROW_CINS = (1, 2, 3, 4, 8)
DEVICE = "cuda"


def takes_narrow(fn) -> bool:
    """Whether a wrapper of this checkout takes ``narrow=``."""
    return "narrow" in inspect.signature(fn).parameters


def takes_live(fn) -> bool:
    """Whether a wrapper of this checkout takes ``zero_outside=``."""
    return "zero_outside" in inspect.signature(fn).parameters


def live_pair_count(t, occ, k=5) -> int:
    """The (occupied row, offset) pairs whose source cell is occupied."""
    from segdino3d_tpu_torch.ops import block_dense as BD

    h, need = (k - 1) // 2, 0
    r = torch.nonzero(occ).flatten()
    for s in itertools.product(range(-h, h + 1), repeat=3):
        src = BD.halo_rows_plain(r, t.block_nbr, t.edge, s)
        need += int(((src >= 0) & occ[src.clamp(min=0).long()]).sum())
    return need


def digest(t):
    import hashlib

    return hashlib.sha1(t.detach().float().cpu().numpy().tobytes()
                        ).hexdigest()[:12]


def live_cases(plan, hybrid, gen):
    """[(name, dtype, {path: call}, plain call, library call, ops, bytes)]
    of the flagship's stem dW: K11 on level 0's blocks (the live-pair and
    the row-tile path, where this checkout has both), K4 on the stem
    table."""
    import chip_smoke as C
    from segdino3d_tpu_torch.ops import block_dense as BD
    from segdino3d_tpu_torch.ops import sparse_conv as SC

    lv = plan.levels[0]
    nbr, v0 = plan.stem_nbr, lv.valid.shape[0]
    t = hybrid.blocks[0]
    occ = BD.occupancy(t)
    rows = BD.row_list(t, occ)
    e, b = t.edge, t.num_blocks
    live = int((nbr >= 0).sum())
    need = live_pair_count(t, occ)
    out = []
    for dt in (torch.float32, torch.bfloat16):
        xd = C.pitched(torch.where(occ[:, None], torch.randn(
            occ.shape[0], 259, generator=gen, device=DEVICE), 0.0).to(dt), 1)
        dyd = torch.where(occ[:, None], torch.randn(
            occ.shape[0], 32, generator=gen, device=DEVICE), 0.0).to(dt)
        ci = xd.shape[1]
        paths = {"default": lambda x=xd, dy=dyd: BD.block_wgrad(
            x, dy, t.block_nbr, occ, e, 5, rows)}
        if takes_live(BD.block_wgrad):
            lp = BD.live_pairs(t, occ, 5)
            paths = {"live-pair": lambda x=xd, dy=dyd, lp=lp: BD.block_wgrad(
                         x, dy, t.block_nbr, occ, e, 5, rows,
                         zero_outside=True, live_list=lp),
                     "row-tile (forced)": lambda x=xd, dy=dyd: BD.block_wgrad(
                         x, dy, t.block_nbr, occ, e, 5, rows, live=False),
                     "live-pair list build": lambda: BD.live_pair_list(
                         rows, occ, t.block_nbr, e, 5, BD.live_capacity(t))}

        def lib(x=xd, dy=dyd, ci=ci):
            p = C.to_ncdhw(BD.halo_pad_plain(x.reshape(b, e, e, e, ci),
                                             t.block_nbr, 2))
            return torch.nn.grad.conv3d_weight(
                p, (32, ci, 5, 5, 5), C.to_ncdhw(dy.reshape(b, e, e, e, 32)))

        out.append((
            f"K11 stem dW k5 259->32 L0 (x at {ci}), {int(occ.sum())} "
            f"occupied rows, {need} pairs with an occupied source", dt,
            paths, lambda x=xd, dy=dyd: BD.block_wgrad_plain(
                x, dy, t.block_nbr, occ, e, 5),
            lib, 2.0 * need * 259 * 32,
            C.nbytes(xd, dyd, t.block_nbr, occ) + 125 * ci * 32 * 4))
        x = C.pitched(torch.where(lv.valid[:, None], torch.randn(
            v0, 259, generator=gen, device=DEVICE), 0.0).to(dt), 1)
        dy = torch.where(lv.valid[:, None], torch.randn(
            v0, 32, generator=gen, device=DEVICE), 0.0).to(dt)
        out.append((
            f"K4 stem dW k5 259->32 L0 (x at {x.shape[1]}; dY gathered, "
            f"mirrored, as the gather step runs it; {live} live pairs)", dt,
            {"default": lambda x=x, dy=dy: SC.gather_wgrad(
                x, None, dy, nbr, mirror=True)},
            lambda x=x, dy=dy: SC.gather_wgrad_plain(x, None, dy, nbr, 125,
                                                     v0, True),
            lambda x=x, dy=dy: C.wgrad_library(x, None, dy, nbr, True),
            2.0 * live * 259 * 32, C.nbytes(x, nbr, dy) + 125 * 259 * 32 * 4))
    return out


def stem_cases(plan, hybrid, gen):
    """[(name, dtype, {path: call}, plain call, library call, ops, bytes)]
    of the Baseline's stem dW: K4 unmirrored on the stem table, K11 on
    level 0's blocks."""
    import chip_smoke as C
    from segdino3d_tpu_torch.ops import block_dense as BD
    from segdino3d_tpu_torch.ops import sparse_conv as SC

    lv = plan.levels[0]
    nbr, v0 = plan.stem_nbr, lv.valid.shape[0]
    t = hybrid.blocks[0]
    occ = BD.occupancy(t)
    rows = BD.row_list(t, occ)
    e, b = t.edge, t.num_blocks
    live = int((nbr >= 0).sum())
    need = 0
    r = torch.nonzero(occ).flatten()
    for s in itertools.product(range(-2, 3), repeat=3):
        src = BD.halo_rows_plain(r, t.block_nbr, e, s)
        need += int(((src >= 0) & occ[src.clamp(min=0).long()]).sum())
    out = []
    for dt in (torch.float32, torch.bfloat16):
        x = torch.randn(v0, 3, generator=gen, device=DEVICE).to(dt)
        dy = torch.where(lv.valid[:, None], torch.randn(
            v0, 32, generator=gen, device=DEVICE), 0.0).to(dt)
        paths = {"default": lambda x=x, dy=dy: SC.gather_wgrad(x, nbr, dy,
                                                               None)}
        if takes_narrow(SC.gather_wgrad):
            paths = {p: (lambda x=x, dy=dy, f=f: SC.gather_wgrad(
                x, nbr, dy, None, narrow=f))
                for p, f in (("wide", False), ("narrow", True))}
        out.append((
            "K4 stem dW k5 3->32 L0 (x gathered, unmirrored, as the step "
            f"runs it; {live} live pairs)", dt, paths,
            lambda x=x, dy=dy: SC.gather_wgrad_plain(x, nbr, dy, None, 125,
                                                     v0),
            lambda x=x, dy=dy: C.wgrad_library(x, nbr, dy, None, False),
            2.0 * live * 3 * 32, C.nbytes(x, nbr, dy) + 125 * 3 * 32 * 4))
        xd = torch.where(occ[:, None], torch.randn(
            occ.shape[0], 3, generator=gen, device=DEVICE), 0.0).to(dt)
        dyd = torch.where(occ[:, None], torch.randn(
            occ.shape[0], 32, generator=gen, device=DEVICE), 0.0).to(dt)
        paths = {"default": lambda x=xd, dy=dyd: BD.block_wgrad(
            x, dy, t.block_nbr, occ, e, 5, rows)}
        if takes_narrow(BD.block_wgrad):
            paths = {p: (lambda x=xd, dy=dyd, f=f: BD.block_wgrad(
                x, dy, t.block_nbr, occ, e, 5, rows, narrow=f))
                for p, f in (("wide", False), ("narrow", True))}

        def lib(x=xd, dy=dyd):
            p = C.to_ncdhw(BD.halo_pad_plain(x.reshape(b, e, e, e, 3),
                                             t.block_nbr, 2))
            return torch.nn.grad.conv3d_weight(
                p, (32, 3, 5, 5, 5), C.to_ncdhw(dy.reshape(b, e, e, e, 32)))

        out.append((
            f"K11 stem dW k5 3->32 L0, {int(occ.sum())} occupied rows, "
            f"{need} pairs with an occupied source", dt, paths,
            lambda x=xd, dy=dyd: BD.block_wgrad_plain(x, dy, t.block_nbr,
                                                      occ, e, 5),
            lib, 2.0 * need * 3 * 32,
            C.nbytes(xd, dyd, t.block_nbr, occ) + 125 * 3 * 32 * 4))
    return out


def held(got, want, dt):
    """(max |got - want|, whether it is within the tolerance: fp32 1e-4,
    bf16 1e-2 x max |want|)."""
    import chip_smoke as C

    tol = C.WGRAD_TOL if dt == torch.float32 else 1e-2
    err = float((got - want).abs().max())
    return err, err <= tol * float(want.abs().max())


def run_stem(cases, rounds, reps, held=held):
    """Stem cases: every path held to the plain version (``held``; a path
    named as a list build is only timed), then the paths timed in turn;
    each output's digest printed."""
    import chip_smoke as C

    for name, dt, paths, plain, lib, ops, byts in cases:
        dts = str(dt).replace("torch.", "")
        want = plain()
        digests = {}
        for path, fn in paths.items():
            if "list build" in path:
                continue
            got = fn()
            digests[path] = digest(got)
            err, ok = held(got, want, dt)
            if not ok:
                raise SystemExit(f"{name} {dts} {path}: max_abs_err "
                                 f"{err:.3e} against the plain version")
        del want
        samples = {p: [] for p in paths}
        for _ in range(rounds):
            for path, fn in paths.items():
                samples[path].append(C.time_ms(fn, reps))
        b_ms, b_by = C.bound(ops, byts, C.CONV_PEAK[dt])
        lib_ms = C.time_ms(lib, reps)
        for path, t in samples.items():
            t = np.array(t)
            print(f"stem {name} {dts} {path} path: min {t.min():.4f} ms, "
                  f"median {np.median(t):.4f} ms over {rounds} x {reps} "
                  f"calls; library {lib_ms:.4f} ms; bound {b_ms:.4f} ms "
                  f"({b_by})"
                  + (f"; output digest {digests[path]}" if path in digests
                     else ""), flush=True)


def crossing(plan, hybrid, gen, rounds, reps):
    """K4 and K11, wide against narrow path, at ``NARROW_CINS``, each path
    held to the plain version first."""
    import chip_smoke as C
    from segdino3d_tpu_torch.ops import block_dense as BD
    from segdino3d_tpu_torch.ops import narrow as N
    from segdino3d_tpu_torch.ops import sparse_conv as SC

    lv = plan.levels[0]
    v0 = lv.valid.shape[0]
    t = hybrid.blocks[0]
    occ = BD.occupancy(t)
    rows = BD.row_list(t, occ)
    for cin in NARROW_CINS:
        for dt in (torch.float32, torch.bfloat16):
            for k in (5, 3):
                nbr = plan.stem_nbr if k == 5 else lv.nbr
                x = torch.randn(v0, cin, generator=gen, device=DEVICE).to(dt)
                dy = torch.where(lv.valid[:, None], torch.randn(
                    v0, 32, generator=gen, device=DEVICE), 0.0).to(dt)
                xd = torch.randn(occ.shape[0], cin, generator=gen,
                                 device=DEVICE).to(dt)
                dyd = torch.where(occ[:, None], torch.randn(
                    occ.shape[0], 32, generator=gen, device=DEVICE),
                    0.0).to(dt)
                for name, call, plain in (
                        (f"K4 k{k} {cin}->32 L0",
                         lambda f, x=x, dy=dy, nbr=nbr: SC.gather_wgrad(
                             x, nbr, dy, None, narrow=f),
                         lambda x=x, dy=dy, nbr=nbr, k=k:
                         SC.gather_wgrad_plain(x, nbr, dy, None, k ** 3,
                                               v0)),
                        (f"K11 k{k} {cin}->32 L0 over the occupied rows",
                         lambda f, x=xd, dy=dyd, k=k: BD.block_wgrad(
                             x, dy, t.block_nbr, occ, t.edge, k, rows,
                             narrow=f),
                         lambda x=xd, dy=dyd, k=k: BD.block_wgrad_plain(
                             x, dy, t.block_nbr, occ, t.edge, k))):
                    want = plain()
                    for f in (False, True):
                        err, ok = held(call(f), want, dt)
                        if not ok:
                            raise SystemExit(f"{name} {dt} narrow={f}: "
                                             f"max_abs_err {err:.3e}")
                    del want
                    samples = {False: [], True: []}
                    for _ in range(rounds):
                        for f in (False, True):
                            samples[f].append(C.time_ms(
                                lambda f=f: call(f), reps))
                    wide, narrow = (float(np.median(samples[f]))
                                    for f in (False, True))
                    rule = N.narrow_wgrad_path(k ** 3, cin, 32, dt)
                    print(f"crossing {name} {str(dt).replace('torch.', '')}"
                          f": wide {wide:.4f} ms, narrow {narrow:.4f} ms "
                          f"({wide / narrow:.2f}x); the rule picks "
                          f"{'narrow' if rule else 'wide'}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--narrow", action="store_true",
                    help="the Baseline stem's dW, wide against narrow "
                    "path, and the crossing by Cin")
    ap.add_argument("--live", action="store_true",
                    help="the flagship stem's dW, the live-pair path "
                    "against the row-tile path, K4 beside them")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("wgrad_bench: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    from segdino3d_tpu_torch.data.collate import (PadSpec, attach_host_plan,
                                                  collate)
    from segdino3d_tpu_torch.ops import cuda_build
    from segdino3d_tpu_torch.ops import sparse_conv as SC

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    if args.live:
        run_stem(live_cases(batch.plan, hybrid.plan, gen), args.rounds,
                 args.reps)
        return 0
    if args.narrow:
        run_stem(stem_cases(batch.plan, hybrid.plan, gen), args.rounds,
                 args.reps)
        if takes_narrow(SC.gather_wgrad):
            crossing(batch.plan, hybrid.plan, gen, args.rounds, args.reps)
        return 0
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
