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
plain version (``sparse_conv.gather_conv_plain``) and the library
yardstick (``chip_smoke.conv_library``: a gather and one cuBLAS GEMM, TF32
off).  Prints the card's name and power limit, then per case its calls
per forward and per step, the samples' minimum and median in ms, the
plain version's and the library's ms and the bound of its live pairs (2 x pairs x Cin x Cout
operations at the fp32 peak, or its bytes at the memory rate, the
larger); then the calls' medians summed per forward and per step.  K1's pair lists (K4's, ``cached_pairs``) are built before the
timing, as a forward builds them once per table.  Run it in two checkouts
within one call to compare two versions of the kernels.

    python -m segdino3d_tpu_torch.tools.conv_bench --narrow

times instead K1's and K10's two paths against each other at Cin 1, 3, 4,
8 and 16 into 32 channels (the Baseline's stem is 3 -> 32), fp32 and
bf16: K1 on the scene's k5 stem table and level 0's k3 table, K10 on the
hybrid plan's level-0 blocks under the occupancy (k5 and k3), the wide
path and the narrow path (``gather_conv(..., narrow=)``, ``block_conv(...,
narrow=)``) forced, in turn, medians of ``rounds`` samples.  Each case is
held to its plain version (fp32 1e-4, bf16 1e-2) and, in fp32, the two
paths to each other bit for bit.  The crossing, where the narrow path
stops winning, sets ``ops/narrow.py:NARROW_MAX_CIN``; a shape the narrow
kernel does not take (``narrow.narrow_fits``) shows "not taken".

    python -m segdino3d_tpu_torch.tools.conv_bench --dtype bf16

times the bf16 backbone's K1, K10, K4 and K11 cases, each in bf16 and
fp32 on the same seeded inputs: K1 at the wide stems (the flagship's k5
259 -> 32 on the stem table, the v2 model's 262 -> 32 on level 0's k3
table), the bf16 rows at the aligned pitch (264, zero past Cin) and at
the bare width; K10 at every distinct (level,
Cin, Cout) of the hybrid forward, the dense k5 stem and the dX role on the
hybrid plan's blocks; K4 and K11 at the stem's dW.  Per case: the median
of ``rounds`` interleaved samples, the library call (K1: a gather and one
cuBLAS GEMM; K10: ``conv3d`` of the halo-padded blocks alone), the bound
and a digest of the output, so that two checkouts timed in one call show
which outputs are bit-equal (every fp32 one should be).  Only the tools'
older helpers of ``chip_smoke.py`` are used, so the file runs in an older
checkout too (copy it into that checkout's ``tools/``).

    python -m segdino3d_tpu_torch.tools.conv_bench --live

times the flagship's stem forward (k5, 259 -> 32; bf16 at the aligned
pitch 264) in the forms its steps run: K10 on the hybrid plan's level-0
blocks for an input zero outside the occupancy (block-dense training
plans), on the live-pair path (the level's live-pair list built before
the timing) and on the row-tile path forced (``block_conv(..., live=)``),
with K1 on the stem table (gather plans) beside them; each path held to
its plain version (fp32 1e-4, bf16 1e-2), with the samples' minimum and
median, the library call (K10: the halo assembly and cuDNN ``conv3d``;
K1: a gather and one cuBLAS GEMM), the bound of the live pairs, a digest
of the output and the live-pair list's build.  In a checkout whose
wrapper takes no ``zero_outside`` the default path alone is timed (copy
this file and ``wgrad_bench.py``, whose runner it uses, into that
checkout's ``tools/``).
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
    call, live pairs, Cin, Cout, bytes, plain call)"""
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
                    byts + nbr.shape[1] * cout * 4,
                    lambda: SC.gather_conv_plain(x, nbr, w, valid)))

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


NARROW_CINS = (1, 3, 4, 8, 16)


def narrow_sweep(plan, hybrid, gen, rounds, reps):
    """K1 and K10, wide path against narrow path, at ``NARROW_CINS``."""
    import chip_smoke as C
    from segdino3d_tpu_torch.ops import block_dense as BD
    from segdino3d_tpu_torch.ops import narrow as N
    from segdino3d_tpu_torch.ops import sparse_conv as SC

    lv, t = plan.levels, hybrid.blocks[0]
    occ = BD.occupancy(t)
    rows = BD.row_list(t, occ)
    cases = []
    for cin in NARROW_CINS:
        for dt in (torch.float32, torch.bfloat16):
            for k, nbr in ((5, plan.stem_nbr), (3, lv[0].nbr)):
                x = torch.randn(lv[0].valid.shape[0], cin, generator=gen,
                                device="cuda").to(dt)
                w = (torch.randn(k ** 3, cin, 32, generator=gen,
                                 device="cuda") * (k ** 3 * cin) ** -0.5
                     ).to(dt)
                cases.append((
                    f"K1 k{k} {cin}->32 L0", dt, k ** 3, cin,
                    lambda x=x, w=w, nbr=nbr, f=None: SC.gather_conv(
                        x, nbr, w, lv[0].valid, narrow=f),
                    lambda x=x, w=w, nbr=nbr: SC.gather_conv_plain(
                        x, nbr, w, lv[0].valid)))
            for k in (5, 3):
                x = torch.where(occ[:, None], torch.randn(
                    occ.shape[0], cin, generator=gen, device="cuda"),
                    0.0).to(dt)
                w = (torch.randn(k ** 3, cin, 32, generator=gen,
                                 device="cuda") * (k ** 3 * cin) ** -0.5
                     ).to(dt)
                cases.append((
                    f"K10 k{k} {cin}->32 L0 under the occupancy", dt,
                    k ** 3, cin,
                    lambda x=x, w=w, f=None: BD.block_conv(
                        x, t.block_nbr, w, occ, t.edge, rows, narrow=f),
                    lambda x=x, w=w: BD.dense_subm_conv_plain(
                        x, t.block_nbr, w, occ, t.edge)))
    for name, dt, n_off, cin, call, plain in cases:
        dts = str(dt).replace("torch.", "")
        fits = N.narrow_fits(n_off, cin, 32, dt)
        wide = call(f=False)
        want = plain()
        tol = C.TOL[dt]
        paths = {"wide": wide}
        if fits:
            paths["narrow"] = call(f=True)
        for path, got in paths.items():
            if not torch.allclose(got.float(), want.float(), rtol=tol,
                                  atol=tol):
                raise SystemExit(f"{name} {dts} {path} path disagrees with "
                                 "the plain version")
        same = ""
        if fits and dt == torch.float32:
            if not torch.equal(paths["narrow"], wide):
                raise SystemExit(f"{name} fp32: the narrow path is not "
                                 "bit-equal to the wide path")
            same = "; fp32 paths bit-equal"
        del wide, want, paths
        samples = {"wide": [], "narrow": []}
        for _ in range(rounds):
            for path in (("wide", "narrow") if fits else ("wide",)):
                samples[path].append(C.time_ms(
                    lambda path=path: call(f=path == "narrow"), reps))
        med = {p: float(np.median(v)) for p, v in samples.items() if v}
        narrow_text = (f"narrow {med['narrow']:.4f} ms "
                       f"({med['wide'] / med['narrow']:.2f}x)"
                       if fits else "narrow: not taken (Cin above "
                       f"{N.KERNEL_MAX_CIN} or {N.smem_bytes(n_off, cin, 32, dt)}"
                       " bytes of shared memory)")
        print(f"narrow sweep {name} {dts}: wide {med['wide']:.4f} ms, "
              f"{narrow_text}; the rule picks "
              f"{'narrow' if N.narrow_path(n_off, cin, 32, dt) else 'wide'}"
              f"{same}", flush=True)


def padded(x, dim, pitch):
    """``x`` widened along ``dim`` to ``pitch`` with zero columns."""
    if x.shape[dim] == pitch:
        return x
    shape = list(x.shape)
    shape[dim] = pitch - x.shape[dim]
    return torch.cat([x, x.new_zeros(shape)], dim).contiguous()


def digest(t):
    import hashlib

    return hashlib.sha1(t.detach().float().cpu().numpy().tobytes()
                        ).hexdigest()[:12]


def live_cases(plan, hybrid, gen):
    """[(name, dtype, {path: call}, plain call, library call, ops, bytes)]
    of the flagship's stem forward: K10 on level 0's blocks (the live-pair
    and the row-tile path, where this checkout has both), K1 on the stem
    table."""
    import chip_smoke as C
    from segdino3d_tpu_torch.ops import block_dense as BD
    from segdino3d_tpu_torch.ops import sparse_conv as SC
    from segdino3d_tpu_torch.tools import wgrad_bench as WB

    lv = plan.levels[0]
    nbr, valid, v0 = plan.stem_nbr, lv.valid, lv.valid.shape[0]
    t = hybrid.blocks[0]
    occ = BD.occupancy(t)
    rows = BD.row_list(t, occ)
    e, b = t.edge, t.num_blocks
    live = int((nbr >= 0).sum())
    need = WB.live_pair_count(t, occ)
    out = []
    for dt in (torch.float32, torch.bfloat16):
        x = C.pitched(torch.where(occ[:, None], torch.randn(
            occ.shape[0], 259, generator=gen, device="cuda"), 0.0).to(dt), 1)
        w = C.pitched((torch.randn(125, 259, 32, generator=gen,
                                   device="cuda") * (125 * 259) ** -0.5
                       ).to(dt), 1)
        ci = x.shape[1]
        paths = {"default": lambda x=x, w=w: BD.block_conv(
            x, t.block_nbr, w, occ, e, rows)}
        if WB.takes_live(BD.block_conv):
            lp = BD.live_pairs(t, occ, 5)
            paths = {"live-pair": lambda x=x, w=w, lp=lp: BD.block_conv(
                         x, t.block_nbr, w, occ, e, rows, zero_outside=True,
                         live_list=lp),
                     "row-tile (forced)": lambda x=x, w=w: BD.block_conv(
                         x, t.block_nbr, w, occ, e, rows, live=False),
                     "live-pair list build": lambda: BD.live_pair_list(
                         rows, occ, t.block_nbr, e, 5, BD.live_capacity(t))}
        wc = w.reshape(5, 5, 5, ci, 32).permute(4, 3, 0, 1, 2).contiguous()

        def lib(x=x, wc=wc, ci=ci):
            p = C.to_ncdhw(BD.halo_pad_plain(x.reshape(b, e, e, e, ci),
                                             t.block_nbr, 2))
            return torch.nn.functional.conv3d(p, wc)

        out.append((
            f"K10 dense stem k5 259->32 L0 (x at {ci}), {int(occ.sum())} "
            f"occupied rows, {need} live pairs", dt, paths,
            lambda x=x, w=w: BD.dense_subm_conv_plain(x, t.block_nbr, w, occ,
                                                      e),
            lib, 2.0 * need * 259 * 32,
            C.nbytes(x, w) + 4 * int(occ.sum())
            + occ.shape[0] * 32 * x.element_size()))
        xv = C.pitched(torch.where(valid[:, None], torch.randn(
            v0, 259, generator=gen, device="cuda"), 0.0).to(dt), 1)
        out.append((
            f"K1 stem k5 259->32 L0 (x at {xv.shape[1]}, the gather "
            f"layout's; {live} live pairs)", dt,
            {"default": lambda x=xv, w=w: SC.gather_conv(x, nbr, w, valid)},
            lambda x=xv, w=w: SC.gather_conv_plain(x, nbr, w, valid),
            lambda x=xv, w=w: C.conv_library(x, nbr, w),
            2.0 * live * 259 * 32,
            C.nbytes(xv, nbr, w, valid) + v0 * 32 * xv.element_size()))
    return out


def conv_held(got, want, dt):
    """(max |got - want|, whether it is within rtol = atol = 1e-4 in fp32,
    1e-2 in bf16)."""
    tol = 1e-4 if dt == torch.float32 else 1e-2
    err = float((got.float() - want.float()).abs().max())
    return err, bool(torch.allclose(got.float(), want.float(), rtol=tol,
                                    atol=tol))


def bf16_cases(plan, hybrid, gen):
    """(name, dtype, kernel call, plain call or None, library call or None,
    operations, bytes)"""
    import torch.nn.functional as F

    import chip_smoke as C
    from segdino3d_tpu_torch.ops import block_dense as BD
    from segdino3d_tpu_torch.ops import sparse_conv as SC

    lv = plan.levels
    v0, valid = lv[0].valid.shape[0], lv[0].valid
    out = []

    def nb(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    for label, nbr, cin in (("stem k5 259->32 L0", plan.stem_nbr, 259),
                            ("v2-width stem k3 262->32 on L0's k3 table",
                             lv[0].nbr, 262)):
        hits = int((nbr[:, valid] >= 0).sum())
        x32 = torch.randn(v0, cin, generator=gen, device="cuda")
        w32 = torch.randn(nbr.shape[0], cin, 32, generator=gen,
                          device="cuda") * (nbr.shape[0] * cin) ** -0.5
        for dt, pitch in ((torch.float32, cin), (torch.bfloat16, 264),
                          (torch.bfloat16, cin)):
            x, w = padded(x32.to(dt), 1, pitch), padded(w32.to(dt), 1, pitch)
            out.append((f"K1 {label} at width {pitch}", dt,
                        lambda x=x, w=w, nbr=nbr: SC.gather_conv(
                            x, nbr, w, valid),
                        lambda x=x, w=w, nbr=nbr: SC.gather_conv_plain(
                            x, nbr, w, valid),
                        lambda x=x, w=w, nbr=nbr: C.conv_library(x, nbr, w),
                        2.0 * hits * cin * 32,
                        nb(x, nbr, w, valid) + v0 * 32 * x.element_size()))

    def k10(name, t, cin, cout, k, dx=False, pitch=None):
        occ = BD.occupancy(t)
        mask, rows = BD.dilated_rows(occ, t.block_nbr, t.edge, k) if dx \
            else (occ, BD.row_list(t, occ))
        e, b, h = t.edge, t.num_blocks, (k - 1) // 2
        x32 = torch.where(occ[:, None], torch.randn(
            occ.shape[0], cin, generator=gen, device="cuda"), 0.0)
        w32 = torch.randn(k ** 3, cin, cout, generator=gen,
                          device="cuda") * (k ** 3 * cin) ** -0.5
        ones = torch.ones(k ** 3, 1, 1, device="cuda")
        hits = BD.dense_subm_conv_plain(occ.float()[:, None], t.block_nbr,
                                        ones, None, e)[:, 0]
        need = float(hits.sum() if dx else hits[occ].sum())
        for dt in (torch.float32, torch.bfloat16):
            pw = pitch if (pitch and dt == torch.bfloat16) else cin
            x, w = padded(x32.to(dt), 1, pw), padded(w32.to(dt), 1, pw)
            wc = w.reshape(k, k, k, pw, cout).permute(4, 3, 0, 1, 2
                                                      ).contiguous()
            p5 = BD.halo_pad_plain(x.reshape(b, e, e, e, pw), t.block_nbr, h)
            pad = p5.permute(0, 4, 1, 2, 3).contiguous()
            del p5
            out.append((f"K10 {name}" + (f" at width {pw}" if pitch else ""),
                        dt, lambda x=x, w=w: BD.block_conv(
                            x, t.block_nbr, w, mask, e, rows),
                        lambda x=x, w=w: BD.dense_subm_conv_plain(
                            x, t.block_nbr, w, None if dx else occ, e),
                        lambda p=pad, wc=wc: F.conv3d(p, wc),
                        2.0 * need * cin * cout,
                        nb(x, t.block_nbr, w, mask)
                        + occ.shape[0] * cout * x.element_size()))

    for li, cin, cout, _ in K3_CONVS:
        k10(f"k3 {cin}->{cout} L{li}", hybrid.blocks[li], cin, cout, 3)
    k10("dense stem k5 259->32 L0", hybrid.blocks[0], 259, 32, 5, pitch=264)
    k10("dX k3 96->96 L0 under the dilation", hybrid.blocks[0], 96, 96, 3,
        dx=True)

    t = hybrid.blocks[0]
    occ = BD.occupancy(t)
    x32 = torch.randn(v0, 259, generator=gen, device="cuda")
    dy32 = torch.randn(v0, 32, generator=gen, device="cuda")
    xd32 = torch.where(occ[:, None], torch.randn(
        occ.shape[0], 259, generator=gen, device="cuda"), 0.0)
    dyd32 = torch.where(occ[:, None], torch.randn(
        occ.shape[0], 32, generator=gen, device="cuda"), 0.0)
    for dt in (torch.float32, torch.bfloat16):
        pw = 264 if dt == torch.bfloat16 else 259
        x, dy = padded(x32.to(dt), 1, pw), dy32.to(dt)
        live = int((plan.stem_nbr >= 0).sum())
        out.append((f"K4 stem dW k5 259->32 L0 at width {pw}", dt,
                    lambda x=x, dy=dy: SC.gather_wgrad(x, None, dy,
                                                       plan.stem_nbr, True),
                    None, lambda x=x, dy=dy: C.wgrad_library(
                        x, None, dy, plan.stem_nbr, True),
                    2.0 * live * 259 * 32,
                    nb(x, dy, plan.stem_nbr) + 125 * 259 * 32 * 4))
        xd, dyd = padded(xd32.to(dt), 1, pw), dyd32.to(dt)
        out.append((f"K11 stem dW k5 259->32 L0 at width {pw}", dt,
                    lambda xd=xd, dyd=dyd: BD.block_wgrad(
                        xd, dyd, t.block_nbr, occ, t.edge, 5,
                        BD.row_list(t, occ)), None, None,
                    2.0 * live * 259 * 32,
                    nb(xd, dyd, t.block_nbr, occ) + 125 * 259 * 32 * 4))
    return out


def bf16_sweep(plan, hybrid, gen, rounds, reps):
    """Each case of ``bf16_cases``: held to its plain version where it has
    one, its output's digest, then timed."""
    import chip_smoke as C

    runs = bf16_cases(plan, hybrid, gen)
    digests = []
    for name, dt, call, plain, *_ in runs:
        got = call()
        if plain is not None:
            want = plain()
            tol = C.TOL[dt]
            if not torch.allclose(got.float(), want.float(), rtol=tol,
                                  atol=tol):
                err = float((got.float() - want.float()).abs().max())
                raise SystemExit(f"{name} {dt}: max_abs_err {err:.3e} "
                                 "against the plain version")
            del want
        digests.append(digest(got))
        del got
    samples = {i: [] for i in range(len(runs))}
    for _ in range(rounds):
        for i, run in enumerate(runs):
            samples[i].append(C.time_ms(run[2], reps))
    for i, (name, dt, _, _, lib, ops, byts) in enumerate(runs):
        med = float(np.median(samples[i]))
        peak = "bf16" if dt == torch.bfloat16 else "fp32"
        b_ms, b_by = C.bound(ops, byts, peak)
        lib_text = "" if lib is None else \
            f"; library {C.time_ms(lib, reps):.4f} ms"
        print(f"bf16 sweep {name} {str(dt).replace('torch.', '')}: median "
              f"{med:.4f} ms over {rounds} x {reps} calls{lib_text}; "
              f"bound {b_ms:.4f} ms ({b_by}); output digest {digests[i]}",
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--narrow", action="store_true",
                    help="K1 and K10, wide against narrow path, by Cin")
    ap.add_argument("--live", action="store_true",
                    help="the flagship stem's forward, K10's live-pair "
                    "path against its row-tile path, K1 beside them")
    ap.add_argument("--dtype", choices=("fp32", "bf16"), default="fp32",
                    help="bf16: the bf16 backbone's K1, K10, K4 and K11 "
                    "cases, each beside its fp32 run")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("conv_bench: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    from segdino3d_tpu_torch.data.collate import (PadSpec, attach_host_plan,
                                                  collate)
    from segdino3d_tpu_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_build.build_all(("gather_gemm_conv", "gather_wgrad", "block_conv",
                          "block_wgrad"))
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
    if args.live:
        from segdino3d_tpu_torch.tools import wgrad_bench as WB

        hybrid = attach_host_plan(collate(records, spec, "cuda"), records,
                                  spec, level_cap_ratios=C.LEVEL_CAP_RATIOS,
                                  **C.plan_layout("hybrid")).plan
        WB.run_stem(live_cases(plan, hybrid, gen), args.rounds, args.reps,
                    held=conv_held)
        return 0
    if args.narrow or args.dtype == "bf16":
        hybrid = attach_host_plan(collate(records, spec, "cuda"), records,
                                  spec, level_cap_ratios=C.LEVEL_CAP_RATIOS,
                                  **C.plan_layout("hybrid")).plan
        if args.narrow:
            narrow_sweep(plan, hybrid, gen, args.rounds, args.reps)
        else:
            bf16_sweep(plan, hybrid, gen, args.rounds, args.reps)
        return 0
    runs = cases(plan, gen)
    samples = {i: [] for i in range(len(runs))}
    for _ in range(args.rounds):
        for i, run in enumerate(runs):
            samples[i].append(C.time_ms(run[3], args.reps))
    library = [C.time_ms(run[4], args.reps) for run in runs]
    plain = [C.time_ms(run[9], args.reps) for run in runs]
    per_fwd = per_step = bound_step = 0.0
    for i, (name, fwd, step, _, _, pairs, cin, cout, byts,
            _) in enumerate(runs):
        t = np.array(samples[i])
        med = float(np.median(t))
        b_ms, b_by = C.bound(2.0 * pairs * cin * cout, byts, "fp32")
        per_fwd += fwd * med
        per_step += step * med
        bound_step += step * b_ms
        print(f"{name}: min {t.min():.4f} ms, median {med:.4f} ms over "
              f"{args.rounds} x {args.reps} calls; plain {plain[i]:.4f} ms; "
              f"library {library[i]:.4f} ms; {pairs} live pairs, bound {b_ms:.4f} ms ({b_by}); calls "
              f"per forward {fwd}, per step {step}", flush=True)
    print(f"K1 summed over its calls (medians): {per_fwd:.4f} ms per gather "
          f"forward, {per_step:.4f} ms per gather training step (bound "
          f"{bound_step:.4f} ms)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
