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
of the output and the live-pair list's build.  Then every distinct k3
conv of the Res16UNet34C (``K3_CONVS``) on its level's blocks of the
hybrid plan, fp32 and bf16, in the forward role (the occupancy's row list
and its live-pair list, ``live_pairs``) and in the dX role (flipped,
transposed weights on a cotangent zero outside the occupancy, under the
occupancy's k3 dilation, over the dilation's live-pair list,
``dilation_pairs``), on the live-pair path and on the row-tile path forced
(and the live-pair path's other form, the pair-major form or the
row-group kernel, forced, where the checkout has both), each with the
bound of its live pairs.  In a checkout
whose wrapper takes no ``zero_outside`` (or, at k3, has no
``dilation_pairs``) the default path alone is timed (copy this file and
``wgrad_bench.py``, whose runner it uses, into that checkout's
``tools/``).

    python -m segdino3d_tpu_torch.tools.conv_bench --live --scene batched
    python -m segdino3d_tpu_torch.tools.conv_bench --live --scene stress \
        --dtype bf16

times the same k3 cases on ``chip_smoke.py`` phase 12's plans instead,
in ``--dtype`` alone, under its ``SEGDINO_CONV_CHUNK_MB``: the batch of 8
headline scenes at its pinned caps (level 0 in the gather layout there:
levels 1-4) or the 400,000-point stress scene at its caps; the form
thresholds of ``ops/narrow.py`` are keyed on the level's capacity.

    python -m segdino3d_tpu_torch.tools.conv_bench --form \
        --scene headline batched stress [--dtype fp32|bf16|both]

times the two forms of K1 and of K10's live-pair path against each other,
the paired runs behind ``ops/narrow.py``'s row-group thresholds: on each
scene's plan (the headline scene's gather plan for K1 and hybrid plan for
K10; phase 12's plans under its ``SEGDINO_CONV_CHUNK_MB``, as ``--live
--scene`` builds them), K1 at the stem (k5 259 -> 32, bf16 at the 264
pitch), at level 0's k3 96 -> 96 and 128 -> 96 in the forward and dX
roles where level 0 is a gather level, at the headline scene's level 1
and at the v2 model's k3 stem 262 -> 32 on level 0's k3 table; K10 at
96 -> 96 of the first block-dense level (the headline scene's L0, the
batch's L1, the stress scene's L0), forward and dX.  ``gather2`` and
``gather4`` put 2 and 4 headline scenes in the gather layout (K1 at level
0's and level 1's k3 convs, caps between the headline scene's and the
batch's).  The paths: the pair-major form in the budget's offset chunks
and in one chunk (where the budget cuts it) and the row-group form (K10's
bf16 forward also on the row tiles), interleaved; each held to the plain
version (fp32 1e-4, bf16 1e-2), every fp32 path bit-equal to the
pair-major form (checked before the timing); beside K1's cases the build
of its table's pair list (``gather_pairs``).

    python -m segdino3d_tpu_torch.tools.conv_bench --chunks

times the convs whose pair-major buffer outgrows the budget at the
headline scene's caps (``SEGDINO_CONV_CHUNK_MB``, 1024 MiB unset): K1 at
the stem and K10's dense stem (each at the stems' pitch), K10's k3 dX
96 -> 128 at level 0 in the pair-major form, each in the budget's offset
chunks and in one chunk (the budget lifted), held bit-equal to each other and
to the plain version first, the two interleaved.
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
        # the stem at its pitch (zero columns past Cin), as the backbone
        # gives it
        x = C.pitched(torch.randn(x_rows, cin, generator=gen, device="cuda"),
                      1) if cin > 256 else torch.randn(
            x_rows, cin, generator=gen, device="cuda")
        w = torch.randn(nbr.shape[0], cin, cout, generator=gen,
                        device="cuda") * (nbr.shape[0] * cin) ** -0.5
        if cin > 256:
            w = C.pitched(w, 1)
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
                     **form_paths(lambda f, x=x, w=w, lp=lp: BD.block_conv(
                         x, t.block_nbr, w, occ, e, rows, zero_outside=True,
                         live_list=lp, form=f), 5, dt),
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


def form_paths(call, k, dt):
    """{path: call} of K10's live-pair path in the form ``narrow`` does not
    pick (``narrow.LIVE_FORMS``: the pair-major form and the row-group
    kernel), where this checkout's wrapper takes ``form=``; ``call(f)``
    runs it in form f."""
    import inspect

    from segdino3d_tpu_torch.ops import block_dense as BD
    from segdino3d_tpu_torch.ops import narrow as N

    if "form" not in inspect.signature(BD.block_conv).parameters:
        return {}
    return {f"live-pair, {f} (forced)": (lambda f=f: call(f))
            for f in N.LIVE_FORMS if f != N.live_form(k, dt)}


def k3_live_cases(hybrid, gen, dtypes=(torch.float32, torch.bfloat16)):
    """[(name, dtype, {path: call}, plain call, library call, ops, bytes)]
    of every distinct k3 conv of a block-dense level in the forward and dX
    roles, in ``dtypes``: K10 on its level's blocks (the live-pair and the
    row-tile path, where this checkout has both; the live-pair path's other
    form, where it has two)."""
    import chip_smoke as C
    from segdino3d_tpu_torch.ops import block_dense as BD
    from segdino3d_tpu_torch.ops import sparse_conv as SC

    both = hasattr(BD, "dilation_pairs")
    out = []

    def case(li, cin, cout, n, dx, dt):
        t = hybrid.blocks[li]
        occ = BD.occupancy(t)
        e, b, nbr = t.edge, t.num_blocks, t.block_nbr
        ci, co = (cout, cin) if dx else (cin, cout)
        mask, rl = BD.dilation(t, occ, 3) if dx else (occ, BD.row_list(t, occ))
        lp = (BD.dilation_pairs if dx else BD.live_pairs)(t, occ, 3) \
            if both else BD.live_pair_list(rl, occ, nbr, e, 3)
        pairs, listed = int(lp.counts.sum()), int(rl.count)
        x = torch.where(occ[:, None], torch.randn(
            occ.shape[0], ci, generator=gen, device="cuda"), 0.0).to(dt)
        w = (torch.randn(27, cin, cout, generator=gen, device="cuda")
             * (27 * cin) ** -0.5).to(dt)
        if dx:
            w = SC._transposed(w.flip(0))
        paths = {"default": lambda: BD.block_conv(x, nbr, w, mask, e, rl)}
        if both:
            cap = BD.live_capacity(t)
            paths = {
                "live-pair": lambda: BD.block_conv(
                    x, nbr, w, mask, e, rl, zero_outside=True, live=True,
                    live_list=lp),
                **form_paths(lambda f: BD.block_conv(
                    x, nbr, w, mask, e, rl, zero_outside=True, live=True,
                    live_list=lp, form=f), 3, dt),
                "row-tile (forced)": lambda: BD.block_conv(
                    x, nbr, w, mask, e, rl, live=False),
                "live-pair list build": lambda: BD.live_pair_list(
                    rl, occ, nbr, e, 3, cap, occ.shape[0] if dx else None)}
        wc = w.reshape(3, 3, 3, ci, co).permute(4, 3, 0, 1, 2).contiguous()

        def library():
            p = C.to_ncdhw(BD.halo_pad_plain(x.reshape(b, e, e, e, ci), nbr,
                                             1))
            return torch.nn.functional.conv3d(p, wc)

        role = "dX" if dx else "forward"
        out.append((
            f"K10 k3 {role} {ci}->{co} L{li} ({n} a forward), {listed} "
            f"listed rows, {pairs} live pairs", dt, paths,
            lambda: BD.dense_subm_conv_plain(x, nbr, w, None if dx else mask,
                                             e),
            library, 2.0 * pairs * ci * co,
            C.nbytes(x, w) + 4 * listed + occ.shape[0] * co * x.element_size()))

    for li, cin, cout, n in K3_CONVS:
        if hybrid.blocks[li] is None:
            continue
        for dx in (False, True):
            for dt in dtypes:
                case(li, cin, cout, n, dx, dt)
    return out


def chunk_cases(plan, hybrid, gen):
    """[(name, dtype, {path: call}, plain call, library call, ops, bytes)]
    of the pair-major convs whose buffer outgrows the budget
    (``SEGDINO_CONV_CHUNK_MB``, 1024 MiB unset) at the headline scene's
    caps: K1 at the stem and K10's dense stem (at the stems' pitch; bf16
    K1 too), K10's k3 dX 96->128 at L0 (fp32, the pair-major form), each in
    the budget's offset chunks and in one chunk, held bit-equal first."""
    import chip_smoke as C
    from segdino3d_tpu_torch.ops import block_dense as BD
    from segdino3d_tpu_torch.ops import narrow as N
    from segdino3d_tpu_torch.ops import sparse_conv as SC

    lv = plan.levels[0]
    nbr, valid, v0 = plan.stem_nbr, lv.valid, lv.valid.shape[0]
    t = hybrid.blocks[0]
    occ = BD.occupancy(t)
    e, nb = t.edge, t.block_nbr
    rows = BD.row_list(t, occ)
    dil, drows = BD.dilation(t, occ, 3)
    out = []

    def add(name, dt, k, cin, cout, call, plain, lib, pairs, counter, byts):
        before = counter.launches
        got = call()
        n = counter.launches - before
        whole = C.in_one_chunk(call)
        if not torch.equal(got, whole()):
            raise SystemExit(f"{name} {dt}: {n} chunks differ from one chunk")
        out.append((f"{name}, {n} offset chunks", dt,
                    {f"{n} chunks": call, "one chunk": whole},
                    plain, lib, 2.0 * pairs * cin * cout, byts))

    live = int((nbr >= 0).sum())
    for dt in (torch.float32, torch.bfloat16):
        x = C.pitched(torch.randn(v0, 259, generator=gen, device="cuda"
                                  ).to(dt), 1)
        w = C.pitched((torch.randn(125, 259, 32, generator=gen, device="cuda")
                       * (125 * 259) ** -0.5).to(dt), 1)
        add(f"K1 stem k5 259->32 L0 (x at {x.shape[1]})", dt, 5, 259, 32,
            lambda x=x, w=w: SC.gather_conv(x, nbr, w, valid),
            lambda x=x, w=w: SC.gather_conv_plain(x, nbr, w, valid),
            lambda x=x, w=w: C.conv_library(x, nbr, w), live,
            SC.gather_conv.chunks,
            C.nbytes(x, nbr, w, valid) + v0 * 32 * x.element_size())
    def k10(name, k, cin, cout, mask, rlist, lp):
        # a stem at its pitch (zero columns past Cin), as the backbone
        # gives it
        x = torch.where(occ[:, None], torch.randn(
            occ.shape[0], cin, generator=gen, device="cuda"), 0.0)
        w = torch.randn(k ** 3, cin, cout, generator=gen, device="cuda") \
            * (k ** 3 * cin) ** -0.5
        if cin > 256:
            x, w = C.pitched(x, 1), C.pitched(w, 1)
        ci = x.shape[1]
        wc = w.reshape(k, k, k, ci, cout).permute(4, 3, 0, 1, 2).contiguous()

        def lib():
            p = C.to_ncdhw(BD.halo_pad_plain(
                x.reshape(t.num_blocks, e, e, e, ci), nb, (k - 1) // 2))
            return torch.nn.functional.conv3d(p, wc)

        add(name, torch.float32, k, cin, cout,
            lambda: BD.block_conv(x, nb, w, mask, e, rlist,
                                  zero_outside=True, live=True,
                                  live_list=lp, form=N.PAIR_MAJOR),
            lambda: BD.block_conv_live_plain(x, w, lp), lib,
            int(lp.counts.sum()), BD.block_conv.chunks,
            C.nbytes(x, w) + occ.shape[0] * cout * 4)

    k10(f"K10 dense stem k5 259->32 L0 (x at "
        f"{N.row_pitch(259, torch.float32)}), pair-major", 5, 259, 32, occ,
        rows, BD.live_pairs(t, occ, 5))
    k10("K10 k3 dX 96->128 L0 under the dilation, pair-major", 3, 96, 128,
        dil, drows, BD.dilation_pairs(t, occ, 3))
    return out




def form_case(name, dt, call, plain, lib, ops, byts, chunks, more=None):
    """A ``--form`` case: ``call(**kw)`` runs the conv with ``kw`` forcing
    a form; its paths the pair-major form (``chunks``: a counter of offset
    chunks, the budget's and one chunk where they differ), the row-group
    form, and ``more``."""
    import chip_smoke as C
    from segdino3d_tpu_torch.ops import narrow as N

    pm = lambda: call(form=N.PAIR_MAJOR)  # noqa: E731
    before = chunks.launches
    pm()
    n = chunks.launches - before
    paths = {f"pair-major, {n} chunks": pm}
    if n > 1:
        paths["pair-major, one chunk"] = C.in_one_chunk(pm)
    paths["row groups"] = lambda: call(form=N.ROW_GROUPS)
    paths.update(more or {})
    if dt == torch.float32:
        ref = pm()
        for path, fn in paths.items():
            if "list build" not in path and not torch.equal(fn(), ref):
                raise SystemExit(f"{name}: {path} differs from the pair-major "
                                 "form")
        print(f"form {name} float32: every path bit-equal to the pair-major "
              f"form, digest {digest(ref)}", flush=True)
        del ref
    return (name, dt, paths, plain, lib, ops, byts)


def form_cases(scene, gen, dtypes):
    """``--form``'s cases on ``scene``'s plans (see the module docstring):
    [(name, dtype, {path: call}, plain call, library call, ops, bytes)]."""
    import chip_smoke as C
    from segdino3d_tpu_torch.data.collate import (PadSpec, attach_host_plan,
                                                  collate)
    from segdino3d_tpu_torch.ops import block_dense as BD
    from segdino3d_tpu_torch.ops import narrow as N
    from segdino3d_tpu_torch.ops import sparse_conv as SC

    if scene == "headline":
        records = C.make_records()
        spec = PadSpec(C.SCENE["n_points"], C.SCENE["n_superpoints"], 64,
                       128, 200)
        plan = attach_host_plan(collate(records, spec, "cuda"), records,
                                spec, voxel_size=0.02,
                                level_cap_ratios=C.LEVEL_CAP_RATIOS).plan
        hybrid = attach_host_plan(collate(records, spec, "cuda"), records,
                                  spec, level_cap_ratios=C.LEVEL_CAP_RATIOS,
                                  **C.plan_layout("hybrid")).plan
    elif scene.startswith("gather"):
        plan, hybrid = scene_hybrid(scene), None
    else:
        plan = hybrid = scene_hybrid(scene)
    lv = plan.levels
    v0, valid = lv[0].valid.shape[0], lv[0].valid
    out = []

    def k1(label, nbr, valid, cin, cout, dx=False):
        """K1 at ``nbr`` for a conv cin -> cout, or (``dx``) its input
        gradient: the flipped, transposed weight on a Cout-wide input."""
        v = nbr.shape[1]
        hits = int((nbr[:, valid] >= 0).sum())
        width = cout if dx else cin
        for dt in dtypes:
            pitch = N.row_pitch(cin, dt) if cin > 256 else cin
            x = padded(torch.randn(v, width, generator=gen, device="cuda"
                                   ).to(dt), 1, pitch if not dx else width)
            w = padded((torch.randn(nbr.shape[0], cin, cout, generator=gen,
                                    device="cuda")
                        * (nbr.shape[0] * cin) ** -0.5).to(dt), 1, pitch)
            if dx:
                w = SC._transposed(w.flip(0)).contiguous()

            def call(x=x, w=w, **kw):
                return SC.gather_conv(x, nbr, w, valid, dx=dx, **kw)

            out.append(form_case(
                f"K1 {label}, table of {v} rows, {hits} live pairs", dt,
                call, lambda x=x, w=w: SC.gather_conv_plain(x, nbr, w, valid),
                lambda x=x, w=w: C.conv_library(x, nbr, w),
                2.0 * hits * cin * cout,
                C.nbytes(x, nbr, w, valid) + v * w.shape[2] * x.element_size(),
                SC.gather_conv.chunks,
                {"pair list build": lambda: SC.gather_pairs(None, nbr)}))

    k1("stem k5 259->32 L0", plan.stem_nbr, valid, 259, 32)
    if lv[0].nbr is not None:
        for cin in (96, 128):
            k1(f"k3 {cin}->96 L0", lv[0].nbr, valid, cin, 96)
            k1(f"k3 dX of {cin}->96 L0", lv[0].nbr, valid, cin, 96, dx=True)
    if scene == "headline":
        k1("k3 96->96 L1", lv[1].nbr, lv[1].valid, 96, 96)
        k1("v2 k3 stem 262->32 L0", lv[0].nbr, valid, 262, 32)
    if hybrid is None:
        k1("k3 96->96 L1", lv[1].nbr, lv[1].valid, 96, 96)
        return out

    li = next(i for i, t in enumerate(hybrid.blocks) if t is not None)
    t = hybrid.blocks[li]
    occ = BD.occupancy(t)
    e, nb = t.edge, t.block_nbr
    for dx in (False, True):
        mask, rl = BD.dilation(t, occ, 3) if dx else (occ, BD.row_list(t, occ))
        lp = (BD.dilation_pairs if dx else BD.live_pairs)(t, occ, 3)
        need, listed = int(lp.counts.sum()), int(rl.count)
        for dt in dtypes:
            x = torch.where(occ[:, None], torch.randn(
                occ.shape[0], 96, generator=gen, device="cuda"), 0.0).to(dt)
            w = (torch.randn(27, 96, 96, generator=gen, device="cuda")
                 * (27 * 96) ** -0.5).to(dt)
            if dx:
                w = SC._transposed(w.flip(0))

            def call(x=x, w=w, mask=mask, rl=rl, lp=lp, **kw):
                return BD.block_conv(x, nb, w, mask, e, rl, zero_outside=True,
                                     live=True, live_list=lp, **kw)

            wc = w.reshape(3, 3, 3, 96, 96).permute(4, 3, 0, 1, 2
                                                    ).contiguous()

            def lib(x=x, wc=wc):
                p = C.to_ncdhw(BD.halo_pad_plain(
                    x.reshape(t.num_blocks, e, e, e, 96), nb, 1))
                return torch.nn.functional.conv3d(p, wc)

            more = {} if dx or dt == torch.float32 else {
                "row tiles": lambda x=x, w=w, rl=rl: BD.block_conv(
                    x, nb, w, occ, e, rl, live=False)}
            role = "dX" if dx else "forward"
            out.append(form_case(
                f"K10 k3 {role} 96->96 L{li}, {listed} listed rows, {need} "
                f"live pairs", dt, call,
                lambda x=x, w=w, lp=lp: BD.block_conv_live_plain(x, w, lp),
                lib, 2.0 * need * 96 * 96,
                C.nbytes(x, w) + 4 * listed + occ.shape[0] * 96
                * x.element_size(), BD.block_conv.chunks, more))
    return out


def scene_hybrid(scene):
    """Phase 12's hybrid plan (``chip_smoke.py``) under its
    ``SEGDINO_CONV_CHUNK_MB``: "batched", 8 headline scenes at their
    pinned caps, or "stress", the 400,000-point scene at its caps; or
    "gatherN", N headline scenes at their caps in the gather layout (K1 at
    every level, between the headline scene's caps and the batch's)."""
    import chip_smoke as C
    from segdino3d_tpu_torch.data.collate import (PadSpec, attach_host_plan,
                                                  collate)
    from segdino3d_tpu_torch.data.synthetic import synthetic_scene

    os.environ["SEGDINO_CONV_CHUNK_MB"] = C.SCALE_CHUNK_MB
    if scene == "stress":
        records = [synthetic_scene(0, **C.STRESS_SCENE)]
        spec = PadSpec(*C.STRESS_PAD)
    else:
        n = C.BATCH_SCENES if scene == "batched" else int(scene[6:])
        records = [synthetic_scene(s, **C.SCENE) for s in range(n)]
        spec = PadSpec(C.SCENE["n_points"], C.SCENE["n_superpoints"], 64,
                       128, 200)
    args = C.plan_layout("gather" if scene.startswith("gather") else "hybrid")
    level_caps, block_caps = C.probe_caps(
        records, spec, args.get("block_edges", ()), len(records),
        pin_blocks=scene == "batched")
    plan = attach_host_plan(collate(records, spec, "cuda"), records, spec,
                            level_caps=level_caps, block_caps=block_caps,
                            **args).plan
    print(f"{scene}: level caps {level_caps}, block caps {block_caps}; "
          f"level 0 {C.l0_layout(plan)}; "
          f"{C.describe_blocks(plan) if plan.blocks else 'no block level'}",
          flush=True)
    return plan


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
    ap.add_argument("--dtype", choices=("fp32", "bf16", "both"),
                    default="fp32",
                    help="bf16: the bf16 backbone's K1, K10, K4 and K11 "
                    "cases, each beside its fp32 run; with --scene, the "
                    "dtype timed")
    ap.add_argument("--scene", choices=("headline", "batched", "stress",
                                        "gather2", "gather4"),
                    nargs="+", default=["headline"],
                    help="with --live, the plan the k3 convs run on: "
                    "chip_smoke.py phase 12's batch of 8 or its stress "
                    "scene, under its SEGDINO_CONV_CHUNK_MB; with --form, "
                    "each scene in turn (gatherN: N headline scenes in "
                    "the gather layout, K1 alone)")
    ap.add_argument("--form", action="store_true",
                    help="K1's and K10's pair-major and row-group forms "
                    "against each other")
    ap.add_argument("--chunks", action="store_true",
                    help="the convs whose pair-major buffer outgrows the "
                    "budget at the headline caps, in its offset chunks "
                    "and in one chunk")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("conv_bench: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    from segdino3d_tpu_torch.data.collate import (PadSpec, attach_host_plan,
                                                  collate)
    from segdino3d_tpu_torch.ops import cuda_build
    from segdino3d_tpu_torch.tools import wgrad_bench as WB

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_build.build_all(("gather_gemm_conv", "gather_wgrad", "block_conv",
                          "block_wgrad"))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    dtypes = {"fp32": (torch.float32,), "bf16": (torch.bfloat16,),
              "both": (torch.float32, torch.bfloat16)}[args.dtype]
    if args.form:
        for scene in args.scene:
            runs = form_cases(scene, gen, dtypes)
            WB.run_stem(runs, args.rounds, args.reps, held=conv_held,
                        prefix=f"form {scene}")
            del runs
            torch.cuda.empty_cache()
        return 0
    if args.live and args.scene != ["headline"]:
        for scene in args.scene:
            WB.run_stem(k3_live_cases(scene_hybrid(scene), gen, dtypes),
                        args.rounds, args.reps, held=conv_held,
                        prefix=f"{scene} k3")
        return 0
    records = C.make_records()
    spec = PadSpec(C.SCENE["n_points"], C.SCENE["n_superpoints"], 64, 128,
                   200)
    plan = attach_host_plan(collate(records, spec, "cuda"), records, spec,
                            voxel_size=0.02,
                            level_cap_ratios=C.LEVEL_CAP_RATIOS).plan
    print(f"voxels per level {[int(t.valid.sum()) for t in plan.levels]}, "
          f"caps {[t.valid.shape[0] for t in plan.levels]}", flush=True)
    if args.live or args.chunks:
        hybrid = attach_host_plan(collate(records, spec, "cuda"), records,
                                  spec, level_cap_ratios=C.LEVEL_CAP_RATIOS,
                                  **C.plan_layout("hybrid")).plan
        if args.chunks:
            WB.run_stem(chunk_cases(plan, hybrid, gen), args.rounds,
                        args.reps, held=conv_held, prefix="chunks")
            return 0
        WB.run_stem(live_cases(plan, hybrid, gen), args.rounds, args.reps,
                    held=conv_held)
        WB.run_stem(k3_live_cases(hybrid, gen), args.rounds, args.reps,
                    held=conv_held, prefix="k3")
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
