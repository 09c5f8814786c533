#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``segdino3d_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. print the card's name and power limit (``nvidia-smi``); build the
   hand-written kernels (``csrc/*.cu``, one ``nvcc`` each, in parallel) and
   the C++ host-plan library;
2. hold every kernel against its plain PyTorch version at the main path's
   shapes, and time the kernel, the plain version and a PyTorch yardstick
   with CUDA events: the forward kernels K1-K3 in fp32 and bf16, two calls
   of each bit-equal (K1 at the k5 stem, a k3 conv of every level and two
   down convs; K2 at the four up convs; K3 as the voxel mean from its two
   column sources, with fp32 and with fp16 2D features, and as the
   superpoint pool, each CSR build timed beside it; the CSR's own two
   kernels, equal to their plain version); the
   backward kernels K4 (weight gradients) and K5 (pooling gradient, as
   the pool's backward runs it: one operation, the count division inside,
   two calls bit-equal), and K1/K2 in their backward roles, in fp32 at the training shapes; the
   plan engine's kernels K6 (coordinate hash: build and lookup of the same
   keys in one launch at each level's hash, L0-L4), K8 (voxel compaction)
   and K7
   (neighbour tables: every table of the headline plan in one launch and
   at most one memset, and one table alone), whose integer outputs must be
   equal (with the profiled device time of a call and of an empty launch
   beside its host-bound CUDA-event time, as for the dilation below); the
   block-dense
   layout's kernels on the flagship config's block tables: K9 (slot
   gather, both ways, equal), K10 (block conv at the occupied rows: k3
   96->96 at level 0, k3 384->256 at level 3, the dense k5 stem 259->32,
   fp32 and bf16, each on the level's cached row list, and its dX role
   under the occupancy's k-dilation on the dilation's cached list, two
   calls in a row bit-equal to each other and to a call that builds its
   own list, held to the unmasked plain version on every cell; with the
   bound of the pairs whose source is occupied, of its rows' work and of
   the dense work, and the operations one call puts on the card), the
   dilation kernel beside it (the mask and its row list equal to the plain
   dilation's occupied rows) and K11 (its weight gradient: level 0 k3 and
   the stem, over the level's cached occupied-row list), each with its
   bound from the cells this scene occupies (K11: of the pairs whose source
   is occupied, and of all pairs whose source block exists) and the row
   list's build timed beside it; K4 with the live pairs its compacted
   per-offset lists hold and their build timed beside it; K8
   is timed as the wrapper call alone, its launches per call counted by
   ``torch.profiler`` (at most two); K12 (the compacted
   stem's slot sum) on the scene's compacted tables with 32 and 8 slots
   per voxel, fp32 and bf16, the stem's wide matmul timed beside it;
3. run the eval path at full width: ScanNet200 eval of the flagship
   SegDINO3D (Res16UNet34C + 6-layer DINO-X query decoder) with seeded
   random weights on a seeded synthetic 120,000-point scene with 1,536
   superpoints: collate -> host plan -> backbone -> decoder ->
   predict_instance -> AP evaluator.  It prints scenes/s, ms per stage,
   each kernel's launches in one forward (K1's pair lists: one per index
   table), peak memory, and K1's, K2's and K3's device time in one more,
   profiled forward; checks that the forward builds no (N, 259)
   concatenation of the point features, that every output is finite, and
   holds the card's forward against the CPU's
   plain path on a small scene, on a host plan and on a device plan;
3b. run the same eval path on a plan built on the card (the batch carries
   no host plan; K6-K8 in the backbone), at the host plan's capacities:
   every table must equal the host plan's on its valid rows and the
   outputs must match the host-plan forward's within 1e-5.  It prints the
   device plan's ms beside the host plan's, scenes/s and each kernel's
   launches in one forward;
4. run the training path at full width: the flagship recipe's step (host
   plan -> backbone -> query subsampling -> decoder -> SparseMatcher
   criterion -> backward -> clip -> AdamW/PolyLR -> EMA) for a few batch-1
   steps, then one ``accum_steps=4`` step over four seeded scenes (the
   JAX package's recipe for the reference's batch 4).  It prints s/step,
   ms per stage, peak memory, each kernel's launches in one step (K4's
   pair lists, shared with K1: one per index table and scene), K1's, K4's
   and K11's device time in one more, profiled, batch-1 step,
   checks that every loss and the gradient norm are finite, and holds the
   card's step against the CPU's plain path on a small scene;
4b. run the batch-1 training step on device plans (built inside the
   forward) for a few steps: s/step, the plan stage, launches, finite
   losses and gradient norm;
3c. run the eval path on the flagship config's eval layout, the hybrid one
   (a gather k5 stem, block-dense convs everywhere else: kernels K9 and
   K10 at the occupied rows): blocks and fill per level, scenes/s, ms per
   stage, launches in one forward, peak memory; the backbone output within
   3e-3 x max|.| of the gather layout's on the same scene and weights, and
   the card against the CPU's plain path on a small hybrid scene;
4c. run batch-1 training steps on the config's training layout
   (block-dense everywhere, the k5 stem too: K9, K10 forward and as dX
   under the dilation, the dilation, K11 and its row lists): s/step, ms
   per stage, launches per step, K4's and K11's device time and K10's
   row-list launches in a profiled step (no conv may build its own list),
   peak memory, finite losses and gradient norm, and the card
   against the CPU on a small scene;
3d. run the eval entry point on three headline-size scenes written to a
   temp dir (``write_scannet_layout``): the port's ScanNet200 reader,
   ``EvalLoader`` (batch 1, default buckets, capacity prescan, prefetch 1)
   on the config's hybrid host plans and ``evaluate`` (bit-packed result
   transfer), once with the gather stem (K1) and once with the compacted
   stem (K12): launches per forward, scenes/s, ms per stage, peak memory;
   the compacted run's superpoint features within 3e-3 x max|.| of the
   gather run's, and the card against the CPU on a small compacted-stem
   scene at 1e-4;
5. print one ``kernels`` JSON line, then the result line.

It needs one card, imports no JAX, and takes its kernels from the
checkout: run from anywhere else it fails.
"""
from __future__ import annotations

import copy
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet, dense peaks:
PEAK_OPS = {"fp32": 67e12,         # fp32 outside the tensor cores
            "bf16": 989e12}        # bf16 tensor cores
CONV_PEAK = {torch.float32: "fp32", torch.bfloat16: "bf16"}
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}   # rtol = atol
SCENE = dict(n_points=120000, n_instances=24, n_superpoints=1536,
             n_classes=180, feat_dim_2d=256)
LEVEL_CAP_RATIOS = (1.0, 0.4, 0.15, 0.06, 0.025)
TIMED_ITERS = 5
DEVICE = "cuda"
# training: the flagship recipe (configs/prototypes/SegDINO3D_ScanNet200.py,
# configs/schedules/adamw_polylr_3d.py)
TRAIN_SEEDS = (0, 1, 2, 3)
TRAIN_STEPS = 3            # measured batch-1 steps, after one warm-up step
OPTIMIZER = dict(lr=1e-4, weight_decay=0.05)
SCHEDULER = dict(total_iters=300 * 129, power=0.9)
CLIP_MAX_NORM, EMA_DECAY = 10.0, 0.9997
WGRAD_TOL = 1e-4           # K4, K11: |kernel - plain| <= 1e-4 * max |plain|


def model_cfg():
    """The flagship SegDINO3D eval config (ScanNet200, DINO-X early
    fusion), as ``configs/models/base_3d.py`` sets it, with its conv
    layouts (``builder.host_plan_args``)."""
    return dict(
        type="SegDINO3D",
        pointcloud_backbone_cfg=dict(
            type="Res16UNet34C", in_channels=259, out_channels=96,
            voxel_size=0.02, mode_fuse_2d_feat="early_fusion",
            compute_dtype="float32", block_edges=(4, 4, 4, 4, 4),
            stem_gather=True, block_edges_train=(4, 4, 4, 4, 4),
            config=dict(conv1_kernel_size=5, bn_momentum=0.02)),
        decoder_cfg=dict(
            type="ScanNetQueryDecoder", num_layers=6,
            num_instance_classes=198, num_semantic_classes=200,
            in_channels=96, d_model=256, num_heads=8, hidden_dim=1024,
            dropout=0.0, activation_fn="gelu", iter_pred=True,
            attn_mask=True, fix_attention=True, objectness_flag=False,
            add_dinox_query_ca=True, add_dinox_query_ca_mask=True,
            add_positional_embedding=True, pos_type="sine", temperature=20,
            add_box_size_pred=True, box_modulate_ca=True,
            normalize_box_prediction=True),
        test_cfg=dict(topk_insts=600, inst_score_thr=0.0, pan_score_thr=0.5,
                      npoint_thr=100, obj_normalization=True,
                      sp_score_thr=0.4, nms=True,
                      matrix_nms_kernel="linear", stuff_classes=[0, 1]))


def train_cfg():
    """The flagship training config: the eval config plus query
    subsampling and the criterion of ``configs/models/base_3d.py``."""
    costs = [dict(type="QueryClassificationCost", weight=0.5),
             dict(type="MaskBCECost", weight=1.0),
             dict(type="MaskDiceCost", weight=1.0),
             dict(type="CenterL1Cost", weight=0.5),
             dict(type="SizeL1Cost", weight=0.5)]
    return dict(
        model_cfg(), query_thr=0.5, mode_3d_center="median",
        criterion_cfg=dict(
            type="ScanNetUnifiedCriterion", num_semantic_classes=200,
            sem_criterion=dict(type="ScanNetSemanticCriterion",
                               ignore_index=200, loss_weight=0.5),
            inst_criterion=dict(
                type="InstanceCriterion",
                matcher=dict(type="SparseMatcher", topk=1, costs=costs),
                loss_weight=[0.5, 1.0, 1.0, 0.5, 0.5, 0.5], num_classes=198,
                non_object_weight=0.1, fix_dice_loss_weight=True,
                iter_matcher=True, fix_mean_loss=True)))


def compact_cfg():
    """The flagship eval config with the degree-compacted stem turned on
    (its default D = 32 slots)."""
    cfg = model_cfg()
    cfg["pointcloud_backbone_cfg"]["stem_compact"] = True
    return cfg


def plan_layout(name):
    """``attach_host_plan`` arguments of a conv layout: "gather" (phases
    3-4b), or the flagship config's eval layout "hybrid", the same with the
    compacted stem "compact" (phase 3d) or its training layout
    "block-dense" (``builder.host_plan_args``)."""
    from segdino3d_tpu_torch.builder import host_plan_args

    if name == "hybrid":
        return host_plan_args(model_cfg())
    if name == "compact":
        return host_plan_args(compact_cfg())
    if name == "block-dense":
        return host_plan_args(train_cfg(), train=True)
    if name != "gather":
        raise ValueError(f"unknown layout {name}")
    return dict(voxel_size=0.02)


def time_ms(fn, reps=10):
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(ops, byts, peak):
    t_ops = ops / PEAK_OPS[peak] * 1e3
    t_bytes = byts / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# --------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# --------------------------------------------------------------------------

def _randn(gen, shape, dtype, scale=1.0):
    return (torch.randn(shape, generator=gen, device=DEVICE) * scale).to(dtype)


def conv_library(x, nbr, w):
    """Yardstick: gather + one dense library GEMM (im2col, or for a wide
    input the matmul-first form)."""
    n_off, cin, cout = w.shape
    xp = torch.cat([x, x.new_zeros(1, cin)])
    idx = torch.where(nbr < 0, x.shape[0], nbr).long()
    if cin > 2 * cout:
        y = x @ w.permute(1, 0, 2).reshape(cin, n_off * cout)
        yp = torch.cat([y, y.new_zeros(1, n_off * cout)]).view(-1, n_off, cout)
        return yp[idx, torch.arange(n_off, device=x.device)[:, None]].sum(0)
    return xp[idx.T].reshape(-1, n_off * cin) @ w.reshape(n_off * cin, cout)


def up_library(x, parent, kpos, w):
    cin = w.shape[1]
    a = x.new_zeros(parent.shape[0], 8, cin)
    live = parent >= 0
    rows = torch.nonzero(live)[:, 0]
    a[rows, kpos[rows].long()] = x[parent[rows].long()]
    return a.reshape(-1, 8 * cin) @ w.reshape(8 * cin, -1)


def segment_library(seg, num_segments, valid, rows):
    keep = valid & (seg >= 0) & (seg < num_segments)
    idx = seg[keep].long()[:, None].expand(-1, rows.shape[1])
    return rows.new_zeros(num_segments, rows.shape[1]).scatter_reduce(
        0, idx, rows[keep], "mean", include_self=False)


def kernel_cases(batch, s_cap, gen):
    """(kernel, case name, {dtype: (kernel_fn, plain_fn, library_fn,
    ops, bytes, peak)}) at the main path's shapes."""
    from segdino3d_tpu_torch.models.backbone.wrapper import \
        superpoint_segment_ids
    from segdino3d_tpu_torch.ops import scatter as SS
    from segdino3d_tpu_torch.ops import sparse_conv as SC

    plan = batch.plan
    n_points = batch.points.shape[1]
    lv = plan.levels
    cases = []

    def conv_case(name, vin, nbr, valid, cin, cout):
        per = {}
        hits = int((nbr >= 0).sum())
        for dt in (torch.float32, torch.bfloat16):
            x = _randn(gen, (vin, cin), dt)
            w = _randn(gen, (nbr.shape[0], cin, cout), dt,
                       (nbr.shape[0] * cin) ** -0.5)
            per[dt] = (lambda x=x, w=w: SC.gather_conv(x, nbr, w, valid),
                       lambda x=x, w=w: SC.gather_conv_plain(x, nbr, w, valid),
                       lambda x=x, w=w: conv_library(x, nbr, w),
                       2.0 * hits * cin * cout,
                       nbytes(x, nbr, w, valid)
                       + nbr.shape[1] * cout * x.element_size(), CONV_PEAK[dt])
        cases.append(("gather_gemm_conv", name, per))

    v0 = lv[0].valid.shape[0]
    conv_case("stem k5 259->32 L0", v0, plan.stem_nbr, lv[0].valid, 259, 32)
    conv_case("subm k3 96->96 L0", v0, lv[0].nbr, lv[0].valid, 96, 96)
    for li, c in ((1, 96), (2, 64), (3, 128), (4, 256)):
        conv_case(f"subm k3 {c}->{c} L{li}", lv[li].valid.shape[0],
                  lv[li].nbr, lv[li].valid, c, c)
    conv_case("down 32->32 L0->L1", v0, lv[0].child, lv[1].valid, 32, 32)
    conv_case("down 128->128 L3->L4", lv[3].valid.shape[0], lv[3].child,
              lv[4].valid, 128, 128)

    def up_case(name, coarse, fine, cin, cout):
        per = {}
        live = int((fine.valid & (fine.parent >= 0)).sum())
        for dt in (torch.float32, torch.bfloat16):
            x = _randn(gen, (coarse.valid.shape[0], cin), dt)
            w = _randn(gen, (8, cin, cout), dt, cin ** -0.5)
            per[dt] = (lambda x=x, w=w: SC.up_conv_rows(
                           x, fine.child, fine.parent, fine.kpos, w,
                           fine.valid),
                       lambda x=x, w=w: SC.up_conv_plain(
                           x, fine.parent, fine.kpos, w, fine.valid),
                       lambda x=x, w=w: up_library(x, fine.parent, fine.kpos,
                                                   w),
                       2.0 * live * cin * cout,
                       nbytes(x, fine.parent, fine.kpos, w, fine.valid)
                       + fine.valid.shape[0] * cout * x.element_size(),
                       CONV_PEAK[dt])
        cases.append(("up_conv", name, per))

    # the decoder's four up convs, the forward's order reversed
    up_case("up 96->96 L1->L0", lv[1], lv[0], 96, 96)
    up_case("up 128->96 L2->L1", lv[2], lv[1], 128, 96)
    up_case("up 256->128 L3->L2", lv[3], lv[2], 256, 128)
    up_case("up 256->256 L4->L3", lv[4], lv[3], 256, 256)

    # K3 as the forward calls it: the voxel mean from two column sources
    # (the points' colour columns and the 2D features, each read in place
    # and rounded to the compute dtype), over the forward's voxel CSR
    inverse = plan.inverse
    pvalid = inverse >= 0
    seg_vox = torch.where(inverse >= 0, inverse, v0).contiguous()
    vox_csr = SS.segment_csr(seg_vox, v0, pvalid)
    n_members = int(pvalid.sum())
    pts = _randn(gen, (n_points, 6), torch.float32)
    for fdt in (torch.float32, torch.float16):
        f2d = _randn(gen, (n_points, 256), fdt)
        srcs = [pts[:, 3:], f2d]
        per = {}
        for dt in (torch.float32, torch.bfloat16):
            per[dt] = (lambda dt=dt, srcs=srcs: SS.segment_mean_gather(
                           seg_vox, v0, pvalid, d=srcs, csr=vox_csr,
                           round_to=dt),
                       lambda dt=dt, srcs=srcs: SS.segment_mean_gather_plain(
                           seg_vox, v0, pvalid, d=srcs, round_to=dt),
                       lambda dt=dt, f2d=f2d: segment_library(
                           seg_vox, v0, pvalid, torch.cat(
                               [pts[:, 3:], f2d.float()], 1).to(dt).float()),
                       float(n_members * 259),
                       nbytes(seg_vox, pvalid, f2d) + n_points * 3 * 4
                       + v0 * 259 * 4, "fp32",
                       {"CSR build (segment_csr)": lambda: SS.segment_csr(
                           seg_vox, v0, pvalid),
                        "as the forward calls it (CSR, K3, cast)":
                        lambda dt=dt, srcs=srcs: SS.segment_mean_columns(
                            srcs, seg_vox, v0, dt, pvalid,
                            SS.segment_csr(seg_vox, v0, pvalid))})
        fname = str(fdt).replace("torch.", "")
        cases.append(("segment_mean_gather", f"voxel mean, rgb (N,6)[:,3:6] "
                      f"+ 2D (N,256) {fname} -> V0", per))

    # the CSR both run on: its two kernels around torch.sort, equal to the
    # plain version; library: the int64 sort and searchsorted it replaced
    def flat_csr(c):
        return torch.cat([c.offsets, c.members, c.sorted_ids.long(),
                          c.counters.long()])

    def sort_library(seg, num_segments, valid):
        keep = valid & (seg >= 0) & (seg < num_segments)
        ids = torch.sort(torch.where(keep, seg.long(), num_segments),
                         stable=True)
        return torch.searchsorted(ids.values, torch.arange(
            num_segments + 1, device=seg.device)), ids.indices

    def csr_case(what, seg, num_segments):
        """Bytes: the ids and the mask read once, the CSR's arrays
        (offsets, members, sorted ids, counters) written once."""
        c = SS.segment_csr(seg, num_segments, pvalid)
        cases.append(("segment_csr", f"CSR of the {what}, {n_points} ids -> "
                      f"{num_segments} segments", {torch.float32: (
                          (lambda: SS.segment_csr(seg, num_segments, pvalid),
                           lambda: flat_csr(SS.segment_csr(
                               seg, num_segments, pvalid))),
                          lambda: flat_csr(SS.segment_csr_plain(
                              seg, num_segments, pvalid)),
                          lambda: sort_library(seg, num_segments, pvalid),
                          0.0, nbytes(seg, pvalid, c.offsets, c.members,
                                      c.sorted_ids, c.counters),
                          "fp32", 0.0)}))

    csr_case("voxels", seg_vox, v0)

    # the fused devoxelize + superpoint pool: the (V0, 96) U-Net output
    # gathered through the inverse map, and the two (N, 3) centroid sets
    seg_sp = superpoint_segment_ids(batch.superpoint_ids, s_cap)
    sp_csr = SS.segment_csr(seg_sp, s_cap, pvalid)
    csr_case("superpoints", seg_sp, s_cap)
    q = [_randn(gen, (n_points, 3), torch.float32) for _ in range(2)]
    per = {}
    for dt in (torch.float32, torch.bfloat16):
        g = _randn(gen, (v0, 96), dt)

        def lib(g=g):
            gp = torch.cat([g.float(), g.new_zeros(1, 96).float()])
            rows = torch.cat([gp[torch.where(inverse < 0, v0, inverse).long()],
                              *q], 1)
            return segment_library(seg_sp, s_cap, pvalid, rows)

        per[dt] = (lambda g=g: SS.segment_mean_gather(
                       seg_sp, s_cap, pvalid, g=g, gather_idx=inverse, d=q,
                       csr=sp_csr),
                   lambda g=g: SS.segment_mean_gather_plain(
                       seg_sp, s_cap, pvalid, g=g, gather_idx=inverse, d=q),
                   lib, float(n_members * 102),
                   nbytes(seg_sp, pvalid, g, inverse, *q) + s_cap * 102 * 4,
                   "fp32",
                   {"CSR build (segment_csr)": lambda: SS.segment_csr(
                       seg_sp, s_cap, pvalid)})
    cases.append(("segment_mean_gather",
                  "superpoint pool (V0,96)+2x(N,3)->1536", per))
    return cases


def wgrad_library(a, ia, b, ib, mirror):
    """Yardstick for K4: gather each offset's rows, then one batched
    library GEMM."""
    table = ia if ia is not None else ib
    n_off, rows = table.shape

    def side(x, idx):
        if idx is None:
            return x[:rows].expand(n_off, -1, -1)
        xp = torch.cat([x, x.new_zeros(1, x.shape[1])])
        return xp[torch.where(idx < 0, x.shape[0], idx).long()]

    dw = torch.matmul(side(a, ia).transpose(1, 2), side(b, ib))
    return dw.flip(0) if mirror else dw


def backward_cases(batch, s_cap, gen):
    """The backward kernels at the training path's shapes, fp32: K4 for
    the stem, a level-0 k3 conv, a down and an up conv; K5 for the
    pooling; K1 and K2 in their backward roles."""
    from segdino3d_tpu_torch.models.backbone.wrapper import \
        superpoint_segment_ids
    from segdino3d_tpu_torch.ops import scatter as SS
    from segdino3d_tpu_torch.ops import sparse_conv as SC

    plan = batch.plan
    lv = plan.levels
    v0, v1 = lv[0].valid.shape[0], lv[1].valid.shape[0]
    f32 = torch.float32
    cases = []

    def live_pairs(ia, ib):
        live = torch.ones_like((ia if ia is not None else ib), dtype=torch.bool)
        for t in (ia, ib):
            if t is not None:
                live &= t >= 0
        return int(live.sum())

    def wgrad_case(name, a, ia, b, ib, mirror=False):
        table = ia if ia is not None else ib
        n_off, rows = table.shape
        cin, cout = a.shape[1], b.shape[1]
        live = live_pairs(ia, ib)
        pairs = SC.gather_pairs(ia, ib)
        torch.cuda.synchronize()
        if int(pairs.counts.sum()) != live:
            raise SystemExit(f"gather_pairs [{name}]: {int(pairs.counts.sum())}"
                             f" listed pairs, {live} live")
        cases.append(("gather_wgrad", f"{name}; the compacted lists hold "
                      f"{live} live pairs of {n_off * rows}", {f32: (
            lambda: SC.gather_wgrad(a, ia, b, ib, mirror),
            lambda: SC.gather_wgrad_plain(a, ia, b, ib, n_off, rows, mirror),
            lambda: wgrad_library(a, ia, b, ib, mirror),
            2.0 * live * cin * cout,
            nbytes(a, ia, b, ib) + n_off * cin * cout * 4, "fp32",
            WGRAD_TOL,
            {"pair list build (gather_pairs, once per table and step)":
             lambda: SC.gather_pairs(ia, ib)})}))

    wgrad_case("stem dW k5 259->32 L0 (dY gathered, mirrored)",
               _randn(gen, (v0, 259), f32), None, _randn(gen, (v0, 32), f32),
               plan.stem_nbr, mirror=True)
    wgrad_case("subm dW k3 96->96 L0", _randn(gen, (v0, 96), f32), lv[0].nbr,
               _randn(gen, (v0, 96), f32), None)
    wgrad_case("down dW 32->32 L0->L1", _randn(gen, (v0, 32), f32),
               lv[0].child, _randn(gen, (v1, 32), f32), None)
    wgrad_case("up dW 96->96 L1->L0", _randn(gen, (v1, 96), f32), None,
               _randn(gen, (v0, 96), f32), lv[0].child)

    # K1 and K2 in the backward's roles
    def conv_role(name, x, nbr, w, valid, hits):
        cases.append(("gather_gemm_conv", name, {f32: (
            lambda: SC.gather_conv(x, nbr, w, valid),
            lambda: SC.gather_conv_plain(x, nbr, w, valid),
            lambda: conv_library(x, nbr, w),
            2.0 * hits * w.shape[1] * w.shape[2],
            nbytes(x, nbr, w, valid) + nbr.shape[1] * w.shape[2] * 4,
            "fp32")}))

    w = _randn(gen, (27, 96, 96), f32, (27 * 96) ** -0.5)
    conv_role("subm dX k3 96->96 L0 (flipped, transposed W)",
              _randn(gen, (v0, 96), f32), lv[0].nbr,
              w.flip(0).transpose(1, 2).contiguous(), lv[0].valid,
              int((lv[0].nbr >= 0).sum()))
    every = torch.ones(v1, dtype=torch.bool, device=DEVICE)
    conv_role("up dX 96->96 L0->L1 over the child table",
              _randn(gen, (v0, 96), f32), lv[0].child,
              _randn(gen, (8, 96, 96), f32, 96 ** -0.5), every,
              int((lv[0].child >= 0).sum()))
    dy = _randn(gen, (v1, 32), f32)
    wt = _randn(gen, (8, 32, 32), f32, 32 ** -0.5)
    fine = lv[0]
    live = int((fine.valid & (fine.parent >= 0)).sum())
    cases.append(("up_conv", "down dX 32->32 L1->L0 (transposed W)", {f32: (
        lambda: SC.up_conv_rows(dy, fine.child, fine.parent, fine.kpos, wt,
                                fine.valid),
        lambda: SC.up_conv_plain(dy, fine.parent, fine.kpos, wt, fine.valid),
        lambda: up_library(dy, fine.parent, fine.kpos, wt),
        2.0 * live * 32 * 32,
        nbytes(dy, fine.parent, fine.kpos, wt, fine.valid)
        + v0 * 32 * 4, "fp32")}))

    # K5: the pooling's gradient into the U-Net output, as the pool's
    # backward runs it: the voxel columns of the (1,536, 102) gradient read
    # in place, each divided by its superpoint's count inside the kernel
    inverse = plan.inverse
    pvalid = batch.point_valid.reshape(-1)
    seg = superpoint_segment_ids(batch.superpoint_ids, s_cap)
    vox_csr = SS.segment_csr(inverse, v0, pvalid)
    sp_off = SS.segment_csr(seg, s_cap, pvalid).offsets
    dmeans = _randn(gen, (s_cap, 102), f32)
    g = dmeans[:, :96]
    keep = pvalid & (inverse >= 0) & (seg >= 0) & (seg < s_cap)
    vidx, sidx = inverse[keep].long(), seg[keep].long()
    quot = g / SS.segment_counts(sp_off)[:, None]
    n_members = int(keep.sum())

    def pool_backward():
        return SS.segment_grad(g, seg, s_cap, sp_off, inverse, pvalid,
                               vox_csr)

    ops, us = device_ops(pool_backward)
    print(f"segment_grad [the pool's backward]: one call puts {len(ops)} "
          f"operations on the card, {us:.1f} us of device time: {ops}",
          flush=True)
    if len(ops) != 1:
        raise SystemExit(f"segment_grad: the pool's backward made {len(ops)} "
                         "operations, 1 expected")
    cases.append(("segment_grad", "pool backward (1,536,96 of 102)->(V0,96), "
                  "the count division inside; library: index_add_ of the "
                  "quotients", {f32: (
        pool_backward,
        lambda: SS.segment_grad_plain(g, seg, s_cap, sp_off, inverse, pvalid,
                                      v0),
        lambda: g.new_zeros(v0, 96).index_add_(0, vidx, quot[sidx]),
        float(n_members * 96 * 2),
        nbytes(g, seg, vox_csr.offsets, vox_csr.members, sp_off)
        + v0 * 96 * 4, "fp32")}))
    return cases


def flat_compaction(c):
    """K8's outputs as one int32 vector, to compare."""
    parts = [c.inverse, c.coords_T.reshape(-1), c.valid.to(torch.int32),
             c.num_voxels.reshape(1)]
    return torch.cat(parts + ([c.kpos] if c.kpos is not None else []))


def device_ops(fn):
    """(names of the kernels, copies and memsets that one call of ``fn``
    puts on the card, their summed device time in us), by
    ``torch.profiler`` after a warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    names = [e.name.replace("(anonymous namespace)::", "").split("(")[0]
             for e in events]
    return names, sum(e.time_range.elapsed_us() for e in events)


def plan_engine_cases(batch, level_caps):
    """K6, K8 and K7 at the main path's shapes: the headline scene's point
    keys (insert + lookup), the level-0 compaction and the downsample to
    level 1, the stem's k5 and level 0's k3 neighbour tables.  Bytes count
    each input once and each output once; no arithmetic to speak of."""
    from segdino3d_tpu_torch.models.backbone.wrapper import min_shift
    from segdino3d_tpu_torch.ops import hashing as TQ
    from segdino3d_tpu_torch.ops import keys as TK
    from segdino3d_tpu_torch.ops import sparse_conv as SC
    from segdino3d_tpu_torch.ops import voxelize as TV

    f32, exact = torch.float32, 0.0
    valid = batch.point_valid.reshape(-1)
    pts = batch.points.reshape(-1, 6)
    bidx, shifted = min_shift(pts[:, :3] / torch.full((), 0.02, device=DEVICE),
                              batch.point_valid)
    cols, key = TV.point_keys(bidx, shifted, valid)
    n, v0 = key.shape[0], level_caps[0]
    cases = []

    def flat_build(h, winner, key, lookup):
        """The winners, a lookup of the same keys in the table, the flag."""
        return torch.cat([winner, lookup(h, key),
                          h.overflow.to(torch.int32).reshape(1)])

    def hash_case(name, key, cap):
        """K6's build and lookup of the same keys, one launch.  Bytes: the
        keys read, the winners and the table written."""
        t = TQ.table_size(cap)
        cases.append(("coord_hash", f"{name}: build + lookup in one launch, "
                      f"{key.shape[0]} keys, {t} slots", {f32: (
                          (lambda: TQ.build_and_lookup(key, cap),
                           lambda: flat_build(*TQ.build_and_lookup(key, cap),
                                              key, TQ.lookup_hash)),
                          lambda: flat_build(
                              *TQ.build_and_lookup_plain(key, cap), key,
                              TQ.lookup_hash_plain),
                          lambda: torch.unique(key, sorted=True,
                                               return_inverse=True)[1],
                          0.0, nbytes(key) + key.shape[0] * 4 + t * 8,
                          "fp32", exact)}))

    def compact_case(name, key, coords_T, cap, shift):
        hcap = min(cap, key.shape[0])
        hk, wk = TQ.build_and_lookup(key, hcap)
        hp, wp = TQ.build_and_lookup_plain(key, hcap)
        rows = torch.arange(key.shape[0], device=DEVICE, dtype=torch.int32)
        m = key.shape[0]
        # the remapped hash (each key's voxel id), and the input hash kept
        before = hk.vals.clone()
        ck = TV.voxel_compact(wk, coords_T, cap, shift, hk)
        cp = TV.voxel_compact_plain(wp, coords_T, cap, shift, hp)
        if not (torch.equal(TQ.lookup_hash(ck.hash, key),
                            TQ.lookup_hash_plain(cp.hash, key))
                and torch.equal(ck.hash.keys, hk.keys)
                and torch.equal(hk.vals, before)):
            raise SystemExit(f"voxel_compact [{name}]: the remapped hash "
                             "differs from the plain version's")
        ops, us = device_ops(lambda: TV.voxel_compact(wk, coords_T, cap,
                                                      shift, hk, shift == 1))
        print(f"voxel_compact [{name}]: one call puts {len(ops)} operations "
              f"on the card, {us:.1f} us of device time: {ops}", flush=True)
        if len(ops) > 2:
            raise SystemExit(f"voxel_compact [{name}]: {len(ops)} launches "
                             "in one call, at most 2 expected")
        cases.append(("voxel_compact", f"{name}; library: torch.cumsum of "
                      "the winner flags, the prefix sum alone, a part of "
                      "K8's work", {f32: (
            (lambda: TV.voxel_compact(wk, coords_T, cap, shift, hk,
                                      shift == 1),
             lambda: flat_compaction(TV.voxel_compact(
                 wk, coords_T, cap, shift, hk, shift == 1))),
            lambda: flat_compaction(TV.voxel_compact_plain(
                wp, coords_T, cap, shift, hp, shift == 1)),
            lambda: torch.cumsum((wk == rows).to(torch.int32), 0),
            0.0, nbytes(wk, coords_T) + 2 * nbytes(hk.vals)
            + m * 4 * (1 + shift) + cap * 17 + 4, "fp32", exact)}))

    def queries(lv, k):
        """(the level's sorted own keys, its k^3 x V query keys)"""
        v = lv.coords_T.shape[1]
        live = torch.arange(v, device=DEVICE) < lv.num_voxels
        sorted_keys = torch.sort(TK.pack_columns_u32(*lv.coords_T,
                                                     live)).values
        offs = torch.from_numpy(SC.kernel_offsets(k)).to(DEVICE)
        q = [lv.coords_T[d][None] + offs[:, d - 1][:, None] for d in (1, 2, 3)]
        return sorted_keys, TK.pack_columns_u32(
            lv.coords_T[0][None].expand_as(q[0]), *q,
            live[None].expand_as(q[0])).reshape(-1)

    def searchsorted_library(tables):
        """One ``torch.searchsorted`` over every table's queries: each
        level's keys lifted by its place in ``tables`` (33 bits up), so
        one sorted sequence holds them all."""
        keys, qs = [], []
        for li, (lv, k) in enumerate(tables):
            sk, qk = queries(lv, k)
            keys.append(sk + (li << 33))
            qs.append(qk + (li << 33))
        sorted_all, q_all = torch.cat(keys), torch.cat(qs)
        return lambda: torch.searchsorted(sorted_all, q_all)

    def table_bytes(tables):
        lvs = {id(lv): lv for lv, _ in tables}.values()
        return sum(nbytes(lv.coords_T, lv.hash.keys, lv.hash.vals) + 4
                   for lv in lvs) + sum(k ** 3 * lv.coords_T.shape[1] * 4
                                        for lv, k in tables)

    def flat(tables):
        return torch.cat([t.reshape(-1) for t in tables])

    def plan_case(pyramid):
        """Every table of the plan, one launch (and one memset)."""
        tables = [(pyramid[0], 5)] + [(lv, 3) for lv in pyramid]

        def built():
            k3, stem = SC.neighbor_tables(pyramid, 5)
            return flat([stem] + k3)

        ops, us = device_ops(lambda: SC.neighbor_tables(pyramid, 5))
        print(f"neighbor_tables [the headline plan]: one call puts "
              f"{len(ops)} operations on the card, {us:.1f} us of device "
              f"time: {ops}", flush=True)
        if len(ops) > 2:
            raise SystemExit(f"neighbor_tables: {len(ops)} launches in one "
                             "call, at most 2 expected (a memset, K7)")
        cases.append(("neighbor_table", "every table of the plan in one "
                      "launch: stem k5 (level 0's k3 table from its probes) "
                      f"+ k3 of {len(pyramid)} levels, caps "
                      f"{[lv.coords_T.shape[1] for lv in pyramid]}; library: "
                      "one searchsorted of every query", {f32: (
                          (lambda: SC.neighbor_tables(pyramid, 5), built),
                          lambda: flat([SC.neighbor_table_plain(
                              lv.coords_T, lv.num_voxels, k)
                              for lv, k in tables]),
                          searchsorted_library(tables), 0.0,
                          table_bytes(tables), "fp32", exact)}))

    def nbr_case(name, lv, k):
        """One table, one launch (as ``neighbor_table`` builds it)."""
        cases.append(("neighbor_table", f"{name}, one table", {f32: (
            lambda: SC.neighbor_table(lv, k),
            lambda: SC.neighbor_table_plain(lv.coords_T, lv.num_voxels, k),
            searchsorted_library([(lv, k)]), 0.0, table_bytes([(lv, k)]),
            "fp32", exact)}))

    hash_case("level 0, the points", key, min(v0, n))
    compact_case(f"voxelize {n} points -> V0 cap {v0}", key, cols, v0, 0)
    grid = TV.voxelize(bidx, shifted, valid, v0)
    b, x, y, z = grid.coords_T
    key1 = TK.pack_columns_u32(b, x >> 1, y >> 1, z >> 1, grid.valid)
    compact_case(f"downsample L0 -> L1 cap {level_caps[1]} (parent, kpos)",
                 key1, grid.coords_T, level_caps[1], 1)
    pyramid = SC.build_conv_plan(grid, 5, level_caps)
    for li in range(1, len(pyramid)):   # each downsample's hash
        b, x, y, z = pyramid[li - 1].coords_T
        hash_case(f"level {li}, level {li - 1}'s voxels",
                  TK.pack_columns_u32(b, x >> 1, y >> 1, z >> 1,
                                      pyramid[li - 1].valid),
                  min(level_caps[li], level_caps[li - 1]))
    plan_case(pyramid)
    nbr_case("stem k5, level 0", pyramid[0], 5)
    nbr_case("k3, level 0", pyramid[0], 3)
    return cases


# kernels whose sums have one fixed order: two calls must be bit-equal
BIT_EQUAL = ("gather_gemm_conv", "up_conv", "segment_mean_gather",
             "segment_grad")
# kernels whose CUDA-event time is mostly the wrapper's host dispatch (and
# K5): their profiled device time and operations are printed beside it
HOST_BOUND = ("coord_hash", "neighbor_table", "voxel_compact",
              "block_dilate", "segment_csr", "segment_grad")


def launch_floor():
    """(CUDA-event ms, profiled device ms) of one launch of an empty kernel
    through the same ctypes path as the kernels: the floor under a kernel
    of a few microseconds."""
    from segdino3d_tpu_torch.ops import cuda_build

    lib = cuda_build.library("neighbor_table")
    anchor = torch.empty(1, device=DEVICE)

    def empty():
        cuda_build.check(lib.empty_launch(cuda_build.stream_ptr(anchor)),
                         "empty_launch")

    return time_ms(empty), device_ops(empty)[1] / 1e3


def check_kernels(cases):
    """Compare, then time; returns per-kernel rows (headline = first case
    of each kernel, fp32) and the max error over each kernel's cases.  A
    case's ``per`` maps a dtype to (kernel_fn, plain_fn, library_fn, ops,
    bytes, peak) and optionally a tolerance relative to ``max |plain|``
    (a float: for long fp32 reductions; 0 for integer outputs, which must
    be equal) and a dict of further yardsticks {name: fn}, timed (CUDA
    events and profiled device time) and printed beside it.  ``kernel_fn`` may be a pair (timed, compared): the
    wrapper call alone, and the same call with what turns its outputs into
    one tensor to compare.  The outputs of K1, K2 and K3 must also be
    bit-equal between two calls (their sums have a fixed order)."""
    rows, floor = {}, None
    for kernel, name, per in cases:
        for dt, (kfn, pfn, lfn, ops, byts, peak, *opt) in per.items():
            rel = [o for o in opt if isinstance(o, float)]
            extra = next((o for o in opt if isinstance(o, dict)), {})
            kfn, cfn = kfn if isinstance(kfn, tuple) else (kfn, kfn)
            got, want = cfn(), pfn()
            if kernel in BIT_EQUAL and not torch.equal(got, cfn()):
                raise SystemExit(f"{kernel} [{name}] {dt}: two calls differ")
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            if rel:
                atol = rel[0] * float(want.float().abs().max())
                ok = err <= atol
                tol_text = "equal" if rel[0] == 0 else \
                    f"atol={rel[0]:g} x max|plain| = {atol:.3e}"
            else:
                tol = TOL[dt]
                ok = torch.allclose(got.float(), want.float(), rtol=tol,
                                    atol=tol)
                tol_text = f"rtol=atol={tol:g}"
            del got, want
            k_ms, p_ms, l_ms = time_ms(kfn), time_ms(pfn, 3), time_ms(lfn)
            extra_text = "".join(
                f", {k} {time_ms(fn, 3):.4f} ms (profiled device time "
                f"{device_ops(fn)[1] / 1e3:.4f} ms)" for k, fn in extra.items())
            if kernel in HOST_BOUND:
                launched, us = device_ops(kfn)
                if floor is None:
                    floor = launch_floor()
                extra_text += (f", profiled device time {us / 1e3:.4f} ms "
                               f"in {len(launched)} launches; an empty "
                               f"launch {floor[0]:.4f} ms (device "
                               f"{floor[1]:.4f} ms)")
            b_ms, b_by = bound(ops, byts, peak)
            dts = str(dt).replace("torch.", "")
            print(f"kernel {kernel} [{name}] {dts}: max_abs_err={err:.3e} "
                  f"({tol_text}) {'ok' if ok else 'MISMATCH'}; "
                  f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                  f"library {l_ms:.4f} ms{extra_text}, bound {b_ms:.4f} ms "
                  f"({b_by})", flush=True)
            if not ok:
                raise SystemExit(f"{kernel} [{name}] {dts} disagrees with "
                                 f"its plain version")
            row = rows.setdefault(kernel, dict(max_abs_err=0.0))
            if dt == torch.float32:
                row["max_abs_err"] = max(row["max_abs_err"], err)
                row.setdefault("headline", dict(
                    case=name, ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                    bound_ms=b_ms, bound_by=b_by))
    return rows


def to_ncdhw(x5):
    """(B, D, H, W, C) -> (B, C, D, H, W), contiguous."""
    return x5.permute(0, 4, 1, 2, 3).contiguous()


def dense_cases(plan, gen):
    """K9, K10 and K11 on the block tables of the flagship eval plan (the
    hybrid layout; the training plan's are the same tables), at the main
    path's shapes.  Bytes count each input once and each output once; the
    conv's operations count the pairs (output cell, offset) whose source
    cell is occupied, over the occupied output cells (over every cell in
    the dX role, which has no output mask), as this scene needs them.  The
    case name carries the occupied share of the occupied blocks' cells and
    the bound of the dense work the kernel does."""
    import torch.nn.functional as F

    from segdino3d_tpu_torch.ops import block_dense as BD

    f32, exact = torch.float32, 0.0
    cases = []
    t0, t3 = plan.blocks[0], plan.blocks[3]

    def fill(t):
        return block_fill(t)[2]   # the occupied blocks' occupied share

    def pairs(t, k, masked):
        """(pairs the conv needs, every (cell, offset) pair)"""
        occ = BD.occupancy(t)
        ones = torch.ones(k ** 3, 1, 1, device=DEVICE)
        hits = BD.dense_subm_conv_plain(occ.float()[:, None], t.block_nbr,
                                        ones, None, t.edge)[:, 0]
        return (float(hits[occ].sum() if masked else hits.sum()),
                float(occ.shape[0] * k ** 3))

    def gather_case(x, idx):
        n_ref = int((idx >= 0).sum())
        xp = torch.cat([x, x.new_zeros(1, x.shape[1])])
        il = torch.where(idx < 0, x.shape[0], idx).long()
        return (lambda: BD.slot_gather(x, idx),
                lambda: BD.slot_gather_plain(x, idx),
                lambda: torch.index_select(xp, 0, il), 0.0,
                n_ref * x.shape[1] * x.element_size() + nbytes(idx)
                + idx.shape[0] * x.shape[1] * x.element_size(), "fp32",
                exact)

    v0 = plan.levels[0].valid.shape[0]
    for direction in ("enter", "exit"):
        per = {}
        for dt in (torch.float32, torch.bfloat16):
            if direction == "enter":
                x = torch.where(plan.levels[0].valid[:, None],
                                _randn(gen, (v0, 96), dt), 0.0)
                per[dt] = gather_case(x, t0.slot_vox)
            else:
                x = torch.where(BD.occupancy(t0)[:, None],
                                _randn(gen, (t0.slot_vox.shape[0], 96), dt),
                                0.0)
                per[dt] = gather_case(x, t0.vox_slot)
        what = ("voxels (V0,96) -> dense rows (B0*64,96), through slot_vox"
                if direction == "enter" else
                "dense rows (B0*64,96) -> voxels (V0,96), through vox_slot")
        cases.append(("slot_gather", f"{what}, fill {fill(t0):.1%}", per))

    def conv_case(name, t, cin, cout, k, dtypes, dx=False):
        """The forward under the occupancy mask, or (``dx``) the input
        gradient's role: flipped, transposed weights on an input that is
        zero outside the occupancy, under the occupancy's k-dilation as
        the backward runs it, held to the plain version without a mask on
        every cell."""
        occ = BD.occupancy(t)
        # the level's cached list of the mask, as the autograd Function
        # passes it: the dilation's (dX) or the occupancy's
        mask, rlist = BD.dilated_rows(occ, t.block_nbr, t.edge, k) if dx \
            else (occ, BD.row_list(t, occ))
        need, dense = pairs(t, k, masked=not dx)
        rows = int(mask.sum())
        per = {}
        for dt in dtypes:
            x = torch.where(occ[:, None],
                            _randn(gen, (occ.shape[0], cin), dt), 0.0)
            w = _randn(gen, (k ** 3, cin, cout), dt, (k ** 3 * cin) ** -0.5)
            h = (k - 1) // 2
            b, e = t.num_blocks, t.edge
            wc = w.reshape(k, k, k, cin, cout).permute(4, 3, 0, 1, 2
                                                       ).contiguous()
            padded = to_ncdhw(BD.halo_pad_plain(x.reshape(b, e, e, e, cin),
                                                t.block_nbr, h))

            def lib(x=x, wc=wc, b=b, e=e, h=h):
                p = to_ncdhw(BD.halo_pad_plain(x.reshape(b, e, e, e, cin),
                                               t.block_nbr, h))
                return F.conv3d(p, wc)

            if dx:
                twice = [BD.block_conv(x, t.block_nbr, w, mask, e, rlist)
                         for _ in range(2)]
                per_call = BD.block_conv(x, t.block_nbr, w, mask, e)
                if not (torch.equal(*twice) and torch.equal(twice[0],
                                                            per_call)):
                    raise SystemExit(f"block_conv [{name}] {dt}: two calls "
                                     "on one cached dilation list differ "
                                     "from each other or from the per-call "
                                     "list")
                print(f"block_conv [{name}] {dt}: two calls on one cached "
                      "dilation list bit-equal to each other and to the "
                      "per-call list's", flush=True)
                del twice, per_call
            per[dt] = (lambda x=x, w=w: BD.block_conv(
                           x, t.block_nbr, w, mask, e, rlist),
                       lambda x=x, w=w: BD.dense_subm_conv_plain(
                           x, t.block_nbr, w, None if dx else occ, e),
                       lib, 2.0 * need * cin * cout,
                       nbytes(x, t.block_nbr, w, mask)
                       + occ.shape[0] * cout * x.element_size(),
                       CONV_PEAK[dt],
                       {"library without the halo assembly (conv3d alone)":
                        lambda p=padded, wc=wc: F.conv3d(p, wc)})
        ops, us = device_ops(per[dtypes[0]][0])
        print(f"block_conv [{name}]: one call puts {len(ops)} operations on "
              f"the card, {us:.1f} us of device time: {ops}", flush=True)
        dense_ms = bound(2.0 * dense * cin * cout, 0.0, "fp32")[0]
        rows_ms = bound(2.0 * rows * k ** 3 * cin * cout, 0.0, "fp32")[0]
        what = (f"dilation {rows} rows = {rows / occ.shape[0]:.1%} of the "
                f"cells, {rows / int(occ.sum()):.2f}x the occupied"
                if dx else f"{rows} occupied rows")
        cases.append(("block_conv", f"{name}, fill {fill(t):.1%}, {what}; "
                      f"bound of its rows' work {rows_ms:.4f} ms, "
                      f"dense-work bound {dense_ms:.4f} ms (fp32)", per))

    def dilate_case(t, k):
        """The dilation and its row list (one pass and the list pass),
        held to the plain dilation and its occupied rows."""
        occ = BD.occupancy(t)
        b, e, h = t.num_blocks, t.edge, (k - 1) // 2
        n = occ.shape[0]
        padded = BD.halo_pad_plain(occ.float().reshape(b, e, e, e, 1),
                                   t.block_nbr, h)[..., 0][:, None]

        def flat(mask, rows):
            listed = torch.where(torch.arange(n, device=DEVICE)
                                 < rows.count, rows.rows, -1)
            return torch.cat([mask.to(torch.int32), listed,
                              rows.count.reshape(1).to(torch.int32)])

        n_listed = int(BD.occupancy_dilation_plain(occ, t.block_nbr, e,
                                                   k).sum())

        def plain():
            m = BD.occupancy_dilation_plain(occ, t.block_nbr, e, k)
            return flat(m, BD.RowList(*BD.occupied_rows_plain(m), None))

        cases.append(("block_dilate", f"k{k} dilation of the L0 occupancy "
                      f"and its row list, {n} cells; library: max_pool3d of "
                      "the halo-padded occupancy", {f32: (
                          (lambda: BD.dilated_rows(occ, t.block_nbr, e, k),
                           lambda: flat(*BD.dilated_rows(occ, t.block_nbr,
                                                         e, k))),
                          plain, lambda: F.max_pool3d(padded, k, stride=1),
                          0.0, nbytes(occ, t.block_nbr) + n + 4 * n_listed
                          + 4, "fp32", exact)}))

    both = (torch.float32, torch.bfloat16)
    conv_case("k3 96->96 L0", t0, 96, 96, 3, both)
    conv_case("k3 384->256 L3", t3, 384, 256, 3, both)
    conv_case("dense stem k5 259->32 L0", t0, 259, 32, 5, both)
    conv_case("dX k3 96->96 L0 (flipped, transposed W, under the "
              "dilation)", t0, 96, 96, 3, (f32,), dx=True)
    dilate_case(t0, 3)

    def all_pairs(t, k):
        """(occupied cell, offset) pairs whose source block exists: the
        pairs K11's contract reduces"""
        r = torch.nonzero(BD.occupancy(t)).flatten()
        h = (k - 1) // 2
        return float(sum(int((BD.halo_rows_plain(r, t.block_nbr, t.edge,
                                                 s) >= 0).sum())
                         for s in itertools.product(range(-h, h + 1),
                                                    repeat=3)))

    def wgrad_case(name, t, cin, cout, k):
        occ = BD.occupancy(t)
        need, dense = pairs(t, k, masked=True)
        every = all_pairs(t, k)
        x = torch.where(occ[:, None], _randn(gen, (occ.shape[0], cin), f32),
                        0.0)
        dy = torch.where(occ[:, None],
                         _randn(gen, (occ.shape[0], cout), f32), 0.0)
        b, e, h = t.num_blocks, t.edge, (k - 1) // 2

        def lib():
            p = to_ncdhw(BD.halo_pad_plain(x.reshape(b, e, e, e, cin),
                                           t.block_nbr, h))
            return torch.nn.grad.conv3d_weight(
                p, (cout, cin, k, k, k), to_ncdhw(dy.reshape(b, e, e, e,
                                                             cout)))

        dense_ms = bound(2.0 * dense * cin * cout, 0.0, "fp32")[0]
        all_ms = bound(2.0 * every * cin * cout, 0.0, "fp32")[0]
        live_ms = bound(2.0 * need * cin * cout, 0.0, "fp32")[0]
        cases.append(("block_wgrad", f"{name}, fill {fill(t):.1%}, "
                      f"{int(every)} pairs with a source block (all-pairs "
                      f"bound {all_ms:.4f} ms), {int(need)} with an occupied "
                      f"source (live-pair bound {live_ms:.4f} ms), dense-work "
                      f"bound {dense_ms:.4f} ms (fp32)", {f32: (
                          lambda: BD.block_wgrad(x, dy, t.block_nbr, occ, e,
                                                 k, BD.row_list(t, occ)),
                          lambda: BD.block_wgrad_plain(x, dy, t.block_nbr,
                                                       occ, e, k),
                          lib, 2.0 * need * cin * cout,
                          nbytes(x, dy, t.block_nbr, occ)
                          + k ** 3 * cin * cout * 4, "fp32", WGRAD_TOL,
                          {"row list build (block_rows, once per level and "
                           "step)": lambda: BD.occupied_rows(occ)})}))

    wgrad_case("dW k3 96->96 L0", t0, 96, 96, 3)
    wgrad_case("stem dW k5 259->32 L0", t0, 259, 32, 5)
    return cases


def stem_library(y2, slots, ov_src, ov_dst, valid):
    """Yardstick for K12: ``index_select`` of every slot row, a sum over
    the slots, ``index_add_`` of the overflow rows, the mask."""
    d, v = slots.shape
    rows = y2.index_select(0, slots.clamp(min=0).reshape(-1).long())
    acc = torch.where((slots >= 0).reshape(-1, 1), rows.float(), 0.0)
    acc = acc.view(d, v, -1).sum(0)
    ov = acc.new_zeros(v + 1, acc.shape[1]).index_add_(
        0, ov_dst.long(), torch.where(
            (ov_src >= 0)[:, None],
            y2.index_select(0, ov_src.clamp(min=0).long()).float(), 0.0))
    return torch.where(valid[:, None], acc + ov[:v], 0.0).to(y2.dtype)


def stem_compact_cases(records, spec, gen):
    """K12 on the headline scene's compacted-stem tables at the level-0 cap
    of the main path, with D = 32 (the default) and D = 8 (most pairs in
    the overflow), fp32 and bf16, over a (V0 * 125, 32) product table.
    Bytes: the occupied slot rows and overflow rows, the slot table, the
    overflow pairs, the mask and the output; operations: one add per
    gathered element.  The wide product alone (the stem's matmul,
    259 -> 125 x 32, ``torch.matmul``, TF32 off) is timed beside it."""
    from segdino3d_tpu_torch.data.collate import attach_host_plan, collate
    from segdino3d_tpu_torch.ops import sparse_conv as SC

    cases = []
    for d in (32, 8):
        plan = attach_host_plan(
            collate(records, spec, DEVICE), records, spec,
            level_cap_ratios=LEVEL_CAP_RATIOS, voxel_size=0.02,
            stem_compact=True, stem_compact_slots=d).plan
        slots, ov_src, ov_dst = plan.stem_compact
        valid = plan.levels[0].valid
        v = valid.shape[0]
        n_rows = int((slots >= 0).sum()) + int((ov_src >= 0).sum())
        per, mm = {}, {}
        for dt in (torch.float32, torch.bfloat16):
            y2 = _randn(gen, (v * 125, 32), dt)
            x = _randn(gen, (v, 259), dt)
            w = _randn(gen, (259, 125 * 32), dt, 259 ** -0.5)
            mm[CONV_PEAK[dt]] = bound(2.0 * v * 259 * 125 * 32,
                                      nbytes(x, w, y2), CONV_PEAK[dt])
            per[dt] = (
                lambda y2=y2: SC.stem_slot_sum(y2, slots, ov_src, ov_dst,
                                               valid),
                lambda y2=y2: SC.stem_slot_sum_plain(y2, slots, ov_src,
                                                     ov_dst, valid),
                lambda y2=y2: stem_library(y2, slots, ov_src, ov_dst, valid),
                float(n_rows * 32),
                n_rows * 32 * y2.element_size()
                + nbytes(slots, ov_src, ov_dst, valid)
                + v * 32 * y2.element_size(), "fp32",
                {"wide matmul 259->4000": lambda x=x, w=w: x @ w})
        print(f"compacted stem D={d}: {int((slots >= 0).sum())} slot pairs, "
              f"{int((ov_src >= 0).sum())} overflow pairs of "
              f"{ov_src.shape[0]}, V0 cap {v}; the wide matmul's bound "
              + ", ".join(f"{k} {t:.4f} ms ({by})" for k, (t, by)
                          in mm.items()), flush=True)
        cases.append(("stem_slot_sum", f"D={d} slot sum ({v}*125, 32)", per))
    return cases


# --------------------------------------------------------------------------
# phase 3: the main path
# --------------------------------------------------------------------------

def make_records():
    from segdino3d_tpu_torch.data.synthetic import synthetic_scene

    rec = synthetic_scene(0, **SCENE)
    # production loaders read DINO-X features as fp16
    rec["points_2dfeats"] = rec["points_2dfeats"].astype(np.float16)
    return [rec]


def counters():
    """{kernel: its wrappers}; a kernel's launches are its wrappers' sum."""
    from segdino3d_tpu_torch.ops import block_dense as BD
    from segdino3d_tpu_torch.ops import hashing as TQ
    from segdino3d_tpu_torch.ops import scatter as SS
    from segdino3d_tpu_torch.ops import sparse_conv as SC
    from segdino3d_tpu_torch.ops import voxelize as TV

    return {"gather_gemm_conv": (SC.gather_conv,),
            "up_conv": (SC.up_conv_rows,),
            "segment_mean_gather": (SS.segment_mean_gather,),
            # the CSR of K3's segments (two launches around torch.sort),
            # one per segment set and forward
            "segment_csr": (SS.segment_csr,),
            "gather_wgrad": (SC.gather_wgrad,),
            "segment_grad": (SS.segment_grad,),
            "coord_hash": (TQ.build_and_lookup, TQ.lookup_hash),
            "neighbor_table": (SC.neighbor_table, SC.neighbor_tables),
            "voxel_compact": (TV.voxel_compact,),
            "slot_gather": (BD.slot_gather,),
            "block_conv": (BD.block_conv,),
            "block_dilate": (BD.dilated_rows,),
            "block_wgrad": (BD.block_wgrad,),
            "stem_slot_sum": (SC.stem_slot_sum,),
            # the pair lists (K1 and K4) and row lists (K11), built once per
            # table or level and forward or step; they launch in K4's and
            # K10's libraries
            "gather_pairs": (SC.gather_pairs,),
            "block_rows": (BD.occupied_rows,)}


# the pair lists of K1 and K4 in a gather-layout forward or step: the
# stem's table, each level's k3 table and each child table (one list for
# K1's down conv and up conv dX and K4's dW of both)
GATHER_PAIR_LISTS = 10


def step_kernel_ms(run):
    """Device ms of K1 (its products and sums; the pair lists it shares with
    K4 apart), K4 (its tiles and split sums; its pair lists apart) and K11
    (the same; its row lists are K10's row-list kernels and are not told
    apart from K10's own), and of all device work, in one call of ``run``
    (one training step), by ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return kernel_ms(prof.events())


def kernel_ms(events):
    """{K1, K2, K3, K4, K4 pair lists, K11, device}: summed device ms of
    ``events``; and the count of K10's row-list launches."""
    ms = dict.fromkeys(("K1", "K2", "K3", "K4", "K4 pair lists", "K11",
                        "device"), 0.0)
    ms["row-list launches"] = 0
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n, t = e.name, e.time_range.elapsed_us() / 1e3
        ms["device"] += t
        # K10's row lists: the count and list passes and the dilation
        ms["row-list launches"] += any(
            f in n for f in ("count_rows_kernel", "list_rows_kernel",
                             "dilate_kernel"))
        if "conv_products_kernel" in n or "conv_pair_sum_kernel" in n:
            ms["K1"] += t
        elif "up_conv_kernel" in n:
            ms["K2"] += t
        elif "segment_mean_kernel" in n:
            ms["K3"] += t
        elif "gather_wgrad_kernel" in n or ("sum_splits" in n and
                                          "ListPairs" in n):
            ms["K4"] += t
        elif "count_pairs_kernel" in n or "list_pairs_kernel" in n:
            ms["K4 pair lists"] += t
        elif "block_wgrad_kernel" in n or ("sum_splits" in n and
                                           "HaloPairs" in n):
            ms["K11"] += t
    return ms


def concat_shapes(run):
    """The output shapes of every ``aten::cat`` that ``run()`` dispatches
    (the profiler records no shapes of a tensor list)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Cats(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.shapes = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket is torch.ops.aten.cat:
                self.shapes.append(tuple(out.shape))
            return out

    with Cats() as mode:
        run()
    return mode.shapes


def forward_device_ms(model, batch):
    """({K1, K2, K3, device} ms of one eval forward, backbone and decoder,
    by ``torch.profiler``; the (N, 259) concatenations of one more, the
    early-fused point features the forward no longer builds)."""
    from torch.profiler import ProfilerActivity, profile

    def forward():
        with torch.no_grad():
            model.decode(batch, model.backbone(batch))
        torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        forward()
    n = batch.points.shape[0] * batch.points.shape[1]
    return kernel_ms(prof.events()), [
        sh for sh in concat_shapes(forward) if sh == (n, 259)]


# the kernels of the gather layout's training step on device plans
GATHER_STEP_KERNELS = ("gather_gemm_conv", "up_conv", "segment_mean_gather",
                       "gather_wgrad", "segment_grad", "coord_hash",
                       "neighbor_table", "voxel_compact")


def reset_counts():
    for fns in counters().values():
        for fn in fns:
            fn.launches = 0


def read_counts():
    return {k: sum(fn.launches for fn in fns)
            for k, fns in counters().items()}


def run_main_path(model, test_cfg, records, spec, device_plan=False,
                  layout="gather"):
    """The eval path on host plans of ``layout`` (``plan_layout``); with
    ``device_plan`` the batch carries no host plan and the backbone builds
    it on the card ("plan" is then the collate alone, and the backbone
    stage holds the device plan)."""
    from segdino3d_tpu_torch.data.collate import (attach_host_plan, collate,
                                                  eval_annotation)
    from segdino3d_tpu_torch.evaluation.evaluate import (host_prediction,
                                                         postprocess)
    from segdino3d_tpu_torch.data.scannet_constants import (
        SCANNET200_CLASS_NAMES, SCANNET200_RAW_IDS)
    from segdino3d_tpu_torch.evaluation.evaluator import InstanceSeg3DEvaluator

    evaluator = InstanceSeg3DEvaluator(SCANNET200_RAW_IDS,
                                       SCANNET200_CLASS_NAMES)
    plan_args = plan_layout(layout)

    def once():
        t = {}
        t0 = time.perf_counter()
        batch = collate(records, spec, DEVICE)
        if not device_plan:
            batch = attach_host_plan(batch, records, spec,
                                     level_cap_ratios=LEVEL_CAP_RATIOS,
                                     **plan_args)
        torch.cuda.synchronize()
        t["plan"] = time.perf_counter() - t0
        with torch.no_grad():
            t0 = time.perf_counter()
            bb = model.backbone(batch)
            torch.cuda.synchronize()
            t["backbone"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out = model.decode(batch, bb)
            torch.cuda.synchronize()
            t["decoder"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            res = postprocess(out, batch, test_cfg)
            torch.cuda.synchronize()
            t["postprocess"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        evaluator.reset()
        for record, r in zip(records, res):
            evaluator.process(eval_annotation(record), host_prediction(
                record, *r, plan_overflow=out["plan_overflow"]))
        metrics = evaluator.evaluate()
        t["ap_eval"] = time.perf_counter() - t0
        return t, batch, bb, out, res, metrics

    once()                                   # warm-up
    reset_counts()
    t, batch, bb, out, res, metrics = once()
    launches = read_counts()

    torch.cuda.reset_peak_memory_stats()
    times = [once()[0] for _ in range(TIMED_ITERS)]
    peak = torch.cuda.max_memory_allocated()
    return launches, times, peak, batch, bb, out, res, metrics


def check_outputs(bb, out, res, s_cap):
    checks = {"sp_feats": bb.sp_feats, "cls_preds": out["cls_preds"],
              "masks": out["masks"], "sem_preds": out["sem_preds"],
              "centers": out["centers"], "sizes": out["sizes"]}
    shapes = {"sp_feats": (1, s_cap, 96), "cls_preds": (1, s_cap, 199),
              "masks": (1, s_cap, s_cap), "sem_preds": (1, s_cap, 201),
              "centers": (1, s_cap, 3), "sizes": (1, s_cap, 3)}
    for k, v in checks.items():
        if tuple(v.shape) != shapes[k]:
            raise SystemExit(f"{k}: shape {tuple(v.shape)} != {shapes[k]}")
        if not bool(torch.isfinite(v).all()):
            raise SystemExit(f"{k}: non-finite values")
    inst = res[0][0]
    if not bool(torch.isfinite(inst.scores).all()):
        raise SystemExit("instance scores: non-finite values")
    print(f"outputs finite; {int(inst.valid.sum())} instances kept of "
          f"{inst.valid.shape[0]}", flush=True)


def check_small_reference(model, plans=("host", "device")):
    """The card's forward (kernels) against the CPU's plain path, same
    weights, on a small scene, on a host plan and on a device plan (K6-K8
    on the card; the device plan's capacity is the scene's point count),
    at rtol = atol = 1e-3, and on a hybrid host plan ("hybrid", K9 and
    K10) or one with the compacted stem ("compact", K12) at 1e-4.
    Compared before any attention threshold: the superpoint features and
    the first head's class and mask logits."""
    from segdino3d_tpu_torch.data.collate import PadSpec, attach_host_plan, \
        collate
    from segdino3d_tpu_torch.data.synthetic import synthetic_scene

    rec = [synthetic_scene(1, n_points=4000, n_instances=6, n_superpoints=128,
                           n_classes=180, feat_dim_2d=256)]
    spec = PadSpec(4096, SCENE["n_superpoints"], 16, 16, 200)
    cpu_model = copy.deepcopy(model).cpu()
    cpu_model.backbone.voxel_cap = None
    card_cap, model.backbone.voxel_cap = model.backbone.voxel_cap, None
    try:
        for plan in plans:
            outs = {}
            tol = 1e-4 if plan in ("hybrid", "compact") else 1e-3
            for dev, m in ((DEVICE, model), ("cpu", cpu_model)):
                batch = collate(rec, spec, dev)
                if plan != "device":
                    batch = attach_host_plan(batch, rec, spec, **plan_layout(
                        "gather" if plan == "host" else plan))
                with torch.no_grad():
                    bb = m.backbone(batch)
                    o = m.decode(batch, bb)
                outs[dev] = dict(sp_feats=bb.sp_feats,
                                 cls0=o["aux_outputs"][0]["cls_preds"],
                                 mask0=o["aux_outputs"][0]["masks"])
            for k in outs["cpu"]:
                a, b = outs[DEVICE][k].cpu(), outs["cpu"][k]
                err = float((a - b).abs().max())
                ok = torch.allclose(a, b, rtol=tol, atol=tol)
                print(f"small-scene reference, {plan} plan, {k}: "
                      f"max_abs_err={err:.3e} (rtol=atol={tol:g}) "
                      f"{'ok' if ok else 'MISMATCH'}", flush=True)
                if not ok:
                    raise SystemExit(f"card forward disagrees with the CPU "
                                     f"on {k} ({plan} plan)")
    finally:
        model.backbone.voxel_cap = card_cap


# --------------------------------------------------------------------------
# phase 3b: the eval path on a plan built on the card
# --------------------------------------------------------------------------

PLAN_FIELDS = ("nbr", "parent", "kpos", "child", "up_order")


def compare_plans(dev, host):
    """Every table of the device plan against the host plan's, on valid
    rows (the neighbour ids themselves are compared whole); returns the
    number of tables whose full arrays are equal too."""
    def same(a, b, what):
        if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
            raise SystemExit(f"device plan differs from the host plan: {what}")

    same(dev.inverse, host.inverse, "inverse")
    same(dev.stem_nbr[:, host.levels[0].valid],
         host.stem_nbr[:, host.levels[0].valid], "stem_nbr")
    whole = int(torch.equal(dev.stem_nbr, host.stem_nbr))
    for li, (d, h) in enumerate(zip(dev.levels, host.levels)):
        same(d.valid, h.valid, f"level {li} valid")
        for k in PLAN_FIELDS:
            a, b = getattr(d, k), getattr(h, k)
            if b is None:
                if a is not None:
                    raise SystemExit(f"level {li} {k}: not in the host plan")
                continue
            if k in ("parent", "kpos"):
                a, b = a[h.valid], b[h.valid]
            elif k == "nbr":
                a, b = a[:, h.valid], b[:, h.valid]
            elif k == "child":
                cv = host.levels[li + 1].valid
                a, b = a[:, cv], b[:, cv]
            elif k == "up_order":
                n = int(h.valid.sum())
                a, b = a[:n], b[:n]
            same(a, b, f"level {li} {k}")
            whole += int(torch.equal(getattr(d, k), getattr(h, k)))
    return whole


def run_device_plan_path(model, test_cfg, records, spec, host_batch, host_bb,
                         host_out):
    """Phase 3b: tables, the plan's time beside the host plan's, then the
    eval path on device plans."""
    from segdino3d_tpu_torch.data.collate import attach_host_plan, collate

    bare = collate(records, spec, DEVICE)
    coords = bare.points.reshape(-1, 6)[:, :3] / torch.full(
        (), 0.02, device=DEVICE)
    plan, overflow = model.backbone.device_plan(coords, bare.point_valid)
    torch.cuda.synchronize()
    if bool(overflow):
        raise SystemExit("device plan overflowed at the host plan's caps")
    whole = compare_plans(plan, host_batch.plan)
    n_tables = 2 + sum(getattr(lv, k) is not None for lv in plan.levels
                       for k in PLAN_FIELDS)
    print(f"device plan equals the host plan on every valid row (inverse, "
          f"stem_nbr, each level's valid/nbr/parent/kpos/child/up_order; "
          f"{whole} of {n_tables - 1} tables equal whole)", flush=True)

    def device():
        model.backbone.device_plan(coords, bare.point_valid)

    def host():
        attach_host_plan(bare, records, spec, voxel_size=0.02,
                         level_cap_ratios=LEVEL_CAP_RATIOS)

    plan_ms = {}
    for fn in (device, host):
        fn()
        torch.cuda.synchronize()
    for _ in range(TIMED_ITERS):
        for name, fn in (("device", device), ("host", host)):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            plan_ms.setdefault(name, []).append(
                1e3 * (time.perf_counter() - t0))
    dev_ms = time_ms(device, reps=TIMED_ITERS)
    print(f"plan alone, mean of {TIMED_ITERS} (host clock, synchronised): "
          f"device {float(np.mean(plan_ms['device'])):.3f} ms "
          f"(CUDA events {dev_ms:.3f} ms), host (C++ plan + copies) "
          f"{float(np.mean(plan_ms['host'])):.3f} ms", flush=True)

    launches, times, peak, batch, bb, out, res, metrics = run_main_path(
        model, test_cfg, records, spec, device_plan=True)
    if batch.plan is not None:
        raise SystemExit("the device-plan run got a host plan")
    # coord_hash: one build-and-lookup launch a level (voxelize and four
    # downsamples)
    expected = {"gather_gemm_conv": 51, "up_conv": 4, "segment_mean_gather": 2,
                "coord_hash": 5, "voxel_compact": 5, "neighbor_table": 1}
    print(f"launches in one forward on a device plan: {launches} (expected "
          f"{expected})", flush=True)
    for k, n in expected.items():
        if launches[k] < n or (k != "gather_gemm_conv" and launches[k] != n):
            raise SystemExit(f"{k}: {launches[k]} launches on the device "
                             f"plan path, expected {n}")
    pairs = {"sp_feats": (bb.sp_feats, host_bb.sp_feats)}
    pairs.update({k: (out[k], host_out[k]) for k in
                  ("cls_preds", "masks", "sem_preds", "centers", "sizes")})
    for k, (a, b) in pairs.items():
        err = float((a - b).abs().max())
        ok = torch.allclose(a, b, rtol=1e-5, atol=1e-5)
        print(f"device-plan forward vs host-plan forward {k}: "
              f"max_abs_err={err:.3e} (rtol=atol=1e-5) "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            raise SystemExit(f"device-plan forward disagrees on {k}")
    check_outputs(bb, out, res, SCENE["n_superpoints"])
    stages = {k: 1e3 * float(np.mean([t[k] for t in times]))
              for k in times[0]}
    total = [sum(t.values()) for t in times]
    print(f"main path on device plans: {1.0 / float(np.mean(total)):.3f} "
          f"scenes/s over {TIMED_ITERS} iterations (batch 1, fp32); ms per "
          f"stage " + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
          + f" (plan = collate only; the backbone builds the plan); total "
          f"{1e3 * float(np.mean(total)):.2f} ms; peak "
          f"{peak / 2 ** 30:.3f} GiB", flush=True)
    return launches


# --------------------------------------------------------------------------
# phase 4: the training path
# --------------------------------------------------------------------------

def numpy_queries(num_superpoints, s_cap, seed):
    """A query selection made with numpy, so the card and the CPU train on
    the same queries: valid superpoints in a seeded random order, the
    first floor((0.5 + 0.5 u) * n_valid) valid (``query_thr`` 0.5)."""
    rng = np.random.RandomState(seed)
    n = np.asarray(num_superpoints)
    valid = np.arange(s_cap)[None, :] < n[:, None]
    noise = np.where(valid, rng.rand(len(n), s_cap), 2.0)
    order = np.argsort(noise, axis=-1, kind="stable").astype(np.int32)
    n_sel = np.floor((0.5 + 0.5 * rng.rand(len(n))) * n).astype(np.int32)
    return (torch.from_numpy(order),
            torch.from_numpy(np.arange(s_cap)[None, :] < n_sel[:, None]))


def make_train_step(model, accum_steps, ema=True):
    from segdino3d_tpu_torch.builder import build_criterion
    from segdino3d_tpu_torch.parallel.train_step import TrainStep
    from segdino3d_tpu_torch.train.ema import EMA
    from segdino3d_tpu_torch.train.optim import build_optimizer

    opt = build_optimizer(model.named_parameters(), OPTIMIZER, SCHEDULER,
                          clip_max_norm=CLIP_MAX_NORM)
    return TrainStep(model, build_criterion(train_cfg()), opt,
                     EMA(model.named_parameters(), EMA_DECAY) if ema
                     else None, accum_steps=accum_steps)


def check_metrics(step, metrics, what):
    """The step's metrics on the host (``TrainStep.host_metrics``: one copy,
    raising on a device plan's overflow), all finite."""
    vals = step.host_metrics(metrics)
    bad = [k for k, v in vals.items() if not np.isfinite(v)]
    if bad:
        raise SystemExit(f"{what}: non-finite {bad}: {vals}")
    return vals


def run_training(model, records, spec, layout="gather", accum=True):
    """A warm-up and TRAIN_STEPS measured batch-1 steps on host plans of
    ``layout`` (``plan_layout``), then (with ``accum``) one accum_steps=4
    step over four scenes.  Returns (launches in one batch-1 step, per-step stage seconds,
    the accumulated step's stage seconds and launches or None, peak bytes,
    metrics)."""
    from segdino3d_tpu_torch.data.collate import attach_host_plan, collate
    from segdino3d_tpu_torch.parallel.train_step import StageClock, TrainStep

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    step1 = make_train_step(model, 1)
    # the accumulated step continues the run: one optimizer and EMA
    step4 = TrainStep(model, step1.criterion, step1.optimizer, step1.ema,
                      accum_steps=4)
    plan_args = plan_layout(layout)

    def plan(rec):
        t0 = time.perf_counter()
        b = attach_host_plan(collate([rec], spec, DEVICE), [rec], spec,
                             level_cap_ratios=LEVEL_CAP_RATIOS, **plan_args)
        torch.cuda.synchronize()
        return b, time.perf_counter() - t0

    b, _ = plan(records[0])
    check_metrics(step1, step1([b], generator=gen), "warm-up step")
    torch.cuda.reset_peak_memory_stats()
    steps, launches, metrics = [], None, []
    for i in range(TRAIN_STEPS):
        b, t_plan = plan(records[i % len(records)])
        clock = StageClock(torch.cuda.synchronize)
        reset_counts()
        m = step1([b], generator=gen, clock=clock)
        if launches is None:
            launches = read_counts()
        metrics.append(check_metrics(step1, m, f"batch-1 step {i}"))
        steps.append(dict(plan=t_plan, **clock.seconds))
    # a fresh plan, so that the step builds its pair and row lists
    from segdino3d_tpu_torch.ops import block_dense as BD

    b, _ = plan(records[0])
    BD.block_conv.own_lists = 0
    ms = step_kernel_ms(lambda: step1([b], generator=gen))
    print(f"K1-K3 and the weight gradients in one batch-1 {layout} step "
          f"(torch.profiler, device ms): K1 {ms['K1']:.4f}, K2 "
          f"{ms['K2']:.4f}, K3 {ms['K3']:.4f}, K4 {ms['K4']:.4f} "
          f"(+ pair lists {ms['K4 pair lists']:.4f}), K11 {ms['K11']:.4f}, "
          f"of {ms['device']:.4f} ms of device work; K10's row-list "
          f"launches {ms['row-list launches']} (two per level's occupancy "
          f"and dilation list, none inside a conv)", flush=True)
    if BD.block_conv.own_lists:
        raise SystemExit(f"{BD.block_conv.own_lists} K10 calls built their "
                         "own row list in a step: every conv should take its "
                         "level's cached list")
    if not accum:
        return (launches, steps, None, None,
                torch.cuda.max_memory_allocated(), metrics)
    mbs, t_plan = [], 0.0
    for rec in records:
        b, t = plan(rec)
        mbs.append(b)
        t_plan += t
    clock = StageClock(torch.cuda.synchronize)
    reset_counts()
    m4 = step4(mbs, generator=gen, clock=clock)
    launches4 = read_counts()
    metrics.append(check_metrics(step4, m4, "accum_steps=4 step"))
    accum = dict(plan=t_plan, **clock.seconds)
    return (launches, steps, accum, launches4,
            torch.cuda.max_memory_allocated(), metrics)


def check_small_train(model, layout="gather"):
    """One train step of the card (kernels) against the CPU's plain path,
    same weights and queries, on a small sparse scene (500 points per m^2,
    so every U-Net level keeps enough voxels for well-conditioned batch
    norms), on host plans of ``layout``: the losses and the gradient
    norm (rtol 1e-4), and each leaf's clipped gradient norm (rtol 1e-3,
    atol 1e-3 x the largest)."""
    from segdino3d_tpu_torch.data.collate import PadSpec, attach_host_plan, \
        collate
    from segdino3d_tpu_torch.data.synthetic import synthetic_scene

    rec = [synthetic_scene(1, n_points=4000, n_instances=6, n_superpoints=128,
                           n_classes=180, feat_dim_2d=256,
                           point_density=500.0)]
    spec = PadSpec(4096, SCENE["n_superpoints"], 16, 16, 200)
    out = {}
    for dev in (DEVICE, "cpu"):
        m = copy.deepcopy(model).to(dev)
        # sparse levels keep most voxels: every level gets the full cap
        batch = attach_host_plan(collate(rec, spec, dev), rec, spec,
                                 level_cap_ratios=(1.0,) * 5,
                                 **plan_layout(layout))
        q = numpy_queries(batch.num_superpoints.cpu().numpy(),
                          SCENE["n_superpoints"], seed=5)
        step = make_train_step(m, 1, ema=False)
        metrics = step([batch], queries=[tuple(t.to(dev) for t in q)])
        out[dev] = (check_metrics(step, metrics, f"small step on {dev}"),
                    {n: float(p.grad.norm()) for n, p in m.named_parameters()})
    (mc, gc), (mp, gp) = out[DEVICE], out["cpu"]
    for k in mp:
        ok = np.isclose(mc[k], mp[k], rtol=1e-4, atol=0)
        print(f"small-scene train step ({layout}) {k}: card "
              f"{mc[k]:.6f} cpu {mp[k]:.6f} "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            raise SystemExit(f"card train step disagrees with the CPU on {k}")
    scale = max(gp.values())
    worst = max(gp, key=lambda n: abs(gc[n] - gp[n]) / (1e-3 * scale
                                                        + 1e-3 * gp[n]))
    bad = [n for n in gp
           if not np.isclose(gc[n], gp[n], rtol=1e-3, atol=1e-3 * scale)]
    print(f"small-scene train step ({layout}): {len(gp)} "
          f"gradient leaves, worst {worst} "
          f"card {gc[worst]:.6g} cpu {gp[worst]:.6g} (rtol 1e-3, atol "
          f"{1e-3 * scale:.3g}) {'ok' if not bad else 'MISMATCH'}",
          flush=True)
    if bad:
        raise SystemExit(f"card gradients disagree with the CPU on {bad[:5]}")


def run_training_device(model, records, spec):
    """Phase 4b: TRAIN_STEPS batch-1 steps on batches without a host plan
    (the backbone builds each plan in the forward), after a warm-up.  The
    plan is also built alone before each step and timed, to report it."""
    from segdino3d_tpu_torch.data.collate import collate
    from segdino3d_tpu_torch.parallel.train_step import StageClock

    gen = torch.Generator(device=DEVICE).manual_seed(1)
    step = make_train_step(model, 1)

    def bare(rec):
        t0 = time.perf_counter()
        b = collate([rec], spec, DEVICE)
        torch.cuda.synchronize()
        return b, time.perf_counter() - t0

    check_metrics(step, step([bare(records[0])[0]], generator=gen),
                  "device-plan warm-up step")
    steps, launches, metrics = [], None, []
    for i in range(TRAIN_STEPS):
        b, t_collate = bare(records[i % len(records)])
        coords = b.points.reshape(-1, 6)[:, :3] / torch.full(
            (), 0.02, device=DEVICE)
        t0 = time.perf_counter()
        _, overflow = model.backbone.device_plan(coords, b.point_valid)
        torch.cuda.synchronize()
        t_plan = time.perf_counter() - t0
        if bool(overflow):
            raise SystemExit(f"device plan overflowed on training scene {i}")
        clock = StageClock(torch.cuda.synchronize)
        reset_counts()
        m = step([b], generator=gen, clock=clock)
        if launches is None:
            launches = read_counts()
        metrics.append(check_metrics(step, m, f"device-plan step {i}"))
        steps.append(dict(collate=t_collate, plan_alone=t_plan,
                          **clock.seconds))
    keys = ("collate", "forward", "criterion", "backward", "optimizer")
    mean = {k: 1e3 * float(np.mean([st[k] for st in steps]))
            for k in keys + ("plan_alone",)}
    total = [sum(st[k] for k in keys) for st in steps]
    print(f"launches in one batch-1 train step on a device plan: {launches}",
          flush=True)
    for k in GATHER_STEP_KERNELS:
        if launches[k] <= 0:
            raise SystemExit(f"{k}: not launched in the device-plan step")
    print(f"train batch 1 on device plans: {float(np.mean(total)):.4f} s/step "
          f"over {TRAIN_STEPS} steps (fp32; the forward builds the plan); "
          f"ms per stage " + ", ".join(f"{k} {mean[k]:.2f}" for k in keys)
          + f"; device plan alone {mean['plan_alone']:.2f} ms", flush=True)
    print(f"device-plan train metrics (finite): {metrics[-1]}", flush=True)
    return launches


def report_training(launches, steps, accum, launches4, peak):
    expected = {"gather_gemm_conv": 101, "up_conv": 8,
                "segment_mean_gather": 2, "gather_wgrad": 55,
                "segment_grad": 1}
    print(f"launches in one batch-1 train step: {launches} (expected "
          f"{expected}; gather_pairs {GATHER_PAIR_LISTS}: one pair list per "
          f"index table, the stem's, five levels' and four child tables)",
          flush=True)
    print(f"launches in one accum_steps=4 step: {launches4}", flush=True)
    for k in expected:
        if launches[k] <= 0 or launches4[k] <= 0:
            raise SystemExit(f"{k}: not launched in the train step")
    if launches["gather_pairs"] != GATHER_PAIR_LISTS or \
            launches4["gather_pairs"] != 4 * GATHER_PAIR_LISTS:
        raise SystemExit(f"gather_pairs: {launches['gather_pairs']} / "
                         f"{launches4['gather_pairs']} pair lists in the "
                         f"batch-1 / accumulated step, expected "
                         f"{GATHER_PAIR_LISTS} per scene")
    keys = ("plan", "forward", "criterion", "backward", "optimizer")
    mean = {k: 1e3 * float(np.mean([st[k] for st in steps])) for k in keys}
    total = [sum(st[k] for k in keys) for st in steps]
    print(f"train batch 1: {float(np.mean(total)):.4f} s/step over "
          f"{TRAIN_STEPS} steps (fp32; stages timed with a device sync at "
          f"each boundary); ms per stage "
          + ", ".join(f"{k} {v:.2f}" for k, v in mean.items()), flush=True)
    print(f"train accum_steps=4 (4 scenes x batch 1): "
          f"{sum(accum[k] for k in keys):.4f} s/step; ms per stage "
          + ", ".join(f"{k} {1e3 * accum[k]:.2f}" for k in keys), flush=True)
    print(f"train peak device memory: {peak / 2 ** 30:.3f} GiB", flush=True)


# --------------------------------------------------------------------------
# phases 3c and 4c: the flagship config's block-dense layouts
# --------------------------------------------------------------------------

def block_fill(t):
    """(voxels, occupied blocks, their cells' occupied share) of a level."""
    from segdino3d_tpu_torch.ops import block_dense as BD

    occ = BD.occupancy(t).view(t.num_blocks, -1)
    n_vox, blocks = int(occ.sum()), int(occ.any(1).sum())
    return n_vox, blocks, n_vox / max(occ.shape[1] * blocks, 1)


def describe_blocks(plan):
    """Voxels, blocks, block cap and fill of each block-dense level."""
    parts = []
    for li, t in enumerate(plan.blocks):
        if t is None:
            parts.append(f"L{li} gather")
            continue
        n_vox, blocks, fill = block_fill(t)
        parts.append(f"L{li} {n_vox} voxels in {blocks} blocks (cap "
                     f"{t.num_blocks}), fill {fill:.1%}")
    return "; ".join(parts)


def run_hybrid_eval(model, test_cfg, records, spec, gather_bb):
    """Phase 3c: the eval path on the config's eval layout (hybrid)."""
    launches, times, peak, batch, bb, out, res, metrics = run_main_path(
        model, test_cfg, records, spec, layout="hybrid")
    plan = batch.plan
    if plan.blocks is None or plan.stem_nbr is None:
        raise SystemExit("the hybrid plan has no block tables or no stem "
                         "table")
    print(f"hybrid plan {plan_layout('hybrid')}: {describe_blocks(plan)}",
          flush=True)
    # one occupancy row list per block-dense level, which its convs share
    expected = {"gather_gemm_conv": 5, "up_conv": 4, "segment_mean_gather": 2,
                "block_conv": 46, "slot_gather": 18,
                "block_rows": sum(t is not None for t in plan.blocks)}
    print(f"launches in one hybrid forward: {launches} (expected "
          f"{expected})", flush=True)
    for k, n in expected.items():
        if launches[k] != n:
            raise SystemExit(f"{k}: {launches[k]} launches in the hybrid "
                             f"forward, expected {n}")
    stages = {k: 1e3 * float(np.mean([t[k] for t in times]))
              for k in times[0]}
    total = [sum(t.values()) for t in times]
    print(f"hybrid main path: {1.0 / float(np.mean(total)):.3f} scenes/s "
          f"over {TIMED_ITERS} iterations (batch 1, fp32); ms per stage "
          + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
          + f"; total {1e3 * float(np.mean(total)):.2f} ms; peak "
          f"{peak / 2 ** 30:.3f} GiB", flush=True)
    a, b = bb.sp_feats, gather_bb.sp_feats
    err, scale = float((a - b).abs().max()), float(b.abs().max())
    ok = err <= 3e-3 * scale
    print(f"hybrid backbone vs gather backbone sp_feats: max_abs_err="
          f"{err:.3e} (<= 3e-3 x max|gather| = {3e-3 * scale:.3e}) "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        raise SystemExit("the hybrid backbone disagrees with the gather "
                         "backbone")
    check_outputs(bb, out, res, SCENE["n_superpoints"])
    check_small_reference(model, plans=("hybrid",))
    return launches


DISK_SEEDS = (0, 1, 2)


class StageTimer:
    """Device-synchronised wall time of a module's forwards (a pre and a
    post hook), and the tensors ``keep`` takes from its outputs."""

    def __init__(self, module, keep=None):
        self.seconds, self.kept, self._t = 0.0, [], 0.0
        self.keep = keep
        self.hooks = [module.register_forward_pre_hook(self._pre),
                      module.register_forward_hook(self._post)]

    def _pre(self, *_):
        torch.cuda.synchronize()
        self._t = time.perf_counter()

    def _post(self, _module, _inputs, out):
        torch.cuda.synchronize()
        self.seconds += time.perf_counter() - self._t
        if self.keep is not None:
            self.kept.append(self.keep(out).clone())

    def remove(self):
        for h in self.hooks:
            h.remove()


def run_disk_eval(model, test_cfg, root, layout):
    """One pass of the eval entry point over the scenes under ``root``:
    the port's ScanNet200 reader, ``EvalLoader`` (batch 1, the default
    buckets, the capacity prescan, one batch of prefetch) on host plans of
    ``layout``, and ``evaluate`` (packed result transfer).  Returns
    (launches, stage ms, scenes/s, peak bytes, metrics, sp_feats per
    scene)."""
    from segdino3d_tpu_torch.data.bucketing import BucketPolicy
    from segdino3d_tpu_torch.data.loader import EvalLoader
    from segdino3d_tpu_torch.data.scannet_constants import (
        SCANNET200_CLASS_NAMES, SCANNET200_RAW_IDS)
    from segdino3d_tpu_torch.data.scannet_dataset import \
        ScanNet200InstanceSeg3D
    from segdino3d_tpu_torch.evaluation.evaluate import evaluate
    from segdino3d_tpu_torch.evaluation.evaluator import InstanceSeg3DEvaluator

    # the synthetic labels are class ids already
    reader = ScanNet200InstanceSeg3D(
        scene_set="val", root_scenes=root, adjust_class_ids=False,
        root_points_2dfeats=os.path.join(root, "features_2d"),
        feats_2d_dtype="float16")
    loader = EvalLoader(reader, batch_size=1,
                        bucket_policy=BucketPolicy.default(),
                        host_plan_cfg=plan_layout(layout), prefetch=1,
                        prescan_caps=True, device=DEVICE)
    waited = []

    def timed(it):
        it = iter(it)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            waited.append(time.perf_counter() - t0)
            yield item

    backbone = StageTimer(model.backbone, keep=lambda bb: bb.sp_feats)
    decoder = StageTimer(model.decoder)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    try:
        metrics = evaluate(model, timed(loader), InstanceSeg3DEvaluator(
            SCANNET200_RAW_IDS, SCANNET200_CLASS_NAMES), test_cfg)
        total = time.perf_counter() - t0
    finally:
        backbone.remove()
        decoder.remove()
    launches = read_counts()
    n = len(DISK_SEEDS)
    stages = {"loader wait (read, plan, copy)": sum(waited),
              "backbone": backbone.seconds, "decoder": decoder.seconds}
    stages["postprocess + result copy + AP"] = total - sum(stages.values())
    ms = {k: 1e3 * v / n for k, v in stages.items()}
    return (launches, ms, n / total, torch.cuda.max_memory_allocated(),
            metrics, backbone.kept)


def run_disk_phase(model, test_cfg):
    """Phase 3d: the eval entry point on scenes read from disk, with the
    config's gather stem and with the compacted stem (K12)."""
    import tempfile

    from segdino3d_tpu_torch.data.synthetic import write_scannet_layout

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        write_scannet_layout(root, DISK_SEEDS, **SCENE)
        print(f"wrote {len(DISK_SEEDS)} scenes ({SCENE['n_points']} points, "
              f"{SCENE['n_superpoints']} superpoints) in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        runs = {layout: run_disk_eval(model, test_cfg, root, layout)
                for layout in ("hybrid", "compact")}
    expected = {"hybrid": {"gather_gemm_conv": 5, "stem_slot_sum": 0},
                "compact": {"gather_gemm_conv": 4, "stem_slot_sum": 1}}
    n = len(DISK_SEEDS)
    for layout, (launches, ms, rate, peak, metrics, _) in runs.items():
        per = {k: v / n for k, v in launches.items() if v}
        print(f"eval entry point, {layout} stem: launches per forward {per} "
              f"(expected {expected[layout]}: the stem is K1 or K12)",
              flush=True)
        for k, want in expected[layout].items():
            if launches[k] != want * n:
                raise SystemExit(f"{k}: {launches[k]} launches over {n} "
                                 f"forwards of the {layout} run, expected "
                                 f"{want} each")
        print(f"eval entry point, {layout} stem: {rate:.3f} scenes/s over "
              f"{n} scenes read from disk (batch 1, fp32, prefetch 1); ms "
              f"per scene " + ", ".join(f"{k} {v:.2f}" for k, v in
                                        ms.items())
              + f"; peak {peak / 2 ** 30:.3f} GiB; all_ap_25="
              f"{metrics['all_ap_25']:.4f}", flush=True)
    for i, (a, b) in enumerate(zip(runs["compact"][5], runs["hybrid"][5])):
        if not bool(torch.isfinite(a).all()):
            raise SystemExit(f"compacted stem: non-finite sp_feats, scene {i}")
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        ok = err <= 3e-3 * scale
        print(f"scene {i}: compacted-stem sp_feats vs gather stem: "
              f"max_abs_err={err:.3e} (<= 3e-3 x max|gather| = "
              f"{3e-3 * scale:.3e}) {'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            raise SystemExit("the compacted stem disagrees with the gather "
                             "stem")
    check_small_reference(model, plans=("compact",))
    return runs["compact"][0]


def run_dense_training(model, records, spec):
    """Phase 4c: batch-1 steps on the config's training layout."""
    check_small_train(model, "block-dense")
    launches, steps, _, _, peak, metrics = run_training(
        model, records, spec, layout="block-dense", accum=False)
    expected = {"block_conv": 93, "block_dilate": 5, "block_wgrad": 47,
                "slot_gather": 35, "gather_gemm_conv": 8, "up_conv": 8,
                "gather_wgrad": 8, "segment_mean_gather": 2,
                "segment_grad": 1, "block_rows": 5, "gather_pairs": 4}
    print(f"launches in one block-dense train step: {launches} (expected "
          f"{expected}: K10 47 forward + 46 dX, per level one k3 dilation "
          f"with its list (the dX convs') and one occupancy row list (the "
          f"forward convs' and K11's), one pair list, K1's and K4's, per "
          f"child table)",
          flush=True)
    for k, n in expected.items():
        if launches[k] != n:
            raise SystemExit(f"{k}: {launches[k]} launches in the "
                             f"block-dense train step, expected {n}")
    keys = ("plan", "forward", "criterion", "backward", "optimizer")
    mean = {k: 1e3 * float(np.mean([st[k] for st in steps])) for k in keys}
    total = [sum(st[k] for k in keys) for st in steps]
    print(f"block-dense train batch 1 {plan_layout('block-dense')}: "
          f"{float(np.mean(total)):.4f} "
          f"s/step over {TRAIN_STEPS} steps (fp32); ms per stage "
          + ", ".join(f"{k} {v:.2f}" for k, v in mean.items())
          + f"; peak {peak / 2 ** 30:.3f} GiB", flush=True)
    print(f"block-dense train metrics (finite): {metrics[-1]}", flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from segdino3d_tpu_torch.builder import Capacities, build_model, \
        random_init_
    from segdino3d_tpu_torch.data.collate import PadSpec
    from segdino3d_tpu_torch.ops import cuda_build, host_plan

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # phase 1: build
    t0 = time.perf_counter()
    reports = cuda_build.build_all()
    host_plan._load()
    print(f"built kernels {sorted(reports)} and libsparseplan in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)

    # the main path's scene and plan (phase 2 reuses its tables)
    t0 = time.perf_counter()
    records = make_records()
    spec = PadSpec(SCENE["n_points"], SCENE["n_superpoints"], 64, 128, 200)
    from segdino3d_tpu_torch.data.collate import attach_host_plan, collate
    batch = attach_host_plan(collate(records, spec, DEVICE), records, spec,
                             voxel_size=0.02, level_cap_ratios=LEVEL_CAP_RATIOS)
    plan = batch.plan
    print(f"scene: {SCENE['n_points']} points, voxels per level "
          f"{[int(l.valid.sum()) for l in plan.levels]} (caps "
          f"{[l.valid.shape[0] for l in plan.levels]}), built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # phase 2: kernels against their plain versions
    level_caps = [lv.valid.shape[0] for lv in plan.levels]
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    hybrid = attach_host_plan(collate(records, spec, DEVICE), records, spec,
                              level_cap_ratios=LEVEL_CAP_RATIOS,
                              **plan_layout("hybrid"))
    rows = check_kernels(kernel_cases(batch, SCENE["n_superpoints"], gen)
                         + backward_cases(batch, SCENE["n_superpoints"], gen)
                         + plan_engine_cases(batch, level_caps)
                         + dense_cases(hybrid.plan, gen)
                         + stem_compact_cases(records, spec, gen))
    del hybrid

    # phase 3: the main path at full width; a batch without a host plan
    # (phase 3b) gets a device plan at the host plan's capacities
    caps = Capacities(num_superpoints=SCENE["n_superpoints"],
                      num_voxels=level_caps[0],
                      level_cap_ratios=LEVEL_CAP_RATIOS)
    model, test_cfg = build_model(model_cfg(), caps)
    random_init_(model, seed=0)
    launches, times, peak, batch, bb, out, res, metrics = run_main_path(
        model, test_cfg, records, spec)
    print(f"launches in one forward: {launches} (expected gather_gemm_conv "
          f"51, up_conv 4, segment_mean_gather 2, segment_csr 2, gather_pairs "
          f"{GATHER_PAIR_LISTS}: K1's pair lists, one per index table)",
          flush=True)
    expected = {"gather_gemm_conv": 51, "up_conv": 4,
                "segment_mean_gather": 2, "segment_csr": 2}
    for k, n in expected.items():
        if launches[k] < n or (k == "up_conv" and launches[k] != n):
            raise SystemExit(f"{k}: {launches[k]} launches, expected {n}")
    if launches["gather_pairs"] != GATHER_PAIR_LISTS:
        raise SystemExit(f"gather_pairs: {launches['gather_pairs']} pair "
                         f"lists in one forward, expected "
                         f"{GATHER_PAIR_LISTS}")
    stages = {k: 1e3 * float(np.mean([t[k] for t in times]))
              for k in times[0]}
    total = [sum(t.values()) for t in times]
    print(f"main path: {1.0 / float(np.mean(total)):.3f} scenes/s over "
          f"{TIMED_ITERS} iterations (batch 1, fp32); ms per stage "
          + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
          + f"; total {1e3 * float(np.mean(total)):.2f} ms", flush=True)
    print(f"peak device memory: {peak / 2 ** 30:.3f} GiB", flush=True)
    print(f"AP on the random-weight scene: all_ap={metrics['all_ap']:.4f} "
          f"all_ap_50={metrics['all_ap_50']:.4f} "
          f"all_ap_25={metrics['all_ap_25']:.4f}", flush=True)
    check_outputs(bb, out, res, SCENE["n_superpoints"])
    fwd_ms, cats = forward_device_ms(model, batch)
    print(f"one gather forward (torch.profiler, device ms): K1 "
          f"{fwd_ms['K1']:.4f}, K2 {fwd_ms['K2']:.4f}, K3 {fwd_ms['K3']:.4f} "
          f"of {fwd_ms['device']:.4f}; (N, 259) concatenations: {len(cats)}",
          flush=True)
    if cats:
        raise SystemExit("the forward concatenated the (N, 259) point "
                         "features on the card")
    check_small_reference(model)

    # phase 3b: the main path on device plans
    dev_launches = run_device_plan_path(model, test_cfg, records, spec, batch,
                                        bb, out)

    # phase 3c: the main path on the config's eval layout (hybrid)
    hybrid_launches = run_hybrid_eval(model, test_cfg, records, spec, bb)

    # phase 3d: the eval entry point on scenes read from disk, the gather
    # stem and the compacted stem
    disk_launches = run_disk_phase(model, test_cfg)

    # phase 4: the training path at full width
    from segdino3d_tpu_torch.data.synthetic import synthetic_scene
    tmodel, _ = build_model(train_cfg(), caps, train=True)
    random_init_(tmodel, seed=0)
    check_small_train(tmodel)
    train_records = []
    for seed in TRAIN_SEEDS:
        rec = synthetic_scene(seed, **SCENE)
        rec["points_2dfeats"] = rec["points_2dfeats"].astype(np.float16)
        train_records.append(rec)
    tspec = PadSpec(SCENE["n_points"], SCENE["n_superpoints"], 64, 128, 200)
    (train_launches, steps, accum, launches4, train_peak,
     metrics) = run_training(tmodel, train_records, tspec)
    report_training(train_launches, steps, accum, launches4, train_peak)
    print(f"train metrics (finite): first {metrics[0]}, accum_steps=4 "
          f"{metrics[-1]}", flush=True)

    # phase 4b: batch-1 training on device plans, at a capacity that holds
    # every training scene (the host plan's bucket of each)
    from segdino3d_tpu_torch.data.collate import _plan_coords
    tmodel.backbone.voxel_cap = max(
        host_plan.voxel_bucket(host_plan.probe_voxel_count(
            c.reshape(-1, 3), bidx, valid.reshape(-1)))
        for c, valid, bidx in (_plan_coords([r], tspec.num_points, 0.02)
                               for r in train_records[:TRAIN_STEPS]))
    print(f"device-plan training: voxel cap {tmodel.backbone.voxel_cap}, "
          f"level cap ratios {LEVEL_CAP_RATIOS}", flush=True)
    train_dev_launches = run_training_device(tmodel, train_records, tspec)

    # phase 4c: batch-1 training on the config's training layout
    dmodel, _ = build_model(train_cfg(), caps, train=True)
    random_init_(dmodel, seed=0)
    dense_train_launches = run_dense_training(dmodel, train_records, tspec)

    # phase 5: the kernels line, then the result line
    meta = {
        "gather_gemm_conv": ("segdino3d_tpu_torch/csrc/gather_gemm_conv.cu",
                             "segdino3d_tpu/ops/sparse_conv.py:232"),
        "up_conv": ("segdino3d_tpu_torch/csrc/up_conv.cu",
                    "segdino3d_tpu/ops/sparse_conv.py:447"),
        "segment_mean_gather": (
            "segdino3d_tpu_torch/csrc/segment_mean_gather.cu",
            "segdino3d_tpu/ops/scatter.py:27"),
        # the segments' CSR (the JAX op scatters without one)
        "segment_csr": ("segdino3d_tpu_torch/csrc/segment_mean_gather.cu",
                        "segdino3d_tpu/ops/scatter.py:40"),
        "gather_wgrad": ("segdino3d_tpu_torch/csrc/gather_wgrad.cu",
                         "segdino3d_tpu/ops/sparse_conv.py:305"),
        "segment_grad": ("segdino3d_tpu_torch/csrc/segment_grad.cu",
                         "segdino3d_tpu/ops/voxelize.py:115"),
        "coord_hash": ("segdino3d_tpu_torch/csrc/coord_hash.cu",
                       "segdino3d_tpu/ops/hashing.py:56"),
        "neighbor_table": ("segdino3d_tpu_torch/csrc/neighbor_table.cu",
                           "segdino3d_tpu/ops/sparse_conv.py:64"),
        "voxel_compact": ("segdino3d_tpu_torch/csrc/voxel_compact.cu",
                          "segdino3d_tpu/ops/voxelize.py:47"),
        "slot_gather": ("segdino3d_tpu_torch/csrc/slot_gather.cu",
                        "segdino3d_tpu/ops/block_dense.py:80"),
        "block_conv": ("segdino3d_tpu_torch/csrc/block_conv.cu",
                       "segdino3d_tpu/ops/block_dense.py:257"),
        # the dX role's output mask (the dilation outside which the JAX
        # op's unmasked input gradient is zero)
        "block_dilate": ("segdino3d_tpu_torch/csrc/block_conv.cu",
                         "segdino3d_tpu/ops/block_dense.py:396"),
        "block_wgrad": ("segdino3d_tpu_torch/csrc/block_wgrad.cu",
                        "segdino3d_tpu/ops/block_dense.py:414"),
        "stem_slot_sum": ("segdino3d_tpu_torch/csrc/stem_slot_sum.cu",
                          "segdino3d_tpu/ops/sparse_conv.py:369"),
    }
    plan_kernels = ("coord_hash", "neighbor_table", "voxel_compact")
    dense_kernels = ("slot_gather", "block_conv", "block_dilate",
                     "block_wgrad")
    kernels = []
    for name, (source, replaces) in meta.items():
        h = rows[name]["headline"]
        # the eval path's count for the forward kernels, the train step's
        # for the backward ones, the device-plan eval path's and step's for
        # the plan engine's, the hybrid eval path's and the block-dense
        # step's for the block-dense ones; all are printed above
        if name == "stem_slot_sum":
            # phase 3d's compacted run (3 forwards); no training path
            main_launches = disk_launches[name]
        elif name in plan_kernels:
            main_launches = dev_launches[name]
            train_launches[name] = train_dev_launches[name]
        elif name in dense_kernels:
            main_launches = hybrid_launches[name] or \
                dense_train_launches[name]
            train_launches[name] = dense_train_launches[name]
        else:
            main_launches = launches[name] if launches[name] > 0 \
                else train_launches[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=main_launches, launches_train_step=train_launches[name],
            max_abs_err=rows[name]["max_abs_err"],
            ms=h["ms"], plain_ms=h["plain_ms"], bound_ms=h["bound_ms"],
            bound_by=h["bound_by"], library_ms=h["library_ms"],
            shape=h["case"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
