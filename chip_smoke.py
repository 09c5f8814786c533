#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``segdino3d_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. print the card's name and power limit (``nvidia-smi``); build the
   hand-written kernels (``csrc/*.cu``, one ``nvcc`` each, in parallel) and
   the C++ host-plan library;
2. hold every kernel against its plain PyTorch version at the main path's
   shapes, and time the kernel, the plain version and a PyTorch yardstick
   with CUDA events: the forward kernels K1-K3 in fp32 and bf16; the
   backward kernels K4 (weight gradients) and K5 (pooling gradient), and
   K1/K2 in their backward roles, in fp32 at the training shapes;
3. run the eval path at full width: ScanNet200 eval of the flagship
   SegDINO3D (Res16UNet34C + 6-layer DINO-X query decoder) with seeded
   random weights on a seeded synthetic 120,000-point scene with 1,536
   superpoints: collate -> host plan -> backbone -> decoder ->
   predict_instance -> AP evaluator.  It prints scenes/s, ms per stage,
   each kernel's launches in one forward, and peak memory, checks that
   every output is finite, and holds the card's forward against the CPU's
   plain path on a small scene;
4. run the training path at full width: the flagship recipe's step (host
   plan -> backbone -> query subsampling -> decoder -> SparseMatcher
   criterion -> backward -> clip -> AdamW/PolyLR -> EMA) for a few batch-1
   steps, then one ``accum_steps=4`` step over four seeded scenes (the
   JAX package's recipe for the reference's batch 4).  It prints s/step,
   ms per stage, peak memory and each kernel's launches in one step,
   checks that every loss and the gradient norm are finite, and holds the
   card's step against the CPU's plain path on a small scene;
5. print one ``kernels`` JSON line, then the result line.

It needs one card, imports no JAX, and takes its kernels from the
checkout: run from anywhere else it fails.
"""
from __future__ import annotations

import copy
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
WGRAD_TOL = 1e-4           # K4: |kernel - plain| <= 1e-4 * max |plain|


def model_cfg():
    """The flagship SegDINO3D eval config (ScanNet200, DINO-X early
    fusion), as ``configs/models/base_3d.py`` sets it."""
    return dict(
        type="SegDINO3D",
        pointcloud_backbone_cfg=dict(
            type="Res16UNet34C", in_channels=259, out_channels=96,
            voxel_size=0.02, mode_fuse_2d_feat="early_fusion",
            compute_dtype="float32",
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
    conv_case("subm k3 256->256 L4", lv[4].valid.shape[0], lv[4].nbr,
              lv[4].valid, 256, 256)
    conv_case("down 32->32 L0->L1", v0, lv[0].child, lv[1].valid, 32, 32)
    conv_case("down 128->128 L3->L4", lv[3].valid.shape[0], lv[3].child,
              lv[4].valid, 128, 128)

    def up_case(name, coarse, fine, cin, cout):
        per = {}
        live = int((fine.valid & (fine.parent >= 0)).sum())
        for dt in (torch.float32, torch.bfloat16):
            x = _randn(gen, (coarse.valid.shape[0], cin), dt)
            w = _randn(gen, (8, cin, cout), dt, cin ** -0.5)
            args = (fine.parent, fine.kpos, fine.up_order)
            per[dt] = (lambda x=x, w=w: SC.up_conv_rows(x, *args, w,
                                                        fine.valid),
                       lambda x=x, w=w: SC.up_conv_plain(
                           x, fine.parent, fine.kpos, w, fine.valid),
                       lambda x=x, w=w: up_library(x, fine.parent, fine.kpos,
                                                   w),
                       2.0 * live * cin * cout,
                       nbytes(x, *args, w, fine.valid)
                       + fine.valid.shape[0] * cout * x.element_size(),
                       CONV_PEAK[dt])
        cases.append(("up_conv", name, per))

    up_case("up 96->96 L1->L0", lv[1], lv[0], 96, 96)
    up_case("up 256->256 L4->L3", lv[4], lv[3], 256, 256)

    inverse = plan.inverse
    pvalid = inverse >= 0
    seg_vox = torch.where(inverse >= 0, inverse, v0).contiguous()
    n_members = int(pvalid.sum())
    per = {}
    for dt in (torch.float32, torch.bfloat16):
        d = _randn(gen, (n_points, 259), dt)
        per[dt] = (lambda d=d: SS.segment_mean_gather(seg_vox, v0, pvalid,
                                                      d=d),
                   lambda d=d: SS.segment_mean_gather_plain(seg_vox, v0,
                                                            pvalid, d=d),
                   lambda d=d: segment_library(seg_vox, v0, pvalid, d.float()),
                   float(n_members * 259),
                   nbytes(seg_vox, pvalid, d) + v0 * 259 * 4, "fp32")
    cases.append(("segment_mean_gather", "voxel mean (N,259)->V0", per))

    seg_sp = superpoint_segment_ids(batch.superpoint_ids, s_cap)
    q = _randn(gen, (n_points, 6), torch.float32)
    per = {}
    for dt in (torch.float32, torch.bfloat16):
        g = _randn(gen, (v0, 96), dt)

        def lib(g=g):
            gp = torch.cat([g.float(), g.new_zeros(1, 96).float()])
            rows = torch.cat([gp[torch.where(inverse < 0, v0, inverse).long()],
                              q], 1)
            return segment_library(seg_sp, s_cap, pvalid, rows)

        per[dt] = (lambda g=g: SS.segment_mean_gather(
                       seg_sp, s_cap, pvalid, g=g, gather_idx=inverse, d=q),
                   lambda g=g: SS.segment_mean_gather_plain(
                       seg_sp, s_cap, pvalid, g=g, gather_idx=inverse, d=q),
                   lib, float(n_members * 102),
                   nbytes(seg_sp, pvalid, g, inverse, q) + s_cap * 102 * 4,
                   "fp32")
    cases.append(("segment_mean_gather",
                  "superpoint pool (V0,96)+(N,6)->1536", per))
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
        cases.append(("gather_wgrad", name, {f32: (
            lambda: SC.gather_wgrad(a, ia, b, ib, mirror),
            lambda: SC.gather_wgrad_plain(a, ia, b, ib, n_off, rows, mirror),
            lambda: wgrad_library(a, ia, b, ib, mirror),
            2.0 * live_pairs(ia, ib) * cin * cout,
            nbytes(a, ia, b, ib) + n_off * cin * cout * 4, "fp32",
            WGRAD_TOL)}))

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
        lambda: SC.up_conv_rows(dy, fine.parent, fine.kpos, fine.up_order,
                                wt, fine.valid),
        lambda: SC.up_conv_plain(dy, fine.parent, fine.kpos, wt, fine.valid),
        lambda: up_library(dy, fine.parent, fine.kpos, wt),
        2.0 * live * 32 * 32,
        nbytes(dy, fine.parent, fine.kpos, fine.up_order, wt, fine.valid)
        + v0 * 32 * 4, "fp32")}))

    # K5: the pooling's gradient into the U-Net output
    inverse = plan.inverse
    pvalid = batch.point_valid.reshape(-1)
    seg = superpoint_segment_ids(batch.superpoint_ids, s_cap)
    vox_csr = SS.segment_csr(inverse, v0, pvalid)
    g = _randn(gen, (s_cap, 96), f32)
    keep = pvalid & (inverse >= 0)
    vidx, sidx = inverse[keep].long(), seg[keep].long()
    n_members = int(keep.sum())
    cases.append(("segment_grad", "pool backward (1,536,96)->(V0,96)", {f32: (
        lambda: SS.segment_grad(g, seg, s_cap, inverse, pvalid, vox_csr),
        lambda: SS.segment_grad_plain(g, seg, s_cap, inverse, pvalid, v0),
        lambda: g.new_zeros(v0, 96).index_add_(0, vidx, g[sidx]),
        float(n_members * 96),
        nbytes(g, seg, *vox_csr) + v0 * 96 * 4, "fp32")}))
    return cases


def check_kernels(cases):
    """Compare, then time; returns per-kernel rows (headline = first case
    of each kernel, fp32) and the max error over each kernel's cases.  A
    case's ``per`` maps a dtype to (kernel_fn, plain_fn, library_fn, ops,
    bytes, peak) and optionally a 7th entry, a tolerance relative to
    ``max |plain|`` (for long fp32 reductions)."""
    rows = {}
    for kernel, name, per in cases:
        for dt, (kfn, pfn, lfn, ops, byts, peak, *rel) in per.items():
            got, want = kfn(), pfn()
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            if rel:
                atol = rel[0] * float(want.float().abs().max())
                ok = err <= atol
                tol_text = f"atol={rel[0]:g} x max|plain| = {atol:.3e}"
            else:
                tol = TOL[dt]
                ok = torch.allclose(got.float(), want.float(), rtol=tol,
                                    atol=tol)
                tol_text = f"rtol=atol={tol:g}"
            k_ms, p_ms, l_ms = time_ms(kfn), time_ms(pfn, 3), time_ms(lfn, 3)
            b_ms, b_by = bound(ops, byts, peak)
            dts = str(dt).replace("torch.", "")
            print(f"kernel {kernel} [{name}] {dts}: max_abs_err={err:.3e} "
                  f"({tol_text}) {'ok' if ok else 'MISMATCH'}; "
                  f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                  f"library {l_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})",
                  flush=True)
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
    from segdino3d_tpu_torch.ops import scatter as SS
    from segdino3d_tpu_torch.ops import sparse_conv as SC

    return {"gather_gemm_conv": SC.gather_conv, "up_conv": SC.up_conv_rows,
            "segment_mean_gather": SS.segment_mean_gather,
            "gather_wgrad": SC.gather_wgrad, "segment_grad": SS.segment_grad}


def run_main_path(model, test_cfg, records, spec):
    from segdino3d_tpu_torch.data.collate import (attach_host_plan, collate,
                                                  eval_annotation)
    from segdino3d_tpu_torch.evaluation.evaluate import (host_prediction,
                                                         postprocess)
    from segdino3d_tpu_torch.data.scannet_constants import (
        SCANNET200_CLASS_NAMES, SCANNET200_RAW_IDS)
    from segdino3d_tpu_torch.evaluation.evaluator import InstanceSeg3DEvaluator

    evaluator = InstanceSeg3DEvaluator(SCANNET200_RAW_IDS,
                                       SCANNET200_CLASS_NAMES)

    def once():
        t = {}
        t0 = time.perf_counter()
        batch = attach_host_plan(collate(records, spec, DEVICE), records,
                                 spec, voxel_size=0.02,
                                 level_cap_ratios=LEVEL_CAP_RATIOS)
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
            evaluator.process(eval_annotation(record), host_prediction(record,
                                                                       *r))
        metrics = evaluator.evaluate()
        t["ap_eval"] = time.perf_counter() - t0
        return t, batch, bb, out, res, metrics

    once()                                   # warm-up
    for fn in counters().values():
        fn.launches = 0
    t, batch, bb, out, res, metrics = once()
    launches = {k: fn.launches for k, fn in counters().items()}

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


def check_small_reference(model):
    """The card's forward (kernels) against the CPU's plain path, same
    weights, on a small scene.  Compared before any attention threshold:
    the superpoint features and the first head's class and mask logits."""
    from segdino3d_tpu_torch.data.collate import PadSpec, attach_host_plan, \
        collate
    from segdino3d_tpu_torch.data.synthetic import synthetic_scene

    rec = [synthetic_scene(1, n_points=4000, n_instances=6, n_superpoints=128,
                           n_classes=180, feat_dim_2d=256)]
    spec = PadSpec(4096, SCENE["n_superpoints"], 16, 16, 200)
    cpu_model = copy.deepcopy(model).cpu()
    outs = {}
    for dev, m in ((DEVICE, model), ("cpu", cpu_model)):
        batch = attach_host_plan(collate(rec, spec, dev), rec, spec,
                                 voxel_size=0.02)
        with torch.no_grad():
            bb = m.backbone(batch)
            o = m.decode(batch, bb)
        outs[dev] = dict(sp_feats=bb.sp_feats,
                         cls0=o["aux_outputs"][0]["cls_preds"],
                         mask0=o["aux_outputs"][0]["masks"])
    for k in outs["cpu"]:
        a, b = outs[DEVICE][k].cpu(), outs["cpu"][k]
        err = float((a - b).abs().max())
        ok = torch.allclose(a, b, rtol=1e-3, atol=1e-3)
        print(f"small-scene reference {k}: max_abs_err={err:.3e} "
              f"(rtol=atol=1e-3) {'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            raise SystemExit(f"card forward disagrees with the CPU on {k}")


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


def check_metrics(metrics, what):
    vals = {k: float(v) for k, v in metrics.items()}
    bad = [k for k, v in vals.items() if not np.isfinite(v)]
    if bad:
        raise SystemExit(f"{what}: non-finite {bad}: {vals}")
    return vals


def run_training(model, records, spec):
    """A warm-up and TRAIN_STEPS measured batch-1 steps, then one
    accum_steps=4 step over four scenes.  Returns (launches in one batch-1
    step, per-step stage seconds, the accumulated step's stage seconds and
    launches, peak bytes, metrics)."""
    from segdino3d_tpu_torch.data.collate import attach_host_plan, collate
    from segdino3d_tpu_torch.parallel.train_step import StageClock, TrainStep

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    step1 = make_train_step(model, 1)
    # the accumulated step continues the run: one optimizer and EMA
    step4 = TrainStep(model, step1.criterion, step1.optimizer, step1.ema,
                      accum_steps=4)

    def plan(rec):
        t0 = time.perf_counter()
        b = attach_host_plan(collate([rec], spec, DEVICE), [rec], spec,
                             voxel_size=0.02, level_cap_ratios=LEVEL_CAP_RATIOS)
        torch.cuda.synchronize()
        return b, time.perf_counter() - t0

    b, _ = plan(records[0])
    check_metrics(step1([b], generator=gen), "warm-up step")
    torch.cuda.reset_peak_memory_stats()
    steps, launches, metrics = [], None, []
    for i in range(TRAIN_STEPS):
        b, t_plan = plan(records[i % len(records)])
        clock = StageClock(torch.cuda.synchronize)
        for fn in counters().values():
            fn.launches = 0
        m = step1([b], generator=gen, clock=clock)
        if launches is None:
            launches = {k: fn.launches for k, fn in counters().items()}
        metrics.append(check_metrics(m, f"batch-1 step {i}"))
        steps.append(dict(plan=t_plan, **clock.seconds))
    mbs, t_plan = [], 0.0
    for rec in records:
        b, t = plan(rec)
        mbs.append(b)
        t_plan += t
    clock = StageClock(torch.cuda.synchronize)
    for fn in counters().values():
        fn.launches = 0
    m4 = step4(mbs, generator=gen, clock=clock)
    launches4 = {k: fn.launches for k, fn in counters().items()}
    metrics.append(check_metrics(m4, "accum_steps=4 step"))
    accum = dict(plan=t_plan, **clock.seconds)
    return (launches, steps, accum, launches4,
            torch.cuda.max_memory_allocated(), metrics)


def check_small_train(model):
    """One train step of the card (kernels) against the CPU's plain path,
    same weights and queries, on a small sparse scene (500 points per m^2,
    so every U-Net level keeps enough voxels for well-conditioned batch
    norms): the losses and the gradient norm (rtol 1e-4), and each leaf's
    clipped gradient norm (rtol 1e-3, atol 1e-3 x the largest)."""
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
                                 voxel_size=0.02, level_cap_ratios=(1.0,) * 5)
        q = numpy_queries(batch.num_superpoints.cpu().numpy(),
                          SCENE["n_superpoints"], seed=5)
        metrics = make_train_step(m, 1, ema=False)(
            [batch], queries=[tuple(t.to(dev) for t in q)])
        out[dev] = (check_metrics(metrics, f"small step on {dev}"),
                    {n: float(p.grad.norm()) for n, p in m.named_parameters()})
    (mc, gc), (mp, gp) = out[DEVICE], out["cpu"]
    for k in mp:
        ok = np.isclose(mc[k], mp[k], rtol=1e-4, atol=0)
        print(f"small-scene train step {k}: card {mc[k]:.6f} cpu {mp[k]:.6f} "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            raise SystemExit(f"card train step disagrees with the CPU on {k}")
    scale = max(gp.values())
    worst = max(gp, key=lambda n: abs(gc[n] - gp[n]) / (1e-3 * scale
                                                        + 1e-3 * gp[n]))
    bad = [n for n in gp
           if not np.isclose(gc[n], gp[n], rtol=1e-3, atol=1e-3 * scale)]
    print(f"small-scene train step: {len(gp)} gradient leaves, worst {worst} "
          f"card {gc[worst]:.6g} cpu {gp[worst]:.6g} (rtol 1e-3, atol "
          f"{1e-3 * scale:.3g}) {'ok' if not bad else 'MISMATCH'}",
          flush=True)
    if bad:
        raise SystemExit(f"card gradients disagree with the CPU on {bad[:5]}")


def report_training(launches, steps, accum, launches4, peak):
    expected = {"gather_gemm_conv": 101, "up_conv": 8,
                "segment_mean_gather": 2, "gather_wgrad": 55,
                "segment_grad": 1}
    print(f"launches in one batch-1 train step: {launches} (expected "
          f"{expected})", flush=True)
    print(f"launches in one accum_steps=4 step: {launches4}", flush=True)
    for k in expected:
        if launches[k] <= 0 or launches4[k] <= 0:
            raise SystemExit(f"{k}: not launched in the train step")
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
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    rows = check_kernels(kernel_cases(batch, SCENE["n_superpoints"], gen)
                         + backward_cases(batch, SCENE["n_superpoints"], gen))

    # phase 3: the main path at full width
    caps = Capacities(num_superpoints=SCENE["n_superpoints"])
    model, test_cfg = build_model(model_cfg(), caps)
    random_init_(model, seed=0)
    launches, times, peak, batch, bb, out, res, metrics = run_main_path(
        model, test_cfg, records, spec)
    print(f"launches in one forward: {launches} (expected gather_gemm_conv "
          f"51, up_conv 4, segment_mean_gather 2)", flush=True)
    expected = {"gather_gemm_conv": 51, "up_conv": 4,
                "segment_mean_gather": 2}
    for k, n in expected.items():
        if launches[k] < n or (k == "up_conv" and launches[k] != n):
            raise SystemExit(f"{k}: {launches[k]} launches, expected {n}")
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
    check_small_reference(model)

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

    # phase 5: the kernels line, then the result line
    meta = {
        "gather_gemm_conv": ("segdino3d_tpu_torch/csrc/gather_gemm_conv.cu",
                             "segdino3d_tpu/ops/sparse_conv.py:232"),
        "up_conv": ("segdino3d_tpu_torch/csrc/up_conv.cu",
                    "segdino3d_tpu/ops/sparse_conv.py:447"),
        "segment_mean_gather": (
            "segdino3d_tpu_torch/csrc/segment_mean_gather.cu",
            "segdino3d_tpu/ops/scatter.py:27"),
        "gather_wgrad": ("segdino3d_tpu_torch/csrc/gather_wgrad.cu",
                         "segdino3d_tpu/ops/sparse_conv.py:305"),
        "segment_grad": ("segdino3d_tpu_torch/csrc/segment_grad.cu",
                         "segdino3d_tpu/ops/voxelize.py:115"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        h = rows[name]["headline"]
        # the eval path's count for the forward kernels, the train step's
        # for the backward ones; both are printed above
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
