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
   per voxel, fp32 and bf16, the stem's wide matmul timed beside it; and
   the ScanNet v2 path's new shapes on phase 5's host plan: K1 at the k3
   stem 262->32, level 4's 160->160, a tail block's 192->96 and the
   128->160 down conv, K2 at the 160->128 and 64->32 up convs (fp32 and
   bf16), K3 as the voxel mean from three column sources (rgb, centred
   xyz, 2D features fp32 / fp16) and as the pool of the 32-channel output,
   K4 at the stem's 27x262x32 and level 4's 27x160x160 dW, K5 at C = 32;
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
4d. run the training entry point from disk: four headline-size scenes
   written to a temp dir, a temp config that inherits
   ``configs/prototypes/SegDINO3D_ScanNet200.py`` and changes only the
   data roots and the loop's lengths (batch 4, 8 process workers, sync
   scale, shared memory), and ``python -m segdino3d_tpu_torch.train_3d``
   in a child process twice: run A (``--accum_steps 4``, 4 steps,
   checkpoints at 2 and 4, steps 2-3 profiled, the in-loop eval of 2
   scenes building the eval cache) must log four finite steps, write both
   checkpoints, an mAP line, a complete cache manifest and a trace that
   holds each kernel of the block-dense step exactly 2 x 4 times as
   often as phase 4c's step launches it (two steps of four
   microbatches); run B
   (``--resume``, to step 6) must resume at step 4, write checkpoint 6
   and serve its eval from run A's cache unchanged.  It prints the CLI's
   s/step beside phase 4's accumulated step, the loader wait, the eval's
   scenes/s, the peak device memory and each run's wall time;
3d. run the eval entry point on three headline-size scenes written to a
   temp dir (``write_scannet_layout``): the port's ScanNet200 reader,
   ``EvalLoader`` (batch 1, default buckets, capacity prescan, prefetch 1)
   on the config's hybrid host plans and ``evaluate`` (bit-packed result
   transfer), once with the gather stem (K1) and once with the compacted
   stem (K12): launches per forward, scenes/s, ms per stage, peak memory;
   the compacted run's superpoint features within 3e-3 x max|.| of the
   gather run's, and the card against the CPU on a small compacted-stem
   scene at 1e-4;
5. run the ScanNet v2 model (``configs/prototypes/SegDINO3D_ScanNetv2.py``:
   SpConvUNet planes 32-160 with a k3 stem over rgb + centred xyz + DINO-X
   = 262 channels, the 6-layer decoder on its 32 channels, 18 / 20
   classes) at full width with seeded random weights on seeded scenes of
   phase 3's size: 5a eval at batch 1 on host plans (a k3 stem, the exact
   min shift): collate -> host plan -> backbone -> decoder ->
   predict_instance -> the ScanNet v2 AP evaluator; scenes/s, ms per
   stage, launches in one forward (K1 41, K2 4, K3 2, 9 pair lists),
   peak memory, K1-K3 device time of a profiled forward, which must hold
   no (N, 262) concatenation; finite outputs; the card against the CPU's
   plain path on a small scene, on a host and on a device plan; 5b the
   same eval on device plans: tables equal to the host plan's on valid
   rows, outputs within 1e-5 of the host-plan forward's; 5c batch-1
   training steps on host plans (AdamW/PolyLR, clip 10, no EMA, as the
   config says): s/step, ms per stage, launches, peak memory, K1's and
   K4's device time in a profiled step, finite losses and gradient norm,
   and the card against the CPU on a small scene;
6. run the Baseline model (``configs/prototypes/Baseline_ScanNet200.py``:
   the flagship Res16UNet34C on rgb alone, a k5 stem over 3 channels, the
   6-layer decoder without DINO-X cross-attention) at full width with
   seeded random weights on phase 3's scene without 2D features: 6a eval
   at batch 1 on the config's hybrid host plans -> predict_instance -> the
   ScanNet200 AP evaluator: scenes/s, ms per stage, launches (K1 5, K2 4,
   K3 2, K10 46, K9 18), peak memory, K1/K3/K10 device time of a profiled
   forward, finite outputs, the card against the CPU on a small scene
   (hybrid and device plan); 6b the same eval on device plans: tables
   equal to a gather host plan's on valid rows, outputs within 1e-5 of
   its forward's; 6e the eval entry point on scenes written without 2D
   features, read with ``root_points_2dfeats=None``: the loader wait per
   scene beside phase 3d's; 6c batch-1 training steps on the config's
   block-dense training plans (the dense k5 stem over 3 channels; no
   EMA): s/step, ms per stage, launches, K10/K11 device time of a
   profiled step, finite losses, the card against the CPU on a small
   scene; 6d two batch-1 steps on device plans (K1's and K4's narrow
   paths at the 3-channel stem, launches checked: one pair list fewer
   than a gather step's); phase 2 holds its new shapes (K1 at the k5 stem
   3->32, K10 at the dense stem 3->32 on the L0 row list, K11 and K4 at
   the stem's 125x3x32 dW in the forms the steps run, each on its narrow
   path and on its wide path forced, fp32 and bf16; two calls of each
   narrow dW path bit-equal, K4's narrow path building no pair list and
   allocating its output and split scratch alone,
   ``narrow.wgrad_smem_bytes`` equal to the library's; K3 from the one
   3-channel colour source);
7. run the decoder options on the flagship model at full width: 7a an
   eval forward and two training steps with the Fourier PE, objectness,
   ``query_num`` 400, a two-layer semantic head, dropout 0.1 (masks from
   the step's generator) and activation checkpointing, finite outputs and
   losses, the card against the CPU on a small scene with dropout 0; 7b
   an eval forward of the plain decoder with 100 learned queries; 7c an
   eval forward with the decoder's projections in bf16: with the config's
   mask gating the first head that reads them (layer 1) within 5e-2 x
   max|.| of the fp32 forward's masks and class logits (the later layers
   printed: gating flips move them), and without the gating every
   layer's;
11. (run after phase 9) export the serving artifact of the bf16 flagship
   (``segdino3d_tpu_torch/tools/export_serving.py``: ``torch.export`` of
   backbone + decoder + ``predict_instance`` with bit-packed masks, every
   kernel a registered op) at full width (PadSpec 131,072 points, 1,536
   superpoints, the hybrid plan at the capacities ``probe_plan_caps``
   gives four headline scenes); load it in a child process that imports
   no model module, builder or registry (``sys.modules`` checked) and run
   it on the four scenes; its labels, validity and packed masks must equal
   the eager served function's in this process and its scores be within
   1e-2 (or within the spread of two eager calls where they differ); its
   launches a forward, counted by the wrappers, must equal phase 10a's,
   and its hand-written kernels in the profiler's trace the eager
   forward's, name for name and count for count, with no library
   convolution in either.  It prints the export's seconds, the artifact's
   MB, the cold load's seconds, both paths' ms a forward and scenes/s;
8. print one ``kernels`` JSON line (each kernel's ScanNet v2 and Baseline
   cases and launches in it too, its CUDA launches per step of the
   CLI, ``cli_device_launches_per_step``, and in a forward of the serving
   artifact, ``launches_artifact``), the run's wall time, then the
   result line.

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


def v2_model_cfg():
    """The ScanNet v2 model (``configs/prototypes/SegDINO3D_ScanNetv2.py``
    as the config loader reads its ``model``, ``_base_`` merged): the
    SpConvUNet backbone (k3 stem over rgb + centred xyz + DINO-X = 262
    channels, planes 32-160), the 6-layer DINO-X query decoder on its 32
    channels, 18 instance and 20 semantic classes, and the criterion
    (``tests/test_torch_port_spconv.py`` holds this copy to the file)."""
    costs = [dict(type="QueryClassificationCost", weight=0.5),
             dict(type="MaskBCECost", weight=1.0),
             dict(type="MaskDiceCost", weight=1.0),
             dict(type="CenterL1Cost", weight=0.5),
             dict(type="SizeL1Cost", weight=0.5)]
    return dict(
        type="SegDINO3D", num_classes=18, query_thr=0.5,
        mode_3d_center="median", add_positional_embedding=True,
        filter_outofbox_points_eval=True,
        pointcloud_backbone_cfg=dict(
            type="SpConvUNet", num_planes=[32, 64, 96, 128, 160],
            block_reps=2, in_channels=262, voxel_size=0.02,
            mode_fuse_2d_feat="early_fusion", add_positional_embedding=True),
        decoder_cfg=dict(
            type="ScanNetQueryDecoder", num_layers=6,
            num_instance_queries=0, num_semantic_queries=0,
            num_instance_classes=18, num_semantic_classes=20,
            num_semantic_linears=1, in_channels=32, d_model=256,
            num_heads=8, hidden_dim=1024, dropout=0.0, activation_fn="gelu",
            iter_pred=True, attn_mask=True, fix_attention=True,
            objectness_flag=False, add_dinox_query_ca=True,
            add_dinox_query_ca_mask=True, dinox_query_ca_mask_threshold=0.2,
            add_positional_embedding=True, pos_type="sine", temperature=20,
            add_box_size_pred=True, box_modulate_ca=True,
            normalize_box_prediction=True),
        criterion_cfg=dict(
            type="ScanNetUnifiedCriterion", num_semantic_classes=20,
            sem_criterion=dict(type="ScanNetSemanticCriterion",
                               ignore_index=20, loss_weight=0.5),
            inst_criterion=dict(
                type="InstanceCriterion",
                matcher=dict(type="SparseMatcher", topk=1, costs=costs),
                loss_weight=[0.5, 1.0, 1.0, 0.5, 0.5, 0.5], num_classes=18,
                non_object_weight=0.1, fix_dice_loss_weight=True,
                iter_matcher=True, fix_mean_loss=True)),
        test_cfg=dict(topk_insts=600, inst_score_thr=0.0, pan_score_thr=0.5,
                      npoint_thr=100, obj_normalization=True,
                      sp_score_thr=0.4, nms=True,
                      matrix_nms_kernel="linear", stuff_classes=[0, 1]))


def baseline_model_cfg():
    """The Baseline model (``configs/prototypes/Baseline_ScanNet200.py`` as
    the config loader reads its ``model``, ``_base_`` merged): the flagship
    Res16UNet34C on rgb alone (``only_rgb``, a k5 stem over 3 channels), the
    6-layer decoder without DINO-X cross-attention, its criterion and
    layouts (``tests/test_torch_port_baseline.py`` holds this copy to the
    file)."""
    costs = [dict(type="QueryClassificationCost", weight=0.5),
             dict(type="MaskBCECost", weight=1.0),
             dict(type="MaskDiceCost", weight=1.0),
             dict(type="CenterL1Cost", weight=0.5),
             dict(type="SizeL1Cost", weight=0.5)]
    return dict(
        type="SegDINO3D", num_classes=198, query_thr=0.5,
        mode_3d_center="median", add_positional_embedding=True,
        filter_outofbox_points_eval=True,
        pointcloud_backbone_cfg=dict(
            type="Res16UNet34C", block_edges=[4, 4, 4, 4, 4],
            stem_gather=True, block_edges_train=[4, 4, 4, 4, 4],
            in_channels=3, out_channels=96, voxel_size=0.02,
            mode_fuse_2d_feat="only_rgb", add_positional_embedding=True,
            config=dict(dilations=[1, 1, 1, 1], conv1_kernel_size=5,
                        bn_momentum=0.02)),
        decoder_cfg=dict(
            type="ScanNetQueryDecoder", num_layers=6,
            num_instance_queries=0, num_semantic_queries=0,
            num_instance_classes=198, num_semantic_classes=200,
            num_semantic_linears=1, in_channels=96, d_model=256,
            num_heads=8, hidden_dim=1024, dropout=0.0, activation_fn="gelu",
            iter_pred=True, attn_mask=True, fix_attention=True,
            objectness_flag=False, add_dinox_query_ca=False,
            add_dinox_query_ca_mask=False, dinox_query_ca_mask_threshold=0.2,
            add_positional_embedding=True, pos_type="sine", temperature=20,
            add_box_size_pred=True, box_modulate_ca=True,
            normalize_box_prediction=True),
        criterion_cfg=dict(
            type="ScanNetUnifiedCriterion", num_semantic_classes=200,
            sem_criterion=dict(type="ScanNetSemanticCriterion",
                               ignore_index=200, loss_weight=0.5),
            inst_criterion=dict(
                type="InstanceCriterion",
                matcher=dict(type="SparseMatcher", topk=1, costs=costs),
                loss_weight=[0.5, 1.0, 1.0, 0.5, 0.5, 0.5], num_classes=198,
                non_object_weight=0.1, fix_dice_loss_weight=True,
                iter_matcher=True, fix_mean_loss=True)),
        test_cfg=dict(topk_insts=600, inst_score_thr=0.0, pan_score_thr=0.5,
                      npoint_thr=100, obj_normalization=True,
                      sp_score_thr=0.4, nms=True,
                      matrix_nms_kernel="linear", stuff_classes=[0, 1]))


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
    "block-dense", or the ScanNet v2 model's "v2" (phase 5: gather, a k3
    stem, the exact min shift), or the Baseline's eval and training
    layouts "baseline" and "baseline-train" (phase 6: the flagship's on a
    3-channel stem) (``builder.host_plan_args``)."""
    from segdino3d_tpu_torch.builder import host_plan_args

    if name == "hybrid":
        return host_plan_args(model_cfg())
    if name == "compact":
        return host_plan_args(compact_cfg())
    if name == "block-dense":
        return host_plan_args(train_cfg(), train=True)
    if name == "v2":
        return host_plan_args(v2_model_cfg())
    if name == "baseline":
        return host_plan_args(baseline_model_cfg())
    if name == "baseline-train":
        return host_plan_args(baseline_model_cfg(), train=True)
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


def pitched(x, dim):
    """``x`` widened along ``dim`` to the stems' aligned pitch
    (``narrow.row_pitch``) with zero columns; as it is in fp32."""
    from segdino3d_tpu_torch.ops import narrow as N

    pad = N.row_pitch(x.shape[dim], x.dtype) - x.shape[dim]
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim).contiguous()


def conv_case(cases, gen, name, vin, nbr, valid, cin, cout, wide=False):
    """K1 in its forward role, fp32 and bf16; with ``wide``, K1's wide
    path (the pair-major schedule) forced and timed beside it as a
    yardstick.  A bf16 stem (``narrow.wide_stem``) runs at the aligned
    pitch, as the backbone gives it (its input and weight zero past
    Cin)."""
    from segdino3d_tpu_torch.ops import sparse_conv as SC

    per = {}
    hits = int((nbr >= 0).sum())
    for dt in (torch.float32, torch.bfloat16):
        x = pitched(_randn(gen, (vin, cin), dt), 1)
        w = pitched(_randn(gen, (nbr.shape[0], cin, cout), dt,
                           (nbr.shape[0] * cin) ** -0.5), 1)
        extra = {"the wide path":
                 lambda x=x, w=w: SC.gather_conv(x, nbr, w, valid,
                                                 narrow=False)} if wide else {}
        per[dt] = (lambda x=x, w=w: SC.gather_conv(x, nbr, w, valid),
                   lambda x=x, w=w: SC.gather_conv_plain(x, nbr, w, valid),
                   lambda x=x, w=w: conv_library(x, nbr, w),
                   2.0 * hits * cin * cout,
                   nbytes(x, nbr, w, valid)
                   + nbr.shape[1] * cout * x.element_size(), CONV_PEAK[dt],
                   extra)
    cases.append(("gather_gemm_conv", name, per))


def up_case(cases, gen, name, coarse, fine, cin, cout):
    """K2 as an up conv, fp32 and bf16."""
    from segdino3d_tpu_torch.ops import sparse_conv as SC

    per = {}
    live = int((fine.valid & (fine.parent >= 0)).sum())
    for dt in (torch.float32, torch.bfloat16):
        x = _randn(gen, (coarse.valid.shape[0], cin), dt)
        w = _randn(gen, (8, cin, cout), dt, cin ** -0.5)
        per[dt] = (lambda x=x, w=w: SC.up_conv_rows(
                       x, fine.child, fine.parent, fine.kpos, w, fine.valid),
                   lambda x=x, w=w: SC.up_conv_plain(
                       x, fine.parent, fine.kpos, w, fine.valid),
                   lambda x=x, w=w: up_library(x, fine.parent, fine.kpos, w),
                   2.0 * live * cin * cout,
                   nbytes(x, fine.parent, fine.kpos, w, fine.valid)
                   + fine.valid.shape[0] * cout * x.element_size(),
                   CONV_PEAK[dt])
    cases.append(("up_conv", name, per))


def voxel_mean_cases(cases, gen, plan, n_points, centred=False,
                     rgb_only=False):
    """K3 as the forward calls it: the voxel mean from its column sources
    (the points' colour columns, on the v2 path the centred xyz, and the
    2D features with fp32 and with fp16 values, each read in place and
    rounded to the compute dtype; with ``rgb_only``, the Baseline's, the
    colour columns alone), over the forward's voxel CSR."""
    from segdino3d_tpu_torch.ops import scatter as SS

    v0 = plan.levels[0].valid.shape[0]
    inverse = plan.inverse
    pvalid = inverse >= 0
    seg_vox = torch.where(inverse >= 0, inverse, v0).contiguous()
    vox_csr = SS.segment_csr(seg_vox, v0, pvalid)
    n_members = int(pvalid.sum())
    pts = _randn(gen, (n_points, 6), torch.float32)
    mid = [_randn(gen, (n_points, 3), torch.float32)] if centred else []
    cols = 3 if rgb_only else 3 + 3 * len(mid) + 256
    for fdt in (None,) if rgb_only else (torch.float32, torch.float16):
        f2d = None if rgb_only else _randn(gen, (n_points, 256), fdt)
        srcs = [pts[:, 3:]] + mid + ([] if rgb_only else [f2d])
        per = {}
        for dt in (torch.float32, torch.bfloat16):
            per[dt] = (lambda dt=dt, srcs=srcs: SS.segment_mean_gather(
                           seg_vox, v0, pvalid, d=srcs, csr=vox_csr,
                           round_to=dt),
                       lambda dt=dt, srcs=srcs: SS.segment_mean_gather_plain(
                           seg_vox, v0, pvalid, d=srcs, round_to=dt),
                       lambda dt=dt, srcs=srcs: segment_library(
                           seg_vox, v0, pvalid, torch.cat(
                               [s.float() for s in srcs], 1).to(dt).float()),
                       float(n_members * cols),
                       nbytes(seg_vox, pvalid, f2d, *mid) + n_points * 3 * 4
                       + v0 * cols * 4, "fp32",
                       {"CSR build (segment_csr)": lambda: SS.segment_csr(
                           seg_vox, v0, pvalid),
                        "as the forward calls it (CSR, K3, cast)":
                        lambda dt=dt, srcs=srcs: SS.segment_mean_columns(
                            srcs, seg_vox, v0, dt, pvalid,
                            SS.segment_csr(seg_vox, v0, pvalid))})
        if rgb_only:
            cases.append(("segment_mean_gather", "baseline voxel mean, rgb "
                          "(N,6)[:,3:6] alone -> V0 x 3", per))
            continue
        fname = str(fdt).replace("torch.", "")
        tag, what = ("v2 ", " + centred xyz (N,3)") if centred else ("", "")
        cases.append(("segment_mean_gather", f"{tag}voxel mean, rgb (N,6)"
                      f"[:,3:6]{what} + 2D (N,256) {fname} -> V0 x {cols}",
                      per))
    return seg_vox, pvalid


def pool_case(cases, gen, batch, s_cap, width, tag=""):
    """K3 as the fused devoxelize + superpoint pool: the (V0, width) U-Net
    output gathered through the inverse map, and the two (N, 3) centroid
    sets."""
    from segdino3d_tpu_torch.models.backbone.wrapper import \
        superpoint_segment_ids
    from segdino3d_tpu_torch.ops import scatter as SS

    plan = batch.plan
    v0 = plan.levels[0].valid.shape[0]
    inverse = plan.inverse
    pvalid = inverse >= 0
    n_points = inverse.shape[0]
    n_members = int(pvalid.sum())
    seg_sp = superpoint_segment_ids(batch.superpoint_ids, s_cap)
    sp_csr = SS.segment_csr(seg_sp, s_cap, pvalid)
    q = [_randn(gen, (n_points, 3), torch.float32) for _ in range(2)]
    per = {}
    for dt in (torch.float32, torch.bfloat16):
        g = _randn(gen, (v0, width), dt)

        def lib(g=g):
            gp = torch.cat([g.float(), g.new_zeros(1, width).float()])
            rows = torch.cat([gp[torch.where(inverse < 0, v0, inverse).long()],
                              *q], 1)
            return segment_library(seg_sp, s_cap, pvalid, rows)

        per[dt] = (lambda g=g: SS.segment_mean_gather(
                       seg_sp, s_cap, pvalid, g=g, gather_idx=inverse, d=q,
                       csr=sp_csr),
                   lambda g=g: SS.segment_mean_gather_plain(
                       seg_sp, s_cap, pvalid, g=g, gather_idx=inverse, d=q),
                   lib, float(n_members * (width + 6)),
                   nbytes(seg_sp, pvalid, g, inverse, *q)
                   + s_cap * (width + 6) * 4, "fp32",
                   {"CSR build (segment_csr)": lambda: SS.segment_csr(
                       seg_sp, s_cap, pvalid)})
    cases.append(("segment_mean_gather", f"{tag}superpoint pool (V0,{width})"
                  f"+2x(N,3)->{s_cap}", per))
    return seg_sp


def kernel_cases(batch, s_cap, gen):
    """(kernel, case name, {dtype: (kernel_fn, plain_fn, library_fn,
    ops, bytes, peak)}) at the main path's shapes."""
    from segdino3d_tpu_torch.ops import scatter as SS

    plan = batch.plan
    n_points = batch.points.shape[1]
    lv = plan.levels
    cases = []
    v0 = lv[0].valid.shape[0]
    conv_case(cases, gen, "stem k5 259->32 L0", v0, plan.stem_nbr,
              lv[0].valid, 259, 32)
    conv_case(cases, gen, "subm k3 96->96 L0", v0, lv[0].nbr, lv[0].valid,
              96, 96)
    for li, c in ((1, 96), (2, 64), (3, 128), (4, 256)):
        conv_case(cases, gen, f"subm k3 {c}->{c} L{li}",
                  lv[li].valid.shape[0], lv[li].nbr, lv[li].valid, c, c)
    conv_case(cases, gen, "down 32->32 L0->L1", v0, lv[0].child, lv[1].valid,
              32, 32)
    conv_case(cases, gen, "down 128->128 L3->L4", lv[3].valid.shape[0],
              lv[3].child, lv[4].valid, 128, 128)
    # the decoder's four up convs, the forward's order reversed
    up_case(cases, gen, "up 96->96 L1->L0", lv[1], lv[0], 96, 96)
    up_case(cases, gen, "up 128->96 L2->L1", lv[2], lv[1], 128, 96)
    up_case(cases, gen, "up 256->128 L3->L2", lv[3], lv[2], 256, 128)
    up_case(cases, gen, "up 256->256 L4->L3", lv[4], lv[3], 256, 256)
    seg_vox, pvalid = voxel_mean_cases(cases, gen, plan, n_points)

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
    seg_sp = pool_case(cases, gen, batch, s_cap, 96)
    csr_case("superpoints", seg_sp, s_cap)
    return cases


def wgrad_case(cases, name, a, ia, b, ib, mirror=False, cin=None):
    """K4 on the tables' compacted pair lists, in a's dtype (bf16 at the
    bf16 tolerance of the kernel tests: 1e-2 x max |plain|).  ``cin``: the
    logical input width where ``a`` comes at a wider pitch (zero columns),
    which the bound's operations and weight bytes count."""
    from segdino3d_tpu_torch.ops import sparse_conv as SC

    table = ia if ia is not None else ib
    n_off, rows = table.shape
    cin, cout = cin or a.shape[1], b.shape[1]
    live = torch.ones_like(table, dtype=torch.bool)
    for t in (ia, ib):
        if t is not None:
            live &= t >= 0
    live = int(live.sum())
    pairs = SC.gather_pairs(ia, ib)
    torch.cuda.synchronize()
    if int(pairs.counts.sum()) != live:
        raise SystemExit(f"gather_pairs [{name}]: {int(pairs.counts.sum())}"
                         f" listed pairs, {live} live")
    cases.append(("gather_wgrad", f"{name}; the compacted lists hold "
                  f"{live} live pairs of {n_off * rows}", {a.dtype: (
        lambda: SC.gather_wgrad(a, ia, b, ib, mirror),
        lambda: SC.gather_wgrad_plain(a, ia, b, ib, n_off, rows, mirror),
        lambda: wgrad_library(a, ia, b, ib, mirror),
        2.0 * live * cin * cout,
        nbytes(a, ia, b, ib) + n_off * cin * cout * 4, CONV_PEAK[a.dtype],
        WGRAD_TOL if a.dtype == torch.float32 else 1e-2,
        {"pair list build (gather_pairs, once per table and step)":
         lambda: SC.gather_pairs(ia, ib)})}))


def pool_backward_case(cases, gen, batch, s_cap, width, tag=""):
    """K5: the pooling's gradient into the U-Net output, as the pool's
    backward runs it: the voxel columns of the (S, width + 6) gradient
    read in place, each divided by its superpoint's count inside the
    kernel; exactly one operation on the card."""
    from segdino3d_tpu_torch.models.backbone.wrapper import \
        superpoint_segment_ids
    from segdino3d_tpu_torch.ops import scatter as SS

    plan = batch.plan
    v0 = plan.levels[0].valid.shape[0]
    inverse = plan.inverse
    pvalid = batch.point_valid.reshape(-1)
    seg = superpoint_segment_ids(batch.superpoint_ids, s_cap)
    vox_csr = SS.segment_csr(inverse, v0, pvalid)
    sp_off = SS.segment_csr(seg, s_cap, pvalid).offsets
    dmeans = _randn(gen, (s_cap, width + 6), torch.float32)
    g = dmeans[:, :width]
    keep = pvalid & (inverse >= 0) & (seg >= 0) & (seg < s_cap)
    vidx, sidx = inverse[keep].long(), seg[keep].long()
    quot = g / SS.segment_counts(sp_off)[:, None]
    n_members = int(keep.sum())

    def pool_backward():
        return SS.segment_grad(g, seg, s_cap, sp_off, inverse, pvalid,
                               vox_csr)

    ops, us = device_ops(pool_backward)
    print(f"segment_grad [the pool's backward, C = {width}]: one call puts "
          f"{len(ops)} operations on the card, {us:.1f} us of device time: "
          f"{ops}", flush=True)
    if len(ops) != 1:
        raise SystemExit(f"segment_grad: the pool's backward made {len(ops)} "
                         "operations, 1 expected")
    cases.append(("segment_grad", f"{tag}pool backward ({s_cap},{width} of "
                  f"{width + 6})->(V0,{width}), the count division inside; "
                  "library: index_add_ of the quotients", {torch.float32: (
        pool_backward,
        lambda: SS.segment_grad_plain(g, seg, s_cap, sp_off, inverse, pvalid,
                                      v0),
        lambda: g.new_zeros(v0, width).index_add_(0, vidx, quot[sidx]),
        float(n_members * width * 2),
        nbytes(g, seg, vox_csr.offsets, vox_csr.members, sp_off)
        + v0 * width * 4, "fp32")}))


def backward_cases(batch, s_cap, gen):
    """The backward kernels at the training path's shapes, fp32: K4 for
    the stem, a level-0 k3 conv, a down and an up conv; K5 for the
    pooling; K1 and K2 in their backward roles."""
    from segdino3d_tpu_torch.ops import sparse_conv as SC

    plan = batch.plan
    lv = plan.levels
    v0, v1 = lv[0].valid.shape[0], lv[1].valid.shape[0]
    f32 = torch.float32
    cases = []
    wgrad_case(cases, "stem dW k5 259->32 L0 (dY gathered, mirrored)",
               _randn(gen, (v0, 259), f32), None, _randn(gen, (v0, 32), f32),
               plan.stem_nbr, mirror=True)
    wgrad_case(cases, "subm dW k3 96->96 L0", _randn(gen, (v0, 96), f32),
               lv[0].nbr, _randn(gen, (v0, 96), f32), None)
    wgrad_case(cases, "down dW 32->32 L0->L1", _randn(gen, (v0, 32), f32),
               lv[0].child, _randn(gen, (v1, 32), f32), None)
    wgrad_case(cases, "up dW 96->96 L1->L0", _randn(gen, (v1, 96), f32),
               None, _randn(gen, (v0, 96), f32), lv[0].child)

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
    pool_backward_case(cases, gen, batch, s_cap, 96)
    # the bf16 stem's dW at the aligned pitch (its fp32 case is the first)
    bf16 = torch.bfloat16
    wgrad_case(cases, "stem dW k5 259->32 L0 at the bf16 pitch 264 (dY "
               "gathered, mirrored)", pitched(_randn(gen, (v0, 259), bf16),
                                              1),
               None, _randn(gen, (v0, 32), bf16), plan.stem_nbr, mirror=True,
               cin=259)
    return cases


def v2_cases(batch, s_cap, gen):
    """The ScanNet v2 path's new shapes (phase 5's scene on its host plan:
    the exact min shift, a k3 stem), forward and backward: K1 at the k3
    stem 262->32 (Cin 262 takes the kernel's scalar A path), at level 4
    160->160 (Cout 160: column tiles of 64 + 64 + 32), a level-2 tail
    block's 192->96 and the 128->160 down conv; K2 at the up convs
    160->128 and 64->32; K3 as the voxel mean from three column sources and
    as the pool of the 32-channel output; K4 at the stem's 27x262x32 and
    level 4's 27x160x160 dW; K5 at C = 32."""
    plan = batch.plan
    lv = plan.levels
    v0 = lv[0].valid.shape[0]
    v = [l.valid.shape[0] for l in lv]
    f32 = torch.float32
    cases = []
    conv_case(cases, gen, "v2 stem k3 262->32 L0", v0, lv[0].nbr,
              lv[0].valid, 262, 32)
    conv_case(cases, gen, "v2 subm k3 160->160 L4", v[4], lv[4].nbr,
              lv[4].valid, 160, 160)
    conv_case(cases, gen, "v2 tail subm k3 192->96 L2", v[2], lv[2].nbr,
              lv[2].valid, 192, 96)
    conv_case(cases, gen, "v2 down 128->160 L3->L4", v[3], lv[3].child,
              lv[4].valid, 128, 160)
    up_case(cases, gen, "v2 up 160->128 L4->L3", lv[4], lv[3], 160, 128)
    up_case(cases, gen, "v2 up 64->32 L1->L0", lv[1], lv[0], 64, 32)
    voxel_mean_cases(cases, gen, plan, batch.points.shape[1], centred=True)
    pool_case(cases, gen, batch, s_cap, 32, "v2 ")
    wgrad_case(cases, "v2 stem dW k3 262->32 L0 (dY gathered, mirrored)",
               _randn(gen, (v0, 262), f32), None,
               _randn(gen, (v0, 32), f32), lv[0].nbr, mirror=True)
    wgrad_case(cases, "v2 subm dW k3 160->160 L4",
               _randn(gen, (v[4], 160), f32), lv[4].nbr,
               _randn(gen, (v[4], 160), f32), None)
    pool_backward_case(cases, gen, batch, s_cap, 32, "v2 ")
    return cases


def requested_growth(fn):
    """(``fn()``, the peak of the bytes its allocations requested above
    those live before it): the allocator's own block sizes depend on the
    blocks it holds cached (a request may take a larger free block
    whole), so the call's requests are counted, each at its size."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_stats()["requested_bytes.all.current"]
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.memory_stats()["requested_bytes.all.peak"] - base


def narrow_stem_check(plan, gen):
    """K1's narrow path at the Baseline's stem allocates its output alone
    and builds no pair list (on a fresh copy of the stem table, which no
    list was built for), where the wide path builds the list and
    allocates its (n_off * V, 32) fp32 buffer, and the two paths' fp32
    outputs are bit-equal (one order of sums); and ``narrow.smem_bytes``
    equals the library's ``narrow_conv_smem`` on every shape the rule
    admits at k3 and k5 into 32 or 64 channels."""
    from segdino3d_tpu_torch.ops import cuda_build
    from segdino3d_tpu_torch.ops import narrow as N
    from segdino3d_tpu_torch.ops import sparse_conv as SC

    lib = cuda_build.library("gather_gemm_conv")
    for n_off in (27, 125):
        for cin in range(1, N.KERNEL_MAX_CIN + 1):
            for cout in (32, 64):
                for dt in (torch.float32, torch.bfloat16):
                    if not N.narrow_fits(n_off, cin, cout, dt):
                        continue
                    want = lib.narrow_conv_smem(n_off, cin, cout,
                                                cuda_build.dtype_code(dt))
                    if N.smem_bytes(n_off, cin, cout, dt) != want:
                        raise SystemExit(f"narrow.smem_bytes{(n_off, cin, cout)}"
                                         f" {dt} differs from the kernel's "
                                         f"{want}")
    lv = plan.levels[0]
    x = _randn(gen, (lv.valid.shape[0], 3), torch.float32)
    w = _randn(gen, (125, 3, 32), torch.float32, 375 ** -0.5)
    grown, outs = {}, {}
    for path in ("narrow", "wide"):
        table = plan.stem_nbr.clone()
        lists = SC.gather_pairs.launches
        out, grown[path] = requested_growth(
            lambda: SC.gather_conv(x, table, w, lv.valid,
                                   narrow=None if path == "narrow" else False))
        grown[path] = (grown[path], SC.gather_pairs.launches - lists)
        outs[path] = out
        del out, table
    out_bytes = lv.valid.shape[0] * 32 * 4
    print(f"K1 at the Baseline stem 3->32: the narrow path's peak "
          f"allocation {grown['narrow'][0] / 2 ** 20:.2f} MiB (its output "
          f"{out_bytes / 2 ** 20:.2f} MiB), {grown['narrow'][1]} pair lists "
          f"built; the wide path's {grown['wide'][0] / 2 ** 20:.2f} MiB, "
          f"{grown['wide'][1]} pair list; fp32 outputs of the two paths "
          f"bit-equal; narrow.smem_bytes equal to the kernel's", flush=True)
    if grown["narrow"][0] > out_bytes or grown["narrow"][1]:
        raise SystemExit("K1's narrow path allocated more than its output "
                         "or built a pair list")
    if not torch.equal(outs["narrow"], outs["wide"]):
        raise SystemExit("K1's narrow and wide paths differ in fp32 at the "
                         "Baseline stem")


def narrow_wgrad_check(plan, hybrid, gen):
    """K4's narrow path at the Baseline's stem dW (the step's form,
    ``gather_wgrad(x, nbr, dy, None)``) builds no pair list and allocates
    its output and split scratch alone (on a fresh copy of the stem table,
    which no list was built for), where the wide path builds the table's
    list and its workspace; two calls of each narrow path, K4's and K11's
    (the dense stem's dW on level 0's cached row list of ``hybrid``, whose
    ticket it leaves at 0), are bit-equal in fp32 and bf16; and ``narrow.wgrad_smem_bytes`` equals the library's
    ``narrow_wgrad_smem`` on every shape the narrow path takes at 8, 27
    and 125 offsets."""
    from segdino3d_tpu_torch.ops import block_dense as BD
    from segdino3d_tpu_torch.ops import cuda_build
    from segdino3d_tpu_torch.ops import narrow as N
    from segdino3d_tpu_torch.ops import sparse_conv as SC

    lib = cuda_build.library("gather_wgrad")
    for n_off in (8, 27, 125):
        for cin in range(1, N.KERNEL_MAX_CIN + 1):
            for cout in (1, 32, 38, 64, 96):
                for dt in (torch.float32, torch.bfloat16):
                    if not N.wgrad_fits(n_off, cin, cout, dt):
                        continue
                    want = lib.narrow_wgrad_smem(n_off, cin, cout,
                                                 cuda_build.dtype_code(dt))
                    if N.wgrad_smem_bytes(n_off, cin, cout, dt) != want:
                        raise SystemExit(
                            f"narrow.wgrad_smem_bytes{(n_off, cin, cout)} "
                            f"{dt} differs from the kernel's {want}")
    lv = plan.levels[0]
    v0 = lv.valid.shape[0]
    x = _randn(gen, (v0, 3), torch.float32)
    dy = torch.where(lv.valid[:, None],
                     _randn(gen, (v0, 32), torch.float32), 0.0)
    grown = {}
    for path in ("narrow", "wide"):
        table = plan.stem_nbr.clone()
        lists = SC.gather_pairs.launches
        out, grown[path] = requested_growth(
            lambda: SC.gather_wgrad(x, table, dy, None,
                                    narrow=None if path == "narrow"
                                    else False))
        grown[path] = (grown[path], SC.gather_pairs.launches - lists)
        del out, table
    splits = SC.wgrad_splits(v0, 125, 3, 32)
    # the output and the split scratch
    own = sum(n * 125 * 3 * 32 * 4 for n in (1, splits))
    print(f"K4 at the Baseline stem dW 125x3x32: the narrow path's peak "
          f"allocation {grown['narrow'][0] / 2 ** 20:.3f} MiB (its output "
          f"and {splits} splits' scratch {own / 2 ** 20:.3f} MiB), "
          f"{grown['narrow'][1]} pair lists built; the wide path's "
          f"{grown['wide'][0] / 2 ** 20:.3f} MiB, {grown['wide'][1]} pair "
          f"list", flush=True)
    if grown["narrow"][0] > own or grown["narrow"][1]:
        raise SystemExit("K4's narrow path allocated more than its output "
                         "and scratch or built a pair list")
    t = hybrid.blocks[0]
    occ = BD.occupancy(t)
    rows = BD.row_list(t, occ)
    narrow = (SC.gather_wgrad.narrow.launches, BD.block_wgrad.narrow.launches)
    for dt in (torch.float32, torch.bfloat16):
        x, dy = _randn(gen, (v0, 3), dt), _randn(gen, (v0, 32), dt)
        xd = _randn(gen, (occ.shape[0], 3), dt)
        dyd = torch.where(occ[:, None],
                          _randn(gen, (occ.shape[0], 32), dt), 0.0)
        for what, call in (
                ("K4", lambda: SC.gather_wgrad(x, plan.stem_nbr, dy, None)),
                ("K11", lambda: BD.block_wgrad(xd, dyd, t.block_nbr, occ,
                                               t.edge, 5, rows))):
            if not torch.equal(call(), call()):
                raise SystemExit(f"{what}'s narrow path: two calls differ "
                                 f"in {dt}")
    torch.cuda.synchronize()
    if (SC.gather_wgrad.narrow.launches - narrow[0],
            BD.block_wgrad.narrow.launches - narrow[1]) != (4, 4) or \
            int(rows.ws[occ.shape[0] + 1]) != 0:
        raise SystemExit("K4 or K11 at the Baseline stem dW: not on the "
                         "narrow path, or the row list's ticket left set")
    print("K4's and K11's narrow paths at the Baseline stem dW: two calls "
          "bit-equal in fp32 and bf16; narrow.wgrad_smem_bytes equal to "
          "the kernel's", flush=True)


def narrow_wgrad_cases(cases, gen, plan):
    """K4 at the Baseline's stem dW in the form its device-plan step runs
    (x gathered, unmirrored, dY masked by the level's validity), on the
    narrow path the rule picks and on the wide path forced, each fp32 and
    bf16 and held to the plain version (1e-4 x max fp32, 1e-2 x max
    bf16)."""
    from segdino3d_tpu_torch.ops import sparse_conv as SC

    lv = plan.levels[0]
    v0, nbr = lv.valid.shape[0], plan.stem_nbr
    live = int((nbr >= 0).sum())
    for path, forced in (("narrow path", None), ("wide path, forced",
                                                 False)):
        per = {}
        for dt in (torch.float32, torch.bfloat16):
            x = _randn(gen, (v0, 3), dt)
            dy = torch.where(lv.valid[:, None], _randn(gen, (v0, 32), dt),
                             0.0)
            per[dt] = (
                lambda x=x, dy=dy, f=forced: SC.gather_wgrad(x, nbr, dy,
                                                             None, narrow=f),
                lambda x=x, dy=dy: SC.gather_wgrad_plain(x, nbr, dy, None,
                                                         125, v0),
                lambda x=x, dy=dy: wgrad_library(x, nbr, dy, None, False),
                2.0 * live * 3 * 32, nbytes(x, nbr, dy) + 125 * 3 * 32 * 4,
                CONV_PEAK[dt], WGRAD_TOL if dt == torch.float32 else 1e-2)
        cases.append(("gather_wgrad", f"baseline stem dW k5 3->32 L0 (x "
                      f"gathered, unmirrored, as the step runs it; {path}); "
                      f"{live} live pairs of {125 * v0}", per))


def baseline_cases(batch, hybrid, gen):
    """The Baseline's new shapes (rgb alone, Cin 3) on the main scene's
    plan: K1 at the k5 stem 3->32 (fp32, bf16: 12- and 6-byte rows) on its
    narrow path, the wide path timed beside it, K3 as the voxel mean from
    the one 3-channel colour source and K4 at the stem's 125x3x32 dW on
    both paths (K10's dense stem and K11's stem dW are in
    ``dense_cases``); the narrow paths' allocation and bit-equality
    checks."""
    plan = batch.plan
    lv = plan.levels
    v0 = lv[0].valid.shape[0]
    cases = []
    narrow_stem_check(plan, gen)
    narrow_wgrad_check(plan, hybrid, gen)
    conv_case(cases, gen, "baseline stem k5 3->32 L0 (narrow path)", v0,
              plan.stem_nbr, lv[0].valid, 3, 32, wide=True)
    voxel_mean_cases(cases, gen, plan, batch.points.shape[1], rgb_only=True)
    narrow_wgrad_cases(cases, gen, plan)
    return cases


def flat_compaction(c):
    """K8's outputs as one int32 vector, to compare."""
    parts = [c.inverse, c.coords_T.reshape(-1), c.valid.to(torch.int32),
             c.num_voxels.reshape(1)]
    return torch.cat(parts + ([c.kpos] if c.kpos is not None else []))


def profiled_events(fn, lead):
    """The device events (kernels, copies, memsets) of one call of
    ``fn()``, by ``torch.profiler``, in a trace that first runs ``lead()``
    and a marker kernel (``torch.cuda._sleep``); only the events after the
    marker count.  A trace can lose its first device events: phase 11's
    eager forward lost its first 1 to 17 hand-written launches (K3's CSR
    and voxel mean, K1's stem conv and its pair list) in some traces of a
    long-lived process, also after a warm-up step of the profiler's
    schedule and after 20 ms of idle time at the trace's start.  A trace
    that lost the marker is taken again (up to six times)."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(6):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            lead()
            torch.cuda.synchronize()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        marks = [i for i, e in enumerate(events) if "spin_kernel" in e.name]
        if marks:
            return events[marks[-1] + 1:]
        print(f"profiled_events: the trace lost its marker (attempt "
              f"{attempt + 1}, {len(events)} device events)", flush=True)
    raise SystemExit("profiled_events: the profiler kept no marker")


def device_ops(fn, prepare=tuple):
    """(names of the kernels, copies and memsets that one call of
    ``fn(*prepare())`` puts on the card, their summed device time in us),
    by ``profiled_events`` with a call on other ``prepare()`` arguments as
    its lead, ``prepare`` called outside the trace.  A trace that holds no
    device event of the call is taken again (up to six times): every call
    measured here puts work on the card, and the profiler has returned an
    empty trace for a one-kernel call, twice in a row for another."""
    for attempt in range(6):
        first, second = prepare(), prepare()
        events = profiled_events(lambda: fn(*second), lambda: fn(*first))
        if events:
            break
        print(f"device_ops: an empty trace (attempt {attempt + 1})",
              flush=True)
    else:
        raise SystemExit("device_ops: the profiler kept no device event")
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


# what a kernel's library call is, where the line names it: K10's is the
# whole of it in the case's dtype, beside "conv3d alone"
LIBRARY_CALL = {"block_conv": "library (halo assembly + cuDNN conv3d)"}


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
            k_ms, p_ms = time_ms(kfn), time_ms(pfn, 3)
            l_ms = None if lfn is None else time_ms(lfn)
            extra_ms = {k: time_ms(fn, 3) for k, fn in extra.items()}
            extra_text = "".join(
                f", {k} {extra_ms[k]:.4f} ms (profiled device time "
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
                  f"{LIBRARY_CALL.get(kernel, 'library')} "
                  + ("none" if l_ms is None else f"{l_ms:.4f} ms") +
                  f"{extra_text}, bound {b_ms:.4f} ms ({b_by})", flush=True)
            if not ok:
                raise SystemExit(f"{kernel} [{name}] {dts} disagrees with "
                                 f"its plain version")
            row = rows.setdefault(kernel, dict(max_abs_err=0.0, cases=[],
                                               bf16_cases=[]))
            if dt == torch.bfloat16:
                row["bf16_cases"].append(dict(
                    shape=name, ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                    bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                    **({"beside_ms": extra_ms} if extra_ms else {})))
            if dt == torch.float32:
                row["max_abs_err"] = max(row["max_abs_err"], err)
                row["cases"].append(dict(
                    shape=name, ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                    bound_ms=b_ms, bound_by=b_by, max_abs_err=err))
                row.setdefault("headline", dict(row["cases"][-1], case=name))
    return rows


# the distinct (level, Cin, Cout) of the hybrid forward's 46 K10 convs:
# the BasicBlocks of Res16UNet34C (blocks 1-4 down, 5-8 up with the skip)
HYBRID_K10_SHAPES = ((1, 32, 32), (2, 32, 64), (2, 64, 64), (3, 64, 128),
                     (3, 128, 128), (4, 128, 256), (4, 256, 256),
                     (3, 384, 256), (3, 256, 256), (2, 192, 128),
                     (2, 128, 128), (1, 128, 96), (1, 96, 96), (0, 128, 96),
                     (0, 96, 96))


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

    def conv_case(name, t, cin, cout, k, dtypes, dx=False, wide=False,
                  live=False):
        """The forward under the occupancy mask, or (``dx``) the input
        gradient's role: flipped, transposed weights on an input that is
        zero outside the occupancy, under the occupancy's k-dilation as
        the backward runs it, held to the plain version without a mask on
        every cell.  With ``wide``, K10's wide path (the per-offset stage
        loop) forced and timed beside it.  With ``live``, the live-pair
        path (the input stated zero outside the occupancy, over the level's
        live-pair list) held to its plain version, the row-tile path forced
        and the list's build timed beside it; fp32 bit-equal to the
        row-tile path."""
        occ = BD.occupancy(t)
        # the level's cached list of the mask, as the autograd Function
        # passes it: the dilation's (dX) or the occupancy's
        mask, rlist = BD.dilated_rows(occ, t.block_nbr, t.edge, k) if dx \
            else (occ, BD.row_list(t, occ))
        need, dense = pairs(t, k, masked=not dx)
        rows = int(mask.sum())
        per = {}
        for dt in dtypes:
            # a bf16 stem at the aligned pitch, as the backbone gives it
            x = pitched(torch.where(occ[:, None], _randn(
                gen, (occ.shape[0], cin), dt), 0.0), 1)
            w = pitched(_randn(gen, (k ** 3, cin, cout), dt,
                               (k ** 3 * cin) ** -0.5), 1)
            ci = x.shape[1]
            h = (k - 1) // 2
            b, e = t.num_blocks, t.edge
            wc = w.reshape(k, k, k, ci, cout).permute(4, 3, 0, 1, 2
                                                      ).contiguous()
            padded = to_ncdhw(BD.halo_pad_plain(x.reshape(b, e, e, e, ci),
                                                t.block_nbr, h))

            def lib(x=x, wc=wc, b=b, e=e, h=h, ci=ci):
                p = to_ncdhw(BD.halo_pad_plain(x.reshape(b, e, e, e, ci),
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
            extra = {"library without the halo assembly (conv3d alone)":
                     lambda p=padded, wc=wc: F.conv3d(p, wc)}
            if live:
                lp = BD.live_pairs(t, occ, k)
                kernel = (lambda x=x, w=w, lp=lp: BD.block_conv(
                    x, t.block_nbr, w, occ, e, rlist, zero_outside=True,
                    live_list=lp))
                extra["the row-tile path (forced)"] = \
                    lambda x=x, w=w: BD.block_conv(x, t.block_nbr, w, occ, e,
                                                   rlist, live=False)
                extra["live-pair list build (block_live_pairs, once per "
                      "level and step)"] = \
                    lambda: BD.live_pair_list(rlist, occ, t.block_nbr, e, k,
                                              BD.live_capacity(t))
                got, tiles = kernel(), extra["the row-tile path (forced)"]()
                full = BD.dense_subm_conv_plain(x, t.block_nbr, w, occ, e)
                if not torch.allclose(got.float(), full.float(),
                                      rtol=TOL[dt], atol=TOL[dt]) or (
                        dt == torch.float32 and not torch.equal(got, tiles)):
                    raise SystemExit(f"block_conv [{name}] {dt}: the "
                                     "live-pair path differs from the "
                                     "row-tile plain version or, in fp32, "
                                     "from the row-tile path")
                print(f"block_conv [{name}] {dt}: within rtol=atol="
                      f"{TOL[dt]:g} of the row-tile plain version"
                      + (", bit-equal to the row-tile path"
                         if dt == torch.float32 else ""), flush=True)
                del got, tiles, full
                per[dt] = (kernel, lambda x=x, w=w, lp=lp:
                           BD.block_conv_live_plain(x, w, lp),
                           lib, 2.0 * need * cin * cout,
                           nbytes(x, w) + 4 * int(occ.sum())
                           + occ.shape[0] * cout * x.element_size(),
                           CONV_PEAK[dt], extra)
                continue
            if wide:
                extra["the wide path"] = \
                    lambda x=x, w=w: BD.block_conv(x, t.block_nbr, w, mask,
                                                   e, rlist, narrow=False)
                if dt == torch.float32 and not torch.equal(
                        BD.block_conv(x, t.block_nbr, w, mask, e, rlist),
                        extra["the wide path"]()):
                    raise SystemExit(f"block_conv [{name}]: the narrow and "
                                     "wide paths differ in fp32")
            per[dt] = (lambda x=x, w=w: BD.block_conv(
                           x, t.block_nbr, w, mask, e, rlist),
                       lambda x=x, w=w: BD.dense_subm_conv_plain(
                           x, t.block_nbr, w, None if dx else occ, e),
                       lib, 2.0 * need * cin * cout,
                       nbytes(x, t.block_nbr, w, mask)
                       + occ.shape[0] * cout * x.element_size(),
                       CONV_PEAK[dt], extra)
        ops, us = device_ops(per[dtypes[0]][0])
        print(f"block_conv [{name}]: one call puts {len(ops)} operations on "
              f"the card, {us:.1f} us of device time: {ops}", flush=True)
        dense_ms = bound(2.0 * dense * cin * cout, 0.0, "fp32")[0]
        rows_ms = bound(2.0 * rows * k ** 3 * cin * cout, 0.0, "fp32")[0]
        what = (f"dilation {rows} rows = {rows / occ.shape[0]:.1%} of the "
                f"cells, {rows / int(occ.sum()):.2f}x the occupied"
                if dx else f"{rows} occupied rows")
        if live:
            live_ms = bound(2.0 * need * cin * cout, 0.0, "fp32")[0]
            what += (f", {int(need)} live pairs (live-pair path; bound of "
                     f"the live pairs {live_ms:.4f} ms)")
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
    conv_case("dense stem k5 259->32 L0", t0, 259, 32, 5, both, live=True)

    def live_list_case(t, k):
        """The live-pair list of the level's occupied-row list (one pass,
        two launches), held exactly to its plain version: the counts,
        each offset's pairs and the map over the listed rows.  Bytes: the
        row list, the occupancy and the shell table read once; the map
        over the listed rows and the pairs written once."""
        occ = BD.occupancy(t)
        rlist = BD.row_list(t, occ)
        cap = BD.live_capacity(t)
        n_list = int(rlist.count)

        def flat(lp):
            c = lp.counts.tolist()
            return torch.cat([lp.counts] + [lp.src[o, :n] for o, n in
                                            enumerate(c)]
                             + [lp.dst[o, :n] for o, n in enumerate(c)]
                             + [lp.map[:, :n_list].reshape(-1)])

        def build():
            return BD.live_pair_list(rlist, occ, t.block_nbr, t.edge, k, cap)

        def plain():
            return flat(BD.live_pairs_plain(rlist, occ, t.block_nbr, t.edge,
                                            k, cap))

        n_pairs = int(build().counts.sum())
        cases.append(("block_live_pairs", f"k{k} live-pair list of the L0 "
                      f"occupancy's row list, {n_list} listed rows, {n_pairs} "
                      "live pairs; library: none", {f32: (
                          (build, lambda: flat(build())), plain, None, 0.0,
                          nbytes(rlist.rows[:n_list], occ, t.block_nbr)
                          + 4 * (k ** 3 * n_list + 2 * n_pairs + k ** 3),
                          "fp32", exact)}))

    live_list_case(t0, 5)
    # the Baseline's dense stem over rgb alone, on the same L0 row list
    conv_case("baseline dense stem k5 3->32 L0 (narrow path)", t0, 3, 32, 5,
              both, wide=True)
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

    def wgrad_case(name, t, cin, cout, k, dt=f32, narrow=None, live=False):
        """K11 over the level's row list; with ``live``, the live-pair path
        over the level's live-pair list (the input stated zero outside the
        occupancy), held to its plain version, the row-tile path forced
        and the list's build timed beside it."""
        occ = BD.occupancy(t)
        need, dense = pairs(t, k, masked=True)
        every = all_pairs(t, k)
        x = pitched(torch.where(occ[:, None], _randn(
            gen, (occ.shape[0], cin), dt), 0.0), 1)
        dy = torch.where(occ[:, None],
                         _randn(gen, (occ.shape[0], cout), dt), 0.0)
        b, e, h, ci = t.num_blocks, t.edge, (k - 1) // 2, x.shape[1]

        def lib():
            p = to_ncdhw(BD.halo_pad_plain(x.reshape(b, e, e, e, ci),
                                           t.block_nbr, h))
            return torch.nn.grad.conv3d_weight(
                p, (cout, ci, k, k, k), to_ncdhw(dy.reshape(b, e, e, e,
                                                            cout)))

        dense_ms = bound(2.0 * dense * cin * cout, 0.0, "fp32")[0]
        all_ms = bound(2.0 * every * cin * cout, 0.0, "fp32")[0]
        live_ms = bound(2.0 * need * cin * cout, 0.0, "fp32")[0]
        rlist = BD.row_list(t, occ)
        kernel = (lambda: BD.block_wgrad(x, dy, t.block_nbr, occ, e, k,
                                         rlist, narrow))
        plain = (lambda: BD.block_wgrad_plain(x, dy, t.block_nbr, occ, e,
                                              k))
        extra = {"row list build (block_rows, once per level and step)":
                 lambda: BD.occupied_rows(occ)}
        if live:
            lp = BD.live_pairs(t, occ, k)
            kernel = (lambda: BD.block_wgrad(x, dy, t.block_nbr, occ, e, k,
                                             rlist, zero_outside=True,
                                             live_list=lp))
            full = plain()
            if not bool(torch.equal(kernel(), kernel())) or float(
                    (kernel() - full).abs().max()) > (
                        WGRAD_TOL if dt == f32 else 1e-2) * float(
                    full.abs().max()):
                raise SystemExit(f"block_wgrad [{name}]: the live-pair path "
                                 "differs between two calls or from the "
                                 "row-tile plain version")
            print(f"block_wgrad [{name}]: two calls bit-equal, within the "
                  "tolerance of the row-tile plain version", flush=True)
            del full
            plain = (lambda: BD.block_wgrad_live_plain(x, dy, lp))
            extra = {"the row-tile path (forced)": lambda: BD.block_wgrad(
                         x, dy, t.block_nbr, occ, e, k, rlist, live=False),
                     "live-pair list build (block_live_pairs, once per "
                     "level and step)": lambda: BD.live_pair_list(
                         rlist, occ, t.block_nbr, e, k, BD.live_capacity(t))}
        cases.append(("block_wgrad", f"{name}, fill {fill(t):.1%}, "
                      f"{int(every)} pairs with a source block (all-pairs "
                      f"bound {all_ms:.4f} ms), {int(need)} with an occupied "
                      f"source (live-pair bound {live_ms:.4f} ms), dense-work "
                      f"bound {dense_ms:.4f} ms (fp32)"
                      + ("; live-pair path" if live else ""), {dt: (
                          kernel, plain, lib, 2.0 * need * cin * cout,
                          nbytes(x, dy, t.block_nbr, occ)
                          + k ** 3 * cin * cout * 4, CONV_PEAK[dt],
                          WGRAD_TOL if dt == f32 else 1e-2, extra)}))

    wgrad_case("dW k3 96->96 L0", t0, 96, 96, 3)
    wgrad_case("stem dW k5 259->32 L0", t0, 259, 32, 5, live=True)
    # the Baseline's dense stem dW, on the narrow path the rule picks and
    # on the wide path forced
    for dt in (f32, torch.bfloat16):
        wgrad_case("baseline stem dW k5 3->32 L0 (narrow path)", t0, 3, 32,
                   5, dt)
        wgrad_case("baseline stem dW k5 3->32 L0 (wide path, forced)", t0, 3,
                   32, 5, dt, narrow=False)

    # the bf16 backbone (phase 10): K10 at every other distinct (level,
    # Cin, Cout) of the hybrid forward (k3 96->96 L0 and 384->256 L3 are
    # above), fp32 beside each; its dX role; K11's stem dW at the pitch
    for li, cin, cout in HYBRID_K10_SHAPES:
        if (li, cin, cout) not in ((0, 96, 96), (3, 384, 256)):
            conv_case(f"k3 {cin}->{cout} L{li}", plan.blocks[li], cin, cout,
                      3, both)
    conv_case("dX k3 96->96 L0 (flipped, transposed W, under the "
              "dilation)", t0, 96, 96, 3, (torch.bfloat16,), dx=True)
    wgrad_case("stem dW k5 259->32 L0 at the bf16 pitch 264", t0, 259, 32, 5,
               torch.bfloat16, live=True)
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

def rgb_only(rec):
    """A record as the reader gives it without 2D features (the
    Baseline's ``root_points_2dfeats=None``)."""
    return dict(rec, points_2dfeats=None, query2d_feats=None,
                query2d_pos=None)


def make_records(n_classes=SCENE["n_classes"]):
    from segdino3d_tpu_torch.data.synthetic import synthetic_scene

    rec = synthetic_scene(0, **dict(SCENE, n_classes=n_classes))
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
            # of K1's and K10's launches, those on the narrow path (the
            # Baseline's 3-channel stem)
            "gather_gemm_conv narrow": (SC.gather_conv.narrow,),
            # of K1's launches, those on the bf16 wide-stem path
            "gather_gemm_conv wide stem": (SC.gather_conv.wide_stem,),
            "up_conv": (SC.up_conv_rows,),
            "segment_mean_gather": (SS.segment_mean_gather,),
            # the CSR of K3's segments (two launches around torch.sort),
            # one per segment set and forward
            "segment_csr": (SS.segment_csr,),
            "gather_wgrad": (SC.gather_wgrad,),
            # of K4's and K11's launches, those on the narrow path (the
            # Baseline's 3-channel stem dW)
            "gather_wgrad narrow": (SC.gather_wgrad.narrow,),
            "segment_grad": (SS.segment_grad,),
            "coord_hash": (TQ.build_and_lookup, TQ.lookup_hash),
            "neighbor_table": (SC.neighbor_table, SC.neighbor_tables),
            "voxel_compact": (TV.voxel_compact,),
            "slot_gather": (BD.slot_gather,),
            "block_conv": (BD.block_conv,),
            "block_conv narrow": (BD.block_conv.narrow,),
            "block_dilate": (BD.dilated_rows,),
            "block_wgrad": (BD.block_wgrad,),
            "block_wgrad narrow": (BD.block_wgrad.narrow,),
            # of K10's and K11's launches, those on the live-pair path (the
            # flagship's dense stem in training), and the live-pair lists
            # they share (block_live_pairs, once per level and step)
            "block_conv live": (BD.block_conv.live,),
            "block_wgrad live": (BD.block_wgrad.live,),
            "block_live_pairs": (BD.live_pair_list,),
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
# the narrow-path counts of a phase whose convs all take the wide paths
# (the flagship and the v2 model)
NO_NARROW = {"gather_gemm_conv narrow": 0, "block_conv narrow": 0,
             "gather_wgrad narrow": 0, "block_wgrad narrow": 0}
# the live-pair counts of a phase without a dense k5 stem in training
NO_LIVE = {"block_conv live": 0, "block_wgrad live": 0,
           "block_live_pairs": 0}


def step_kernel_ms(run, lead):
    """Device ms of K1 (its products and sums; the pair lists it shares with
    K4 apart), K4 (its tiles and split sums; its pair lists apart) and K11
    (the same; its row lists are K10's row-list kernels and are not told
    apart from K10's own), and of all device work, in one call of ``run``
    (one training step), by ``profiled_events`` after ``lead`` (another
    step)."""
    return kernel_ms(profiled_events(run, lead))


def kernel_ms(events):
    """{K1, K2, K3, K4, K4 pair lists, K10, K11, the live-pair list,
    device}: summed device ms of ``events``; and the count of K10's
    row-list launches."""
    ms = dict.fromkeys(("K1", "K2", "K3", "K4", "K4 pair lists", "K10",
                        "K11", "live-pair list", "device"), 0.0)
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
        if any(f in n for f in CLI_STEP_KERNELS["gather_gemm_conv"]):
            ms["K1"] += t
        elif "up_conv_kernel" in n:
            ms["K2"] += t
        elif "segment_mean_kernel" in n:
            ms["K3"] += t
        elif any(f in n for f in CLI_STEP_KERNELS["block_conv"]):
            ms["K10"] += t
        elif "gather_wgrad_kernel" in n or "gather_wgrad_narrow_kernel" in n \
                or ("sum_splits" in n and ("ListPairs" in n
                                           or "TableRows" in n)):
            ms["K4"] += t
        elif "count_pairs_kernel" in n or "list_pairs_kernel" in n:
            ms["K4 pair lists"] += t
        elif "count_live_kernel" in n or "list_live_kernel" in n:
            ms["live-pair list"] += t
        elif "block_wgrad_kernel" in n or "block_wgrad_narrow_kernel" in n \
                or ("sum_splits" in n and ("HaloPairs" in n
                                           or "ListedRows" in n
                                           or "LivePairs" in n)):
            ms["K11"] += t
    return ms


def dispatched(run):
    """[(operator, its output's shape or None)] of every operator that
    ``run()`` dispatches, in order (a ``TorchDispatchMode``: the wrappers'
    direct kernel launches are not operators)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            self.calls.append((func.overloadpacket, tuple(out.shape)
                               if isinstance(out, torch.Tensor) else None))
            return out

    with Record() as mode:
        run()
    return mode.calls


def concat_shapes(run):
    """The output shapes of every ``aten::cat`` that ``run()`` dispatches
    (the profiler records no shapes of a tensor list)."""
    return [shape for op, shape in dispatched(run)
            if op is torch.ops.aten.cat]


def forward_device_ms(model, batch, cols=259):
    """({K1, K2, K3, K10, device} ms of one eval forward, backbone and
    decoder, by ``profiled_events`` after a lead forward of the same
    batch (its pair and row lists built already); the (N, cols)
    concatenations of one more, the early-fused point features the forward
    no longer builds, unless ``cols`` is None (one column source: nothing
    to concatenate))."""
    def forward():
        with torch.no_grad():
            model.decode(batch, model.backbone(batch))
        torch.cuda.synchronize()

    ms = kernel_ms(profiled_events(forward, forward))
    if cols is None:
        return ms, []
    n = batch.points.shape[0] * batch.points.shape[1]
    return ms, [
        sh for sh in concat_shapes(forward) if sh == (n, cols)]


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
    stage holds the device plan).  The ScanNet v2 layout scores with the
    v2 evaluator (20 classes), the others with the ScanNet200 one."""
    from segdino3d_tpu_torch.data.collate import (attach_host_plan, collate,
                                                  eval_annotation)
    from segdino3d_tpu_torch.evaluation.evaluate import (host_prediction,
                                                         postprocess)
    from segdino3d_tpu_torch.data import scannet_constants as SC
    from segdino3d_tpu_torch.evaluation.evaluator import InstanceSeg3DEvaluator

    if layout == "v2":
        evaluator = InstanceSeg3DEvaluator(SC.SCANNET20_RAW_IDS,
                                           SC.SCANNET20_CLASS_NAMES)
        bg_class_id = 20
    else:
        evaluator = InstanceSeg3DEvaluator(SC.SCANNET200_RAW_IDS,
                                           SC.SCANNET200_CLASS_NAMES)
        bg_class_id = 200
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
            evaluator.process(
                eval_annotation(record, bg_class_id), host_prediction(
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


def check_outputs(bb, out, res, s_cap, width=96, n_inst=198, n_sem=200):
    """Shapes (``width`` backbone channels, ``n_inst`` and ``n_sem``
    classes) and finite values of the eval path's outputs."""
    checks = {"sp_feats": bb.sp_feats, "cls_preds": out["cls_preds"],
              "masks": out["masks"], "sem_preds": out["sem_preds"],
              "centers": out["centers"], "sizes": out["sizes"]}
    shapes = {"sp_feats": (1, s_cap, width),
              "cls_preds": (1, s_cap, n_inst + 1),
              "masks": (1, s_cap, s_cap), "sem_preds": (1, s_cap, n_sem + 1),
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


def check_small_reference(model, plans=("host", "device"), tol=None):
    """The card's forward (kernels) against the CPU's plain path, same
    weights, on a small scene, on a host plan ("host", or the v2 model's
    "v2") and on a device plan (K6-K8 on the card; the device plan's
    capacity is the scene's point count), at rtol = atol = 1e-3, and on a
    hybrid host plan ("hybrid" or the Baseline's "baseline", K9 and K10)
    or one with the compacted stem ("compact", K12) at 1e-4.  An rgb-only
    model gets the scene without its 2D features; ``tol`` overrides the
    tolerance (a bf16 backbone, phase 10a).
    Compared before any attention threshold: the superpoint features and
    the first head's class and mask logits."""
    from segdino3d_tpu_torch.data.collate import PadSpec, attach_host_plan, \
        collate
    from segdino3d_tpu_torch.data.synthetic import synthetic_scene

    rec = [synthetic_scene(1, n_points=4000, n_instances=6, n_superpoints=128,
                           n_classes=180, feat_dim_2d=256)]
    if model.backbone.mode_fuse_2d_feat == "only_rgb":
        rec = [rgb_only(r) for r in rec]
    spec = PadSpec(4096, SCENE["n_superpoints"], 16, 16, 200)
    cpu_model = copy.deepcopy(model).cpu()
    cpu_model.backbone.voxel_cap = None
    card_cap, model.backbone.voxel_cap = model.backbone.voxel_cap, None
    try:
        for plan in plans:
            outs = {}
            t = tol or (1e-4 if plan in ("hybrid", "compact", "baseline")
                        else 1e-3)
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
                ok = torch.allclose(a, b, rtol=t, atol=t)
                print(f"small-scene reference, {plan} plan, {k}: "
                      f"max_abs_err={err:.3e} (rtol=atol={t:g}) "
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
                         host_out, layout="gather", n_conv=51, width=96,
                         n_inst=198, n_sem=200, tag=None):
    """Phases 3b, 5b and 6b: tables, the plan's time beside the host
    plan's (of ``layout``), then the eval path on device plans, ``n_conv``
    K1 launches a forward; ``tag`` prefixes the printed lines."""
    from segdino3d_tpu_torch.data.collate import attach_host_plan, collate

    if tag is None:
        tag = "v2 " if layout == "v2" else ""
    bare = collate(records, spec, DEVICE)
    xyz = bare.points.reshape(-1, 6)[:, :3]
    plan, overflow = model.backbone.device_plan(xyz, bare.point_valid)
    torch.cuda.synchronize()
    if bool(overflow):
        raise SystemExit("device plan overflowed at the host plan's caps")
    whole = compare_plans(plan, host_batch.plan)
    n_tables = 2 + sum(getattr(lv, k) is not None for lv in plan.levels
                       for k in PLAN_FIELDS)
    print(f"{tag}device plan equals the host plan on every valid row "
          f"(inverse, stem_nbr, each level's valid/nbr/parent/kpos/child/up_order; "
          f"{whole} of {n_tables - 1} tables equal whole)", flush=True)

    def device():
        model.backbone.device_plan(xyz, bare.point_valid)

    def host():
        attach_host_plan(bare, records, spec,
                         level_cap_ratios=LEVEL_CAP_RATIOS,
                         **plan_layout(layout))

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
    print(f"{tag}plan alone, mean of {TIMED_ITERS} (host clock, "
          f"synchronised): device {float(np.mean(plan_ms['device'])):.3f} ms "
          f"(CUDA events {dev_ms:.3f} ms), host (C++ plan + copies) "
          f"{float(np.mean(plan_ms['host'])):.3f} ms", flush=True)

    launches, times, peak, batch, bb, out, res, metrics = run_main_path(
        model, test_cfg, records, spec, device_plan=True, layout=layout)
    if batch.plan is not None:
        raise SystemExit("the device-plan run got a host plan")
    # coord_hash: one build-and-lookup launch a level (voxelize and four
    # downsamples)
    expected = {"gather_gemm_conv": n_conv, "up_conv": 4,
                "segment_mean_gather": 2, "coord_hash": 5,
                "voxel_compact": 5, "neighbor_table": 1}
    print(f"{tag}launches in one forward on a device plan: {launches} "
          f"(expected {expected})", flush=True)
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
        print(f"{tag}device-plan forward vs host-plan forward {k}: "
              f"max_abs_err={err:.3e} (rtol=atol=1e-5) "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            raise SystemExit(f"device-plan forward disagrees on {k}")
    check_outputs(bb, out, res, SCENE["n_superpoints"], width, n_inst, n_sem)
    stages = {k: 1e3 * float(np.mean([t[k] for t in times]))
              for k in times[0]}
    total = [sum(t.values()) for t in times]
    print(f"{tag}main path on device plans: {1.0 / float(np.mean(total)):.3f} "
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


def make_train_step(model, accum_steps, ema=True, cfg=None):
    """The recipe's step (AdamW/PolyLR, clip 10, EMA with ``ema``) with
    the criterion of ``cfg`` (default: the flagship's)."""
    from segdino3d_tpu_torch.builder import build_criterion
    from segdino3d_tpu_torch.parallel.train_step import TrainStep
    from segdino3d_tpu_torch.train.ema import EMA
    from segdino3d_tpu_torch.train.optim import build_optimizer

    opt = build_optimizer(model.named_parameters(), OPTIMIZER, SCHEDULER,
                          clip_max_norm=CLIP_MAX_NORM)
    return TrainStep(model, build_criterion(cfg or train_cfg()), opt,
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


def run_training(model, records, spec, layout="gather", accum=True,
                 cfg=None, ema=True):
    """A warm-up and TRAIN_STEPS measured batch-1 steps on host plans of
    ``layout`` (``plan_layout``), with the criterion of ``cfg`` and EMA
    with ``ema``, then (with ``accum``) one accum_steps=4 step over four
    scenes.  Returns (launches in one batch-1 step, per-step stage
    seconds, the accumulated step's stage seconds and launches or None,
    peak bytes, metrics)."""
    from segdino3d_tpu_torch.data.collate import attach_host_plan, collate
    from segdino3d_tpu_torch.parallel.train_step import StageClock, TrainStep

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    step1 = make_train_step(model, 1, ema, cfg)
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

    b0, _ = plan(records[0])
    b, _ = plan(records[0])
    BD.block_conv.own_lists = 0
    ms = step_kernel_ms(lambda: step1([b], generator=gen),
                        lambda: step1([b0], generator=gen))
    print(f"K1-K3, K10 and the weight gradients in one batch-1 {layout} "
          f"step (torch.profiler, device ms): K1 {ms['K1']:.4f}, K2 "
          f"{ms['K2']:.4f}, K3 {ms['K3']:.4f}, K10 {ms['K10']:.4f}, K4 "
          f"{ms['K4']:.4f} (+ pair lists {ms['K4 pair lists']:.4f}), K11 "
          f"{ms['K11']:.4f}, K10 + K11 {ms['K10'] + ms['K11']:.4f} (+ the "
          f"stem's live-pair list {ms['live-pair list']:.4f}), "
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


def small_train_records(model, cfg, n_points=4000):
    """The small sparse scene of ``check_small_train`` (500 points per m^2,
    so every U-Net level keeps enough voxels for well-conditioned batch
    norms), without its 2D features for an rgb-only model."""
    from segdino3d_tpu_torch.data.synthetic import synthetic_scene

    crit = cfg["criterion_cfg"]
    rec = [synthetic_scene(1, n_points=n_points, n_instances=6,
                           n_superpoints=128, n_classes=min(
                               180, crit["inst_criterion"]["num_classes"]),
                           feat_dim_2d=256, point_density=500.0)]
    if model.backbone.mode_fuse_2d_feat == "only_rgb":
        rec = [rgb_only(r) for r in rec]
    return rec


def check_small_train(model, layout="gather", cfg=None, n_points=4000,
                      loss_rtol=1e-4, grad_rtol=1e-3, norm_rtol=None):
    """One train step of the card (kernels) against the CPU's plain path,
    same weights and queries, on the small sparse scene of
    ``small_train_records`` with ``n_points`` points, on host plans of
    ``layout``: the losses and the gradient norm (rtol 1e-4), and each
    leaf's clipped gradient norm (rtol 1e-3, atol 1e-3 x the largest).
    (The Baseline's and the decoder options' steps take 16,000 points: at
    4,000 a 1e-6 relative change of the convs' outputs moves their
    gradient norm by up to 2.1e-4 and 1.0e-4, at 16,000 by at most 2.1e-5
    and 2.9e-6, ``tools/step_sensitivity.py``.)  A bf16 backbone (phase
    10b) is held at tolerances of its own: ``loss_rtol`` for the losses and
    ``norm_rtol`` (``loss_rtol`` unless given) for the gradient norm; with
    ``grad_rtol`` None the leaves are left to the caller.  Returns the
    card's and the CPU's {leaf: clipped gradient norm}."""
    from segdino3d_tpu_torch.data.collate import PadSpec, attach_host_plan, \
        collate

    cfg = cfg or train_cfg()
    crit = cfg["criterion_cfg"]
    rec = small_train_records(model, cfg, n_points)
    spec = PadSpec(n_points + 96, SCENE["n_superpoints"], 16, 16,
                   crit["num_semantic_classes"])
    out = {}
    for dev in (DEVICE, "cpu"):
        m = copy.deepcopy(model).to(dev)
        # sparse levels keep most voxels: every level gets the full cap
        batch = attach_host_plan(collate(rec, spec, dev), rec, spec,
                                 level_cap_ratios=(1.0,) * 5,
                                 **plan_layout(layout))
        q = numpy_queries(batch.num_superpoints.cpu().numpy(),
                          SCENE["n_superpoints"], seed=5)
        step = make_train_step(m, 1, ema=False, cfg=cfg)
        metrics = step([batch], queries=[tuple(t.to(dev) for t in q)])
        out[dev] = (check_metrics(step, metrics, f"small step on {dev}"),
                    {n: float(p.grad.norm()) for n, p in m.named_parameters()})
    (mc, gc), (mp, gp) = out[DEVICE], out["cpu"]
    for k in mp:
        rtol = norm_rtol if k == "grad_norm" and norm_rtol else loss_rtol
        ok = np.isclose(mc[k], mp[k], rtol=rtol, atol=0)
        print(f"small-scene train step ({layout}) {k}: card "
              f"{mc[k]:.6f} cpu {mp[k]:.6f} "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            raise SystemExit(f"card train step disagrees with the CPU on {k}")
    if grad_rtol is None:
        return gc, gp
    scale = max(gp.values())
    worst = max(gp, key=lambda n: abs(gc[n] - gp[n]) / (
        grad_rtol * scale + grad_rtol * gp[n]))
    bad = [n for n in gp if not np.isclose(gc[n], gp[n], rtol=grad_rtol,
                                           atol=grad_rtol * scale)]
    print(f"small-scene train step ({layout}): {len(gp)} "
          f"gradient leaves, worst {worst} "
          f"card {gc[worst]:.6g} cpu {gp[worst]:.6g} (rtol {grad_rtol:g}, "
          f"atol {grad_rtol * scale:.3g}) {'ok' if not bad else 'MISMATCH'}",
          flush=True)
    if bad:
        raise SystemExit(f"card gradients disagree with the CPU on {bad[:5]}")
    return gc, gp


def check_bf16_leaves(gc, gp):
    """Phase 10b's gradient leaves (each clipped gradient's norm), card
    against CPU, each relative to its own CPU value: every backbone leaf
    within ``BF16_LEAF_RTOL``, the median over all leaves within
    ``BF16_LEAF_MEDIAN``."""
    rel = {n: abs(gc[n] - gp[n]) / gp[n] if gp[n] else
           (0.0 if gc[n] == 0.0 else float("inf")) for n in gp}
    backbone = [n for n in rel if n.startswith("backbone.")]
    worst = max(backbone, key=rel.get)
    median = float(np.median(list(rel.values())))
    bad = [n for n in backbone if not rel[n] <= BF16_LEAF_RTOL]
    ok = not bad and median <= BF16_LEAF_MEDIAN
    print(f"small-scene bf16 train step: {len(backbone)} backbone leaves, "
          f"worst {worst} {rel[worst]:.3e} of its own (limit "
          f"{BF16_LEAF_RTOL:g}); median over {len(rel)} leaves {median:.3e} "
          f"(limit {BF16_LEAF_MEDIAN:g}) {'ok' if ok else 'MISMATCH'}",
          flush=True)
    if not ok:
        raise SystemExit(f"card gradients disagree with the CPU: {bad[:5]}, "
                         f"median {median:.3e}")


def run_training_device(model, records, spec, n_steps=TRAIN_STEPS, cfg=None,
                        ema=True, tag=""):
    """Phases 4b and 6d: ``n_steps`` batch-1 steps on batches without a
    host plan (the backbone builds each plan in the forward), after a
    warm-up, with the criterion of ``cfg``.  The plan is also built alone
    before each step and timed, to report it."""
    from segdino3d_tpu_torch.data.collate import collate
    from segdino3d_tpu_torch.parallel.train_step import StageClock

    gen = torch.Generator(device=DEVICE).manual_seed(1)
    step = make_train_step(model, 1, ema, cfg)

    def bare(rec):
        t0 = time.perf_counter()
        b = collate([rec], spec, DEVICE)
        torch.cuda.synchronize()
        return b, time.perf_counter() - t0

    check_metrics(step, step([bare(records[0])[0]], generator=gen),
                  "device-plan warm-up step")
    steps, launches, metrics = [], None, []
    for i in range(n_steps):
        b, t_collate = bare(records[i % len(records)])
        t0 = time.perf_counter()
        _, overflow = model.backbone.device_plan(
            b.points.reshape(-1, 6)[:, :3], b.point_valid)
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
    print(f"{tag}launches in one batch-1 train step on a device plan: "
          f"{launches}", flush=True)
    for k in GATHER_STEP_KERNELS:
        if launches[k] <= 0:
            raise SystemExit(f"{tag}{k}: not launched in the device-plan "
                             "step")
    print(f"{tag}train batch 1 on device plans: {float(np.mean(total)):.4f} "
          f"s/step over {n_steps} steps (fp32; the forward builds the "
          f"plan); ms per stage " + ", ".join(f"{k} {mean[k]:.2f}"
                                             for k in keys)
          + f"; device plan alone {mean['plan_alone']:.2f} ms", flush=True)
    print(f"{tag}device-plan train metrics (finite): {metrics[-1]}",
          flush=True)
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
                "block_rows": sum(t is not None for t in plan.blocks),
                **NO_NARROW}
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
    return launches, bb.sp_feats


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


def run_disk_eval(model, test_cfg, root, layout, features_2d=True,
                  adjust_class_ids=False):
    """One pass of the eval entry point over the scenes under ``root``:
    the port's ScanNet200 reader (with the DINO-X features as fp16, or
    without ``features_2d`` none: ``root_points_2dfeats=None``; raw
    ScanNet label ids with ``adjust_class_ids``),
    ``EvalLoader`` (batch 1, the default buckets, the capacity prescan,
    one batch of prefetch) on host plans of ``layout``, and ``evaluate``
    (packed result transfer).  Returns (launches, stage ms, scenes/s, peak
    bytes, metrics, sp_feats per scene)."""
    from segdino3d_tpu_torch.data.bucketing import BucketPolicy
    from segdino3d_tpu_torch.data.loader import EvalLoader
    from segdino3d_tpu_torch.data.scannet_constants import (
        SCANNET200_CLASS_NAMES, SCANNET200_RAW_IDS)
    from segdino3d_tpu_torch.data.scannet_dataset import \
        ScanNet200InstanceSeg3D
    from segdino3d_tpu_torch.evaluation.evaluate import evaluate
    from segdino3d_tpu_torch.evaluation.evaluator import InstanceSeg3DEvaluator

    # the synthetic layout's labels are class ids already
    reader = ScanNet200InstanceSeg3D(
        scene_set="val", root_scenes=root, adjust_class_ids=adjust_class_ids,
        root_points_2dfeats=os.path.join(root, "features_2d")
        if features_2d else None, feats_2d_dtype="float16")
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
    n = loader.num_scenes
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
    return runs["compact"][0], runs["hybrid"][1]


def run_dense_training(model, records, spec):
    """Phase 4c: batch-1 steps on the config's training layout."""
    check_small_train(model, "block-dense")
    launches, steps, _, _, peak, metrics = run_training(
        model, records, spec, layout="block-dense", accum=False)
    expected = {**BLOCK_DENSE_STEP, **NO_NARROW}
    print(f"launches in one block-dense train step: {launches} (expected "
          f"{expected}: K10 47 forward (the stem's on the live-pair path) "
          f"+ 46 dX, K11 47 (the stem's on the live-pair path, on the "
          f"forward's live-pair list), per level one k3 dilation "
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


# --------------------------------------------------------------------------
# phase 4d: the training entry point from disk
# --------------------------------------------------------------------------

CLI_SEEDS = (0, 1, 2, 3)
CLI_TIMEOUT_S = 480
# the block-dense training step's kernels (phase 4c's) and the CUDA
# functions each launches, as named in the profile trace
CLI_STEP_KERNELS = {
    "slot_gather": ("slot_gather_kernel",),
    "block_conv": ("block_conv_kernel", "block_conv_narrow_kernel",
                   "block_conv_wg_kernel", "group_sum_kernel",
                   "live_products_kernel", "live_products_wg_kernel",
                   "live_sum_kernel"),
    "block_dilate": ("dilate_kernel",),
    "block_wgrad": ("block_wgrad_kernel", "block_wgrad_narrow_kernel"),
    "gather_gemm_conv": ("conv_products_kernel", "conv_pair_sum_kernel",
                         "gather_conv_narrow_kernel",
                         "conv_products_wg_kernel"),
    "up_conv": ("up_conv_kernel",),
    "gather_wgrad": ("gather_wgrad_kernel", "gather_wgrad_narrow_kernel"),
    "segment_mean_gather": ("segment_mean_kernel",),
    "segment_grad": ("segment_grad_kernel",),
    "segment_csr": ("csr_keys_kernel", "csr_offsets_kernel"),
}


def cli_config(root):
    """The flagship prototype with only the data roots and the loop's
    lengths changed (batch 4, 8 process workers, sync scale, shm)."""
    proto = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "configs", "prototypes", "SegDINO3D_ScanNet200.py")
    feats = os.path.join(root, "features_2d")
    return "\n".join([
        f"_base_ = [{proto!r}]",
        *(f"_base_.data.{split}[0].{key} = {value!r}"
          for split in ("train_main", "eval_main")
          for key, value in (("root_scenes", root),
                             ("root_points_2dfeats", feats))),
        "num_iterations = 4", "save_step = 2", "eval_step = 4",
        "print_freq = 1", ""])


def run_cli(args, what, launcher=()):
    """``python [launcher] -m segdino3d_tpu_torch.train_3d args`` in a
    child process (its own session: past ``CLI_TIMEOUT_S`` it is killed
    with its loader workers); (its stdout and stderr, wall seconds).
    Fails unless it exits 0."""
    import signal

    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, *launcher, "-m", "segdino3d_tpu_torch.train_3d",
         *args],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=CLI_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        print("\n".join(out.splitlines()[-80:]), flush=True)
        raise SystemExit(f"{what}: the CLI ran past {CLI_TIMEOUT_S} s")
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        print("\n".join(out.splitlines()[-80:]), flush=True)
        raise SystemExit(f"{what}: the CLI exited with code "
                         f"{proc.returncode}")
    return out, wall


def print_cli_lines(out, what):
    """The CLI's log lines that the phase reads, as it logged them."""
    keys = ("iter [", "resumed at", "eval", "mAP", "GiB", "profil")
    for line in out.splitlines():
        if "segdino3d_tpu_torch INFO] " in line and any(k in line
                                                       for k in keys):
            print(f"  {what}: {line.split('] ', 1)[-1]}", flush=True)


def cli_iterations(out):
    """[(step, {metric: value})] of the CLI's logged iterations."""
    import re

    its = []
    for m in re.finditer(r"iter \[(\d+)/\d+\] (.*)", out):
        vals = dict(re.findall(r"(\w+): ([-+0-9.eainfINF]+)s?", m.group(2)))
        its.append((int(m.group(1)), {k: float(v) for k, v in vals.items()}))
    return its


def trace_launches(trace_dir):
    """{kernel: CUDA launches} of ``CLI_STEP_KERNELS`` in the CLI's
    profile trace."""
    path = os.path.join(trace_dir, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    counts = dict.fromkeys(CLI_STEP_KERNELS, 0)
    for e in events:
        if e.get("cat") != "kernel":
            continue
        name = e.get("name", "")
        for k, fns in CLI_STEP_KERNELS.items():
            counts[k] += any(f in name for f in fns)
    return counts


def run_cli_phase(step4_s):
    """Phase 4d: the flagship config trained from scenes on disk by the
    CLI (run A: 4 steps, checkpoints 2 and 4, profiled steps 2-3, the
    in-loop eval building the eval cache; run B: resumed to step 6, its
    eval served from the cache).  Returns the kernels' CUDA launches per
    profiled step."""
    import re
    import shutil
    import tempfile

    from segdino3d_tpu_torch.data.synthetic import write_scannet_layout

    torch.cuda.empty_cache()
    shm = shutil.disk_usage("/dev/shm")
    print(f"/dev/shm: {shm.free / 2 ** 30:.1f} GiB free of "
          f"{shm.total / 2 ** 30:.1f}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        root, work = os.path.join(tmp, "data"), os.path.join(tmp, "work")
        t0 = time.perf_counter()
        write_scannet_layout(root, CLI_SEEDS, **SCENE)
        cfg_path = os.path.join(tmp, "cfg.py")
        with open(cfg_path, "w") as f:
            f.write(cli_config(root))
        print(f"wrote {len(CLI_SEEDS)} scenes for the CLI in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        base = ["--config_file", cfg_path, "--work_dir", work,
                "--accum_steps", "4", "--num_eval_scenes", "2"]

        out_a, wall_a = run_cli(base + ["--profile_steps", "2:3"], "run A")
        print_cli_lines(out_a, "run A")
        its = cli_iterations(out_a)
        if [s for s, _ in its] != [0, 1, 2, 3]:
            raise SystemExit(f"run A logged steps {[s for s, _ in its]}, "
                             "expected 0-3")
        for s, vals in its:
            if not all(np.isfinite(vals.get(k, np.nan))
                       for k in ("total_loss", "grad_norm")):
                raise SystemExit(f"run A step {s}: non-finite {vals}")
        ckpts = sorted(os.listdir(os.path.join(work, "checkpoints")))
        if ckpts != ["step_0000000002.pth", "step_0000000004.pth"]:
            raise SystemExit(f"run A checkpoints {ckpts}, expected 2 and 4")
        ap = re.search(r"mAP: ([0-9.]+)  mAP50: ([0-9.]+)  mAP25: "
                       r"([0-9.]+)", out_a)
        if ap is None:
            raise SystemExit("run A logged no mAP line")
        rate_a = float(re.search(r"eval: 2 scenes in [0-9.]+ s \(([0-9.]+) "
                                 r"scenes/s\)", out_a).group(1))
        caches = os.listdir(os.path.join(work, "eval_cache"))
        manifest = os.path.join(work, "eval_cache", caches[0],
                                "manifest.json")
        with open(manifest) as f:
            n_batches = json.load(f)["n_batches"]
        if len(caches) != 1 or n_batches != 2:
            raise SystemExit(f"eval cache {caches}: {n_batches} batches, "
                             "expected one namespace of 2")
        launches = trace_launches(os.path.join(work, "profile"))
        print(f"phase 4d run A: CUDA launches of the block-dense step's "
              f"kernels in profiled steps 2-3 (the trace): {launches}",
              flush=True)
        # per microbatch, phase 4c's step: its wrapper calls times the
        # CUDA functions of a call (K1, the CSR build and K10 on the
        # live-pair path launch two)
        want = {k: 2 * 4 * (BLOCK_DENSE_STEP.get(k, 2)
                            * (2 if k in ("gather_gemm_conv", "segment_csr")
                               else 1)
                            + BLOCK_DENSE_STEP.get(f"{k} live", 0)
                            * (k == "block_conv"))
                for k in CLI_STEP_KERNELS}
        if launches != want:
            raise SystemExit(f"the CLI's profiled steps launched {launches}, "
                             f"expected 2 steps x 4 microbatches of phase "
                             f"4c's step: {want}")
        peak = re.search(r"GiB in use, ([0-9.]+) GiB peak", out_a)
        cache_dir = os.path.dirname(manifest)
        mtimes = {n: os.stat(os.path.join(cache_dir, n)).st_mtime_ns
                  for n in os.listdir(cache_dir)}

        out_b, wall_b = run_cli(base + ["--resume", "--options",
                                        "num_iterations=6", "eval_step=6"],
                                "run B")
        print_cli_lines(out_b, "run B")
        if "resumed at step 4" not in out_b:
            raise SystemExit("run B did not log 'resumed at step 4'")
        its_b = cli_iterations(out_b)
        if [s for s, _ in its_b] != [4, 5]:
            raise SystemExit(f"run B logged steps {[s for s, _ in its_b]}, "
                             "expected 4 and 5")
        if not os.path.isfile(os.path.join(work, "checkpoints",
                                           "step_0000000006.pth")):
            raise SystemExit("run B wrote no checkpoint 6")
        if f"eval cache {cache_dir}: serving" not in out_b or mtimes != {
                n: os.stat(os.path.join(cache_dir, n)).st_mtime_ns
                for n in os.listdir(cache_dir)}:
            raise SystemExit("run B's eval was not served from run A's "
                             "cache unchanged")
        rate_b = float(re.search(r"eval: 2 scenes in [0-9.]+ s \(([0-9.]+) "
                                 r"scenes/s\)", out_b).group(1))
    step_s = float(np.median([v["time"] for _, v in its[1:]]))
    data_s = float(np.median([v["data"] for _, v in its[1:]]))
    print(f"phase 4d: the CLI (flagship config, batch 4 = accum_steps 4 x 1 "
          f"scene, block-dense training plans, 8 process workers, shm): "
          f"{step_s:.4f} s/step (median of logged steps 1-3, loader wait "
          f"included) beside phase 4's TrainStep alone at accum_steps=4 "
          f"(gather layout) {step4_s:.4f} s/step; loader wait "
          f"{data_s:.4f} s/step (median of steps 1-3; step 0, with the "
          f"workers' start, {its[0][1]['data']:.3f} s); in-loop eval "
          f"{rate_a:.3f} scenes/s building the eval cache, {rate_b:.3f} "
          f"served from it; peak device memory "
          f"{peak.group(1) if peak else 'not logged'} GiB; mAP "
          f"{ap.group(1)}; run A {wall_a:.1f} s, run B {wall_b:.1f} s wall",
          flush=True)
    return {k: n / 2 for k, n in launches.items()}


# --------------------------------------------------------------------------
# phase 5: the ScanNet v2 model (SpConvUNet)
# --------------------------------------------------------------------------

# a v2 forward: the k3 stem, 20 block convs and 16 tail convs, 4 down convs
# (K1); 4 up convs (K2); the voxel mean and the pool (K3) on their CSRs;
# one pair list per index table (each level's k3 table, the stem's being
# level 0's, and each child table)
V2_FORWARD = {"gather_gemm_conv": 41, "up_conv": 4, "segment_mean_gather": 2,
              "segment_csr": 2}
V2_PAIR_LISTS = 9
V2_WIDTHS = dict(width=32, n_inst=18, n_sem=20)


def v2_spec():
    from segdino3d_tpu_torch.data.collate import PadSpec

    return PadSpec(SCENE["n_points"], SCENE["n_superpoints"], 64, 128, 20)


def v2_host_batch(records):
    """The first v2 scene, collated on the card with its host plan."""
    from segdino3d_tpu_torch.data.collate import attach_host_plan, collate

    return attach_host_plan(collate(records[:1], v2_spec(), DEVICE),
                            records[:1], v2_spec(),
                            level_cap_ratios=LEVEL_CAP_RATIOS,
                            **plan_layout("v2"))


def run_v2_phase(records):
    """Phase 5 on the v2 scenes ``records``: 5a eval on host plans, 5b on
    device plans at the first scene's host-plan capacities, 5c batch-1
    training steps on host plans (the config's recipe: no EMA).  Returns
    the launches of a host-plan forward, of a device-plan forward and of a
    training step."""
    from segdino3d_tpu_torch.builder import Capacities, build_model, \
        random_init_

    s_cap = SCENE["n_superpoints"]
    spec = v2_spec()
    caps = Capacities(num_superpoints=s_cap,
                      num_voxels=v2_host_batch(records).plan.levels[0]
                      .valid.shape[0],
                      level_cap_ratios=LEVEL_CAP_RATIOS)
    cfg = v2_model_cfg()

    # 5a: eval on host plans (a k3 stem, the exact min shift)
    model, test_cfg = build_model(cfg, caps)
    random_init_(model, seed=0)
    launches, times, peak, batch, bb, out, res, metrics = run_main_path(
        model, test_cfg, records[:1], spec, layout="v2")
    print(f"v2 launches in one forward: {launches} (expected "
          f"{V2_FORWARD}, gather_pairs {V2_PAIR_LISTS})", flush=True)
    for k, n in V2_FORWARD.items():
        if launches[k] != n:
            raise SystemExit(f"v2 {k}: {launches[k]} launches, expected {n}")
    if launches["gather_pairs"] != V2_PAIR_LISTS:
        raise SystemExit(f"v2 gather_pairs: {launches['gather_pairs']} pair "
                         f"lists in one forward, expected {V2_PAIR_LISTS}")
    stages = {k: 1e3 * float(np.mean([t[k] for t in times]))
              for k in times[0]}
    total = [sum(t.values()) for t in times]
    print(f"v2 main path {plan_layout('v2')}: levels "
          f"{[int(lv.valid.sum()) for lv in batch.plan.levels]} (caps "
          f"{[lv.valid.shape[0] for lv in batch.plan.levels]}); "
          f"{1.0 / float(np.mean(total)):.3f} scenes/s over {TIMED_ITERS} "
          f"iterations (batch 1, fp32); ms per stage "
          + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
          + f"; total {1e3 * float(np.mean(total)):.2f} ms; peak "
          f"{peak / 2 ** 30:.3f} GiB", flush=True)
    print(f"v2 AP on the random-weight scene (ScanNet v2 evaluator): "
          f"all_ap={metrics['all_ap']:.4f} all_ap_50="
          f"{metrics['all_ap_50']:.4f} all_ap_25={metrics['all_ap_25']:.4f}",
          flush=True)
    check_outputs(bb, out, res, s_cap, **V2_WIDTHS)
    fwd_ms, cats = forward_device_ms(model, batch, cols=262)
    print(f"one v2 forward (torch.profiler, device ms): K1 "
          f"{fwd_ms['K1']:.4f}, K2 {fwd_ms['K2']:.4f}, K3 {fwd_ms['K3']:.4f} "
          f"of {fwd_ms['device']:.4f}; (N, 262) concatenations: {len(cats)}",
          flush=True)
    if cats:
        raise SystemExit("the v2 forward concatenated the (N, 262) point "
                         "features on the card")
    check_small_reference(model, plans=("v2", "device"))

    # 5b: the same eval on device plans
    dev_launches = run_device_plan_path(
        model, test_cfg, records[:1], spec, batch, bb, out, layout="v2",
        n_conv=V2_FORWARD["gather_gemm_conv"], **V2_WIDTHS)
    del model, batch, bb, out, res

    # 5c: batch-1 training steps on host plans
    tmodel, _ = build_model(cfg, caps, train=True)
    random_init_(tmodel, seed=0)
    check_small_train(tmodel, "v2", cfg)
    train_launches, steps, _, _, train_peak, train_metrics = run_training(
        tmodel, records, spec, layout="v2", accum=False, cfg=cfg, ema=False)
    print(f"v2 launches in one batch-1 train step: {train_launches}",
          flush=True)
    for k in ("gather_gemm_conv", "up_conv", "segment_mean_gather",
              "gather_wgrad", "segment_grad"):
        if train_launches[k] <= 0:
            raise SystemExit(f"v2 {k}: not launched in the train step")
    if train_launches["gather_pairs"] != V2_PAIR_LISTS:
        raise SystemExit(f"v2 gather_pairs: {train_launches['gather_pairs']}"
                         f" pair lists in a step, expected {V2_PAIR_LISTS}")
    keys = ("plan", "forward", "criterion", "backward", "optimizer")
    mean = {k: 1e3 * float(np.mean([st[k] for st in steps])) for k in keys}
    total = [sum(st[k] for k in keys) for st in steps]
    print(f"v2 train batch 1: {float(np.mean(total)):.4f} s/step over "
          f"{TRAIN_STEPS} steps (fp32, AdamW/PolyLR, clip 10, no EMA); ms "
          f"per stage " + ", ".join(f"{k} {v:.2f}" for k, v in mean.items())
          + f"; peak {train_peak / 2 ** 30:.3f} GiB", flush=True)
    print(f"v2 train metrics (finite): {train_metrics[-1]}", flush=True)
    return launches, dev_launches, train_launches


# --------------------------------------------------------------------------
# phase 6: the Baseline_ScanNet200 model (rgb alone, no DINO-X)
# --------------------------------------------------------------------------

# the hybrid eval forward: the stem and four down convs (K1), 46 block
# convs (K10) with their slot gathers (K9) and one occupancy row list per
# level, four up convs (K2), the voxel mean and the pool (K3)
HYBRID_FORWARD = {"gather_gemm_conv": 5, "up_conv": 4,
                  "segment_mean_gather": 2, "block_conv": 46,
                  "slot_gather": 18, "block_rows": 5, **NO_LIVE}
# the block-dense training step (phase 4c's): the dense k5 stem's forward
# and dW on the live-pair path over one list
BLOCK_DENSE_STEP = {"block_conv": 93, "block_dilate": 5, "block_wgrad": 47,
                    "slot_gather": 35, "gather_gemm_conv": 8, "up_conv": 8,
                    "gather_wgrad": 8, "segment_mean_gather": 2,
                    "segment_grad": 1, "block_rows": 5, "gather_pairs": 4,
                    "block_conv live": 1, "block_wgrad live": 1,
                    "block_live_pairs": 1}
# the Baseline's: the same, with its 3-channel stem on K1's narrow path
# (eval: the gather stem) or K10's and its dW on K11's (training: the dense
# stem; its input needs no gradient, so no dX role)
BASELINE_FORWARD = {**HYBRID_FORWARD, **NO_NARROW,
                    "gather_gemm_conv narrow": 1}
BASELINE_STEP = {**BLOCK_DENSE_STEP, **NO_NARROW, "block_conv narrow": 1,
                 "block_wgrad narrow": 1, **NO_LIVE}
# its step on device plans (gather layout): the stem on K1's narrow path and
# its dW on K4's, which take no pair list, so the stem's table gets none
BASELINE_DEVICE_STEP = {"gather_gemm_conv": 101, "up_conv": 8,
                        "segment_mean_gather": 2, "gather_wgrad": 55,
                        "segment_grad": 1,
                        "gather_pairs": GATHER_PAIR_LISTS - 1, **NO_NARROW,
                        "gather_gemm_conv narrow": 1,
                        "gather_wgrad narrow": 1, **NO_LIVE}


def check_counts(launches, expected, what):
    print(f"{what}: {launches} (expected {expected})", flush=True)
    for k, n in expected.items():
        if launches[k] != n:
            raise SystemExit(f"{what}: {k} {launches[k]}, expected {n}")


def stage_line(times):
    stages = {k: 1e3 * float(np.mean([t[k] for t in times]))
              for k in times[0]}
    total = [sum(t.values()) for t in times]
    return (f"{1.0 / float(np.mean(total)):.3f} scenes/s over {len(times)} "
            f"iterations (batch 1, fp32); ms per stage "
            + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
            + f"; total {1e3 * float(np.mean(total)):.2f} ms")


def run_baseline_phase(records, train_records, spec, disk_ms):
    """Phase 6 on the rgb-only scenes ``records`` (eval) and
    ``train_records`` (training): 6a eval on the config's hybrid host
    plans, 6b on device plans (against a gather host plan), 6e the eval
    entry point from disk without 2D features, 6c batch-1 steps on the
    config's block-dense training plans, 6d batch-1 steps on device plans.
    Returns the launches of a host-plan forward, of a device-plan forward,
    of a block-dense step and of a device-plan step."""
    import tempfile

    from segdino3d_tpu_torch.builder import Capacities, build_model, \
        random_init_
    from segdino3d_tpu_torch.data.collate import attach_host_plan, collate
    from segdino3d_tpu_torch.data.synthetic import write_scannet_layout
    from segdino3d_tpu_torch.ops import host_plan

    s_cap = SCENE["n_superpoints"]
    cfg = baseline_model_cfg()
    gather = attach_host_plan(collate(records[:1], spec, DEVICE),
                              records[:1], spec,
                              level_cap_ratios=LEVEL_CAP_RATIOS,
                              **plan_layout("gather"))
    caps = Capacities(num_superpoints=s_cap,
                      num_voxels=gather.plan.levels[0].valid.shape[0],
                      level_cap_ratios=LEVEL_CAP_RATIOS)

    # 6a: eval on the config's hybrid host plans
    model, test_cfg = build_model(cfg, caps)
    random_init_(model, seed=0)
    if model.backbone.unet.conv0p1s1.kernel.shape[1] != 3 or \
            hasattr(model.decoder, "dinox_ca"):
        raise SystemExit("the Baseline model is not rgb-only")
    launches, times, peak, batch, bb, out, res, metrics = run_main_path(
        model, test_cfg, records[:1], spec, layout="baseline")
    if batch.points_2dfeats is not None or batch.plan.blocks is None:
        raise SystemExit("baseline: a batch with 2D features or without "
                         "block tables")
    check_counts(launches, BASELINE_FORWARD, "baseline launches in one "
                 "hybrid forward")
    print(f"baseline main path {plan_layout('baseline')}: "
          f"{stage_line(times)}; peak {peak / 2 ** 30:.3f} GiB", flush=True)
    print(f"baseline AP on the random-weight scene: all_ap="
          f"{metrics['all_ap']:.4f} all_ap_50={metrics['all_ap_50']:.4f} "
          f"all_ap_25={metrics['all_ap_25']:.4f}", flush=True)
    check_outputs(bb, out, res, s_cap)
    fwd_ms, _ = forward_device_ms(model, batch, cols=None)
    print(f"one baseline hybrid forward (torch.profiler, device ms): K1 "
          f"{fwd_ms['K1']:.4f}, K3 {fwd_ms['K3']:.4f}, K10 "
          f"{fwd_ms['K10']:.4f}, K2 {fwd_ms['K2']:.4f} of "
          f"{fwd_ms['device']:.4f}", flush=True)
    check_small_reference(model, plans=("baseline", "device"))

    # 6b: the same eval on device plans, against a gather host plan
    with torch.no_grad():
        gbb = model.backbone(gather)
        gout = model.decode(gather, gbb)
    dev_launches = run_device_plan_path(model, test_cfg, records[:1], spec,
                                        gather, gbb, gout, tag="baseline ")
    del gather, gbb, gout, batch, bb, out, res

    # 6e: the eval entry point from disk, no 2D features written or read
    with tempfile.TemporaryDirectory() as root:
        write_scannet_layout(root, DISK_SEEDS, features_2d=False, **SCENE)
        if os.listdir(os.path.join(root, "features_2d")):
            raise SystemExit("baseline: 2D features written")
        d_launches, ms, rate, d_peak, d_metrics, _ = run_disk_eval(
            model, test_cfg, root, "baseline", features_2d=False)
    n = len(DISK_SEEDS)
    check_counts(d_launches, {k: n * v for k, v in BASELINE_FORWARD.items()},
                 f"baseline entry point launches over {n} forwards")
    wait = "loader wait (read, plan, copy)"
    print(f"baseline eval entry point: {rate:.3f} scenes/s over {n} scenes "
          f"read from disk without 2D features (batch 1, fp32, prefetch 1); "
          f"ms per scene " + ", ".join(f"{k} {v:.2f}" for k, v in ms.items())
          + f"; peak {d_peak / 2 ** 30:.3f} GiB; loader wait {ms[wait]:.2f} "
          f"ms a scene against phase 3d's {disk_ms[wait]:.2f} with the "
          f"DINO-X features", flush=True)
    del model

    # 6c: batch-1 steps on the config's block-dense training plans
    tmodel, _ = build_model(cfg, caps, train=True)
    random_init_(tmodel, seed=0)
    check_small_train(tmodel, "baseline-train", cfg, n_points=16000)
    train_launches, steps, _, _, t_peak, t_metrics = run_training(
        tmodel, train_records, spec, layout="baseline-train", accum=False,
        cfg=cfg, ema=False)
    check_counts(train_launches, BASELINE_STEP,
                 "baseline launches in one block-dense train step")
    keys = ("plan", "forward", "criterion", "backward", "optimizer")
    mean = {k: 1e3 * float(np.mean([st[k] for st in steps])) for k in keys}
    total = [sum(st[k] for k in keys) for st in steps]
    print(f"baseline train batch 1 {plan_layout('baseline-train')}: "
          f"{float(np.mean(total)):.4f} s/step over {TRAIN_STEPS} steps "
          f"(fp32, AdamW/PolyLR, clip 10, no EMA); ms per stage "
          + ", ".join(f"{k} {v:.2f}" for k, v in mean.items())
          + f"; peak {t_peak / 2 ** 30:.3f} GiB", flush=True)
    print(f"baseline train metrics (finite): {t_metrics[-1]}", flush=True)

    # 6d: batch-1 steps on device plans (K4's narrow path at the 3-channel
    # stem)
    from segdino3d_tpu_torch.data.collate import _plan_coords
    tmodel.backbone.voxel_cap = max(
        host_plan.voxel_bucket(host_plan.probe_voxel_count(
            c.reshape(-1, 3), bidx, valid.reshape(-1)))
        for c, valid, bidx in (_plan_coords([r], spec.num_points, 0.02)
                               for r in train_records[:2]))
    dev_train_launches = run_training_device(
        tmodel, train_records, spec, n_steps=2, cfg=cfg, ema=False,
        tag="baseline ")
    check_counts(dev_train_launches, BASELINE_DEVICE_STEP,
                 "baseline launches in one device-plan train step")
    return launches, dev_launches, train_launches, dev_train_launches


# --------------------------------------------------------------------------
# phase 7: the decoder options on the flagship model
# --------------------------------------------------------------------------

def options_cfg(dropout=0.1):
    """The flagship training config with the Fourier PE, objectness, a
    two-layer semantic head, dropout, activation checkpointing and
    ``query_num`` top-k queries."""
    cfg = train_cfg()
    cfg["decoder_cfg"].update(pos_type="fourier", objectness_flag=True,
                              num_semantic_linears=2, dropout=dropout,
                              use_activation_checkpoint=True)
    cfg["query_num"] = 400
    return cfg


def check_finite(out, what, shapes):
    for k, shape in shapes.items():
        v = out[k]
        if tuple(v.shape) != shape:
            raise SystemExit(f"{what} {k}: shape {tuple(v.shape)} != {shape}")
        if not bool(torch.isfinite(v).all()):
            raise SystemExit(f"{what} {k}: non-finite values")


def run_options_phase(fp32_model, records, train_records, spec, caps):
    """Phase 7: 7a a forward and two training steps of ``options_cfg()``
    (gather host plans) and its card-vs-CPU step with dropout 0; 7b an
    eval forward of the plain decoder with learned queries; 7c a bf16
    decoder's eval forward against ``fp32_model``'s."""
    from segdino3d_tpu_torch.builder import build_model, random_init_
    from segdino3d_tpu_torch.data.collate import attach_host_plan, collate
    from segdino3d_tpu_torch.evaluation.evaluate import postprocess

    s_cap = SCENE["n_superpoints"]
    batch = attach_host_plan(collate(records[:1], spec, DEVICE), records[:1],
                             spec, level_cap_ratios=LEVEL_CAP_RATIOS,
                             **plan_layout("gather"))

    def forward(model, what):
        with torch.no_grad():
            model(batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model(batch)
            res = postprocess(out, batch, test_cfg)
            torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        inst = res[0][0]
        if not bool(torch.isfinite(inst.scores).all()):
            raise SystemExit(f"{what}: non-finite instance scores")
        print(f"{what}: forward + postprocess {ms:.2f} ms (batch 1, host "
              f"plan built before), {int(inst.valid.sum())} instances kept",
              flush=True)
        return out

    # 7a: Fourier PE, objectness, two-layer semantic head, top-k queries,
    # dropout and activation checkpointing
    cfg = options_cfg()
    model, test_cfg = build_model(cfg, caps)
    random_init_(model, seed=0)
    out = forward(model, "options eval (fourier, objectness, query_num 400)")
    q = min(cfg["query_num"], s_cap)
    check_finite(out, "options eval", {
        "cls_preds": (1, q, 199), "masks": (1, q, s_cap),
        "sem_preds": (1, q, 201), "scores": (1, q, 1), "centers": (1, q, 3),
        "sizes": (1, q, 3)})
    tmodel, _ = build_model(cfg, caps, train=True)
    tmodel.load_state_dict(model.state_dict())
    del model
    step = make_train_step(tmodel, 1, ema=False, cfg=cfg)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    for i in range(2):
        rec = train_records[i]
        b = attach_host_plan(collate([rec], spec, DEVICE), [rec], spec,
                             level_cap_ratios=LEVEL_CAP_RATIOS,
                             **plan_layout("gather"))
        state = gen.get_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step([b], generator=gen)
        vals = check_metrics(step, m, f"options step {i}")
        if torch.equal(gen.get_state(), state):
            raise SystemExit("options step: dropout drew nothing")
        print(f"options train step {i} (dropout 0.1 from the step's "
              f"generator, checkpointed): {time.perf_counter() - t0:.4f} s; "
              f"metrics (finite) {vals}", flush=True)
    # the card against the CPU with dropout 0, same weights
    cfg0 = options_cfg(dropout=0.0)
    model0, _ = build_model(cfg0, caps, train=True)
    model0.load_state_dict(tmodel.state_dict())
    del tmodel
    check_small_train(model0, "gather", cfg0, n_points=16000)
    del model0

    # 7b: the plain decoder with learned queries, no positions
    cfg = model_cfg()
    cfg["decoder_cfg"].update(
        iter_pred=False, num_instance_queries=100,
        add_positional_embedding=False, box_modulate_ca=False,
        add_box_size_pred=False, normalize_box_prediction=False)
    cfg["add_positional_embedding"] = False
    model, test_cfg = build_model(cfg, caps)
    random_init_(model, seed=0)
    out = forward(model, "plain decoder, 100 learned queries")
    check_finite(out, "plain decoder", {
        "cls_preds": (1, 100, 199), "masks": (1, 100, s_cap),
        "sem_preds": (1, 100, 201)})
    if out["centers"] is not None or out["aux_outputs"]:
        raise SystemExit("plain decoder: centers or aux outputs")
    del model

    # 7c: the decoder's projections in bf16 against fp32, same weights.
    # With the config's mask-attention gating, a head's bf16 rounding
    # flips some sigmoid(mask) < 0.5 decisions of the next layer, which
    # then attends to other superpoints: the first head that reads the
    # bf16 projections (layer 1) is held, the last is printed.  Without
    # the gating every layer is held.
    for gated in (True, False):
        cfg = model_cfg()
        cfg["decoder_cfg"]["attn_mask"] = gated
        ref_model = fp32_model
        if not gated:
            ref_model, _ = build_model(cfg, caps)
            ref_model.load_state_dict(fp32_model.state_dict())
        cfg["decoder_cfg"]["compute_dtype"] = "bfloat16"
        model, test_cfg = build_model(cfg, caps)
        model.load_state_dict(fp32_model.state_dict())
        what = "bf16 decoder" + ("" if gated else " without mask gating")
        out = forward(model, what)
        with torch.no_grad():
            ref = ref_model(batch)
        for i, (o, r) in enumerate(zip(out["aux_outputs"] + [out],
                                       ref["aux_outputs"] + [ref])):
            if i == 0:          # the input queries' head: no bf16 inside
                continue
            held = i == 1 or not gated
            for k in ("masks", "cls_preds"):
                a, b = o[k].float(), r[k]
                err, scale = float((a - b).abs().max()), float(b.abs().max())
                ok = err <= 5e-2 * scale
                print(f"{what} vs fp32, layer {i} {k}: max_abs_err={err:.3e}"
                      f" (5e-2 x max|fp32| = {5e-2 * scale:.3e}) "
                      + (("ok" if ok else "MISMATCH") if held
                         else "(printed only)"), flush=True)
                if held and not ok:
                    raise SystemExit(f"{what} disagrees with fp32 on {k}, "
                                     f"layer {i}")
        del model
        if not gated:
            del ref_model


# --------------------------------------------------------------------------
# phase 10: the flagship backbone in bf16
# --------------------------------------------------------------------------

# tolerances of the bf16 backbone's checks (CHANGES.md): against the same
# scene's fp32 forward (a bf16 ulp is 2^-8 of a value; ~50 stacked
# convs, each rounding its output); the card against the CPU's plain bf16
# path (both round the same products, in fp32 sums of other orders, so a
# value near a rounding boundary flips by one ulp and the flip propagates).
# The small training step amplifies such flips: half-ulp noise on each
# conv output of the CPU's plain bf16 step, 4 seeds, moves its
# segmentation loss by up to 4.4% and its gradient norm by 12%; each
# leaf's clipped gradient norm by up to 24% in the backbone (median 7%),
# the median leaf by 10%, and decoder leaves by up to 229%, so those are
# held only through the median and the norm
# (``tools/step_sensitivity.py --model flagship-bf16 --eps 2e-3 --seeds 4
# --leaves 552``).  The leaves' limits are twice the readings.
BF16_FP32_TOL = 5e-2
BF16_REF_TOL = 5e-2
BF16_LOSS_RTOL = 5e-2
BF16_NORM_RTOL = 1.5e-1
BF16_LEAF_RTOL = 5e-1
BF16_LEAF_MEDIAN = 2e-1


def bf16_cfg(cfg):
    """``cfg`` with the backbone's compute dtype bf16."""
    cfg = copy.deepcopy(cfg)
    cfg["pointcloud_backbone_cfg"]["compute_dtype"] = "bfloat16"
    return cfg


def k10_level_ms(model, batch):
    """{level: device ms} of K10's launches in one forward of ``model``'s
    backbone (``profiled_events``): each conv's warpgroup kernel (and group
    sum) tied to its level by the launch order, recorded by a wrapper
    around ``block_dense.row_list``, which each forward conv calls once
    just before its launch, for the profiled call (after a lead call)."""
    from segdino3d_tpu_torch.ops import block_dense as BD

    def forward():
        with torch.no_grad():
            model.backbone(batch)

    level_of = {t.block_nbr.data_ptr(): li
                for li, t in enumerate(batch.plan.blocks) if t is not None}
    order, orig = [], BD.row_list

    def recorded(tables, occ):
        order.append(level_of[tables.block_nbr.data_ptr()])
        return orig(tables, occ)

    def recorded_forward():
        order.clear()
        BD.row_list = recorded
        try:
            forward()
        finally:
            BD.row_list = orig

    events = profiled_events(recorded_forward, forward)
    events = sorted((e for e in events
                     if any(f in e.name for f in ("block_conv_wg_kernel",
                                                  "group_sum_kernel"))),
                    key=lambda e: e.time_range.start)
    ms, conv = {}, -1
    for e in events:
        conv += "block_conv_wg_kernel" in e.name
        li = order[conv]
        ms[li] = ms.get(li, 0.0) + e.time_range.elapsed_us() / 1e3
    if conv + 1 != len(order):
        raise SystemExit(f"phase 10a: {conv + 1} K10 warpgroup launches "
                         f"profiled, {len(order)} convs")
    return dict(sorted(ms.items())), {li: order.count(li) for li in ms}


def check_element_loads(what):
    """No bf16 kernel call of the run copied its rows element by element."""
    from segdino3d_tpu_torch.ops import narrow as N

    n = N.element_loads.calls
    print(f"{what}: bf16 kernel calls that copied rows element by element "
          f"{n} (expected 0: the stems' rows at the aligned pitch)",
          flush=True)
    if n:
        raise SystemExit(f"{what}: {n} bf16 kernel calls took the element "
                         "copies")


def run_bf16_phase(model, test_cfg, records, train_records, spec, tspec,
                   caps, fp32_feats):
    """Phase 10: the flagship backbone with ``compute_dtype="bfloat16"``
    (the JAX package's headline dtype) at full width: 10a the hybrid eval
    on phase 3c's scene and weights, against its fp32 forward and, on a
    small scene, the CPU's plain bf16 path; 10b batch-1 steps on the
    block-dense training layout with phase 4c's weights and scenes, after a
    small-scene step against the CPU's.  Returns the launches of a forward
    and of a step."""
    from segdino3d_tpu_torch.builder import build_model, random_init_
    from segdino3d_tpu_torch.ops import narrow as N

    bmodel, _ = build_model(bf16_cfg(model_cfg()), caps)
    bmodel.load_state_dict(model.state_dict())
    N.element_loads.calls = 0
    launches, times, peak, batch, bb, out, res, _ = run_main_path(
        bmodel, test_cfg, records, spec, layout="hybrid")
    check_element_loads("phase 10a")
    expected = {**HYBRID_FORWARD, **NO_NARROW,
                "gather_gemm_conv wide stem": 1}
    check_counts(launches, expected, "phase 10a launches in one bf16 "
                 "hybrid forward (phase 3c's; the stem on K1's bf16 wide-stem "
                 "path)")
    stages = {k: 1e3 * float(np.mean([t[k] for t in times]))
              for k in times[0]}
    total = [sum(t.values()) for t in times]
    print(f"phase 10a bf16 hybrid main path: {1.0 / float(np.mean(total)):.3f}"
          f" scenes/s over {TIMED_ITERS} iterations (batch 1, bf16 "
          f"backbone, fp32 decoder); ms per stage "
          + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
          + f"; total {1e3 * float(np.mean(total)):.2f} ms; peak "
          f"{peak / 2 ** 30:.3f} GiB", flush=True)
    if bb.sp_feats.dtype != torch.bfloat16:
        raise SystemExit(f"phase 10a: sp_feats {bb.sp_feats.dtype}")
    a, b = bb.sp_feats.float(), fp32_feats.float()
    err, scale = float((a - b).abs().max()), float(b.abs().max())
    ok = torch.allclose(a, b, rtol=BF16_FP32_TOL, atol=BF16_FP32_TOL)
    print(f"phase 10a bf16 sp_feats vs phase 3c's fp32 forward of the same "
          f"scene: max_abs_err={err:.3e} of max {scale:.3e} (rtol=atol="
          f"{BF16_FP32_TOL:g}) {'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        raise SystemExit("phase 10a: the bf16 backbone disagrees with the "
                         "fp32 one")
    check_outputs(bb, out, res, SCENE["n_superpoints"])
    fwd_ms, _ = forward_device_ms(bmodel, batch, cols=None)
    lvl_ms, lvl_n = k10_level_ms(bmodel, batch)
    print(f"phase 10a one bf16 hybrid forward (torch.profiler, device ms): "
          f"K1 {fwd_ms['K1']:.4f}, K2 {fwd_ms['K2']:.4f}, K3 "
          f"{fwd_ms['K3']:.4f}, K10 {fwd_ms['K10']:.4f} of "
          f"{fwd_ms['device']:.4f}; K10 by level "
          + ", ".join(f"L{li} {v:.4f} ({lvl_n[li]} convs)"
                      for li, v in lvl_ms.items()), flush=True)
    check_small_reference(bmodel, plans=("hybrid",), tol=BF16_REF_TOL)
    del bmodel, batch, bb, out, res

    dmodel, _ = build_model(bf16_cfg(train_cfg()), caps, train=True)
    random_init_(dmodel, seed=0)
    check_bf16_leaves(*check_small_train(
        dmodel, "block-dense", loss_rtol=BF16_LOSS_RTOL, grad_rtol=None,
        norm_rtol=BF16_NORM_RTOL))
    N.element_loads.calls = 0
    train_launches, steps, _, _, peak, metrics = run_training(
        dmodel, train_records, tspec, layout="block-dense", accum=False)
    check_element_loads("phase 10b")
    expected = {**BLOCK_DENSE_STEP, **NO_NARROW,
                "gather_gemm_conv wide stem": 0}
    check_counts(train_launches, expected, "phase 10b launches in one bf16 "
                 "block-dense train step (phase 4c's)")
    grads = [p.grad for p in dmodel.parameters() if p.grad is not None]
    if not grads or not all(bool(torch.isfinite(g).all()) for g in grads):
        raise SystemExit("phase 10b: missing or non-finite gradients")
    keys = ("plan", "forward", "criterion", "backward", "optimizer")
    mean = {k: 1e3 * float(np.mean([st[k] for st in steps])) for k in keys}
    total = [sum(st[k] for k in keys) for st in steps]
    print(f"phase 10b bf16 block-dense train batch 1 "
          f"{plan_layout('block-dense')}: {float(np.mean(total)):.4f} s/step "
          f"over {TRAIN_STEPS} steps (bf16 backbone); ms per stage "
          + ", ".join(f"{k} {v:.2f}" for k, v in mean.items())
          + f"; peak {peak / 2 ** 30:.3f} GiB; {len(grads)} gradient leaves "
          f"finite; metrics {metrics[-1]}", flush=True)
    return launches, train_launches


# --------------------------------------------------------------------------
# phase 9: distribution and the prepared data
# --------------------------------------------------------------------------

DIST_TIMEOUT_S = 420
CLI_BACKEND = "nccl"        # the CLI's group on the card (phase 9b)
# |2-rank - one process's mean| <= DIST_TOL x max |one process's| per
# tensor family: the ranks and the reference run the same kernels on the
# same card, but the weight gradients' float atomics add in any order
DIST_TOL = 1e-4
EVAL_DIST_SEEDS = (0, 1, 2, 3)
# phase 9c's thresholds over the flagship's: its random weights give mask
# logits of about -2.9 to -1.7 (no positive one, so the objectness
# normalisation zeroes every score) and sigmoids under its 0.4, so its
# own test config keeps no instance and the comparison would hold
# nothing; these keep the top 50 of each scene
EVAL_DIST_TEST_CFG = dict(topk_insts=50, sp_score_thr=0.1,
                          obj_normalization=False)
# phase 9a's layouts: phase 4's gather host plans and the flagship's
# training layout (phase 4c's block-dense plans)
DIST_LAYOUTS = ("gather", "block-dense")
FLAG_ITERS = 200            # timed calls of the stop flag's all-reduce


def dist_train_model():
    from segdino3d_tpu_torch.builder import Capacities, build_model, \
        random_init_

    model, _ = build_model(train_cfg(), Capacities(
        num_superpoints=SCENE["n_superpoints"],
        level_cap_ratios=LEVEL_CAP_RATIOS), train=True)
    return random_init_(model, seed=0)


def dist_shard(rank, layout):
    """Rank ``rank``'s batch-1 microbatch (phase 4's scene of
    ``TRAIN_SEEDS[rank]`` on a host plan of ``layout``) and its numpy
    queries."""
    from segdino3d_tpu_torch.data.collate import (PadSpec, attach_host_plan,
                                                  collate)
    from segdino3d_tpu_torch.data.synthetic import synthetic_scene

    rec = synthetic_scene(TRAIN_SEEDS[rank], **SCENE)
    rec["points_2dfeats"] = rec["points_2dfeats"].astype(np.float16)
    spec = PadSpec(SCENE["n_points"], SCENE["n_superpoints"], 64, 128, 200)
    b = attach_host_plan(collate([rec], spec, DEVICE), [rec], spec,
                         level_cap_ratios=LEVEL_CAP_RATIOS,
                         **plan_layout(layout))
    q = numpy_queries(b.num_superpoints.cpu().numpy(), SCENE["n_superpoints"],
                      seed=100 + rank)
    return b, tuple(t.to(DEVICE) for t in q)


def bn_buffers(model):
    return {n: b for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


def _child_fail(path):
    import traceback

    with open(path + ".err", "w") as f:
        f.write(traceback.format_exc())


def dist_step_rank(rank, world, store, out):
    """Phase 9a, one rank: one flagship step on its shard of each layout
    of ``DIST_LAYOUTS`` (a fresh model each) in a gloo group of ``world``
    processes on cuda:0, then the engine's stop flag (``mesh.any_flag``)
    timed; rank 0 writes its gradients, parameters and batch-norm
    statistics after each step to ``out``."""
    from segdino3d_tpu_torch.parallel import mesh

    try:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # NCCL refuses two ranks on one device ("Duplicate GPU detected"):
        # on one card the group is gloo, which all-reduces CUDA tensors
        # through the host; the NCCL path is phase 9b's
        mesh.init_distributed(init_method=f"file://{store}", rank=rank,
                              world_size=world, backend="gloo",
                              timeout_s=300.0)
        res = {}
        for layout in DIST_LAYOUTS:
            model = dist_train_model()
            step = make_train_step(model, 1)
            step.process_group = torch.distributed.group.WORLD
            b, q = dist_shard(rank, layout)
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            metrics = step([b], queries=[q])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = read_counts()
            vals = check_metrics(step, metrics, f"rank {rank} {layout} step")
            state = ([p.detach() for p in model.parameters()]
                     + [p.grad for p in model.parameters()]
                     + list(bn_buffers(model).values()))
            flat = torch.cat([t.reshape(-1).float() for t in state])
            ref = flat.clone()
            torch.distributed.broadcast(ref, 0)
            res[layout] = dict(metrics=vals, seconds=seconds,
                               launches=launches,
                               same=bool(torch.equal(flat, ref)))
            if rank == 0:
                res[layout].update(
                    grads={n: p.grad.cpu()
                           for n, p in model.named_parameters()},
                    params={n: p.detach().cpu()
                            for n, p in model.named_parameters()},
                    stats={n: v.cpu() for n, v in bn_buffers(model).items()})
            del model, step, b, q
            torch.cuda.empty_cache()
        mesh.barrier()
        t0 = time.perf_counter()
        for _ in range(FLAG_ITERS):
            mesh.any_flag(False)
        res["flag_us"] = 1e6 * (time.perf_counter() - t0) / FLAG_ITERS
        torch.save(res, f"{out}.rank{rank}")
    except BaseException:
        _child_fail(f"{out}.rank{rank}")
        raise
    finally:
        mesh.shutdown_distributed()


def run_children(target, args_of, world, what):
    """``world`` spawned processes of ``target(rank, *args_of(rank))``;
    fails when one fails or outlives ``DIST_TIMEOUT_S`` (then all are
    killed)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, *args_of(r)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DIST_TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10.0)
    codes = [p.exitcode for p in procs]
    if hung or codes != [0] * world:
        raise SystemExit(f"{what}: processes ended with {codes}"
                         + (f", {len(hung)} killed after {DIST_TIMEOUT_S} s"
                            if hung else ""))


def child_results(path, world, what):
    out = []
    for r in range(world):
        err = f"{path}.rank{r}.err"
        if os.path.exists(err):
            with open(err) as f:
                print(f.read(), flush=True)
            raise SystemExit(f"{what}: rank {r} failed")
        out.append(torch.load(f"{path}.rank{r}", weights_only=False))
    return out


def one_process_mean_step(world, layout):
    """Phase 9a's reference: one process runs every rank's shard of
    ``layout`` from the same state and weights, averages the gradients,
    losses and batch-norm statistics and takes the optimizer step on the
    mean."""
    from segdino3d_tpu_torch.train.optim import global_norm

    model = dist_train_model()
    step = make_train_step(model, 1)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    params = dict(model.named_parameters())
    grads = {n: torch.zeros_like(p) for n, p in params.items()}
    stats = {n: torch.zeros_like(v) for n, v in bn_buffers(model).items()}
    losses = {}
    for r in range(world):
        model.load_state_dict(init)
        model.train()
        for p in params.values():
            p.grad = None
        b, q = dist_shard(r, layout)
        outputs, gt = model(b, q, None)
        ls = step.criterion(outputs, gt)
        ls["total_loss"] = sum(ls.values())
        ls["total_loss"].backward()
        for n, p in params.items():
            if p.grad is not None:
                grads[n] += p.grad / world
        for n, v in bn_buffers(model).items():
            stats[n] += v / world
        for k, v in ls.items():
            losses[k] = losses.get(k, 0.0) + float(v.detach()) / world
    model.load_state_dict(init)
    with torch.no_grad():
        for n, p in params.items():
            p.grad = grads[n]
        for n, v in bn_buffers(model).items():
            v.copy_(stats[n])
        norm = global_norm(list(grads.values()))
    step.optimizer.step(norm)
    losses["grad_norm"] = float(norm)
    return dict(metrics=losses,
                grads={n: p.grad for n, p in params.items()},
                params={n: p.detach() for n, p in params.items()},
                stats=bn_buffers(model))


def compare_family(got, want, what, layout):
    scale = max(float(v.abs().max()) for v in want.values())
    err = max(float((got[n].to(v.device) - v).abs().max())
              for n, v in want.items())
    ok = err <= DIST_TOL * scale
    print(f"phase 9a {layout} {what}: max_abs_err={err:.3e} over {len(want)} "
          f"tensors (<= {DIST_TOL} x max|reference| = "
          f"{DIST_TOL * scale:.3e}) {'ok' if ok else 'MISMATCH'}",
          flush=True)
    if not ok:
        raise SystemExit(f"phase 9a: the 2-rank {layout} step's {what} "
                         f"disagree with one process's mean")


def run_dist_step_phase(card, expected):
    """Phase 9a: a 2-rank flagship step of each layout on the one card,
    against one process that runs both shards and takes the mean; each
    rank's launches equal ``expected[layout]`` (phase 4's and 4c's batch-1
    steps).  Returns rank 0's launches of each layout."""
    import tempfile

    world = 2
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "step")
        t0 = time.perf_counter()
        run_children(dist_step_rank, lambda r: (world, os.path.join(
            tmp, "store"), out), world, "phase 9a")
        wall = time.perf_counter() - t0
        ranks = child_results(out, world, "phase 9a")
    for layout in DIST_LAYOUTS:
        got_ranks = [r[layout] for r in ranks]
        ref = one_process_mean_step(world, layout)
        for k, v in ref["metrics"].items():
            got = [r["metrics"][k] for r in got_ranks]
            ok = all(np.isclose(g, v, rtol=1e-5, atol=0) for g in got)
            print(f"phase 9a {layout} {k}: ranks {got} one process {v:.6f} "
                  f"(rtol 1e-5) {'ok' if ok else 'MISMATCH'}", flush=True)
            if not ok:
                raise SystemExit(f"phase 9a: {layout} {k} disagrees with "
                                 f"one process's mean")
        if not all(r["same"] for r in got_ranks):
            raise SystemExit(f"phase 9a: the ranks' states differ after the "
                             f"{layout} step")
        for fam, what in (("grads", "clipped gradients"),
                          ("stats", "batch-norm statistics"),
                          ("params", "updated parameters")):
            compare_family(got_ranks[0][fam], ref[fam], what, layout)
        del ref
        for r, res in enumerate(got_ranks):
            if res["launches"] != expected[layout]:
                raise SystemExit(
                    f"phase 9a rank {r} launched {res['launches']} in the "
                    f"{layout} step, expected the one-process batch-1 step's "
                    f"{expected[layout]}")
        print(f"phase 9a: 2-rank flagship step on {layout} host plans (gloo "
              f"on one card, batch 1 a rank), every rank equal to rank 0 and "
              f"to one process's mean; step "
              f"{max(r['seconds'] for r in got_ranks):.4f} s (slowest rank, "
              f"the all-reduce through the host included); launches a rank "
              f"{got_ranks[0]['launches']}; {card}", flush=True)
    print(f"phase 9a: the engine's stop flag (mesh.any_flag, a host int32 "
          f"all-reduced over gloo, no wait on the card) "
          f"{[round(r['flag_us'], 1) for r in ranks]} us a call on the "
          f"ranks (mean of {FLAG_ITERS}); the phase {wall:.1f} s wall with "
          f"the processes' start; {card}", flush=True)
    return {layout: ranks[0][layout]["launches"] for layout in DIST_LAYOUTS}


def dist_eval_rank(rank, world, store, root, gather_dir, out):
    """Phase 9c, one process: its share of the scenes under ``root``
    (``EvalLoader`` process shards), gathered through ``gather_dir`` in a
    gloo group (the gather's barriers; NCCL takes one rank a card)."""
    from segdino3d_tpu_torch.parallel import mesh

    try:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        mesh.init_distributed(init_method=f"file://{store}", rank=rank,
                              world_size=world, backend="gloo",
                              timeout_s=300.0)
        res = dist_eval(root, rank, world, gather_dir)
        torch.save(res, f"{out}.rank{rank}")
    except BaseException:
        _child_fail(f"{out}.rank{rank}")
        raise
    finally:
        mesh.shutdown_distributed()


def dist_eval(root, rank, world, gather_dir=None):
    """The flagship eval model (seeded weights) over process ``rank``'s
    share of the scenes under ``root``: the AP dict, the gathered results
    (scene id, instance masks, labels, scores) in their order, launches
    and seconds."""
    from segdino3d_tpu_torch.builder import Capacities, build_model, \
        random_init_
    from segdino3d_tpu_torch.data.bucketing import BucketPolicy
    from segdino3d_tpu_torch.data.loader import EvalLoader
    from segdino3d_tpu_torch.data.scannet_constants import (
        SCANNET200_CLASS_NAMES, SCANNET200_RAW_IDS)
    from segdino3d_tpu_torch.data.scannet_dataset import \
        ScanNet200InstanceSeg3D
    from segdino3d_tpu_torch.evaluation.evaluate import evaluate
    from segdino3d_tpu_torch.evaluation.evaluator import \
        InstanceSeg3DEvaluator

    model, test_cfg = build_model(model_cfg(), Capacities(
        num_superpoints=SCENE["n_superpoints"],
        level_cap_ratios=LEVEL_CAP_RATIOS))
    random_init_(model, seed=0)
    reader = ScanNet200InstanceSeg3D(
        scene_set="val", root_scenes=root, adjust_class_ids=False,
        root_points_2dfeats=os.path.join(root, "features_2d"),
        feats_2d_dtype="float16")
    loader = EvalLoader(reader, batch_size=1,
                        bucket_policy=BucketPolicy.default(),
                        host_plan_cfg=plan_layout("hybrid"), prefetch=1,
                        device=DEVICE, process_index=rank,
                        process_count=world)
    ev = InstanceSeg3DEvaluator(SCANNET200_RAW_IDS, SCANNET200_CLASS_NAMES)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    ap = evaluate(model, loader, ev, dict(test_cfg, **EVAL_DIST_TEST_CFG),
                  gather_dir=gather_dir, process_index=rank,
                  process_count=world)
    seconds = time.perf_counter() - t0
    return dict(ap=ap, results=[
        (a["lidar_idx"], p["pts_instance_masks"], p["instance_labels"],
         p["instance_scores"]) for a, p in ev._results],
        launches=read_counts(), seconds=seconds, n_local=len(loader))


def run_dist_eval_phase(card, root):
    """Phase 9c: eval from disk in 2 processes on the card, gathered
    through a directory, against one process on the same scenes."""
    import tempfile

    world = 2
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "eval")
        t0 = time.perf_counter()
        run_children(dist_eval_rank, lambda r: (
            world, os.path.join(tmp, "store"), root,
            os.path.join(tmp, "gather"), out), world, "phase 9c")
        wall = time.perf_counter() - t0
        ranks = child_results(out, world, "phase 9c")
    one = dist_eval(root, 0, 1)
    n = len(EVAL_DIST_SEEDS)
    # merged in rank order: rank 0's scenes (global batches 0, 2, ...),
    # then rank 1's
    order = [one["results"][i] for r in range(world)
             for i in range(r, n, world)]
    for r, res in enumerate(ranks):
        try:
            np.testing.assert_equal(res["ap"], one["ap"])
        except AssertionError as e:
            raise SystemExit(f"phase 9c: rank {r}'s gathered AP differs "
                             f"from one process's: {e}")
        if not all(len(g[2]) for g in res["results"]):
            raise SystemExit(f"phase 9c: a scene of rank {r} kept no "
                             f"instance, so the comparison holds nothing")
        got_ids = [g[0] for g in res["results"]]
        if got_ids != [o[0] for o in order]:
            raise SystemExit(f"phase 9c: rank {r} gathered scenes {got_ids},"
                             f" expected {[o[0] for o in order]}")
        # the same kernels on the same card: bit for bit
        for g, o in zip(res["results"], order):
            for what, a, b in zip(("masks", "labels", "scores"), g[1:],
                                  o[1:]):
                if a.shape != b.shape or not np.array_equal(a, b):
                    diff = (float(np.abs(a.astype(np.float64) - b).max())
                            if a.shape == b.shape else None)
                    raise SystemExit(
                        f"phase 9c: rank {r}'s gathered {what} of {g[0]} "
                        f"differ from one process's (shapes {a.shape} "
                        f"{b.shape}, max |diff| {diff})")
    total = {k: sum(r["launches"][k] for r in ranks) for k in one["launches"]}
    if total != one["launches"] or not all(
            one["launches"].get(k) == n * v for k, v in
            {"gather_gemm_conv": 5, "block_conv": 46}.items()):
        raise SystemExit(f"phase 9c: the processes launched {total} in all, "
                         f"one process {one['launches']}")
    print(f"phase 9c: eval of {n} scenes from disk in 2 processes on the "
          f"card ({[r['n_local'] for r in ranks]} scenes each, hybrid host "
          f"plans), gathered through a directory: every rank's gathered "
          f"scene order, instance masks, labels and scores "
          f"({sum(len(o[2]) for o in order)} instances) bit-equal to one "
          f"process's, and its AP equal (all_ap="
          f"{one['ap']['all_ap']:.4f} all_ap_25="
          f"{one['ap']['all_ap_25']:.4f}); {n / max(r['seconds'] for r in ranks):.3f} "
          f"scenes/s (the slower process's eval, gather included) against "
          f"{n / one['seconds']:.3f} in one process; the phase {wall:.1f} s "
          f"wall with the processes' start; launches per process "
          f"{[{k: v for k, v in r['launches'].items() if v} for r in ranks]}"
          f"; {card}", flush=True)


def run_torchrun_cli_phase(card, root):
    """Phase 9b: the CLI under ``torch.distributed.run --nproc_per_node 1``:
    an NCCL group of one on the card, two steps from disk through the
    group's all-reduce, a checkpoint, the in-loop eval."""
    import re
    import socket
    import tempfile

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        cfg_path = os.path.join(tmp, "cfg.py")
        with open(cfg_path, "w") as f:
            f.write(cli_config(root))
        work = os.path.join(tmp, "work")
        out, wall = run_cli(
            ["--config_file", cfg_path, "--work_dir", work,
             "--accum_steps", "1", "--num_eval_scenes", "2", "--options",
             "num_iterations=2", "save_step=2", "eval_step=2",
             "data.train_batch_size=1", "data.num_workers=2"], "phase 9b",
            launcher=["-m", "torch.distributed.run", "--nproc_per_node", "1",
                      "--master_addr", "127.0.0.1", "--master_port",
                      str(port)])
        print_cli_lines(out, "phase 9b")
        if f"process 0 of 1 ({CLI_BACKEND})" not in out:
            raise SystemExit("phase 9b: the CLI did not log an NCCL group")
        its = cli_iterations(out)
        if [s for s, _ in its] != [0, 1] or not all(
                np.isfinite(v.get("total_loss", np.nan)) for _, v in its):
            raise SystemExit(f"phase 9b: logged steps {its}")
        if sorted(os.listdir(os.path.join(work, "checkpoints"))) != [
                "step_0000000002.pth"]:
            raise SystemExit("phase 9b: no checkpoint of step 2")
        if re.search(r"mAP: [0-9.]+", out) is None:
            raise SystemExit("phase 9b: no mAP line")
    print(f"phase 9b: torch.distributed.run --nproc_per_node 1 (NCCL group "
          f"of one) ran the flagship config 2 steps at batch 1 from disk "
          f"through the group's all-reduce, checkpointed and evaluated; "
          f"step 1 {its[1][1]['time']:.4f} s (loader wait "
          f"{its[1][1]['data']:.4f}); {wall:.1f} s wall; {card}", flush=True)


# a ScanNet-style scan: a vh_clean_2 mesh's scale
SCAN_GRID = 387              # 149,769 vertices, 297,992 faces


def write_scan(scans_dir, sid, seed=0):
    """A seeded room: a 6 m x 6 m floor grid whose boxes are raised into
    objects, with colours, a labels ply (ScanNet raw ids), the
    aggregation / segs json pair and an axis alignment; returns the
    vertex and face counts."""
    from segdino3d_tpu_torch.data.scannet_constants import SCANNET200_RAW_IDS
    from segdino3d_tpu_torch.tools.ply_io import write_ply

    rng = np.random.RandomState(seed)
    n = SCAN_GRID
    x, y = np.meshgrid(np.linspace(0, 6, n), np.linspace(0, 6, n))
    z = 0.002 * rng.randn(n, n)
    obj = np.zeros((n, n), np.int64)
    for k in range(1, 25):
        cx, cy = rng.uniform(0.5, 5.5, 2)
        w, d = rng.uniform(0.3, 1.0, 2)
        inside = (np.abs(x - cx) < w / 2) & (np.abs(y - cy) < d / 2)
        z[inside] = rng.uniform(0.4, 1.5)
        obj[inside] = k
    verts = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    obj = obj.ravel()
    a = (np.arange(n - 1)[:, None] * n + np.arange(n - 1)[None, :]).ravel()
    faces = np.concatenate([np.stack([a, a + 1, a + n], 1),
                            np.stack([a + 1, a + n + 1, a + n], 1)])
    palette = rng.randint(0, 256, (25, 3))
    colors = np.clip(palette[obj] + rng.randint(-8, 9, (len(obj), 3)), 0,
                     255).astype(np.uint8)
    raw = np.asarray(SCANNET200_RAW_IDS)
    cls = rng.randint(2, 60, 25)                  # things; 2 = floor
    labels = np.where(obj > 0, raw[cls[obj]], raw[1]).astype(np.uint16)
    sdir = os.path.join(scans_dir, sid)
    os.makedirs(sdir)
    write_ply(os.path.join(sdir, f"{sid}_vh_clean_2.ply"), verts, faces,
              colors)
    write_ply(os.path.join(sdir, f"{sid}_vh_clean_2.labels.ply"), verts,
              faces, colors, labels=labels)
    with open(os.path.join(sdir, f"{sid}_vh_clean_2.0.010000.segs.json"),
              "w") as f:
        json.dump({"segIndices": obj.tolist()}, f)
    with open(os.path.join(sdir, f"{sid}.aggregation.json"), "w") as f:
        json.dump({"segGroups": [
            {"objectId": k - 1, "label": f"object{k}", "segments": [k]}
            for k in range(1, 25) if (obj == k).any()]}, f)
    with open(os.path.join(sdir, f"{sid}.txt"), "w") as f:
        f.write("axisAlignment = 0 -1 0 3 1 0 0 -3 0 0 1 0 0 0 0 1\n")
    return len(verts), len(faces)


def run_prepared_data_phase(card):
    """Phase 9d: a synthetic scan of a vh_clean_2 mesh's size through the
    port's ``prepare_scannet``, then the Baseline's eval entry point (rgb
    alone) on the card from the prepared layout."""
    import tempfile

    from segdino3d_tpu_torch.builder import Capacities, build_model, \
        random_init_
    from segdino3d_tpu_torch.tools import prepare_scannet

    sid = "scene0000_00"
    with tempfile.TemporaryDirectory() as tmp:
        scans, out = os.path.join(tmp, "scans"), os.path.join(tmp, "prep")
        splits = os.path.join(tmp, "splits")
        os.makedirs(scans)
        os.makedirs(splits)
        t0 = time.perf_counter()
        n_v, n_f = write_scan(scans, sid)
        t_write = time.perf_counter() - t0
        with open(os.path.join(splits, "scannetv2_val.txt"), "w") as f:
            f.write(sid + "\n")
        t0 = time.perf_counter()
        prepare_scannet.main(["--scans_dir", scans, "--output_dir", out,
                              "--splits_dir", splits, "--num_workers", "1"])
        t_prep = time.perf_counter() - t0
        sp = np.fromfile(os.path.join(out, "super_points", f"{sid}.bin"),
                         np.int64)
        inst = np.fromfile(os.path.join(out, "instance_mask", f"{sid}.bin"),
                           np.int64)
        pts = np.fromfile(os.path.join(out, "points", f"{sid}.bin"),
                          np.float32).reshape(-1, 6)
        if len(sp) != n_v or len(pts) != n_v or not np.isfinite(pts).all():
            raise SystemExit("phase 9d: prepared files of the wrong size")
        print(f"phase 9d: prepare_scannet on a {n_v}-vertex, {n_f}-face "
              f"scan (written in {t_write:.1f} s): {t_prep:.2f} s, "
              f"{len(np.unique(sp))} superpoints, {len(np.unique(inst)) - 1} "
              f"instances", flush=True)
        cfg = baseline_model_cfg()
        model, test_cfg = build_model(cfg, Capacities(
            num_superpoints=SCENE["n_superpoints"],
            level_cap_ratios=LEVEL_CAP_RATIOS))
        random_init_(model, seed=0)
        # the prepared labels are raw ScanNet ids: the reader maps them
        launches, ms, rate, peak, metrics, kept = run_disk_eval(
            model, test_cfg, out, "baseline", features_2d=False,
            adjust_class_ids=True)
    check_counts(launches, BASELINE_FORWARD, "phase 9d baseline launches in "
                 "one hybrid forward of the prepared scan")
    if not all(bool(torch.isfinite(k).all()) for k in kept) or \
            not np.isfinite(metrics["all_ap_25"]):
        raise SystemExit("phase 9d: non-finite outputs")
    print(f"phase 9d: the Baseline eval entry point on the prepared scan "
          f"(rgb alone, raw ids mapped by the reader): {rate:.3f} scenes/s, "
          f"ms " + ", ".join(f"{k} {v:.2f}" for k, v in ms.items())
          + f"; peak {peak / 2 ** 30:.3f} GiB; all_ap_25="
          f"{metrics['all_ap_25']:.4f}; prepare {t_prep:.2f} s; {card}",
          flush=True)


def run_phase9(card, step_launches):
    """Phase 9: 9a a 2-rank step of each layout (``step_launches``: the
    one-process step's launches of each), 9b the CLI under
    torch.distributed.run, 9c eval in 2 processes, 9d prepared data;
    returns 9a's launches a rank of each layout."""
    import tempfile

    from segdino3d_tpu_torch.data.synthetic import write_scannet_layout

    launches = run_dist_step_phase(card, step_launches)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        write_scannet_layout(root, EVAL_DIST_SEEDS, **SCENE)
        print(f"phase 9: wrote {len(EVAL_DIST_SEEDS)} scenes in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        run_torchrun_cli_phase(card, root)
        run_dist_eval_phase(card, root)
    run_prepared_data_phase(card)
    return launches


# --------------------------------------------------------------------------
# phase 11: the serving export
# --------------------------------------------------------------------------

# the scenes the artifact serves (the headline scene's generator, seeds
# 0-3), padded to the JAX tool's PadSpec (131,072 points)
SERVE_SEEDS = (0, 1, 2, 3)
SERVE_POINTS = 131072
SERVE_TIMED = 3            # timed calls a scene, after one warm-up call
# the port's hand-written kernels (csrc/), as the profiler names them
OWN_KERNELS = ("block_conv_kernel", "block_conv_narrow_kernel",
               "block_conv_wg_kernel", "group_sum_kernel",
               "block_wgrad_kernel", "block_wgrad_narrow_kernel",
               "build_lookup_kernel", "count_live_kernel", "list_live_kernel",
               "live_products_kernel", "live_products_wg_kernel",
               "live_sum_kernel",
               "conv_pair_sum_kernel", "conv_products_kernel",
               "conv_products_wg_kernel", "count_pairs_kernel",
               "count_rows_kernel", "csr_keys_kernel", "csr_offsets_kernel",
               "dilate_kernel", "finish_kernel", "flags_kernel",
               "gather_conv_narrow_kernel", "gather_wgrad_kernel",
               "gather_wgrad_narrow_kernel",
               "list_pairs_kernel", "list_rows_kernel", "lookup_kernel",
               "neighbor_kernel", "segment_grad_kernel",
               "segment_mean_kernel", "slot_gather_kernel",
               "stem_slot_sum_kernel", "sum_splits_kernel", "up_conv_kernel")
# fragments of library convolution kernels (cuDNN's) that must not stand
# in for them
LIBRARY_CONV = ("cudnn", "fprop", "dgrad", "implicit_convolve",
                "implicit_gemm", "winograd")


def kernel_counts(names):
    """{kernel name: launches} of ``device_ops``'s names, copies and
    memsets left out."""
    import collections

    return dict(collections.Counter(
        n for n in names if not n.startswith(("Memcpy", "Memset"))))


def own_kernels(names):
    """The entries of ``kernel_counts`` that are the port's kernels."""
    return {n: c for n, c in names.items()
            if any(k in n for k in OWN_KERNELS)}


def library_convs(names):
    return sorted(n for n in names if n not in own_kernels(names)
                  and any(f in n.lower() for f in LIBRARY_CONV))


def served_leaves(records, meta, seed):
    """The leaves of scene ``seed`` of ``records`` at the artifact's
    capacities (``meta``), on the card."""
    from segdino3d_tpu_torch.tools import export_serving as ES

    return ES.serving_batch([records[seed]], meta, DEVICE)


def serve_scenes(call, records, meta):
    """Each scene of ``records`` ({seed: record}) served by ``call`` (1 +
    ``SERVE_TIMED`` synchronised calls, each on a batch built anew by
    ``served_leaves``):
    {"outs": {seed: the first call's outputs on the host}, "last": the
    last call's, and the means over the timed calls of "plan" ms (collate
    + the host plan: ``serving_batch``), "collate" ms (``collate`` to the
    card alone, at ``spec``, timed apart after each batch) and "forward"
    ms (the served function), and "faults", the minor page faults of the
    process a plan}."""
    import resource

    from segdino3d_tpu_torch.data.collate import collate

    spec = served_spec(meta)
    res = dict(outs={}, last={})
    plan_ms, collate_ms, fwd_ms, faults = [], [], [], []
    for seed in records:
        for rep in range(1 + SERVE_TIMED):
            torch.cuda.synchronize()
            f0 = resource.getrusage(resource.RUSAGE_SELF).ru_minflt
            t0 = time.perf_counter()
            leaves = served_leaves(records, meta, seed)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            f1 = resource.getrusage(resource.RUSAGE_SELF).ru_minflt
            got = call(leaves)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if rep == 0:
                res["outs"][seed] = {k: v.cpu() for k, v in got.items()}
                continue
            plan_ms.append(1e3 * (t1 - t0))
            fwd_ms.append(1e3 * (t2 - t1))
            faults.append(f1 - f0)
            del leaves, got
            t0 = time.perf_counter()
            collate([records[seed]], spec, DEVICE)
            torch.cuda.synchronize()
            collate_ms.append(1e3 * (time.perf_counter() - t0))
        res["last"][seed] = {k: v.cpu() for k, v in call(
            served_leaves(records, meta, seed)).items()}
    res.update(plan=float(np.mean(plan_ms)),
               collate=float(np.mean(collate_ms)),
               forward=float(np.mean(fwd_ms)),
               faults=float(np.mean(faults)))
    return res


def served_spec(meta):
    from segdino3d_tpu_torch.data.collate import PadSpec

    p = meta["pad_spec"]
    return PadSpec(p["n_points"], p["s_cap"], p["i_cap"], p["k2d"],
                   p["n_sem"])


def host_threads():
    """(torch's intra-op threads, the process's live threads)."""
    return torch.get_num_threads(), len(os.listdir("/proc/self/task"))


def serve_child(art, records_path, out):
    """Phase 11's serving process: load the artifact (``load_artifact``:
    the registered ops, not the model code), build each scene's batch from
    its record (``records_path``, as a reader would give it) at the
    artifact's capacities (``serving_batch``), run it, count its launches
    and profile its kernels; writes the results to ``out``."""
    t0 = time.perf_counter()
    from segdino3d_tpu_torch.tools import export_serving as ES

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    call, meta = ES.load_artifact(art)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    records = torch.load(records_path, weights_only=False)
    first = served_leaves(records, meta, SERVE_SEEDS[0])
    t0 = time.perf_counter()
    call(first)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    served = serve_scenes(call, records, meta)
    reset_counts()
    call(first)
    torch.cuda.synchronize()
    launches = read_counts()
    names = kernel_counts(device_ops(lambda: call(first))[0])
    barred = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith(
                        ("jax.", "segdino3d_tpu.",
                         "segdino3d_tpu_torch.models"))
                    or m in ("segdino3d_tpu", "segdino3d_tpu_torch.builder",
                             "segdino3d_tpu_torch.registry"))
    torch.save(dict(served, load_s=load_s, first_s=first_s,
                    launches=launches, names=names, barred=barred,
                    threads=host_threads()), out)


OP_CALLS = 1000


def op_route_us(registered):
    """Host microseconds a call of K9 on a small input, launched by its
    wrapper or through its registered op (``ops/custom_ops.py``, which
    the eager paths take only while ``torch.export`` traces)."""
    from segdino3d_tpu_torch.ops import block_dense as BD
    from segdino3d_tpu_torch.ops import custom_ops as CO

    x = torch.randn(1024, 32, device=DEVICE)
    idx = torch.arange(1024, dtype=torch.int32, device=DEVICE)
    fn = CO.slot_gather if registered else BD.slot_gather
    fn(x, idx)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(OP_CALLS):
        fn(x, idx)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / OP_CALLS * 1e6


def differing_slots(a, b):
    """Slots of one scene's outputs whose label, validity or packed mask
    differ between ``a`` and ``b``."""
    return int(((a["labels"] != b["labels"]) | (a["valid"] != b["valid"])
                | (a["masks_packed"] != b["masks_packed"]).any(-1)).sum())


def eager_spread(eager):
    """{seed: the slots and the largest score difference by which two
    eager calls on the scene differ} (``serve_scenes``'s first and last
    calls)."""
    return {seed: dict(slots=differing_slots(eager["outs"][seed], last),
                       scores=float((eager["outs"][seed]["scores"]
                                     - last["scores"]).abs().max()))
            for seed, last in eager["last"].items()}


def compare_served(got, want, spread, what):
    """Each scene's labels, validity and packed masks equal, and scores
    within ``TOL[bf16]``; where two eager calls on the scene differed
    (``spread``), in no more slots than they did, and scores no further
    apart than theirs."""
    for seed in want:
        g, w, sp = got[seed], want[seed], spread[seed]
        slots = differing_slots(g, w)
        err = float((g["scores"] - w["scores"]).abs().max())
        tol = max(TOL[torch.bfloat16], sp["scores"])
        print(f"phase 11 scene {seed}: {what} against the eager path: "
              f"labels, valid, masks_packed differ in {slots} slots (limit "
              f"{sp['slots']}, two eager calls); scores max_abs_err="
              f"{err:.3e} (limit {tol:.3e}); {int(g['valid'].sum())} valid "
              f"slots of {g['valid'].numel()}", flush=True)
        if slots > sp["slots"] or err > tol:
            raise SystemExit(f"phase 11: {what} disagrees with the eager "
                             f"path on scene {seed}")


PAIRED_ORDER = ("artifact", "eager", "eager", "artifact")


def paired_forwards(calls, records, meta):
    """Forward ms of each of ``calls`` ({route: call}) in one process, in
    ``PAIRED_ORDER`` on every scene, each call on a batch built anew:
    {route: [ms]}, the i-th entries of the two routes a pair."""
    ms = {r: [] for r in calls}
    for seed in records:
        for route in PAIRED_ORDER:
            leaves = served_leaves(records, meta, seed)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            calls[route](leaves)
            torch.cuda.synchronize()
            ms[route].append(1e3 * (time.perf_counter() - t0))
    return ms


def run_serving_phase(card):
    """Phase 11: the bf16 flagship's serving artifact (``tools/
    export_serving.py``) at full width on the card, loaded and run in a
    child process without the model code, against the eager served
    function on the same scenes; returns the artifact's launches a
    forward."""
    import collections
    import tempfile

    from segdino3d_tpu_torch.data.collate import collate, probe_plan_caps
    from segdino3d_tpu_torch.tools import export_serving as ES

    t_phase = time.perf_counter()
    spec = ES.pad_spec(SERVE_POINTS, SCENE["n_superpoints"], False)
    plan = ES.plan_args(False)
    records = {seed: ES.scene_records([seed], SCENE["n_points"],
                                      SCENE["n_superpoints"], False)[0]
               for seed in SERVE_SEEDS}
    vox, blocks = 0, None
    for seed in SERVE_SEEDS:
        rec = [records[seed]]
        v, b = probe_plan_caps(collate(rec, spec, "cpu"), rec,
                               voxel_size=plan["voxel_size"],
                               level_cap_ratios=plan["level_cap_ratios"],
                               block_edges=plan["block_edges"])
        vox = max(vox, v)
        blocks = b if blocks is None else [max(x, y)
                                           for x, y in zip(blocks, b)]
    with tempfile.TemporaryDirectory() as tmp:
        art = os.path.join(tmp, "artifact")
        # the tool's default backbone dtype, bf16
        dtype_env = os.environ.pop("SEGDINO_COMPUTE_DTYPE", None)
        t0 = time.perf_counter()
        try:
            _, _, _, meta, served_fn = ES.export_artifact(
                art, DEVICE, SERVE_POINTS, SCENE["n_superpoints"], 1,
                SCENE["n_points"], records=[records[SERVE_SEEDS[0]]],
                voxel_cap=vox, block_caps=blocks,
                # phase 9c's thresholds: the random weights keep no
                # instance under the flagship's own
                test_cfg=EVAL_DIST_TEST_CFG)
        finally:
            if dtype_env is not None:
                os.environ["SEGDINO_COMPUTE_DTYPE"] = dtype_env
        export_s = time.perf_counter() - t0
        mb = os.path.getsize(os.path.join(art, "model.pt2")) / 1e6
        print(f"phase 11: exported the {meta['compute_dtype']} flagship "
              f"(6 decoder layers, d_model 256) at PadSpec "
              f"{meta['pad_spec']}, plan caps voxels {vox} blocks {blocks} "
              f"(probe_plan_caps of scenes {list(SERVE_SEEDS)}), "
              f"{meta['n_batch_leaves']} batch leaves: {export_s:.1f} s, "
              f"model.pt2 {mb:.1f} MB", flush=True)

        out = os.path.join(tmp, "served.pt")
        records_path = os.path.join(tmp, "records.pt")
        torch.save(records, records_path)
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-c",
             "import sys; sys.path.insert(0, %r); import chip_smoke; "
             "chip_smoke.serve_child(%r, %r, %r)"
             % (os.path.dirname(os.path.abspath(__file__)), art,
                records_path, out)],
            capture_output=True, text=True, timeout=600)
        child_s = time.perf_counter() - t0
        if child.returncode != 0:
            print(child.stdout[-4000:], child.stderr[-8000:], flush=True)
            raise SystemExit("phase 11: the serving process failed")
        served = torch.load(out, weights_only=False)
        # the artifact again in this process, for forwards paired with
        # the eager path's
        art_call, _ = ES.load_artifact(art)

    if served["barred"]:
        raise SystemExit(f"phase 11: the serving process imported "
                         f"{served['barred']}")

    def eager(leaves):
        return served_fn(*leaves)

    def fresh():
        return (served_leaves(records, meta, SERVE_SEEDS[0]),)

    want = serve_scenes(eager, records, meta)
    spread = eager_spread(want)
    print("phase 11: two eager calls a scene differ in "
          + "; ".join(f"scene {seed}: {sp['slots']} slots, scores by "
                      f"{sp['scores']:.3e}" for seed, sp in spread.items()),
          flush=True)
    compare_served(served["outs"], want["outs"], spread,
                   "the artifact in the serving process")
    paired = paired_forwards(dict(artifact=art_call, eager=eager), records,
                             meta)
    diff = np.subtract(paired["artifact"], paired["eager"])
    print(f"phase 11 ({card}) paired forwards in this process "
          f"({len(diff)} pairs, {'/'.join(PAIRED_ORDER)} a scene, a batch "
          f"built anew each): artifact {np.mean(paired['artifact']):.2f} "
          f"ms, eager {np.mean(paired['eager']):.2f} ms; artifact - eager "
          f"a pair: mean {diff.mean():.2f}, median {np.median(diff):.2f}, "
          f"min {diff.min():.2f}, max {diff.max():.2f} ms", flush=True)
    ops = {route: collections.Counter(str(op) for op, _ in dispatched(
        lambda: call(*fresh()))) for route, call in
        (("artifact", art_call), ("eager", eager))}
    gap = sorted(set(ops["artifact"]) | set(ops["eager"]),
                 key=lambda op: ops["eager"][op] - ops["artifact"][op])
    print(f"phase 11 operators a forward (dispatched, the wrappers' direct "
          f"launches apart): artifact {sum(ops['artifact'].values())}, "
          f"eager {sum(ops['eager'].values())}; the largest differences "
          f"(artifact / eager): " + ", ".join(
              f"{op} {ops['artifact'][op]} / {ops['eager'][op]}"
              for op in gap[:8]), flush=True)
    compare_served({seed: {k: v.cpu() for k, v in art_call(
        served_leaves(records, meta, seed)).items()} for seed in records},
        want["outs"], spread, "the artifact in this process")

    # a batch built anew, as each of phase 10a's forwards takes: the
    # eager path keeps a table's pair list while the table lives
    reset_counts()
    eager(*fresh())
    torch.cuda.synchronize()
    launches = read_counts()
    expected = {**HYBRID_FORWARD, **NO_NARROW,
                "gather_gemm_conv wide stem": 1}
    check_counts(launches, expected, "phase 11 eager served forward "
                 "(phase 10a's launches)")
    check_counts(served["launches"], launches, "phase 11 artifact forward "
                 "in the serving process")
    names = kernel_counts(device_ops(eager, fresh)[0])
    own_e, own_a = own_kernels(names), own_kernels(served["names"])
    same = "name for name and count for count equal" if own_a == own_e \
        else "DIFFERENT"
    print(f"phase 11 hand-written kernels a forward (torch.profiler): eager "
          f"{sum(own_e.values())} launches of {len(own_e)} kernels, the "
          f"artifact {sum(own_a.values())} of {len(own_a)}: {same}; "
          + ", ".join(f"{n} {c}" for n, c in sorted(own_a.items())),
          flush=True)
    if own_a != own_e:
        raise SystemExit(f"phase 11: the artifact's kernels {own_a} differ "
                         f"from the eager forward's {own_e}")
    convs = library_convs(served["names"]) + library_convs(names)
    rest_e = {n: c for n, c in names.items() if n not in own_e}
    rest_a = {n: c for n, c in served["names"].items() if n not in own_a}
    only_a = sorted(set(rest_a.items()) - set(rest_e.items()))
    only_e = sorted(set(rest_e.items()) - set(rest_a.items()))
    rest = "equal" if rest_a == rest_e else \
        f"differ: the artifact's {only_a}, the eager path's {only_e}"
    print(f"phase 11 library convolutions in either forward: {convs}; the "
          f"other kernels ({sum(rest_a.values())} launches in the artifact, "
          f"{sum(rest_e.values())} eager) {rest}", flush=True)
    if convs:
        raise SystemExit(f"phase 11: library convolutions {convs}")
    print(f"phase 11 host us a call of K9 (slot_gather, 1,024 x 32 rows, "
          f"{OP_CALLS} calls back to back): the wrapper's launch "
          f"{op_route_us(False):.2f}, through the registered op "
          f"{op_route_us(True):.2f}", flush=True)
    n = len(SERVE_SEEDS)
    c_plan, e_plan = served["plan"], want["plan"]
    print(f"phase 11 ({card}): export {export_s:.1f} s, artifact "
          f"{mb:.1f} MB, cold load {served['load_s']:.2f} s (the serving "
          f"process, its first call {served['first_s']:.2f} s, the process "
          f"{child_s:.1f} s in all); a forward: artifact in the serving "
          f"process {served['forward']:.2f} ms, eager {want['forward']:.2f} "
          f"ms; collate + host plan {c_plan:.2f} / {e_plan:.2f} ms, of "
          f"which collate {served['collate']:.2f} / {want['collate']:.2f} "
          f"and the host plan {c_plan - served['collate']:.2f} / "
          f"{e_plan - want['collate']:.2f}, minor page faults a plan "
          f"{served['faults']:.0f} / {want['faults']:.0f}; torch threads / "
          f"live threads "
          f"{served['threads']} / {host_threads()}; scenes/s (plan + "
          f"forward, {n} scenes x {SERVE_TIMED} calls) artifact "
          f"{1e3 / (c_plan + served['forward']):.3f}, eager "
          f"{1e3 / (e_plan + want['forward']):.3f}; the phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return served["launches"]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
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

    # the v2 scenes (the same geometry, 18 instance classes); the first
    # one's host plan lives on the card for phase 2 only, so the earlier
    # phases' peaks do not count it
    from segdino3d_tpu_torch.data.synthetic import synthetic_scene
    v2_records = []
    for seed in TRAIN_SEEDS[:TRAIN_STEPS]:
        rec = synthetic_scene(seed, **dict(SCENE, n_classes=18))
        rec["points_2dfeats"] = rec["points_2dfeats"].astype(np.float16)
        v2_records.append(rec)
    v2_batch = v2_host_batch(v2_records)

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
                         + stem_compact_cases(records, spec, gen)
                         + v2_cases(v2_batch, SCENE["n_superpoints"], gen)
                         + baseline_cases(batch, hybrid.plan, gen))
    del hybrid, v2_batch

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
    if launches["gather_gemm_conv narrow"]:
        raise SystemExit("the flagship's forward took K1's narrow path")
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
    hybrid_launches, hybrid_feats = run_hybrid_eval(model, test_cfg, records,
                                                    spec, bb)

    # phase 3d: the eval entry point on scenes read from disk, the gather
    # stem and the compacted stem
    disk_launches, disk_ms = run_disk_phase(model, test_cfg)

    # phase 4: the training path at full width
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

    del tmodel, dmodel

    # phase 4d: the training entry point (the CLI) from scenes on disk
    cli_launches = run_cli_phase(sum(v for k, v in accum.items()
                                     if k != "plan"))

    # phase 5: the ScanNet v2 model (SpConvUNet) at full width
    v2_launches, v2_dev_launches, v2_train_launches = run_v2_phase(
        v2_records)

    # phase 6: the Baseline_ScanNet200 model (rgb alone) at full width
    (bl_launches, bl_dev_launches, bl_train_launches,
     bl_dev_train_launches) = run_baseline_phase(
        [rgb_only(r) for r in records],
        [rgb_only(r) for r in train_records], spec, disk_ms)

    # phase 7: the decoder options on the flagship model at full width
    run_options_phase(model, records, train_records, spec, caps)

    # phase 10: the flagship backbone in bf16 (10a hybrid eval, 10b
    # block-dense steps)
    bf16_launches, bf16_train_launches = run_bf16_phase(
        model, test_cfg, records, train_records, spec, tspec, caps,
        hybrid_feats)
    del model

    # phase 9: a 2-rank step, the CLI in an NCCL group, eval in 2
    # processes, the prepared data
    dist_launches = run_phase9(card, {
        "gather": dict(train_launches),
        "block-dense": dict(dense_train_launches)})

    # phase 11: the bf16 flagship's serving export, run in a process
    # without the model code
    artifact_launches = run_serving_phase(card)

    # phase 8: the kernels line, then the result line
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
        # the live-pair list of the dense stem's forward and dW: the pairs
        # whose products the JAX op's dense conv computes as exact zeros
        # are left out
        "block_live_pairs": ("segdino3d_tpu_torch/csrc/block_conv.cu",
                             "segdino3d_tpu/ops/block_dense.py:257"),
        "stem_slot_sum": ("segdino3d_tpu_torch/csrc/stem_slot_sum.cu",
                          "segdino3d_tpu/ops/sparse_conv.py:369"),
    }
    plan_kernels = ("coord_hash", "neighbor_table", "voxel_compact")
    dense_kernels = ("slot_gather", "block_conv", "block_dilate",
                     "block_wgrad", "block_live_pairs")
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
        # phase 5's counts: the host-plan forward's, the device-plan
        # forward's for the plan engine's kernels, else the train step's
        v2_main = v2_dev_launches[name] if name in plan_kernels else \
            v2_launches[name] or v2_train_launches[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=main_launches, launches_train_step=train_launches[name],
            max_abs_err=rows[name]["max_abs_err"],
            ms=h["ms"], plain_ms=h["plain_ms"], bound_ms=h["bound_ms"],
            bound_by=h["bound_by"], library_ms=h["library_ms"],
            shape=h["case"], launches_v2=v2_main,
            launches_v2_train_step=v2_train_launches[name],
            v2_cases=[c for c in rows[name]["cases"]
                      if c["shape"].startswith("v2 ")],
            launches_baseline=(bl_dev_launches[name] if name in plan_kernels
                               else bl_launches[name]
                               or bl_train_launches[name]),
            launches_baseline_train_step=(
                bl_dev_train_launches[name] if name in plan_kernels
                else bl_train_launches[name]
                or bl_dev_train_launches[name]),
            baseline_cases=[c for c in rows[name]["cases"]
                            if c["shape"].startswith("baseline ")],
            cli_device_launches_per_step=cli_launches.get(name, 0),
            **({"narrow_launches": dict(
                flagship=launches[f"{name} narrow"],
                baseline=bl_launches[f"{name} narrow"],
                baseline_train_step=bl_train_launches[f"{name} narrow"],
                baseline_device_train_step=bl_dev_train_launches[
                    f"{name} narrow"])}
               if f"{name} narrow" in launches else {}),
            **({"live_launches": dict(
                block_dense_train_step=dense_train_launches[f"{name} live"],
                bf16_train_step=bf16_train_launches[f"{name} live"],
                baseline_train_step=bl_train_launches[f"{name} live"],
                eval_hybrid=hybrid_launches[f"{name} live"])}
               if f"{name} live" in launches else {}),
            launches_2rank_step=dist_launches["block-dense"][name],
            launches_2rank_step_gather=dist_launches["gather"][name],
            launches_bf16=bf16_launches[name],
            launches_artifact=artifact_launches[name],
            launches_bf16_train_step=bf16_train_launches[name],
            bf16_cases=rows[name]["bf16_cases"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"chip_smoke wall time: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
