"""Padded-batch assembly: numpy records -> ``SceneBatch`` tensors.

Counterpart of ``segdino3d_tpu/data/collate.py`` (``PadSpec``, ``collate``,
``_plan_coords``, ``attach_host_plan`` in the gather, block-dense and
hybrid layouts, and ``eval_annotation``).  Scenes are padded to static
capacities.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from segdino3d_tpu_torch.gtypes import SceneBatch
from segdino3d_tpu_torch.ops.host_plan import (L0_BUDGET_BYTES,
                                               build_host_plan,
                                               host_plan_to_device,
                                               probe_voxel_count,
                                               voxel_bucket)


@dataclass(frozen=True)
class PadSpec:
    num_points: int
    num_superpoints: int
    num_instances: int
    num_queries2d: int
    num_semantic_classes: int


def _pad_to(arr: np.ndarray, n: int, axis: int = 0, fill=0):
    pad = n - arr.shape[axis]
    if pad < 0:
        raise ValueError(
            f"record dim {arr.shape[axis]} exceeds capacity {n} (axis {axis})")
    if pad == 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return np.pad(arr, widths, constant_values=fill)


def collate(records: List[Dict], spec: PadSpec, device) -> SceneBatch:
    """Pad ``records`` to ``spec`` and put the batch on ``device``."""
    b = len(records)
    P, S, I, K = (spec.num_points, spec.num_superpoints,
                  spec.num_instances, spec.num_queries2d)
    Csem = spec.num_semantic_classes

    points = np.zeros((b, P, 6), np.float32)
    point_valid = np.zeros((b, P), bool)
    sp_ids = np.zeros((b, P), np.int32)
    n_sp = np.zeros((b,), np.int32)
    inst_labels = np.zeros((b, I), np.int32)
    inst_valid = np.zeros((b, I), bool)
    point_inst = np.full((b, P), -1, np.int32)
    sp_inst_masks = np.zeros((b, I, S), bool)
    sp_sem_masks = np.zeros((b, Csem + 1, S), bool)
    scene_idx = np.zeros((b,), np.int32)

    any_2d = any(r.get("points_2dfeats") is not None for r in records)
    any_el = any(r.get("elastic_coords") is not None for r in records)
    c2d = next((r["points_2dfeats"].shape[-1] for r in records
                if r.get("points_2dfeats") is not None), 0)
    cq = next((r["query2d_feats"].shape[-1] for r in records
               if r.get("query2d_feats") is not None), 0)
    p2d_dtype = next((np.asarray(r["points_2dfeats"]).dtype for r in records
                      if r.get("points_2dfeats") is not None), np.float32)
    p2d = np.zeros((b, P, c2d), p2d_dtype) if any_2d else None
    q2f = np.zeros((b, K, cq), np.float32) if any_2d else None
    q2p = np.zeros((b, K, 3), np.float32) if any_2d else None
    q2v = np.zeros((b, K), bool) if any_2d else None
    elastic = np.zeros((b, P, 3), np.float32) if any_el else None

    for bi, r in enumerate(records):
        n = r["points"].shape[0]
        points[bi] = _pad_to(np.asarray(r["points"], np.float32), P)
        point_valid[bi, :n] = True
        if r["superpoint_ids"] is not None:
            sp_ids[bi] = _pad_to(r["superpoint_ids"].astype(np.int32), P)
            n_sp[bi] = int(r["superpoint_ids"].max()) + 1
        ni = len(r["inst_labels"])
        inst_labels[bi, :ni] = r["inst_labels"]
        inst_valid[bi, :ni] = True
        point_inst[bi] = _pad_to(r["point_inst_ids"].astype(np.int32), P,
                                 fill=-1)
        if r.get("sp_inst_masks") is not None:
            m = r["sp_inst_masks"]
            sp_inst_masks[bi, :m.shape[0], :m.shape[1]] = m
        if r.get("sp_sem_masks") is not None:
            m = r["sp_sem_masks"]
            # the last row is the unlabeled class: keep it last even when
            # the record's label space is smaller than the spec's
            sp_sem_masks[bi, :m.shape[0] - 1, :m.shape[1]] = m[:-1]
            sp_sem_masks[bi, -1, :m.shape[1]] = m[-1]
        scene_idx[bi] = r.get("scene_idx", bi)
        if any_2d and r.get("points_2dfeats") is not None:
            p2d[bi] = _pad_to(np.asarray(r["points_2dfeats"], p2d_dtype), P)
            nq = r["query2d_feats"].shape[0]
            q2f[bi, :nq] = r["query2d_feats"]
            q2p[bi, :nq] = r["query2d_pos"]
            q2v[bi, :nq] = True
        if any_el:
            if r.get("elastic_coords") is not None:
                elastic[bi] = _pad_to(
                    np.asarray(r["elastic_coords"], np.float32), P)
            else:
                vs = r.get("coords_voxel_size", 0.02)
                elastic[bi] = _pad_to(
                    np.asarray(r["points"][:, :3] / vs, np.float32), P)

    def t(x):
        return None if x is None else torch.from_numpy(x).to(device)

    return SceneBatch(
        points=t(points), point_valid=t(point_valid),
        superpoint_ids=t(sp_ids), num_superpoints=t(n_sp),
        points_2dfeats=t(p2d), query2d_feats=t(q2f),
        query2d_pos=t(q2p), query2d_valid=t(q2v),
        elastic_coords=t(elastic),
        inst_labels=t(inst_labels), inst_valid=t(inst_valid),
        point_inst_ids=t(point_inst),
        sp_inst_masks=t(sp_inst_masks), sp_sem_masks=t(sp_sem_masks),
        scene_idx=t(scene_idx),
    )


def _plan_coords(records: List[Dict], num_points: int, voxel_size: float):
    """Voxel-unit plan coordinates: elastic coords when present, else
    xyz/voxel_size, min-shifted per scene by a multiple of 16 (the backbone
    wrapper's coordinate policy, ``models.backbone.wrapper``)."""
    b = len(records)
    coords = np.zeros((b, num_points, 3), np.float32)
    valid = np.zeros((b, num_points), bool)
    for bi, r in enumerate(records):
        n = r["points"].shape[0]
        valid[bi, :n] = True
        if r.get("elastic_coords") is not None:
            c = np.asarray(r["elastic_coords"], np.float32)
        else:
            c = np.asarray(r["points"][:, :3], np.float32) / voxel_size
        mins = np.floor(c.min(0) / 16.0) * 16.0
        coords[bi, :n] = c - mins
    bidx = np.repeat(np.arange(b, dtype=np.int32), num_points)
    return coords, valid, bidx


def attach_host_plan(batch: SceneBatch, records: List[Dict], spec: PadSpec,
                     *, voxel_size: float, voxel_cap: Optional[int] = None,
                     level_cap_ratios=(1.0, 0.7, 0.35, 0.12, 0.05),
                     level_caps: Optional[Sequence[int]] = None,
                     num_levels: int = 5, stem_kernel: int = 5,
                     block_edges: Optional[Sequence[int]] = None,
                     block_caps: Optional[Sequence[int]] = None,
                     stem_gather: bool = False, auto_l0_layout: bool = True
                     ) -> SceneBatch:
    """Build the sparse-conv plan on the host (C++) and attach it on the
    batch's device.

    ``voxel_cap=None`` probes the batch's unique-voxel count and picks a
    geometric bucket; ``level_caps`` (measured per-level voxel caps)
    overrides the ``level_cap_ratios`` derivation.  ``block_edges[l]`` > 0
    runs level ``l`` block-dense (block counts bucketed unless
    ``block_caps`` pins them) and ``stem_gather`` keeps a gather stem over
    a block-dense level 0 (``builder.host_plan_args`` reads these from a
    model config).  ``auto_l0_layout`` lets level 0 fall back to the gather
    layout when its dense convs would outgrow the JAX package's budget
    (``ops.host_plan.l0_dense_fits``, ``L0_BUDGET_BYTES``)."""
    coords, valid, bidx = _plan_coords(records, spec.num_points, voxel_size)
    if level_caps is not None:
        caps = [max(256, -(-int(c) // 256) * 256)
                for c in level_caps[:num_levels]]
        if voxel_cap is not None:
            caps[0] = voxel_cap
    else:
        if voxel_cap is None:
            voxel_cap = voxel_bucket(probe_voxel_count(
                coords.reshape(-1, 3), bidx, valid.reshape(-1)))
        caps = [max(256, -(-int(voxel_cap * r) // 256) * 256)
                for r in level_cap_ratios[:num_levels]]
        caps[0] = voxel_cap
    plan = build_host_plan(coords.reshape(-1, 3), bidx, valid.reshape(-1),
                           caps, num_levels=num_levels,
                           stem_kernel=stem_kernel, block_edges=block_edges,
                           block_caps=block_caps, stem_gather=stem_gather,
                           l0_budget_bytes=(L0_BUDGET_BYTES if auto_l0_layout
                                            else None))
    if plan.overflow:
        raise ValueError("host plan capacity overflow — raise voxel caps")
    return dataclasses.replace(
        batch, plan=host_plan_to_device(plan, batch.points.device))


def eval_annotation(record: Dict, bg_class_id: int = 200
                    ) -> Dict[str, np.ndarray]:
    """Per-point GT maps for the evaluator."""
    inst = record["inst_merged"]
    sem = record["semantic_masks"]
    sem_ann = np.where(inst >= 0, sem, bg_class_id)
    return dict(pts_instance_mask=inst.astype(np.int64),
                pts_semantic_mask=sem_ann.astype(np.int64),
                lidar_idx=record["scene_id"])
