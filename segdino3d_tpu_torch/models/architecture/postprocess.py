"""Eval post-processing: top-k, matrix-NMS, unpooling, filters.

Counterpart of ``segdino3d_tpu/models/architecture/postprocess.py``.  Every
function takes one scene's tensors and keeps static shapes: the top
``topk_insts`` slots carry validity flags instead of being filtered.  The
top-k is a stable descending sort, so ties break toward the lower index as
``lax.top_k`` does; thresholds are strict ``>``.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from segdino3d_tpu_torch.ops.nms import mask_matrix_nms


class InstancePred(NamedTuple):
    point_masks: torch.Tensor   # (N_out, P) bool
    labels: torch.Tensor        # (N_out,) int64
    scores: torch.Tensor        # (N_out,) float
    valid: torch.Tensor         # (N_out,) bool
    boxes: torch.Tensor         # (N_out, 6) center+size (zeros if absent)


def predict_instance(cls_preds: torch.Tensor,      # (Q, C+1)
                     mask_logits: torch.Tensor,    # (Q, S)
                     query_valid: torch.Tensor,    # (Q,)
                     sp_valid: torch.Tensor,       # (S,)
                     sp_ids: torch.Tensor,         # (P,) point -> superpoint
                     point_valid: torch.Tensor,    # (P,)
                     points_xyz: torch.Tensor,     # (P, 3)
                     score_threshold: float,
                     test_cfg: Dict,
                     centers: Optional[torch.Tensor] = None,   # (Q, 3)
                     sizes: Optional[torch.Tensor] = None,
                     scores_q: Optional[torch.Tensor] = None,  # (Q, 1)
                     filter_outofbox: bool = False) -> InstancePred:
    num_classes = cls_preds.shape[1] - 1
    probs = torch.softmax(cls_preds, dim=-1)[:, :-1]
    if scores_q is not None:
        probs = probs * scores_q
    probs = torch.where(query_valid[:, None], probs, -1.0)

    flat = probs.reshape(-1)
    k = min(test_cfg.get("topk_insts", 600), flat.shape[0])
    sorted_scores, sorted_idx = torch.sort(flat, descending=True, stable=True)
    top_scores, top_idx = sorted_scores[:k], sorted_idx[:k]
    labels = top_idx % num_classes
    qidx = top_idx // num_classes
    inst_valid = top_scores > -0.5

    m_logits = mask_logits[qidx]
    m_sig = torch.sigmoid(m_logits) * sp_valid[None, :]

    scores = top_scores
    if test_cfg.get("obj_normalization"):
        pos = (m_logits > 0) & sp_valid[None, :]
        mask_scores = (m_sig * pos).sum(-1) / (pos.sum(-1) + 1e-6)
        scores = scores * mask_scores

    if test_cfg.get("nms"):
        new_scores, order = mask_matrix_nms(
            m_sig, labels, scores, valid=inst_valid,
            kernel=test_cfg.get("matrix_nms_kernel", "linear"))
        scores = new_scores[order]
        labels = labels[order]
        m_sig = m_sig[order]
        qidx = qidx[order]
        inst_valid = inst_valid[order] & torch.isfinite(scores)

    # threshold before the superpoint -> point unpool (same result, the
    # gathered values are copies)
    sp_safe = sp_ids.long().clamp(0, m_sig.shape[1] - 1)
    sp_mask = m_sig > test_cfg.get("sp_score_thr", 0.4)
    pt_mask = sp_mask[:, sp_safe] & point_valid[None, :]

    inst_valid = inst_valid & (scores > score_threshold)
    npoints = pt_mask.sum(-1)
    inst_valid = inst_valid & (npoints > test_cfg.get("npoint_thr", 100))

    if centers is not None and sizes is not None:
        box_c = centers[qidx]
        box_s = sizes[qidx]
        boxes = torch.cat([box_c, box_s], dim=-1)
        if filter_outofbox:
            loose = box_s * (1 + 1.5)
            lo = box_c - loose / 2
            hi = box_c + loose / 2
            inside = ((points_xyz[None] >= lo[:, None])
                      & (points_xyz[None] <= hi[:, None])).all(-1)
            pt_mask = pt_mask & inside
    else:
        boxes = cls_preds.new_zeros(k, 6)

    scores = torch.where(inst_valid, scores, 0.0)
    return InstancePred(point_masks=pt_mask, labels=labels, scores=scores,
                        valid=inst_valid, boxes=boxes)


def predict_semantic(sem_preds: torch.Tensor, sp_ids: torch.Tensor,
                     classes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-superpoint argmax broadcast to points; ``classes=None`` excludes
    the trailing no-object column."""
    cols = sem_preds[:, :-1] if classes is None else sem_preds[:, classes]
    sp_arg = cols.argmax(dim=-1)
    return sp_arg[sp_ids.long().clamp(0, sem_preds.shape[0] - 1)]


def predict_panoptic(sem_preds: torch.Tensor, inst: InstancePred,
                     sp_ids: torch.Tensor, n_stuff_classes: int,
                     npoint_thr: int):
    """Merge stuff semantics with thing instances -> (sem map, inst map)."""
    stuff = torch.arange(n_stuff_classes, device=sem_preds.device)
    sem_map = predict_semantic(sem_preds, sp_ids, stuff)

    # ascending-score sort: the higher score wins the per-point max below
    order = torch.argsort(torch.where(inst.valid, inst.scores, float("inf")),
                          stable=True)
    masks = inst.point_masks[order] & inst.valid[order][:, None]
    labels = inst.labels[order]

    k = masks.shape[0]
    inst_idxs = (torch.arange(k, device=masks.device)
                 + n_stuff_classes)[:, None]
    insts = inst_idxs * masks
    things_inst = insts.amax(dim=0)
    winner = insts.argmax(dim=0)
    things_sem = labels[winner] + n_stuff_classes

    # drop tiny instances (> npoint_thr survives)
    slot = things_inst.clamp(0, k + n_stuff_classes)
    counts = torch.bincount(slot, minlength=k + n_stuff_classes + 1)
    keep = counts[slot] > npoint_thr
    things_inst = torch.where(keep | (things_inst == 0), things_inst, 0)

    things_sem = torch.where(things_inst == 0, 0, things_sem)
    sem_map = torch.where(things_inst != 0, 0, sem_map)
    return sem_map + things_sem, sem_map + things_inst
