"""Matrix NMS for multi-class masks with static shapes (plain PyTorch).

Counterpart of ``segdino3d_tpu/ops/nms.py:mask_matrix_nms``: decay
``score *= min_j (1 - iou_ij) / (1 - compensate_iou_i)`` over
higher-scored same-class masks j.  Sorts are stable, as ``jnp.argsort`` is,
so tied scores keep their input order.
"""
from __future__ import annotations

from typing import Optional

import torch


def mask_matrix_nms(masks: torch.Tensor, labels: torch.Tensor,
                    scores: torch.Tensor,
                    valid: Optional[torch.Tensor] = None,
                    kernel: str = "linear", sigma: float = 2.0):
    """masks (N, S) soft masks in [0, 1], labels (N,), scores (N,), valid
    (N,) bool.  Returns (new_scores, order): decayed scores in input order,
    and the order that sorts them descending (invalid entries last)."""
    n = masks.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=masks.device)
    scores = torch.where(valid, scores, float("-inf"))
    order0 = torch.argsort(-scores, stable=True)
    m = masks[order0].float()
    lab = labels[order0]
    sc = scores[order0]
    val = valid[order0]

    area = m.sum(-1)
    inter = m @ m.T
    union = area[:, None] + area[None, :] - inter
    iou = inter / union.clamp(min=1e-12)

    triu = torch.ones(n, n, dtype=torch.bool, device=masks.device).triu(1)
    pair = triu & (lab[:, None] == lab[None, :]) & val[:, None] & val[None, :]
    decay_iou = torch.where(pair, iou, 0.0)
    comp = decay_iou.amax(dim=0)[:, None]       # compensate per column
    if kernel == "gaussian":
        decay = torch.exp(-sigma * decay_iou ** 2) / torch.exp(
            -sigma * comp ** 2)
    elif kernel == "linear":
        decay = (1 - decay_iou) / (1 - comp).clamp(min=1e-12)
    else:
        raise NotImplementedError(kernel)
    coeff = torch.where(pair, decay, float("inf")).amin(dim=0)
    # the top-scored row always contributes (1-0)/(1-0) = 1
    coeff = torch.where(torch.isfinite(coeff), coeff, 1.0).clamp(max=1.0)
    new_sc = torch.where(val, sc * coeff, float("-inf"))

    new_scores = torch.full_like(new_sc, float("-inf"))
    new_scores[order0] = new_sc
    return new_scores, torch.argsort(-new_scores, stable=True)
