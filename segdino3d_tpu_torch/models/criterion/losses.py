"""Training criterion: matching + semantic/instance losses (padded batch).

Counterpart of ``segdino3d_tpu/models/criterion/losses.py`` over padded
(B, Q, S/G) tensors, with the same normalisation arithmetic, including the
reference's asymmetries:

* the main layer's dice loss is summed over scenes then (with
  ``fix_dice_loss_weight``) multiplied by 4/B, while an aux layer's dice is
  divided by B first;
* weighted class CE with torch semantics: sum(w_t * ce) / sum(w_t), the
  no-object weight on unmatched queries;
* mask BCE is the mean over (n_matched x n_superpoints) elements, summed
  over scenes, / B;
* center/size L1: sum over xyz, mean over matched, mean over scenes;
* per-layer re-matching when ``iter_matcher``;
* with objectness scores (``loss_weight[3]``): the squared error of each
  matched query's score against its mask's IoU, over the pairs with IoU
  above 0.5, summed over the scenes that have one and divided by B.

Matching reads the predictions without a gradient.  ``SparseMatcher``
keeps, per GT instance, the queries inside it whose cost is strictly below
the (k+1)-th smallest; a stable ascending sort stands in for
``lax.top_k`` (equal costs keep the lower query index first, as there).
``HungarianMatcher`` runs scipy's solver on the host, like the JAX
package's host callback.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

INF_COST = 1e8


# ---------------------------------------------------------------------------
# elementary losses
# ---------------------------------------------------------------------------

def sigmoid_bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise BCE-with-logits (no reduction), the stable form."""
    return (logits.clamp(min=0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def _sp_weight(sp_valid: torch.Tensor, dtype) -> torch.Tensor:
    return sp_valid.to(dtype)[:, None, :]                 # (B, 1, S)


def pairwise_mask_bce_cost(mask_logits, gt_masks, sp_valid):
    """(B, Q, S) logits x (B, G, S) {0, 1} -> (B, Q, G), mean over each
    scene's valid superpoints."""
    sp_w = _sp_weight(sp_valid, mask_logits.dtype)
    pos = sigmoid_bce(mask_logits, torch.ones_like(mask_logits)) * sp_w
    neg = sigmoid_bce(mask_logits, torch.zeros_like(mask_logits)) * sp_w
    gt = gt_masks.to(mask_logits.dtype) * sp_w
    cost = pos @ gt.transpose(1, 2) + neg @ (sp_w - gt).transpose(1, 2)
    return cost / sp_w.sum(-1, keepdim=True).clamp(min=1.0)


def pairwise_dice_cost(mask_logits, gt_masks, sp_valid):
    sp_w = _sp_weight(sp_valid, mask_logits.dtype)
    probs = torch.sigmoid(mask_logits) * sp_w
    gt = gt_masks.to(mask_logits.dtype) * sp_w
    num = 2 * probs @ gt.transpose(1, 2)
    den = probs.sum(-1)[:, :, None] + gt.sum(-1)[:, None, :]
    return 1 - (num + 1) / (den + 1)


def get_iou_pairs(pred_logits, gt, sp_valid):
    """Per-pair IoU of the binarised predictions over the valid
    superpoints: (B, P, S), (B, P, S), (B, S) -> (B, P)."""
    sp_w = sp_valid.to(pred_logits.dtype)[:, None, :]
    binp = (torch.sigmoid(pred_logits) >= 0.5).to(pred_logits.dtype) * sp_w
    gtw = (gt > 0.5).to(pred_logits.dtype) * sp_w
    inter = (binp * gtw).sum(-1)
    union = binp.sum(-1) + gtw.sum(-1) - inter
    return inter / (union + 1e-6)


def dice_loss_pairs(pred_logits, gt, pair_valid, sp_valid):
    """Per-pair dice over the last axis (superpoints), mean over the valid
    pairs of each scene: (B, P, S), (B, P, S), (B, P), (B, S) -> (B,)."""
    sp_w = sp_valid.to(pred_logits.dtype)[:, None, :]
    probs = torch.sigmoid(pred_logits) * sp_w
    gtw = gt.to(pred_logits.dtype) * sp_w
    num = 2 * (probs * gtw).sum(-1)
    den = probs.sum(-1) + gtw.sum(-1)
    d = 1 - (num + 1) / (den + 1)
    w = pair_valid.to(d.dtype)
    return (d * w).sum(-1) / w.sum(-1).clamp(min=1.0)


# ---------------------------------------------------------------------------
# matchers
# ---------------------------------------------------------------------------

class MatchResult(NamedTuple):
    """Per-GT matched queries: (B, G, k) indices + validity."""
    pair_q: torch.Tensor      # (B, G, k) int32 query index per gt slot
    pair_valid: torch.Tensor  # (B, G, k) bool


def assemble_cost(costs_cfg, cls_preds, mask_logits, centers, sizes, labels,
                  gt_sp_masks, gt_centers, gt_sizes, sp_valid):
    """Weighted sum of the configured cost terms -> (B, Q, G)."""
    b, q = cls_preds.shape[:2]
    g = labels.shape[1]
    total = cls_preds.new_zeros(b, q, g)
    for cost in costs_cfg:
        t, w = cost["type"], cost["weight"]
        if t == "QueryClassificationCost":
            scores = torch.softmax(cls_preds, dim=-1)
            total = total + w * -torch.gather(
                scores, 2, labels.long()[:, None, :].expand(b, q, g))
        elif t == "MaskBCECost":
            total = total + w * pairwise_mask_bce_cost(mask_logits,
                                                       gt_sp_masks, sp_valid)
        elif t == "MaskDiceCost":
            total = total + w * pairwise_dice_cost(mask_logits, gt_sp_masks,
                                                   sp_valid)
        elif t == "CenterL1Cost":
            if centers is not None:
                total = total + w * (centers[:, :, None, :]
                                     - gt_centers[:, None, :, :]).abs().sum(-1)
        elif t == "SizeL1Cost":
            if sizes is not None:
                total = total + w * (sizes[:, :, None, :]
                                     - gt_sizes[:, None, :, :]).abs().sum(-1)
        else:
            raise ValueError(f"unknown cost {t}")
    return total


class SparseMatcher:
    def __init__(self, costs, topk=1):
        self.costs = [dict(c) for c in costs]
        self.topk = topk

    def __call__(self, cost, query_masks, query_valid, gt_valid
                 ) -> MatchResult:
        """cost (B, Q, G); query_masks (B, G, Q) bool 'query inside
        instance'; query_valid (B, Q); gt_valid (B, G)."""
        masked = torch.where(query_masks.transpose(1, 2), cost, INF_COST)
        masked = torch.where(query_valid[:, :, None], masked, INF_COST)
        masked = torch.where(gt_valid[:, None, :], masked, INF_COST)
        k = self.topk
        # smallest k + 1 per gt column, equal costs lower index first
        vals, idx = torch.sort(masked.transpose(1, 2), dim=-1, stable=True)
        thresh = vals[..., k:k + 1]
        pair_valid = (vals[..., :k] < thresh) & gt_valid[..., None]
        return MatchResult(pair_q=idx[..., :k].to(torch.int32),
                           pair_valid=pair_valid)


def _hungarian_host(cost: np.ndarray, n_q: int, n_g: int):
    from scipy.optimize import linear_sum_assignment

    g_cap = cost.shape[1]
    rows, cols = linear_sum_assignment(cost[:n_q, :n_g])
    pair_q = np.zeros((g_cap,), np.int32)
    pair_valid = np.zeros((g_cap,), bool)
    pair_q[cols] = rows.astype(np.int32)
    pair_valid[cols] = True
    return pair_q, pair_valid


class HungarianMatcher:
    """Hungarian assignment with scipy on the host (the valid queries and
    instances are assumed to be a prefix, as the collate pads at the
    end)."""

    def __init__(self, costs):
        self.costs = [dict(c) for c in costs]
        self.topk = 1

    def __call__(self, cost, query_masks, query_valid, gt_valid
                 ) -> MatchResult:
        cost_np = cost.detach().cpu().numpy()
        n_q = query_valid.sum(-1).cpu().numpy()
        n_g = gt_valid.sum(-1).cpu().numpy()
        out = [_hungarian_host(c, int(nq), int(ng))
               for c, nq, ng in zip(cost_np, n_q, n_g)]
        pair_q = torch.from_numpy(np.stack([o[0] for o in out]))
        pair_valid = torch.from_numpy(np.stack([o[1] for o in out]))
        return MatchResult(pair_q=pair_q[..., None].to(cost.device),
                           pair_valid=pair_valid[..., None].to(cost.device))


MATCHERS = {"SparseMatcher": SparseMatcher,
            "HungarianMatcher": HungarianMatcher}


# ---------------------------------------------------------------------------
# criteria
# ---------------------------------------------------------------------------

class ScanNetSemanticCriterion:
    """Semantic CE over the queries' semantic targets."""

    def __init__(self, ignore_index, loss_weight):
        self.ignore_index = ignore_index
        self.loss_weight = loss_weight

    def __call__(self, sem_preds, sem_targets, query_valid):
        """sem_preds (B, Q, C+1); sem_targets (B, Q) int (argmax of the
        semantic one-hot rows); query_valid (B, Q)."""
        if self.ignore_index >= 0:
            sem_preds = sem_preds[..., :-1]
        logp = F.log_softmax(sem_preds, dim=-1)
        tgt = sem_targets.long().clamp(0, sem_preds.shape[-1] - 1)
        ce = -torch.gather(logp, 2, tgt[..., None])[..., 0]
        w = (query_valid & (sem_targets != self.ignore_index)).to(ce.dtype)
        per_scene = (ce * w).sum(-1) / w.sum(-1).clamp(min=1.0)
        return self.loss_weight * per_scene.mean()


class InstanceCriterion:
    """Instance losses with per-layer matching."""

    def __init__(self, matcher, loss_weight, non_object_weight, num_classes,
                 fix_dice_loss_weight, iter_matcher, fix_mean_loss=False):
        m = dict(matcher)
        self.matcher = MATCHERS[m.pop("type")](**m)
        self.loss_weight = list(loss_weight)
        self.non_object_weight = non_object_weight
        self.num_classes = num_classes
        self.fix_dice_loss_weight = fix_dice_loss_weight
        self.iter_matcher = iter_matcher
        # fix_mean_loss is a no-op when every scene contributes (the
        # reference comments its skip branch out)
        del fix_mean_loss

    @torch.no_grad()
    def match(self, layer: Dict[str, Any], gt: Dict[str, torch.Tensor]
              ) -> MatchResult:
        cost = assemble_cost(
            self.matcher.costs, layer["cls_preds"], layer["masks"],
            layer.get("centers"), layer.get("sizes"),
            gt["labels"].clamp(min=0), gt["sp_masks"], gt["centers"],
            gt["sizes"], gt["sp_valid"])
        return self.matcher(cost, gt["query_masks"], gt["query_valid"],
                            gt["gt_valid"])

    def layer_loss(self, layer, gt, match: MatchResult, aux: bool):
        cls_preds = layer["cls_preds"]      # (B, Q, C+1)
        masks = layer["masks"]              # (B, Q, S)
        centers = layer.get("centers")      # (B, Q, 3) | None
        sizes = layer.get("sizes")
        b, q = cls_preds.shape[:2]
        g, k = match.pair_q.shape[1:]
        s = masks.shape[-1]
        labels = gt["labels"].long()
        qv, spv = gt["query_valid"], gt["sp_valid"]
        pv = match.pair_valid

        # classification: a query matched to several instances takes the
        # largest instance index (the reference's last write wins)
        flatg = torch.arange(g, device=cls_preds.device)[None, :, None] \
            .expand(b, g, k)
        safe_q = torch.where(pv, match.pair_q.long(), q).reshape(b, -1)
        best_g = torch.full((b, q + 1), -1, dtype=torch.long,
                            device=cls_preds.device).scatter_reduce(
            1, safe_q, torch.where(pv, flatg, -1).reshape(b, -1), "amax")[:, :q]
        tgt = torch.where(best_g >= 0,
                          torch.gather(labels, 1, best_g.clamp(min=0)),
                          self.num_classes)
        logp = F.log_softmax(cls_preds, dim=-1)
        ce = -torch.gather(logp, 2, tgt[..., None])[..., 0]
        wvec = torch.where(tgt == self.num_classes, self.non_object_weight,
                           1.0) * qv.to(ce.dtype)
        cls_loss = ((ce * wvec).sum(-1) / wvec.sum(-1).clamp(min=1e-12)).mean()

        # mask losses over matched pairs
        pq = match.pair_q.long().clamp(0, q - 1).reshape(b, g * k)
        pred_pair = torch.gather(masks, 1, pq[..., None].expand(-1, -1, s))
        gt_pair = gt["sp_masks"][:, :, None, :].expand(b, g, k, s) \
            .reshape(b, g * k, s).to(masks.dtype)
        sp_w = spv.to(masks.dtype)
        pair_w = pv.reshape(b, g * k).to(masks.dtype)
        elem_bce = sigmoid_bce(pred_pair, gt_pair) * sp_w[:, None, :]
        per_scene_bce = (elem_bce * pair_w[..., None]).sum((1, 2)) / \
            (pair_w.sum(1) * sp_w.sum(-1)).clamp(min=1.0)
        mask_bce_loss = per_scene_bce.sum() / b

        per_scene_dice = dice_loss_pairs(pred_pair, gt_pair, pair_w > 0, spv)
        mask_dice_loss = per_scene_dice.sum() / b if aux \
            else per_scene_dice.sum()
        if self.fix_dice_loss_weight:
            mask_dice_loss = mask_dice_loss / b * 4

        def pair_l1(pred, gt_attr):
            pp = torch.gather(pred, 1, pq[..., None].expand(-1, -1, 3))
            gg = gt_attr[:, :, None, :].expand(b, g, k, 3).reshape(b, g * k, 3)
            l1 = (pp - gg).abs().sum(-1)
            return ((l1 * pair_w).sum(1) / pair_w.sum(1).clamp(min=1.0)).mean()

        lw = self.loss_weight
        loss = lw[0] * cls_loss + lw[1] * mask_bce_loss + lw[2] * mask_dice_loss
        scores = layer.get("scores")        # (B, Q, 1) | None
        if scores is not None:
            # objectness: MSE of the matched queries' scores against their
            # masks' IoU, over the pairs with IoU > 0.5; a scene without
            # such a pair adds nothing, the sum over scenes is divided by B
            sc_pair = torch.gather(scores[..., 0], 1, pq)
            iou = get_iou_pairs(pred_pair, gt_pair, spv)
            w = (pair_w.bool() & (iou > 0.5)).to(iou.dtype)
            per_scene = ((sc_pair - iou).square() * w).sum(1) / \
                w.sum(1).clamp(min=1.0)
            has = (w.sum(1) > 0).to(per_scene.dtype)
            loss = loss + lw[3] * (per_scene * has).sum() / b
        if len(lw) >= 5 and centers is not None:
            loss = loss + lw[4] * pair_l1(centers, gt["centers"])
        if len(lw) >= 6 and sizes is not None:
            loss = loss + lw[5] * pair_l1(sizes, gt["sizes"])
        return loss

    def __call__(self, pred: Dict[str, Any], gt: Dict[str, torch.Tensor]):
        """pred: the decoder's output dict; gt: the training forward's
        targets (labels, sp_masks, query_masks, centers, sizes,
        query_valid, gt_valid, sp_valid)."""
        match = self.match(pred, gt)
        loss = self.layer_loss(pred, gt, match, aux=False)
        for layer in pred.get("aux_outputs", []):
            m = self.match(layer, gt) if self.iter_matcher else match
            loss = loss + self.layer_loss(layer, gt, m, aux=True)
        return loss


class ScanNetUnifiedCriterion:
    """Semantic + instance criterion: {"seg_loss", "inst_loss"}."""

    def __init__(self, num_semantic_classes, sem_criterion, inst_criterion):
        self.num_semantic_classes = num_semantic_classes
        sc = dict(sem_criterion)
        sc.pop("type", None)
        self.sem_criterion = ScanNetSemanticCriterion(**sc)
        ic = dict(inst_criterion)
        ic.pop("type", None)
        self.inst_criterion = InstanceCriterion(**ic)

    def __call__(self, pred, gt) -> Dict[str, torch.Tensor]:
        seg_loss = self.sem_criterion(
            pred["sem_preds"], gt["query_sem_targets"], gt["query_valid"])
        inst_loss = self.inst_criterion(pred, gt)
        return {"seg_loss": seg_loss, "inst_loss": inst_loss}
