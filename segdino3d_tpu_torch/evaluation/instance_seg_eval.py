"""ScanNet instance-segmentation AP protocol (pure numpy, host side).

A copy of ``segdino3d_tpu/evaluation/instance_seg_eval.py``.

From-scratch implementation of the public ScanNet benchmark protocol as
used by the reference evaluator
(the reference repository's
``evaluation/utils_instance_seg_3d_eval.py:18-565``):

* GT encoding: per-point id ``1000 * semantic_id + instance_index`` for
  valid classes; anything else (including -1) is *void*;
* greedy gt->pred matching per (scene, class, overlap threshold) with the
  duplicate-match rule: a second prediction overlapping an already-matched
  GT above threshold contributes a false positive carrying the lower of the
  two confidences;
* unmatched predictions are false positives unless the ignored fraction
  (void intersection + small/"group" GT intersections) exceeds the overlap
  threshold;
* PR curve over unique confidence thresholds, first point artificial
  (p=1, r=0), integrated with the [-0.5, 0, 0.5] convolution step rule;
* averages over overlaps {0.5..0.95 step .05} for AP, plus AP50/AP25,
  best-F1 precision/recall at 0.5, and ScanNet200 head/common/tail splits.

Instance masks arrive as (n_pred, n_points) booleans (the reference's
fixed-format variant) — intersections are computed vectorized with bincount
instead of per-pred python loops.
"""
from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np

from segdino3d_tpu_torch.data.scannet_constants import (
    COMMON_CATS_SCANNET_200, HEAD_CATS_SCANNET_200, TAIL_CATS_SCANNET_200)

DEFAULT_OVERLAPS = np.append(np.arange(0.5, 0.95, 0.05), 0.25)
MIN_REGION_SIZE = 100


def encode_gt_ids(semantic: np.ndarray, instance: np.ndarray,
                  valid_class_ids: Sequence[int]) -> np.ndarray:
    """Per-point gt id = 1000*sem + inst for valid-class points
    (reference ``rename_gt`` :469-494)."""
    out = instance.astype(np.int64).copy()
    valid = np.asarray(valid_class_ids)
    for i in np.unique(instance):
        m = instance == i
        sems, counts = np.unique(semantic[m], return_counts=True)
        if len(sems) > 1:
            # real annotations occasionally label one instance with several
            # semantic classes (the reference asserts here, :491, which
            # would abort a full-val eval); take the majority class —
            # identical behavior on clean data
            warnings.warn(
                f"gt instance {int(i)} spans semantic classes "
                f"{sems.tolist()}; using the majority class")
        sem = int(sems[np.argmax(counts)])
        if sem in valid:
            out[m] = 1000 * sem + int(i)
    return out


class _GtInst:
    __slots__ = ("inst_id", "vert_count", "matched_preds")

    def __init__(self, inst_id, vert_count):
        self.inst_id = inst_id
        self.vert_count = vert_count
        self.matched_preds = []   # list of (pred_index, intersection)


class _Pred:
    __slots__ = ("uid", "conf", "vert_count", "void_inter", "matched_gts")

    def __init__(self, uid, conf, vert_count, void_inter):
        self.uid = uid
        self.conf = conf
        self.vert_count = vert_count
        self.void_inter = void_inter
        self.matched_gts = []     # list of (_GtInst, intersection, is_counted)


def _collect_scene(pred_masks, pred_labels, pred_scores, gt_ids,
                   valid_class_ids, num_classes, uid_base):
    """Build per-class gt/pred association structures for one scene."""
    valid = np.asarray(valid_class_ids)
    gt_sem = gt_ids // 1000
    is_valid_gt = np.isin(gt_sem, valid)
    void_mask = ~is_valid_gt

    # class-index lookup for gt ids
    cls_of_raw = {int(r): c for c, r in enumerate(valid)}

    per_class_gt: List[Dict[int, _GtInst]] = [dict() for _ in range(num_classes)]
    uniq, counts = np.unique(gt_ids[is_valid_gt], return_counts=True)
    for gid, cnt in zip(uniq.tolist(), counts.tolist()):
        c = cls_of_raw[gid // 1000]
        per_class_gt[c][gid] = _GtInst(gid, cnt)

    per_class_pred: List[List[_Pred]] = [[] for _ in range(num_classes)]
    n_pred = len(pred_labels)
    for pi in range(n_pred):
        c = int(pred_labels[pi])
        if not (0 <= c < num_classes):
            continue
        mask = pred_masks[pi]
        cnt = int(mask.sum())
        if cnt < MIN_REGION_SIZE:
            continue
        void_inter = int((mask & void_mask).sum())
        pred = _Pred(uid_base + pi, float(pred_scores[pi]), cnt, void_inter)
        ids_in_mask = gt_ids[mask]
        u, icnt = np.unique(ids_in_mask, return_counts=True)
        for gid, inter in zip(u.tolist(), icnt.tolist()):
            gobj = per_class_gt[c].get(gid)
            if gobj is not None:
                gobj.matched_preds.append((pred, inter))
                pred.matched_gts.append((gobj, inter))
        per_class_pred[c].append(pred)
    return per_class_gt, per_class_pred


def evaluate_matches(scenes, num_classes, overlaps):
    """scenes: list of (per_class_gt, per_class_pred)."""
    ap = np.zeros((num_classes, len(overlaps)))
    pr_rc = np.zeros((2, num_classes, len(overlaps)))
    for oi, tau in enumerate(overlaps):
        for c in range(num_classes):
            y_true, y_score = [], []
            hard_fn = 0
            has_gt = has_pred = False
            pred_used: Dict[int, bool] = {}
            for per_class_gt, per_class_pred in scenes:
                for p in per_class_pred[c]:
                    pred_used[p.uid] = False
            for per_class_gt, per_class_pred in scenes:
                gts = list(per_class_gt[c].values())
                gts = [g for g in gts if g.vert_count >= MIN_REGION_SIZE]
                if gts:
                    has_gt = True
                if per_class_pred[c]:
                    has_pred = True
                for g in gts:
                    found = False
                    matched_score = None
                    for p, inter in g.matched_preds:
                        if pred_used[p.uid]:
                            continue
                        overlap = inter / (g.vert_count + p.vert_count - inter)
                        if overlap > tau:
                            if matched_score is not None:
                                # duplicate match: lower score becomes FP
                                hi = max(matched_score, p.conf)
                                lo = min(matched_score, p.conf)
                                matched_score = hi
                                y_true.append(0)
                                y_score.append(lo)
                            else:
                                found = True
                                matched_score = p.conf
                                pred_used[p.uid] = True
                    if matched_score is not None:
                        y_true.append(1)
                        y_score.append(matched_score)
                    if not found:
                        hard_fn += 1
                for p in per_class_pred[c]:
                    found_gt = False
                    for g, inter in p.matched_gts:
                        overlap = inter / (g.vert_count + p.vert_count - inter)
                        if overlap > tau:
                            found_gt = True
                            break
                    if found_gt:
                        continue
                    num_ignore = p.void_inter
                    for g, inter in p.matched_gts:
                        if g.inst_id < 1000:      # "group" annotation
                            num_ignore += inter
                        if g.vert_count < MIN_REGION_SIZE:
                            num_ignore += inter
                    if num_ignore / p.vert_count <= tau:
                        y_true.append(0)
                        y_score.append(p.conf)

            if has_gt and has_pred:
                ap[c, oi], pr_rc[0, c, oi], pr_rc[1, c, oi] = _pr_curve(
                    np.asarray(y_true, float), np.asarray(y_score, float),
                    hard_fn)
            elif has_gt:
                ap[c, oi] = 0.0
            else:
                ap[c, oi] = np.nan
                pr_rc[:, c, oi] = np.nan
    return ap, pr_rc


def _pr_curve(y_true, y_score, hard_fn):
    order = np.argsort(y_score)
    y_score = y_score[order]
    y_true = y_true[order]
    cumsum = np.cumsum(y_true)
    num_examples = len(y_score)
    num_true = cumsum[-1] if num_examples else 0

    thresholds, first_idx = np.unique(y_score, return_index=True)
    n_pr = len(first_idx) + 1
    precision = np.zeros(n_pr)
    recall = np.zeros(n_pr)
    cumsum_ext = np.append(cumsum, 0)
    for out_i, idx in enumerate(first_idx):
        below = cumsum_ext[idx - 1]      # TPs with score < threshold
        tp = num_true - below
        fp = num_examples - idx - tp
        fn = below + hard_fn
        precision[out_i] = tp / (tp + fp)
        recall[out_i] = tp / (tp + fn)
    precision[-1] = 1.0
    recall[-1] = 0.0

    f1 = 2 * precision * recall / (precision + recall + 1e-4)
    best = int(np.argmax(f1))

    r_ext = np.concatenate([[recall[0]], recall, [0.0]])
    steps = np.convolve(r_ext, [-0.5, 0, 0.5], "valid")
    return float(np.dot(precision, steps)), precision[best], recall[best]


def compute_averages(ap, pr_rc, overlaps, class_labels):
    o50 = np.isclose(overlaps, 0.5)
    o25 = np.isclose(overlaps, 0.25)
    oall = ~o25
    res = dict(
        all_ap=float(np.nanmean(ap[:, oall])),
        all_ap_50=float(np.nanmean(ap[:, o50])),
        all_ap_25=float(np.nanmean(ap[:, o25])),
        all_prec_50=float(np.nanmean(pr_rc[0][:, o50])),
        all_rec_50=float(np.nanmean(pr_rc[1][:, o50])),
        classes={},
    )
    for i, name in enumerate(class_labels):
        res["classes"][name] = dict(
            ap=float(np.nanmean(ap[i, oall])),
            ap50=float(np.nanmean(ap[i, o50])),
            ap25=float(np.nanmean(ap[i, o25])),
            prec50=float(np.nanmean(pr_rc[0][i, o50])),
            rec50=float(np.nanmean(pr_rc[1][i, o50])),
        )
    for split_name, cats in (("head", HEAD_CATS_SCANNET_200),
                             ("common", COMMON_CATS_SCANNET_200),
                             ("tail", TAIL_CATS_SCANNET_200)):
        idx = [i for i, c in enumerate(class_labels) if c in cats]
        if idx:
            res[f"{split_name}_ap"] = float(np.nanmean(ap[np.ix_(idx, oall.nonzero()[0])]))
            res[f"{split_name}_ap_50"] = float(np.nanmean(ap[np.ix_(idx, o50.nonzero()[0])]))
            res[f"{split_name}_ap_25"] = float(np.nanmean(ap[np.ix_(idx, o25.nonzero()[0])]))
    return res


def instance_seg_eval(gt_semantic_masks: List[np.ndarray],
                      gt_instance_masks: List[np.ndarray],
                      pred_instance_masks: List[np.ndarray],
                      pred_instance_labels: List[np.ndarray],
                      pred_instance_scores: List[np.ndarray],
                      valid_class_ids: Sequence[int],
                      class_labels: Sequence[str],
                      overlaps: Optional[np.ndarray] = None,
                      print_summary: bool = True) -> Dict:
    """Top-level entry matching the reference signature (:497-565)."""
    assert len(valid_class_ids) == len(class_labels)
    overlaps = DEFAULT_OVERLAPS if overlaps is None else overlaps
    num_classes = len(class_labels)

    scenes = []
    uid_base = 0
    for si in range(len(gt_semantic_masks)):
        gt_ids = encode_gt_ids(gt_semantic_masks[si], gt_instance_masks[si],
                               valid_class_ids)
        masks = np.asarray(pred_instance_masks[si])
        labels = np.asarray(pred_instance_labels[si])
        scores = np.asarray(pred_instance_scores[si])
        scenes.append(_collect_scene(masks, labels, scores, gt_ids,
                                     valid_class_ids, num_classes, uid_base))
        uid_base += len(labels)

    ap, pr_rc = evaluate_matches(scenes, num_classes, overlaps)
    res = compute_averages(ap, pr_rc, overlaps, class_labels)

    if print_summary:
        rows = [f"{'class':<28s} {'AP25':>7s} {'AP50':>7s} {'AP':>7s}"]
        for name in class_labels:
            c = res["classes"][name]
            rows.append(f"{name:<28s} {c['ap25']:7.4f} {c['ap50']:7.4f} "
                        f"{c['ap']:7.4f}")
        rows.append(f"{'Overall':<28s} {res['all_ap_25']:7.4f} "
                    f"{res['all_ap_50']:7.4f} {res['all_ap']:7.4f}")
        print("\n".join(rows))
    return res
