"""Eval driver: inference over a set of scenes, then the AP protocol.

Counterpart of ``segdino3d_tpu/evaluation/evaluate.py``: a no-grad
forward, post-processing on the model's device (top-k, matrix-NMS,
unpooling, thresholds; one instance run serves both the instance and the
panoptic thresholds), GT annotation assembly and the ScanNet AP protocol.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Tuple

import torch

from segdino3d_tpu_torch.data.collate import eval_annotation
from segdino3d_tpu_torch.evaluation.evaluator import InstanceSeg3DEvaluator
from segdino3d_tpu_torch.gtypes import SceneBatch
from segdino3d_tpu_torch.models.architecture.postprocess import (
    InstancePred, predict_instance, predict_panoptic, predict_semantic)


def postprocess(out, batch: SceneBatch, test_cfg: Dict,
                filter_outofbox: bool = True, n_stuff: int = 2) -> List[Tuple]:
    """Per scene (inst, sem, pan_sem, pan_map) from the model's outputs."""
    thr_i = test_cfg.get("inst_score_thr", 0.0)
    thr_p = test_cfg.get("pan_score_thr", 0.5)

    def at_threshold(base: InstancePred, thr: float) -> InstancePred:
        valid = base.valid & (base.scores > thr)
        return base._replace(valid=valid,
                             scores=torch.where(valid, base.scores, 0.0))

    results = []
    for b in range(batch.batch_size):
        base = predict_instance(
            out["cls_preds"][b], out["masks"][b], out["query_valid"][b],
            out["sp_valid"][b], batch.superpoint_ids[b], batch.point_valid[b],
            batch.points[b, :, :3], min(thr_i, thr_p), test_cfg,
            centers=out["centers"][b], sizes=out["sizes"][b],
            filter_outofbox=filter_outofbox)
        sem = predict_semantic(out["sem_preds"][b], batch.superpoint_ids[b])
        pan_sem, pan_map = predict_panoptic(
            out["sem_preds"][b], at_threshold(base, thr_p),
            batch.superpoint_ids[b], n_stuff, test_cfg.get("npoint_thr", 100))
        results.append((at_threshold(base, thr_i), sem, pan_sem, pan_map))
    return results


def make_predict_fn(model, test_cfg: Dict, filter_outofbox: bool = True,
                    n_stuff: int = 2) -> Callable[[SceneBatch], List[Tuple]]:
    """predict(batch) -> per scene (inst, sem, pan_sem, pan_map)."""

    @torch.no_grad()
    def predict(batch: SceneBatch):
        return postprocess(model(batch), batch, test_cfg, filter_outofbox,
                           n_stuff)

    return predict


def host_prediction(record: Dict, inst: InstancePred, sem, pan_sem,
                    pan_map) -> Dict:
    """One scene's prediction as the evaluator's numpy dict."""
    n_pts = record["points"].shape[0]
    valid = inst.valid.cpu().numpy()
    return dict(
        pts_instance_masks=inst.point_masks.cpu().numpy()[valid, :n_pts],
        instance_labels=inst.labels.cpu().numpy()[valid],
        instance_scores=inst.scores.cpu().numpy()[valid],
        pts_semantic_mask=sem.cpu().numpy()[:n_pts],
        pts_panoptic_sem=pan_sem.cpu().numpy()[:n_pts],
        pts_panoptic_inst=pan_map.cpu().numpy()[:n_pts])


def evaluate(model, eval_loader: Iterable, evaluator: InstanceSeg3DEvaluator,
             test_cfg: Dict, filter_outofbox: bool = True,
             bg_class_id: int = 200) -> Dict:
    """``eval_loader`` yields (records, batch) pairs; returns the metric
    dict of ``evaluator``."""
    predict = make_predict_fn(model, test_cfg, filter_outofbox)
    evaluator.reset()
    for records, batch in eval_loader:
        for record, result in zip(records, predict(batch)):
            evaluator.process(eval_annotation(record, bg_class_id),
                              host_prediction(record, *result))
    return evaluator.evaluate()
