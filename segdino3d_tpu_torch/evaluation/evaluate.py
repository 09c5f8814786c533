"""Eval driver: inference over a set of scenes, then the AP protocol.

Counterpart of ``segdino3d_tpu/evaluation/evaluate.py``: a no-grad
forward, post-processing on the model's device (top-k, matrix-NMS,
unpooling, thresholds; one instance run serves both the instance and the
panoptic thresholds; the instance masks bit-packed, ``ops.bitpack``), the
copy of the packed rows to the host, which unpacks the valid ones, GT
annotation assembly and the ScanNet AP protocol.

A forward on a plan built on the device reports whether the plan
outgrew its capacities (``BackboneOutput.overflow``); the driver reads
that flag at the result copy, which waits on the device anyway, and
raises, as a host plan does when it overflows.

With ``process_count`` > 1 each process evaluates its share of the
batches (``EvalLoader(process_index=..., process_count=...)``), writes
its results to ``gather_dir`` and reads every process's back, so every
process returns the metrics of the whole set.  The processes form a
``parallel.mesh`` group: process 0 removes the shards of an earlier eval
in ``gather_dir`` before any process writes its own (a barrier), and no
process returns before every one has read the shards (a second one), so
a shard left by another run or round never stands in for this one's.
(The JAX driver waits only for each shard file to exist.)
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

from segdino3d_tpu_torch.data.collate import eval_annotation
from segdino3d_tpu_torch.evaluation.evaluator import InstanceSeg3DEvaluator
from segdino3d_tpu_torch.gtypes import SceneBatch
from segdino3d_tpu_torch.models.architecture.postprocess import (
    InstancePred, predict_instance, predict_panoptic, predict_semantic)
from segdino3d_tpu_torch.models.backbone.wrapper import DEVICE_PLAN_OVERFLOW
from segdino3d_tpu_torch.ops.bitpack import pack_bits, unpack_bits_np
from segdino3d_tpu_torch.parallel import mesh


def postprocess(out, batch: SceneBatch, test_cfg: Dict,
                filter_outofbox: bool = True, n_stuff: int = 2) -> List[Tuple]:
    """Per scene (inst, sem, pan_sem, pan_map) from the model's outputs;
    ``inst.point_masks`` bit-packed, (top-k, ceil(P / 8)) uint8."""
    thr_i = test_cfg.get("inst_score_thr", 0.0)
    thr_p = test_cfg.get("pan_score_thr", 0.5)

    def at_threshold(base: InstancePred, thr: float) -> InstancePred:
        valid = base.valid & (base.scores > thr)
        return base._replace(valid=valid,
                             scores=torch.where(valid, base.scores, 0.0))

    def scene(key, b):
        # centers and sizes are None without positional embeddings, the
        # objectness scores without objectness_flag
        v = out.get(key)
        return None if v is None else v[b]

    results = []
    for b in range(batch.batch_size):
        base = predict_instance(
            out["cls_preds"][b], out["masks"][b], out["query_valid"][b],
            out["sp_valid"][b], batch.superpoint_ids[b], batch.point_valid[b],
            batch.points[b, :, :3], min(thr_i, thr_p), test_cfg,
            centers=scene("centers", b), sizes=scene("sizes", b),
            scores_q=scene("scores", b), filter_outofbox=filter_outofbox)
        sem = predict_semantic(out["sem_preds"][b], batch.superpoint_ids[b])
        pan_sem, pan_map = predict_panoptic(
            out["sem_preds"][b], at_threshold(base, thr_p),
            batch.superpoint_ids[b], n_stuff, test_cfg.get("npoint_thr", 100))
        inst = at_threshold(base, thr_i)
        results.append((inst._replace(point_masks=pack_bits(
            inst.point_masks)), sem, pan_sem, pan_map))
    return results


def make_predict_fn(model, test_cfg: Dict, filter_outofbox: bool = True,
                    n_stuff: int = 2
                    ) -> Callable[[SceneBatch], Tuple[List[Tuple],
                                                      torch.Tensor]]:
    """predict(batch) -> (per scene (inst, sem, pan_sem, pan_map), the
    plan's overflow flag, a 0-d bool tensor)."""

    @torch.no_grad()
    def predict(batch: SceneBatch):
        out = model(batch)
        return (postprocess(out, batch, test_cfg, filter_outofbox, n_stuff),
                out["plan_overflow"])

    return predict


def host_prediction(record: Dict, inst: InstancePred, sem, pan_sem,
                    pan_map, plan_overflow: Optional[torch.Tensor] = None
                    ) -> Dict:
    """One scene's prediction as the evaluator's numpy dict: the packed
    masks copied whole, the valid rows unpacked.  Raises where
    ``plan_overflow`` is set: it is read after the first copy, when the
    device is done."""
    # the eval cache's records are slim: the point count, no points
    n_pts = (record["points"].shape[0] if "points" in record
             else int(record["n_points"]))
    valid = inst.valid.cpu().numpy()
    if plan_overflow is not None and bool(plan_overflow):
        raise ValueError(DEVICE_PLAN_OVERFLOW)
    return dict(
        pts_instance_masks=unpack_bits_np(
            inst.point_masks.cpu().numpy()[valid], n_pts),
        instance_labels=inst.labels.cpu().numpy()[valid],
        instance_scores=inst.scores.cpu().numpy()[valid],
        pts_semantic_mask=sem.cpu().numpy()[:n_pts],
        pts_panoptic_sem=pan_sem.cpu().numpy()[:n_pts],
        pts_panoptic_inst=pan_map.cpu().numpy()[:n_pts])


def evaluate(model, eval_loader: Iterable, evaluator: InstanceSeg3DEvaluator,
             test_cfg: Dict, filter_outofbox: bool = True,
             bg_class_id: int = 200, gather_dir: Optional[str] = None,
             process_index: int = 0, process_count: int = 1) -> Dict:
    """``eval_loader`` (a ``data.loader.EvalLoader``, or any iterable of
    (records, batch) pairs with the batch on the model's device, or a list
    of per-shard batches whose scenes follow one another, the padding
    last); returns the metric dict of ``evaluator``, of every process's
    scenes where ``process_count`` > 1 (through ``gather_dir``, a path
    every process can read)."""
    if process_count > 1:
        if gather_dir is None:
            raise ValueError("multi-process eval needs gather_dir")
        if mesh.process_count() != process_count:
            raise ValueError(
                f"multi-process eval of {process_count} processes needs a "
                f"process group of that size (parallel.mesh."
                f"init_distributed), not {mesh.process_count()}")
        if process_index == 0:
            evaluator.clear_shards(gather_dir)
        mesh.barrier()
    predict = make_predict_fn(model, test_cfg, filter_outofbox)
    evaluator.reset()
    for records, batch in eval_loader:
        shards = batch if isinstance(batch, list) else [batch]
        scenes = []
        for shard in shards:
            results, overflow = predict(shard)
            scenes += [(r, overflow) for r in results]
        # the padded tail's scenes have no record: zip drops them
        for record, (result, overflow) in zip(records, scenes):
            evaluator.process(eval_annotation(record, bg_class_id),
                              host_prediction(record, *result,
                                              plan_overflow=overflow))
    if process_count > 1:
        evaluator.save_shard(gather_dir, process_index)
        evaluator.load_shards(gather_dir, process_count)
        mesh.barrier()
    return evaluator.evaluate()
