"""Instance-seg evaluator: accumulates per-scene predictions, computes mAP.

A copy of ``segdino3d_tpu/evaluation/evaluator.py:InstanceSeg3DEvaluator``
without the registry, the multi-host result gather and the benchmark
submission writers: it converts panoptic-style GT markup back to
instance-task ids and feeds the ScanNet AP protocol with
``valid_class_ids`` minus the stuff classes.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from segdino3d_tpu_torch.evaluation.instance_seg_eval import instance_seg_eval


def map_inst_markup(sem: np.ndarray, inst: np.ndarray,
                    valid_thing_ids: Sequence[int], num_stuff: int):
    """Undo the stuff-merged panoptic encoding."""
    inst = inst.astype(np.int64) - num_stuff
    inst[inst < 0] = -1
    sem = sem.astype(np.int64) - num_stuff
    sem[inst == -1] = -1
    mapping = np.asarray(list(valid_thing_ids) + [-1], np.int64)
    sem = mapping[sem]
    return sem, inst


class InstanceSeg3DEvaluator:
    """Accumulate (eval_ann, prediction) pairs; compute ScanNet AP."""

    def __init__(self, valid_class_ids: Sequence[int],
                 class_names: Sequence[str],
                 stuff_class_inds: Sequence[int] = (0, 1)):
        self.valid_class_ids = list(valid_class_ids)
        self.class_names = list(class_names)
        self.num_stuff = len(stuff_class_inds)
        self.reset()

    def reset(self):
        self._results: List = []

    def process(self, eval_ann: Dict, pred: Dict):
        """pred: dict with pts_instance_masks (N, P) bool, labels (N,),
        scores (N,), and optional semantic/panoptic point maps."""
        self._results.append((eval_ann, pred))

    def evaluate(self) -> Dict:
        gt_sems, gt_insts, masks, labels, scores = [], [], [], [], []
        thing_ids = self.valid_class_ids[self.num_stuff:]
        for ann, pred in self._results:
            sem, inst = map_inst_markup(
                ann["pts_semantic_mask"].copy(),
                ann["pts_instance_mask"].copy(), thing_ids, self.num_stuff)
            gt_sems.append(sem)
            gt_insts.append(inst)
            masks.append(pred["pts_instance_masks"])
            labels.append(pred["instance_labels"])
            scores.append(pred["instance_scores"])
        return instance_seg_eval(
            gt_sems, gt_insts, masks, labels, scores,
            valid_class_ids=thing_ids,
            class_labels=self.class_names[self.num_stuff:],
            print_summary=False)
