"""Instance-seg evaluator: accumulates per-scene predictions, computes mAP.

A copy of ``segdino3d_tpu/evaluation/evaluator.py:InstanceSeg3DEvaluator``
without the registry: it converts panoptic-style GT markup back to
instance-task ids and feeds the ScanNet AP protocol with
``valid_class_ids`` minus the stuff classes.  It also gathers the results
of several processes through files in a directory every process can read
(``save_shard`` / ``load_shards``), dumps per-scene metrics, and writes the
ScanNet benchmark's submission files; each file is byte-equal to the JAX
evaluator's on the same results.
"""
from __future__ import annotations

import json
import os
import pickle
import time
from typing import Dict, List, Optional, Sequence

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
                 stuff_class_inds: Sequence[int] = (0, 1),
                 submission_prefix_instance: Optional[str] = None,
                 submission_prefix_semantic: Optional[str] = None):
        self.valid_class_ids = list(valid_class_ids)
        self.class_names = list(class_names)
        self.num_stuff = len(stuff_class_inds)
        self.submission_prefix_instance = submission_prefix_instance
        self.submission_prefix_semantic = submission_prefix_semantic
        self.reset()

    def reset(self):
        self._results: List = []

    def process(self, eval_ann: Dict, pred: Dict):
        """pred: dict with pts_instance_masks (N, P) bool, labels (N,),
        scores (N,), and optional semantic/panoptic point maps."""
        self._results.append((eval_ann, pred))

    def save_shard(self, gather_dir: str, process_index: int) -> str:
        """Write this process's results to ``gather_dir`` (a temporary
        name, then renamed: a shard that exists is whole)."""
        os.makedirs(gather_dir, exist_ok=True)
        path = os.path.join(gather_dir, f"shard_{process_index:04d}.pkl")
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            pickle.dump(self._results, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
        return path

    @staticmethod
    def clear_shards(gather_dir: str) -> None:
        """Remove every shard (and partly written one) in ``gather_dir``."""
        if not os.path.isdir(gather_dir):
            return
        for name in os.listdir(gather_dir):
            if name.startswith("shard_"):
                os.remove(os.path.join(gather_dir, name))

    def load_shards(self, gather_dir: str, process_count: int,
                    timeout_s: float = 600.0) -> None:
        """Replace the results by every process's shard, in rank order;
        raises ``TimeoutError`` when a shard is still missing after
        ``timeout_s``.  Every process may call it and then computes the
        same metrics.  The shards are this program's own pickles."""
        paths = [os.path.join(gather_dir, f"shard_{p:04d}.pkl")
                 for p in range(process_count)]
        deadline = time.monotonic() + timeout_s
        while any(not os.path.exists(p) for p in paths):
            if time.monotonic() > deadline:
                missing = [p for p in paths if not os.path.exists(p)]
                raise TimeoutError(f"eval gather: missing shards {missing}")
            time.sleep(0.2)
        merged: List = []
        for p in paths:
            with open(p, "rb") as f:
                merged.extend(pickle.load(f))
        self._results = merged

    def _gt(self, ann: Dict):
        return map_inst_markup(
            ann["pts_semantic_mask"].copy(), ann["pts_instance_mask"].copy(),
            self.valid_class_ids[self.num_stuff:], self.num_stuff)

    def evaluate_per_scene(self, out_json: Optional[str] = None) -> Dict:
        """{scene id: its all_ap, all_ap_50, all_ap_25}, written to
        ``out_json`` where given."""
        thing_ids = self.valid_class_ids[self.num_stuff:]
        per_scene = {}
        for ann, pred in self._results:
            sem, inst = self._gt(ann)
            res = instance_seg_eval(
                [sem], [inst], [pred["pts_instance_masks"]],
                [pred["instance_labels"]], [pred["instance_scores"]],
                valid_class_ids=thing_ids,
                class_labels=self.class_names[self.num_stuff:],
                print_summary=False)
            per_scene[str(ann.get("lidar_idx"))] = dict(
                all_ap=res["all_ap"], all_ap_50=res["all_ap_50"],
                all_ap_25=res["all_ap_25"])
        if out_json:
            with open(out_json, "w") as f:
                json.dump(per_scene, f, indent=1)
        return per_scene

    def evaluate(self) -> Dict:
        """The AP dict; with ``submission_prefix_instance`` the submission
        files are written instead and the dict is empty."""
        if self.submission_prefix_instance:
            self.format_results_instance()
            return {}
        gt_sems, gt_insts, masks, labels, scores = [], [], [], [], []
        thing_ids = self.valid_class_ids[self.num_stuff:]
        for ann, pred in self._results:
            sem, inst = self._gt(ann)
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

    def format_results_instance(self) -> None:
        """The ScanNet benchmark's instance files: ``<scene>.txt`` (one
        line per instance: its mask file, raw class id, score) and
        ``predicted_masks/<scene>_<i>.txt`` (one 0/1 line per point)."""
        prefix = self.submission_prefix_instance
        os.makedirs(os.path.join(prefix, "predicted_masks"), exist_ok=True)
        for ann, pred in self._results:
            sid = ann.get("lidar_idx", "scene")
            lines = []
            for i in range(len(pred["instance_labels"])):
                cls = self.valid_class_ids[
                    self.num_stuff + int(pred["instance_labels"][i])]
                rel = f"predicted_masks/{sid}_{i:03d}.txt"
                lines.append(f"{rel} {cls} "
                             f"{float(pred['instance_scores'][i]):.4f}")
                np.savetxt(os.path.join(prefix, rel),
                           pred["pts_instance_masks"][i].astype(np.int32),
                           fmt="%d")
            with open(os.path.join(prefix, f"{sid}.txt"), "w") as f:
                f.write("".join(line + "\n" for line in lines))

    def format_results_semantic(self) -> None:
        """The ScanNet benchmark's semantic files: ``<scene>.txt``, the
        raw class id of each point."""
        prefix = self.submission_prefix_semantic
        os.makedirs(prefix, exist_ok=True)
        ids = np.asarray(self.valid_class_ids)
        for ann, pred in self._results:
            sid = ann.get("lidar_idx", "scene")
            out = ids[np.clip(pred["pts_semantic_mask"], 0, len(ids) - 1)]
            np.savetxt(os.path.join(prefix, f"{sid}.txt"), out, fmt="%d")
