"""Offline ScanNet data preparation: raw scans -> the readers' .bin layout.

Counterpart of ``tools/prepare_scannet.py``, with its flags and files.
For every scene:

1. read ``<scene>_vh_clean_2.ply`` (mesh and colour),
   ``<scene>_vh_clean_2.labels.ply`` (raw semantic labels) or the
   aggregation / segs json pair, and the axis-alignment matrix of
   ``<scene>.txt``;
2. axis-align the vertices, build per-vertex semantic and instance ids;
3. compute superpoints with the native mesh segmentator
   (``data.segmentator``);
4. write ``points/{id}.bin`` (N x 6 float32 xyzrgb),
   ``instance_mask/{id}.bin`` and ``semantic_mask/{id}.bin`` (int64),
   ``super_points/{id}.bin`` (int64) and the split lists under
   ``meta_data/``.

Usage:
    python -m segdino3d_tpu_torch.tools.prepare_scannet \\
        --scans_dir <raw>/scans --output_dir data/scannet200 \\
        [--num_workers 8] [--max_scenes N] [--label_map TSV] \\
        [--splits_dir DIR]
"""
from __future__ import annotations

import argparse
import csv
import json
import multiprocessing as mp
import os
import shutil
from typing import Optional

import numpy as np

from segdino3d_tpu_torch.data.segmentator import segment_mesh
from segdino3d_tpu_torch.tools.ply_io import read_ply


def read_axis_align_matrix(meta_path: str) -> Optional[np.ndarray]:
    if not os.path.isfile(meta_path):
        return None
    with open(meta_path) as f:
        for line in f:
            if line.startswith("axisAlignment"):
                vals = [float(x) for x in line.split("=")[1].split()]
                return np.asarray(vals, np.float64).reshape(4, 4)
    return None


def read_label_map(tsv_path: str, label_from: str = "raw_category",
                   label_to: str = "id"):
    """ScanNet's ``scannetv2-labels.combined.tsv``: {raw category: id}."""
    mapping = {}
    with open(tsv_path) as f:
        for row in csv.DictReader(f, delimiter="\t"):
            try:
                mapping[row[label_from]] = int(row[label_to])
            except ValueError:
                mapping[row[label_from]] = 0
    return mapping


def export_scene(scans_dir: str, scene_id: str, output_dir: str,
                 label_map_path: Optional[str] = None) -> bool:
    """Write one scene's files; False where it has no mesh."""
    sdir = os.path.join(scans_dir, scene_id)
    mesh_p = os.path.join(sdir, f"{scene_id}_vh_clean_2.ply")
    agg_p = os.path.join(sdir, f"{scene_id}.aggregation.json")
    seg_p = os.path.join(sdir, f"{scene_id}_vh_clean_2.0.010000.segs.json")
    meta_p = os.path.join(sdir, f"{scene_id}.txt")
    if not os.path.isfile(mesh_p):
        return False

    mesh = read_ply(mesh_p)
    verts = mesh["vertices"].astype(np.float64)
    colors = mesh.get("colors", np.zeros((len(verts), 3), np.uint8))
    faces = mesh["faces"]

    m = read_axis_align_matrix(meta_p)
    if m is not None:
        hom = np.concatenate([verts, np.ones((len(verts), 1))], 1)
        verts = (hom @ m.T)[:, :3]

    n = len(verts)
    sem = np.zeros(n, np.int64)
    inst = np.full(n, -1, np.int64)

    # semantics from the labels ply where present, else (with a label
    # map) from the aggregation's objects
    labels_p = os.path.join(sdir, f"{scene_id}_vh_clean_2.labels.ply")
    if os.path.isfile(labels_p):
        sem = read_ply(labels_p).get("labels", sem).astype(np.int64)

    if os.path.isfile(agg_p) and os.path.isfile(seg_p):
        with open(seg_p) as f:
            seg_to_verts = {}
            for vi, s in enumerate(json.load(f)["segIndices"]):
                seg_to_verts.setdefault(s, []).append(vi)
        label_map = read_label_map(label_map_path) if label_map_path \
            else None
        with open(agg_p) as f:
            for obj in json.load(f)["segGroups"]:
                for s in obj["segments"]:
                    for vi in seg_to_verts.get(s, ()):
                        inst[vi] = obj["objectId"]
                if label_map is not None:
                    raw = label_map.get(obj["label"], 0)
                    for s in obj["segments"]:
                        for vi in seg_to_verts.get(s, ()):
                            sem[vi] = raw

    sp = segment_mesh(verts.astype(np.float32), faces)

    pts = np.concatenate(
        [verts.astype(np.float32), colors.astype(np.float32)], 1)
    for sub in ("points", "instance_mask", "semantic_mask", "super_points"):
        os.makedirs(os.path.join(output_dir, sub), exist_ok=True)
    pts.tofile(os.path.join(output_dir, "points", f"{scene_id}.bin"))
    inst.tofile(os.path.join(output_dir, "instance_mask", f"{scene_id}.bin"))
    sem.tofile(os.path.join(output_dir, "semantic_mask", f"{scene_id}.bin"))
    sp.tofile(os.path.join(output_dir, "super_points", f"{scene_id}.bin"))
    return True


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--scans_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--label_map", default=None,
                   help="scannetv2-labels.combined.tsv path")
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--max_scenes", type=int, default=None)
    p.add_argument("--splits_dir", default=None,
                   help="dir with scannetv2_{train,val,test}.txt lists")
    args = p.parse_args(argv)

    scenes = sorted(d for d in os.listdir(args.scans_dir)
                    if os.path.isdir(os.path.join(args.scans_dir, d)))
    if args.max_scenes:
        scenes = scenes[:args.max_scenes]

    jobs = [(args.scans_dir, s, args.output_dir, args.label_map)
            for s in scenes]
    if args.num_workers > 1:
        with mp.get_context("spawn").Pool(args.num_workers) as pool:
            ok = pool.starmap(export_scene, jobs)
    else:
        ok = [export_scene(*j) for j in jobs]
    print(f"exported {sum(ok)}/{len(scenes)} scenes")

    meta = os.path.join(args.output_dir, "meta_data")
    os.makedirs(meta, exist_ok=True)
    if args.splits_dir:
        for split in ("train", "val", "test"):
            src = os.path.join(args.splits_dir, f"scannetv2_{split}.txt")
            if os.path.isfile(src):
                shutil.copy(src, meta)
    else:
        with open(os.path.join(meta, "scannetv2_train.txt"), "w") as f:
            f.write("\n".join(s for s, o in zip(scenes, ok) if o))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
