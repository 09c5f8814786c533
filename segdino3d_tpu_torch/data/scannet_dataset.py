"""ScanNet200 / ScanNet v2 instance-segmentation readers (host side).

Counterpart of ``segdino3d_tpu/data/scannet_dataset.py``: reads the
reference's on-disk scene layout (``points/{id}.bin`` float32 N x 6,
``instance_mask|semantic_mask/{id}.bin`` int64, ``super_points/{id}.bin``
int64, the DINO-X features ``{id}.pth``, ``{id}_query_feats.pth`` and
``{id}_query_3dctr.pth``), applies the same label adjustments (ScanNet200:
the chair/floor swap and the raw-id lookup table; v2: the NYU40 -> 20
table), stuff exclusion and instance re-indexing, the GT superpoint pooling
and the eval-time merging of stuff points, and returns the same numpy
records.  Both readers are registered in ``registry.DATASETS``.

The transforms are the pipelines of ``data.transforms`` (train, or
val/test), built through ``registry.TRANSFORMS``; a ``transform_cfg`` that
names anything else raises.  Every random draw comes from the caller's
``np.random.RandomState`` in the JAX reader's order: the DINO-X query
dropout (``dropout_rate_2dfeats``, train scenes only), then the
transforms.  ``get_record(..., sync_scale=s)`` presets the pipeline's
scale factor (the loader's batch-wide sync scale), which then draws no
scale.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from segdino3d_tpu_torch.data import scannet_constants as C
import segdino3d_tpu_torch.data.transforms  # noqa: F401 (registers them)
from segdino3d_tpu_torch.registry import DATASETS, TRANSFORMS

_TRANSFORM_TYPES = ("Scannet200Transforms", "ScannetTransforms")
# ``voxel_size`` sizes the training pipeline's elastic distortion only
_TRANSFORM_KEYS = ("type", "scene_set", "voxel_size")


def pool_to_superpoints(onehot: np.ndarray, sp_ids: np.ndarray,
                        num_sp: int) -> np.ndarray:
    """scatter-mean of one-hot rows over superpoints, then > 0.5."""
    sums = np.zeros((num_sp, onehot.shape[1]), np.float32)
    np.add.at(sums, sp_ids, onehot.astype(np.float32))
    counts = np.bincount(sp_ids, minlength=num_sp).astype(np.float32)
    means = sums / np.maximum(counts, 1.0)[:, None]
    return means > 0.5


def _transforms(transform_cfg: Optional[Dict], scene_set: str,
                voxel_size: float = 0.02):
    """The pipeline a reader's ``transform_cfg`` names (the factory's cfg,
    or the reference's wrapper around it), the default one for None."""
    if transform_cfg is None:
        cfg = dict(type="Scannet200Transforms", voxel_size=voxel_size)
    else:
        cfg = dict(transform_cfg)
        cfg = dict(cfg.get("transform_cfg", cfg))
    if cfg.get("type") not in _TRANSFORM_TYPES or set(cfg) - set(
            _TRANSFORM_KEYS):
        raise NotImplementedError(
            f"transform_cfg {transform_cfg}: the port reads the ScanNet "
            f"pipelines only ({' or '.join(_TRANSFORM_TYPES)} with keys "
            f"{_TRANSFORM_KEYS})")
    cfg.setdefault("scene_set", scene_set)
    return TRANSFORMS.build(cfg)


class _ScanNetBase:
    """The readers' shared logic; a subclass fixes the label space."""

    num_semantic_classes: int
    bg_class_id: int

    def __init__(self, scene_set: str, root_scenes: str,
                 use_super_points: bool = True,
                 adjust_class_ids: bool = True, exclude_stuffs: bool = True,
                 root_points_2dfeats: Optional[str] = None,
                 dropout_rate_2dfeats: float = 0.0,
                 transform_cfg: Optional[Dict] = None,
                 mode_fuse_multi_scale_2d_feats: str = "mean",
                 stuff_categories: Sequence[str] = ("wall", "floor"),
                 dataset_type: str = "scannet",
                 skip_empty_scenes: bool = False,
                 voxel_size: float = 0.02,
                 feats_2d_dtype: str = "float32",
                 num_semantic_classes: Optional[int] = None):
        """``dataset_type`` and ``skip_empty_scenes`` are the configs'
        reader keys: stored and, as in the JAX reader, read only by
        ``cache_fingerprint``."""
        if scene_set not in ("train", "val", "test"):
            raise ValueError(scene_set)
        if mode_fuse_multi_scale_2d_feats != "mean":
            raise NotImplementedError(mode_fuse_multi_scale_2d_feats)
        if num_semantic_classes is not None:
            # a smaller label space (small test configs)
            self.num_semantic_classes = num_semantic_classes
            self.bg_class_id = num_semantic_classes
        self.scene_set = scene_set
        self.root_scenes = root_scenes
        self.use_super_points = use_super_points
        self.adjust_class_ids = adjust_class_ids
        self.exclude_stuffs = exclude_stuffs
        self.root_points_2dfeats = root_points_2dfeats
        self.dropout_rate_2dfeats = dropout_rate_2dfeats
        self.mode_fuse = mode_fuse_multi_scale_2d_feats
        self.n_stuff = len(stuff_categories)
        self.dataset_type = dataset_type
        self.skip_empty_scenes = skip_empty_scenes
        self.feats_2d_dtype = np.dtype(feats_2d_dtype)
        with open(os.path.join(root_scenes, "meta_data",
                               f"scannetv2_{scene_set}.txt")) as f:
            self.scene_ids: List[str] = [l.strip() for l in f if l.strip()]
        self._lut = self._build_lut()
        self.transforms = _transforms(transform_cfg, scene_set, voxel_size)

    def _build_lut(self) -> np.ndarray:
        raise NotImplementedError

    def _adjust(self, sem: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def __len__(self):
        return len(self.scene_ids)

    def cache_fingerprint(self) -> str:
        """Identity for the eval batch cache (``data.eval_cache``): the
        scene list, each points file's size and mtime, and every reader
        setting that shapes a record, as the JAX reader's."""
        import hashlib

        stats = []
        for sid in self.scene_ids:
            try:
                st = os.stat(os.path.join(self.root_scenes, "points",
                                          f"{sid}.bin"))
                stats.append((sid, st.st_size, st.st_mtime_ns))
            except OSError:
                stats.append((sid, -1, -1))
        knobs = (type(self).__name__, self.scene_set, self.use_super_points,
                 self.adjust_class_ids, self.exclude_stuffs,
                 str(self.feats_2d_dtype), self.root_points_2dfeats,
                 self.mode_fuse, self.n_stuff, self.dataset_type,
                 self.skip_empty_scenes, self.num_semantic_classes)
        return hashlib.sha1(repr((knobs, stats)).encode()).hexdigest()[:16]

    def _load_2d(self, scene_id: str, rng: np.random.RandomState):
        """(point features mean-fused over scales, query features, query
        centres); on the train set a share ``dropout_rate_2dfeats`` of the
        queries is dropped at random."""
        import torch

        root = self.root_points_2dfeats

        def load(name):
            return torch.load(os.path.join(root, name), map_location="cpu",
                              weights_only=False)

        pf = load(f"{scene_id}.pth")
        qf = load(f"{scene_id}_query_feats.pth")
        qp = load(f"{scene_id}_query_3dctr.pth")
        if isinstance(pf, (list, tuple)):
            pf = torch.stack(list(pf), 0).mean(0)
        pf = pf.float().numpy().astype(self.feats_2d_dtype, copy=False)
        qf = qf.float().numpy()
        qp = (qp.float().numpy() if hasattr(qp, "numpy")
              else np.asarray(qp, np.float32))
        if self.dropout_rate_2dfeats > 0 and self.scene_set == "train":
            n = qp.shape[0]
            keep = int(n * (1 - self.dropout_rate_2dfeats))
            sel = rng.choice(n, keep, replace=False)
            qp, qf = qp[sel], qf[sel]
        return pf, qf, qp

    def _read(self, sub: str, scene_id: str, dtype) -> np.ndarray:
        return np.fromfile(os.path.join(self.root_scenes, sub,
                                        f"{scene_id}.bin"), dtype=dtype)

    def get_record(self, idx: int,
                   rng: Optional[np.random.RandomState] = None,
                   sync_scale: Optional[float] = None) -> Dict:
        """Load, label-adjust, pool and transform one scene: a numpy
        record of the JAX package's schema.  ``sync_scale`` presets the
        pipeline's scale factor."""
        rng = rng or np.random.RandomState()
        scene_id = self.scene_ids[idx]
        points = self._read("points", scene_id, np.float32).reshape(-1, 6)
        points = points.copy()
        inst = self._read("instance_mask", scene_id, np.int64)
        sem = self._read("semantic_mask", scene_id, np.int64)
        if self.adjust_class_ids:
            sem = self._adjust(sem)

        n_cls = self.num_semantic_classes
        if self.exclude_stuffs:
            # stuff and unlabeled points lose their instance; re-index
            inst = inst.copy()
            inst[sem < self.n_stuff] = -1
            inst[sem >= n_cls] = -1
            uniq = np.unique(inst)
            remap = np.full(inst.max() + 2, -1, np.int64)
            remap[uniq] = np.arange(len(uniq)) - (1 if uniq[0] == -1 else 0)
            inst = remap[inst]

        pf = qf = qp = None
        if self.root_points_2dfeats is not None:
            pf, qf, qp = self._load_2d(scene_id, rng)

        sp = sp_inst_masks = sp_sem_masks = None
        if self.use_super_points:
            sp = self._read("super_points", scene_id, np.int64)
            num_sp = int(sp.max()) + 1
            n_inst = int(inst.max()) + 1
            onehot_i = np.zeros((len(inst), n_inst), bool)
            has = inst >= 0
            onehot_i[np.arange(len(inst))[has], inst[has]] = True
            sp_inst_masks = pool_to_superpoints(onehot_i, sp, num_sp)
            onehot_s = np.zeros((len(sem), n_cls + 1), bool)
            onehot_s[np.arange(len(sem)), np.clip(sem, 0, n_cls)] = True
            sp_sem_masks = pool_to_superpoints(onehot_s, sp, num_sp)
            sp_sem_masks[sp_sem_masks.sum(-1) == 0, -1] = True

        # eval-time stuff merging for the GT annotation
        inst_merged = None
        if self.scene_set != "train":
            inst_merged = inst.copy()
            inst_merged[inst_merged != -1] += self.n_stuff
            for k in range(self.n_stuff):
                inst_merged[sem == k] = k

        # per-instance labels (train label space: -n_stuff when excluded)
        n_inst = int(inst.max()) + 1
        labels = np.zeros(n_inst, np.int64)
        for i in range(n_inst):
            m = inst == i
            if m.any():
                cid = int(sem[m][0])
                labels[i] = cid - self.n_stuff if self.exclude_stuffs else cid

        target = {"extra_features": {"query2d_pos": qp}}
        if sync_scale is not None:
            target["pcd_scale_factor"] = sync_scale
        points, target = self.transforms(points, target, rng)
        return dict(
            scene_id=scene_id, scene_idx=idx, points=points,
            superpoint_ids=sp, point_inst_ids=inst, inst_labels=labels,
            sp_inst_masks=None if sp_inst_masks is None else sp_inst_masks.T,
            sp_sem_masks=None if sp_sem_masks is None else sp_sem_masks.T,
            points_2dfeats=pf, query2d_feats=qf,
            query2d_pos=target["extra_features"].get("query2d_pos"),
            elastic_coords=target.get("elastic_coords"),
            semantic_masks=sem, inst_merged=inst_merged)


@DATASETS.register_module()
class ScanNet200InstanceSeg3D(_ScanNetBase):
    num_semantic_classes = 200
    bg_class_id = 200

    def _build_lut(self):
        return C.scannet200_seg_label_lut()

    def _adjust(self, sem):
        # the chair/floor swap of ScanNet200's preprocessing, then raw id
        # -> 0..199
        s = sem.copy()
        s[sem == 2] = 3
        s[sem == 3] = 2
        s = np.clip(s, 0, len(self._lut) - 1)
        return self._lut[s]


@DATASETS.register_module()
class ScanNetInstanceSeg3D(_ScanNetBase):
    """ScanNet v2 (20 classes)."""
    num_semantic_classes = 20
    bg_class_id = 20

    def __init__(self, *args, **kw):
        kw.setdefault("skip_empty_scenes", True)
        super().__init__(*args, **kw)

    def _build_lut(self):
        return C.scannet20_seg_label_lut()

    def _adjust(self, sem):
        s = np.clip(sem, 0, len(self._lut) - 1)
        return self._lut[s]
