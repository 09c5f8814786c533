"""Host-side (numpy) point-cloud transforms: the val/test pipeline.

Counterpart of ``segdino3d_tpu/data/transforms.py`` for eval: colour
normalisation with the reference's ScanNet statistics, in a ``Compose3D``.
The training augmentations (flips, rotation/scale/translation, elastic
distortion) come with the training-data slice; until then
``Scannet200Transforms("train")`` raises.
"""
from __future__ import annotations

import numpy as np


class Compose3D:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, points, target, rng: np.random.RandomState):
        for t in self.transforms:
            points, target = t(points, target, rng)
        return points, target


class NormalizePointsColor:
    """(rgb - mean) / std on columns 3:6."""

    def __init__(self, color_mean, color_std=127.5):
        self.mean = np.asarray(color_mean, np.float32)
        self.std = np.asarray(color_std, np.float32)

    def __call__(self, points, target, rng):
        points[:, 3:6] = (points[:, 3:6] - self.mean) / self.std
        return points, target


# the reference's ScanNet colour statistics (SPFormer's)
SCANNET_COLOR_MEAN = (0.47793125906962 * 255,
                      0.4303257521323044 * 255,
                      0.3749598901421883 * 255)
SCANNET_COLOR_STD = (0.2834475483823543 * 255,
                     0.27566157565723015 * 255,
                     0.27018971370874995 * 255)


def Scannet200Transforms(scene_set: str) -> Compose3D:
    """The reader's pipeline of ``scene_set`` (ScanNet v2 shares it)."""
    if scene_set in ("val", "test"):
        return Compose3D([NormalizePointsColor(SCANNET_COLOR_MEAN,
                                               SCANNET_COLOR_STD)])
    if scene_set == "train":
        raise NotImplementedError(
            "the training transforms (flip, rotation/scale/translation, "
            "elastic) are not ported: they come with the training-data "
            "slice")
    raise ValueError(scene_set)
