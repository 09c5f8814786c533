"""Host-side (numpy) point-cloud transforms: the train and val pipelines.

Counterpart of ``segdino3d_tpu/data/transforms.py``, draw for draw: the
same transforms take the same values from the caller's
``np.random.RandomState`` in the same order, so a record is bit-equal to
the JAX package's from the same seed.

* ``RandomFlip3D``: x and y flips, each with its probability, applied to
  the points and to ``query2d_pos``;
* ``GlobalRotScaleTrans``: a z rotation, a scale (a preset
  ``pcd_scale_factor`` wins: the loader's sync scale) and a translation,
  each applied to ``query2d_pos`` too;
* ``NormalizePointsColor``: (rgb - mean) / std;
* ``ElasticTransform``: two scales of smoothed noise displacing the voxel
  coordinates (and ``query2d_pos`` through the same interpolators), written
  to ``elastic_coords`` and ``elastic_coords_query2d_pos``;
* ``Scannet200Transforms`` (registered as ``ScannetTransforms`` too): the
  train pipeline (flip, rotation/scale/translation, colour, elastic) or
  the val/test one (colour alone), with the reference's ScanNet colour
  statistics.
"""
from __future__ import annotations

import math

import numpy as np
import scipy.interpolate
import scipy.ndimage

from segdino3d_tpu_torch.registry import TRANSFORMS


class Compose3D:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, points, target, rng: np.random.RandomState):
        for t in self.transforms:
            points, target = t(points, target, rng)
        return points, target


def _q2d(target):
    return target.get("extra_features", {}).get("query2d_pos")


class RandomFlip3D:
    def __init__(self, p_horizontal=0.5, p_vertical=0.5):
        self.p_h = p_horizontal
        self.p_v = p_vertical

    def __call__(self, points, target, rng):
        q2d = _q2d(target)
        for axis, p in ((0, self.p_h), (1, self.p_v)):
            if rng.rand() < p:
                points[:, axis] = -points[:, axis]
                if q2d is not None:
                    q2d[:, axis] = -q2d[:, axis]
        return points, target


class GlobalRotScaleTrans:
    def __init__(self, rot_range=(-3.14, 3.14), scale_range=(0.8, 1.2),
                 translation_std=(0.1, 0.1, 0.1)):
        self.rot_range = rot_range
        self.scale_range = scale_range
        self.translation_std = np.asarray(translation_std, np.float32)

    def __call__(self, points, target, rng):
        q2d = _q2d(target)
        ang = rng.uniform(*self.rot_range)
        c, s = math.cos(ang), math.sin(ang)
        rot = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], np.float32)
        points[:, :3] = points[:, :3] @ rot
        if q2d is not None:
            q2d[:] = q2d @ rot
        target["pcd_rotation_angle"] = ang
        # a preset scale (the batch's sync scale) draws nothing
        scale = target.get("pcd_scale_factor")
        if scale is None:
            scale = rng.uniform(*self.scale_range)
        target["pcd_scale_factor"] = scale
        points[:, :3] *= scale
        if q2d is not None:
            q2d *= scale
        trans = rng.normal(scale=self.translation_std,
                           size=3).astype(np.float32)
        points[:, :3] += trans
        if q2d is not None:
            q2d += trans
        return points, target


class NormalizePointsColor:
    """(rgb - mean) / std on columns 3:6."""

    def __init__(self, color_mean, color_std=127.5):
        self.mean = np.asarray(color_mean, np.float32)
        self.std = np.asarray(color_std, np.float32)

    def __call__(self, points, target, rng):
        points[:, 3:6] = (points[:, 3:6] - self.mean) / self.std
        return points, target


class ElasticTransform:
    """Two-scale smoothed-noise elastic displacement in voxel units."""

    def __init__(self, gran=(6, 20), mag=(40, 160), voxel_size=0.02, p=0.5):
        self.gran = gran
        self.mag = mag
        self.voxel_size = voxel_size
        self.p = p

    def _make_interp(self, x, gran, rng):
        blur_axes = [np.ones((3, 1, 1), np.float32) / 3,
                     np.ones((1, 3, 1), np.float32) / 3,
                     np.ones((1, 1, 3), np.float32) / 3]
        dims = np.abs(x).max(0).astype(np.int32) // gran + 3
        noise = [rng.randn(*dims).astype(np.float32) for _ in range(3)]
        for blur in blur_axes * 2:
            noise = [scipy.ndimage.convolve(n, blur, mode="constant", cval=0)
                     for n in noise]
        ax = [np.linspace(-(d - 1) * gran, (d - 1) * gran, d) for d in dims]
        return [scipy.interpolate.RegularGridInterpolator(
            ax, n, bounds_error=False, fill_value=0) for n in noise]

    @staticmethod
    def _apply(x, interp, mag):
        disp = np.stack([f(x) for f in interp], axis=1).astype(np.float32)
        return x + disp * mag

    def __call__(self, points, target, rng):
        coords = points[:, :3].astype(np.float32) / self.voxel_size
        q2d = _q2d(target)
        q2d_coords = None if q2d is None else q2d / self.voxel_size
        if rng.rand() < self.p:
            for gran, mag in zip(self.gran, self.mag):
                interp = self._make_interp(coords, gran, rng)
                coords = self._apply(coords, interp, mag)
                if q2d_coords is not None:
                    q2d_coords = self._apply(q2d_coords, interp, mag)
        target["elastic_coords"] = coords
        if q2d_coords is not None:
            target["extra_features"]["elastic_coords_query2d_pos"] = \
                q2d_coords
        target["coords_voxel_size"] = self.voxel_size
        return points, target


# the reference's ScanNet colour statistics (SPFormer's)
SCANNET_COLOR_MEAN = (0.47793125906962 * 255,
                      0.4303257521323044 * 255,
                      0.3749598901421883 * 255)
SCANNET_COLOR_STD = (0.2834475483823543 * 255,
                     0.27566157565723015 * 255,
                     0.27018971370874995 * 255)


@TRANSFORMS.register_module()
def Scannet200Transforms(scene_set: str, voxel_size: float = 0.02
                         ) -> Compose3D:
    """The reader's pipeline of ``scene_set`` (ScanNet v2 shares it);
    ``voxel_size`` sizes the elastic distortion."""
    if scene_set == "train":
        return Compose3D([
            RandomFlip3D(0.5, 0.5),
            GlobalRotScaleTrans((-3.14, 3.14), (0.8, 1.2), (0.1, 0.1, 0.1)),
            NormalizePointsColor(SCANNET_COLOR_MEAN, SCANNET_COLOR_STD),
            ElasticTransform((6, 20), (40, 160), voxel_size, p=0.5),
        ])
    if scene_set in ("val", "test"):
        return Compose3D([NormalizePointsColor(SCANNET_COLOR_MEAN,
                                               SCANNET_COLOR_STD)])
    raise ValueError(scene_set)


TRANSFORMS.register_module("ScannetTransforms", Scannet200Transforms)
