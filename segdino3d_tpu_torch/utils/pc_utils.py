"""Point-cloud debug utilities: sampling, rotations, bbox/mesh export.

Counterpart of ``segdino3d_tpu/utils/pc_utils.py``, with the same
functions.  Host-side numpy helpers mirroring the reference's debug toolbox
(``segdino3d/models/module/pc_util.py:34-304``): random subsampling,
canonical rotation matrices, axis-aligned / oriented bounding-box mesh
export, and polyline-as-cylinders export.  The range-normalization
``shift_scale_points`` lives on the compute path instead
(``segdino3d_tpu_torch/ops/pos_embed.py``) because the positional embedding
consumes it inside the model's forward.

Mesh export writes standard PLY through the port's ``tools/ply_io.py``,
with no trimesh or plyfile dependency.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from segdino3d_tpu_torch.tools.ply_io import write_ply


def random_sampling(pc: np.ndarray, num_sample: int,
                    replace: Optional[bool] = None,
                    return_choices: bool = False,
                    rng: Optional[np.random.RandomState] = None):
    """Uniformly subsample ``num_sample`` points (``pc_util.py:34-45``).

    ``replace`` defaults to sampling with replacement only when the cloud
    has fewer points than requested.
    """
    rng = rng or np.random
    n = pc.shape[0]
    if replace is None:
        replace = n < num_sample
    choices = rng.choice(n, num_sample, replace=replace)
    return (pc[choices], choices) if return_choices else pc[choices]


def scale_points(xyz: np.ndarray, mult_factor: np.ndarray) -> np.ndarray:
    """Per-batch isotropic scale (``pc_util.py:79-83``): xyz (..., N, 3),
    mult_factor broadcastable to the batch dims."""
    return xyz * np.asarray(mult_factor)[..., None, None]


# ---- canonical rotation matrices (``pc_util.py:111-140``) ----

def roty(t: float) -> np.ndarray:
    """Rotation about the +y (up, camera coord) axis."""
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)


def roty_batch(t: np.ndarray) -> np.ndarray:
    """Vectorized ``roty``: t (...,) -> (..., 3, 3)."""
    t = np.asarray(t)
    c, s = np.cos(t), np.sin(t)
    out = np.zeros(t.shape + (3, 3), t.dtype if t.dtype.kind == "f"
                   else np.float64)
    out[..., 0, 0] = c
    out[..., 0, 2] = s
    out[..., 1, 1] = 1
    out[..., 2, 0] = -s
    out[..., 2, 2] = c
    return out


def rotz(t: float) -> np.ndarray:
    """Rotation about the +z (up, depth coord) axis."""
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)


def rotate_point_cloud(points: np.ndarray,
                       rotation_matrix: Optional[np.ndarray] = None,
                       rng: Optional[np.random.RandomState] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Rotate xyz about y by ``rotation_matrix`` (random yaw when None);
    returns (rotated, matrix) (``pc_util.py:86-97``)."""
    if rotation_matrix is None:
        angle = (rng or np.random).uniform() * 2 * np.pi
        rotation_matrix = roty(angle)
    return points[:, :3] @ rotation_matrix.T, rotation_matrix


def rotate_pc_along_y(pc: np.ndarray, rot_angle: float) -> np.ndarray:
    """In-place-style yaw rotation of the (x, z) columns
    (``pc_util.py:100-108``)."""
    c, s = np.cos(rot_angle), np.sin(rot_angle)
    rot = np.array([[c, -s], [s, c]], pc.dtype)
    out = pc.copy()
    out[:, [0, 2]] = pc[:, [0, 2]] @ rot.T
    return out


def point_cloud_to_bbox(points: np.ndarray) -> np.ndarray:
    """Axis-aligned bbox (cx, cy, cz, dx, dy, dz) of one cloud (N, 3) or
    a batch (B, N, 3) (``pc_util.py:142-152``)."""
    mn = points.min(axis=-2)
    mx = points.max(axis=-2)
    return np.concatenate([(mn + mx) / 2.0, mx - mn], axis=-1)


# ---- bbox/mesh PLY export (``pc_util.py:155-304``) ----

_BOX_CORNERS = np.array(
    [[x, y, z] for x in (-0.5, 0.5) for y in (-0.5, 0.5) for z in (-0.5, 0.5)],
    np.float64)                          # (8, 3), unit cube
# 12 triangles over the corner index grid (two per face, outward-ish)
_BOX_FACES = np.array([
    [0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],   # x faces
    [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],   # y faces
    [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3],   # z faces
], np.int32)


def _box_mesh(box: np.ndarray, rot: Optional[np.ndarray] = None):
    """(cx, cy, cz, dx, dy, dz) -> (8, 3) vertices of the box mesh."""
    v = _BOX_CORNERS * np.asarray(box[3:6])
    if rot is not None:
        v = v @ rot.T
    return v + np.asarray(box[:3])


def _write_boxes(path: str, boxes: np.ndarray, rots, colors=None) -> None:
    verts, faces, cols = [], [], []
    for i, box in enumerate(np.atleast_2d(boxes)):
        r = None if rots is None else rots[i]
        v = _box_mesh(box, r)
        faces.append(_BOX_FACES + 8 * i)
        verts.append(v)
        if colors is not None:
            cols.append(np.broadcast_to(np.asarray(colors[i]), (8, 3)))
    write_ply(path, np.concatenate(verts).astype(np.float32),
              faces=np.concatenate(faces),
              colors=np.concatenate(cols).astype(np.uint8)
              if cols else None)


def write_bbox(scene_bbox: np.ndarray, out_filename: str) -> None:
    """Axis-aligned boxes (K, 6) -> one PLY mesh (``pc_util.py:155-185``)."""
    _write_boxes(out_filename, scene_bbox, None)


def write_oriented_bbox(scene_bbox: np.ndarray, out_filename: str,
                        colors=None) -> None:
    """Boxes (K, 7) = (center, lengths, yaw-about-+z) -> PLY mesh
    (``pc_util.py:188-238``)."""
    scene_bbox = np.atleast_2d(scene_bbox)
    rots = [rotz(b[6]) for b in scene_bbox]
    if colors is not None and np.ndim(colors) == 1:
        colors = np.tile(np.asarray(colors), (len(scene_bbox), 1))
    _write_boxes(out_filename, scene_bbox[:, :6], rots, colors)


def write_oriented_bbox_camera_coord(scene_bbox: np.ndarray,
                                     out_filename: str) -> None:
    """Boxes (K, 7) with heading about +y (camera coords) -> PLY mesh
    (``pc_util.py:241-279``)."""
    scene_bbox = np.atleast_2d(scene_bbox)
    rots = [roty(b[6]) for b in scene_bbox]
    _write_boxes(out_filename, scene_bbox[:, :6], rots)


def write_lines_as_cylinders(pcl: np.ndarray, filename: str,
                             rad: float = 0.005, res: int = 64) -> None:
    """Segments (K, 2, 3) -> PLY of cylinders (``pc_util.py:282-304``).

    Each cylinder is a ``res``-gon tube between the two endpoints.
    """
    verts, faces = [], []
    ang = np.linspace(0, 2 * np.pi, res, endpoint=False)
    ring = np.stack([np.cos(ang), np.sin(ang), np.zeros(res)], axis=1)
    for ki, (a, b) in enumerate(np.asarray(pcl, np.float64)):
        axis = b - a
        length = np.linalg.norm(axis)
        if length < 1e-12:
            continue
        z = axis / length
        # any unit vector not parallel to z
        ref = np.array([1.0, 0, 0]) if abs(z[0]) < 0.9 else np.array([0, 1.0, 0])
        x = np.cross(ref, z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        frame = np.stack([x, y, z], axis=1)
        bot = ring * rad @ frame.T + a
        top = bot + axis
        base = sum(v.shape[0] for v in verts)
        verts.extend([bot, top])
        for j in range(res):
            jn = (j + 1) % res
            faces.append([base + j, base + jn, base + res + j])
            faces.append([base + jn, base + res + jn, base + res + j])
    if not verts:
        return
    write_ply(filename, np.concatenate(verts).astype(np.float32),
              faces=np.asarray(faces, np.int32))
