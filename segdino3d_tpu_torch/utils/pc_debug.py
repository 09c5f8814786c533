"""Debug point-cloud helpers: sampling, rotations, bbox/mesh export.

Counterpart of ``segdino3d_tpu/utils/pc_debug.py``, with the same
functions, and through it of the reference's debug-only utilities
(``segdino3d/models/module/pc_util.py:34-304``): ``random_sampling``,
rotation helpers (``roty/rotz/roty_batch``, ``rotate_point_cloud``,
``rotate_pc_along_y``; ``rotx`` is carried over from the upstream
votenet-style pc_util these derive from — the reference file itself
defines only the y/z variants), ``point_cloud_to_bbox``, and the mesh writers
(``write_bbox``, ``write_oriented_bbox``,
``write_oriented_bbox_camera_coord``, ``write_lines_as_cylinders``).
``shift_scale_points``/``scale_points`` — the two functions the model
path actually uses — live in ``ops/pos_embed.py``.

Host-side numpy by design: these run in visualization scripts, never
on the model path. The mesh writers emit binary PLY through the port's
``tools/ply_io.py`` with self-generated box/cylinder geometry instead of
depending on trimesh.
"""
from __future__ import annotations

import numpy as np

from segdino3d_tpu_torch.tools.ply_io import write_ply


# ---------------------------------------------------------------- sampling
def random_sampling(pc: np.ndarray, num_sample: int, replace=None,
                    return_choices: bool = False, rng=None):
    """Sample ``num_sample`` rows from an (N, C) cloud.

    Samples without replacement when the cloud is large enough (matching
    the reference's default), with replacement otherwise.
    """
    rng = np.random.default_rng() if rng is None else rng
    if replace is None:
        replace = pc.shape[0] < num_sample
    choices = rng.choice(pc.shape[0], num_sample, replace=replace)
    return (pc[choices], choices) if return_choices else pc[choices]


# --------------------------------------------------------------- rotations
def rotx(t: float) -> np.ndarray:
    """Rotation about the x-axis."""
    c, s = np.cos(t), np.sin(t)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float64)


def roty(t: float) -> np.ndarray:
    """Rotation about the y-axis."""
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float64)


def rotz(t: float) -> np.ndarray:
    """Rotation about the z-axis."""
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float64)


def roty_batch(t: np.ndarray) -> np.ndarray:
    """Batched y-rotations: t of shape (...,) -> (..., 3, 3)."""
    t = np.asarray(t)
    out = np.zeros(t.shape + (3, 3), dtype=np.float64)
    c, s = np.cos(t), np.sin(t)
    out[..., 0, 0] = c
    out[..., 0, 2] = s
    out[..., 1, 1] = 1
    out[..., 2, 0] = -s
    out[..., 2, 2] = c
    return out


def rotate_point_cloud(points: np.ndarray, rotation_matrix=None, rng=None):
    """Rotate an (N, 3) cloud about its centroid (random Z yaw if no
    matrix given). Returns (rotated, rotation_matrix)."""
    if rotation_matrix is None:
        rng = np.random.default_rng() if rng is None else rng
        ang = rng.uniform() * 2 * np.pi
        s, c = np.sin(ang), np.cos(ang)
        # right-multiplication convention, as in the reference
        rotation_matrix = np.array(
            [[c, s, 0], [-s, c, 0], [0, 0, 1]], dtype=np.float64)
    ctr = points.mean(axis=0)
    return (points - ctr) @ rotation_matrix + ctr, rotation_matrix


def rotate_pc_along_y(pc: np.ndarray, rot_angle: float) -> np.ndarray:
    """Rotate (N, C>=3) points about the y axis (camera coords: z
    forward, x left, y down). Mutates and returns ``pc``."""
    c, s = np.cos(rot_angle), np.sin(rot_angle)
    rotmat = np.array([[c, -s], [s, c]])
    pc[:, [0, 2]] = pc[:, [0, 2]] @ rotmat.T
    return pc


# -------------------------------------------------------------------- bbox
def point_cloud_to_bbox(points: np.ndarray) -> np.ndarray:
    """Axis-aligned box of an (N, 3) cloud or (B, N, 3) batch as
    (center_xyz, lengths_xyz)."""
    axis = points.ndim - 2
    mn, mx = points.min(axis), points.max(axis)
    return np.concatenate([0.5 * (mn + mx), mx - mn], axis=axis)


# ------------------------------------------------------------ mesh writers
_BOX_CORNERS = np.array(
    [[x, y, z] for x in (-0.5, 0.5) for y in (-0.5, 0.5)
     for z in (-0.5, 0.5)], dtype=np.float64)
# outward-wound triangles over the 8 corners above (2 per face)
_BOX_FACES = np.array([
    [0, 1, 3], [0, 3, 2],      # -x
    [4, 6, 7], [4, 7, 5],      # +x
    [0, 4, 5], [0, 5, 1],      # -y
    [2, 3, 7], [2, 7, 6],      # +y
    [0, 2, 6], [0, 6, 4],      # -z
    [1, 5, 7], [1, 7, 3],      # +z
], dtype=np.int32)


def _box_mesh(center, lengths, rotmat=None):
    v = _BOX_CORNERS * np.asarray(lengths)
    if rotmat is not None:
        v = v @ np.asarray(rotmat).T
    return v + np.asarray(center), _BOX_FACES


def _write_mesh_scene(parts, out_filename, colors=None):
    verts, faces, cols, off = [], [], [], 0
    for i, (v, f) in enumerate(parts):
        verts.append(v)
        faces.append(f + off)
        if colors is not None:
            cols.append(np.broadcast_to(colors[i][:3], (len(v), 3)))
        off += len(v)
    write_ply(out_filename,
              np.concatenate(verts) if verts else np.zeros((0, 3)),
              faces=np.concatenate(faces) if verts else None,
              colors=np.concatenate(cols) if cols else None)


def write_bbox(scene_bbox: np.ndarray, out_filename: str) -> None:
    """Export (N, 6) axis-aligned boxes (center, lengths) as a PLY mesh."""
    _write_mesh_scene([_box_mesh(b[:3], b[3:6]) for b in scene_bbox],
                      out_filename)


def _heading2rotmat_z(angle):
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def _heading2rotmat_y(angle):
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def write_oriented_bbox(scene_bbox: np.ndarray, out_filename: str,
                        colors=None) -> None:
    """Export (N, 7) Z-yaw boxes (center, lengths, heading) as PLY.

    ``colors``: optional (N, 3/4) uint8, or a single color for all boxes.
    """
    if colors is not None:
        colors = np.asarray(colors, dtype=np.uint8)
        if colors.ndim == 1:
            colors = np.broadcast_to(colors, (len(scene_bbox),) +
                                     colors.shape)
        assert colors.shape[0] == len(scene_bbox)
    _write_mesh_scene(
        [_box_mesh(b[:3], b[3:6], _heading2rotmat_z(b[6]))
         for b in scene_bbox], out_filename, colors=colors)


def write_oriented_bbox_camera_coord(scene_bbox: np.ndarray,
                                     out_filename: str) -> None:
    """Export (N, 7) Y-heading boxes (camera coords) as PLY."""
    _write_mesh_scene(
        [_box_mesh(b[:3], b[3:6], _heading2rotmat_y(b[6]))
         for b in scene_bbox], out_filename)


def _cylinder_mesh(src, tgt, rad, res):
    src, tgt = np.asarray(src, np.float64), np.asarray(tgt, np.float64)
    vec = tgt - src
    h = float(np.linalg.norm(vec))
    # orthonormal frame with e3 along the segment
    e3 = vec / max(h, 1e-12)
    a = np.array([1.0, 0, 0]) if abs(e3[0]) < 0.9 else np.array([0, 1.0, 0])
    e1 = np.cross(e3, a)
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(e3, e1)
    ang = 2 * np.pi * np.arange(res) / res
    ring = rad * (np.cos(ang)[:, None] * e1 + np.sin(ang)[:, None] * e2)
    bot, top = src + ring, tgt + ring
    verts = np.concatenate([bot, top, src[None], tgt[None]])
    i = np.arange(res)
    j = (i + 1) % res
    faces = np.concatenate([
        np.stack([i, j, res + i], -1),                 # side lower
        np.stack([j, res + j, res + i], -1),           # side upper
        np.stack([np.full(res, 2 * res), j, i], -1),   # bottom cap
        np.stack([np.full(res, 2 * res + 1), res + i, res + j], -1),
    ]).astype(np.int32)
    return verts, faces


def write_lines_as_cylinders(pcl: np.ndarray, filename: str,
                             rad: float = 0.005, res: int = 64) -> None:
    """Export (N, 2, 3) point pairs as cylinder segments to
    ``<filename>.ply`` (same suffix behavior as the reference)."""
    _write_mesh_scene([_cylinder_mesh(s, t, rad, res) for s, t in pcl],
                      f"{filename}.ply")
