"""Synthetic indoor-scene generator.

A copy of ``segdino3d_tpu/data/synthetic.py:synthetic_scene`` and
``write_scannet_layout``: the same seed gives the same record, so the port
and the JAX package can be fed one scene.  Records carry the schema of the
ScanNet readers, and ``write_scannet_layout`` writes scenes in the on-disk
layout that ``data.scannet_dataset`` reads.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from segdino3d_tpu_torch.data.scannet_dataset import pool_to_superpoints


def _grid_surface(rng, m, origin, u_axis, v_axis, n_axis, u_len, v_len,
                  pitch, jitter=0.6, thickness=0.015):
    """Sample m points on a rectangle via a jittered grid.

    Real indoor scans cover surfaces *contiguously* — at 2 cm voxels nearly
    every surface cell in view is occupied (scan meshes are dense), unlike
    i.i.d.-uniform sprinkling which leaves most cells empty at realistic
    point budgets.  Grid + jitter reproduces that connectivity, which is
    what drives sparse-conv neighbor density and block-dense tile fill.
    """
    nu = max(1, int(round(u_len / pitch)))
    nv = max(1, int(round(v_len / pitch)))
    cells = nu * nv
    if m >= cells:
        # full coverage: every cell once, surplus as extra random cells
        idx = np.concatenate([np.arange(cells),
                              rng.randint(0, cells, m - cells)])
    else:
        idx = rng.permutation(cells)[:m]
    u = (idx // nv + rng.uniform(-jitter, jitter, m) + 0.5) * (u_len / nu)
    v = (idx % nv + rng.uniform(-jitter, jitter, m) + 0.5) * (v_len / nv)
    w = rng.uniform(0, thickness, m)
    out = np.tile(np.asarray(origin, np.float32), (m, 1))
    out[:, u_axis] += u.astype(np.float32)
    out[:, v_axis] += v.astype(np.float32)
    out[:, n_axis] += w.astype(np.float32)
    return out


def synthetic_scene(seed: int = 0,
                    n_points: int = 20000,
                    n_instances: int = 8,
                    n_superpoints: int = 96,
                    n_classes: int = 18,
                    n_stuff: int = 2,
                    n_queries2d: int = 12,
                    feat_dim_2d: int = 256,
                    extent: Optional[float] = None,
                    point_density: float = 3500.0) -> Dict:
    """A room: floor/wall 'stuff' + box-surface instances, superpoints by
    grid.  Surfaces are sampled at ``point_density`` pts/m^2 on jittered
    grids (ScanNet-like contiguity at 2 cm voxels); with the default
    density the room extent is derived from the point budget so surface
    coverage stays realistic at any ``n_points``."""
    rng = np.random.RandomState(seed)
    pts = np.zeros((n_points, 6), np.float32)
    pitch = 1.0 / np.sqrt(point_density)

    # nominal room geometry, then scale every dimension so the total
    # surface area matches the point budget at the target density (real
    # scans sample their visible surfaces fully; coverage, not extent,
    # is the invariant)
    nominal_extent = extent if extent is not None else 4.5
    wall_h = min(2.5, nominal_extent * 0.7)
    sizes = [rng.uniform(0.25, min(0.9, nominal_extent / 3), 3)
             for _ in range(n_instances)]
    ctrs = [rng.uniform(0.4, max(nominal_extent - 0.4, 0.6), 3)
            * np.array([1, 1, 0.3]) for _ in range(n_instances)]
    area = (nominal_extent ** 2 + 2 * nominal_extent * wall_h
            + sum(2 * (s[0] * s[1] + s[0] * s[2] + s[1] * s[2])
                  for s in sizes))
    s_geo = float(np.sqrt(n_points / (point_density * area)))
    ext = nominal_extent * s_geo
    wall_h *= s_geo
    sizes = [s * s_geo for s in sizes]
    ctrs = [c * s_geo for c in ctrs]

    # point budget per surface proportional to its area
    a_floor = ext ** 2
    a_wall = ext * wall_h
    a_insts = [2 * (s[0] * s[1] + s[0] * s[2] + s[1] * s[2]) for s in sizes]
    a_tot = a_floor + 2 * a_wall + sum(a_insts)
    n_floor = int(n_points * a_floor / a_tot)
    n_wall = int(n_points * a_wall / a_tot)
    n_things = n_points - n_floor - 2 * n_wall

    pts[:n_floor, :3] = _grid_surface(
        rng, n_floor, (0, 0, 0), 0, 1, 2, ext, ext, pitch)
    w0 = n_floor
    pts[w0:w0 + n_wall, :3] = _grid_surface(
        rng, n_wall, (0, 0, 0), 0, 2, 1, ext, wall_h, pitch)
    w1 = w0 + n_wall
    pts[w1:w1 + n_wall, :3] = _grid_surface(
        rng, n_wall, (0, 0, 0), 1, 2, 0, ext, wall_h, pitch)

    sem = np.zeros(n_points, np.int64)
    sem[:n_floor] = 1            # floor
    sem[n_floor:w1 + n_wall] = 0  # walls
    inst = np.full(n_points, -1, np.int64)

    start = w1 + n_wall
    labels = []
    lo = start
    a_things = sum(a_insts)
    for i in range(n_instances):
        ctr, size = ctrs[i], sizes[i]
        m = (n_things - (lo - start)) if i == n_instances - 1 else \
            int(n_things * a_insts[i] / max(a_things, 1e-9))
        hi = lo + m
        # box surface, per-face points proportional to face area
        faces = []
        fa = [size[1] * size[2], size[1] * size[2],
              size[0] * size[2], size[0] * size[2],
              size[0] * size[1], size[0] * size[1]]
        per_face = [int(m * a / max(sum(fa), 1e-9)) for a in fa]
        per_face[0] += m - sum(per_face)
        for f, mf in enumerate(per_face):
            if mf <= 0:
                continue
            axis = f // 2
            ua, va = [a for a in range(3) if a != axis]
            org = ctr - size / 2
            if f % 2 == 1:
                org = org.copy()
                org[axis] += size[axis]
            faces.append(_grid_surface(rng, mf, org, ua, va, axis,
                                       size[ua], size[va], pitch))
        pts[lo:hi, :3] = np.concatenate(faces, 0)
        cls = rng.randint(n_stuff, n_classes)
        sem[lo:hi] = cls
        inst[lo:hi] = i
        labels.append(cls - n_stuff)
        lo = hi

    pts[:, 3:] = rng.randn(n_points, 3).astype(np.float32) * 0.5

    # superpoints: spatial grid cells split by (instance, semantic) label —
    # real superpoints (graph-cut mesh segmentation, segmentator) respect
    # object boundaries, so a pure-superpoint oracle reaches IoU ~1.0;
    # plain grid cells straddle instances and cap achievable point-IoU at
    # 0.3-0.7, making high-bar overfit tests impossible by construction
    cell = ext / max(2, int(np.sqrt(n_superpoints)))
    gkey = (np.floor(pts[:, 0] / cell).astype(np.int64) * 1000
            + np.floor(pts[:, 1] / cell).astype(np.int64) * 10
            + np.floor(pts[:, 2] / 1.0).astype(np.int64))
    label = np.where(inst >= 0, inst, 1000 + sem)   # pure per (inst|stuff-sem)
    key = gkey * 4096 + label
    ukeys, sp, counts = np.unique(key, return_inverse=True,
                                  return_counts=True)
    if len(ukeys) > n_superpoints:
        # merge the smallest grid cells into their label's largest cell so
        # the budget holds WITHOUT mixing labels (purity is the invariant)
        ulabel = (ukeys % 4096).astype(np.int64)
        order = np.argsort(counts)                   # smallest first
        remap = np.arange(len(ukeys))
        biggest = {}                                 # label -> largest key idx
        for i in np.argsort(-counts):
            biggest.setdefault(int(ulabel[i]), int(i))
        excess = len(ukeys) - n_superpoints
        for i in order:
            if excess <= 0:
                break
            tgt = biggest[int(ulabel[i])]
            if tgt != i:
                remap[i] = tgt
                excess -= 1
        _, remap2 = np.unique(remap[sp], return_inverse=True)
        sp = remap2
    assert int(sp.max()) < n_superpoints

    num_sp = int(sp.max()) + 1
    onehot_i = np.zeros((n_points, n_instances), bool)
    has = inst >= 0
    onehot_i[np.arange(n_points)[has], inst[has]] = True
    sp_inst = pool_to_superpoints(onehot_i, sp, num_sp)
    onehot_s = np.zeros((n_points, n_classes + 1), bool)
    onehot_s[np.arange(n_points), np.clip(sem, 0, n_classes)] = True
    sp_sem = pool_to_superpoints(onehot_s, sp, num_sp)
    sp_sem[sp_sem.sum(-1) == 0, -1] = True

    inst_merged = inst.copy()
    inst_merged[inst_merged != -1] += n_stuff
    for k in range(n_stuff):
        inst_merged[sem == k] = k

    # synthetic DINO-X features: class-correlated so training can learn
    pf = np.zeros((n_points, feat_dim_2d), np.float32)
    pf[np.arange(n_points), sem % feat_dim_2d] = 1.0
    pf += rng.randn(n_points, feat_dim_2d).astype(np.float32) * 0.1
    q2p = np.zeros((n_queries2d, 3), np.float32)
    q2f = rng.randn(n_queries2d, feat_dim_2d).astype(np.float32) * 0.1
    for k in range(min(n_queries2d, n_instances)):
        m = inst == k
        q2p[k] = pts[m, :3].mean(0)
        q2f[k, labels[k] % feat_dim_2d] += 1.0
    for k in range(n_instances, n_queries2d):
        q2p[k] = rng.uniform(0, ext, 3)

    return dict(
        scene_id=f"synth{seed:04d}",
        scene_idx=seed,
        points=pts,
        superpoint_ids=sp.astype(np.int64),
        point_inst_ids=inst,
        inst_labels=np.asarray(labels, np.int64),
        sp_inst_masks=sp_inst.T,   # (I, S)
        sp_sem_masks=sp_sem.T,     # (C+1, S)
        points_2dfeats=pf,
        query2d_feats=q2f,
        query2d_pos=q2p,
        elastic_coords=None,
        semantic_masks=sem,
        inst_merged=inst_merged,
    )


def write_scannet_layout(root: str, seeds, n_classes: int = 18,
                         features_2d: bool = True, **kw):
    """Write the scenes of ``seeds`` (``synthetic_scene`` with ``kw``) in
    the reference's .bin/.pth layout under ``root``, every scene in each of
    the train, val and test lists; returns the scene ids.  Without
    ``features_2d`` the DINO-X ``.pth`` files are not written (an rgb-only
    model's reader does not open them)."""
    import torch

    feat_root = os.path.join(root, "features_2d")
    for sub in ("meta_data", "points", "instance_mask", "semantic_mask",
                "super_points", "features_2d"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    ids = []
    for seed in seeds:
        rec = synthetic_scene(seed, n_classes=n_classes, **kw)
        sid = rec["scene_id"]
        ids.append(sid)
        for sub, key, dtype in (("points", "points", np.float32),
                                ("instance_mask", "point_inst_ids", np.int64),
                                ("semantic_mask", "semantic_masks", np.int64),
                                ("super_points", "superpoint_ids", np.int64)):
            rec[key].astype(dtype).tofile(os.path.join(root, sub,
                                                       f"{sid}.bin"))
        if not features_2d:
            continue
        torch.save([torch.tensor(rec["points_2dfeats"])],
                   os.path.join(feat_root, f"{sid}.pth"))
        torch.save(torch.tensor(rec["query2d_feats"]),
                   os.path.join(feat_root, f"{sid}_query_feats.pth"))
        torch.save(torch.tensor(rec["query2d_pos"]),
                   os.path.join(feat_root, f"{sid}_query_3dctr.pth"))
    for split in ("train", "val", "test"):
        with open(os.path.join(root, "meta_data", f"scannetv2_{split}.txt"),
                  "w") as f:
            f.write("\n".join(ids))
    return ids
