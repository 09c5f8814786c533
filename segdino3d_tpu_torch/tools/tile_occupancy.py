"""How much of a gather conv's tile work its neighbour tables need.

    python -m segdino3d_tpu_torch.tools.tile_occupancy

Builds the host plan of ``chip_smoke.py``'s main-path scene (120,000
points, seeded) on the CPU and prints, for the k5 stem table and each
level's k3 table, as shares of all (row, offset) pairs: the pairs that hold
a neighbour (the work the data needs); the work of a kernel that skips an
offset only for a whole tile (K1's first version), with rows in voxel order and
with rows sorted by their neighbour bit mask; the work of tiles that
compact their rows with a neighbour per offset into groups padded to 16
rows (to 8 beside it), with rows in voxel order and mask-sorted; and the
work of K1's pair-major items, each offset's live pairs in items of 64,
an offset's last item padded to 16 rows.  Counts, not times: no device.
"""
from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def tile_hit_share(nbr: np.ndarray, rows: np.ndarray, tile: int) -> float:
    """Share of (tile, offset) pairs with a neighbour, tiles of ``tile``
    consecutive entries of ``rows``."""
    n_tiles = -(-rows.shape[0] // tile)
    padded = np.full(n_tiles * tile, -1)
    padded[:rows.shape[0]] = rows
    padded = padded.reshape(n_tiles, tile)
    hit = np.where(padded[None] >= 0, nbr[:, np.maximum(padded, 0)], -1) >= 0
    return float(hit.any(-1).mean())


def compacted_share(nbr: np.ndarray, rows: np.ndarray, tile: int,
                    pad: int) -> float:
    """Share of (row, offset) pairs computed when each tile of ``tile``
    consecutive entries of ``rows`` multiplies, per offset, its rows with a
    neighbour there, padded to a multiple of ``pad``."""
    n_tiles = -(-rows.shape[0] // tile)
    padded = np.full(n_tiles * tile, -1)
    padded[:rows.shape[0]] = rows
    padded = padded.reshape(n_tiles, tile)
    live = np.where(padded[None] >= 0, nbr[:, np.maximum(padded, 0)], -1) >= 0
    work = -(-live.sum(-1) // pad) * pad
    return float(work.sum() / (nbr.shape[0] * rows.shape[0]))


def pair_major_share(nbr: np.ndarray) -> float:
    """Share of (row, offset) pairs computed by K1's items: each offset's
    live pairs, the last item of an offset padded to 16 rows."""
    counts = (nbr >= 0).sum(1)
    work = counts // 64 * 64 + -(-(counts % 64) // 16) * 16
    return float(work.sum() / nbr.size)


def mask_order(nbr: np.ndarray) -> np.ndarray:
    """Rows sorted by their neighbour bit mask (lexicographic)."""
    bits = np.packbits((nbr >= 0).T, axis=1)
    return np.lexsort(bits.T[::-1])


def main() -> int:
    import chip_smoke as C
    from segdino3d_tpu_torch.data.collate import _plan_coords
    from segdino3d_tpu_torch.data.synthetic import synthetic_scene
    from segdino3d_tpu_torch.ops import host_plan as H

    rec = synthetic_scene(0, **dict(C.SCENE, feat_dim_2d=8))
    coords, valid, bidx = _plan_coords([rec], C.SCENE["n_points"], 0.02)
    coords, valid = coords.reshape(-1, 3), valid.reshape(-1)
    cap = H.voxel_bucket(H.probe_voxel_count(coords, bidx, valid))
    caps = [max(256, -(-int(cap * r) // 256) * 256)
            for r in C.LEVEL_CAP_RATIOS]
    caps[0] = cap
    plan = H.build_host_plan(coords, bidx, valid, caps)
    # the kernel's tiles: 128 rows for Cout <= 32, else 64
    tables = [("stem k5 (L0, 128-row tiles)", plan.stem_nbr,
               plan.levels[0].num_voxels, 128)]
    tables += [(f"k3 L{i} (64-row tiles)", lv.subm_nbr, lv.num_voxels, 64)
               for i, lv in enumerate(plan.levels)]
    print(f"{'table':30s} {'pairs':>7s} {'tiles':>7s} "
          f"{'tiles, mask-sorted':>19s} {'compacted 16 (8)':>17s} "
          f"{'compacted 16, mask-sorted':>26s} {'K1 pair-major':>14s}")
    for name, nbr, n, tile in tables:
        nbr = nbr[:, :n]
        rows, order = np.arange(n), mask_order(nbr)
        print(f"{name:30s} {float((nbr >= 0).mean()):7.3f} "
              f"{tile_hit_share(nbr, rows, tile):7.3f} "
              f"{tile_hit_share(nbr, order, tile):19.3f} "
              f"{compacted_share(nbr, rows, tile, 16):9.3f} "
              f"({compacted_share(nbr, rows, tile, 8):.3f}) "
              f"{compacted_share(nbr, order, tile, 16):26.3f} "
              f"{pair_major_share(nbr):14.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
