"""Voxelization on the device, and voxel -> point unpooling.

Counterpart of ``segdino3d_tpu/ops/voxelize.py``.  ``voxelize`` is the
first step of the on-device plan engine: floor-quantize the points, pack
their keys (``ops.keys``), insert them into the coordinate hash (K6,
``ops.hashing``) and compact the winners, the points whose key's smallest
row is their own, into voxel ids in first-occurrence order (K8,
``csrc/voxel_compact.cu``, through ``voxel_compact``).  It returns the
inverse map, the voxel coordinates and the voxel count, which stays on the
device.  The feature mean is not part of it: the backbone wrapper averages
with K3 over the inverse map, as on a host plan (the JAX ``voxelize`` sums
then divides, the same function in another summation order).

``devoxelize`` serves callers that need per-point features; on the main
path the unpooling is fused into the superpoint pooling kernel
(``ops.scatter.pool_gathered``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from segdino3d_tpu_torch.ops import cuda_build
from segdino3d_tpu_torch.ops import keys as K
from segdino3d_tpu_torch.ops.hashing import CoordHash, build_and_lookup

ROWS_PER_BLOCK = 1024   # K8's rows per thread block in its flags pass


def compact_scratch(n: int) -> int:
    """Ints of K8's scratch for n rows: the count, then per 32-row word its
    winner bits and the winners before it in its block, then per block its
    count."""
    return 1 + 2 * -(-n // 32) + -(-n // ROWS_PER_BLOCK)


class Compaction(NamedTuple):
    inverse: torch.Tensor          # (N,) int32 row -> voxel id, -1 none/dropped
    coords_T: torch.Tensor         # (4, cap) int32 (b, x, y, z), 0 past count
    valid: torch.Tensor            # (cap,) bool
    num_voxels: torch.Tensor       # () int32, may exceed cap
    kpos: Optional[torch.Tensor]   # (N,) int32 slot in the 2x2x2 block
    hash: CoordHash                # values remapped to voxel ids


def voxel_compact_plain(winner: torch.Tensor, coords_T: torch.Tensor,
                        cap: int, shift: int, h: CoordHash,
                        with_kpos: bool = False) -> Compaction:
    """Plain version of K8: ``torch.cumsum`` over the winner flags."""
    n, dev = winner.shape[0], winner.device
    rows = torch.arange(n, device=dev, dtype=torch.int32)
    is_w = winner == rows
    vid = (torch.cumsum(is_w.to(torch.int32), 0) - 1).to(torch.int32)
    num = is_w.sum().to(torch.int32)
    inverse = torch.where(winner >= 0,
                          vid[winner.clamp(0, max(n - 1, 0)).long()], -1)
    inverse = torch.where(inverse < cap, inverse, -1).to(torch.int32)
    slot = torch.where(is_w & (vid < cap), vid, cap).long()
    shifted = torch.cat([coords_T[:1], coords_T[1:] >> shift])
    out = torch.zeros(4, cap + 1, dtype=torch.int32, device=dev)
    out[:, slot] = shifted
    kpos = None
    if with_kpos:
        kpos = (((coords_T[1] & 1) << 2) | ((coords_T[2] & 1) << 1)
                | (coords_T[3] & 1)).to(torch.int32)
    stored = (h.vals >= 0) & (h.vals < n)
    vals = torch.where(stored, vid[h.vals.clamp(0, max(n - 1, 0)).long()], -1)
    return Compaction(
        inverse=inverse, coords_T=out[:, :cap].contiguous(),
        valid=torch.arange(cap, device=dev) < num, num_voxels=num, kpos=kpos,
        hash=h._replace(vals=vals.to(torch.int32)))


def voxel_compact(winner: torch.Tensor, coords_T: torch.Tensor, cap: int,
                  shift: int, h: CoordHash, with_kpos: bool = False
                  ) -> Compaction:
    """Voxel ids of the winners (rows r with ``winner[r] == r``) in row
    order, for rows with coordinates ``coords_T`` (4, N) int32; the voxel
    coordinates are the winners' with x, y, z shifted right by ``shift``.
    The returned hash is ``h`` with its values mapped from rows to voxel
    ids; ``h`` itself is left as it was."""
    n = winner.shape[0]
    if winner.dtype != torch.int32 or coords_T.dtype != torch.int32 \
            or coords_T.shape != (4, n):
        raise TypeError("voxel_compact: winner (N,) and coords_T (4, N) must "
                        "be int32")
    if winner.is_cpu:
        return voxel_compact_plain(winner, coords_T, cap, shift, h, with_kpos)
    dev = winner.get_device()
    if not (coords_T.get_device() == h.vals.get_device() == dev
            and winner.is_contiguous() and coords_T.is_contiguous()
            and h.vals.is_contiguous()):
        raise ValueError("voxel_compact: tensors must be contiguous and on "
                         "one CUDA device")
    # one int32 allocation for the outputs and the scratch (the wrapper's
    # host time is most of a call's)
    t_size = h.vals.shape[0]
    sizes = (n, 4 * cap, t_size, compact_scratch(n)) + ((n,) if with_kpos
                                                        else ())
    parts = torch.empty(sum(sizes), dtype=torch.int32,
                        device=winner.device).split(sizes)
    inverse, out, vals, ws = parts[:4]
    kpos = parts[4] if with_kpos else None
    valid = torch.empty(cap, dtype=torch.bool, device=winner.device)
    cuda_build.check(cuda_build.library("voxel_compact").voxel_compact(
        winner.data_ptr(), coords_T.data_ptr(), n, shift, cap, ws.data_ptr(),
        inverse.data_ptr(), None if kpos is None else kpos.data_ptr(),
        out.data_ptr(), valid.data_ptr(), h.vals.data_ptr(), vals.data_ptr(),
        t_size, cuda_build.stream_ptr(winner)), "voxel_compact")
    voxel_compact.launches += 1
    return Compaction(inverse, out.view(4, cap), valid, ws[0], kpos,
                      CoordHash(h.keys, vals, h.overflow))


voxel_compact.launches = 0


class VoxelGrid(NamedTuple):
    """A batch-flattened sparse voxel tensor (level 0 of the pyramid)."""
    coords_T: torch.Tensor         # (4, V) int32 (b, x, y, z); 0 past count
    valid: torch.Tensor            # (V,) bool
    hash: CoordHash                # key -> voxel id
    num_voxels: torch.Tensor       # () int32, may exceed V (overflow)
    inverse_mapping: torch.Tensor  # (N,) int32 point -> voxel id, -1 none
    overflow: torch.Tensor         # () bool: a capacity was exceeded


def point_keys(batch_idx: torch.Tensor, coords_f: torch.Tensor,
               valid: torch.Tensor):
    """(cols (4, N) int32 (b, x, y, z), keys (N,) int64) of the points'
    voxels: ``ijk = max(floor(coords), 0)``."""
    ijk = torch.floor(coords_f).clamp(min=0).to(torch.int32)
    cols = torch.cat([batch_idx.to(torch.int32)[None], ijk.T]).contiguous()
    return cols, K.pack_columns_u32(cols[0], cols[1], cols[2], cols[3], valid)


def voxelize(batch_idx: torch.Tensor, coords_f: torch.Tensor,
             valid: torch.Tensor, num_voxels_static: Optional[int] = None
             ) -> VoxelGrid:
    """Quantize points into a sparse voxel grid.

    batch_idx (N,) scene index per point; coords_f (N, 3) float coordinates
    in voxel units, min-shifted to be >= 0 by the caller; valid (N,) bool;
    ``num_voxels_static`` the voxel capacity V (default N).  A voxel whose
    id reaches V is dropped: its points map to -1 and ``overflow`` is set,
    as it is for a valid point outside the key's range."""
    n = coords_f.shape[0]
    v_cap = num_voxels_static or n
    cols, key = point_keys(batch_idx, coords_f, valid)
    h, winner = build_and_lookup(key, capacity=min(v_cap, n))
    comp = voxel_compact(winner, cols, v_cap, 0, h)
    out_of_range = (valid & (key == K.SENTINEL)).any()
    return VoxelGrid(
        coords_T=comp.coords_T, valid=comp.valid, hash=comp.hash,
        num_voxels=comp.num_voxels, inverse_mapping=comp.inverse,
        overflow=h.overflow | (comp.num_voxels > v_cap) | out_of_range)


def devoxelize(vox_feats: torch.Tensor, inverse_mapping: torch.Tensor,
               point_valid: torch.Tensor) -> torch.Tensor:
    """(V, C) voxel rows -> (N, C) point rows; -1 and invalid points -> 0."""
    padded = torch.cat([vox_feats, vox_feats.new_zeros(1, vox_feats.shape[1])])
    idx = torch.where(inverse_mapping < 0, vox_feats.shape[0],
                      inverse_mapping).long()
    return torch.where(point_valid[:, None], padded[idx], 0.0)
