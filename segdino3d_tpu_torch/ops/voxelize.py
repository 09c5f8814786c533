"""Voxel -> point unpooling (ME ``x.slice(field)``).

Counterpart of ``segdino3d_tpu/ops/voxelize.py:devoxelize``.  On the main
path the unpooling is fused into the superpoint pooling kernel
(``ops.scatter.pool_gathered``); this standalone form serves callers that
need the per-point features themselves.
"""
from __future__ import annotations

import torch


def devoxelize(vox_feats: torch.Tensor, inverse_mapping: torch.Tensor,
               point_valid: torch.Tensor) -> torch.Tensor:
    """(V, C) voxel rows -> (N, C) point rows; -1 and invalid points -> 0."""
    padded = torch.cat([vox_feats, vox_feats.new_zeros(1, vox_feats.shape[1])])
    idx = torch.where(inverse_mapping < 0, vox_feats.shape[0],
                      inverse_mapping).long()
    return torch.where(point_valid[:, None], padded[idx], 0.0)
