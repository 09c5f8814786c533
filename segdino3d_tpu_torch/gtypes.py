"""Batch containers for the 3D instance-seg pipeline.

Counterpart of ``segdino3d_tpu/gtypes.py``: a batch is a set of padded,
statically shaped tensors with validity masks.  Shape symbols: B scenes,
P points, S superpoints, I instances, K 2D (DINO-X) object queries,
C_sem semantic classes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from segdino3d_tpu_torch.ops.host_plan import UNetPlan


@dataclass
class SceneBatch:
    """One batch of padded scenes."""

    # geometry + appearance
    points: torch.Tensor              # (B, P, 6) xyz + normalized rgb
    point_valid: torch.Tensor         # (B, P) bool
    superpoint_ids: torch.Tensor      # (B, P) int32 in [0, S)
    num_superpoints: torch.Tensor     # (B,) int32
    # precomputed DINO-X features
    points_2dfeats: Optional[torch.Tensor] = None   # (B, P, 256)
    query2d_feats: Optional[torch.Tensor] = None    # (B, K, 256)
    query2d_pos: Optional[torch.Tensor] = None      # (B, K, 3)
    query2d_valid: Optional[torch.Tensor] = None    # (B, K) bool
    # elastic augmentation (voxel units)
    elastic_coords: Optional[torch.Tensor] = None   # (B, P, 3)
    elastic_query2d_pos: Optional[torch.Tensor] = None  # (B, K, 3)
    # ground truth
    inst_labels: Optional[torch.Tensor] = None      # (B, I) int32
    inst_valid: Optional[torch.Tensor] = None       # (B, I) bool
    point_inst_ids: Optional[torch.Tensor] = None   # (B, P) int32, -1 = none
    sp_inst_masks: Optional[torch.Tensor] = None    # (B, I, S) bool
    sp_sem_masks: Optional[torch.Tensor] = None     # (B, C_sem+1, S) bool
    scene_idx: Optional[torch.Tensor] = None        # (B,) int32
    # host-built sparse-conv plan (ops.host_plan)
    plan: Optional[UNetPlan] = None

    @property
    def batch_size(self) -> int:
        return self.points.shape[0]

    @property
    def num_points(self) -> int:
        return self.points.shape[1]

    @property
    def sp_capacity(self) -> int:
        return self.sp_inst_masks.shape[2] if self.sp_inst_masks is not None \
            else 0


@dataclass
class BackboneOutput:
    """Superpoint-level features + positions (padded dense batch)."""
    sp_feats: torch.Tensor            # (B, S, C)
    sp_pos: torch.Tensor              # (B, S, 3) centroids (with elastic)
    sp_pos_wo_elastic: torch.Tensor   # (B, S, 3) centroids (raw coords)
    sp_valid: torch.Tensor            # (B, S) bool
