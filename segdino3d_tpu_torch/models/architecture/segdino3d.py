"""SegDINO3D architecture, eval branch: backbone -> queries -> decoder.

Counterpart of ``segdino3d_tpu/models/architecture/segdino3d.py``: the scene
range (and GT instance centers/sizes) from elastic-or-raw coordinates, and
the eval forward in which every superpoint is a query.  Training-time query
subsampling and the top-k query selection are not ported.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from segdino3d_tpu_torch.gtypes import BackboneOutput, SceneBatch


def _scene_coords(batch: SceneBatch, voxel_size: float) -> torch.Tensor:
    if batch.elastic_coords is not None:
        return batch.elastic_coords * voxel_size
    return batch.points[..., :3]


def scene_range(batch: SceneBatch, voxel_size: float) -> torch.Tensor:
    """(B, 2, 3) per-scene [min, max] over valid points."""
    coords = _scene_coords(batch, voxel_size)
    pv = batch.point_valid[..., None]
    mins = torch.where(pv, coords, 1e9).amin(dim=1)
    maxs = torch.where(pv, coords, -1e9).amax(dim=1)
    return torch.stack([mins, maxs], dim=1)


def compute_scene_range_and_boxes(batch: SceneBatch, voxel_size: float,
                                  mode_3d_center: str = "median"):
    """Scene [min, max] + GT instance centers/sizes (B, I, 3)."""
    rng = scene_range(batch, voxel_size)
    if batch.point_inst_ids is None:
        return rng, None, None
    coords = _scene_coords(batch, voxel_size)
    b = coords.shape[0]
    i_cap = batch.inst_labels.shape[1]
    ids = batch.point_inst_ids.long()
    valid = (batch.point_valid & (ids >= 0)).reshape(-1)
    seg = (torch.arange(b, device=ids.device)[:, None] * i_cap
           + ids.clamp(0, i_cap - 1)).reshape(-1)
    seg = torch.where(valid, seg, b * i_cap)     # dump slot
    flat = coords.reshape(-1, 3)
    idx = seg[:, None].expand(-1, 3)
    n_seg = b * i_cap + 1
    imin = flat.new_full((n_seg, 3), float("inf")).scatter_reduce(
        0, idx, flat, "amin")[:-1]
    imax = flat.new_full((n_seg, 3), float("-inf")).scatter_reduce(
        0, idx, flat, "amax")[:-1]
    cnt = torch.bincount(seg, minlength=n_seg)[:-1].reshape(b, i_cap)
    if mode_3d_center == "median":
        ctr = (imax + imin) / 2
    elif mode_3d_center == "mean":
        summ = flat.new_zeros(n_seg, 3).index_add_(0, seg, flat)[:-1]
        ctr = summ / cnt.reshape(-1, 1).clamp(min=1).to(flat.dtype)
    else:
        raise ValueError(mode_3d_center)
    has = (cnt > 0)[..., None]
    centers = torch.where(has, ctr.reshape(b, i_cap, 3), 0.0)
    sizes = torch.where(has, (imax - imin).reshape(b, i_cap, 3), 0.0)
    return rng, centers, sizes


class SegDINO3D(nn.Module):
    def __init__(self, backbone: nn.Module, decoder: nn.Module,
                 voxel_size: float = 0.02):
        super().__init__()
        self.backbone = backbone
        self.decoder = decoder
        self.voxel_size = voxel_size

    def forward(self, batch: SceneBatch) -> Dict[str, Any]:
        """Eval forward: every valid superpoint is a query."""
        return self.decode(batch, self.backbone(batch))

    def decode(self, batch: SceneBatch, bb: BackboneOutput) -> Dict[str, Any]:
        """The decoder half of ``forward`` on the backbone's output."""
        rng = scene_range(batch, self.voxel_size)
        b, s = bb.sp_valid.shape
        outputs = self.decoder(
            sp_feats=bb.sp_feats, sp_valid=bb.sp_valid, sp_pos=bb.sp_pos,
            sp_pos_wo_elastic=bb.sp_pos_wo_elastic,
            queries_feat=bb.sp_feats, query_valid=bb.sp_valid,
            queries_pos=bb.sp_pos, dinox_queries=batch.query2d_feats,
            dinox_query_pos=batch.query2d_pos,
            dinox_valid=batch.query2d_valid, scene_range=rng)
        outputs["scene_range"] = rng
        outputs["sp_valid"] = bb.sp_valid
        outputs["query_sp_idx"] = torch.arange(
            s, dtype=torch.int32, device=rng.device).expand(b, s)
        outputs["sp_pos_wo_elastic"] = bb.sp_pos_wo_elastic
        return outputs
