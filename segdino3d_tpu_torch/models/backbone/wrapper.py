"""Backbone forward wrapper: points -> voxels -> U-Net -> superpoints.

Counterpart of the host-plan branch of
``segdino3d_tpu/models/backbone/wrapper.py:SparseBackboneWrapper``:

1. early-fuse per-point DINO-X features with rgb;
2. average point features into the plan's level-0 voxels (kernel K3);
3. run the sparse U-Net;
4. unpool voxel -> point and pool point -> superpoint in one fused K3
   launch, together with the superpoint centroids of the quantized point
   coordinates with and without elastic augmentation.  Its gradient (K5)
   walks the voxel CSR that step 2 builds.

Nothing here runs under ``no_grad``: in training mode the gradient flows
from the superpoint features back to every U-Net parameter.

The per-scene multiple-of-16 min shift of the conv grid lives where the
plan is built (``data.collate.attach_host_plan``); superpoint positions use
the unshifted coordinates, as in the JAX package.
"""
from __future__ import annotations

import torch
from torch import nn

from segdino3d_tpu_torch.gtypes import BackboneOutput, SceneBatch
from segdino3d_tpu_torch.ops import scatter


def superpoint_segment_ids(superpoint_ids: torch.Tensor, s_cap: int
                           ) -> torch.Tensor:
    """Global segment id (b * S + sp) for flattened points."""
    b = superpoint_ids.shape[0]
    sp = superpoint_ids.clamp(0, s_cap - 1)
    base = torch.arange(b, dtype=sp.dtype, device=sp.device)[:, None] * s_cap
    return (base + sp).reshape(-1)


class SparseBackboneWrapper(nn.Module):
    def __init__(self, unet: nn.Module, voxel_size: float = 0.02,
                 s_cap: int = 1024, mode_fuse_2d_feat: str = "early_fusion",
                 compute_dtype: str = "float32"):
        super().__init__()
        self.unet = unet
        self.voxel_size = voxel_size
        self.s_cap = s_cap
        self.mode_fuse_2d_feat = mode_fuse_2d_feat
        self.compute_dtype = getattr(torch, compute_dtype)

    def forward(self, batch: SceneBatch) -> BackboneOutput:
        if batch.plan is None:
            raise ValueError("the port runs on host-built plans: call "
                             "data.collate.attach_host_plan first")
        b, p = batch.points.shape[:2]
        n = b * p
        s_cap = self.s_cap
        pts = batch.points.reshape(n, 6)
        pvalid = batch.point_valid.reshape(n)
        if batch.elastic_coords is not None:
            coords_vox = batch.elastic_coords.reshape(n, 3)   # voxel units
        else:
            coords_vox = pts[:, :3] / self.voxel_size

        feats = pts[:, 3:]
        if (self.mode_fuse_2d_feat == "early_fusion"
                and batch.points_2dfeats is not None):
            feats = torch.cat(
                [feats, batch.points_2dfeats.reshape(n, -1).float()], dim=-1)
        feats = feats.to(self.compute_dtype).contiguous()

        plan = batch.plan
        valid0 = plan.levels[0].valid
        v0 = valid0.shape[0]
        inverse = plan.inverse          # -1: the point has no voxel
        vox_csr = scatter.segment_csr(inverse, v0, pvalid)
        vox_feats = scatter.segment_mean(feats, inverse, v0, pvalid,
                                         csr=vox_csr)
        vox_feats = torch.where(valid0[:, None], vox_feats, 0.0)
        vox_out = self.unet(vox_feats, plan)

        seg = superpoint_segment_ids(batch.superpoint_ids, s_cap)
        q_with = torch.floor(coords_vox).float() * self.voxel_size
        q_wo = torch.floor(pts[:, :3] / self.voxel_size).float() \
            * self.voxel_size
        sp_feats, sp_pos, sp_pos_wo = scatter.pool_gathered(
            vox_out, inverse, [q_with, q_wo], seg, b * s_cap, pvalid,
            vox_csr=vox_csr)

        sp_valid = (torch.arange(s_cap, device=pts.device)[None, :]
                    < batch.num_superpoints[:, None])
        m = sp_valid[..., None]
        return BackboneOutput(
            sp_feats=torch.where(m, sp_feats.reshape(b, s_cap, -1), 0.0),
            sp_pos=torch.where(m, sp_pos.reshape(b, s_cap, 3), 0.0),
            sp_pos_wo_elastic=torch.where(m, sp_pos_wo.reshape(b, s_cap, 3),
                                          0.0),
            sp_valid=sp_valid)
