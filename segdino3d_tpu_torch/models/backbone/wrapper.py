"""Backbone forward wrapper: points -> voxels -> U-Net -> superpoints.

Counterpart of ``segdino3d_tpu/models/backbone/wrapper.py:
SparseBackboneWrapper``:

1. early-fuse per-point features: rgb, on the SpConvUNet path
   (``include_centered_xyz``) the xyz centred on the scene's mean over its
   valid points, and the DINO-X features, as the voxel mean's column
   sources, each read in its own dtype: no (N, 259) or (N, 262) tensor;
2. take the batch's host plan or, when the batch has none, build the plan
   on the device of its tensors (``device_plan``: the per-scene min shift
   of the conv grid, then ``voxelize`` and ``build_unet_plan``, kernels
   K6-K8).  The shift is the valid points' minimum rounded down to a
   multiple of 16 (Res16UNet34C), or with ``exact_min_shift``
   (SpConvUNet) the minimum itself, subtracted in metric space before the
   division by the voxel size, as the reference quantizes
   ``(p - p.min(0)) / voxel``;
3. average point features into the plan's level-0 voxels (kernel K3),
   each element rounded to the compute dtype first;
4. run the sparse U-Net;
5. unpool voxel -> point and pool point -> superpoint in one fused K3
   launch, together with the superpoint centroids of the quantized point
   coordinates with and without elastic augmentation.  Its gradient (K5)
   walks the voxel CSR that step 3 builds.

Nothing here runs under ``no_grad``: in training mode the gradient flows
from the superpoint features back to every U-Net parameter.

A host plan carries the same min shift (``data.collate.attach_host_plan``);
superpoint positions use the unshifted coordinates, as in the JAX package.
``overflow`` in the output is set when a device plan outgrew a capacity (a
host plan raises on overflow when it is built).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from segdino3d_tpu_torch.gtypes import BackboneOutput, SceneBatch
from segdino3d_tpu_torch.models.backbone.res16unet import build_unet_plan
from segdino3d_tpu_torch.ops import scatter
from segdino3d_tpu_torch.ops.host_plan import UNetPlan
from segdino3d_tpu_torch.ops.voxelize import voxelize

# raised by the eval driver and the training step when ``overflow`` is set
DEVICE_PLAN_OVERFLOW = ("device plan capacity overflow — raise "
                        "Capacities.num_voxels or level_cap_ratios")


def superpoint_segment_ids(superpoint_ids: torch.Tensor, s_cap: int
                           ) -> torch.Tensor:
    """Global segment id (b * S + sp) for flattened points."""
    b = superpoint_ids.shape[0]
    sp = superpoint_ids.clamp(0, s_cap - 1)
    base = torch.arange(b, dtype=sp.dtype, device=sp.device)[:, None] * s_cap
    return (base + sp).reshape(-1)


def voxel_units(xyz: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """``xyz / voxel_size`` as a true division, as numpy's in the host
    plan: a CUDA tensor divided by a Python scalar is multiplied by its
    reciprocal, which can floor a point into the neighbouring voxel."""
    return xyz / torch.full((), voxel_size, device=xyz.device)


def min_shift(coords_vox: torch.Tensor, point_valid: torch.Tensor,
              exact: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scene index (B*P,) int32, coordinates (B*P, 3) shifted per scene by
    the valid points' minimum): rounded down to a multiple of 16, a
    lattice translation that keeps every level's 2x grouping, so the keys
    stay non-negative without changing the voxels; with ``exact`` the
    minimum itself."""
    b, p = point_valid.shape
    per_scene = coords_vox.reshape(b, p, 3)
    masked = torch.where(point_valid[..., None], per_scene, 1e9)
    mins = masked.amin(dim=1)
    if not exact:
        mins = torch.floor(mins / 16.0) * 16.0
    bidx = torch.arange(b, dtype=torch.int32, device=coords_vox.device
                        )[:, None].expand(b, p).reshape(-1)
    return bidx, (per_scene - mins[:, None, :]).reshape(b * p, 3)


class SparseBackboneWrapper(nn.Module):
    """``voxel_cap`` is the device plan's level-0 voxel capacity (``None``:
    the batch's point count) and ``level_cap_ratios`` each level's share of
    it, rounded up to a multiple of 256 and at least 256, as in the JAX
    wrapper.  The stem's kernel size is the U-Net's.  The SpConvUNet path
    sets ``include_centered_xyz`` and ``exact_min_shift`` (see the module
    docstring)."""

    def __init__(self, unet: nn.Module, level_cap_ratios: Sequence[float],
                 voxel_size: float = 0.02, s_cap: int = 1024,
                 mode_fuse_2d_feat: str = "early_fusion",
                 compute_dtype: str = "float32",
                 voxel_cap: Optional[int] = None,
                 include_centered_xyz: bool = False,
                 exact_min_shift: bool = False):
        super().__init__()
        self.unet = unet
        self.voxel_size = voxel_size
        self.s_cap = s_cap
        self.mode_fuse_2d_feat = mode_fuse_2d_feat
        self.compute_dtype = getattr(torch, compute_dtype)
        self.voxel_cap = voxel_cap
        self.level_cap_ratios = tuple(level_cap_ratios)
        self.include_centered_xyz = include_centered_xyz
        self.exact_min_shift = exact_min_shift

    def device_plan(self, xyz: torch.Tensor, point_valid: torch.Tensor,
                    elastic_coords: Optional[torch.Tensor] = None
                    ) -> Tuple[UNetPlan, torch.Tensor]:
        """(plan, overflow) built on the device of ``xyz`` (B*P, 3), metric,
        for the points ``point_valid`` (B, P); the grid is the elastic
        coordinates' (voxel units) where they are given."""
        if elastic_coords is not None:
            bidx, shifted = min_shift(elastic_coords.reshape(-1, 3),
                                      point_valid, self.exact_min_shift)
        elif self.exact_min_shift:
            # the minimum subtracted in metric space, then divided
            bidx, shifted = min_shift(xyz, point_valid, exact=True)
            shifted = voxel_units(shifted, self.voxel_size)
        else:
            bidx, shifted = min_shift(voxel_units(xyz, self.voxel_size),
                                      point_valid)
        grid = voxelize(bidx, shifted, point_valid.reshape(-1),
                        num_voxels_static=self.voxel_cap)
        v0 = grid.coords_T.shape[1]
        caps = [max(256, -(-int(v0 * r) // 256) * 256)
                for r in self.level_cap_ratios]
        caps[0] = v0
        return build_unet_plan(grid, num_levels=5,
                               stem_kernel=self.unet.stem_kernel,
                               level_caps=caps)

    def forward(self, batch: SceneBatch) -> BackboneOutput:
        b, p = batch.points.shape[:2]
        n = b * p
        s_cap = self.s_cap
        pts = batch.points.reshape(n, 6)
        pvalid = batch.point_valid.reshape(n)
        raw_vox = voxel_units(pts[:, :3], self.voxel_size)
        coords_vox = raw_vox if batch.elastic_coords is None \
            else batch.elastic_coords.reshape(n, 3)   # voxel units

        # the early-fused point features [rgb | centred xyz | 2D features],
        # as column sources of the voxel mean: never concatenated on the card
        feats = [pts[:, 3:]]
        if self.include_centered_xyz:
            xyz = batch.points[..., :3]
            w = batch.point_valid[..., None].to(xyz.dtype)
            mean = (xyz * w).sum(1) / w.sum(1).clamp(min=1.0)
            feats.append((xyz - mean[:, None, :]).reshape(n, 3))
        if (self.mode_fuse_2d_feat == "early_fusion"
                and batch.points_2dfeats is not None):
            feats.append(batch.points_2dfeats.reshape(n, -1))

        if batch.plan is not None:
            plan = batch.plan
            overflow = torch.zeros((), dtype=torch.bool, device=pts.device)
        else:
            plan, overflow = self.device_plan(pts[:, :3], batch.point_valid,
                                              batch.elastic_coords)
        valid0 = plan.levels[0].valid
        v0 = valid0.shape[0]
        inverse = plan.inverse          # -1: the point has no voxel
        vox_csr = scatter.segment_csr(inverse, v0, pvalid)
        vox_feats = scatter.segment_mean_columns(
            feats, inverse, v0, self.compute_dtype, pvalid, csr=vox_csr)
        vox_feats = torch.where(valid0[:, None], vox_feats, 0.0)
        vox_out = self.unet(vox_feats, plan)

        seg = superpoint_segment_ids(batch.superpoint_ids, s_cap)
        q_with = torch.floor(coords_vox).float() * self.voxel_size
        q_wo = torch.floor(raw_vox).float() * self.voxel_size
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
            sp_valid=sp_valid, overflow=overflow)
