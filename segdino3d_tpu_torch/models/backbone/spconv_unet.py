"""SpConvUNet backbone (the ScanNet v2 config family).

Counterpart of ``segdino3d_tpu/models/backbone/spconv_unet.py``: the
SPFormer-style U-Net unrolled onto the same 5-level plan as Res16UNet34C.
A k3 submanifold ``input_conv`` (rgb + centred xyz + DINO-X = 262 -> 32
channels), per level ``block_reps`` pre-norm residual blocks, before each
stride-2 down conv a batch norm and ReLU, on the way up a batch norm, ReLU
and the up conv, then the concatenation ``[skip, x]`` (the reverse of
Res16UNet34C's ``[x, skip]``) into ``block_reps`` tail blocks, and last a
batch norm and ReLU.  Planes (32, 64, 96, 128, 160); batch norms with eps
1e-4 and momentum 0.1.

Every conv runs through the level's context (``make_level_ctxs``), so the
gather layout's kernels K1 (subm and down convs, the input gradients of
the subm and up convs), K2 (up convs, the down convs' input gradient) and
K4 (weight gradients) carry it; the stem is level 0's k3 table.  Module
names mirror the flax tree through ``convert.py`` (``blocks_l0_1`` ->
``blocks_l0.1``, ``down_norm_2`` -> ``down_norm.2``).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from segdino3d_tpu_torch.models.backbone.res16unet import (DownConv,
                                                           SubMConv, UpConv,
                                                           make_level_ctxs)
from segdino3d_tpu_torch.models.layers import MaskedBatchNorm, linear
from segdino3d_tpu_torch.ops.host_plan import UNetPlan


class PreNormResidualBlock(nn.Module):
    """norm1 -> ReLU -> conv1 -> norm2 -> ReLU -> conv2, plus the identity
    branch: ``x`` itself, or a bias-free linear map of ``x`` where the
    channel count changes (``i_branch``); no final ReLU."""

    def __init__(self, cin: int, planes: int, bn_momentum: float,
                 bn_eps: float):
        super().__init__()
        self.norm1 = MaskedBatchNorm(cin, eps=bn_eps, momentum=bn_momentum)
        self.conv1 = SubMConv(cin, planes)
        self.norm2 = MaskedBatchNorm(planes, eps=bn_eps, momentum=bn_momentum)
        self.conv2 = SubMConv(planes, planes)
        if cin != planes:
            self.i_branch = nn.Linear(cin, planes, bias=False)

    def forward(self, x, ctx):
        h = self.conv1(F.relu(self.norm1(x, ctx.valid)), ctx)
        h = self.conv2(F.relu(self.norm2(h, ctx.valid)), ctx)
        # in x's dtype: a bf16 input stays bf16 end to end
        ident = linear(x, self.i_branch) if hasattr(self, "i_branch") else x
        return h + ident


class SpConvUNet(nn.Module):
    stem_kernel = 3

    def __init__(self, num_planes: Sequence[int] = (32, 64, 96, 128, 160),
                 block_reps: int = 2, in_channels: int = 262,
                 bn_momentum: float = 0.1, bn_eps: float = 1e-4):
        super().__init__()
        planes = tuple(num_planes)
        self.num_planes = planes

        def bn(c):
            return MaskedBatchNorm(c, eps=bn_eps, momentum=bn_momentum)

        def blocks(cin, c):
            return nn.ModuleList(
                PreNormResidualBlock(cin if r == 0 else c, c, bn_momentum,
                                     bn_eps) for r in range(block_reps))

        n = len(planes)
        self.input_conv = SubMConv(in_channels, planes[0])
        for l in range(n):
            setattr(self, f"blocks_l{l}", blocks(planes[l], planes[l]))
        self.down_norm = nn.ModuleList(bn(planes[l]) for l in range(n - 1))
        self.down_conv = nn.ModuleList(DownConv(planes[l], planes[l + 1])
                                       for l in range(n - 1))
        self.up_norm = nn.ModuleList(bn(planes[l + 1]) for l in range(n - 1))
        self.up_conv = nn.ModuleList(UpConv(planes[l + 1], planes[l])
                                     for l in range(n - 1))
        for l in range(n - 1):
            setattr(self, f"tail_l{l}", blocks(2 * planes[l], planes[l]))
        self.output_norm = bn(planes[0])

    def forward(self, feats: torch.Tensor, plan: UNetPlan) -> torch.Tensor:
        """feats: (V0, in_channels) level-0 voxel features."""
        n = len(self.num_planes)
        lv = plan.levels
        if len(lv) < n:
            raise ValueError(f"SpConvUNet: {n} levels, the plan has {len(lv)}")
        ctxs, _ = make_level_ctxs(plan)
        x = self.input_conv(ctxs[0].enter(feats), ctxs[0])

        skips = []
        for l in range(n):
            for block in getattr(self, f"blocks_l{l}"):
                x = block(x, ctxs[l])
            if l < n - 1:
                skips.append(x)
                h = F.relu(self.down_norm[l](x, ctxs[l].valid))
                x = self.down_conv[l](ctxs[l].exit(h), lv[l], lv[l + 1])
                x = ctxs[l + 1].enter(x)

        for l in range(n - 2, -1, -1):
            h = F.relu(self.up_norm[l](x, ctxs[l + 1].valid))
            x = ctxs[l].enter(self.up_conv[l](ctxs[l + 1].exit(h), lv[l]))
            x = torch.cat([skips[l], x], -1)
            for block in getattr(self, f"tail_l{l}"):
                x = block(x, ctxs[l])

        x = F.relu(self.output_norm(x, ctxs[0].valid))
        return ctxs[0].exit(x)
