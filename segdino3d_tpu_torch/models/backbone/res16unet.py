"""Res16UNet34C sparse U-Net backbone, gather layout.

Counterpart of ``segdino3d_tpu/models/backbone/res16unet.py`` over
``GatherCtx`` levels: a k5 stem, 4 stride-2 down stages with BasicBlock
stacks LAYERS=(2,3,4,6,2,2,2,2), 4 transposed up stages with skip
concatenation, PLANES=(32,64,128,256,256,128,96,96), 96-channel output.
Every convolution runs through ``ops.sparse_conv`` (kernels K1 and K2
forward, K1, K2 and K4 backward).  ``module.train()`` puts every batch
norm in training mode; ``config["bn_momentum"]`` (default 0.02, as in the
JAX package) sets their momentum.  Module and parameter names mirror the
flax tree (``convert.py``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from segdino3d_tpu_torch.models.layers import MaskedBatchNorm, linear
from segdino3d_tpu_torch.ops import sparse_conv as SC
from segdino3d_tpu_torch.ops.host_plan import Level, UNetPlan


class SubMConv(nn.Module):
    """Submanifold conv; ``kernel`` (k^3, Cin, Cout), canonical order."""

    def __init__(self, cin: int, cout: int, kernel_volume: int = 27):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(kernel_volume, cin, cout))

    def forward(self, feats, nbr, valid):
        return SC.subm_conv(feats, nbr, self.kernel.to(feats.dtype), valid)


class DownConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(8, cin, cout))

    def forward(self, feats, fine: Level, coarse: Level):
        return SC.down_conv(feats, fine, coarse, self.kernel.to(feats.dtype))


class UpConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(8, cin, cout))

    def forward(self, feats, fine: Level):
        return SC.up_conv(feats, fine, self.kernel.to(feats.dtype))


class BasicBlock(nn.Module):
    """Minkowski BasicBlock with an optional 1x1 residual projection."""

    def __init__(self, cin: int, planes: int, bn_momentum: float):
        super().__init__()
        self.conv1 = SubMConv(cin, planes)
        self.norm1 = MaskedBatchNorm(planes, momentum=bn_momentum)
        self.conv2 = SubMConv(planes, planes)
        self.norm2 = MaskedBatchNorm(planes, momentum=bn_momentum)
        if cin != planes:
            self.downsample_conv = nn.Linear(cin, planes, bias=False)
            self.downsample_norm = MaskedBatchNorm(planes,
                                                   momentum=bn_momentum)

    def forward(self, x, level: Level):
        out = F.relu(self.norm1(self.conv1(x, level.nbr, level.valid),
                                level.valid))
        out = self.norm2(self.conv2(out, level.nbr, level.valid), level.valid)
        residual = x
        if hasattr(self, "downsample_conv"):
            # in x's dtype: a bf16 input stays bf16 end to end
            residual = self.downsample_norm(
                linear(x, self.downsample_conv), level.valid)
        return F.relu(out + residual)


class Res16UNet34C(nn.Module):
    PLANES = (32, 64, 128, 256, 256, 128, 96, 96)
    LAYERS = (2, 3, 4, 6, 2, 2, 2, 2)
    INIT_DIM = 32

    def __init__(self, in_channels: int = 259, out_channels: int = 96,
                 config: Optional[dict] = None):
        super().__init__()
        P, L, D = self.PLANES, self.LAYERS, self.INIT_DIM
        if out_channels != P[7]:
            raise ValueError(f"Res16UNet34C outputs {P[7]} channels")
        config = config or {}
        k = config.get("conv1_kernel_size", 5)
        self.bn_momentum = config.get("bn_momentum", 0.02)
        self.conv0p1s1 = SubMConv(in_channels, D, kernel_volume=k ** 3)
        self.bn0 = self._bn(D)
        self.conv1p1s2 = DownConv(D, D)
        self.bn1 = self._bn(D)
        self.block1 = self._blocks(D, P[0], L[0])
        self.conv2p2s2 = DownConv(P[0], P[0])
        self.bn2 = self._bn(P[0])
        self.block2 = self._blocks(P[0], P[1], L[1])
        self.conv3p4s2 = DownConv(P[1], P[1])
        self.bn3 = self._bn(P[1])
        self.block3 = self._blocks(P[1], P[2], L[2])
        self.conv4p8s2 = DownConv(P[2], P[2])
        self.bn4 = self._bn(P[2])
        self.block4 = self._blocks(P[2], P[3], L[3])
        self.convtr4p16s2 = UpConv(P[3], P[4])
        self.bntr4 = self._bn(P[4])
        self.block5 = self._blocks(P[4] + P[2], P[4], L[4])
        self.convtr5p8s2 = UpConv(P[4], P[5])
        self.bntr5 = self._bn(P[5])
        self.block6 = self._blocks(P[5] + P[1], P[5], L[5])
        self.convtr6p4s2 = UpConv(P[5], P[6])
        self.bntr6 = self._bn(P[6])
        self.block7 = self._blocks(P[6] + P[0], P[6], L[6])
        self.convtr7p2s2 = UpConv(P[6], P[7])
        self.bntr7 = self._bn(P[7])
        self.block8 = self._blocks(P[7] + D, P[7], L[7])

    def _bn(self, channels: int) -> MaskedBatchNorm:
        return MaskedBatchNorm(channels, momentum=self.bn_momentum)

    def _blocks(self, cin: int, planes: int, n: int) -> nn.ModuleList:
        return nn.ModuleList(
            BasicBlock(cin if i == 0 else planes, planes, self.bn_momentum)
            for i in range(n))

    @staticmethod
    def _run(blocks: nn.ModuleList, x, level: Level):
        for block in blocks:
            x = block(x, level)
        return x

    def forward(self, feats: torch.Tensor, plan: UNetPlan) -> torch.Tensor:
        """feats: (V0, in_channels) level-0 voxel features."""
        lv = plan.levels
        out = self.conv0p1s1(feats, plan.stem_nbr, lv[0].valid)
        out_p1 = F.relu(self.bn0(out, lv[0].valid))

        out = F.relu(self.bn1(self.conv1p1s2(out_p1, lv[0], lv[1]),
                              lv[1].valid))
        out_b1p2 = self._run(self.block1, out, lv[1])
        out = F.relu(self.bn2(self.conv2p2s2(out_b1p2, lv[1], lv[2]),
                              lv[2].valid))
        out_b2p4 = self._run(self.block2, out, lv[2])
        out = F.relu(self.bn3(self.conv3p4s2(out_b2p4, lv[2], lv[3]),
                              lv[3].valid))
        out_b3p8 = self._run(self.block3, out, lv[3])
        out = F.relu(self.bn4(self.conv4p8s2(out_b3p8, lv[3], lv[4]),
                              lv[4].valid))
        out = self._run(self.block4, out, lv[4])

        out = F.relu(self.bntr4(self.convtr4p16s2(out, lv[3]), lv[3].valid))
        out = self._run(self.block5, torch.cat([out, out_b3p8], -1), lv[3])
        out = F.relu(self.bntr5(self.convtr5p8s2(out, lv[2]), lv[2].valid))
        out = self._run(self.block6, torch.cat([out, out_b2p4], -1), lv[2])
        out = F.relu(self.bntr6(self.convtr6p4s2(out, lv[1]), lv[1].valid))
        out = self._run(self.block7, torch.cat([out, out_b1p2], -1), lv[1])
        out = F.relu(self.bntr7(self.convtr7p2s2(out, lv[0]), lv[0].valid))
        return self._run(self.block8, torch.cat([out, out_p1], -1), lv[0])
