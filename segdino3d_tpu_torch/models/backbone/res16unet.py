"""Res16UNet34C sparse U-Net backbone.

Counterpart of ``segdino3d_tpu/models/backbone/res16unet.py``: a k5 stem,
4 stride-2 down stages with BasicBlock stacks LAYERS=(2,3,4,6,2,2,2,2), 4
transposed up stages with skip concatenation,
PLANES=(32,64,128,256,256,128,96,96), 96-channel output.  Each level runs
in the layout its plan gives it (``make_level_ctxs``, ``ops.conv_ctx``):
block-dense where the plan carries block tables (``ops.block_dense``,
kernels K9-K11), else the gather layout (``ops.sparse_conv``, kernels K1,
K2 and K4); a plan with compacted stem tables runs the stem as one wide
matmul and K12 (eval only).  The stride-2 down and up convs always run on voxel rows.
``module.train()`` puts every batch norm in training mode;
``config["bn_momentum"]`` (default 0.02, as in the JAX package) sets their
momentum.  Module and parameter names mirror the flax tree (``convert.py``)
and are the same in both layouts.

``build_unet_plan`` builds the plan on the device of a voxel grid (the
on-device plan engine, kernels K6-K8), in the layout of a host plan.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from segdino3d_tpu_torch.models.layers import MaskedBatchNorm, linear
from segdino3d_tpu_torch.ops import sparse_conv as SC
from segdino3d_tpu_torch.ops.conv_ctx import (CompactStemCtx, DenseCtx,
                                              GatherCtx)
from segdino3d_tpu_torch.ops.host_plan import Level, UNetPlan
from segdino3d_tpu_torch.ops.voxelize import VoxelGrid


def build_unet_plan(grid: VoxelGrid, num_levels: int = 5,
                    stem_kernel: int = 5,
                    level_caps: Optional[Sequence[int]] = None
                    ) -> Tuple[UNetPlan, torch.Tensor]:
    """(plan, overflow) on the grid's device: each level's 27-neighbour
    table and parent links, the k^3 stem table, and the port's child table
    and up-conv row order (``ops.host_plan``).  Every shape is a static
    capacity and nothing waits for the device; ``overflow`` (a 0-d bool
    tensor) is set when any level outgrew its capacity."""
    pyramid = SC.build_conv_plan(grid, num_levels, level_caps)
    nbrs, stem = SC.neighbor_tables(pyramid, stem_kernel)
    levels = []
    overflow = grid.overflow
    for li, lv in enumerate(pyramid):
        child = order = None
        if lv.parent is not None:
            child = SC.child_table(lv.parent, lv.kpos,
                                   pyramid[li + 1].coords_T.shape[1])
            order = SC.up_order(lv.kpos, lv.valid)
        levels.append(Level(valid=lv.valid, nbr=nbrs[li], parent=lv.parent,
                            kpos=lv.kpos, child=child, up_order=order))
        overflow = overflow | lv.overflow
    return UNetPlan(levels=levels, stem_nbr=stem,
                    inverse=grid.inverse_mapping), overflow


def make_level_ctxs(plan: UNetPlan):
    """(one conv context per level, the stem's): block-dense where the plan
    carries block tables, else the gather layout.  A block-dense level 0
    whose plan also carries ``stem_nbr`` (built with ``stem_gather``) runs
    the stem in the gather layout: the hybrid layout.  A plan with
    ``stem_compact`` tables runs the degree-compacted stem, whatever level
    0's layout."""
    blocks = plan.blocks or [None] * len(plan.levels)
    ctxs = [DenseCtx(t) if t is not None else GatherCtx(lv.nbr, lv.valid)
            for t, lv in zip(blocks, plan.levels)]
    if plan.stem_compact is not None:
        return ctxs, CompactStemCtx(*plan.stem_compact, plan.levels[0].valid)
    if blocks[0] is not None and plan.stem_nbr is None:
        return ctxs, ctxs[0]
    return ctxs, GatherCtx(plan.stem_nbr, plan.levels[0].valid)


class SubMConv(nn.Module):
    """Submanifold conv; ``kernel`` (k^3, Cin, Cout), canonical order, run
    by the level's context."""

    def __init__(self, cin: int, cout: int, kernel_volume: int = 27):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(kernel_volume, cin, cout))

    def forward(self, feats, ctx):
        return ctx.subm(feats, self.kernel.to(feats.dtype))


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

    def forward(self, x, ctx):
        out = F.relu(self.norm1(self.conv1(x, ctx), ctx.valid))
        out = self.norm2(self.conv2(out, ctx), ctx.valid)
        residual = x
        if hasattr(self, "downsample_conv"):
            # in x's dtype: a bf16 input stays bf16 end to end
            residual = self.downsample_norm(
                linear(x, self.downsample_conv), ctx.valid)
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
        self.stem_kernel = config.get("conv1_kernel_size", 5)
        self.bn_momentum = config.get("bn_momentum", 0.02)
        self.conv0p1s1 = SubMConv(in_channels, D,
                                  kernel_volume=self.stem_kernel ** 3)
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
    def _run(blocks: nn.ModuleList, x, ctx):
        for block in blocks:
            x = block(x, ctx)
        return x

    def forward(self, feats: torch.Tensor, plan: UNetPlan) -> torch.Tensor:
        """feats: (V0, in_channels) level-0 voxel features."""
        lv = plan.levels
        ctxs, stem_ctx = make_level_ctxs(plan)
        out = self.conv0p1s1(stem_ctx.enter(feats), stem_ctx)
        out_p1 = F.relu(self.bn0(out, stem_ctx.valid))
        if stem_ctx is not ctxs[0]:
            # the stem's output into level 0's layout (identity when both
            # are gather)
            out_p1 = ctxs[0].enter(stem_ctx.exit(out_p1))

        def down(conv, bn, x, li):
            """conv li -> li + 1 on voxel rows, then level li + 1's layout"""
            x = conv(ctxs[li].exit(x), lv[li], lv[li + 1])
            return F.relu(bn(ctxs[li + 1].enter(x), ctxs[li + 1].valid))

        def up(conv, bn, x, li, skip):
            """transposed conv li + 1 -> li on voxel rows, then the skip"""
            x = conv(ctxs[li + 1].exit(x), lv[li])
            x = F.relu(bn(ctxs[li].enter(x), ctxs[li].valid))
            return torch.cat([x, skip], -1)

        out_b1p2 = self._run(self.block1,
                             down(self.conv1p1s2, self.bn1, out_p1, 0),
                             ctxs[1])
        out_b2p4 = self._run(self.block2,
                             down(self.conv2p2s2, self.bn2, out_b1p2, 1),
                             ctxs[2])
        out_b3p8 = self._run(self.block3,
                             down(self.conv3p4s2, self.bn3, out_b2p4, 2),
                             ctxs[3])
        out = self._run(self.block4,
                        down(self.conv4p8s2, self.bn4, out_b3p8, 3), ctxs[4])

        out = self._run(self.block5, up(self.convtr4p16s2, self.bntr4, out,
                                        3, out_b3p8), ctxs[3])
        out = self._run(self.block6, up(self.convtr5p8s2, self.bntr5, out,
                                        2, out_b2p4), ctxs[2])
        out = self._run(self.block7, up(self.convtr6p4s2, self.bntr6, out,
                                        1, out_b1p2), ctxs[1])
        out = self._run(self.block8, up(self.convtr7p2s2, self.bntr7, out,
                                        0, out_p1), ctxs[0])
        return ctxs[0].exit(out)
