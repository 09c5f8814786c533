"""Sine and Fourier positional embeddings over scene-normalized coordinates.

Counterpart of ``segdino3d_tpu/ops/pos_embed.py``: coordinates map to
[0, 1] per scene (``shift_scale_points``).  ``sine_pos_embed`` scales them
by 2*pi, then per-dimension interleaved sin/cos with temperature-geometric
frequencies; ``modulated`` multiplies each spatial dim's block by a
per-point factor (box-modulated attention).  ``fourier_pos_embed`` divides
them by ``modulated``, scales by 2*pi and projects them with a fixed
Gaussian matrix, then [sin, cos].
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def shift_scale_points(xyz: torch.Tensor,
                       src_range: Tuple[torch.Tensor, torch.Tensor]
                       ) -> torch.Tensor:
    """(B, N, 3) coords -> [0,1]^3 given per-batch (min, max) each (B, 3)."""
    mn, mx = src_range
    extent = mx - mn
    return (xyz - mn[:, None, :]) / extent[:, None, :].clamp(min=1e-12)


def fourier_pos_embed(xyz: torch.Tensor, gauss_b: torch.Tensor,
                      num_channels: int,
                      src_range: Tuple[torch.Tensor, torch.Tensor],
                      modulated: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """(B, N, 3) -> (B, N, 2 * (num_channels // 2)) Gaussian-Fourier
    features; ``gauss_b`` is the (3, >= num_channels // 2) projection."""
    d_out = num_channels // 2
    x = shift_scale_points(xyz, src_range)
    if modulated is not None:
        x = x / modulated
    proj = torch.einsum("bnd,dk->bnk", x * (2 * math.pi), gauss_b[:, :d_out])
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


def sine_pos_embed(xyz: torch.Tensor, num_channels: int,
                   src_range: Tuple[torch.Tensor, torch.Tensor],
                   temperature: float = 10000.0, scale: float = 2 * math.pi,
                   modulated: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, N, 3) -> (B, N, num_channels)."""
    xyz = shift_scale_points(xyz, src_range)
    d_in = xyz.shape[2]
    ndim = num_channels // d_in
    if ndim % 2 != 0:
        ndim -= 1
    rems = num_channels - ndim * d_in

    blocks = []
    for d in range(d_in):
        cdim = ndim
        if rems > 0:
            cdim += 2
            rems -= 2
        dim_t = torch.arange(cdim, dtype=torch.float32, device=xyz.device)
        dim_t = temperature ** (2 * torch.floor(dim_t / 2) / cdim)
        raw = xyz[:, :, d] * scale
        pos = raw[:, :, None] / dim_t
        emb = torch.stack([torch.sin(pos[:, :, 0::2]),
                           torch.cos(pos[:, :, 1::2])],
                          dim=3).reshape(*pos.shape[:2], -1)
        if modulated is not None:
            emb = emb * modulated[:, :, d:d + 1]
        blocks.append(emb)
    return torch.cat(blocks, dim=2)
