"""Shared building blocks: masked batch norm (eval mode) and the MLP.

Counterpart of ``segdino3d_tpu/models/layers.py``.  Parameter names follow
the flax tree through ``convert.py``: a flax ``scale`` is ``weight`` here,
``batch_stats`` ``mean``/``var`` are the ``running_mean``/``running_var``
buffers, and a flax ``Dense`` kernel (in, out) is ``nn.Linear.weight``
(out, in).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class MaskedBatchNorm(nn.Module):
    """Batch norm over valid voxels, eval mode: running statistics,
    ``eps`` 1e-5, fp32 arithmetic, output in the input's dtype, invalid
    rows zeroed.  Training-mode statistics are not ported."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        inv = torch.reciprocal(torch.sqrt(self.running_var + self.eps))
        y = (x.float() - self.running_mean) * inv * self.weight + self.bias
        return torch.where(valid[:, None], y.to(x.dtype), 0.0)


def linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """``layer`` applied in ``x``'s dtype (the flax ``Dense(dtype=...)``
    pattern: parameters stay fp32, the product runs in the input type)."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), bias)


class MLP(nn.Module):
    """k-layer ReLU MLP."""

    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            nn.Linear(dims[i], dims[i + 1]) for i in range(num_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x
