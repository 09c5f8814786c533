"""Shared building blocks: masked batch norm and the MLP.

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
    """Batch norm over valid voxels (``segdino3d_tpu/models/layers.py``):
    ``eps`` 1e-5, fp32 arithmetic, output in the input's dtype, invalid rows
    zeroed.

    In training mode (``module.train()``) it normalises with the fp32
    statistics of the valid rows (biased variance) and updates the running
    statistics in place, torch's convention: ``running = (1 - momentum) *
    running + momentum * batch`` with the unbiased variance.  In eval mode
    it uses the running statistics."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            w = valid.float()[:, None]
            n = w.sum().clamp(min=1.0)
            mean = (xf * w).sum(0) / n
            var = ((xf - mean).square() * w).sum(0) / n
            with torch.no_grad():
                m = self.momentum
                unbiased = var * n / (n - 1.0).clamp(min=1.0)
                self.running_mean.copy_((1 - m) * self.running_mean
                                        + m * mean)
                self.running_var.copy_((1 - m) * self.running_var
                                       + m * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.reciprocal(torch.sqrt(var + self.eps))
        y = (xf - mean) * inv * self.weight + self.bias
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
