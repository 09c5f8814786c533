"""EMA of the parameters: ``shadow = decay * shadow + (1 - decay) * p``.

Counterpart of ``segdino3d_tpu/train/ema.py:ema_update``.  The shadow is a
copy of every parameter on the parameters' device, updated in place after
each optimizer step (the JAX package builds a new tree each step).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterable, Tuple

import torch
from torch import nn


class EMA:
    def __init__(self, named_params: Iterable[Tuple[str, nn.Parameter]],
                 decay: float):
        self.decay = decay
        named = list(named_params)
        self.params = [p for _, p in named]
        self.shadow: Dict[str, torch.Tensor] = {
            n: p.detach().clone() for n, p in named}

    @torch.no_grad()
    def update(self) -> None:
        shadow = list(self.shadow.values())
        torch._foreach_mul_(shadow, self.decay)
        torch._foreach_add_(shadow, [p.detach() for p in self.params],
                            alpha=1.0 - self.decay)

    @contextlib.contextmanager
    def applied(self):
        """The shadow in place of the parameters inside the block, the
        parameters restored after it (the JAX package's ``swap_in_ema``
        for eval)."""
        backup = [p.detach().clone() for p in self.params]
        with torch.no_grad():
            for p, s in zip(self.params, self.shadow.values()):
                p.copy_(s)
        try:
            yield
        finally:
            with torch.no_grad():
                for p, b in zip(self.params, backup):
                    p.copy_(b)
