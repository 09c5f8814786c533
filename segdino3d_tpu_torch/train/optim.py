"""AdamW + PolyLR with clipping by global norm, on optax's arithmetic.

Counterpart of ``segdino3d_tpu/train/optim.py``, which chains
``optax.clip_by_global_norm`` and ``optax.adamw`` (b1 0.9, b2 0.999, eps
1e-8, decoupled weight decay on every parameter) under a PolyLR schedule
``lr * (1 - step / total) ^ power``.  The port follows optax's formulas, not
``torch.optim.AdamW``'s or ``clip_grad_norm_``'s:

* clipping: with ``g_norm = sqrt(sum of squares of every gradient)``, the
  gradients are scaled by ``max_norm / g_norm`` only when ``g_norm >=
  max_norm`` (no ``+ 1e-6``);
* the update is ``mu_hat / (sqrt(nu_hat) + eps) + wd * p``, times ``-lr``;
* the schedule reads the step count before it is incremented, so the first
  step uses the base learning rate;
* the schedule and the bias corrections ``1 - b^t`` are computed in fp32,
  as optax computes them (``1 - 0.999`` in fp32 is 1.3e-5 off its real
  value, which the update inherits).

Parameters whose name contains ``backbone`` form a second group with
``lr_backbone`` (the JAX package's ``multi_transform``).  The update runs
in place on the parameters with ``torch._foreach_*`` arithmetic.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn


def poly_lr(base_lr: float, total_iters: int, power: float = 0.9
            ) -> Callable[[int], float]:
    def schedule(step: int) -> float:
        f32 = np.float32
        frac = np.clip(f32(1.0) - f32(step) / f32(total_iters), f32(0.0),
                       f32(1.0))
        return float(f32(base_lr) * frac ** f32(power))
    return schedule


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (a 0-d tensor)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
        list(tensors))))


class AdamW:
    """In-place AdamW over parameter groups ``[(params, schedule), ...]``."""

    def __init__(self, groups: Sequence[Tuple[List[nn.Parameter],
                                              Callable[[int], float]]],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.05,
                 clip_max_norm: Optional[float] = None):
        self.groups = [(list(ps), sched) for ps, sched in groups if ps]
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.clip_max_norm = clip_max_norm
        self.count = 0
        self.mu = [[torch.zeros_like(p) for p in ps] for ps, _ in self.groups]
        self.nu = [[torch.zeros_like(p) for p in ps] for ps, _ in self.groups]

    @property
    def params(self) -> List[nn.Parameter]:
        return [p for ps, _ in self.groups for p in ps]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, grad_norm: Optional[torch.Tensor] = None) -> None:
        """One update from the parameters' ``.grad`` (None = zeros), which
        are clipped in place; ``grad_norm`` is their global norm where the
        caller has it."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.clip_max_norm:
            g_norm = grad_norm if grad_norm is not None else global_norm(
                [p.grad for p in self.params])
            factor = torch.where(g_norm < self.clip_max_norm,
                                 torch.ones_like(g_norm),
                                 self.clip_max_norm / g_norm)
            torch._foreach_mul_([p.grad for p in self.params], factor)
        t = self.count + 1
        c1, c2 = (float(np.float32(1.0) - np.float32(b) ** t)
                  for b in (self.b1, self.b2))
        for (ps, sched), mu, nu in zip(self.groups, self.mu, self.nu):
            grads = [p.grad for p in ps]
            torch._foreach_mul_(mu, self.b1)
            torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
            torch._foreach_mul_(nu, self.b2)
            torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.b2)
            den = torch._foreach_div(nu, c2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, self.eps)
            upd = torch._foreach_div(mu, c1)
            torch._foreach_div_(upd, den)
            torch._foreach_add_(upd, ps, alpha=self.weight_decay)
            torch._foreach_add_(ps, upd, alpha=-sched(self.count))
        self.count = t


def _is_backbone(name: str) -> bool:
    return "backbone" in name.lower()


def build_optimizer(named_params: Iterable[Tuple[str, nn.Parameter]],
                    cfg_optimizer: Dict, cfg_scheduler: Dict,
                    clip_max_norm: Optional[float] = None) -> AdamW:
    """AdamW over ``named_params`` from the JAX package's config schema
    (``optimizer`` lr / lr_backbone / weight_decay, ``scheduler``
    total_iters / power)."""
    lr = cfg_optimizer.get("lr", 1e-4)
    lr_backbone = cfg_optimizer.get("lr_backbone", lr)
    total = cfg_scheduler.get("total_iters", 100_000)
    power = cfg_scheduler.get("power", 0.9)
    main, backbone = [], []
    for name, p in named_params:
        if p.requires_grad:
            (backbone if _is_backbone(name) and lr_backbone != lr
             else main).append(p)
    return AdamW([(main, poly_lr(lr, total, power)),
                  (backbone, poly_lr(lr_backbone, total, power))],
                 weight_decay=cfg_optimizer.get("weight_decay", 0.05),
                 clip_max_norm=clip_max_norm)
