"""One training step: forward, criterion, backward, clip, AdamW/PolyLR, EMA.

Counterpart of ``segdino3d_tpu/parallel/train_step.py:make_train_step``.
With ``accum_steps = k`` the step takes k microbatches in turn, as the
JAX package scans them (its recipe for the reference's batch 4 on one
chip): the batch-norm running statistics are updated by each microbatch
in order, the gradients are summed over the microbatches and scaled by
1/k once, and the losses are averaged.  The metrics are each loss,
``total_loss`` and ``grad_norm`` (the global norm of the averaged
gradients, before clipping), as 0-d tensors on the device.  After a step
the parameters' ``.grad`` hold the clipped gradients.
``host_metrics`` reads them in one copy, together with whether a plan
built on the device outgrew its capacities in the step, and raises if one
did: a step never waits on the device for that flag alone.

With a ``process_group`` (``parallel.mesh``) each process steps its own
microbatches, then the gradients, each loss, ``total_loss`` and the
batch-norm running statistics are averaged over the group (JAX's
``pmean`` over the ``data`` axis), in one all-reduce per dtype, once a
step whatever ``accum_steps``; the norm, the clipping and the update read
the averaged gradients, so every process takes the same update.  There is
no ``DistributedDataParallel``: it would broadcast rank 0's batch-norm
buffers where JAX averages them, and reduce in every microbatch's
backward.

``StageClock`` times the stages of a step for measurement: it synchronises
the device at every stage boundary, so it is off unless a caller passes
one.
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from segdino3d_tpu_torch.gtypes import SceneBatch
from segdino3d_tpu_torch.models.backbone.wrapper import DEVICE_PLAN_OVERFLOW
from segdino3d_tpu_torch.parallel.mesh import all_reduce_mean_
from segdino3d_tpu_torch.train.ema import EMA
from segdino3d_tpu_torch.train.optim import AdamW, global_norm


class StageClock:
    """Wall time per stage, the device synchronised at each mark."""

    def __init__(self, sync: Callable[[], None]):
        self.sync = sync
        self.seconds: Dict[str, float] = defaultdict(float)
        self._t = 0.0

    def start(self) -> None:
        self.sync()
        self._t = time.perf_counter()

    def mark(self, stage: str) -> None:
        self.sync()
        now = time.perf_counter()
        self.seconds[stage] += now - self._t
        self._t = now


class TrainStep:
    def __init__(self, model: nn.Module, criterion, optimizer: AdamW,
                 ema: Optional[EMA] = None, accum_steps: int = 1,
                 process_group=None):
        self.model = model
        self.criterion = criterion
        self.optimizer = optimizer
        self.ema = ema
        self.accum_steps = accum_steps
        self.process_group = process_group
        self.plan_overflow: Optional[torch.Tensor] = None

    def __call__(self, microbatches: Sequence[SceneBatch],
                 queries: Optional[Sequence[Tuple[torch.Tensor,
                                                  torch.Tensor]]] = None,
                 generator: Optional[torch.Generator] = None,
                 clock: Optional[StageClock] = None
                 ) -> Dict[str, torch.Tensor]:
        """One step over ``accum_steps`` microbatches (each a
        ``SceneBatch`` with its host plan).  ``queries`` gives each
        microbatch's query selection; otherwise they are drawn from
        ``generator``, which also draws the decoder's dropout masks, in
        order: a step is reproducible from the generator's seed."""
        if len(microbatches) != self.accum_steps:
            raise ValueError(f"accum_steps={self.accum_steps} but "
                             f"{len(microbatches)} microbatches")
        self.model.train()
        self.optimizer.zero_grad()
        if clock is not None:
            clock.start()
        loss_sums: Dict[str, torch.Tensor] = {}
        total_sum = 0.0
        overflow = None
        for i, mb in enumerate(microbatches):
            outputs, gt = self.model(mb, None if queries is None
                                     else queries[i], generator)
            flag = outputs["plan_overflow"]
            overflow = flag if overflow is None else overflow | flag
            if clock is not None:
                clock.mark("forward")
            losses = self.criterion(outputs, gt)
            total = sum(losses.values())
            if clock is not None:
                clock.mark("criterion")
            total.backward()
            if clock is not None:
                clock.mark("backward")
            for k, v in losses.items():
                loss_sums[k] = loss_sums.get(k, 0.0) + v.detach()
            total_sum = total_sum + total.detach()
        inv = 1.0 / self.accum_steps
        metrics = {k: v * inv for k, v in loss_sums.items()}
        metrics["total_loss"] = total_sum * inv
        if self.process_group is not None:
            # every process reduces the same list: a parameter without a
            # gradient here may have one elsewhere
            for p in self.optimizer.params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.optimizer.params if p.grad is not None]
        with torch.no_grad():
            if self.accum_steps > 1:
                torch._foreach_mul_(grads, inv)
            if self.process_group is not None:
                all_reduce_mean_(grads + list(metrics.values())
                                 + self._bn_stats(), self.process_group)
            grad_norm = global_norm(grads)
        self.optimizer.step(grad_norm)
        if self.ema is not None:
            self.ema.update()
        if clock is not None:
            clock.mark("optimizer")
        metrics["grad_norm"] = grad_norm
        self.plan_overflow = overflow
        return metrics

    def _bn_stats(self):
        return [b for n, b in self.model.named_buffers()
                if n.endswith(("running_mean", "running_var"))]

    def host_metrics(self, metrics: Dict[str, torch.Tensor]
                     ) -> Dict[str, float]:
        """The last step's ``metrics`` as floats, in one device -> host
        copy that also reads the step's plan overflow flag; raises if a
        plan built on the device overflowed (a host plan raises when it is
        built)."""
        keys = list(metrics)
        vals = torch.stack([metrics[k].float() for k in keys]
                           + [self.plan_overflow.float()]).tolist()
        if vals[-1]:
            raise ValueError(DEVICE_PLAN_OVERFLOW)
        return dict(zip(keys, vals[:-1]))
