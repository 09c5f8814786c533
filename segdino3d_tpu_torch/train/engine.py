"""The iteration-based training loop.

Counterpart of ``segdino3d_tpu/train/engine.py``: steps over an endless
loader, logs losses, learning rate, data and step time every
``print_freq`` steps (one device -> host copy through the step's
``host_metrics``; other steps never wait on the device), checkpoints every
``save_step`` steps on a background writer, evaluates every ``eval_step``
steps, profiles ``profile_steps`` and saves at the end.  The first
SIGTERM or SIGINT checkpoints at the next step boundary and returns.

The step's query sampling and dropout masks come from one
``torch.Generator`` on the step's device, seeded with ``seed`` (in a
group of several processes, ``seed`` folded with the process's rank, as
the JAX step folds the mesh axis index into its key).  A resumed state
continues from its step with a fresh loader stream and generator, as in
the JAX package.

In a process group (``parallel.mesh``) only process 0 writes checkpoints;
the others wait for it at a barrier after each save.  A signal to any
process stops every process at the same step boundary: the guard's flag
is all-reduced there, as a host tensor over gloo, so the boundary waits
for the other processes but not for the card.
"""
from __future__ import annotations

import os
import signal
import threading
import time
from typing import Callable, Optional

import torch

from segdino3d_tpu_torch.parallel.mesh import (any_flag, barrier,
                                               process_count, process_index,
                                               process_is_main)
from segdino3d_tpu_torch.train.checkpoint import CheckpointWriter, TrainState
from segdino3d_tpu_torch.utils import profiling
from segdino3d_tpu_torch.utils.metrics import MetricLogger


class _PreemptionGuard:
    """While armed, the first SIGTERM/SIGINT only sets ``signum``: the loop
    checkpoints at the next step boundary and returns.  The previous
    handlers come back on the first signal, so a second one acts as
    usual.  A no-op off the main thread."""

    def __init__(self):
        self.signum = None
        self._prev = {}

    def __enter__(self):
        if threading.current_thread() is not threading.main_thread():
            return self
        for s in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev[s] = signal.signal(s, self._on_signal)
            except (ValueError, OSError):
                pass
        return self

    def _on_signal(self, signum, frame):
        self.signum = signum
        self._restore()

    def _restore(self):
        for s, h in self._prev.items():
            try:
                signal.signal(s, h)
            except (ValueError, OSError):
                pass
        self._prev = {}

    def __exit__(self, *exc):
        self._restore()
        return False


def train_loop(*, step_fn: Callable, state: TrainState, train_loader,
               num_iterations: int, schedule_fn=None, logger=None,
               print_freq: int = 10, save_step: int = 1000,
               eval_step: Optional[int] = None,
               eval_fn: Optional[Callable] = None,
               work_dir: Optional[str] = None, seed: int = 0,
               eval_first: bool = False,
               profile_steps: Optional[tuple] = None) -> TrainState:
    """Train ``state`` from its step to ``num_iterations``; returns it.

    ``step_fn(microbatches, generator=...)`` is a
    ``parallel.train_step.TrainStep`` (or anything with its call and its
    ``host_metrics``); a loader batch that is one ``SceneBatch`` is one
    microbatch.  ``profile_steps=(start, stop)`` traces those steps into
    ``work_dir/profile`` (``utils.profiling``).  The step's generator
    lives on the model's device."""
    log = logger.info if logger else print
    metric_logger = MetricLogger(logger=logger)
    device = next(state.model.parameters()).device
    n_proc = process_count()
    gen = torch.Generator(device=device).manual_seed(
        seed if n_proc == 1 else hash((seed, process_index())) % (2 ** 63))

    if eval_first and eval_fn is not None:
        eval_fn(state)

    start_step = state.step
    it = iter(train_loader)
    t_end = time.time()
    writer = (CheckpointWriter(work_dir) if work_dir and process_is_main()
              else None)
    saves = bool(work_dir)
    last_saved = -1
    try:
        with _PreemptionGuard() as guard:
            for step in range(start_step, num_iterations):
                if profile_steps and work_dir and step == profile_steps[0]:
                    profiling.start_trace(os.path.join(work_dir, "profile"))
                    log(f"profiling steps {profile_steps[0]}.."
                        f"{profile_steps[1]} -> {work_dir}/profile")
                    t_end = time.time()   # the data time is the loader's
                batch = next(it)
                data_t = time.time() - t_end
                mbs = batch if isinstance(batch, list) else [batch]
                with profiling.annotate("train_step"):
                    metrics = step_fn(mbs, generator=gen)
                if step % print_freq == 0:
                    host = step_fn.host_metrics(metrics)
                    lr = float(schedule_fn(step)) if schedule_fn \
                        else float("nan")
                    metric_logger.update(lr=lr, data_time=data_t, **host)
                    iter_t = time.time() - t_end
                    log(f"iter [{step}/{num_iterations}] "
                        + "  ".join(f"{k}: {v:.4f}" for k, v in host.items())
                        + f"  lr: {lr:.3e}  data: {data_t:.3f}s  "
                        f"time: {iter_t:.3f}s")
                t_end = time.time()

                if profile_steps and work_dir and step == profile_steps[1]:
                    path = profiling.stop_trace()
                    log(f"profile trace: {path}")
                    log(profiling.device_memory_summary())
                if saves and save_step and (step + 1) % save_step == 0:
                    if writer:
                        writer.save(state)
                    barrier()
                    last_saved = state.step
                if (eval_fn is not None and eval_step
                        and (step + 1) % eval_step == 0):
                    eval_fn(state)
                stop = guard.signum is not None
                if n_proc > 1:
                    stop = any_flag(stop)
                if stop:
                    log(f"signal {guard.signum or 'on another process'} "
                        f"received: checkpointing at step {step + 1} and "
                        f"exiting the train loop")
                    break
        if saves and state.step != last_saved:
            if writer:
                writer.save(state)
                writer.close()
            barrier()
    finally:
        if hasattr(it, "close"):
            it.close()      # a process-mode loader stops its workers
        if writer:
            writer.close()
    return state
