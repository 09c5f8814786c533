"""Checkpoints: save, keep the newest five, resume, and the pretrained
merge.

Counterpart of ``segdino3d_tpu/train/checkpoint.py`` (orbax there) with
``torch.save``.  A checkpoint is ``work_dir/checkpoints/step_<N>.pth``,
written to a temporary name and renamed, holding a dict with the
reference's top-level keys:

* ``model``: the model's state dict (every parameter and buffer: the
  batch-norm running statistics, a Fourier PE's matrix);
* ``optimizer``: ``step`` (AdamW's update count) and the first and second
  moments ``mu`` / ``nu`` by parameter name;
* ``step``: the training step;
* ``ema_model``: the EMA shadow by parameter name, or None.

The optimizer and the batch norms update their tensors in place, so a save
takes its copy on the host before it returns (``host_state``); the
``CheckpointWriter``'s thread only writes that copy.
"""
from __future__ import annotations

import os
import queue
import re
import threading
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from segdino3d_tpu_torch.train.ema import EMA
from segdino3d_tpu_torch.train.optim import AdamW

_NAME = re.compile(r"^step_(\d+)\.pth$")


class TrainState:
    """What a checkpoint holds: the model, its AdamW and its EMA; the
    step is AdamW's update count."""

    def __init__(self, model: nn.Module, optimizer: AdamW,
                 ema: Optional[EMA] = None):
        self.model = model
        self.optimizer = optimizer
        self.ema = ema

    @property
    def step(self) -> int:
        return self.optimizer.count


def _ckpt_dir(work_dir: str) -> str:
    return os.path.join(os.path.abspath(work_dir), "checkpoints")


def _path(work_dir: str, step: int) -> str:
    return os.path.join(_ckpt_dir(work_dir), f"step_{step:010d}.pth")


def _param_names(state: TrainState) -> Dict[int, str]:
    return {id(p): n for n, p in state.model.named_parameters()}


def host_state(state: TrainState) -> Dict:
    """The checkpoint dict of ``state`` with every tensor copied to the
    host now."""
    def host(t):
        return t.detach().to("cpu", copy=True)

    names = _param_names(state)
    opt = state.optimizer
    moments = {"mu": {}, "nu": {}}
    for (ps, _), mu, nu in zip(opt.groups, opt.mu, opt.nu):
        for p, m, v in zip(ps, mu, nu):
            moments["mu"][names[id(p)]] = host(m)
            moments["nu"][names[id(p)]] = host(v)
    return dict(
        model={k: host(v) for k, v in state.model.state_dict().items()},
        optimizer=dict(step=opt.count, **moments),
        step=state.step,
        ema_model=None if state.ema is None else {
            k: host(v) for k, v in state.ema.shadow.items()})


def _write(work_dir: str, ckpt: Dict, keep: int) -> None:
    path = _path(work_dir, int(ckpt["step"]))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(ckpt, tmp)
    os.replace(tmp, path)
    for step in sorted(_steps(work_dir))[:-keep]:
        os.remove(_path(work_dir, step))


def _steps(work_dir: str):
    d = _ckpt_dir(work_dir)
    if not os.path.isdir(d):
        return []
    return [int(m.group(1)) for m in map(_NAME.match, os.listdir(d)) if m]


def save_checkpoint(work_dir: str, state: TrainState, keep: int = 5):
    """Write ``state`` now; keep the newest ``keep`` checkpoints."""
    _write(work_dir, host_state(state), keep)


# bound on ``CheckpointWriter.close``'s wait for the pending writes
CLOSE_TIMEOUT_S = 600.0


class CheckpointWriter:
    """Checkpoints written on a background thread: ``save`` takes the host
    copy and returns, the thread writes it.  ``close()`` (or the context
    exit) waits for every pending write, at most ``CLOSE_TIMEOUT_S``; an
    error of the thread is raised by the next ``save`` or by ``close``."""

    def __init__(self, work_dir: str, keep: int = 5):
        self.work_dir = work_dir
        self.keep = keep
        self._q: queue.Queue = queue.Queue()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            try:
                ckpt = self._q.get(timeout=1.0)
            except queue.Empty:
                if not threading.main_thread().is_alive():
                    return
                continue
            if ckpt is None:
                return
            try:
                _write(self.work_dir, ckpt, self.keep)
            except BaseException as e:
                self._error = e

    def _raise(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, state: TrainState):
        self._raise()
        self._q.put(host_state(state))

    def close(self):
        if self._thread.is_alive():
            self._q.put(None)
            self._thread.join(CLOSE_TIMEOUT_S)
            if self._thread.is_alive():
                raise RuntimeError(
                    f"checkpoint writer: pending writes to {self.work_dir} "
                    f"not done after {CLOSE_TIMEOUT_S} s")
        self._raise()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def latest_step(work_dir: str) -> Optional[int]:
    steps = _steps(work_dir)
    return max(steps) if steps else None


def restore_checkpoint(work_dir: str, state: TrainState
                       ) -> Optional[TrainState]:
    """Load the newest checkpoint into ``state`` in place (strict: every
    key must match); None where there is none."""
    step = latest_step(work_dir)
    if step is None:
        return None
    ckpt = torch.load(_path(work_dir, step), map_location="cpu",
                      weights_only=True)
    state.model.load_state_dict(ckpt["model"], strict=True)
    names = _param_names(state)
    opt = state.optimizer
    with torch.no_grad():
        for (ps, _), mu, nu in zip(opt.groups, opt.mu, opt.nu):
            for p, m, v in zip(ps, mu, nu):
                m.copy_(ckpt["optimizer"]["mu"][names[id(p)]])
                v.copy_(ckpt["optimizer"]["nu"][names[id(p)]])
        if state.ema is not None:
            if ckpt["ema_model"] is None:
                raise KeyError("the checkpoint holds no EMA shadow")
            for k, v in state.ema.shadow.items():
                v.copy_(ckpt["ema_model"][k])
    opt.count = int(ckpt["optimizer"]["step"])
    return state


def merge_pretrained(model: nn.Module, pretrained: Dict[str, torch.Tensor]
                     ) -> Tuple[int, int]:
    """strict=False load: every entry of ``pretrained`` whose name and
    shape match one of the model's parameters or buffers (the batch-norm
    running statistics too) is copied in, the rest skipped; returns
    (loaded, skipped)."""
    own = model.state_dict()
    loaded = skipped = 0
    with torch.no_grad():
        for k, v in pretrained.items():
            if k in own and tuple(own[k].shape) == tuple(v.shape):
                own[k].copy_(v)
                loaded += 1
            else:
                skipped += 1
    if skipped:
        print(f"[checkpoint] merged pretrained: {loaded} loaded, "
              f"{skipped} skipped (missing/shape-mismatch)")
    return loaded, skipped
