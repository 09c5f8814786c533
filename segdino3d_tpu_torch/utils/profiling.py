"""Profiling on ``torch.profiler``.

Counterpart of ``segdino3d_tpu/utils/profiling.py``:

* ``start_trace(dir)`` / ``stop_trace()``: profile the host and, where
  there is one, the card between the two calls and write a Chrome trace
  (``trace.json``) under ``dir`` (the train loop passes
  ``work_dir/profile`` for ``--profile_steps``);
* ``trace(dir)``: the same around a block;
* ``annotate(name)``: a named range in the trace (``record_function``);
* ``device_memory_summary()``: memory in use and peak memory of the card,
  from ``torch.cuda``'s statistics.

The JAX package's ``start_server`` (a live trace server) has no
counterpart here.
"""
from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

_active: Optional[profile] = None
_log_dir: Optional[str] = None


def start_trace(log_dir: str):
    """Begin a trace (the train engine opens it at ``profile_steps[0]``
    and closes it after ``profile_steps[1]``)."""
    global _active, _log_dir
    if _active is not None:
        raise RuntimeError("a trace is already running")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    _active = profile(activities=activities)
    _active.start()
    _log_dir = log_dir


def stop_trace() -> str:
    """End the trace and write it; returns the trace file's path."""
    global _active, _log_dir
    if _active is None:
        raise RuntimeError("no trace is running")
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof, log_dir = _active, _log_dir
    _active = _log_dir = None
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: str):
    start_trace(log_dir)
    try:
        yield
    finally:
        stop_trace()


def annotate(name: str):
    return record_function(name)


def device_memory_summary() -> str:
    if not torch.cuda.is_available():
        return "device memory stats unavailable (no CUDA device)"
    lines = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        used = stats.get("allocated_bytes.all.current", 0) / 2 ** 30
        peak = stats.get("allocated_bytes.all.peak", 0) / 2 ** 30
        lines.append(f"cuda:{i} ({torch.cuda.get_device_name(i)}): "
                     f"{used:.3f} GiB in use, {peak:.3f} GiB peak")
    return "\n".join(lines)
