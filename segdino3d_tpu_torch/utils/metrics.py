"""Windowed metric meters and the training loop's logger.

Counterpart of ``segdino3d_tpu/utils/metrics.py``: windowed medians and
averages of loss scalars, iteration and data timing with an ETA, and
``find_zero_grad_params``, which lists the parameters whose gradient is
all zero (the unused-parameter check).
"""
from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque
from typing import Dict, Iterable, Optional


class SmoothedValue:
    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        self.deque.append(float(value))
        self.count += n
        self.total += float(value) * n

    @property
    def median(self):
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self):
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            value=self.value)


class MetricLogger:
    def __init__(self, delimiter: str = "  ", logger=None):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.logger = logger

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def _log(self, msg):
        if self.logger is not None:
            self.logger.info(msg)
        else:
            print(msg, flush=True)

    def log_every(self, iterable: Iterable, print_freq: int,
                  header: str = "", total: Optional[int] = None):
        i = 0
        total = total if total is not None else getattr(iterable, "__len__", lambda: None)()
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        end = time.time()
        for obj in iterable:
            data_time.update(time.time() - end)
            yield i, obj
            iter_time.update(time.time() - end)
            end = time.time()
            if i % print_freq == 0 or (total and i == total - 1):
                if total:
                    eta = iter_time.global_avg * (total - i)
                    eta_str = str(datetime.timedelta(seconds=int(eta)))
                else:
                    eta_str = "?"
                meters = self.delimiter.join(
                    f"{k}: {v}" for k, v in self.meters.items())
                self._log(self.delimiter.join([
                    header, f"[{i}/{total}]", f"eta: {eta_str}", meters,
                    f"time: {iter_time}", f"data: {data_time}"]))
            i += 1
        elapsed = time.time() - start
        self._log(f"{header} done in {datetime.timedelta(seconds=int(elapsed))} "
                  f"({elapsed / max(i, 1):.4f} s/it)")


def find_zero_grad_params(named_parameters, eps: float = 0.0):
    """The names of the parameters whose ``.grad`` is None or has no
    element above ``eps`` in magnitude (unused parameters show up here)."""
    out = []
    for name, p in named_parameters:
        if p.grad is None or float(p.grad.detach().abs().max()) <= eps:
            out.append(name)
    return out
