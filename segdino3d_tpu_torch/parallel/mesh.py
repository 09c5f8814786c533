"""Process groups: ``torch.distributed`` in place of the JAX mesh.

Counterpart of ``segdino3d_tpu/parallel/mesh.py``.  Where the JAX package
runs data parallelism as ``shard_map`` over a ``data`` mesh axis, the port
runs one process per card (``python -m torch.distributed.run
--nproc_per_node N ...``): each process steps its own scenes and the
gradients, losses and batch-norm statistics are averaged over the group
with plain collectives after the backward (``parallel.train_step``).

The group comes from torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) or from an explicit
``init_method`` (a ``file://`` store in the tests).  With neither, the
program is one process and every function here is that process's answer
(JAX's no-op).  The backend is NCCL for a process on the card and gloo on
the CPU; a process on the card uses ``cuda:LOCAL_RANK``.

Unlike ``segdino3d_tpu.parallel.mesh.init_distributed``, which swallows
every exception, a group that the environment names and that fails to
form raises.
"""
from __future__ import annotations

import datetime
import os
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

# long enough for a rank that builds its kernels or its eval cache while
# the others wait at a collective
DEFAULT_TIMEOUT_S = 1800.0
# a gloo group of every process beside an NCCL one, for host flags that
# must not wait on the card (None: the default group is gloo already)
_HOST_GROUP = None


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0))


def local_device(device: torch.device) -> torch.device:
    """``device`` with the card index of this process: ``cuda:LOCAL_RANK``
    for a card, the CPU as it is."""
    if device.type != "cuda":
        return device
    return torch.device("cuda", local_rank())


def init_distributed(device: Optional[torch.device] = None,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     backend: Optional[str] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group the environment (or ``init_method`` with
    ``rank`` and ``world_size``) names; False where there is none (one
    process).  ``backend`` defaults to NCCL for a ``device`` on the card,
    else gloo.  Raises when the group fails to form."""
    if dist.is_initialized():
        return True
    if init_method is None:
        if "WORLD_SIZE" not in os.environ:
            return False
        init_method = "env://"
    elif rank is None or world_size is None:
        raise ValueError("init_method needs rank and world_size")
    if backend is None:
        backend = ("nccl" if device is not None and device.type == "cuda"
                   else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    kw = {} if rank is None else dict(rank=rank, world_size=world_size)
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method,
                            timeout=timeout, **kw)
    global _HOST_GROUP
    _HOST_GROUP = (None if backend == "gloo"
                   else dist.new_group(backend="gloo", timeout=timeout))
    return True


def shutdown_distributed() -> None:
    global _HOST_GROUP
    _HOST_GROUP = None
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_is_main() -> bool:
    return process_index() == 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Replace each tensor by its mean over ``group`` (default: the whole
    group), in place: one all-reduce per dtype, over a flat buffer of
    that dtype's tensors."""
    if not dist.is_initialized():
        return
    n = dist.get_world_size(group)
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            dist.all_reduce(flat, group=group)
            flat.div_(n)
            pos = 0
            for t in ts:
                k = t.numel()
                t.copy_(flat[pos:pos + k].view_as(t))
                pos += k


def any_flag(flag: bool) -> bool:
    """Whether ``flag`` is set on any process (one all-reduce of a host
    tensor over gloo: it waits for the other processes, never for the
    card); ``flag`` itself in one process."""
    if not dist.is_initialized():
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_HOST_GROUP)
    return bool(t.item())
