"""Shared-memory transport of loader worker batches.

Counterpart of ``segdino3d_tpu/data/shm_transport.py``.  The process-mode
``loader.TrainLoader`` builds batches in spawned workers; returned through a
``multiprocessing.Queue`` each array would be pickled in the worker, pushed
through a pipe and unpickled (copied) again in the consumer.  Here the
worker pickles the batch (its tensor leaves as numpy arrays) with protocol
5 and a ``buffer_callback``, copies the out-of-band buffers into one POSIX
shared-memory segment and sends only a descriptor (segment name, the
in-band pickle, offsets); the consumer attaches the segment and
``pickle.loads(..., buffers=...)`` rebuilds the arrays as views into the
mapping, with no copy.  Below ``MIN_SHM_BYTES`` of payload the batch goes
through the queue as it is.  A batch larger than the free space of
``/dev/shm`` raises (``ShmSpaceError``, with both sizes): a mapping past
the end of the tmpfs would kill the process that touches it with SIGBUS.

Lifetime: the worker closes its handle and unregisters the segment from
its resource tracker, so the consumer owns it; the consumer registers it
with its own tracker on receipt (``track``), unlinks the name right after
decoding (the memory lives until the last mapping closes), and parks the
mapping in a ``Graveyard`` whose ``sweep`` closes it once no view is left.
"""
from __future__ import annotations

import os
import pickle
from multiprocessing import resource_tracker, shared_memory
from typing import Any, List, Optional, Tuple

# below this many payload bytes the segment setup costs more than the
# pipe copy it saves: small batches go through the queue as they are
# (the environment variable lets a test force the shm path)
MIN_SHM_BYTES = int(os.environ.get("SEGDINO_SHM_MIN_BYTES", 1 << 20))
SHM_DIR = "/dev/shm"


class ShmSpaceError(OSError):
    """A batch does not fit in the free space of ``SHM_DIR``."""


def shm_free_bytes() -> int:
    st = os.statvfs(SHM_DIR)
    return st.f_bavail * st.f_frsize


def check_shm_space(nbytes: int) -> None:
    """Raise ``ShmSpaceError`` unless ``nbytes`` fit in ``SHM_DIR`` now."""
    free = shm_free_bytes()
    if nbytes > free:
        raise ShmSpaceError(
            f"a {nbytes}-byte batch does not fit in {SHM_DIR}, which has "
            f"{free} bytes free: enlarge it (docker --shm-size) or set "
            f"shm_transport=False")


class _Segment(shared_memory.SharedMemory):
    """Parent-side mapping whose finalizer tolerates live consumer views.

    ``SharedMemory.__del__`` calls ``close()``, which raises
    ``BufferError`` while the consumer still holds array views into the
    mapping — at generator shutdown that surfaces as unraisable-exception
    noise.  The memory itself is reclaimed by the kernel at process exit
    regardless (the name is unlinked right after decode)."""

    def __del__(self):
        try:
            super().__del__()
        except BufferError:
            pass


class ShmBatch:
    """Queue-side descriptor: everything needed to rebuild the batch."""

    __slots__ = ("name", "payload", "offsets")

    def __init__(self, name: str, payload: bytes,
                 offsets: List[Tuple[int, int]]):
        self.name = name
        self.payload = payload
        self.offsets = offsets


def encode(obj: Any, min_bytes: int = MIN_SHM_BYTES,
           name: Optional[str] = None):
    """Worker side: return ``obj`` itself (small) or a ``ShmBatch`` whose
    segment is called ``name`` (default: a random name).

    Raises ``ShmSpaceError`` when the payload does not fit in the free
    space of ``SHM_DIR``.
    """
    buffers: List[pickle.PickleBuffer] = []
    payload = pickle.dumps(obj, protocol=5, buffer_callback=buffers.append)
    try:
        # raw() requires C-contiguity; numpy emits PickleBuffers for
        # F-contiguous arrays too, which must fall back to queue pickling
        raws = [b.raw().cast("B") for b in buffers]
    except BufferError:
        return obj
    total = sum(r.nbytes for r in raws)
    if total < min_bytes:
        return obj
    check_shm_space(total)
    shm = shared_memory.SharedMemory(name=name, create=True, size=total)
    offsets: List[Tuple[int, int]] = []
    pos = 0
    for r in raws:
        n = r.nbytes
        shm.buf[pos:pos + n] = r
        offsets.append((pos, n))
        pos += n
    name = shm.name
    # hand ownership to the parent: without this, the worker's resource
    # tracker would also try to unlink the name at shutdown and warn
    try:
        resource_tracker.unregister(shm._name, "shared_memory")
    except Exception:
        pass
    shm.close()
    return ShmBatch(name, payload, offsets)


def track(item: Any):
    """Register a received descriptor's segment with THIS process's
    resource tracker.  Call at queue-receipt time: between the worker's
    ``unregister`` and here nobody owns the segment, so registering as
    early as possible means even a hard parent kill (SIGTERM skips
    ``finally``) leaves the tracker to unlink it.  ``unlink()`` (in
    ``decode`` / the loader's shutdown sweep) unregisters the same name,
    keeping the tracker balanced."""
    if isinstance(item, ShmBatch):
        name = item.name if item.name.startswith("/") else "/" + item.name
        try:
            resource_tracker.register(name, "shared_memory")
        except Exception:
            pass
    return item


def decode(item: Any):
    """Parent side: return ``(batch, shm_or_None)``.

    When ``item`` is a ``ShmBatch`` the returned batch's array leaves are
    views into the shared mapping; the segment name is already unlinked,
    and the caller must keep the returned ``SharedMemory`` object alive
    until the consumer drops the arrays, then ``close()`` it (see
    ``Graveyard``).  Callers that received ``item`` from a worker queue
    should have passed it through ``track`` first.
    """
    if not isinstance(item, ShmBatch):
        return item, None
    track(item)  # idempotent (tracker cache is a set); pairs with unlink
    shm = _Segment(name=item.name)
    views = [shm.buf[off:off + n] for off, n in item.offsets]
    batch = pickle.loads(item.payload, buffers=views)
    del views
    shm.unlink()  # name gone; memory lives until the mapping closes
    return batch, shm


class Graveyard:
    """Deferred ``close()`` of decoded segments.

    ``close()`` raises ``BufferError`` while the consumer still holds
    array views into the mapping, so retire segments lazily: ``add``
    after yielding a batch, ``sweep`` once per iteration, ``drain`` on
    generator shutdown (best effort — an unclosed mapping is reclaimed
    by the kernel at process exit since the name is already unlinked).
    """

    def __init__(self):
        self._pending: List[shared_memory.SharedMemory] = []

    def add(self, shm: Optional[shared_memory.SharedMemory]):
        if shm is not None:
            self._pending.append(shm)

    def sweep(self):
        kept = []
        for shm in self._pending:
            try:
                shm.close()
            except BufferError:
                kept.append(shm)
        self._pending = kept

    def drain(self):
        self.sweep()
        self._pending.clear()
