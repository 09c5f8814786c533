"""The data loaders: training batches and eval batches, on the device.

Counterpart of ``segdino3d_tpu/data/loader.py`` on one device.

``TrainLoader`` streams training batches without end: an epoch-shuffled
index stream (leftovers carry over into the next epoch), sharded over
``process_count`` processes, each batch with one sync scale drawn from
``(seed, epoch, pos)`` and each record with its own ``RandomState`` of
``(seed, epoch, pos, k, process_index)``, the JAX loader's seeds, so its
records and batches are bit-equal to the JAX package's.  With
``mesh_shards`` > 1 a batch is a list of ``mesh_shards`` ``SceneBatch``es
(the training step's microbatches), each with its own host plan.  Batches
are built on the CPU (records, collate, the C++ host plan) in one of three
``worker_mode``s: ``sync`` inline; ``thread``, producer threads over a
record thread pool; ``process``, ``spawn``ed worker processes that never
touch the card and return each batch through shared memory
(``data.shm_transport``) or the result queue.  The consumer moves each
batch to ``device``; an error in a thread or a worker, a worker that
dies, or no batch within ``receive_timeout_s`` (a worker or thread that
is alive but stuck) is raised in the consumer.

``EvalLoader`` reads scenes ``batch_size`` at a time, pads them to a fixed
``pad_spec`` or to the smallest rungs of a ``bucket_policy`` that hold the
batch, and gives each a host plan (``host_plan_cfg``:
``data.collate.attach_host_plan`` arguments).  With ``prefetch`` > 0 one
background thread builds up to that many batches ahead (record IO, the
val transforms, the collate and the C++ plan of scene i + 1 while the
device runs scene i); it builds them on the CPU, and the consumer moves
each to ``device``, so only the consumer's thread touches the device.  An
error in the thread is raised in the consumer.

``prescan_caps``: before the first batch, one count-only pass over the
set (``ops.host_plan.probe_plan_counts``) pins one plan capacity vector
per pad rung: the level-0 voxel cap, each level's measured voxel count,
block caps, the level-0 layout (the JAX package's budget crossover), and
the compacted stem's overflow capacity where ``stem_compact`` is on.  Every
scene of a rung then gets tables of one shape.  It applies with a
``bucket_policy`` and a ``host_plan_cfg`` that pins neither ``voxel_cap``
nor ``block_caps``.

``cache_dir``: the eval batch cache (``data.eval_cache``).  The first pass
writes each CPU batch with the slim records the eval driver reads; a later
loader with the same data and settings serves them from a memory map.

``mesh_shards`` > 1 gives each batch as a list of ``mesh_shards``
``SceneBatch``es of ``batch_size / mesh_shards`` scenes, each with its own
host plan, a partial tail padded by repeating its last scene (only the
real records are yielded).  ``process_index`` / ``process_count`` shard
the global batches round-robin (process p takes batches p, p + count,
...), so every process sees the batches of a one-process run; the prescan
still covers the whole set, so every process pins the same capacities.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from segdino3d_tpu_torch.data.collate import (PadSpec, _plan_coords,
                                              attach_host_plan, collate,
                                              map_leaves, to_device)
from segdino3d_tpu_torch.device import resolve_device
from segdino3d_tpu_torch.ops.host_plan import (l0_dense_budget_bytes,
                                               l0_dense_fits,
                                               overflow_bucket,
                                               probe_plan_counts,
                                               stem_slots_default)


class ConcatDataset:
    """Several readers behind one index space."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def get_record(self, idx: int, rng=None, sync_scale=None) -> Dict:
        di = int(np.searchsorted(self._offsets, idx, side="right") - 1)
        return self.datasets[di].get_record(
            idx - int(self._offsets[di]), rng, sync_scale=sync_scale)


# a batch slower than this is a stuck worker, not a slow one: a
# full-size training batch takes seconds
RECEIVE_TIMEOUT_S = 600.0


def _get(q, timeout_s: float, check, what: str):
    """The next item of ``q``.  While none comes, ``check()`` raises when
    the producers are gone; after ``timeout_s`` (producers alive but
    stuck) a ``RuntimeError`` says ``what`` waited."""
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            return q.get(timeout=min(1.0, timeout_s))
        except queue.Empty:
            check()
            if time.monotonic() >= deadline:
                raise RuntimeError(f"{what}: nothing within {timeout_s} s"
                                   ) from None


def _to_numpy(tree):
    return map_leaves(tree, lambda x: x.numpy()
                      if isinstance(x, torch.Tensor) else x)


def _to_torch(tree):
    return map_leaves(tree, lambda x: torch.from_numpy(x)
                      if isinstance(x, np.ndarray) else x)


def _batch_worker_main(task_q, result_q, loader):
    """A process-mode worker: builds whole CPU batches (records, collate,
    host plan) with ``loader`` (a pickled copy) and returns them with
    numpy leaves, through shared memory with ``shm_transport`` (segments
    named by the process group's rank, the worker's pid and the batch, so
    that no two ranks on a host pick one name).  It stops on its sentinel
    or when its parent is gone, and never touches the card."""
    from segdino3d_tpu_torch.data.shm_transport import encode

    torch.set_num_threads(1)
    parent = mp.parent_process()
    while True:
        try:
            task = task_q.get(timeout=1.0)
        except queue.Empty:
            if parent is not None and not parent.is_alive():
                return
            continue
        if task is None:
            return
        seq = task[0]
        try:
            b = _to_numpy(loader._make_batch(*task[1:]))
            if loader.shm_transport:
                b = encode(b, name=f"segdino_r{loader.process_index}_"
                           f"{os.getpid()}_{seq}")
            result_q.put((seq, b))
        except Exception as e:      # raised in the consumer
            result_q.put((seq, e))


class TrainLoader:
    """Endless shuffled training batches on ``device`` (see the module's
    docstring); the device is the card unless the caller names one."""

    def __init__(self, dataset, batch_size: int, pad_spec: PadSpec,
                 seed: int = 0, sync_scale: bool = True,
                 scale_range=(0.8, 1.2), num_workers: int = 4,
                 prefetch: int = 2, process_index: int = 0,
                 process_count: int = 1, mesh_shards: int = 1,
                 host_plan_cfg: Optional[Dict] = None,
                 worker_mode: str = "thread", shm_transport: bool = True,
                 device=None, receive_timeout_s: float = RECEIVE_TIMEOUT_S):
        if worker_mode not in ("sync", "thread", "process"):
            raise ValueError(f"worker_mode {worker_mode!r}")
        if batch_size % mesh_shards:
            raise ValueError(f"batch_size {batch_size} is not a multiple of "
                             f"mesh_shards {mesh_shards}")
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} of "
                             f"{process_count}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.pad_spec = pad_spec
        self.seed = seed
        self.sync_scale = sync_scale
        self.scale_range = scale_range
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.process_index = process_index
        self.process_count = process_count
        self.mesh_shards = mesh_shards
        self.host_plan_cfg = host_plan_cfg
        self.worker_mode = worker_mode if num_workers > 0 else "sync"
        self.shm_transport = shm_transport
        self.device = resolve_device(device)
        self.receive_timeout_s = receive_timeout_s
        self._pool = None

    def _index_stream(self) -> Iterator:
        """(indices, epoch, pos) of each batch: each epoch a permutation
        from ``RandomState(seed + epoch)``, this process's shard of it
        (DistributedSampler's: same seed, disjoint shards), leftovers
        carried into the next epoch."""
        epoch = 0
        n = len(self.dataset)
        carry: List[int] = []
        pos = 0
        while True:
            rng = np.random.RandomState(self.seed + epoch)
            perm = rng.permutation(n)
            carry.extend(int(x) for x in
                         perm[self.process_index::self.process_count])
            while len(carry) >= self.batch_size:
                yield carry[:self.batch_size], epoch, pos
                carry = carry[self.batch_size:]
                pos += self.batch_size
            epoch += 1
            pos = 0

    def _make_batch(self, idxs, epoch, pos):
        """The CPU batch of ``idxs``: a ``SceneBatch``, or with
        ``mesh_shards`` > 1 a list of them."""
        # one scale per batch, the same in every process for (epoch, pos)
        scale = None
        if self.sync_scale:
            srng = np.random.RandomState(
                hash((self.seed, epoch, pos)) % (2 ** 31))
            scale = float(srng.uniform(*self.scale_range))

        def load_one(k_idx):
            k, idx = k_idx
            rng = np.random.RandomState(
                hash((self.seed, epoch, pos, k, self.process_index))
                % (2 ** 31))
            return self.dataset.get_record(idx, rng, sync_scale=scale)

        pool = self._record_pool()
        records = (list(pool.map(load_one, enumerate(idxs))) if pool
                   else [load_one(ki) for ki in enumerate(idxs)])

        def one(recs):
            b = collate(recs, self.pad_spec, "cpu")
            if self.host_plan_cfg:
                b = attach_host_plan(b, recs, self.pad_spec,
                                     **self.host_plan_cfg)
            return b

        if self.mesh_shards <= 1:
            return one(records)
        per = len(records) // self.mesh_shards
        return [one(records[i * per:(i + 1) * per])
                for i in range(self.mesh_shards)]

    def _record_pool(self):
        """The thread pool of thread mode's record loads, else None."""
        if self.num_workers <= 1 or self.worker_mode != "thread":
            return None
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=self.num_workers)
        return self._pool

    def __getstate__(self):
        # a process-mode worker gets a copy of the loader, not its pool
        state = dict(self.__dict__)
        state["_pool"] = None
        return state

    def __iter__(self):
        if self.worker_mode == "process":
            yield from self._iter_process()
            return
        for batch in self._produced():
            yield to_device(batch, self.device)

    def _produced(self):
        """CPU batches, in order, in sync or thread mode."""
        if self.worker_mode == "sync":
            for item in self._index_stream():
                yield self._make_batch(*item)
            return
        # `prefetch` producers build batches at once (each over the shared
        # record pool); a sequence-numbered reorder keeps the order
        n_prod = max(1, min(self.prefetch, 4))
        q: queue.Queue = queue.Queue(maxsize=self.prefetch + n_prod)
        stop = threading.Event()
        lock = threading.Lock()
        stream = enumerate(self._index_stream())

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            while not stop.is_set():
                with lock:
                    seq, item = next(stream)
                try:
                    if not put((seq, self._make_batch(*item))):
                        return
                except Exception as e:   # raised in the consumer
                    put((seq, e))
                    return

        threads = [threading.Thread(target=producer, daemon=True)
                   for _ in range(n_prod)]
        for t in threads:
            t.start()

        def producers():
            if not any(t.is_alive() for t in threads):
                raise RuntimeError("train loader: the producer threads "
                                   "exited")

        try:
            pending = {}
            want = 0
            while True:
                while want not in pending:
                    seq, b = _get(q, self.receive_timeout_s, producers,
                                  f"train loader threads, waiting for batch "
                                  f"{want}")
                    pending[seq] = b
                b = pending.pop(want)
                if isinstance(b, BaseException):
                    raise b
                yield b
                want += 1
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=60.0)

    def _iter_process(self):
        """``num_workers`` spawned processes build whole batches; the order
        is kept by sequence numbers.  Each batch is moved to the device
        before its shared memory is released; on the CPU the batch's
        tensors are views into it, released once the consumer has moved on
        (``Graveyard``)."""
        from segdino3d_tpu_torch.data.shm_transport import (Graveyard,
                                                            decode, track)

        ctx = mp.get_context("spawn")
        task_q = ctx.Queue()
        result_q = ctx.Queue()
        procs = [ctx.Process(target=_batch_worker_main,
                             args=(task_q, result_q, self), daemon=True)
                 for _ in range(self.num_workers)]
        for p in procs:
            p.start()
        stream = enumerate(self._index_stream())
        graveyard = Graveyard()
        pending = {}

        def workers():
            # a worker only exits on its sentinel: one that is gone died
            dead = [p for p in procs if not p.is_alive()]
            if dead:
                raise RuntimeError(f"loader worker {dead[0].pid} exited with "
                                   f"code {dead[0].exitcode}")

        try:
            for _ in range(self.num_workers + self.prefetch):
                seq, item = next(stream)
                task_q.put((seq, *item))
            want = 0
            while True:
                while want not in pending:
                    seq, b = _get(result_q, self.receive_timeout_s, workers,
                                  f"train loader workers "
                                  f"{[p.pid for p in procs]}, waiting for "
                                  f"batch {want}")
                    pending[seq] = track(b)
                b = pending.pop(want)
                if isinstance(b, BaseException):
                    raise b
                b, shm = decode(b)
                seq, item = next(stream)
                task_q.put((seq, *item))
                graveyard.sweep()
                batch = to_device(_to_torch(b), self.device)
                del b
                if self.device.type != "cpu":
                    # the copy to the card was synchronous (pageable)
                    graveyard.add(shm)
                    shm = None
                yield batch
                del batch
                graveyard.add(shm)
                want += 1
        finally:
            _shut_down(procs, task_q, result_q, pending, graveyard)


def _shut_down(procs, task_q, result_q, pending, graveyard):
    """Stop the workers: a sentinel each, then read results while joining
    (a worker's exit waits for its queue feeder to flush), terminate
    stragglers after 15 s (and never read the queue after a terminate: a
    frame cut short would block the reader), unlink the segments of
    batches never decoded, and close the decoded ones."""
    import multiprocessing.shared_memory as msm

    from segdino3d_tpu_torch.data.shm_transport import ShmBatch, track

    try:
        for _ in procs:
            task_q.put_nowait(None)
    except Exception:
        pass
    deadline = time.monotonic() + 15.0
    while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
        try:
            seq, b = result_q.get(timeout=0.1)
            pending.setdefault(seq, track(b))
        except (queue.Empty, OSError, EOFError):
            pass
        for p in procs:
            if not p.is_alive():
                p.join(timeout=0)
    terminated = False
    for p in procs:
        if p.is_alive():
            p.terminate()
            terminated = True
    if not terminated:
        while True:
            try:
                seq, b = result_q.get_nowait()
                pending.setdefault(seq, track(b))
            except (queue.Empty, OSError, EOFError):
                break
    for p in procs:
        p.join(timeout=1.0)
    for item in pending.values():
        if isinstance(item, ShmBatch):
            try:
                msm.SharedMemory(name=item.name).unlink()
            except Exception:
                pass
    graveyard.drain()


class EvalLoader:
    """Yields (records, SceneBatch on ``device``) over the first ``limit``
    scenes of ``dataset`` (any object with ``__len__`` and
    ``get_record(idx, rng)``)."""

    def __init__(self, dataset, pad_spec: Optional[PadSpec] = None,
                 limit: Optional[int] = None, batch_size: int = 1,
                 bucket_policy=None, host_plan_cfg: Optional[Dict] = None,
                 prefetch: int = 1, prescan_caps: bool = True, device=None,
                 mesh_shards: int = 1, cache_dir: Optional[str] = None,
                 process_index: int = 0, process_count: int = 1):
        if pad_spec is None and bucket_policy is None:
            raise ValueError("EvalLoader needs a pad_spec or a "
                             "bucket_policy")
        if mesh_shards < 1 or batch_size % mesh_shards:
            raise ValueError(f"batch_size {batch_size} is not a multiple of "
                             f"mesh_shards {mesh_shards}")
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} of "
                             f"{process_count}")
        self.dataset = dataset
        self.pad_spec = pad_spec
        self.limit = limit
        self.batch_size = batch_size
        self.bucket_policy = bucket_policy
        self.host_plan_cfg = host_plan_cfg
        self.prefetch = prefetch
        self.prescan_caps = prescan_caps
        self.cache_dir = cache_dir
        self.mesh_shards = mesh_shards
        self.process_index = process_index
        self.process_count = process_count
        self.device = resolve_device(device)
        self._rung_caps: Optional[Dict] = None
        self._cache_obj = None

    @property
    def num_scenes(self) -> int:
        n = len(self.dataset)
        return min(n, self.limit) if self.limit else n

    def __len__(self):
        """The number of this process's batches."""
        gb = -(-self.num_scenes // self.batch_size)
        return -(-(gb - self.process_index) // self.process_count)

    def _batches(self, mine: bool = True):
        """(records, padded records, pad spec) of each batch in order, of
        this process's share (``mine``) or of the whole set; the padded
        records fill a partial tail to ``batch_size`` with ``mesh_shards``
        > 1.  The readers' random draws come from one ``RandomState(0)``
        stream over the batches read, as in the JAX loader."""
        rng = np.random.RandomState(0)
        n = self.num_scenes
        for gi, lo in enumerate(range(0, n, self.batch_size)):
            if mine and gi % self.process_count != self.process_index:
                continue
            recs = [self.dataset.get_record(i, rng)
                    for i in range(lo, min(lo + self.batch_size, n))]
            padded = recs
            if self.mesh_shards > 1 and len(recs) < self.batch_size:
                padded = recs + [recs[-1]] * (self.batch_size - len(recs))
            yield recs, padded, (self.bucket_policy.spec_for(padded)
                                 if self.bucket_policy is not None
                                 else self.pad_spec)

    def _shards(self, padded):
        """The record lists of a batch's ``mesh_shards`` shards."""
        per = self.batch_size // self.mesh_shards
        return [padded[i:i + per] for i in range(0, len(padded), per)]

    def _prescan(self) -> Dict:
        """{pad spec: plan capacities} of every occupied rung (see the
        module's docstring), computed once."""
        if self._rung_caps is not None:
            return self._rung_caps
        cfg = self.host_plan_cfg or {}
        self._rung_caps = {}
        if (not self.prescan_caps or self.bucket_policy is None or not cfg
                or cfg.get("voxel_cap") or cfg.get("block_caps")):
            return self._rung_caps
        edges = list(cfg.get("block_edges") or [])
        num_levels = cfg.get("num_levels", 5)
        stem_kernel = cfg.get("stem_kernel", 5)
        probe_stem = stem_kernel != 3 and bool(cfg.get("stem_compact"))
        stem_d = stem_slots_default(cfg.get("stem_compact_slots"))
        per_rung: Dict = {}
        for _, padded, spec in self._batches(mine=False):
            for sub in self._shards(padded):
                coords, valid, bidx = _plan_coords(
                    sub, spec.num_points, cfg.get("voxel_size", 0.02),
                    cfg.get("exact_min_shift", False))
                voxels, blocks, stem_ov = probe_plan_counts(
                    coords.reshape(-1, 3), bidx, valid.reshape(-1), edges,
                    num_levels, stem_kernel=stem_kernel if probe_stem else 0,
                    stem_slots=stem_d)
                acc = per_rung.setdefault(
                    spec, [np.zeros(num_levels, np.int64),
                           np.zeros(num_levels, np.int64), 0])
                np.maximum(acc[0], voxels, out=acc[0])
                np.maximum(acc[1], blocks, out=acc[1])
                acc[2] = max(acc[2], stem_ov)
        for spec, (voxels, blocks, stem_ov) in per_rung.items():
            block_caps = [0 if i >= len(edges) or not edges[i]
                          else -(-int(b) // 16) * 16
                          for i, b in enumerate(blocks)]
            rung_edges = list(edges) if edges else None
            if rung_edges and rung_edges[0] and not l0_dense_fits(
                    block_caps[0], rung_edges[0], l0_dense_budget_bytes()):
                # the whole rung runs level 0 in the gather layout
                rung_edges[0] = block_caps[0] = 0
            caps = dict(voxel_cap=-(-int(voxels[0]) // 256) * 256,
                        block_caps=block_caps, block_edges=rung_edges,
                        level_caps=[int(v) for v in voxels])
            if probe_stem:
                caps["stem_ov_cap"] = overflow_bucket(max(4096, int(stem_ov)))
            self._rung_caps[spec] = caps
        return self._rung_caps

    @property
    def cache(self):
        """The ``eval_cache.EvalBatchCache`` of this loader's data and
        settings, or None without ``cache_dir``."""
        if self.cache_dir is None:
            return None
        if self._cache_obj is None:
            from segdino3d_tpu_torch.data import eval_cache as ec

            cfg = dict(package="segdino3d_tpu_torch",
                       ds=ec.dataset_fingerprint(self.dataset),
                       limit=self.limit, batch_size=self.batch_size,
                       mesh_shards=self.mesh_shards,
                       proc=(self.process_index, self.process_count),
                       spec=repr(self.pad_spec),
                       bucket=repr(self.bucket_policy),
                       plan=ec.stable_repr(self.host_plan_cfg),
                       prescan=self.prescan_caps)
            self._cache_obj = ec.EvalBatchCache(
                self.cache_dir, ec.config_key(**cfg),
                config_note=ec.stable_repr(cfg))
        return self._cache_obj

    def _iter_cpu(self):
        """(records, CPU batch) of each batch: built, built and written to
        the cache, or served from it (slim records; on the CPU copied out
        of the read-only map)."""
        cache = self.cache
        if cache is None:
            yield from self._iter_build()
        elif cache.complete():
            for recs, batch in cache.iter_batches():
                if self.device.type == "cpu":
                    batch = map_leaves(batch, lambda x: x.clone()
                                       if isinstance(x, torch.Tensor) else x)
                yield recs, batch
        else:
            yield from cache.write_through(self._iter_build())

    def _build_one(self, recs, spec):
        batch = collate(recs, spec, "cpu")
        if self.host_plan_cfg:
            cfg = dict(self.host_plan_cfg)
            cfg.update(self._prescan().get(spec, {}))
            batch = attach_host_plan(batch, recs, spec, **cfg)
        return batch

    def _iter_build(self):
        """(records, batch on the CPU) of each of this process's batches,
        in order; the batch a list of shards with ``mesh_shards`` > 1."""
        for recs, padded, spec in self._batches():
            if self.mesh_shards <= 1:
                yield recs, self._build_one(recs, spec)
            else:
                yield recs, [self._build_one(sub, spec)
                             for sub in self._shards(padded)]

    def __iter__(self):
        for recs, batch in self._produced():
            yield recs, to_device(batch, self.device)

    def _produced(self):
        if self.prefetch <= 0:
            yield from self._iter_cpu()
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        end = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for item in self._iter_cpu():
                    if not put(item):
                        return
                put(end)
            except BaseException as e:   # raised in the consumer
                put(e)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()

        def producer_alive():
            if not thread.is_alive():
                raise RuntimeError("eval loader: the producer thread exited")

        try:
            while True:
                item = _get(q, RECEIVE_TIMEOUT_S, producer_alive,
                            "eval loader")
                if item is end:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            thread.join(timeout=60.0)
