"""The eval loader: records -> padded batches with host plans, in order.

Counterpart of ``segdino3d_tpu/data/loader.py:EvalLoader`` on one process
and one device.  Scenes are read ``batch_size`` at a time, padded to a
fixed ``pad_spec`` or to the smallest rungs of a ``bucket_policy`` that
hold the batch, and given a host plan (``host_plan_cfg``:
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

Mesh sharding, multi-process sharding and the batch cache wait for the
distribution and cache slices, and the training loader for the
training-data slice.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Optional

import numpy as np

from segdino3d_tpu_torch.data.collate import (PadSpec, _plan_coords,
                                              attach_host_plan, collate,
                                              to_device)
from segdino3d_tpu_torch.device import resolve_device
from segdino3d_tpu_torch.ops.host_plan import (L0_BUDGET_BYTES,
                                               l0_dense_fits,
                                               overflow_bucket,
                                               probe_plan_counts,
                                               stem_slots_default)


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
        if mesh_shards != 1:
            raise NotImplementedError("mesh_shards: mesh-sharded eval comes "
                                      "with the distribution slice")
        if (process_index, process_count) != (0, 1):
            raise NotImplementedError("process_index/process_count: "
                                      "multi-process eval comes with the "
                                      "distribution slice")
        if cache_dir is not None:
            raise NotImplementedError("cache_dir: the eval batch cache is "
                                      "not ported")
        self.dataset = dataset
        self.pad_spec = pad_spec
        self.limit = limit
        self.batch_size = batch_size
        self.bucket_policy = bucket_policy
        self.host_plan_cfg = host_plan_cfg
        self.prefetch = prefetch
        self.prescan_caps = prescan_caps
        self.device = resolve_device(device)
        self._rung_caps: Optional[Dict] = None

    @property
    def num_scenes(self) -> int:
        n = len(self.dataset)
        return min(n, self.limit) if self.limit else n

    def __len__(self):
        return -(-self.num_scenes // self.batch_size)

    def _batches(self):
        """(records, pad spec) of each batch, in order; the readers' random
        draws come from one ``RandomState(0)`` stream."""
        rng = np.random.RandomState(0)
        n = self.num_scenes
        for lo in range(0, n, self.batch_size):
            recs = [self.dataset.get_record(i, rng)
                    for i in range(lo, min(lo + self.batch_size, n))]
            yield recs, (self.bucket_policy.spec_for(recs)
                         if self.bucket_policy is not None else self.pad_spec)

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
        for recs, spec in self._batches():
            coords, valid, bidx = _plan_coords(
                recs, spec.num_points, cfg.get("voxel_size", 0.02),
                cfg.get("exact_min_shift", False))
            voxels, blocks, stem_ov = probe_plan_counts(
                coords.reshape(-1, 3), bidx, valid.reshape(-1), edges,
                num_levels, stem_kernel=stem_kernel if probe_stem else 0,
                stem_slots=stem_d)
            acc = per_rung.setdefault(spec, [np.zeros(num_levels, np.int64),
                                             np.zeros(num_levels, np.int64),
                                             0])
            np.maximum(acc[0], voxels, out=acc[0])
            np.maximum(acc[1], blocks, out=acc[1])
            acc[2] = max(acc[2], stem_ov)
        for spec, (voxels, blocks, stem_ov) in per_rung.items():
            block_caps = [0 if i >= len(edges) or not edges[i]
                          else -(-int(b) // 16) * 16
                          for i, b in enumerate(blocks)]
            rung_edges = list(edges) if edges else None
            if rung_edges and rung_edges[0] and not l0_dense_fits(
                    block_caps[0], rung_edges[0], L0_BUDGET_BYTES):
                # the whole rung runs level 0 in the gather layout
                rung_edges[0] = block_caps[0] = 0
            caps = dict(voxel_cap=-(-int(voxels[0]) // 256) * 256,
                        block_caps=block_caps, block_edges=rung_edges,
                        level_caps=[int(v) for v in voxels])
            if probe_stem:
                caps["stem_ov_cap"] = overflow_bucket(max(4096, int(stem_ov)))
            self._rung_caps[spec] = caps
        return self._rung_caps

    def _iter_build(self):
        """(records, batch on the CPU) of each batch, in order."""
        for recs, spec in self._batches():
            batch = collate(recs, spec, "cpu")
            if self.host_plan_cfg:
                cfg = dict(self.host_plan_cfg)
                cfg.update(self._prescan().get(spec, {}))
                batch = attach_host_plan(batch, recs, spec, **cfg)
            yield recs, batch

    def __iter__(self):
        for recs, batch in self._produced():
            yield recs, to_device(batch, self.device)

    def _produced(self):
        if self.prefetch <= 0:
            yield from self._iter_build()
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
                for item in self._iter_build():
                    if not put(item):
                        return
                put(end)
            except BaseException as e:   # raised in the consumer
                put(e)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is end:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            thread.join()
