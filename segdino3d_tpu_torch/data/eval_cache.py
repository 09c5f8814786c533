"""Persistent eval batch cache: build the val set's host work once.

Counterpart of ``segdino3d_tpu/data/eval_cache.py``.  Every host stage of
eval (record IO, the val transform, the padded collate and the C++ plan)
is a deterministic function of the scene files and the loader's settings,
so ``EvalLoader(cache_dir=...)`` builds each batch once, on the CPU, writes
it here, and serves every later pass from a memory map: the consumer only
moves it to the card.

Format: one ``batch_NNNNN.bin`` per loader batch::

    MAGIC(8) | header_len u64 LE | pickle(header) | 64B-aligned raw blobs

``header.skeleton`` is the pickled ``(records_aux, SceneBatch)`` tree with
every array leaf (a numpy array, or a CPU tensor stored as one) swapped
for an ``_ArrRef`` into ``header.metas`` (offset, dtype, shape).  Loading
unpickles the skeleton and grafts ``np.frombuffer`` views over one
``mmap`` back onto it (tensor leaves as ``torch.from_numpy`` of those
views, which are read-only).  A ``manifest.json`` is written last (tmp +
rename), so a build cut short is rebuilt; a change of data or settings
rotates the namespace key and never serves stale batches.
"""
from __future__ import annotations

import hashlib
import json
import mmap
import os
import pickle
import warnings
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from segdino3d_tpu_torch.data.collate import map_leaves

CACHE_FORMAT_VERSION = 1
_MAGIC = b"SD3DTEC1"
_ALIGN = 64


class _ArrRef:
    """Placeholder for an array leaf inside the pickled skeleton; ``tensor``
    says whether the leaf was a torch tensor."""

    __slots__ = ("i", "tensor")

    def __init__(self, i: int, tensor: bool):
        self.i = i
        self.tensor = tensor

    def __getstate__(self):
        return (self.i, self.tensor)

    def __setstate__(self, state):
        self.i, self.tensor = state


def _pack_tree(tree) -> Tuple[Any, List[np.ndarray]]:
    arrays: List[np.ndarray] = []

    def repl(x):
        if isinstance(x, (np.ndarray, torch.Tensor)):
            is_tensor = isinstance(x, torch.Tensor)
            a = x.numpy() if is_tensor else x
            if not a.flags["C_CONTIGUOUS"]:
                # not ascontiguousarray: that promotes 0-d to (1,)
                a = np.copy(a, order="C")
            arrays.append(a)
            return _ArrRef(len(arrays) - 1, is_tensor)
        return x

    return map_leaves(tree, repl), arrays


def _unpack_tree(skeleton, arrays: List[np.ndarray]):
    def repl(x):
        if not isinstance(x, _ArrRef):
            return x
        if not x.tensor:
            return arrays[x.i]
        with warnings.catch_warnings():
            # a read-only view: the consumer copies it to its device
            warnings.simplefilter("ignore", UserWarning)
            return torch.from_numpy(arrays[x.i])

    return map_leaves(skeleton, repl)


def save_bundle(path: str, tree) -> None:
    """Serialize a tree of numpy arrays and CPU tensors; atomic (tmp +
    rename)."""
    skeleton, arrays = _pack_tree(tree)
    metas = []
    off = 0
    for a in arrays:
        off = -(-off // _ALIGN) * _ALIGN
        metas.append((off, a.dtype.str, a.shape))
        off += a.nbytes
    header = pickle.dumps(dict(version=CACHE_FORMAT_VERSION,
                               skeleton=skeleton, metas=metas),
                          protocol=pickle.HIGHEST_PROTOCOL)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(len(header).to_bytes(8, "little"))
        f.write(header)
        pos = 0
        for (o, _, _), a in zip(metas, arrays):
            if o > pos:
                f.write(b"\0" * (o - pos))
                pos = o
            if a.nbytes:   # 0-size views can't cast; nothing to write
                f.write(memoryview(a).cast("B"))
            pos += a.nbytes
    os.replace(tmp, path)


def load_bundle(path: str):
    """Deserialize; array leaves are mmap views (read-only)."""
    with open(path, "rb") as f:
        if f.read(8) != _MAGIC:
            raise ValueError(f"bad cache magic in {path}")
        hlen = int.from_bytes(f.read(8), "little")
        header = pickle.loads(f.read(hlen))
        if header["version"] != CACHE_FORMAT_VERSION:
            raise ValueError(f"cache version {header['version']} != "
                             f"{CACHE_FORMAT_VERSION} in {path}")
        base = f.tell()
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        if hasattr(mm, "madvise"):
            # one readahead of the whole file, not a fault per page
            mm.madvise(mmap.MADV_WILLNEED)
    arrays = []
    for off, dtype_str, shape in header["metas"]:
        dt = np.dtype(dtype_str)
        n = int(np.prod(shape, dtype=np.int64))
        arr = np.frombuffer(mm, dtype=dt, count=n,
                            offset=base + off).reshape(shape)
        arrays.append(arr)
    return _unpack_tree(header["skeleton"], arrays)


def stable_repr(obj) -> str:
    """Deterministic string form for key hashing (sorted dict keys)."""
    if isinstance(obj, dict):
        return "{" + ",".join(
            f"{k}:{stable_repr(obj[k])}" for k in sorted(obj)) + "}"
    if isinstance(obj, (list, tuple)):
        return "[" + ",".join(stable_repr(x) for x in obj) + "]"
    if isinstance(obj, float):
        return repr(round(obj, 12))
    return repr(obj)


def dataset_fingerprint(ds) -> str:
    """Identity of the data: the reader's ``cache_fingerprint()`` where it
    has one (the ScanNet readers stat every scene file), else (class,
    length, scene ids)."""
    fp = getattr(ds, "cache_fingerprint", None)
    if callable(fp):
        return str(fp())
    return stable_repr((type(ds).__name__, len(ds),
                        getattr(ds, "scene_ids", None)))


def config_key(**kwargs) -> str:
    s = stable_repr(dict(kwargs, _v=CACHE_FORMAT_VERSION))
    return hashlib.sha1(s.encode()).hexdigest()[:16]


def record_aux(record: Dict) -> Dict:
    """The slice of an eval record the eval driver reads after the batch:
    the GT annotation arrays (``collate.eval_annotation``) and the point
    count (the length its masks unpack to, ``evaluation.evaluate``)."""
    aux = dict(n_points=int(record["points"].shape[0]),
               scene_id=record.get("scene_id", ""))
    for k in ("inst_merged", "semantic_masks"):
        if record.get(k) is not None:
            aux[k] = np.asarray(record[k])
    return aux


class EvalBatchCache:
    """One namespace (= one loader config) of cached eval batches."""

    def __init__(self, cache_dir: str, key: str, config_note: str = ""):
        self.dir = os.path.join(cache_dir, key)
        self.key = key
        self.config_note = config_note
        self._manifest: Optional[Dict] = None

    def _manifest_path(self) -> str:
        return os.path.join(self.dir, "manifest.json")

    def complete(self) -> bool:
        if self._manifest is not None:
            return True
        try:
            with open(self._manifest_path()) as f:
                m = json.load(f)
        except (OSError, ValueError):
            return False
        if m.get("version") != CACHE_FORMAT_VERSION or m.get("key") != self.key:
            return False
        self._manifest = m
        return True

    def _batch_path(self, i: int) -> str:
        return os.path.join(self.dir, f"batch_{i:05d}.bin")

    @staticmethod
    def _readahead(path: str) -> None:
        """Queue async readahead of a whole cache file into the page cache
        (populates the per-file cache, so the later ``load_bundle`` maps
        warm pages even though this mapping is closed immediately)."""
        try:
            with open(path, "rb") as f:
                mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
                if hasattr(mm, "madvise"):
                    mm.madvise(mmap.MADV_WILLNEED)
                mm.close()
        except (OSError, ValueError):
            pass

    def iter_batches(self) -> Iterator[Tuple[List[Dict], Any]]:
        assert self.complete(), "iter_batches on an incomplete cache"
        n = self._manifest["n_batches"]
        for i in range(n):
            if i + 1 < n:
                # the next batch's disk read overlaps the consumer's work
                self._readahead(self._batch_path(i + 1))
            yield load_bundle(self._batch_path(i))

    def write_through(self, built: Iterator[Tuple[List[Dict], Any]]
                      ) -> Iterator[Tuple[List[Dict], Any]]:
        """Write each built (records, batch) pair while yielding it; the
        manifest lands only after the whole pass, so a pass cut short is
        rebuilt rather than served truncated."""
        os.makedirs(self.dir, exist_ok=True)
        n = 0
        for records, batch in built:
            aux = [record_aux(r) for r in records]
            save_bundle(self._batch_path(n), (aux, batch))
            n += 1
            yield records, batch
        tmp = self._manifest_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(dict(version=CACHE_FORMAT_VERSION, key=self.key,
                           n_batches=n, config=self.config_note), f)
        os.replace(tmp, self._manifest_path())
        self._manifest = None
