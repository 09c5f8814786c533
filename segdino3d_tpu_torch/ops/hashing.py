"""Coordinate hash of the on-device plan engine (kernel K6,
``csrc/coord_hash.cu``).

Counterpart of ``segdino3d_tpu/ops/hashing.py:build_hash`` and
``lookup_hash``: each packed key (``ops.keys``) maps to the smallest row
that carries it, and a lookup of an absent key or of the sentinel gives
-1.  Only that map is ported; the JAX package's four-table
claim-and-evict layout is not.  ``overflow`` is set when a key could not be
placed, as the JAX docstring says.  (The JAX ``build_hash`` also leaves a
key's later duplicate rows pending, so it raises its flag on any voxel of
more than four points; its lookups are right all the same.)

A ``CoordHash`` built from a CUDA tensor is K6's open-addressing table:
``keys`` (T,) int32 holding uint32 keys (all ones where empty) and ``vals``
(T,) int32, T = next_pow2(2 * capacity) (as in JAX).  Built from a CPU
tensor it is the plain version's: ``keys`` the sorted distinct keys
(int64), ``vals`` their smallest rows.  ``lookup_hash`` takes either, on
its device.  ``ops.voxelize.voxel_compact`` later returns a copy whose
``vals`` are voxel ids instead of rows (the same ``keys``).

Both callers insert a set of keys and then look up the same keys, to find
each row's winner (the smallest row of its key): ``build_and_lookup`` does
both, on the card in one launch.

Each wrapper counts its kernel launches in ``launches``.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from segdino3d_tpu_torch.ops import cuda_build
from segdino3d_tpu_torch.ops.keys import SENTINEL


class CoordHash(NamedTuple):
    keys: torch.Tensor      # see the module docstring
    vals: torch.Tensor      # int32
    overflow: torch.Tensor  # () bool: a key could not be placed


def table_size(capacity: int) -> int:
    """next_pow2(2 * capacity), at least 16 (``hashing.build_hash``)."""
    return 1 << max(4, (2 * capacity - 1).bit_length())


def _check_keys(name: str, key: torch.Tensor) -> None:
    if key.dtype != torch.int64 or key.dim() != 1 or not key.is_contiguous():
        raise TypeError(f"{name}: keys must be a contiguous 1-d int64 tensor")


def build_hash_plain(key: torch.Tensor, capacity: int) -> CoordHash:
    """Plain version of K6's insert, with no hash: the sorted distinct keys
    and ``scatter_reduce(amin)`` of the rows that carry each."""
    live = key != SENTINEL
    rows = torch.arange(key.shape[0], device=key.device, dtype=torch.int32)
    uniq, inv = torch.unique(key[live], sorted=True, return_inverse=True)
    vals = torch.full((uniq.shape[0],), key.shape[0], dtype=torch.int32,
                      device=key.device).scatter_reduce(
        0, inv, rows[live], "amin")
    overflow = torch.tensor(uniq.shape[0] > table_size(capacity),
                            device=key.device)
    return CoordHash(keys=uniq, vals=vals, overflow=overflow)


def lookup_hash_plain(h: CoordHash, query: torch.Tensor) -> torch.Tensor:
    """Plain version of K6's lookup: ``searchsorted`` over the sorted keys."""
    if h.keys.shape[0] == 0:
        return torch.full(query.shape, -1, dtype=torch.int32,
                          device=query.device)
    pos = torch.searchsorted(h.keys, query).clamp(max=h.keys.shape[0] - 1)
    hit = (h.keys[pos] == query) & (query != SENTINEL)
    return torch.where(hit, h.vals[pos], -1).to(torch.int32)


def build_and_lookup_plain(key: torch.Tensor, capacity: int
                           ) -> Tuple[CoordHash, torch.Tensor]:
    """Plain version of K6's build with the lookup of its own keys."""
    h = build_hash_plain(key, capacity)
    return h, lookup_hash_plain(h, key)


def build_and_lookup(key: torch.Tensor, capacity: int
                     ) -> Tuple[CoordHash, torch.Tensor]:
    """Insert rows 0..N-1 of ``key`` (N,) int64 (``SENTINEL`` = no row);
    returns the table and (N,) int32 each row's winner, the smallest row
    that carries its key (-1 for a sentinel or a key that found no slot),
    which equals ``lookup_hash(table, key)``."""
    _check_keys("build_and_lookup", key)
    if key.device.type == "cpu":
        return build_and_lookup_plain(key, capacity)
    t_size = table_size(capacity)
    n, dev = key.shape[0], key.device
    # the keys on their own: a level's plan keeps them (K8's remapped table
    # shares them); the values and the winners are freed after K8; the
    # overflow flag is a bool the kernel writes in place
    tkeys = torch.empty(t_size, dtype=torch.int32, device=dev)
    tvals, winner = torch.empty(t_size + n, dtype=torch.int32,
                                device=dev).split((t_size, n))
    flag = torch.empty((), dtype=torch.bool, device=dev)
    lib = cuda_build.library("coord_hash")
    cuda_build.check(lib.coord_hash_build(
        key.data_ptr(), n, tkeys.data_ptr(), tvals.data_ptr(), t_size,
        flag.data_ptr(), winner.data_ptr(), cuda_build.stream_ptr(key)),
        "coord_hash_build")
    build_and_lookup.launches += 1
    return CoordHash(keys=tkeys, vals=tvals, overflow=flag), winner


build_and_lookup.launches = 0


def lookup_hash(h: CoordHash, query: torch.Tensor) -> torch.Tensor:
    """(N,) int32 value of each query key, -1 where absent."""
    _check_keys("lookup_hash", query)
    if query.device.type == "cpu":
        return lookup_hash_plain(h, query)
    if h.keys.device != query.device or h.keys.dtype != torch.int32:
        raise TypeError("lookup_hash: a CUDA query needs a table built by "
                        "build_and_lookup on its device")
    out = torch.empty(query.shape[0], dtype=torch.int32, device=query.device)
    lib = cuda_build.library("coord_hash")
    cuda_build.check(lib.coord_hash_lookup(
        query.data_ptr(), query.shape[0], h.keys.data_ptr(), h.vals.data_ptr(),
        h.keys.shape[0], out.data_ptr(), cuda_build.stream_ptr(query)),
        "coord_hash_lookup")
    lookup_hash.launches += 1
    return out


lookup_hash.launches = 0
