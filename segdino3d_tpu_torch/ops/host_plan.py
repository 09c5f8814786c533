"""ctypes binding to the C++ sparse-conv plan builder (``native/sparseplan``).

Counterpart of ``segdino3d_tpu/ops/host_plan.py:build_host_plan``: voxel
dedup, the (27, V) neighbour tables of the gather-layout levels, the
block-dense tables of the others (``block_assign``: each voxel's dense slot
and each block's 26 shell neighbours, ``ops.block_dense``), the k^3 stem
table or the degree-compacted stem's slot and overflow tables
(``stem_compact``), and the stride-2 parent links, as numpy arrays, and
the count-only probe of the eval loader's capacity prescan
(``probe_plan_counts``).  For the port's
kernels it adds, per level with a coarser one:

* ``child`` (8, V_coarse): ``child[kpos, parent] = fine``, -1 where absent.
  A fine voxel's (parent, kpos) pair is unique, so the down conv becomes a
  gather conv over 8 "offsets" (``ops.sparse_conv.down_conv``);
* ``up_order`` (V,): the fine rows grouped by kpos (a stable sort, invalid
  rows last), the walk order of the up-conv kernel.

The library is built with ``make -C native/sparseplan`` on first use, into
``build/segdino3d_tpu_torch/`` (named by a digest of its source); where the
compiler has no OpenMP runtime it is built without ``-fopenmp``.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from segdino3d_tpu_torch.ops.block_dense import BlockTables
from segdino3d_tpu_torch.ops.cuda_build import BUILD_DIR
from segdino3d_tpu_torch.ops.sparse_conv import kernel_offsets

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "native", "sparseplan")
# the Makefile's flags without -fopenmp, for a compiler with no OpenMP
# runtime (the library's one OpenMP loop is optional: `#ifdef _OPENMP`)
_SERIAL_CXXFLAGS = "-O3 -march=native -fPIC -std=c++17 -Wall"
_lib = None


def _lib_path() -> str:
    with open(os.path.join(_NATIVE_DIR, "sparseplan.cpp"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libsparseplan-{digest}.so")


def _build(path: str) -> None:
    """``make -C native/sparseplan`` into ``path`` (the port keeps its own
    copy under the build directory and leaves ``native/`` untouched)."""
    tmp = f"{path}.tmp{os.getpid()}"
    cmd = ["make", "-s", "-C", _NATIVE_DIR, f"TARGET={tmp}"]
    if subprocess.run(cmd, capture_output=True).returncode != 0:
        subprocess.run(cmd + [f"CXXFLAGS={_SERIAL_CXXFLAGS}"], check=True,
                       capture_output=True)
    os.replace(tmp, path)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    path = _lib_path()
    if not os.path.isfile(path):
        # several test workers may race to build it: one builds, the rest
        # wait on the lock and find the file
        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(os.path.join(BUILD_DIR, ".sparseplan.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not os.path.isfile(path):
                _build(path)
    lib = ctypes.CDLL(path)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.voxel_dedup.restype = ctypes.c_int64
    lib.voxel_dedup.argtypes = [i32p, u8p, ctypes.c_int64, i32p, i32p,
                                ctypes.c_int64]
    lib.neighbor_table.restype = None
    lib.neighbor_table.argtypes = [i32p, ctypes.c_int64, ctypes.c_int64,
                                   i32p, ctypes.c_int32, i32p]
    lib.downsample.restype = ctypes.c_int64
    lib.downsample.argtypes = [i32p, ctypes.c_int64, ctypes.c_int64,
                               i32p, i32p, i32p, ctypes.c_int64]
    lib.block_assign.restype = ctypes.c_int64
    lib.block_assign.argtypes = [i32p, ctypes.c_int64, ctypes.c_int64,
                                 ctypes.c_int32, i32p, i32p, ctypes.c_int64]
    lib.stem_compact.restype = ctypes.c_int64
    lib.stem_compact.argtypes = [i32p, ctypes.c_int64, ctypes.c_int64,
                                 i32p, ctypes.c_int32, ctypes.c_int32,
                                 i32p, i32p, i32p, ctypes.c_int64]
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.probe_plan_counts.restype = None
    lib.probe_plan_counts.argtypes = [i32p, u8p, ctypes.c_int64, i32p,
                                      ctypes.c_int32, i64p, i64p, i32p,
                                      ctypes.c_int32, ctypes.c_int32, i64p]
    _lib = lib
    return lib


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _neighbor_table(lib, coords: np.ndarray, num_valid: int,
                    offsets: np.ndarray) -> np.ndarray:
    """(n_off, V) neighbour table, the offsets split over host threads.

    ctypes releases the GIL for the call, so the slices run in parallel
    whether or not the library was built with OpenMP; each slice writes
    its own rows of the offset-major table."""
    n_off, v_cap = offsets.shape[0], coords.shape[0]
    out = np.empty((n_off, v_cap), np.int32)
    n_threads = max(1, min(n_off, os.cpu_count() or 1))
    bounds = np.linspace(0, n_off, n_threads + 1).astype(int)

    def run(lo, hi):
        part = np.ascontiguousarray(offsets[lo:hi])
        lib.neighbor_table(_i32p(coords), v_cap, num_valid, _i32p(part),
                           hi - lo, _i32p(out[lo:hi]))

    with ThreadPoolExecutor(n_threads) as pool:
        for f in [pool.submit(run, lo, hi)
                  for lo, hi in zip(bounds[:-1], bounds[1:]) if hi > lo]:
            f.result()
    return out


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _coords4(coords_f, batch_idx):
    ijk = np.maximum(np.floor(coords_f).astype(np.int32), 0)
    return np.ascontiguousarray(
        np.concatenate([batch_idx.astype(np.int32)[:, None], ijk], axis=1))


def probe_voxel_count(coords_f: np.ndarray, batch_idx: np.ndarray,
                      valid: np.ndarray) -> int:
    """Unique voxel count (one dedup pass), to pick a voxel capacity."""
    lib = _load()
    n = coords_f.shape[0]
    coords4 = _coords4(coords_f, batch_idx)
    valid_u8 = np.ascontiguousarray(valid.astype(np.uint8))
    inverse = np.empty(n, np.int32)
    vox = np.zeros((n, 4), np.int32)
    return int(lib.voxel_dedup(_i32p(coords4), _u8p(valid_u8), n,
                               _i32p(inverse), _i32p(vox), n))


def probe_plan_counts(coords_f: np.ndarray, batch_idx: np.ndarray,
                      valid: np.ndarray, block_edges: Sequence[int],
                      num_levels: int = 5, stem_kernel: int = 0,
                      stem_slots: int = 0):
    """(voxels per level, blocks per level, stem overflow pairs), counted
    without building a table: the eval loader's capacity prescan.  With
    ``stem_kernel`` > 0 the third value counts the level-0 stem pairs past
    ``stem_slots`` per voxel (the compacted stem's overflow), else 0."""
    lib = _load()
    n = coords_f.shape[0]
    coords4 = _coords4(coords_f, batch_idx)
    valid_u8 = np.ascontiguousarray(valid.astype(np.uint8))
    edges = np.zeros(num_levels, np.int32)
    for i, e in enumerate(list(block_edges or [])[:num_levels]):
        edges[i] = int(e)
    voxels = np.zeros(num_levels, np.int64)
    blocks = np.zeros(num_levels, np.int64)
    stem_ov = np.zeros(1, np.int64)
    offs = (np.ascontiguousarray(kernel_offsets(stem_kernel))
            if stem_kernel else np.zeros((1, 3), np.int32))
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.probe_plan_counts(
        _i32p(coords4), _u8p(valid_u8), n, _i32p(edges), num_levels,
        voxels.ctypes.data_as(i64p), blocks.ctypes.data_as(i64p),
        _i32p(offs), offs.shape[0] if stem_kernel else 0, int(stem_slots),
        stem_ov.ctypes.data_as(i64p))
    return voxels, blocks, int(stem_ov[0])


def voxel_bucket(n: int) -> int:
    """Smallest rung of a ~1.3x geometric ladder >= n (voxel capacities)."""
    m = 2048
    while m < n:
        m = ((max(m + 2048, int(m * 1.3)) + 2047) // 2048) * 2048
    return m


def block_bucket(n: int) -> int:
    """Smallest rung of a fixed ~1.25x geometric ladder >= n (block
    capacities)."""
    m = 16
    while m < n:
        m = ((max(m + 16, int(m * 1.25)) + 15) // 16) * 16
    return m


def stem_degree_bucket(d: int) -> int:
    """Slot-count ladder of the compacted stem's table."""
    for rung in (8, 12, 16, 24, 32, 48, 64, 96, 128):
        if d <= rung:
            return rung
    return d


def overflow_bucket(n: int) -> int:
    """~1.5x ladder of the compacted stem's overflow-pair capacity."""
    m = 4096
    while m < n:
        m = ((max(m + 4096, int(m * 1.5)) + 4095) // 4096) * 4096
    return m


def stem_slots_default(stem_compact_slots: Optional[int] = None) -> int:
    """The compacted stem's slot count D: ``stem_compact_slots`` on the
    ladder, 32 when it is not given."""
    return stem_degree_bucket(int(stem_compact_slots or 32))


def l0_dense_budget_bytes() -> int:
    """The byte budget of level 0's dense layout and of the convs'
    transient scratch: ``SEGDINO_CONV_CHUNK_MB`` MiB (1024 when unset),
    read at each call, as the JAX package reads it
    (``host_plan.l0_dense_budget_bytes``).  The plans' level-0 crossover
    (``l0_dense_fits``) and the offset chunks of K1's and K10's pair-major
    buffers (``sparse_conv.pair_major_chunks``) take it."""
    return int(float(os.environ.get("SEGDINO_CONV_CHUNK_MB", "1024"))
               * 2 ** 20)


def l0_dense_fits(n_blocks: int, edge: int, budget: int, channels: int = 48,
                  itemsize: int = 2, halo: int = 1) -> bool:
    """Whether level 0 stays block-dense: the JAX package's layout
    crossover (``host_plan.l0_dense_fits``), its halo-padded buffer
    ``n_blocks * (edge + 2 halo)^3 * channels * itemsize`` within
    ``budget``."""
    return n_blocks * (edge + 2 * halo) ** 3 * channels * itemsize <= budget


class HostLevel(NamedTuple):
    num_voxels: int
    subm_nbr: Optional[np.ndarray]       # (27, V) int32; None if block-dense
    parent_idx: Optional[np.ndarray]     # (V,) into the coarser level
    parent_kpos: Optional[np.ndarray]    # (V,) slot in the 2x2x2 block
    child: Optional[np.ndarray] = None   # (8, V_coarse) fine index or -1
    up_order: Optional[np.ndarray] = None  # (V,) rows grouped by kpos
    # block-dense layout (``ops.block_dense``); None on gather levels
    num_blocks: int = 0
    vox_slot: Optional[np.ndarray] = None    # (V,) int32
    block_nbr: Optional[np.ndarray] = None   # (26, B_cap) int32
    block_edge: int = 0


class HostPlan(NamedTuple):
    inverse_mapping: np.ndarray     # (N,) point -> voxel id (-1 invalid)
    levels: List[HostLevel]
    # (k^3, V0); None when the stem runs block-dense or compacted
    stem_nbr: Optional[np.ndarray]
    overflow: bool
    # the degree-compacted stem (``ops.sparse_conv.stem_compact_conv``):
    # each voxel's first D (neighbour, offset) pairs as flat rows
    # ``nbr * k^3 + o`` of the wide product, -1 empty, and the pairs past
    # D, voxel-major and by offset within a voxel; padding -1 / V0
    stem_slots: Optional[np.ndarray] = None     # (D, V0) int32
    stem_ov_src: Optional[np.ndarray] = None    # (P,) int32 flat row
    stem_ov_dst: Optional[np.ndarray] = None    # (P,) int32 voxel id


def child_table(parent: np.ndarray, kpos: np.ndarray, num_fine: int,
                coarse_cap: int) -> np.ndarray:
    """(8, coarse_cap) table with ``child[kpos[i], parent[i]] = i`` for the
    first ``num_fine`` (valid) fine rows that have a parent, else -1."""
    child = np.full((8, coarse_cap), -1, np.int32)
    i = np.arange(num_fine, dtype=np.int32)
    linked = parent[:num_fine] >= 0
    child[kpos[:num_fine][linked], parent[:num_fine][linked]] = i[linked]
    return child


def up_order(kpos: np.ndarray, num_fine: int) -> np.ndarray:
    """Fine rows stably sorted by kpos, rows past ``num_fine`` last."""
    key = np.where(np.arange(kpos.shape[0]) < num_fine, kpos, 8)
    return np.argsort(key, kind="stable").astype(np.int32)


def _block_tables(lib, coords, v_cap, count, edge, cap):
    """(n_blocks, vox_slot, block_nbr) of ``block_assign``; with no fixed
    ``cap`` the loose bound B <= V, the table trimmed to ``block_bucket``
    after."""
    b_cap = int(cap) if cap else v_cap
    vox_slot = np.empty(v_cap, np.int32)
    block_nbr = np.empty((26, b_cap), np.int32)
    n_blocks = int(lib.block_assign(_i32p(coords), v_cap, count, edge,
                                    _i32p(vox_slot), _i32p(block_nbr),
                                    b_cap))
    if not cap:
        bucket = block_bucket(n_blocks)
        block_nbr = np.ascontiguousarray(np.pad(
            block_nbr[:, :n_blocks], ((0, 0), (0, bucket - n_blocks)),
            constant_values=-1))
    return n_blocks, vox_slot, block_nbr


def build_host_plan(coords_f: np.ndarray, batch_idx: np.ndarray,
                    valid: np.ndarray, level_caps: Sequence[int],
                    num_levels: int = 5, stem_kernel: int = 5,
                    block_edges: Optional[Sequence[int]] = None,
                    block_caps: Optional[Sequence[int]] = None,
                    stem_gather: bool = False, stem_compact: bool = False,
                    stem_compact_slots: Optional[int] = None,
                    stem_ov_cap: Optional[int] = None,
                    l0_budget_bytes: Optional[int] = None) -> HostPlan:
    """coords_f: (N, 3) float voxel-unit coordinates (min-shifted >= 0).

    ``block_edges[l]`` > 0 gives level ``l`` block-dense tables with
    ``block_caps[l]`` block slots (bucketed when not given); such a level
    has no (27, V) table.  ``stem_gather`` keeps the stem's gather table
    over a block-dense level 0 (the hybrid layout).  With
    ``l0_budget_bytes``, level 0 falls back to the gather layout when its
    dense convs would outgrow the budget (``l0_dense_fits``, keyed on the
    pinned cap when one is given).  ``stem_compact`` replaces a k5
    gather stem (the gather layout's, or the hybrid one's) by the
    degree-compacted tables, ``stem_slots_default(stem_compact_slots)``
    slots per voxel; their overflow capacity is ``stem_ov_cap`` (the eval
    loader's prescan pins it per rung) or 3x the voxel cap, and a plan
    whose pairs outgrow it is rebuilt once at their bucket."""
    lib = _load()
    block_edges = list(block_edges or [0] * num_levels)
    n = coords_f.shape[0]
    coords4 = _coords4(coords_f, batch_idx)
    valid_u8 = np.ascontiguousarray(valid.astype(np.uint8))

    inverse = np.empty(n, np.int32)
    v0_cap = int(level_caps[0])
    vox = np.zeros((v0_cap, 4), np.int32)
    cnt = int(lib.voxel_dedup(_i32p(coords4), _u8p(valid_u8), n,
                              _i32p(inverse), _i32p(vox), v0_cap))
    overflow = cnt > v0_cap
    cnt = min(cnt, v0_cap)
    inverse[inverse >= v0_cap] = -1

    k3 = np.ascontiguousarray(kernel_offsets(3))
    levels: List[HostLevel] = []
    level_coords, level_cnt = vox, cnt
    for li in range(num_levels):
        v_cap = level_coords.shape[0]
        edge = block_edges[li] if li < len(block_edges) else 0
        n_blocks, vox_slot, block_nbr = 0, None, None
        if edge:
            cap = block_caps[li] if block_caps is not None else 0
            n_blocks, vox_slot, block_nbr = _block_tables(
                lib, level_coords, v_cap, level_cnt, edge, cap)
            if (li == 0 and l0_budget_bytes is not None
                    and not l0_dense_fits(int(cap) if cap else n_blocks,
                                          edge, l0_budget_bytes)):
                # level 0's dense convs would outgrow the budget
                edge = block_edges[0] = 0
                n_blocks, vox_slot, block_nbr = 0, None, None
            else:
                overflow = overflow or n_blocks > block_nbr.shape[1]
                n_blocks = min(n_blocks, block_nbr.shape[1])
        nbr = None if edge else _neighbor_table(lib, level_coords,
                                                level_cnt, k3)
        parent = kpos = child = rows_by_kpos = None
        if li < num_levels - 1:
            c_cap = int(level_caps[li + 1])
            parent = np.empty(v_cap, np.int32)
            kpos = np.empty(v_cap, np.int32)
            coarse = np.zeros((c_cap, 4), np.int32)
            ccnt = int(lib.downsample(_i32p(level_coords), v_cap, level_cnt,
                                      _i32p(parent), _i32p(kpos),
                                      _i32p(coarse), c_cap))
            overflow = overflow or ccnt > c_cap
            ccnt = min(ccnt, c_cap)
            parent[parent >= c_cap] = -1
            child = child_table(parent, kpos, level_cnt, c_cap)
            rows_by_kpos = up_order(kpos, level_cnt)
        levels.append(HostLevel(num_voxels=level_cnt, subm_nbr=nbr,
                                parent_idx=parent, parent_kpos=kpos,
                                child=child, up_order=rows_by_kpos,
                                num_blocks=n_blocks, vox_slot=vox_slot,
                                block_nbr=block_nbr, block_edge=edge))
        if li < num_levels - 1:
            level_coords, level_cnt = coarse, ccnt

    stem = slots = ov_src = ov_dst = None
    stem_runs_gather = not block_edges[0] or stem_gather
    if stem_compact and stem_runs_gather and stem_kernel != 3:
        slots, ov_src, ov_dst = _stem_compact_tables(
            lib, vox, cnt, stem_kernel, stem_slots_default(stem_compact_slots),
            int(stem_ov_cap) if stem_ov_cap
            else overflow_bucket(max(4096, 3 * v0_cap)))
    elif stem_runs_gather:
        stem = levels[0].subm_nbr if stem_kernel == 3 else None
        if stem is None:
            stem = _neighbor_table(lib, vox, cnt, kernel_offsets(stem_kernel))
    return HostPlan(inverse_mapping=inverse, levels=levels, stem_nbr=stem,
                    overflow=overflow, stem_slots=slots, stem_ov_src=ov_src,
                    stem_ov_dst=ov_dst)


def _stem_compact_tables(lib, vox, count, stem_kernel, d_cap, p_cap):
    """(slots, ov_src, ov_dst) of ``stem_compact`` at overflow capacity
    ``p_cap``, rebuilt once at the pairs' bucket when they outgrow it (the
    library returns the full pair count and writes only ``p_cap``)."""
    v0_cap = vox.shape[0]
    k = np.ascontiguousarray(kernel_offsets(stem_kernel))
    slots = np.empty((d_cap, v0_cap), np.int32)
    for _ in range(2):
        ov_src = np.full(p_cap, -1, np.int32)
        ov_dst = np.full(p_cap, v0_cap, np.int32)   # the dump row
        n_ov = int(lib.stem_compact(_i32p(vox), v0_cap, count, _i32p(k),
                                    k.shape[0], d_cap, _i32p(slots),
                                    _i32p(ov_src), _i32p(ov_dst), p_cap))
        if n_ov <= p_cap:
            return slots, ov_src, ov_dst
        p_cap = overflow_bucket(n_ov)
    raise ValueError(f"compacted stem: {n_ov} overflow pairs past the "
                     f"rebuilt capacity {p_cap}")


@dataclass
class Level:
    """One pyramid level on the device."""
    valid: torch.Tensor                      # (V,) bool
    nbr: Optional[torch.Tensor]              # (27, V) int32; None if dense
    parent: Optional[torch.Tensor] = None    # (V,) int32 into the coarser level
    kpos: Optional[torch.Tensor] = None      # (V,) int32
    child: Optional[torch.Tensor] = None     # (8, V_coarse) int32
    up_order: Optional[torch.Tensor] = None  # (V,) int32


@dataclass
class UNetPlan:
    """Index tables for one U-Net forward.  A level with ``blocks[l]`` runs
    block-dense, the others the gather layout; ``stem_nbr`` is None when
    the stem runs block-dense too, or compacted: ``stem_compact`` holds
    (slots, ov_src, ov_dst), ``HostPlan``'s tables."""
    levels: List[Level]
    stem_nbr: Optional[torch.Tensor]         # (k^3, V0) int32
    inverse: torch.Tensor                    # (N,) int32 point -> voxel, -1
    blocks: Optional[List[Optional[BlockTables]]] = None
    stem_compact: Optional[Tuple[torch.Tensor, torch.Tensor,
                                 torch.Tensor]] = None


def _invert_slots(vox_slot: np.ndarray, n_dense: int) -> np.ndarray:
    """Dense slot -> voxel id, -1 at empty cells: the inverse of
    ``vox_slot``, which is injective on its valid entries."""
    inv = np.full(n_dense, -1, np.int32)
    m = vox_slot >= 0
    inv[vox_slot[m]] = np.nonzero(m)[0].astype(np.int32)
    return inv


def host_plan_to_device(plan: HostPlan, device) -> UNetPlan:
    def t(a):
        return None if a is None else torch.from_numpy(
            np.ascontiguousarray(a)).to(device)

    levels, blocks = [], []
    for hl in plan.levels:
        v = (hl.subm_nbr.shape[1] if hl.subm_nbr is not None
             else hl.vox_slot.shape[0])
        levels.append(Level(valid=torch.arange(v, device=device)
                            < hl.num_voxels,
                            nbr=t(hl.subm_nbr), parent=t(hl.parent_idx),
                            kpos=t(hl.parent_kpos), child=t(hl.child),
                            up_order=t(hl.up_order)))
        blocks.append(None if hl.vox_slot is None else BlockTables(
            vox_slot=t(hl.vox_slot), block_nbr=t(hl.block_nbr),
            slot_vox=t(_invert_slots(hl.vox_slot, hl.block_nbr.shape[1]
                                    * hl.block_edge ** 3)),
            edge=hl.block_edge))
    return UNetPlan(levels=levels, stem_nbr=t(plan.stem_nbr),
                    inverse=t(plan.inverse_mapping),
                    blocks=blocks if any(b is not None for b in blocks)
                    else None,
                    stem_compact=None if plan.stem_slots is None else (
                        t(plan.stem_slots), t(plan.stem_ov_src),
                        t(plan.stem_ov_dst)))
