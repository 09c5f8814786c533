"""Builds and loads the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for Hopper (``sm_90a``) into its own
shared library with a plain C interface under ``build/segdino3d_tpu_torch/``
at the repository root, on first use.  A library's file name carries a
digest of its sources, so an edited kernel is rebuilt and a stale one is
never loaded.  ``build_all`` starts one ``nvcc`` per source at once.

Nothing here runs at import time: the CPU tests import every module, on
machines that may have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "segdino3d_tpu_torch")
KERNELS = ("gather_gemm_conv", "up_conv", "segment_mean_gather",
           "gather_wgrad", "segment_grad", "coord_hash", "neighbor_table",
           "voxel_compact", "slot_gather", "block_conv", "block_wgrad",
           "stem_slot_sum")
_HEADERS = {"gather_gemm_conv": ("gather_tile.cuh", "wgrad_tile.cuh"),
            "up_conv": ("gather_tile.cuh", "wgrad_tile.cuh"),
            "segment_mean_gather": (), "gather_wgrad": ("wgrad_tile.cuh",),
            "segment_grad": (),
            "coord_hash": ("coord_hash.cuh",),
            "neighbor_table": ("coord_hash.cuh",), "voxel_compact": (),
            "slot_gather": (), "block_conv": ("block_tile.cuh",),
            "block_wgrad": ("block_tile.cuh", "wgrad_tile.cuh"),
            "stem_slot_sum": ()}
# a library's C functions, where they are not the one named after it
_ENTRY_POINTS = {"gather_gemm_conv": ("gather_gemm_conv",
                                      "gather_conv_pair_stride"),
                 "coord_hash": ("coord_hash_build", "coord_hash_lookup"),
                 "gather_wgrad": ("gather_wgrad", "gather_pairs"),
                 "segment_mean_gather": ("segment_mean_gather",
                                         "segment_csr_keys",
                                         "segment_csr_offsets"),
                 "neighbor_table": ("neighbor_tables", "empty_launch"),
                 "block_conv": ("block_conv", "block_conv_rows", "block_rows",
                                "block_dilate")}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # x, nbr, w, valid, pairs, pos, partial, out, v, cin, cout, n_off,
    # dtype, stream
    "gather_gemm_conv": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _P],
    # cout
    "gather_conv_pair_stride": [_I],
    # x, child, w, pairs, parent, valid, out, v_coarse, v_fine, cin, cout,
    # dtype, stream
    "up_conv": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # offsets, members, sorted, counters, partial, gidx, n_src, ptrs,
    # strides, cols, flags, out, S, n, stream
    "segment_mean_gather": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P,
                            _I, _I, _P],
    # seg, seg64, valid, n, S, keys, stream
    "segment_csr_keys": [_P, _I, _P, _I, _I, _P, _P],
    # sorted, n, S, offsets, counters, stream
    "segment_csr_offsets": [_P, _I, _I, _P, _P, _P],
    # a, ia, b, ib, ws, partial, out, rows, cin, cout, n_off, splits,
    # mirror, dtype, stream
    "gather_wgrad": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                     _P],
    # ia, ib, ws, rows, n_off, stream
    "gather_pairs": [_P, _P, _P, _I, _I, _P],
    # offsets, members, seg, g, ld, sp_offsets, out, rows, S, cols,
    # out_dtype, stream
    "segment_grad": [_P, _P, _P, _P, ctypes.c_longlong, _P, _P, _I, _I, _I,
                     _I, _P],
    # keys, n, tkeys, tvals, t_size, overflow, winner, stream
    "coord_hash_build": [_P, _I, _P, _P, _I, _P, _P, _P],
    # queries, n, tkeys, tvals, t_size, out, stream
    "coord_hash_lookup": [_P, _I, _P, _P, _I, _P, _P],
    # desc, n_tables, sub_of, fill, fill_bytes, stream
    "neighbor_tables": [_P, _I, _P, _P, ctypes.c_longlong, _P],
    # stream
    "empty_launch": [_P],
    # winner, coords, n, shift, cap, ws, inverse, kpos, out_coords, valid,
    # tvals, tvals_out, t_size, stream
    "voxel_compact": [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _P],
    # x, idx, out, n, row_bytes, stream
    "slot_gather": [_P, _P, _P, _I, _I, _P],
    # x, block_nbr, w, mask, ws, out, n_blocks, edge, k, cin, cout, dtype,
    # stream
    "block_conv": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # x, block_nbr, w, ws, out, n_blocks, edge, k, cin, cout, dtype, stream
    "block_conv_rows": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # mask, ws, n_rows, stream
    "block_rows": [_P, _P, _I, _P],
    # mask, block_nbr, out, ws, n_blocks, edge, k, stream
    "block_dilate": [_P, _P, _P, _P, _I, _I, _I, _P],
    # x, dy, block_nbr, ws, partial, out, n_blocks, edge, k, cin, cout,
    # splits, dtype, stream
    "block_wgrad": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # y2, slots, ov_src, ov_dst, valid, out, v, d, p, cout, dtype, stream
    "stem_slot_sum": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def library_path(name: str) -> str:
    h = hashlib.sha256()
    for f in (f"{name}.cu",) + _HEADERS[name]:
        with open(os.path.join(CSRC_DIR, f), "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every named kernel that is not built yet, all ``nvcc``s at
    once; returns {name: ptxas report}.  Raises on any failed build."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        procs = {}
        for name in names:
            out = library_path(name)
            if os.path.isfile(out):
                continue
            tmp = f"{out}.tmp{os.getpid()}"
            procs[name] = (out, tmp, subprocess.Popen(
                [nvcc_path(), *NVCC_FLAGS, "-o", tmp, source_path(name)],
                cwd=CSRC_DIR, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        reports, failed = {}, []
        for name, (out, tmp, proc) in procs.items():
            text, _ = proc.communicate()
            reports[name] = text
            if proc.returncode != 0:
                failed.append(f"{name} (rc={proc.returncode}):\n{text}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        path = library_path(name)
        if not os.path.isfile(path):
            build_all([name])
        lib = ctypes.CDLL(path)
        for entry in _ENTRY_POINTS.get(name, (name,)):
            fn = getattr(lib, entry)
            fn.argtypes = _SIGNATURES[entry]
            fn.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def dtype_code(dtype) -> int:
    if dtype == torch.float32:
        return 0
    if dtype == torch.bfloat16:
        return 1
    raise TypeError(f"kernels take float32 or bfloat16, not {dtype}")


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {err}")


# the current stream's handle as an int, without building a Stream object
# (a few microseconds of each launch's host time); absent on CPU builds
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_ptr(tensor) -> int:
    if _raw_stream is not None:
        return _raw_stream(tensor.get_device())
    return torch.cuda.current_stream(tensor.device).cuda_stream
