"""The native mesh segmentator (superpoints), through ctypes.

Counterpart of ``segdino3d_tpu/data/segmentator.py``: the offline data
preparation's graph-cut segmentation of a scan's mesh into superpoints.
The C++ core is ``native/segmentator/segmentator.cpp``; the port builds
its own copy of the library at first use into the build directory (under
a file lock, named by the source's hash) and leaves ``native/`` as it is.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess

import numpy as np

from segdino3d_tpu_torch.ops.cuda_build import BUILD_DIR

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "native", "segmentator")
_lib = None


def _lib_path() -> str:
    with open(os.path.join(_NATIVE_DIR, "segmentator.cpp"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libsegmentator-{digest}.so")


def _load():
    global _lib
    if _lib is not None:
        return _lib
    path = _lib_path()
    if not os.path.isfile(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(os.path.join(BUILD_DIR, ".segmentator.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not os.path.isfile(path):
                tmp = f"{path}.tmp{os.getpid()}"
                subprocess.run(["make", "-s", "-C", _NATIVE_DIR,
                                f"TARGET={tmp}"], check=True,
                               capture_output=True, timeout=600)
                os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    lib.segment_mesh.restype = ctypes.c_int
    lib.segment_mesh.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    _lib = lib
    return lib


def segment_mesh(vertices: np.ndarray, faces: np.ndarray,
                 kthr: float = 0.01, seg_min_verts: int = 20) -> np.ndarray:
    """vertices (N, 3) float, faces (M, 3) int -> per-vertex segment ids
    (int64, 0 .. n_segments - 1)."""
    v = np.ascontiguousarray(vertices, np.float32)
    f = np.ascontiguousarray(faces, np.int32)
    if v.ndim != 2 or v.shape[1] != 3 or f.ndim != 2 or f.shape[1] != 3:
        raise ValueError(f"vertices {v.shape} and faces {f.shape} must be "
                         f"(N, 3) and (M, 3)")
    if f.size and (f.min() < 0 or f.max() >= len(v)):
        raise ValueError("a face names a vertex that does not exist")
    lib = _load()
    out = np.zeros(v.shape[0], np.int32)
    n_seg = lib.segment_mesh(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), v.shape[0],
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), f.shape[0],
        ctypes.c_float(kthr), seg_min_verts,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    if n_seg <= 0 and v.shape[0] > 0:
        raise RuntimeError(f"segment_mesh returned {n_seg} segments")
    return out.astype(np.int64)
