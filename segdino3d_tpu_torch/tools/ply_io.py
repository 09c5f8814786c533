"""PLY mesh reader and writer (numpy only).

The port's copy of ``tools/ply_io.py``: the binary-little-endian and ascii
PLY files that ScanNet ships (``*_vh_clean_2.ply``: x/y/z float,
red/green/blue uchar (+ alpha), faces as ``vertex_indices`` lists;
``*_vh_clean_2.labels.ply``: a ``label`` per vertex).  ``read_ply`` returns
what the JAX reader returns; a binary face list whose rows all hold three
indices is read in one pass.  ``write_ply`` also writes a ``label`` per
vertex, for label files.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

_DTYPES = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def _read_faces_binary(f, cnt: int, cnt_dt: np.dtype, idx_dt: np.dtype):
    """``cnt`` binary face rows: one read where every row is a triangle,
    else row by row."""
    start = f.tell()
    row = np.dtype([("k", cnt_dt), ("i", idx_dt, (3,))])
    raw = f.read(cnt * row.itemsize)
    if len(raw) == cnt * row.itemsize:
        arr = np.frombuffer(raw, row)
        if (arr["k"] == 3).all():
            return arr["i"].astype(np.int32)
    f.seek(start)
    faces = []
    for _ in range(cnt):
        k = int(np.frombuffer(f.read(cnt_dt.itemsize), cnt_dt)[0])
        faces.append(np.frombuffer(f.read(k * idx_dt.itemsize), idx_dt))
    return np.asarray(faces, np.int32)


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """{'vertices': (N, 3) float32, 'colors': (N, 3) uint8 where present,
    'labels': (N,) int64 where present, 'faces': (M, 3) int32 where
    present}."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []   # (name, count, [(prop, dtype) | ("list", ...)])
        cur = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: no end_header")
            line = line.strip().decode()
            if line.startswith("comment"):
                continue
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, cnt = line.split()
                cur = (name, int(cnt), [])
                elements.append(cur)
            elif line.startswith("property"):
                parts = line.split()
                if parts[1] == "list":
                    cur[2].append(("list", _DTYPES[parts[2]],
                                   _DTYPES[parts[3]], parts[4]))
                else:
                    cur[2].append((parts[2], _DTYPES[parts[1]]))
            elif line == "end_header":
                break

        out: Dict[str, np.ndarray] = {}
        for name, cnt, props in elements:
            if all(p[0] != "list" for p in props):
                dt = np.dtype([(p[0], "<" + p[1]) for p in props])
                if fmt == "ascii":
                    rows = [tuple(f.readline().split()) for _ in range(cnt)]
                    arr = np.array(rows, dtype=dt)
                else:
                    arr = np.frombuffer(f.read(cnt * dt.itemsize), dtype=dt)
                if name == "vertex":
                    out["vertices"] = np.stack(
                        [arr["x"], arr["y"], arr["z"]], 1).astype(np.float32)
                    if "red" in dt.names:
                        out["colors"] = np.stack(
                            [arr["red"], arr["green"], arr["blue"]], 1)
                    if "label" in dt.names:
                        out["labels"] = arr["label"].astype(np.int64)
            elif fmt == "ascii":
                faces = []
                for _ in range(cnt):
                    vals = f.readline().split()
                    k = int(vals[0])
                    faces.append([int(v) for v in vals[1:1 + k]])
                out["faces"] = np.asarray(faces, np.int32)
            else:
                out["faces"] = _read_faces_binary(
                    f, cnt, np.dtype("<" + props[0][1]),
                    np.dtype("<" + props[0][2]))
    return out


def write_ply(path: str, vertices: np.ndarray, faces=None, colors=None,
              labels=None):
    """A binary little-endian PLY: x/y/z float, red/green/blue uchar with
    ``colors``, a ushort ``label`` with ``labels``, triangle faces with
    ``faces``."""
    n = len(vertices)
    hdr = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
           "property float x", "property float y", "property float z"]
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if colors is not None:
        hdr += ["property uchar red", "property uchar green",
                "property uchar blue"]
        fields += [("r", "u1"), ("g", "u1"), ("b", "u1")]
    if labels is not None:
        hdr.append("property ushort label")
        fields.append(("label", "<u2"))
    if faces is not None:
        hdr += [f"element face {len(faces)}",
                "property list uchar int vertex_indices"]
    hdr.append("end_header")
    arr = np.empty(n, np.dtype(fields))
    arr["x"], arr["y"], arr["z"] = np.asarray(vertices).T.astype(np.float32)
    if colors is not None:
        arr["r"], arr["g"], arr["b"] = np.asarray(colors).T
    if labels is not None:
        arr["label"] = labels
    with open(path, "wb") as f:
        f.write(("\n".join(hdr) + "\n").encode())
        f.write(arr.tobytes())
        if faces is not None:
            farr = np.empty(len(faces), np.dtype(
                [("k", "u1"), ("i", "<i4", (3,))]))
            farr["k"] = 3
            farr["i"] = np.asarray(faces, np.int32)
            f.write(farr.tobytes())
