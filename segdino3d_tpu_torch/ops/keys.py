"""Single-word coordinate keys of the on-device plan engine.

Counterpart of the uint32 packing of ``segdino3d_tpu/ops/keys.py``: a
voxel coordinate ``(b, x, y, z)`` packs into one 32-bit key

    b (3 bits) | x (10) | y (10) | z (9)

so a scene spans at most 1024 x 1024 x 512 voxels (20.5 m x 20.5 m x 10.2 m
at 2 cm) and a batch at most 8 scenes.  A coordinate outside those fields,
and an invalid row, packs to the sentinel ``0xFFFFFFFF``; the one real
coordinate whose key is all ones would alias the sentinel and is treated as
invalid too, so the same points drop as in the JAX package.

Torch has no full uint32 arithmetic, so a key is an int64 holding the
uint32 value; the CUDA kernels read it as such and keep uint32 in their
tables.  The same packing is written in ``csrc/coord_hash.cuh`` for the
neighbour-table kernel, which forms its query keys itself.
"""
from __future__ import annotations

import torch

B_BITS, X_BITS, Y_BITS, Z_BITS = 3, 10, 10, 9
SENTINEL = 0xFFFFFFFF


def pack_columns_u32(b: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                     z: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Pack integer columns into int64 keys in [0, 2^32); invalid rows,
    out-of-range coordinates and the all-ones alias give ``SENTINEL``."""
    b, x, y, z = (t.long() for t in (b, x, y, z))
    in_range = ((b >= 0) & (b < (1 << B_BITS))
                & (x >= 0) & (x < (1 << X_BITS))
                & (y >= 0) & (y < (1 << Y_BITS))
                & (z >= 0) & (z < (1 << Z_BITS)))
    key = ((b << (X_BITS + Y_BITS + Z_BITS)) | (x << (Y_BITS + Z_BITS))
           | (y << Z_BITS) | z)
    keep = valid & in_range & (key != SENTINEL)
    return torch.where(keep, key, SENTINEL)
