"""Bit-packing of boolean masks for the eval driver's device -> host copy.

Counterpart of ``segdino3d_tpu/ops/bitpack.py``: the (top-k, P) bool
instance masks are packed to one bit per point on the model's device (8x
fewer bytes to copy; ~78 MB unpacked at 600 x 131k points) and the host
unpacks the rows it keeps.  Little-endian bit order within a byte, the
last axis padded with zeros to a multiple of 8: the same bytes as the JAX
package's ``pack_bits``.
"""
from __future__ import annotations

import numpy as np
import torch


def pack_bits(x: torch.Tensor) -> torch.Tensor:
    """Bools packed along the last axis: ``(..., N) -> (..., ceil(N/8))``
    uint8, bit ``j`` of byte ``k`` holding element ``8k + j``."""
    rem = (-x.shape[-1]) % 8
    if rem:
        x = torch.nn.functional.pad(x.to(torch.uint8), (0, rem))
    g = x.reshape(*x.shape[:-1], -1, 8).to(torch.uint8)
    weights = 2 ** torch.arange(8, dtype=torch.uint8, device=x.device)
    return (g * weights).sum(-1, dtype=torch.uint8)


def unpack_bits_np(packed: np.ndarray, count: int) -> np.ndarray:
    """The host's inverse: ``(..., M) uint8 -> (..., count) bool``."""
    out = np.unpackbits(np.asarray(packed, dtype=np.uint8), axis=-1,
                        bitorder="little")
    return out[..., :count].astype(bool)
