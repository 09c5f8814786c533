"""The narrow-input path of K1 and K10: when it runs, and its shared memory.

K1 (``sparse_conv.gather_conv``) and K10 (``block_dense.block_conv``) each
have two paths on the card.  The wide one stages Cin in 32-channel slices
per offset; the narrow one (``csrc/narrow_tile.cuh``) keeps the whole
weight in shared memory and gathers an im2col tile of every offset's few
channels, the JAX package's im2col form.  Both wrappers ask ``pick``, which
follows ``narrow_path`` of the conv's shape alone unless a benchmark or test
forces a path, so both kernels switch at the same place.

``layout`` and ``smem_bytes`` mirror ``ntt::layout`` and
``ntt::smem_bytes`` of ``narrow_tile.cuh`` (``chip_smoke.py`` holds them
equal to the library's ``narrow_conv_smem`` on the card).  Nothing here
needs a card.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

# Cin at or below which the narrow path runs: measured by
# ``tools/conv_bench.py --narrow`` (PERF.md section 6, the crossing): at Cin
# 1-4 the narrow path won every K1 and K10 case, fp32 and bf16, k3 and k5;
# at Cin 8 K1's k5 fp32 case lost (its FMAs grow with Cin, the wide path's
# slices do not).
# Every other conv of the port has Cin >= 32: the flagship's 259-channel
# and the v2 model's 262-channel stems, every k3 conv, the down convs, and
# every dX role (whose Cin is its conv's Cout).
NARROW_MAX_CIN = 4
# dynamic shared memory a thread block may use on an H100 (227 KB)
SMEM_LIMIT = 232448
# the most input channels the kernel holds of a source row in registers
# (``ntt::kMaxCin``)
KERNEL_MAX_CIN = 8
BM, BN = 128, 32         # output rows of a tile, columns of a column tile
MAX_G = 16               # offsets a chunk, at most (``ntt::kMaxG``)


class Layout(NamedTuple):
    g: int        # offsets a chunk
    kc: int       # a chunk's packed channels (bf16: padded to 16)
    ast: int      # the im2col tile's row stride, elements
    chunks: int
    kp: int       # weight rows in shared memory
    wst: int      # weight row stride, elements


def _is_bf16(dtype) -> bool:
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the narrow path takes float32 or bfloat16, not "
                        f"{dtype}")
    return dtype == torch.bfloat16


def layout(n_off: int, cin: int, cout: int, dtype) -> Layout:
    """The narrow core's shared-memory layout (``ntt::layout``)."""
    bf16 = _is_bf16(dtype)
    g = max(1, min(n_off, MAX_G, (64 if bf16 else 48) // cin))
    chunks = -(-n_off // g)
    cols = -(-cout // BN) * BN
    if bf16:
        kc = -(-g * cin // 16) * 16
        return Layout(g, kc, kc + 8, chunks, chunks * kc, cols + 8)
    kc = g * cin
    return Layout(g, kc, kc | 1, chunks, n_off * cin, cols)


def smem_bytes(n_off: int, cin: int, cout: int, dtype) -> int:
    """A thread block's dynamic shared memory on the narrow path: the
    weights, the im2col tile and two int32 rows of tile slots."""
    lay = layout(n_off, cin, cout, dtype)
    size = 2 if _is_bf16(dtype) else 4
    return size * (lay.kp * lay.wst + BM * lay.ast) + 2 * BM * 4


def narrow_fits(n_off: int, cin: int, cout: int, dtype) -> bool:
    """Whether the narrow path takes this shape: Cin within the kernel's
    registers and a thread block that fits on the card."""
    return 0 < cin <= KERNEL_MAX_CIN and \
        smem_bytes(n_off, cin, cout, dtype) <= SMEM_LIMIT


def narrow_path(n_off: int, cin: int, cout: int, dtype) -> bool:
    """Whether K1 and K10 run this conv on their narrow path: a few input
    channels, and a block that fits."""
    return cin <= NARROW_MAX_CIN and narrow_fits(n_off, cin, cout, dtype)


def pick(forced: Optional[bool], n_off: int, cin: int, cout: int, dtype,
         name: str) -> bool:
    """The path a wrapper takes: ``narrow_path`` of the shape, or the path
    a benchmark or test forces (``forced``), which must be one the kernel
    takes."""
    if forced is None:
        return narrow_path(n_off, cin, cout, dtype)
    if forced and not narrow_fits(n_off, cin, cout, dtype):
        raise ValueError(f"{name}: the narrow path does not take {n_off} "
                         f"offsets x {cin} -> {cout} channels in {dtype}")
    return forced
