"""K1's, K4's, K10's and K11's paths by the conv's shape: the narrow-input
paths (when they run, and their shared memory), K10's and K11's live-pair
path at the dense k5 stem, K1's bf16 path at the wide stems, the stems'
aligned row pitch, and the count of calls that copy element by element.

K1 (``sparse_conv.gather_conv``) and K10 (``block_dense.block_conv``) each
have two paths on the card.  The wide one stages Cin in 32-channel slices
per offset; the narrow one (``csrc/narrow_tile.cuh``) keeps the whole
weight in shared memory and gathers an im2col tile of every offset's few
channels, the JAX package's im2col form.  Both wrappers ask ``pick``, which
follows ``narrow_path`` of the conv's shape alone unless a benchmark or test
forces a path, so both kernels switch at the same place.

The weight gradients K4 (``sparse_conv.gather_wgrad``) and K11
(``block_dense.block_wgrad``) have a narrow path too
(``csrc/narrow_wgrad.cuh``): the transpose of the same im2col form, the
chunk's dW block in registers over the listed rows.  They ask ``pick``
with ``wgrad=True``, which follows ``narrow_wgrad_path``.

``layout`` and ``smem_bytes`` mirror ``ntt::layout`` and
``ntt::smem_bytes`` of ``narrow_tile.cuh``, ``wgrad_layout`` and
``wgrad_smem_bytes`` ``nwt::layout`` and ``nwt::smem_bytes`` of
``narrow_wgrad.cuh`` (``chip_smoke.py`` holds them equal to the
libraries' ``narrow_conv_smem`` and ``narrow_wgrad_smem`` on the card).
Nothing here needs a card.

bf16 rows: K1, K2, K4, K10 and K11 copy rows with 16-byte copies where a
row's width (and its tensor's address) keeps 16-byte alignment, else
element by element, which costs the stems several times their products.
A bf16 row of the flagship's 259 or the v2 model's 262 channels breaks it,
so the backbone wrapper gives the stem its input at ``row_pitch`` (264,
zero columns past Cin) and the stem pads its weight to match
(``models/backbone/res16unet.py:SubMConv``).  ``element_loads.calls``
counts the bf16 kernel calls that still copy element by element
(``count_element_loads``); ``chip_smoke.py`` holds it at 0 on the bf16
paths.  In fp32 the pitch stays Cin (the kernels copy 4 bytes at a time
there), so fp32 results are unchanged.
"""
from __future__ import annotations

import types
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
# Cin at or below which K4 and K11 reduce a dW on their narrow path:
# measured by ``tools/wgrad_bench.py --narrow`` (PERF.md section 6, the dW
# crossing): the narrow path won every case at Cin 1, 2, 3, 4 and 8, k3
# and k5, fp32 and bf16 (K4 at k5 Cin 8 by 1.17x, where each of its 16 or
# 21 chunks re-reads dY), so the dW rule reaches the kernel's largest Cin.
# Only the Baseline's stem dW has Cin below 32 among the port's convs.
NARROW_WGRAD_MAX_CIN = 8
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


class WgradLayout(NamedTuple):
    g: int        # offsets a chunk (the forward's)
    kc: int       # a chunk's packed channels (bf16: padded to 16)
    ast: int      # the im2col tile's row stride, elements
    chunks: int
    dst: int      # the dY tile's row stride, elements


def wgrad_layout(n_off: int, cin: int, cout: int, dtype) -> WgradLayout:
    """The narrow weight gradient's shared-memory layout (``nwt::layout``):
    the forward's chunks and im2col tile, no weight, a dY tile of BN
    columns."""
    lay = layout(n_off, cin, cout, dtype)
    return WgradLayout(lay.g, lay.kc, lay.ast, lay.chunks,
                       BN + 8 if _is_bf16(dtype) else BN)


def wgrad_smem_bytes(n_off: int, cin: int, cout: int, dtype) -> int:
    """A thread block's dynamic shared memory on the narrow weight
    gradient: the im2col tile and the dY tile, BM rows each."""
    lay = wgrad_layout(n_off, cin, cout, dtype)
    return (2 if _is_bf16(dtype) else 4) * BM * (lay.ast + lay.dst)


def wgrad_fits(n_off: int, cin: int, cout: int, dtype) -> bool:
    """Whether K4's and K11's narrow path takes this dW shape (n_off,
    Cin, Cout): Cin within the kernel's registers and a block that fits
    (any Cout: column tiles of BN)."""
    return 0 < cin <= KERNEL_MAX_CIN and \
        wgrad_smem_bytes(n_off, cin, cout, dtype) <= SMEM_LIMIT


def narrow_wgrad_path(n_off: int, cin: int, cout: int, dtype) -> bool:
    """Whether K4 and K11 reduce this dW on their narrow path: a few input
    channels, and a block that fits."""
    return cin <= NARROW_WGRAD_MAX_CIN and \
        wgrad_fits(n_off, cin, cout, dtype)


def pick(forced: Optional[bool], n_off: int, cin: int, cout: int, dtype,
         name: str, wgrad: bool = False) -> bool:
    """The path a wrapper takes: ``narrow_path`` (``narrow_wgrad_path``
    for a weight gradient) of the shape, or the path a benchmark or test
    forces (``forced``), which must be one the kernel takes."""
    fits, rule = (wgrad_fits, narrow_wgrad_path) if wgrad else \
        (narrow_fits, narrow_path)
    if forced is None:
        return rule(n_off, cin, cout, dtype)
    if forced and not fits(n_off, cin, cout, dtype):
        raise ValueError(f"{name}: the narrow path does not take {n_off} "
                         f"offsets x {cin} -> {cout} channels in {dtype}")
    return forced


# K10's and K11's live-pair path (``block_dense.block_conv`` and
# ``block_wgrad`` with ``zero_outside``): a k5 conv whose caller states its
# input zero outside the occupancy (the flagship's dense stem, 259 -> 32,
# whose input comes straight from ``scatter_to_dense``), off the narrow
# paths.  Every other block conv keeps the row-tile path: the k3 convs'
# inputs are not promised zero there.
LIVE_KERNEL_VOLUME = 125


def live_path(n_off: int, cin: int, cout: int, dtype, zero_outside: bool,
              wgrad: bool = False) -> bool:
    """Whether K10 (K11 with ``wgrad``) runs this conv over its live
    pairs: the caller states the input zero outside the occupancy, the
    kernel is k5, and the narrow path does not take the shape."""
    if not zero_outside or n_off != LIVE_KERNEL_VOLUME:
        return False
    rule = narrow_wgrad_path if wgrad else narrow_path
    return dtype not in (torch.float32, torch.bfloat16) or \
        not rule(n_off, cin, cout, dtype)


def pick_live(forced: Optional[bool], narrow: bool, n_off: int, cin: int,
              cout: int, dtype, zero_outside: bool, name: str,
              wgrad: bool = False) -> bool:
    """The path a wrapper takes: ``live_path`` of the shape and the
    caller's statement, or the one a benchmark or test forces, which the
    live-pair path takes only on an input stated zero outside the
    occupancy and off the narrow path."""
    if forced is None:
        return not narrow and live_path(n_off, cin, cout, dtype, zero_outside,
                                        wgrad)
    if forced and (narrow or not zero_outside):
        raise ValueError(f"{name}: the live-pair path takes an input stated "
                         "zero outside the occupancy, off the narrow path")
    return forced


# K1's bf16 warpgroup path (``gather_gemm_conv.cu:gather_conv_wg``) takes
# the wide stems: Cin above this and Cout at most WIDE_STEM_MAX_COUT.  The
# flagship's k5 stem (259 -> 32) and the v2 model's k3 stem (262 -> 32) are
# the port's only such convs; every other bf16 K1 conv keeps the mma.sync
# core (Cin <= 384 with Cout >= 64, or Cin <= 96).
WIDE_STEM_MIN_CIN = 257
WIDE_STEM_MAX_COUT = 32


def wide_stem(cin: int, cout: int, dtype) -> bool:
    """Whether K1 runs this conv on its bf16 warpgroup path."""
    return dtype == torch.bfloat16 and cin >= WIDE_STEM_MIN_CIN \
        and cout <= WIDE_STEM_MAX_COUT


def wg_bn(cout: int) -> int:
    """The warpgroup core's column tile for Cout (``wgc::pick_bn``)."""
    return 32 if cout <= 32 else 64 if cout <= 64 else 96 if cout <= 96 \
        else 128


def row_pitch(cin: int, dtype) -> int:
    """The row width at which a stem's ``cin`` input channels reach the
    kernels: Cin rounded up to 16 bytes in bf16, Cin itself in fp32 and
    on the narrow path (Cin <= NARROW_MAX_CIN, whose kernels read a few
    channels a row by design: padded, the Baseline's 3-channel stem would
    leave that path)."""
    if dtype != torch.bfloat16 or cin <= NARROW_MAX_CIN:
        return cin
    return -(-cin // 8) * 8


element_loads = types.SimpleNamespace(calls=0)


def count_element_loads(*tensors: torch.Tensor) -> None:
    """Count a bf16 kernel call whose rows the kernel copies element by
    element: a tensor whose row width or address breaks 16-byte
    alignment."""
    if tensors[0].dtype == torch.bfloat16 and any(
            t.shape[-1] % 8 or t.data_ptr() % 16 for t in tensors):
        element_loads.calls += 1
