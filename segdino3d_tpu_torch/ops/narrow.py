"""K1's, K4's, K10's and K11's paths by the conv's shape: the narrow-input
paths (when they run, and their shared memory), K10's and K11's live-pair
path at the block convs, K1's bf16 path at the wide stems, the stems'
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

Stem rows: K1, K2, K4, K10 and K11 copy rows with 16-byte copies where a
row's width (and its tensor's address) keeps 16-byte alignment, else
element by element, which costs the stems several times their products.
A row of the flagship's 259 or the v2 model's 262 channels breaks it in
either dtype, so the backbone wrapper gives the stem its input at
``row_pitch`` (bf16 264 for both; fp32 260 and 264: Cin rounded up to 8
or 4 elements, zero columns past Cin) and the stem pads its weight to match
(``models/backbone/res16unet.py:SubMConv``).  A zero column adds +0 to
each product's sum in the same order, so an fp32 stem at the pitch equals
the same call at Cin value for value.  ``element_loads.calls`` counts the
bf16 kernel calls that still copy element by element
(``count_element_loads``); ``chip_smoke.py`` holds it at 0 on the bf16
paths.
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
# ``block_wgrad`` with ``zero_outside``): every block conv's input is zero
# outside the occupancy (``conv_ctx.DenseCtx``: ``scatter_to_dense`` writes
# 0 at every empty cell, and ``MaskedBatchNorm`` zeroes every row outside
# ``valid`` before each activation, residual sum and concatenation), and
# every dX conv's masked cotangent is.  Off the narrow paths, fp32 runs
# every such conv on its live pairs in every role: on the row tiles a k3
# conv computes all 27 offsets of a listed row though about 9 sources are
# occupied, and K1 on the same pairs beat K10's row tiles at every level.
# bf16 runs the k5 stem there too, and a k3 conv in the roles and at the
# level sizes where the live-pair path won the paired measurement
# (``tools/conv_bench.py --live``, ``tools/wgrad_bench.py --live``, PERF.md
# section 6): up to a level of this many voxels
# (``block_dense.live_capacity``; None: every level).  The row tiles
# (``wgmma``) won the forward at the flagship's L0 and L1 (92,160 and
# 36,864 voxels; 96->96: 0.318 against 0.372 ms at L0, 0.136 against 0.158
# at L1) and dX there (0.840 against 0.868 at L0); the live-pair path won
# L3's wide forwards (384->256 0.055 against 0.082, 256->256 0.043 against
# 0.064), L2's and L3's wide dX (128->192 0.151 against 0.165, 256->384
# 0.090 against 0.159), and every dW (0.256 against 0.475 at L0 96->96);
# the rest tied within the calls' noise.  At a batch of 8 headline scenes
# (``chip_smoke.py`` phase 12a, L3 10,752 voxels) the live-pair path won
# L3's wide forwards again (384->256 0.243 against 0.439, 256->256 0.207
# against 0.301; 128->128 tied, 64->128 lost 0.094 to 0.066), so the
# forward's bound sits between that level and the batch-1 L2 (13,824),
# which keeps the row tiles.
BF16_K3_LIVE_MAX_CAP = {"forward": 12288, "dx": 16384, "wgrad": None}
# The row-group form (``csrc/live_rows.cuh``) of K10's live-pair path and
# of K1 (``gather_form``): one launch over groups of consecutive rows, each
# offset's pairs of a group added into the group's fp32 accumulator in
# shared memory, no pair-major buffer, no offset chunks.  It takes a conv
# by its key, dtype and role at levels of at least this many rows (the
# voxel cap of a gather level, ``block_dense.live_capacity`` of a
# block-dense one), where its paired measurement beat the pair-major form
# (``tools/conv_bench.py --form``, PERF.md section 6); a key absent here
# keeps the pair-major form.
#
# K10, bf16 dX: at the flagship's L0 (92,160 voxels; 96->96 0.702 / 0.684
# ms against the pair-major form's 0.828 / 0.809), the batch of 8's L1
# (190,919: 1.517 / 1.512 against 2.570 / 2.582 in 6 chunks) and the
# stress scene's L0 (262,014: 2.111 / 2.080 against 4.281 / 4.252 in 7),
# not at L1 and below (96->96 L1 0.295 against the row tiles' 0.204,
# ``conv_bench --live``).  Everywhere else K10 keeps its form: fp32 lost
# in every role and at every scale (forward L0 1.098 against 0.613, the
# batch's L1 2.712 against 2.154 in 6 chunks, the stress L0 3.262 against
# 2.486 in 7; dX 2.882 / 5.451 / 9.273 against 1.393 / 3.995 / 6.152),
# and the bf16 forward's row tiles beat it (the batch's L1 0.726 against
# 0.912, the stress L0 1.018 against 1.000 tied).
ROW_GROUPS_MIN_CAP = {
    # K10 (``live_form``): (k, dtype, role)
    (3, torch.bfloat16, "dx"): 65536,
}
# K1, keyed by the shapes the paired measurement timed (medians of 3 x 10
# calls, the final kernels; bf16, row groups against the pair-major form
# in the budget's chunks and in one chunk): the flagship's k3 convs of
# level 0, 96->96 and 128->96 after the concatenation, and their dX roles
# (96->96, 96->128).  At 155,648 rows (2 headline scenes, under 384 MiB)
# 96->96 0.649 ms against 0.977 in 5 chunks and 0.751 in one, its dX
# 0.648 (0.978, 0.754), 128->96 0.790 (1.025, 0.790), 96->128 0.923
# (1.320, 1.001); at 312,832 (4 scenes) 1.235 (2.133, 1.491), 1.219,
# 1.497, 1.757 (3.050, 1.950); at 625,664 (the batch of 8) 2.334 (5.420,
# 2.980), 2.334, 2.841 (5.641, 3.149), 3.357 (6.949, 3.927).  At the
# headline L0 (92,160) they tied or lost (96->96 0.379 against 0.376,
# dX 0.378 against 0.379, 128->96 0.470 against 0.403; 96->128 0.527
# against 0.562 in the default budget's 2 chunks but 0.503 in one), and
# at its L1 (36,864) they lost (0.273 against 0.160): the bound sits
# between 92,160 and 155,648 rows.  Everything else keeps the pair-major
# form: fp32 lost at every shape and scale (the batch's L0 96->96 8.145
# against 7.127 in 27 chunks; the headline's 1.140 against 0.610), and
# so did the stems (bf16 k5 259->32 at the batch 10.947 against 6.931 in
# 25 chunks, the v2 k3 262->32 at the headline 0.568 against 0.217; on
# the warpgroup core, tried and dropped, 7.915 and 0.391).
K1_ROW_GROUPS_MIN_CAP = {
    # K1 (``gather_form``): (offsets, Cin, Cout, dtype, role)
    (27, 96, 96, torch.bfloat16, "forward"): 131072,
    (27, 96, 96, torch.bfloat16, "dx"): 131072,
    (27, 128, 96, torch.bfloat16, "forward"): 131072,
    (27, 96, 128, torch.bfloat16, "dx"): 131072,
}


def live_path(n_off: int, cin: int, cout: int, dtype, zero_outside: bool,
              wgrad: bool = False, dx: bool = False,
              cap: Optional[int] = None) -> bool:
    """Whether K10 (K11 with ``wgrad``) runs this conv over its live
    pairs: the caller states the input zero outside the occupancy (every
    dX conv's is), the narrow path does not take the shape, and in bf16 at
    k3 the role (``dx``, ``wgrad``, else the forward) and the level's voxel
    capacity ``cap`` (None: not known, the row tiles) are ones where it
    won (``BF16_K3_LIVE_MAX_CAP``; or where its row-group form takes the
    conv, ``ROW_GROUPS_MIN_CAP``)."""
    if not zero_outside:
        return False
    if dtype in (torch.float32, torch.bfloat16) and (
            narrow_wgrad_path if wgrad else narrow_path)(n_off, cin, cout,
                                                         dtype):
        return False
    if dtype != torch.bfloat16 or n_off != 27:
        return True
    if not wgrad and live_form(3, dtype, dx, cap) == ROW_GROUPS:
        return True
    most = BF16_K3_LIVE_MAX_CAP["wgrad" if wgrad else "dx" if dx
                                else "forward"]
    return cap is not None and (most is None or cap <= most)


def _row_groups(table, key: tuple, dx: bool, cap: Optional[int]) -> bool:
    """Whether ``table`` (``ROW_GROUPS_MIN_CAP``, ``K1_ROW_GROUPS_MIN_CAP``)
    sends a conv of this key in this role to the row-group form at a level
    of ``cap`` rows."""
    least = table.get(key + ("dx" if dx else "forward",))
    return least is not None and cap is not None and cap >= least


# The two forms of K1 and of K10's live-pair path: the pair-major form
# (``csrc/pair_major.cuh``: each offset's pairs in items of 64, their fp32
# products into a (n_off x pair cap, Cout) buffer, then a second launch adds
# each row's products, in offset chunks past ``SEGDINO_CONV_CHUNK_MB``) and
# the row-group form (``csrc/live_rows.cuh``: one launch, groups of
# consecutive rows, each offset's pairs of a group added into its rows'
# accumulator).
PAIR_MAJOR, ROW_GROUPS = "pair-major", "row groups"
LIVE_FORMS = (PAIR_MAJOR, ROW_GROUPS)


def live_form(k: int, dtype, dx: bool = False, cap: Optional[int] = None
              ) -> str:
    """The form K10's live-pair path takes at kernel size ``k`` in
    ``dtype``, in the forward's role (``dx``: the input gradient's) at a
    level of ``cap`` voxels (None: not known)."""
    return ROW_GROUPS if _row_groups(ROW_GROUPS_MIN_CAP, (k, dtype), dx, cap) \
        else PAIR_MAJOR


def gather_form(n_off: int, cin: int, cout: int, dtype,
                cap: Optional[int] = None, dx: bool = False) -> str:
    """The form K1's wide path takes for ``n_off`` offsets of Cin -> Cout
    in ``dtype``, in the forward's role (``dx``: a k3 conv's input
    gradient, the same kernel with the weight flipped and transposed) on a
    table of ``cap`` rows (None: not known)."""
    return ROW_GROUPS if _row_groups(K1_ROW_GROUPS_MIN_CAP,
                                     (n_off, cin, cout, dtype), dx, cap) \
        else PAIR_MAJOR


# The rows a group of the row-group form takes (``lrc::Group`` in
# ``csrc/live_rows.cuh``), the faster of the sizes the paired measurement
# timed (``conv_bench --form``, PERF.md section 6): fp32 64 (K1's k3 at the
# headline L0 1.150 ms against 1.664 at 192), bf16 128 (the batch of 8's
# L0 2.369 against 2.862 at 192).  Groups filled to one 64-pair tile an
# offset (192 rows at k3; 160-320 timed) did not pay: their accumulator
# leaves one block an SM in fp32 at 96 columns, and an offset's pairs past
# a tile spill into a second, nearly empty chunk.  (The fp32 stems ran
# faster at 192, 5.10 against 5.93 at the headline, but lose to the
# pair-major form at either size.)  Every conv of the port fits two
# blocks an SM at these sizes (``rows_smem_bytes``, which a CPU test
# holds there and ``chip_smoke.py`` to the kernel's).
GROUP_ROWS = {torch.float32: 64, torch.bfloat16: 128}
# the shared memory of an H100 SM, and what each resident block reserves
SM_SMEM_BYTES = 233472
BLOCK_RESERVED_SMEM = 1024


def _pair_bn(cout: int) -> int:
    """K1's and K10's column tile (``gtt::pair_bn``)."""
    return 32 if cout <= 32 else 64 if cout <= 64 or cout > 96 else 96


def rows_smem_bytes(n_off: int, cout: int, dtype) -> int:
    """A block's dynamic shared memory in the row-group form
    (``lrc::smem_bytes``, which ``chip_smoke.py`` holds it equal to): the
    two stage buffers, the R x BN fp32 accumulator and the group's
    tables."""
    bf16 = _is_bf16(dtype)
    rows, bn = GROUP_ROWS[dtype], _pair_bn(cout)
    pad = 8 if bf16 else 4
    stages = (2 if bf16 else 4) * 2 * (
        64 * (32 + pad) + 32 * (bn + (pad if bf16 else 0)))
    tables = n_off * (rows // 32 + 2 + rows // 64) + rows + 4 * 64
    return stages + 4 * rows * bn + 4 * tables

def pick_live(forced: Optional[bool], narrow: bool, n_off: int, cin: int,
              cout: int, dtype, zero_outside: bool, name: str,
              wgrad: bool = False) -> bool:
    """The path a wrapper takes: ``live_path`` of the shape and the
    caller's statement (of the forward's or dW's role, at no known level),
    or the one its caller passes (the autograd Function, by role) or a
    benchmark or test forces, which the live-pair path takes only on an
    input stated zero outside the occupancy and off the narrow path."""
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
    kernels: Cin rounded up to 16 bytes (8 bf16 or 4 fp32 elements), or
    Cin itself on the narrow path (Cin <= NARROW_MAX_CIN, whose kernels
    read a few channels a row by design: padded, the Baseline's 3-channel
    stem would leave that path) or in another dtype."""
    per = {torch.bfloat16: 8, torch.float32: 4}.get(dtype)
    if per is None or cin <= NARROW_MAX_CIN:
        return cin
    return -(-cin // per) * per


element_loads = types.SimpleNamespace(calls=0)


def count_element_loads(*tensors: torch.Tensor) -> None:
    """Count a bf16 kernel call whose rows the kernel copies element by
    element: a tensor whose row width or address breaks 16-byte
    alignment."""
    if tensors[0].dtype == torch.bfloat16 and any(
            t.shape[-1] % 8 or t.data_ptr() % 16 for t in tensors):
        element_loads.calls += 1
