"""Block-dense submanifold convolution: voxels packed into dense blocks.

Counterpart of ``segdino3d_tpu/ops/block_dense.py``.  The host plan
(``ops.host_plan``, C++ ``block_assign``) packs each level's voxels into
aligned ``edge``^3 blocks (x-major cells: ``lx*edge^2 + ly*edge + lz``) and
gives each block its 26 shell neighbours.  A level's features then live as
flat dense rows ``(B*edge^3, C)``:

1. ``scatter_to_dense`` moves voxel rows to dense rows once per stage;
2. each submanifold conv pads every block with the cells of its 26 shell
   neighbours, runs a VALID dense 3D convolution and zeroes the
   unoccupied cells (``dense_subm_conv``);
3. ``gather_from_dense`` moves the rows back to voxels.

Three hand-written CUDA kernels carry it:

* ``slot_gather`` (K9, ``csrc/slot_gather.cu``): ``out[j] = x[idx[j]]``, 0
  where ``idx[j] < 0``.  ``scatter_to_dense`` is the gather through the
  plan's inverse table ``slot_vox`` (every dense row written once, equal to
  the scatter because ``vox_slot`` is injective on valid voxels) and
  ``gather_from_dense`` the gather through ``vox_slot``; each one's
  gradient is the other;
* ``block_conv`` (K10, ``csrc/block_conv.cu``): the halo-padded dense conv
  at the rows of its output mask only (a row list built on the card, 64-row
  tiles across blocks, each row's sources read through the halo addressing;
  the halo is never written to device memory), the other rows zero; for a
  few input channels (the Baseline's rgb stem, ``narrow.narrow_path``) on
  its narrow path, im2col tiles of every offset at once;
* ``block_wgrad`` (K11, ``csrc/block_wgrad.cu``): its weight gradient,
  reduced over the level's occupied-row list (``row_list``: K10's
  ``block_rows``, built once per level and step and kept on the tables,
  which every K10 forward conv of the level also takes); for a few input
  channels (``narrow.narrow_wgrad_path``) on its narrow path, im2col
  tiles of every offset's sources over the listed rows;
* the live-pair path of K10 and K11 (``narrow.live_path``), for a conv
  whose caller states its input zero outside the occupancy (the dense k5
  stem in training, its input straight from ``scatter_to_dense``): a
  source cell outside the occupancy then holds a zero row, so only the
  (listed row, offset) pairs with an occupied source are computed, over a
  list built on the card once per level and step (``live_pairs``:
  ``block_live_pairs``, a pass over the row list) that the stem's forward
  and its dW share; the forward in K1's pair-major form, the dW on K11's
  tile core.

``dense_subm_conv`` is a ``torch.autograd.Function`` whose backward runs
K10 for dX (the mirror identity of ``_chunked_conv_bwd``: the same conv of
the occupancy-masked cotangent with offset-flipped, channel-transposed
weights) and K11 for dW.  The JAX op's dX is not masked: it is non-zero at
unoccupied cells next to occupied ones.  It is zero outside the k-dilation
of the occupancy (the cells whose k^3 window holds an occupied cell), so
the backward gives K10 that dilation as its output mask, which is exact on
every cell, with the dilation's row list (``dilation``: built on the card
once per level and kernel size by ``block_dilate``, a kernel beside K10,
and its list pass).  The JAX module chunks
wide convs and halves wide inputs to bound a TPU buffer; both are exact,
and the port, which never materialises the halo, does neither.

Each wrapper launches its kernel for a CUDA tensor and counts the launch in
its ``launches`` attribute; for a CPU tensor it runs the plain PyTorch
version beside it (``*_plain``), which the CPU tests hold against the JAX
package and ``chip_smoke.py`` holds the kernel against on the card.  While
``torch.export`` traces a model, ``slot_gather``, ``block_conv`` and the
row list put their kernels in the graph as ``ops.custom_ops``' registered
ops instead.
"""
from __future__ import annotations

import itertools
import types
from dataclasses import dataclass, field
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from segdino3d_tpu_torch.ops import cuda_build
from segdino3d_tpu_torch.ops import narrow as N
from segdino3d_tpu_torch.ops.sparse_conv import (_gather_rows, _require_cuda,
                                                 _transposed, as_sum_type,
                                                 wgrad_splits)

# rows of the (26, B) shell-neighbour table: itertools.product(-1, 0, 1)^3
# order with the centre skipped; face directions land at these rows
FACE_XM, FACE_YM, FACE_ZM, FACE_ZP, FACE_YP, FACE_XP = 4, 10, 12, 13, 15, 21
# block edges and kernel sizes the kernels take
EDGES = (4, 8)
KERNEL_SIZES = (3, 5)


def _shell_dirs():
    return [d for d in itertools.product((-1, 0, 1), repeat=3)
            if d != (0, 0, 0)]


@dataclass
class BlockTables:
    """One level's block-dense layout (``ops.host_plan.host_plan_to_device``)."""
    vox_slot: torch.Tensor    # (V,) int32 block*edge^3 + cell, -1 invalid
    block_nbr: torch.Tensor   # (26, B) int32 shell neighbours, -1 absent
    slot_vox: torch.Tensor    # (B*edge^3,) int32 dense row -> voxel, -1 empty
    edge: int
    # k -> (occupancy, its k-dilation, the dilation's row list), filled by
    # ``dilation``
    dilations: Dict[int, Tuple[torch.Tensor, torch.Tensor, "RowList"]] = \
        field(default_factory=dict, repr=False, compare=False)
    # (occupancy, its occupied-row list), filled by ``row_list``
    rows: Optional[Tuple[torch.Tensor, "RowList"]] = field(
        default=None, repr=False, compare=False)
    # k -> (occupancy, its live-pair list), filled by ``live_pairs``
    live: Dict[int, Tuple[torch.Tensor, "LivePairs"]] = field(
        default_factory=dict, repr=False, compare=False)

    @property
    def num_blocks(self) -> int:
        return self.block_nbr.shape[1]


def occupancy(tables: BlockTables) -> torch.Tensor:
    """(B*edge^3,) bool occupied cells.  ``block_assign`` gives every voxel
    past the level's count ``vox_slot = -1``, so ``slot_vox`` names valid
    voxels only."""
    return tables.slot_vox >= 0


def kernel_size(n_off: int) -> int:
    k = round(n_off ** (1.0 / 3.0))
    if k ** 3 != n_off:
        raise ValueError(f"{n_off} offsets are not a cube")
    return k


# ---------------------------------------------------------------------------
# K9: slot gather
# ---------------------------------------------------------------------------

def slot_gather_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of K9."""
    return _gather_rows(x, idx)


def slot_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[j] = x[idx[j]]``, a zero row where ``idx[j] < 0``.

    x (R, C) of any dtype, rows contiguous; idx (N,) int32 with entries in
    [-1, R).  Returns (N, C) in x's dtype."""
    if x.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"slot_gather: x {tuple(x.shape)}, idx "
                         f"{tuple(idx.shape)}")
    if torch.compiler.is_exporting():
        from segdino3d_tpu_torch.ops import custom_ops
        return custom_ops.slot_gather(x, idx)
    if x.device.type == "cpu":
        return slot_gather_plain(x, idx)
    _require_cuda("slot_gather", x, idx)
    if idx.dtype != torch.int32:
        raise TypeError("slot_gather: idx must be int32")
    out = torch.empty(idx.shape[0], x.shape[1], dtype=x.dtype,
                      device=x.device)
    lib = cuda_build.library("slot_gather")
    cuda_build.check(lib.slot_gather(
        x.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0],
        x.shape[1] * x.element_size(), cuda_build.stream_ptr(x)),
        "slot_gather")
    slot_gather.launches += 1
    return out


slot_gather.launches = 0


class _SlotGather(torch.autograd.Function):
    """``out = x[idx]`` where ``idx`` is injective on its non-negative
    entries and ``inv_idx`` is its inverse; the transpose of an injective
    gather is the inverse gather (``_bijection_take`` in JAX)."""

    @staticmethod
    def forward(ctx, x, idx, inv_idx):
        ctx.save_for_backward(inv_idx)
        return slot_gather(x, idx)

    @staticmethod
    def backward(ctx, g):
        (inv_idx,) = ctx.saved_tensors
        dx = None
        if ctx.needs_input_grad[0]:
            dx = slot_gather(g.contiguous(), inv_idx)
        return dx, None, None


def scatter_to_dense(feats: torch.Tensor, tables: BlockTables) -> torch.Tensor:
    """(V, C) voxel rows -> (B*edge^3, C) flat dense rows, 0 at empty cells."""
    return _SlotGather.apply(feats, tables.slot_vox, tables.vox_slot)


def gather_from_dense(dense: torch.Tensor, tables: BlockTables
                      ) -> torch.Tensor:
    """(B*edge^3, C) flat dense rows -> (V, C) voxel rows, 0 past the
    level's count."""
    return _SlotGather.apply(dense, tables.vox_slot, tables.slot_vox)


# ---------------------------------------------------------------------------
# K10: the halo-padded block conv
# ---------------------------------------------------------------------------

def halo_pad_plain(blocks: torch.Tensor, block_nbr: torch.Tensor,
                   halo: int) -> torch.Tensor:
    """(B, E, E, E, C) -> (B, E+2h, E+2h, E+2h, C): every shell direction
    takes its slab from the neighbour's core (``_halo_pad_impl`` in JAX),
    zeros where the neighbour is absent."""
    h = halo
    b, e, c = blocks.shape[0], blocks.shape[1], blocks.shape[-1]
    sl = {-1: slice(e - h, e), 0: slice(0, e), 1: slice(0, h)}
    parts = {(0, 0, 0): blocks}
    for di, d in enumerate(_shell_dirs()):
        slab = blocks[:, sl[d[0]], sl[d[1]], sl[d[2]], :].reshape(b, -1)
        ext = (h if d[0] else e, h if d[1] else e, h if d[2] else e)
        parts[d] = _gather_rows(slab, block_nbr[di]).reshape(b, *ext, c)
    xs = []
    for dx in (-1, 0, 1):
        ys = []
        for dy in (-1, 0, 1):
            ys.append(torch.cat([parts[(dx, dy, dz)] for dz in (-1, 0, 1)],
                                dim=3))
        xs.append(torch.cat(ys, dim=2))
    return torch.cat(xs, dim=1)


def dense_subm_conv_plain(feats: torch.Tensor, block_nbr: torch.Tensor,
                          weights: torch.Tensor, occ: Optional[torch.Tensor],
                          edge: int) -> torch.Tensor:
    """Plain version of K10: ``halo_pad_plain``, then one fp32 product of
    the shifted window per offset, in ascending offset order."""
    n_off, cin, cout = weights.shape
    k = kernel_size(n_off)
    b = block_nbr.shape[1]
    x = as_sum_type(feats).reshape(b, edge, edge, edge, cin)
    padded = halo_pad_plain(x, block_nbr, (k - 1) // 2)
    wf = as_sum_type(weights)
    acc = x.new_zeros(b * edge ** 3, cout)
    for o, (i, j, m) in enumerate(itertools.product(range(k), repeat=3)):
        window = padded[:, i:i + edge, j:j + edge, m:m + edge, :]
        acc += window.reshape(-1, cin) @ wf[o]
    if occ is not None:
        acc = torch.where(occ[:, None], acc, 0.0)
    return acc.to(feats.dtype)


def _check_layout(name, feats, block_nbr, n_off, edge, cin):
    b = block_nbr.shape[1]
    if block_nbr.shape[0] != 26 or tuple(feats.shape) != (b * edge ** 3, cin):
        raise ValueError(f"{name}: feats {tuple(feats.shape)}, block_nbr "
                         f"{tuple(block_nbr.shape)}, edge {edge}, Cin {cin}")
    if edge not in EDGES or kernel_size(n_off) not in KERNEL_SIZES:
        raise ValueError(f"{name}: edge {edge} / k {kernel_size(n_off)} not "
                         f"in {EDGES} / {KERNEL_SIZES}")


# K10's row list: rows per thread block of its count and list passes
LIST_ROWS = 4096


def row_workspace_size(n_rows: int) -> int:
    """K10's int32 scratch: the row list (``n_rows``), its count, the conv's
    tile ticket and the list passes' per-block counts."""
    return n_rows + 2 + -(-n_rows // LIST_ROWS)


def row_workspace(n_rows: int, device) -> torch.Tensor:
    return torch.empty(row_workspace_size(n_rows), dtype=torch.int32,
                       device=device)


def occupied_rows_plain(mask: torch.Tensor) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Plain version of K10's row list: the rows of ``mask`` (R,) bool in
    ascending order, which is block-major, in a list of capacity R with -1
    past the count; and the count, () int32."""
    idx = torch.nonzero(mask).flatten().to(torch.int32)
    rows = torch.full((mask.shape[0],), -1, dtype=torch.int32,
                      device=mask.device)
    rows[:idx.shape[0]] = idx
    return rows, torch.tensor(idx.shape[0], dtype=torch.int32,
                              device=mask.device)


class RowList(NamedTuple):
    """An occupied-row list: the rows of a mask, ascending."""
    rows: torch.Tensor              # (R,) int32; past the count: -1 (plain
    #                                 version) or unspecified (kernel)
    count: torch.Tensor             # () int32
    ws: Optional[torch.Tensor]      # block_rows' workspace (rows, count,
    #                                 a tile ticket), None on the CPU


def rows_in(ws: torch.Tensor, n_rows: int) -> RowList:
    """The ``RowList`` of ``n_rows`` rows whose workspace is ``ws``."""
    return RowList(ws[:n_rows], ws[n_rows], ws)


def _row_list(mask: torch.Tensor) -> RowList:
    if mask.dim() != 1 or mask.dtype != torch.bool:
        raise TypeError("occupied_rows: mask must be (R,) bool")
    if torch.compiler.is_exporting():
        from segdino3d_tpu_torch.ops import custom_ops
        return custom_ops.block_rows(mask)
    if mask.device.type == "cpu":
        return RowList(*occupied_rows_plain(mask), None)
    _require_cuda("occupied_rows", mask)
    n = mask.shape[0]
    ws = row_workspace(n, mask.device)
    lib = cuda_build.library("block_conv")
    cuda_build.check(lib.block_rows(mask.data_ptr(), ws.data_ptr(), n,
                                    cuda_build.stream_ptr(mask)),
                     "block_rows")
    occupied_rows.launches += 1
    return rows_in(ws, n)


def occupied_rows(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10's row list of ``mask`` (``block_rows``) as a -1-padded list:
    see ``occupied_rows_plain``.  The count stays on the card."""
    rows, count, ws = _row_list(mask)
    if ws is None:
        return rows, count
    n = mask.shape[0]
    return torch.where(torch.arange(n, device=mask.device) < count, rows,
                       -1), count


occupied_rows.launches = 0


def row_list(tables: BlockTables, occ: torch.Tensor) -> RowList:
    """The occupied-row list of ``occ`` on ``tables``, kept on the tables:
    built once per level (``block_rows``) for all the level's forward
    convs (K10) and weight gradients (K11)."""
    hit = tables.rows
    if hit is None or hit[0] is not occ:
        hit = (occ, _row_list(occ))
        tables.rows = hit
    return hit[1]


def occupancy_dilation_plain(mask: torch.Tensor, block_nbr: torch.Tensor,
                             edge: int, k: int) -> torch.Tensor:
    """Plain version of ``block_dilate``: the rows whose k^3 window of the
    halo-padded block holds a row of ``mask`` (B*edge^3,) bool."""
    b = block_nbr.shape[1]
    m = mask.reshape(b, edge, edge, edge, 1).to(torch.float32)
    padded = halo_pad_plain(m, block_nbr, (k - 1) // 2)[..., 0]
    pooled = torch.nn.functional.max_pool3d(padded[:, None], k, stride=1)
    return (pooled[:, 0] > 0).reshape(-1)


def dilated_rows(mask: torch.Tensor, block_nbr: torch.Tensor, edge: int,
                 k: int) -> Tuple[torch.Tensor, RowList]:
    """((B*edge^3,) bool, its row list): the k-dilation of ``mask`` through
    the block halo (a row is in it when some row of its k^3 window is in
    ``mask``).  On the card ``block_dilate`` writes the mask and the list
    pass's counts in one pass, then the list pass runs (two launches,
    counted as one call)."""
    b = block_nbr.shape[1]
    if tuple(mask.shape) != (b * edge ** 3,) or mask.dtype != torch.bool \
            or edge not in EDGES or k not in KERNEL_SIZES:
        raise ValueError(f"dilated_rows: mask {tuple(mask.shape)} "
                         f"{mask.dtype}, {b} blocks, edge {edge}, k {k}")
    if mask.device.type == "cpu":
        out = occupancy_dilation_plain(mask, block_nbr, edge, k)
        return out, RowList(*occupied_rows_plain(out), None)
    _require_cuda("dilated_rows", mask, block_nbr)
    if mask.data_ptr() % 8:
        raise ValueError("dilated_rows: mask must be 8-byte aligned")
    n = mask.shape[0]
    out = torch.empty_like(mask)
    ws = row_workspace(n, mask.device)
    lib = cuda_build.library("block_conv")
    cuda_build.check(lib.block_dilate(
        mask.data_ptr(), block_nbr.data_ptr(), out.data_ptr(), ws.data_ptr(),
        b, edge, k, cuda_build.stream_ptr(mask)), "block_dilate")
    dilated_rows.launches += 1
    return out, rows_in(ws, n)


dilated_rows.launches = 0


def dilation(tables: BlockTables, occ: torch.Tensor, k: int
             ) -> Tuple[torch.Tensor, RowList]:
    """The k-dilation of ``occ`` on ``tables`` and its row list, kept on
    the tables: built once per level and kernel size for all the level's
    dX convs."""
    hit = tables.dilations.get(k)
    if hit is None or hit[0] is not occ:
        hit = (occ, *dilated_rows(occ, tables.block_nbr, tables.edge, k))
        tables.dilations[k] = hit
    return hit[1], hit[2]


# ---------------------------------------------------------------------------
# the live-pair path: K10 and K11 where the input is zero outside the
# occupancy (the dense stem)
# ---------------------------------------------------------------------------

class LivePairs(NamedTuple):
    """The live pairs of an occupied-row list: per offset o, in list order,
    the listed rows whose source cell (through the block halo) is occupied.
    Pair j of offset o is ``(src[o, j], dst[o, j])``; ``map[o, i]`` is the
    pair of listed row i at o, -1 where its source is unoccupied or
    absent."""
    src: torch.Tensor       # (n_off, cap) int32 source rows; past the
    #                         count -1 (plain version) or unspecified
    dst: torch.Tensor       # (n_off, cap) int32 listed rows, the same
    map: torch.Tensor       # (n_off, cap) int32; past the row count -1
    #                         (plain version) or unspecified
    counts: torch.Tensor    # (n_off,) int32
    rows: RowList           # the occupied-row list it was built on
    ws: Optional[torch.Tensor]   # block_live_pairs' workspace, None on the
    #                              CPU


def live_workspace_size(n_off: int, cap: int) -> int:
    """``block_live_pairs``' int32 workspace: src, dst and map, the counts,
    a ticket, the list passes' per-block counts and the count pass's bits
    (a word per 32 listed rows)."""
    blocks = max(1, -(-cap // LIST_ROWS))
    return 3 * n_off * cap + n_off + 1 + n_off * blocks * (1 + LIST_ROWS // 32)


def live_capacity(tables: BlockTables) -> int:
    """The listed rows a level's live-pair list holds: its occupied rows
    are distinct voxels' slots (``vox_slot`` is injective), so at most the
    level's voxel capacity."""
    return min(tables.slot_vox.shape[0], tables.vox_slot.shape[0])


def live_pairs_plain(rows: RowList, occ: torch.Tensor,
                     block_nbr: torch.Tensor, edge: int, k: int, cap: int
                     ) -> LivePairs:
    """Plain version of ``block_live_pairs``."""
    n = int(rows.count)
    listed = rows.rows[:n]
    h = (k - 1) // 2
    n_off = k ** 3
    src = torch.full((n_off, cap), -1, dtype=torch.int32, device=occ.device)
    dst, pmap = src.clone(), src.clone()
    counts = torch.zeros(n_off, dtype=torch.int32, device=occ.device)
    for o, shift in enumerate(itertools.product(range(-h, h + 1), repeat=3)):
        s = halo_rows_plain(listed, block_nbr, edge, shift)
        live = (s >= 0) & occ[s.clamp(min=0).long()]
        c = int(live.sum())
        src[o, :c], dst[o, :c] = s[live], listed[live]
        pmap[o, :n] = torch.where(live, torch.cumsum(live, 0) - 1, -1).to(
            torch.int32)
        counts[o] = c
    return LivePairs(src, dst, pmap, counts, rows, None)


def live_in(ws: torch.Tensor, n_off: int, cap: int, rows: RowList
            ) -> LivePairs:
    """The ``LivePairs`` of ``rows`` whose workspace is ``ws``."""
    n = n_off * cap
    return LivePairs(ws[:n].view(n_off, cap), ws[n:2 * n].view(n_off, cap),
                     ws[2 * n:3 * n].view(n_off, cap),
                     ws[3 * n:3 * n + n_off], rows, ws)


def live_pair_list(rows: RowList, occ: torch.Tensor, block_nbr: torch.Tensor,
                   edge: int, k: int, cap: Optional[int] = None) -> LivePairs:
    """The live pairs of ``rows``, the row list of ``occ``: on the card one
    pass over the list (two launches, ``block_live_pairs``), the counts
    left there.  ``cap`` bounds the list's count (``live_capacity``; the
    list's own capacity when not given)."""
    n_rows = occ.shape[0]
    cap = n_rows if cap is None else cap
    if edge not in EDGES or k not in KERNEL_SIZES or not 0 <= cap <= n_rows \
            or occ.dtype != torch.bool or rows.rows.shape[0] != n_rows:
        raise ValueError(f"live_pair_list: {n_rows} rows, edge {edge}, k {k},"
                         f" cap {cap}")
    if occ.device.type == "cpu":
        return live_pairs_plain(rows, occ, block_nbr, edge, k, cap)
    _require_cuda("live_pair_list", occ, block_nbr)
    if rows.ws is None:
        raise ValueError("live_pair_list: rows must be the card's row list")
    n_off = k ** 3
    ws = torch.empty(live_workspace_size(n_off, cap), dtype=torch.int32,
                     device=occ.device)
    lib = cuda_build.library("block_conv")
    cuda_build.check(lib.block_live_pairs(
        rows.ws.data_ptr(), occ.data_ptr(), block_nbr.data_ptr(),
        ws.data_ptr(), block_nbr.shape[1], edge, k, cap,
        cuda_build.stream_ptr(occ)), "block_live_pairs")
    live_pair_list.launches += 1
    return live_in(ws, n_off, cap, rows)


live_pair_list.launches = 0


def live_pairs(tables: BlockTables, occ: torch.Tensor, k: int) -> LivePairs:
    """The live-pair list of ``occ``'s row list on ``tables``, kept on the
    tables: built once per level and step for the stem's forward (K10) and
    its weight gradient (K11)."""
    hit = tables.live.get(k)
    if hit is None or hit[0] is not occ:
        hit = (occ, live_pair_list(row_list(tables, occ), occ,
                                   tables.block_nbr, tables.edge, k,
                                   live_capacity(tables)))
        tables.live[k] = hit
    return hit[1]


def block_conv_live_plain(feats: torch.Tensor, weights: torch.Tensor,
                          pairs: LivePairs) -> torch.Tensor:
    """Plain version of K10's live-pair path: per offset, ascending, its
    live pairs' products ``feats[src] @ weights[o]`` in fp32 added to their
    rows; every other row 0.  On an input zero outside the occupancy the
    list was built on, ``dense_subm_conv_plain`` under that occupancy."""
    xf, wf = as_sum_type(feats), as_sum_type(weights)
    acc = xf.new_zeros(feats.shape[0], weights.shape[2])
    for o in range(weights.shape[0]):
        n = int(pairs.counts[o])
        acc.index_add_(0, pairs.dst[o, :n].long(),
                       xf[pairs.src[o, :n].long()] @ wf[o])
    return acc.to(feats.dtype)


def block_wgrad_live_plain(feats: torch.Tensor, dy: torch.Tensor,
                           pairs: LivePairs) -> torch.Tensor:
    """Plain version of K11's live-pair path: ``dW[o] = feats[src]^T @
    dy[dst]`` over offset o's live pairs, fp32.  On an input zero outside
    the occupancy the list was built on, ``block_wgrad_plain``."""
    xf, dyf = as_sum_type(feats), as_sum_type(dy)
    n_off = pairs.src.shape[0]
    dw = xf.new_zeros(n_off, feats.shape[1], dy.shape[1])
    for o in range(n_off):
        n = int(pairs.counts[o])
        dw[o] = xf[pairs.src[o, :n].long()].T @ dyf[pairs.dst[o, :n].long()]
    return dw


def _live_list(live_list, rows, occ, block_nbr, edge, k):
    """The call's live-pair list: the caller's, else one built here on
    ``rows`` (or on a row list built here) at the rows' capacity."""
    if live_list is not None:
        if live_list.src.shape[0] != k ** 3 or (
                occ.is_cuda and live_list.ws is None):
            raise ValueError("the live-pair list does not match the call")
        return live_list
    if rows is None or (occ.is_cuda and rows.ws is None):
        rows = _row_list(occ)
    return live_pair_list(rows, occ, block_nbr, edge, k)


def block_conv(feats: torch.Tensor, block_nbr: torch.Tensor,
               weights: torch.Tensor, occ: Optional[torch.Tensor],
               edge: int, rows: Optional[RowList] = None,
               narrow: Optional[bool] = None,
               groups: Optional[int] = None, zero_outside: bool = False,
               live: Optional[bool] = None,
               live_list: Optional[LivePairs] = None) -> torch.Tensor:
    """Submanifold conv of flat dense rows with each block halo-padded from
    its shell neighbours: ``out[c] = sum_o halo[c + o] @ weights[o]``,
    zero at unoccupied cells when ``occ`` is given.

    feats (B*edge^3, Cin); block_nbr (26, B) int32; weights (k^3, Cin, Cout)
    in feats' dtype, canonical offset order; occ (B*edge^3,) bool or None;
    rows the card's row list of ``occ`` (``row_list``, ``dilation``), built
    inside the call when not given.  Returns (B*edge^3, Cout) in feats'
    dtype, summed in fp32.  On the card only the rows of ``occ`` are
    computed (every row without it), on the narrow path where
    ``narrow.narrow_path`` of the shape says so (or ``narrow``, where a
    benchmark forces one path).  In bf16 the wide path runs on the
    warpgroup core; where a level's tiles are too few to fill the card it
    cuts each tile's offsets into groups whose fp32 partials a second
    launch adds in order, into a scratch allocated here at the level's
    capacity (``groups``: at most this many, where a test asks).

    ``zero_outside``: the caller states that ``feats`` is zero at every row
    outside ``occ`` (the dense stem's input, straight from
    ``scatter_to_dense``).  Where ``narrow.live_path`` then takes the shape
    (the k5 stem; or ``live``, where a benchmark or test forces a path) the
    conv runs over the live pairs of ``occ``'s row list only (``live_list``,
    ``live_pairs``; built inside the call when not given): each offset's
    pairs in items of 64, their products into a pair-major (k^3 * cap,
    Cout rounded up to the column tile) fp32 scratch allocated here, then
    each row's products added in ascending offset order.  Pairs whose
    source is unoccupied carry exact zeros and are skipped, so the result
    is the conv's.  On the CPU that path's plain version runs."""
    n_off, cin, cout = weights.shape
    _check_layout("block_conv", feats, block_nbr, n_off, edge, cin)
    if torch.compiler.is_exporting():
        from segdino3d_tpu_torch.ops import custom_ops
        return custom_ops.block_conv(feats, block_nbr, weights, occ, edge,
                                     rows)
    k = kernel_size(n_off)
    if zero_outside and occ is None:
        raise ValueError("block_conv: zero_outside needs occ")
    narrow = N.pick(narrow, n_off, cin, cout, feats.dtype, "block_conv") \
        if feats.dtype in (torch.float32, torch.bfloat16) else False
    live = N.pick_live(live, narrow, n_off, cin, cout, feats.dtype,
                       zero_outside, "block_conv")
    if live:
        live_list = _live_list(live_list, rows, occ, block_nbr, edge, k)
        if feats.device.type == "cpu":
            return block_conv_live_plain(feats, weights, live_list)
    if feats.device.type == "cpu":
        return dense_subm_conv_plain(feats, block_nbr, weights, occ, edge)
    _require_cuda("block_conv", feats, block_nbr, weights,
                  *([] if occ is None else [occ]))
    if weights.dtype != feats.dtype or block_nbr.dtype != torch.int32 or (
            occ is not None and occ.dtype != torch.bool):
        raise TypeError("block_conv: weights must match feats' dtype, "
                        "block_nbr must be int32 and occ bool")
    b = block_nbr.shape[1]
    n_rows = b * edge ** 3
    if rows is not None and (occ is None or rows.ws is None
                             or rows.rows.shape[0] != n_rows):
        raise ValueError("block_conv: rows must be the card's row list of "
                         "occ")
    out = (torch.empty if occ is None else torch.zeros)(
        n_rows, cout, dtype=feats.dtype, device=feats.device)
    lib = cuda_build.library("block_conv")
    if live:
        N.count_element_loads(feats, weights)
        dtype = cuda_build.dtype_code(feats.dtype)
        cap = live_list.src.shape[1]
        partial = torch.empty(n_off * cap,
                              lib.block_conv_live_stride(cout, dtype),
                              dtype=torch.float32, device=feats.device)
        cuda_build.check(lib.block_conv_live(
            feats.data_ptr(), weights.data_ptr(), live_list.rows.ws.data_ptr(),
            live_list.ws.data_ptr(), partial.data_ptr(), out.data_ptr(),
            n_rows, cap, k, cin, cout, dtype, cuda_build.stream_ptr(feats)),
            "block_conv_live")
        block_conv.launches += 1
        block_conv.live.launches += 1
        return out
    split_cap, scratch = 1, None
    if feats.dtype == torch.bfloat16 and not narrow:
        split_cap = groups or _split_cap(lib, b, edge, kernel_size(n_off),
                                         cout)
        if split_cap > 1:
            cols = -(-cout // N.wg_bn(cout)) * N.wg_bn(cout)
            scratch = torch.empty(split_cap * n_rows * cols,
                                  dtype=torch.float32, device=feats.device)
    if not narrow:
        N.count_element_loads(feats, weights)
    args = (None if scratch is None else scratch.data_ptr(), split_cap, b,
            edge, kernel_size(n_off), cin, cout,
            cuda_build.dtype_code(feats.dtype), int(narrow),
            cuda_build.stream_ptr(feats))
    if rows is None:
        ws = row_workspace(n_rows, feats.device)
        block_conv.own_lists += 1
        err = lib.block_conv(
            feats.data_ptr(), block_nbr.data_ptr(), weights.data_ptr(),
            None if occ is None else occ.data_ptr(), ws.data_ptr(),
            out.data_ptr(), *args)
    else:
        err = lib.block_conv_rows(
            feats.data_ptr(), block_nbr.data_ptr(), weights.data_ptr(),
            rows.ws.data_ptr(), out.data_ptr(), *args)
    cuda_build.check(err, "block_conv")
    block_conv.launches += 1
    block_conv.narrow.launches += int(narrow)
    return out


# the bf16 conv's offset groups by (blocks, edge, k, Cout): one query of
# the card each shape
_SPLIT_CAPS: Dict[Tuple[int, int, int, int], int] = {}


def _split_cap(lib, b, edge, k, cout):
    key = (b, edge, k, cout)
    if key not in _SPLIT_CAPS:
        _SPLIT_CAPS[key] = cuda_build.check_count(
            lib.block_conv_split_cap(b, edge, k, cout),
            "block_conv_split_cap")
    return _SPLIT_CAPS[key]


block_conv.launches = 0
block_conv.narrow = types.SimpleNamespace(launches=0)   # of them narrow
block_conv.live = types.SimpleNamespace(launches=0)     # of them live-pair
block_conv.own_lists = 0     # calls that built their row list themselves


# ---------------------------------------------------------------------------
# K11: the block conv's weight gradient
# ---------------------------------------------------------------------------

def block_wgrad_plain(feats: torch.Tensor, dy: torch.Tensor,
                      block_nbr: torch.Tensor, occ: torch.Tensor, edge: int,
                      k: int) -> torch.Tensor:
    """Plain version of K11: one fp32 product per offset of the shifted
    halo window and the occupancy-masked ``dy``."""
    cin, cout = feats.shape[1], dy.shape[1]
    b = block_nbr.shape[1]
    x = as_sum_type(feats).reshape(b, edge, edge, edge, cin)
    padded = halo_pad_plain(x, block_nbr, (k - 1) // 2)
    dym = torch.where(occ[:, None], as_sum_type(dy), 0.0)
    dw = x.new_zeros(k ** 3, cin, cout)
    for o, (i, j, m) in enumerate(itertools.product(range(k), repeat=3)):
        window = padded[:, i:i + edge, j:j + edge, m:m + edge, :]
        dw[o] = window.reshape(-1, cin).T @ dym
    return dw


def halo_rows_plain(rows: torch.Tensor, block_nbr: torch.Tensor, edge: int,
                    shift) -> torch.Tensor:
    """The dense row of each row's cell shifted by ``shift`` (3 ints in
    [-edge, edge]), read through the block halo (``bdt::halo_row``): in the
    row's block or one of its 26 shell neighbours, -1 where that block is
    absent."""
    rows = rows.long()
    e3 = edge ** 3
    blk, cell = rows // e3, rows % e3
    q = [cell // (edge * edge) + shift[0], (cell // edge) % edge + shift[1],
         cell % edge + shift[2]]
    d = [(qi >= edge).long() - (qi < 0).long() for qi in q]
    centre = (d[0] == 0) & (d[1] == 0) & (d[2] == 0)
    di = (d[0] + 1) * 9 + (d[1] + 1) * 3 + (d[2] + 1)
    di = torch.where(di > 13, di - 1, di).clamp(max=25)
    src = torch.where(centre, blk, block_nbr.long()[di, blk])
    lx, ly, lz = (qi - dd * edge for qi, dd in zip(q, d))
    out = ((src * edge + lx) * edge + ly) * edge + lz
    return torch.where(src >= 0, out, -1).to(torch.int32)


def block_wgrad_rows_plain(feats: torch.Tensor, dy: torch.Tensor,
                           block_nbr: torch.Tensor, rows: RowList, edge: int,
                           k: int) -> torch.Tensor:
    """K11's reduction as the kernel runs it: per offset, the listed rows'
    ``dy`` against their halo-shifted ``feats`` rows (a zero row where the
    source block is absent), one fp32 product."""
    xf, dyf = as_sum_type(feats), as_sum_type(dy)
    r = rows.rows[:int(rows.count)]
    h = (k - 1) // 2
    dw = xf.new_zeros(k ** 3, feats.shape[1], dy.shape[1])
    for o, s in enumerate(itertools.product(range(-h, h + 1), repeat=3)):
        src = halo_rows_plain(r, block_nbr, edge, s)
        dw[o] = _gather_rows(xf, src).T @ dyf[r.long()]
    return dw


def block_wgrad(feats: torch.Tensor, dy: torch.Tensor,
                block_nbr: torch.Tensor, occ: torch.Tensor, edge: int,
                k: int, rows: Optional[RowList] = None,
                narrow: Optional[bool] = None, zero_outside: bool = False,
                live: Optional[bool] = None,
                live_list: Optional[LivePairs] = None) -> torch.Tensor:
    """``dW[o] = sum over occupied cells c of halo[c + o]^T @ dy[c]`` as
    (k^3, Cin, Cout) fp32.

    feats (B*edge^3, Cin) and dy (B*edge^3, Cout) share one dtype;
    block_nbr (26, B) int32; occ (B*edge^3,) bool; rows its occupied-row
    list (``row_list``), built here when not given.  The kernel reduces
    the listed rows only, on the narrow path where
    ``narrow.narrow_wgrad_path`` of the shape says so (or ``narrow``,
    where a benchmark or test forces one path).  ``zero_outside``: the
    caller states ``feats`` zero outside ``occ``; where
    ``narrow.live_path`` then takes the shape (or ``live`` forces it) the
    kernel reduces the live pairs alone (``live_list``, as ``block_conv``
    takes it), on the CPU that path's plain version."""
    cin, cout = feats.shape[1], dy.shape[1]
    _check_layout("block_wgrad", feats, block_nbr, k ** 3, edge, cin)
    if tuple(dy.shape) != (feats.shape[0], cout) or \
            tuple(occ.shape) != (feats.shape[0],):
        raise ValueError(f"block_wgrad: dy {tuple(dy.shape)}, occ "
                         f"{tuple(occ.shape)}")
    narrow = N.pick(narrow, k ** 3, cin, cout, feats.dtype, "block_wgrad",
                    wgrad=True) \
        if feats.dtype in (torch.float32, torch.bfloat16) else False
    live = N.pick_live(live, narrow, k ** 3, cin, cout, feats.dtype,
                       zero_outside, "block_wgrad", wgrad=True)
    if live:
        live_list = _live_list(live_list, rows, occ, block_nbr, edge, k)
        if feats.device.type == "cpu":
            return block_wgrad_live_plain(feats, dy, live_list)
    if feats.device.type == "cpu":
        return block_wgrad_plain(feats, dy, block_nbr, occ, edge, k)
    _require_cuda("block_wgrad", feats, dy, block_nbr, occ)
    if dy.dtype != feats.dtype or block_nbr.dtype != torch.int32 or \
            occ.dtype != torch.bool:
        raise TypeError("block_wgrad: feats and dy must share a dtype, "
                        "block_nbr must be int32 and occ bool")
    lib = cuda_build.library("block_wgrad")
    if live:
        cap = live_list.src.shape[1]
        splits = wgrad_splits(cap, k ** 3, cin, cout)
        out = torch.empty(k ** 3, cin, cout, dtype=torch.float32,
                          device=feats.device)
        partial = out if splits == 1 else torch.empty(
            splits, k ** 3, cin, cout, dtype=torch.float32,
            device=feats.device)
        N.count_element_loads(feats, dy)
        cuda_build.check(lib.block_wgrad_live(
            feats.data_ptr(), dy.data_ptr(), live_list.ws.data_ptr(),
            partial.data_ptr(), out.data_ptr(), cap, k, cin, cout, splits,
            cuda_build.dtype_code(feats.dtype), cuda_build.stream_ptr(feats)),
            "block_wgrad_live")
        block_wgrad.launches += 1
        block_wgrad.live.launches += 1
        return out
    if rows is None:
        rows = _row_list(occ)
    elif rows.ws is None or rows.rows.shape[0] != occ.shape[0]:
        raise ValueError("block_wgrad: rows must be the card's row list of "
                         "occ")
    b = block_nbr.shape[1]
    splits = wgrad_splits(occ.shape[0], k ** 3, cin, cout)
    out = torch.empty(k ** 3, cin, cout, dtype=torch.float32,
                      device=feats.device)
    partial = out if splits == 1 else torch.empty(
        splits, k ** 3, cin, cout, dtype=torch.float32, device=feats.device)
    if not narrow:
        N.count_element_loads(feats, dy)
    entry = lib.block_wgrad_narrow if narrow else lib.block_wgrad
    cuda_build.check(entry(
        feats.data_ptr(), dy.data_ptr(), block_nbr.data_ptr(),
        rows.ws.data_ptr(), partial.data_ptr(), out.data_ptr(), b, edge, k,
        cin, cout, splits, cuda_build.dtype_code(feats.dtype),
        cuda_build.stream_ptr(feats)),
        "block_wgrad_narrow" if narrow else "block_wgrad")
    block_wgrad.launches += 1
    block_wgrad.narrow.launches += int(narrow)
    return out


block_wgrad.launches = 0
block_wgrad.narrow = types.SimpleNamespace(launches=0)   # of them narrow
block_wgrad.live = types.SimpleNamespace(launches=0)     # of them live-pair


class _DenseSubmConv(torch.autograd.Function):
    """Backward of ``_chunked_conv_bwd`` (JAX): the block-halo adjacency is
    involutive (``nbr_d[i] = j <=> nbr_{-d}[j] = i``), so dX is the same
    conv (K10) of the masked cotangent with offset-flipped, transposed
    weights, computed on the k-dilation of the occupancy (zero outside it,
    as the unmasked conv is there), and dW is K11.  With ``zero_outside``
    (the input zero outside the occupancy) the forward and dW run on the
    live-pair path where its rule takes the shape, sharing one list."""

    @staticmethod
    def forward(ctx, feats, occ, tables, weights, zero_outside):
        ctx.save_for_backward(feats, occ, weights)
        ctx.tables = tables
        ctx.zero_outside = zero_outside = bool(zero_outside) and \
            not torch.compiler.is_exporting()
        n_off, cin, cout = weights.shape
        rows = row_list(tables, occ) if feats.is_cuda else None
        live = live_pairs(tables, occ, kernel_size(n_off)) if N.live_path(
            n_off, cin, cout, feats.dtype, zero_outside) else None
        return block_conv(feats, tables.block_nbr, weights, occ, tables.edge,
                          rows, zero_outside=zero_outside, live_list=live)

    @staticmethod
    def backward(ctx, dout):
        feats, occ, weights = ctx.saved_tensors
        t, k = ctx.tables, kernel_size(weights.shape[0])
        dy = torch.where(occ[:, None], dout, 0.0).to(feats.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            mask, rows = dilation(t, occ, k)
            dx = block_conv(dy, t.block_nbr, _transposed(weights.flip(0)),
                            mask, t.edge, rows if dy.is_cuda else None)
        if ctx.needs_input_grad[3]:
            rows = row_list(t, occ) if feats.is_cuda else None
            live = live_pairs(t, occ, k) if N.live_path(
                k ** 3, feats.shape[1], dy.shape[1], feats.dtype,
                ctx.zero_outside, wgrad=True) else None
            dw = block_wgrad(feats, dy, t.block_nbr, occ, t.edge, k, rows,
                             zero_outside=ctx.zero_outside,
                             live_list=live).to(weights.dtype)
        return dx, None, None, dw, None


def dense_subm_conv(dense_flat: torch.Tensor, occ: torch.Tensor,
                    tables: BlockTables, weights: torch.Tensor,
                    zero_outside: bool = False) -> torch.Tensor:
    """Submanifold conv on flat dense rows (B*edge^3, Cin) with weights
    (k^3, Cin, Cout) in canonical offset order; (B*edge^3, Cout), zero at
    unoccupied cells.  ``zero_outside``: the caller states the input zero
    at every unoccupied cell (``block_conv``)."""
    return _DenseSubmConv.apply(dense_flat, occ, tables, weights,
                                zero_outside)
