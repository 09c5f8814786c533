"""The eval forward's kernels as ``torch.library`` ops, for ``torch.export``.

The wrappers of ``ops.sparse_conv``, ``ops.block_dense`` and
``ops.scatter`` launch their kernels through ctypes on the tensors'
``data_ptr()``, which a tracer cannot follow.  While ``torch.export``
traces the model (``torch.compiler.is_exporting()``), each wrapper instead
calls its function here, which puts one registered op (namespace
``segdino3d``) in the graph.  An eager call never comes here:
it launches directly, with no dispatcher in the way.

Each op has three implementations:

* CUDA: the wrapper itself, which launches the hand-written kernel (and
  counts the launch) as in an eager forward;
* CPU: the wrapper's plain PyTorch version;
* fake: the output's shape and dtype, from the static capacities of the
  inputs alone.

The pair lists (K4's ``gather_pairs``, which K1 and K2 read), K10's row
lists (``block_rows``) and K10's live-pair lists (``block_live_pairs``) are
ops of their own whose outputs, the kernels' int32 workspaces, feed the
convs: the tracer meets each table once per forward through
``sparse_conv.cached_pairs``, ``block_dense.row_list`` and
``block_dense.live_pairs``, so the graph builds each list once, as an
eager forward does, and each K10 node takes the path the eager forward
takes (``narrow.live_path``).  On the
card those workspaces hold unspecified entries past the lists, which no
reader touches.  Split
counts that depend on the card (K10's bf16 offset groups) are taken on
plain ints while tracing and stored in the graph.

``segdino3d_tpu_torch.tools.export_serving`` writes the artifact; a
serving process imports this module (which registers the ops) before
``torch.export.load``.
"""
from typing import List, Optional, Tuple

import torch
from torch import Tensor
from torch.library import custom_op

from segdino3d_tpu_torch.ops import block_dense as BD
from segdino3d_tpu_torch.ops import cuda_build
from segdino3d_tpu_torch.ops import narrow as N
from segdino3d_tpu_torch.ops import scatter as SS
from segdino3d_tpu_torch.ops import sparse_conv as SC


def _on_card(t: Tensor) -> bool:
    return t.device.type == "cuda"


# ---------------------------------------------------------------------------
# K4's pair lists (read by K1 and K2)
# ---------------------------------------------------------------------------

@custom_op("segdino3d::gather_pairs", mutates_args=(), device_types="cpu")
def gather_pairs_op(ia: Optional[Tensor], ib: Optional[Tensor]) -> Tensor:
    pairs = SC.gather_pairs_plain(ia, ib)
    n_off, rows = pairs.rows.shape
    ws = torch.zeros(SC.pair_workspace_size(n_off, rows), dtype=torch.int32,
                     device=pairs.rows.device)
    view = SC.pairs_in(ws, n_off, rows)
    for got, want in zip(view[:2] + view[3:], pairs[:2] + pairs[3:]):
        got.copy_(want)
    return ws


@gather_pairs_op.register_kernel("cuda")
def _(ia, ib):
    return SC.gather_pairs(ia, ib).ws


@gather_pairs_op.register_fake
def _(ia, ib):
    t = ia if ia is not None else ib
    return t.new_empty(SC.pair_workspace_size(*t.shape), dtype=torch.int32)


def gather_pairs(ia: Optional[Tensor], ib: Optional[Tensor]) -> SC.PairList:
    t = ia if ia is not None else ib
    return SC.pairs_in(gather_pairs_op(ia, ib), *t.shape)


# ---------------------------------------------------------------------------
# K1 and K2
# ---------------------------------------------------------------------------

@custom_op("segdino3d::gather_conv", mutates_args=(), device_types="cpu")
def gather_conv_op(feats: Tensor, nbr: Tensor, weights: Tensor,
                   valid: Tensor, pairs: Optional[Tensor]) -> Tensor:
    return SC.gather_conv_plain(feats, nbr, weights, valid)


@gather_conv_op.register_kernel("cuda")
def _(feats, nbr, weights, valid, pairs):
    return SC.gather_conv(feats, nbr, weights, valid, pairs=None
                          if pairs is None else SC.pairs_in(pairs, *nbr.shape))


@gather_conv_op.register_fake
def _(feats, nbr, weights, valid, pairs):
    return feats.new_empty(nbr.shape[1], weights.shape[2])


def gather_conv(feats: Tensor, nbr: Tensor, weights: Tensor,
                valid: Tensor) -> Tensor:
    """K1's node; on the card its wide path reads the table's pair list."""
    n_off, cin, cout = weights.shape
    wide = _on_card(feats) and not N.narrow_path(n_off, cin, cout,
                                                  feats.dtype)
    pairs = SC.cached_pairs(None, nbr).ws if wide else None
    return gather_conv_op(feats, nbr, weights, valid, pairs)


@custom_op("segdino3d::up_conv", mutates_args=(), device_types="cpu")
def up_conv_op(feats: Tensor, child: Tensor, parent: Tensor, kpos: Tensor,
               weights: Tensor, valid: Tensor, pairs: Optional[Tensor]
               ) -> Tensor:
    return SC.up_conv_plain(feats, parent, kpos, weights, valid)


@up_conv_op.register_kernel("cuda")
def _(feats, child, parent, kpos, weights, valid, pairs):
    return SC.up_conv_rows(feats, child, parent, kpos, weights, valid,
                           pairs=None if pairs is None
                           else SC.pairs_in(pairs, *child.shape))


@up_conv_op.register_fake
def _(feats, child, parent, kpos, weights, valid, pairs):
    return feats.new_empty(parent.shape[0], weights.shape[2])


def up_conv_rows(feats: Tensor, child: Tensor, parent: Tensor, kpos: Tensor,
                 weights: Tensor, valid: Tensor) -> Tensor:
    """K2's node over the child table's pair list (K1's down conv's)."""
    pairs = SC.cached_pairs(None, child).ws if _on_card(feats) else None
    return up_conv_op(feats, child, parent, kpos, weights, valid, pairs)


# ---------------------------------------------------------------------------
# K9, K10 and its row lists
# ---------------------------------------------------------------------------

@custom_op("segdino3d::slot_gather", mutates_args=(), device_types="cpu")
def slot_gather(x: Tensor, idx: Tensor) -> Tensor:
    return BD.slot_gather_plain(x, idx)


@slot_gather.register_kernel("cuda")
def _(x, idx):
    return BD.slot_gather(x, idx)


@slot_gather.register_fake
def _(x, idx):
    return x.new_empty(idx.shape[0], x.shape[1])


@custom_op("segdino3d::block_rows", mutates_args=(), device_types="cpu")
def block_rows_op(mask: Tensor) -> Tensor:
    rows, count = BD.occupied_rows_plain(mask)
    ws = BD.row_workspace(mask.shape[0], mask.device).zero_()
    ws[:mask.shape[0]] = rows
    ws[mask.shape[0]] = count
    return ws


@block_rows_op.register_kernel("cuda")
def _(mask):
    return BD._row_list(mask).ws


@block_rows_op.register_fake
def _(mask):
    return mask.new_empty(BD.row_workspace_size(mask.shape[0]),
                          dtype=torch.int32)


def block_rows(mask: Tensor) -> BD.RowList:
    return BD.rows_in(block_rows_op(mask), mask.shape[0])


@custom_op("segdino3d::block_live_pairs", mutates_args=(),
           device_types="cpu")
def block_live_pairs_op(rows: Tensor, occ: Tensor, block_nbr: Tensor,
                        edge: int, k: int, cap: int, row_cap: int) -> Tensor:
    lp = BD.live_pairs_plain(BD.rows_in(rows, occ.shape[0]), occ, block_nbr,
                             edge, k, cap, row_cap)
    n_off = k ** 3
    ws = torch.zeros(BD.live_workspace_size(n_off, cap, row_cap),
                     dtype=torch.int32, device=occ.device)
    view = BD.live_in(ws, n_off, cap, row_cap, lp.rows)
    for mine, plain in zip(view[:4], lp[:4]):
        mine.copy_(plain)
    return ws


@block_live_pairs_op.register_kernel("cuda")
def _(rows, occ, block_nbr, edge, k, cap, row_cap):
    return BD.live_pair_list(BD.rows_in(rows, occ.shape[0]), occ, block_nbr,
                             edge, k, cap, row_cap).ws


@block_live_pairs_op.register_fake
def _(rows, occ, block_nbr, edge, k, cap, row_cap):
    return occ.new_empty(BD.live_workspace_size(k ** 3, cap, row_cap),
                         dtype=torch.int32)


def live_pair_list(rows: BD.RowList, occ: Tensor, block_nbr: Tensor,
                   edge: int, k: int, cap: int, row_cap: int) -> BD.LivePairs:
    return BD.live_in(block_live_pairs_op(rows.ws, occ, block_nbr, edge, k,
                                          cap, row_cap),
                      k ** 3, cap, row_cap, rows)


def _live(live: Optional[Tensor], n_off: int, cap: int, row_cap: int,
          rows: Optional[Tensor], n_rows: int) -> Optional[BD.LivePairs]:
    if live is None:
        return None
    return BD.live_in(live, n_off, cap, row_cap, BD.rows_in(rows, n_rows))


@custom_op("segdino3d::block_conv", mutates_args=(), device_types="cpu")
def block_conv_op(feats: Tensor, block_nbr: Tensor, weights: Tensor,
                  occ: Optional[Tensor], edge: int, rows: Optional[Tensor],
                  groups: int, live: Optional[Tensor], cap: int,
                  row_cap: int) -> Tensor:
    lp = _live(live, weights.shape[0], cap, row_cap, rows, feats.shape[0])
    if lp is not None:
        return BD.block_conv_live_plain(feats, weights, lp)
    return BD.dense_subm_conv_plain(feats, block_nbr, weights, occ, edge)


@block_conv_op.register_kernel("cuda")
def _(feats, block_nbr, weights, occ, edge, rows, groups, live, cap,
      row_cap):
    lp = _live(live, weights.shape[0], cap, row_cap, rows, feats.shape[0])
    return BD.block_conv(feats, block_nbr, weights, occ, edge,
                         None if rows is None else BD.rows_in(
                             rows, feats.shape[0]), groups=groups or None,
                         zero_outside=lp is not None, live=lp is not None,
                         live_list=lp)


@block_conv_op.register_fake
def _(feats, block_nbr, weights, occ, edge, rows, groups, live, cap,
      row_cap):
    return feats.new_empty(feats.shape[0], weights.shape[2])


def block_conv(feats: Tensor, block_nbr: Tensor, weights: Tensor,
               occ: Optional[Tensor], edge: int,
               rows: Optional[BD.RowList],
               live_list: Optional[BD.LivePairs] = None) -> Tensor:
    """K10's node, on the live-pair path over ``live_list`` where given;
    on the card the bf16 wide path's offset groups are queried here, on
    the shape's ints, and stored in the graph."""
    n_off, cin, cout = weights.shape
    groups = 0
    if live_list is None and _on_card(feats) and \
            feats.dtype == torch.bfloat16 and \
            not N.narrow_path(n_off, cin, cout, feats.dtype):
        groups = BD._split_cap(cuda_build.library("block_conv"),
                               block_nbr.shape[1], edge,
                               BD.kernel_size(n_off), cout)
    if live_list is None:
        live, cap, row_cap = None, 0, 0
    else:
        live, (cap, row_cap) = live_list.ws, (live_list.src.shape[1],
                                              live_list.map.shape[1])
        rows = live_list.rows
    return block_conv_op(feats, block_nbr, weights, occ, edge,
                         None if rows is None else rows.ws, groups, live, cap,
                         row_cap)


# ---------------------------------------------------------------------------
# K3 and the segments' CSR
# ---------------------------------------------------------------------------

@custom_op("segdino3d::segment_csr", mutates_args=(), device_types="cpu")
def segment_csr_op(seg_ids: Tensor, num_segments: int, valid: Optional[Tensor]
                   ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    return tuple(SS.segment_csr_plain(seg_ids, num_segments, valid))


@segment_csr_op.register_kernel("cuda")
def _(seg_ids, num_segments, valid):
    return tuple(SS.segment_csr(seg_ids, num_segments, valid))


@segment_csr_op.register_fake
def _(seg_ids, num_segments, valid):
    n = seg_ids.shape[0]
    return (seg_ids.new_empty(num_segments + 1, dtype=torch.int64),
            seg_ids.new_empty(n, dtype=torch.int64),
            seg_ids.new_empty(n, dtype=torch.int32),
            seg_ids.new_empty(num_segments, dtype=torch.int32))


def segment_csr(seg_ids: Tensor, num_segments: int,
                valid: Optional[Tensor]) -> SS.SegmentCSR:
    return SS.SegmentCSR(*segment_csr_op(seg_ids, num_segments, valid))


@custom_op("segdino3d::segment_mean_gather", mutates_args=(),
           device_types="cpu")
def segment_mean_gather_op(seg_ids: Tensor, num_segments: int,
                           valid: Optional[Tensor], g: Optional[Tensor],
                           gather_idx: Optional[Tensor], d: List[Tensor],
                           csr: List[Tensor], round_to: Optional[torch.dtype]
                           ) -> Tensor:
    return SS.segment_mean_gather_plain(seg_ids, num_segments, valid, g,
                                        gather_idx, d, round_to)


@segment_mean_gather_op.register_kernel("cuda")
def _(seg_ids, num_segments, valid, g, gather_idx, d, csr, round_to):
    return SS.segment_mean_gather(seg_ids, num_segments, valid, g, gather_idx,
                                  d, SS.SegmentCSR(*csr), round_to)


@segment_mean_gather_op.register_fake
def _(seg_ids, num_segments, valid, g, gather_idx, d, csr, round_to):
    ref = g if g is not None else d[0]
    cols = sum(x.shape[1] for x in ([] if g is None else [g]) + list(d))
    return ref.new_empty(num_segments, cols, dtype=torch.float32)


def segment_mean_gather(seg_ids: Tensor, num_segments: int,
                        valid: Optional[Tensor], g: Optional[Tensor],
                        gather_idx: Optional[Tensor], d: List[Tensor],
                        csr: Optional[SS.SegmentCSR],
                        round_to: Optional[torch.dtype]) -> Tensor:
    """K3's node, which reads its column sources where they lie (views
    included), on the segments' CSR (built here when not given)."""
    if csr is None:
        csr = SS.segment_csr(seg_ids, num_segments, valid)
    return segment_mean_gather_op(seg_ids, num_segments, valid, g,
                                  gather_idx, d, list(csr), round_to)


# every registered op, for the tests' ``torch.library.opcheck``
OPS = (gather_pairs_op, gather_conv_op, up_conv_op, slot_gather,
       block_rows_op, block_live_pairs_op, block_conv_op, segment_csr_op,
       segment_mean_gather_op)
