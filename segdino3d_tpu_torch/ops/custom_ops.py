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

The pair lists (K4's ``gather_pairs``, which K1 and K2 read) and K10's row
lists (``block_rows``) are ops of their own whose outputs, the kernels'
int32 workspaces, feed the convs: the tracer meets each table once per
forward through ``sparse_conv.cached_pairs`` and ``block_dense.row_list``,
so the graph builds each list once, as an eager forward does.  On the
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
    ws[:n_off * rows] = pairs.rows.reshape(-1)
    ws[n_off * rows:n_off * rows + n_off] = pairs.counts
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


@custom_op("segdino3d::block_conv", mutates_args=(), device_types="cpu")
def block_conv_op(feats: Tensor, block_nbr: Tensor, weights: Tensor,
                  occ: Optional[Tensor], edge: int, rows: Optional[Tensor],
                  groups: int) -> Tensor:
    return BD.dense_subm_conv_plain(feats, block_nbr, weights, occ, edge)


@block_conv_op.register_kernel("cuda")
def _(feats, block_nbr, weights, occ, edge, rows, groups):
    return BD.block_conv(feats, block_nbr, weights, occ, edge,
                         None if rows is None else BD.rows_in(
                             rows, feats.shape[0]), groups=groups or None)


@block_conv_op.register_fake
def _(feats, block_nbr, weights, occ, edge, rows, groups):
    return feats.new_empty(feats.shape[0], weights.shape[2])


def block_conv(feats: Tensor, block_nbr: Tensor, weights: Tensor,
               occ: Optional[Tensor], edge: int,
               rows: Optional[BD.RowList]) -> Tensor:
    """K10's node; on the card the bf16 wide path's offset groups are
    queried here, on the shape's ints, and stored in the graph."""
    n_off, cin, cout = weights.shape
    groups = 0
    if _on_card(feats) and feats.dtype == torch.bfloat16 \
            and not N.narrow_path(n_off, cin, cout, feats.dtype):
        groups = BD._split_cap(cuda_build.library("block_conv"),
                               block_nbr.shape[1], edge,
                               BD.kernel_size(n_off), cout)
    return block_conv_op(feats, block_nbr, weights, occ, edge,
                         None if rows is None else rows.ws, groups)


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
       block_rows_op, block_conv_op, segment_csr_op, segment_mean_gather_op)
