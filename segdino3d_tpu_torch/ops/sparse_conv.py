"""Sparse 3D convolutions over host-built index tables (gather layout).

Counterpart of ``segdino3d_tpu/ops/sparse_conv.py``.  Every convolution of
the Res16UNet34C in the gather layout, forward and backward, runs in
hand-written CUDA kernels:

* ``gather_conv`` (K1, ``csrc/gather_gemm_conv.cu``):
  ``out[i] = sum_o x[nbr[o, i]] @ W[o]`` for any offset count.  It runs the
  submanifold convs (27 offsets), the k5 stem (125 offsets) and the stride-2
  down convs, whose (8, V_coarse) child table ``child[kpos, parent] = fine``
  (``ops.host_plan``) turns the TPU version's scatter into a gather.  It
  multiplies each offset's live pairs only, from K4's pair list below; for
  a few input channels (the Baseline's rgb stem, ``narrow.narrow_path``)
  its narrow path instead runs im2col tiles over the table itself;
* ``up_conv_rows`` (K2, ``csrc/up_conv.cu``):
  ``fine[i] = x[parent[i]] @ W[kpos[i]]``, on K1's tile core over the
  child table's pair list, each product stored in its fine row;
* ``gather_wgrad`` (K4, ``csrc/gather_wgrad.cu``): the weight gradients,
  ``dW[o] = sum_r A[ia[o, r]]^T @ B[ib[o, r]]``, reduced over each
  offset's live pairs only: ``gather_pairs`` (two launches in the same
  library) lists them once per index table and step (``cached_pairs``);
  at a few input channels (the Baseline's rgb stem,
  ``narrow.narrow_wgrad_path``) its narrow path instead runs im2col tiles
  over every row of the table, with no list;
* ``stem_slot_sum`` (K12, ``csrc/stem_slot_sum.cu``): the slot sum of the
  degree-compacted k5 stem, ``stem_compact_conv`` (inference only), after
  one wide ``torch.matmul``.

``subm_conv``, ``down_conv`` and ``up_conv`` are ``torch.autograd.Function``s
whose backward reuses K1 and K2 for the input gradients (the submanifold
mirror identity of ``_subm_conv_bwd``; the down conv's transpose is an up
conv and the up conv's a down conv over the child table) and K4 for the
weight gradients.

Each wrapper launches its kernel for a CUDA tensor and counts the launch in
its ``launches`` attribute; for a CPU tensor it runs the plain PyTorch
version beside it (``*_plain``), which the CPU tests hold against the JAX
package and ``chip_smoke.py`` holds the kernel against on the card.
Kernel offsets follow the canonical ``itertools.product`` order.
While ``torch.export`` traces a model, ``gather_conv``, ``up_conv_rows``
and ``gather_pairs`` put their kernels in the graph as ``ops.custom_ops``'
registered ops instead.

The coordinate pyramid of the on-device plan engine lives here too, as in
the JAX module: ``downsample`` (K6 + K8 over the 2x-coarsened keys),
``build_conv_plan`` and ``neighbor_tables`` (K7, ``csrc/neighbor_table.cu``:
every table of a plan in one launch; ``neighbor_table`` for one), with the
port's ``child_table`` and ``up_order`` in torch.
"""
from __future__ import annotations

import ctypes
import functools
import itertools
import types
import weakref
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from segdino3d_tpu_torch.ops import cuda_build
from segdino3d_tpu_torch.ops import keys as K
from segdino3d_tpu_torch.ops import narrow as N
from segdino3d_tpu_torch.ops.hashing import CoordHash, build_and_lookup
from segdino3d_tpu_torch.ops.voxelize import VoxelGrid, voxel_compact


def kernel_offsets(kernel_size: int) -> np.ndarray:
    """Centered cube offsets for odd k (submanifold), corner-anchored for
    even k (strided), shape (k^3, 3), canonical (x, y, z) product order."""
    if kernel_size % 2 == 1:
        r = range(-(kernel_size // 2), kernel_size // 2 + 1)
    else:
        r = range(kernel_size)
    return np.array(list(itertools.product(r, r, r)), dtype=np.int32)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``x`` at ``idx``; -1 gives a zero row (a negative index would
    wrap in torch)."""
    padded = torch.cat([x, x.new_zeros(1, x.shape[1])])
    return padded[torch.where(idx < 0, x.shape[0], idx).long()]


def as_sum_type(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the plain versions' sum type: fp32, or fp64 for an fp64
    input (the CPU gradient checks)."""
    return t if t.dtype == torch.float64 else t.float()


def _require_cuda(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on one CUDA "
                             f"device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def gather_conv_plain(feats: torch.Tensor, nbr: torch.Tensor,
                      weights: torch.Tensor, valid: torch.Tensor
                      ) -> torch.Tensor:
    """Plain version of K1: fp32 sums over offsets in ascending order."""
    wf, xf = as_sum_type(weights), as_sum_type(feats)
    acc = xf.new_zeros(nbr.shape[1], weights.shape[2])
    for o in range(nbr.shape[0]):
        acc += _gather_rows(xf, nbr[o]) @ wf[o]
    return torch.where(valid[:, None], acc, 0.0).to(feats.dtype)


def _pack(sizes: Sequence[int], most: int) -> List[Tuple[int, int]]:
    """Consecutive offsets packed greedily into chunks of at most ``most``
    bytes, an offset that alone outgrows it in a chunk of its own."""
    chunks, begin, total = [], 0, 0
    for o, size in enumerate(sizes):
        if o > begin and total + size > most:
            chunks.append((begin, o))
            begin, total = o, 0
        total += size
    chunks.append((begin, len(sizes)))
    return chunks


@functools.lru_cache(maxsize=1024)
def _even_chunks(sizes: Tuple[int, ...], budget: int
                 ) -> Tuple[Tuple[int, int], ...]:
    """The fewest consecutive chunks of offsets of ``sizes`` bytes each
    within ``budget`` (``_pack``), cut with the least largest chunk: the
    smallest bound that packs into as few chunks, by bisection."""
    fewest = len(_pack(sizes, budget))
    lo, hi = min(-(-sum(sizes) // fewest), budget), budget
    while lo < hi:
        mid = (lo + hi) // 2
        if len(_pack(sizes, mid)) <= fewest:
            hi = mid
        else:
            lo = mid + 1
    return tuple(_pack(sizes, lo))


def offset_chunks(n_off: int, cap: int, stride: int,
                  counts: Optional[Sequence[int]] = None, map_rows: int = 0
                  ) -> List[Tuple[int, int]]:
    """The consecutive chunks ``[(o_begin, o_end), ...]`` in which K1 and
    K10 run the offsets of a pair-major conv: ``n_off`` offsets of at most
    ``cap`` pairs each, ``stride`` fp32 columns a pair, within the budget
    (``host_plan.l0_dense_budget_bytes()``: ``SEGDINO_CONV_CHUNK_MB``,
    read at each call).  Offset o's scratch is ``cap`` pairs' products,
    or with ``counts`` (each offset's live pairs, on the host) its
    ``counts[o]`` pairs' products and a ``map_rows`` entry index map (K1's
    (offsets, V) map; K10 reads its list's).  One chunk where every
    offset's scratch fits the budget; else as few chunks as fit it, a
    single offset a chunk where one offset alone outgrows it, cut with the
    least largest chunk (with every count at ``cap`` and no map: chunks of
    an even number of offsets, the last one shorter)."""
    from segdino3d_tpu_torch.ops.host_plan import l0_dense_budget_bytes

    sizes = (cap * stride * 4,) * n_off if counts is None else tuple(
        int(c) * stride * 4 + map_rows * 4 for c in counts)
    if len(sizes) != n_off:
        raise ValueError(f"offset_chunks: {len(sizes)} counts for {n_off} "
                         "offsets")
    return list(_even_chunks(sizes, l0_dense_budget_bytes()))


# K1 and K10 size their pair-major chunks by the list's live pairs where
# the cap-sized chunks (``offset_chunks`` without counts) would number at
# least this many: the counts are read to the host then, one sync a list.
# At the default budget the batch-1 convs past it (the stems, 1.47 GB, and
# L0's dX 96->128, 1.27 GB) run in two cap-sized chunks, whose second cost
# 0.05 ms (the stem's 2.2206 against 2.1686 ms in one, ``conv_bench
# --chunks``, PERF.md section 5): they keep them and add no host sync to a
# batch-1 forward or step.
COUNT_READ_MIN_CHUNKS = 3

# id(counts) -> (a weak reference to it, its values): the per-offset counts
# of a pair list (K1's ``PairList``, K10's ``LivePairs``) read to the host
# once per list while it lives (a list's counts are never written again)
_HOST_COUNTS: Dict[int, Tuple[weakref.ref, Tuple[int, ...]]] = {}


def host_counts(counts: torch.Tensor, counter) -> Tuple[int, ...]:
    """A list's per-offset pair counts on the host: read from the card (one
    host sync, counted in ``counter.launches``) the first time they are
    asked for, then kept with the list."""
    key = id(counts)
    hit = _HOST_COUNTS.get(key)
    if hit is not None and hit[0]() is counts:
        return hit[1]
    values = tuple(counts.tolist())
    counter.launches += 1
    _HOST_COUNTS[key] = (weakref.ref(
        counts, lambda _, key=key: _HOST_COUNTS.pop(key, None)), values)
    return values


def pair_major_chunks(n_off: int, cap: int, stride: int,
                      counts: torch.Tensor, counter, map_rows: int = 0
                      ) -> Tuple[List[Tuple[int, int]], int]:
    """(the offset chunks of a pair-major call, the pairs of its largest
    chunk: the rows of its products' scratch).  The cap-sized chunks, or
    where they would number ``COUNT_READ_MIN_CHUNKS`` or more, chunks sized
    by the list's live pairs (``counts``, the card's per-offset counts,
    read once per list by ``host_counts`` into ``counter``)."""
    chunks = offset_chunks(n_off, cap, stride)
    if len(chunks) < COUNT_READ_MIN_CHUNKS:
        return chunks, max(o1 - o0 for o0, o1 in chunks) * cap
    live = host_counts(counts, counter)
    chunks = offset_chunks(n_off, cap, stride, live, map_rows)
    return chunks, max(sum(live[o0:o1]) for o0, o1 in chunks)


def gather_conv(feats: torch.Tensor, nbr: torch.Tensor, weights: torch.Tensor,
                valid: torch.Tensor, narrow: Optional[bool] = None,
                pairs: Optional["PairList"] = None, dx: bool = False,
                form: Optional[str] = None) -> torch.Tensor:
    """``out[i] = sum_o feats[nbr[o, i]] @ weights[o]``, 0 on invalid rows.

    feats (V_in, Cin); nbr (n_off, V) int32, -1 = absent; weights
    (n_off, Cin, Cout) in feats' dtype; valid (V,) bool.  Returns (V, Cout)
    in feats' dtype, summed in fp32.  On the card the kernel's wide path
    multiplies each offset's live pairs (``cached_pairs``, the weight
    gradient's list, or ``pairs`` where the caller has it: an exported
    graph's) in one of two forms, ``narrow.gather_form`` of the conv, its
    role (``dx``: a k3 conv's input gradient) and the table's rows V (or
    ``form``, which benchmarks and tests force):

    * ``narrow.PAIR_MAJOR``: the products into a pair-major fp32 scratch
      (at most n_off * V rows, Cout rounded up to its column tile), then
      each row adds its products in ascending offset order.  Where the scratch would outgrow the
      ``SEGDINO_CONV_CHUNK_MB`` budget (``pair_major_chunks``) the offsets
      run in consecutive chunks, sized by the list's live pairs where the
      cap-sized ones would be many, each into a scratch of its own live
      pairs, adding onto an fp32 carry of the rows' sums in ascending
      offset order: bit-equal to one chunk.  The bf16 wide stems
      (``narrow.wide_stem``) run it on the warpgroup core;
    * ``narrow.ROW_GROUPS``: one launch over groups of consecutive rows
      (``narrow.GROUP_ROWS``), each offset's products of a group's pairs
      added into the group's fp32 accumulator in ascending offset order;
      it allocates only the output (so runs no offset chunks under any
      budget) and in fp32 equals the pair-major form bit for bit.

    The narrow path (``narrow.narrow_path`` of the shape, or ``narrow``
    where a benchmark forces one path) is one launch that allocates nothing
    but the output and builds no pair list."""
    n_off, cin, cout = weights.shape
    if nbr.shape[0] != n_off or feats.shape[1] != cin \
            or tuple(valid.shape) != (nbr.shape[1],):
        raise ValueError(f"gather_conv: nbr {tuple(nbr.shape)}, feats "
                         f"{tuple(feats.shape)}, weights {tuple(weights.shape)}"
                         f", valid {tuple(valid.shape)}")
    if form is not None and form not in N.LIVE_FORMS:
        raise ValueError(f"gather_conv: form {form} is not one of "
                         f"{N.LIVE_FORMS}")
    if torch.compiler.is_exporting():
        from segdino3d_tpu_torch.ops import custom_ops
        return custom_ops.gather_conv(feats, nbr, weights, valid)
    if feats.device.type == "cpu":
        return gather_conv_plain(feats, nbr, weights, valid)
    _require_cuda("gather_conv", feats, nbr, weights, valid)
    if weights.dtype != feats.dtype or nbr.dtype != torch.int32 \
            or valid.dtype != torch.bool:
        raise TypeError("gather_conv: weights must match feats' dtype, nbr "
                        "must be int32 and valid bool")
    v, dev = nbr.shape[1], feats.device
    narrow = N.pick(narrow, n_off, cin, cout, feats.dtype, "gather_conv")
    if narrow and form is not None:
        raise ValueError("gather_conv: a form is the wide path's")
    out = torch.empty(v, cout, dtype=feats.dtype, device=dev)
    if out.numel() == 0:
        return out
    lib = cuda_build.library("gather_gemm_conv")
    if narrow:
        cuda_build.check(lib.gather_conv_narrow(
            feats.data_ptr(), nbr.data_ptr(), weights.data_ptr(),
            valid.data_ptr(), out.data_ptr(), v, cin, cout, n_off,
            cuda_build.dtype_code(feats.dtype), cuda_build.stream_ptr(feats)),
            "gather_conv_narrow")
        gather_conv.launches += 1
        gather_conv.narrow.launches += 1
        return out
    N.count_element_loads(feats, weights)
    wide = N.wide_stem(cin, cout, feats.dtype)
    pairs = pairs if pairs is not None else cached_pairs(None, nbr)
    form = form or N.gather_form(n_off, cin, cout, feats.dtype, cap=v, dx=dx)
    gather_conv.launches += 1
    gather_conv.wide_stem.launches += int(wide)
    if form == N.ROW_GROUPS:
        cuda_build.check(lib.gather_conv_rows(
            feats.data_ptr(), nbr.data_ptr(), weights.data_ptr(),
            valid.data_ptr(), pairs.ws.data_ptr(), out.data_ptr(), v, cin,
            cout, n_off, cuda_build.dtype_code(feats.dtype),
            cuda_build.stream_ptr(feats)), "gather_conv_rows")
        gather_conv.row_groups.launches += 1
        return out
    stride = lib.gather_conv_pair_stride(cout)
    chunks, rows = pair_major_chunks(n_off, v, stride, pairs.counts,
                                     gather_conv.count_reads, map_rows=v)
    most = max(o1 - o0 for o0, o1 in chunks)
    pos = torch.empty(most, v, dtype=torch.int32, device=dev)
    partial = torch.empty(rows, stride, dtype=torch.float32, device=dev)
    carry = None if len(chunks) == 1 else torch.zeros(
        v, stride, dtype=torch.float32, device=dev)
    ptrs = (pairs.ws.data_ptr(), pos.data_ptr(), partial.data_ptr(),
            None if carry is None else carry.data_ptr(), out.data_ptr())
    args = (feats.data_ptr(), nbr.data_ptr(), weights.data_ptr(),
            valid.data_ptr(), *ptrs, v, cin, cout, n_off)
    for o0, o1 in chunks:
        if wide:
            cuda_build.check(lib.gather_conv_wg(
                *args, o0, o1, cuda_build.stream_ptr(feats)),
                "gather_conv_wg")
        else:
            cuda_build.check(lib.gather_gemm_conv(
                *args, o0, o1, cuda_build.dtype_code(feats.dtype),
                cuda_build.stream_ptr(feats)), "gather_gemm_conv")
    gather_conv.chunks.launches += len(chunks)
    return out


gather_conv.launches = 0
gather_conv.narrow = types.SimpleNamespace(launches=0)   # of them narrow
# of them at a bf16 wide stem's shape (either form)
gather_conv.wide_stem = types.SimpleNamespace(launches=0)
# the offset chunks of the pair-major form's calls (one a call within the
# budget)
gather_conv.chunks = types.SimpleNamespace(launches=0)
# the pair lists whose per-offset counts its calls read to the host to size
# their chunks (``pair_major_chunks``: one host sync a list)
gather_conv.count_reads = types.SimpleNamespace(launches=0)
# of the wide path's calls, those in the row-group form (one launch each)
gather_conv.row_groups = types.SimpleNamespace(launches=0)


def up_conv_plain(feats: torch.Tensor, parent: torch.Tensor,
                  kpos: torch.Tensor, weights: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: each fine row times its own slot's weight."""
    live = valid & (parent >= 0)
    g = _gather_rows(as_sum_type(feats), torch.where(live, parent, -1))
    out = g.new_zeros(g.shape[0], weights.shape[2])
    for o in range(8):
        sel = (live & (kpos == o))[:, None]
        out += torch.where(sel, g @ as_sum_type(weights[o]), 0.0)
    return out.to(feats.dtype)


def up_conv_rows(feats: torch.Tensor, child: torch.Tensor,
                 parent: torch.Tensor, kpos: torch.Tensor,
                 weights: torch.Tensor, valid: torch.Tensor,
                 pairs: Optional["PairList"] = None) -> torch.Tensor:
    """``fine[i] = feats[parent[i]] @ weights[kpos[i]]``, 0 where invalid
    or without a parent.

    feats (V_coarse, Cin); child (8, V_coarse) int32, the fine level's
    child table, which holds each fine row with ``valid & (parent >= 0)``
    once; parent, kpos (V_fine,) int32; weights (8, Cin, Cout) in feats'
    dtype; valid (V_fine,) bool.  On the card the kernel multiplies the
    child table's cached pair list (``cached_pairs(None, child)``, shared
    with K1's down conv and K4, or ``pairs`` where the caller has it) and
    stores each product in its fine row."""
    cin, cout = weights.shape[1:]
    if weights.shape[0] != 8 or feats.shape[1] != cin \
            or tuple(child.shape) != (8, feats.shape[0]) \
            or parent.shape != valid.shape:
        raise ValueError(f"up_conv: feats {tuple(feats.shape)}, child "
                         f"{tuple(child.shape)}, weights "
                         f"{tuple(weights.shape)}, parent "
                         f"{tuple(parent.shape)}, valid {tuple(valid.shape)}")
    if torch.compiler.is_exporting():
        from segdino3d_tpu_torch.ops import custom_ops
        return custom_ops.up_conv_rows(feats, child, parent, kpos, weights,
                                       valid)
    if feats.device.type == "cpu":
        return up_conv_plain(feats, parent, kpos, weights, valid)
    _require_cuda("up_conv", feats, child, parent, weights, valid)
    if weights.dtype != feats.dtype or valid.dtype != torch.bool or any(
            t.dtype != torch.int32 for t in (child, parent)):
        raise TypeError("up_conv: weights must match feats' dtype, index "
                        "tables must be int32 and valid bool")
    v = parent.shape[0]
    out = torch.empty(v, cout, dtype=feats.dtype, device=feats.device)
    if out.numel() == 0:
        return out
    pairs = pairs if pairs is not None else cached_pairs(None, child)
    N.count_element_loads(feats, weights)
    lib = cuda_build.library("up_conv")
    cuda_build.check(lib.up_conv(
        feats.data_ptr(), child.data_ptr(), weights.data_ptr(),
        pairs.ws.data_ptr(), parent.data_ptr(), valid.data_ptr(),
        out.data_ptr(), child.shape[1], v, cin, cout,
        cuda_build.dtype_code(feats.dtype), cuda_build.stream_ptr(feats)),
        "up_conv")
    up_conv_rows.launches += 1
    return out


up_conv_rows.launches = 0


# the weight gradient's split scratch holds at most this many bytes; a
# split reduces at least this many pairs (wgrad_tile.cuh: kMinPairs).  The
# k5 stem's 4.1 MB splits fit 62 of its 75 1,024-pair splits, short enough
# work items to balance the SMs
WGRAD_SCRATCH_BYTES = 256 << 20
WGRAD_MIN_PAIRS = 1024


def wgrad_splits(capacity: int, n_off: int, cin: int, cout: int) -> int:
    """The split scratch's capacity, in splits, for lists of ``capacity``
    pairs per offset: the kernels use as many as an offset's count needs."""
    per_split = n_off * cin * cout * 4
    return max(1, min(-(-capacity // WGRAD_MIN_PAIRS),
                      WGRAD_SCRATCH_BYTES // max(per_split, 1)))


class PairList(NamedTuple):
    """K4's compacted pairs: per offset o, the rows r at which every given
    index table holds a row (``ia[o, r] >= 0`` and ``ib[o, r] >= 0``), in
    ascending order; and per offset and 32-row word (``pair_words``) the
    word's live bits (bit i: row 32 w + i pairs there) and the offset's
    pairs before the word, where K1's row groups find their ranges."""
    rows: torch.Tensor              # (n_off, R) int32; past the count: -1
    #                                 (plain version) or unspecified (kernel)
    counts: torch.Tensor            # (n_off,) int32
    ws: Optional[torch.Tensor]      # the kernel's workspace (rows, counts,
    #                                 its ticket, ...), None on the CPU
    bits: torch.Tensor              # (n_off, words) int32, bit 31 the sign
    starts: torch.Tensor            # (n_off, words) int32


# K4's pair list: rows per thread block of its count and list passes
PAIR_LIST_ROWS = 4096


def pair_words(rows: int) -> int:
    """The 32-row words of a pair list's bits and starts per offset: the
    count and list passes' thread blocks' rows, whole."""
    return max(1, -(-rows // PAIR_LIST_ROWS)) * (PAIR_LIST_ROWS // 32)


def pair_workspace_size(n_off: int, rows: int) -> int:
    """``gather_pairs``' int32 workspace: the rows, the counts, a ticket,
    the list passes' per-block counts, then the count pass's bits and the
    list pass's starts (``pair_words`` each an offset)."""
    return n_off * rows + n_off + 1 \
        + n_off * max(1, -(-rows // PAIR_LIST_ROWS)) \
        + 2 * n_off * pair_words(rows)


def pairs_in(ws: torch.Tensor, n_off: int, rows: int) -> PairList:
    """The ``PairList`` of (n_off, rows) tables whose workspace is
    ``ws``."""
    words = pair_words(rows)
    base = n_off * rows + n_off + 1 + n_off * max(1, -(-rows //
                                                          PAIR_LIST_ROWS))
    return PairList(ws[:n_off * rows].view(n_off, rows),
                    ws[n_off * rows:n_off * rows + n_off], ws,
                    ws[base:base + n_off * words].view(n_off, words),
                    ws[base + n_off * words:base + 2 * n_off * words].view(
                        n_off, words))


def pair_words_plain(live: torch.Tensor) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
    """(bits, starts) of a (n_off, R) live mask, each (n_off,
    ``pair_words(R)``) int32: word w's bit i is row 32 w + i's flag (0 past
    R), its start the offset's live rows before row 32 w."""
    n_off, rows = live.shape
    words = pair_words(rows)
    flags = torch.zeros(n_off, words * 32, dtype=torch.int64,
                        device=live.device)
    flags[:, :rows] = live.long()
    flags = flags.view(n_off, words, 32)
    bits = (flags << torch.arange(32, device=live.device)).sum(-1)
    count = flags.sum(-1)
    starts = count.cumsum(1) - count
    # bit 31 as the sign of an int32, as the kernel's word reads in int32
    return (torch.where(bits >= 1 << 31, bits - (1 << 32), bits).to(
        torch.int32), starts.to(torch.int32))


def gather_pairs_plain(ia: Optional[torch.Tensor],
                       ib: Optional[torch.Tensor]) -> PairList:
    """Plain version of K4's pair list (``gather_pairs``)."""
    live = functools.reduce(torch.logical_and,
                            [t >= 0 for t in (ia, ib) if t is not None])
    counts = live.sum(1, dtype=torch.int32)
    # a stable sort of the dead flags puts each offset's live rows first,
    # in ascending order
    order = torch.sort((~live).to(torch.int8), dim=1, stable=True).indices
    past = torch.arange(live.shape[1], device=live.device)[None, :] \
        >= counts[:, None]
    return PairList(torch.where(past, -1, order).to(torch.int32), counts,
                    None, *pair_words_plain(live))


def gather_pairs(ia: Optional[torch.Tensor], ib: Optional[torch.Tensor]
                 ) -> PairList:
    """Per offset, the rows where every given (n_off, R) index table holds
    a row, ascending; on the card two launches, the counts left there."""
    table = ia if ia is not None else ib
    if table is None:
        raise ValueError("gather_pairs needs ia or ib")
    for t in (ia, ib):
        if t is not None and (t.dim() != 2 or t.shape != table.shape):
            raise ValueError(f"gather_pairs: index tables "
                             f"{tuple(t.shape)} and {tuple(table.shape)}")
    if torch.compiler.is_exporting():
        from segdino3d_tpu_torch.ops import custom_ops
        return custom_ops.gather_pairs(ia, ib)
    if table.device.type == "cpu":
        return gather_pairs_plain(ia, ib)
    present = [t for t in (ia, ib) if t is not None]
    _require_cuda("gather_pairs", *present)
    if any(t.dtype != torch.int32 for t in present):
        raise TypeError("gather_pairs: index tables must be int32")
    n_off, rows = table.shape
    ws = torch.empty(pair_workspace_size(n_off, rows), dtype=torch.int32,
                     device=table.device)
    lib = cuda_build.library("gather_wgrad")
    cuda_build.check(lib.gather_pairs(
        None if ia is None else ia.data_ptr(),
        None if ib is None else ib.data_ptr(), ws.data_ptr(), rows, n_off,
        cuda_build.stream_ptr(table)), "gather_pairs")
    gather_pairs.launches += 1
    return pairs_in(ws, n_off, rows)


gather_pairs.launches = 0

# (id of each given table, ascending) -> (weak references, PairList): the
# pair list of a set of tables, built once per table set while the tables
# live (a plan's tables are built once and never written in place)
_PAIR_LISTS: Dict[Tuple[int, ...], Tuple[tuple, PairList]] = {}


def cached_pairs(ia: Optional[torch.Tensor], ib: Optional[torch.Tensor]
                 ) -> PairList:
    """``gather_pairs`` of these tables, once: the live rows depend on the
    set of tables only, so the down conv's role (ia = child) and the up
    conv's (ib = child) share one list.  K1's and K4's narrow paths take
    no list, so the Baseline's rgb stem table gets none."""
    tables = sorted((t for t in (ia, ib) if t is not None), key=id)
    key = tuple(id(t) for t in tables)
    hit = _PAIR_LISTS.get(key)
    if hit is not None and all(r() is t for r, t in zip(hit[0], tables)):
        return hit[1]
    pairs = gather_pairs(ia, ib)
    refs = tuple(weakref.ref(t, lambda _, key=key: _PAIR_LISTS.pop(key, None))
                 for t in tables)
    _PAIR_LISTS[key] = (refs, pairs)
    return pairs


def gather_wgrad_plain(a: torch.Tensor, ia: Optional[torch.Tensor],
                       b: torch.Tensor, ib: Optional[torch.Tensor],
                       n_off: int, rows: int, mirror: bool = False
                       ) -> torch.Tensor:
    """Plain version of K4: one fp32 product per offset."""
    af, bf = as_sum_type(a), as_sum_type(b)
    dw = af.new_zeros(n_off, a.shape[1], b.shape[1])
    for o in range(n_off):
        ga = af[:rows] if ia is None else _gather_rows(af, ia[o])
        gb = bf[:rows] if ib is None else _gather_rows(bf, ib[o])
        dw[n_off - 1 - o if mirror else o] = ga.T @ gb
    return dw


def gather_wgrad_pairs_plain(a: torch.Tensor, ia: Optional[torch.Tensor],
                             b: torch.Tensor, ib: Optional[torch.Tensor],
                             pairs: PairList, mirror: bool = False
                             ) -> torch.Tensor:
    """K4's reduction as the kernel runs it, over the compacted pairs: one
    fp32 product per offset of its listed rows only."""
    af, bf = as_sum_type(a), as_sum_type(b)
    n_off = pairs.rows.shape[0]
    dw = af.new_zeros(n_off, a.shape[1], b.shape[1])
    for o in range(n_off):
        r = pairs.rows[o, :int(pairs.counts[o])].long()
        ga = af[r if ia is None else ia[o, r].long()]
        gb = bf[r if ib is None else ib[o, r].long()]
        dw[n_off - 1 - o if mirror else o] = ga.T @ gb
    return dw


def gather_wgrad(a: torch.Tensor, ia: Optional[torch.Tensor], b: torch.Tensor,
                 ib: Optional[torch.Tensor], mirror: bool = False,
                 narrow: Optional[bool] = None) -> torch.Tensor:
    """``dW[o] = sum_r a[ia[o, r]]^T @ b[ib[o, r]]`` as (n_off, Cin, Cout)
    fp32; ``mirror`` stores offset o's sum at ``n_off - 1 - o``.

    a (rows_a, Cin) and b (rows_b, Cout) share one dtype; ia, ib (n_off, R)
    int32 index tables, -1 = no row, at least one of them given; an absent
    table is the identity over the first R rows.  On the card the wide
    path reduces the tables' live pairs only (``cached_pairs``).  The
    narrow path (``narrow.narrow_wgrad_path`` of the shape, or ``narrow``
    where a benchmark or test forces one path) takes the unmirrored form
    with a gathered ``a`` and an identity ``b``, the one the backward runs
    at Cin < Cout: every row of ``ia``, no pair list, no pair workspace;
    another form runs the wide path, and forcing it narrow raises."""
    table = ia if ia is not None else ib
    if table is None:
        raise ValueError("gather_wgrad needs ia or ib")
    n_off, rows = table.shape
    for t in (ia, ib):
        if t is not None and tuple(t.shape) != (n_off, rows):
            raise ValueError(f"gather_wgrad: index tables {tuple(t.shape)} "
                             f"and {(n_off, rows)} differ")
    form = ia is not None and ib is None and not mirror
    if narrow and not form:
        raise ValueError("gather_wgrad: the narrow path takes a gathered a, "
                         "an identity b and no mirror")
    if a.device.type == "cpu":
        return gather_wgrad_plain(a, ia, b, ib, n_off, rows, mirror)
    present = [t for t in (a, ia, b, ib) if t is not None]
    _require_cuda("gather_wgrad", *present)
    if a.dtype != b.dtype or any(t.dtype != torch.int32
                                 for t in (ia, ib) if t is not None):
        raise TypeError("gather_wgrad: a and b must share a dtype and index "
                        "tables must be int32")
    if (ia is None and a.shape[0] < rows) or (ib is None and b.shape[0] < rows):
        raise ValueError("gather_wgrad: an identity side has fewer rows "
                         "than the table")
    cin, cout = a.shape[1], b.shape[1]
    narrow = form and N.pick(narrow, n_off, cin, cout, a.dtype,
                             "gather_wgrad", wgrad=True)
    splits = wgrad_splits(rows, n_off, cin, cout)
    out = torch.empty(n_off, cin, cout, dtype=torch.float32, device=a.device)
    partial = out if splits == 1 else torch.empty(
        splits, n_off, cin, cout, dtype=torch.float32, device=a.device)
    lib = cuda_build.library("gather_wgrad")
    if narrow:
        cuda_build.check(lib.gather_wgrad_narrow(
            a.data_ptr(), ia.data_ptr(), b.data_ptr(), partial.data_ptr(),
            out.data_ptr(), rows, cin, cout, n_off, splits,
            cuda_build.dtype_code(a.dtype), cuda_build.stream_ptr(a)),
            "gather_wgrad_narrow")
        gather_wgrad.launches += 1
        gather_wgrad.narrow.launches += 1
        return out
    pairs = cached_pairs(ia, ib)
    N.count_element_loads(a, b)
    cuda_build.check(lib.gather_wgrad(
        a.data_ptr(), None if ia is None else ia.data_ptr(), b.data_ptr(),
        None if ib is None else ib.data_ptr(), pairs.ws.data_ptr(),
        partial.data_ptr(), out.data_ptr(), rows, cin, cout, n_off, splits,
        int(mirror), cuda_build.dtype_code(a.dtype),
        cuda_build.stream_ptr(a)), "gather_wgrad")
    gather_wgrad.launches += 1
    return out


gather_wgrad.launches = 0
gather_wgrad.narrow = types.SimpleNamespace(launches=0)   # of them narrow


def _masked(dout: torch.Tensor, valid: torch.Tensor, dtype) -> torch.Tensor:
    return torch.where(valid[:, None], dout, 0.0).to(dtype).contiguous()


def _transposed(weights: torch.Tensor) -> torch.Tensor:
    """(n_off, Cin, Cout) -> (n_off, Cout, Cin), contiguous."""
    return weights.transpose(1, 2).contiguous()


class _SubmConv(torch.autograd.Function):
    """Backward of ``_subm_conv_bwd`` (``segdino3d_tpu/ops/sparse_conv.py``):
    the mirror identity ``nbr[o, j] = i <=> nbr[n-1-o, i] = j`` makes dX a
    gather conv (K1) of dY with offset-flipped, transposed weights and dW
    a gathered product (K4) that gathers the narrower of X and dY."""

    @staticmethod
    def forward(ctx, feats, nbr, weights, valid):
        ctx.save_for_backward(feats, nbr, weights, valid)
        return gather_conv(feats, nbr, weights, valid)

    @staticmethod
    def backward(ctx, dout):
        feats, nbr, weights, valid = ctx.saved_tensors
        dy = _masked(dout, valid, feats.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = gather_conv(dy, nbr, _transposed(weights.flip(0)), valid,
                             dx=True)
        if ctx.needs_input_grad[2]:
            if feats.shape[1] > dy.shape[1]:
                dw = gather_wgrad(feats, None, dy, nbr, mirror=True)
            else:
                dw = gather_wgrad(feats, nbr, dy, None)
            dw = dw.to(weights.dtype)
        return dx, None, dw, None


class _DownConv(torch.autograd.Function):
    """``coarse[j] = sum_k fine_x[child[k, j]] @ W[k]``; dX is the up conv
    of dY with transposed weights (K2), dW gathers X through the child
    table (K4)."""

    @staticmethod
    def forward(ctx, feats, child, weights, coarse_valid, parent, kpos,
                fine_valid):
        ctx.save_for_backward(feats, child, weights, coarse_valid, parent,
                              kpos, fine_valid)
        return gather_conv(feats, child, weights, coarse_valid)

    @staticmethod
    def backward(ctx, dout):
        (feats, child, weights, coarse_valid, parent, kpos,
         fine_valid) = ctx.saved_tensors
        dy = _masked(dout, coarse_valid, feats.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = up_conv_rows(dy, child, parent, kpos, _transposed(weights),
                              fine_valid)
        if ctx.needs_input_grad[2]:
            dw = gather_wgrad(feats, child, dy, None).to(weights.dtype)
        return dx, None, dw, None, None, None, None


class _UpConv(torch.autograd.Function):
    """``fine[i] = x[parent[i]] @ W[kpos[i]]``; dX is the gather conv of dF
    over the child table with transposed weights (K1), dW gathers dF
    through the child table (K4).  The child table holds exactly the live
    fine rows, so dF needs no mask."""

    @staticmethod
    def forward(ctx, feats, child, parent, kpos, weights, valid):
        ctx.save_for_backward(feats, weights, child)
        return up_conv_rows(feats, child, parent, kpos, weights, valid)

    @staticmethod
    def backward(ctx, dfine):
        feats, weights, child = ctx.saved_tensors
        df = dfine.to(feats.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            every = torch.ones(child.shape[1], dtype=torch.bool,
                               device=child.device)
            dx = gather_conv(df, child, _transposed(weights), every)
        if ctx.needs_input_grad[4]:
            dw = gather_wgrad(feats, None, df, child).to(weights.dtype)
        return dx, None, None, None, dw, None


def subm_conv(feats, nbr, weights, valid):
    """Submanifold convolution: output coordinates == input coordinates."""
    return _SubmConv.apply(feats, nbr, weights, valid)


def down_conv(feats, fine, coarse, weights):
    """Strided conv k=2 s=2: ``coarse[j] = sum_k W[k] fine[child[k, j]]``.

    ``fine.child`` is the (8, V_coarse) child table of the fine level."""
    return _DownConv.apply(feats, fine.child, weights, coarse.valid,
                           fine.parent, fine.kpos, fine.valid)


def up_conv(feats, fine, weights):
    """Transposed conv k=2 s=2 restoring the fine coordinate set."""
    return _UpConv.apply(feats, fine.child, fine.parent, fine.kpos, weights,
                         fine.valid)


# ---------------------------------------------------------------------------
# The degree-compacted k5 stem (inference only)
# ---------------------------------------------------------------------------


def stem_slot_sum_plain(y2: torch.Tensor, slots: torch.Tensor,
                        ov_src: torch.Tensor, ov_dst: torch.Tensor,
                        valid: torch.Tensor) -> torch.Tensor:
    """Plain version of K12: slot-by-slot gathers summed in fp32, then
    ``index_add_`` of the overflow rows into a dump-row-padded table, then
    the mask."""
    def rows(idx):
        r = as_sum_type(y2[idx.clamp(min=0).long()])
        return torch.where((idx >= 0)[:, None], r, 0.0)

    v, cout = slots.shape[1], y2.shape[1]
    acc = as_sum_type(y2.new_zeros(v, cout))
    for d in range(slots.shape[0]):
        acc += rows(slots[d])
    ov = acc.new_zeros(v + 1, cout).index_add_(0, ov_dst.long(), rows(ov_src))
    return torch.where(valid[:, None], acc + ov[:v], 0.0).to(y2.dtype)


def stem_slot_sum(y2: torch.Tensor, slots: torch.Tensor,
                  ov_src: torch.Tensor, ov_dst: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """``out[i] = sum_d y2[slots[d, i]] + sum_{ov_dst[p] = i} y2[ov_src[p]]``
    over entries >= 0, 0 on invalid rows.

    y2 (R, Cout) fp32 or bf16, Cout <= 128; slots (D, V) int32; ov_src,
    ov_dst (P,) int32, ``ov_dst`` ascending (the plan's voxel-major order)
    with V at padding; valid (V,) bool.  Returns (V, Cout) in y2's dtype,
    summed in fp32."""
    v, cout = slots.shape[1], y2.shape[1]
    if ov_src.shape != ov_dst.shape or valid.shape[0] != v:
        raise ValueError(f"stem_slot_sum: slots {tuple(slots.shape)}, "
                         f"ov_src {tuple(ov_src.shape)}, ov_dst "
                         f"{tuple(ov_dst.shape)}, valid {tuple(valid.shape)}")
    if y2.device.type == "cpu":
        return stem_slot_sum_plain(y2, slots, ov_src, ov_dst, valid)
    _require_cuda("stem_slot_sum", y2, slots, ov_src, ov_dst, valid)
    if any(t.dtype != torch.int32 for t in (slots, ov_src, ov_dst)) \
            or valid.dtype != torch.bool:
        raise TypeError("stem_slot_sum: index tables must be int32 and "
                        "valid bool")
    if cout > 128:
        raise ValueError(f"stem_slot_sum: Cout {cout} > 128")
    out = torch.empty(v, cout, dtype=y2.dtype, device=y2.device)
    lib = cuda_build.library("stem_slot_sum")
    cuda_build.check(lib.stem_slot_sum(
        y2.data_ptr(), slots.data_ptr(), ov_src.data_ptr(), ov_dst.data_ptr(),
        valid.data_ptr(), out.data_ptr(), v, slots.shape[0], ov_src.shape[0],
        cout, cuda_build.dtype_code(y2.dtype), cuda_build.stream_ptr(y2)),
        "stem_slot_sum")
    stem_slot_sum.launches += 1
    return out


stem_slot_sum.launches = 0


def _wide_product(feats: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``feats @ W_flat`` read as (V * k^3, Cout): row ``j * k^3 + o`` is
    voxel j's features times offset o's weights."""
    n_off, cin, cout = weights.shape
    w_flat = weights.permute(1, 0, 2).reshape(cin, n_off * cout)
    return (feats @ w_flat).view(feats.shape[0] * n_off, cout)


def stem_compact_conv_plain(feats, weights, slots, ov_src, ov_dst, valid):
    """Plain version of ``stem_compact_conv``: the wide product in fp32,
    rounded to feats' dtype as the JAX op's is, then the slot sum."""
    y2 = _wide_product(as_sum_type(feats), as_sum_type(weights))
    return stem_slot_sum_plain(y2.to(feats.dtype), slots, ov_src, ov_dst,
                               valid)


def stem_compact_conv(feats: torch.Tensor, weights: torch.Tensor,
                      slots: torch.Tensor, ov_src: torch.Tensor,
                      ov_dst: torch.Tensor, valid: torch.Tensor
                      ) -> torch.Tensor:
    """Degree-compacted submanifold conv, the k5 stem
    (``segdino3d_tpu/ops/sparse_conv.py:stem_compact_conv``): one wide
    product ``y = feats @ W_flat`` in feats' dtype, (V, Cin) @ (Cin,
    k^3 * Cout), then K12 sums each voxel's occupied (neighbour, offset)
    rows of ``y``: its D slots and its overflow pairs (``ops.host_plan``).

    Inference only, as in JAX: it has no backward and raises when asked
    for one.  weights (k^3, Cin, Cout) canonical order; slots (D, V0);
    ov_src, ov_dst (P,); valid (V0,) bool."""
    if torch.is_grad_enabled() and (feats.requires_grad
                                    or weights.requires_grad):
        raise RuntimeError("stem_compact_conv is inference only: the "
                           "compacted stem has no backward (train on the "
                           "gather or dense stem)")
    if feats.shape[1] != weights.shape[1]:
        raise ValueError(f"stem_compact_conv: feats {tuple(feats.shape)}, "
                         f"weights {tuple(weights.shape)}")
    if feats.device.type == "cpu":
        return stem_compact_conv_plain(feats, weights, slots, ov_src, ov_dst,
                                       valid)
    return stem_slot_sum(_wide_product(feats, weights.to(feats.dtype)),
                         slots, ov_src, ov_dst, valid)


# ---------------------------------------------------------------------------
# The coordinate pyramid of the on-device plan engine
# ---------------------------------------------------------------------------


class PlanLevel(NamedTuple):
    """One stride level of the pyramid (``sparse_conv.Level`` in JAX)."""
    coords_T: torch.Tensor      # (4, V) int32 in units of this level's stride
    valid: torch.Tensor         # (V,) bool
    hash: CoordHash             # key -> voxel id at this level
    num_voxels: torch.Tensor    # () int32, may exceed V (overflow)
    overflow: torch.Tensor      # () bool
    # links to the next-coarser level (None at the deepest level)
    parent: Optional[torch.Tensor] = None   # (V,) int32, -1 none/dropped
    kpos: Optional[torch.Tensor] = None     # (V,) int32 in [0, 8)


def downsample(level: PlanLevel, v_cap: int):
    """unique(coords // 2) in first-occurrence order -> (coarser level,
    parent, kpos).  A coarse id at or past ``v_cap`` gives ``parent = -1``
    and sets the coarse level's overflow."""
    b, x, y, z = level.coords_T
    key = K.pack_columns_u32(b, x >> 1, y >> 1, z >> 1, level.valid)
    n = key.shape[0]
    h, winner = build_and_lookup(key, capacity=min(v_cap, n))
    comp = voxel_compact(winner, level.coords_T, v_cap, 1, h, with_kpos=True)
    coarse = PlanLevel(coords_T=comp.coords_T, valid=comp.valid,
                       hash=comp.hash, num_voxels=comp.num_voxels,
                       overflow=h.overflow | (comp.num_voxels > v_cap))
    return coarse, comp.inverse, comp.kpos


def build_conv_plan(grid: VoxelGrid, num_levels: int,
                    level_caps: Optional[Sequence[int]] = None
                    ) -> List[PlanLevel]:
    """The stride-1..2^(L-1) pyramid from the level-0 voxels."""
    v0 = grid.coords_T.shape[1]
    caps = list(level_caps) if level_caps is not None else [v0] * num_levels
    levels = [PlanLevel(coords_T=grid.coords_T, valid=grid.valid,
                        hash=grid.hash, num_voxels=grid.num_voxels,
                        overflow=grid.overflow)]
    for li in range(1, num_levels):
        coarse, parent, kpos = downsample(levels[-1], caps[li])
        levels[-1] = levels[-1]._replace(parent=parent, kpos=kpos)
        levels.append(coarse)
    return levels


def neighbor_table_plain(coords_T: torch.Tensor, num_voxels: torch.Tensor,
                         kernel_size: int) -> torch.Tensor:
    """Plain version of K7, with no hash: ``searchsorted`` of each
    neighbour's key over the level's sorted voxel keys."""
    v, dev = coords_T.shape[1], coords_T.device
    live = torch.arange(v, device=dev) < num_voxels
    own = K.pack_columns_u32(*coords_T, live)
    sorted_keys, order = torch.sort(own)
    offs = torch.from_numpy(kernel_offsets(kernel_size)).to(dev)
    q = [coords_T[d][None, :] + offs[:, d - 1][:, None] for d in (1, 2, 3)]
    qk = K.pack_columns_u32(coords_T[0][None, :].expand_as(q[0]), *q,
                            live[None, :].expand_as(q[0]))
    pos = torch.searchsorted(sorted_keys, qk.reshape(-1)).clamp(max=v - 1)
    hit = (sorted_keys[pos] == qk.reshape(-1)) & (qk.reshape(-1) != K.SENTINEL)
    return torch.where(hit, order[pos], -1).to(torch.int32).view(-1, v)


@functools.lru_cache(maxsize=None)
def subset_offsets(kernel_size: int, sub_size: int) -> np.ndarray:
    """(k^3,) int32, read-only: each offset's index among the
    ``sub_size``^3 offsets (``kernel_offsets`` order), -1 where it is not
    one of them."""
    index = {tuple(o): i for i, o in enumerate(kernel_offsets(sub_size))}
    out = np.array([index.get(tuple(o), -1)
                    for o in kernel_offsets(kernel_size)], np.int32)
    out.flags.writeable = False
    return out


# K7's tables of one launch share a buffer, each starting on 256 bytes
_TABLE_ALIGN = 64


def _mirror_fill(tables) -> Tuple[int, int]:
    """(start, end) addresses of the range K7's C entry sets to -1 for
    ``tables``, (out, sub) views in buffer order: from the first table's
    mirrored half to the end of the last view."""
    first = tables[0][0]
    start = first.data_ptr() + (first.shape[0] // 2 + 1) * first.shape[1] * 4
    end = max(t.data_ptr() + t.numel() * 4 for pair in tables for t in pair
              if t is not None)
    return start, end


@functools.lru_cache(maxsize=None)
def _subset_map(kernel_size: int):
    """``subset_offsets(k, 3)`` as the C array K7's entry reads."""
    m = subset_offsets(kernel_size, 3)
    return (ctypes.c_int32 * len(m))(*m.tolist())


def _build_tables(jobs) -> None:
    """One launch of K7 over ``jobs``: (level, k, out, sub) with ``out`` a
    (k^3, V) view and ``sub`` None or a (27, V) view whose cells come from
    ``out``'s probes, all views of one buffer (``_table_buffer``) in the
    jobs' order.  The buffer from the first table's mirrored half to its
    end, which holds every mirrored half, is set to -1 first (one
    memset)."""
    first = jobs[0][2]
    fill, end = _mirror_fill([(out, sub) for _, _, out, sub in jobs])
    desc, sub_map = [], None
    for lv, k, out, sub in jobs:
        h = lv.hash
        _require_cuda("neighbor_table", lv.coords_T, lv.num_voxels, h.keys,
                      h.vals)
        if h.keys.dtype != torch.int32:
            raise TypeError("neighbor_table: the level's hash must be K6's "
                            "table")
        desc += (lv.coords_T.data_ptr(), lv.num_voxels.data_ptr(),
                 h.keys.data_ptr(), h.vals.data_ptr(), out.data_ptr(),
                 0 if sub is None else sub.data_ptr(),
                 lv.coords_T.shape[1], k, h.keys.shape[0])
        if sub is not None:
            sub_map = _subset_map(k)
    lib = cuda_build.library("neighbor_table")
    cuda_build.check(lib.neighbor_tables(
        (ctypes.c_int64 * len(desc))(*desc), len(jobs), sub_map, fill,
        max(end - fill, 0), cuda_build.stream_ptr(first)), "neighbor_table")


def _table_buffer(shapes, device):
    """Views of one int32 buffer, one per (n_off, V) shape, in order."""
    sizes = [-(-n * v // _TABLE_ALIGN) * _TABLE_ALIGN for n, v in shapes]
    buf = torch.empty(sum(sizes), dtype=torch.int32, device=device)
    views, at = [], 0
    for (n, v), size in zip(shapes, sizes):
        views.append(buf.as_strided((n, v), (v, 1), at))
        at += size
    return views


def neighbor_table(level: PlanLevel, kernel_size: int) -> torch.Tensor:
    """(k^3, V) int32: the voxel at ``coords + offset`` (offset-major,
    canonical order), -1 where absent, for rows past the count and for
    neighbours dropped by an overflow."""
    if kernel_size % 2 != 1:
        raise ValueError("neighbor tables are for odd, centered kernels")
    coords_T = level.coords_T
    if coords_T.device.type == "cpu":
        return neighbor_table_plain(coords_T, level.num_voxels, kernel_size)
    (out,) = _table_buffer([(kernel_size ** 3, coords_T.shape[1])],
                           coords_T.device)
    _build_tables([(level, kernel_size, out, None)])
    neighbor_table.launches += 1
    return out


neighbor_table.launches = 0


def neighbor_tables(pyramid: Sequence[PlanLevel], stem_kernel: int
                    ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """(each level's (27, V_l) table, the stem's (k^3, V_0) table): every
    table of a plan.  On the card one launch of K7 builds them all (and one
    memset clears their mirrored halves); a k5 stem's probes also give
    level 0's k3 table, and a k3 stem is level 0's table."""
    if stem_kernel % 2 != 1 or stem_kernel < 3:
        raise ValueError("the stem's kernel must be odd and at least 3")
    if pyramid[0].coords_T.device.type == "cpu":
        k3 = [neighbor_table_plain(lv.coords_T, lv.num_voxels, 3)
              for lv in pyramid]
        stem = k3[0] if stem_kernel == 3 else neighbor_table_plain(
            pyramid[0].coords_T, pyramid[0].num_voxels, stem_kernel)
        return k3, stem
    shapes = [(27, lv.coords_T.shape[1]) for lv in pyramid]
    own_stem = stem_kernel != 3
    if own_stem:
        shapes.insert(0, (stem_kernel ** 3, pyramid[0].coords_T.shape[1]))
    views = _table_buffer(shapes, pyramid[0].coords_T.device)
    k3 = views[1:] if own_stem else views
    jobs = [(lv, 3, t, None) for lv, t in zip(pyramid, k3)]
    if own_stem:
        jobs[0] = (pyramid[0], stem_kernel, views[0], k3[0])
    _build_tables(jobs)
    neighbor_tables.launches += 1
    return list(k3), views[0]


neighbor_tables.launches = 0


def child_table(parent: torch.Tensor, kpos: torch.Tensor, coarse_cap: int
                ) -> torch.Tensor:
    """(8, coarse_cap) int32 with ``child[kpos[i], parent[i]] = i`` for the
    fine rows that have a parent, else -1 (``host_plan.child_table``)."""
    dev = parent.device
    flat = torch.full((8 * coarse_cap + 1,), -1, dtype=torch.int32,
                      device=dev)
    slot = torch.where(parent >= 0, kpos.long() * coarse_cap + parent.long(),
                       8 * coarse_cap)
    flat.scatter_(0, slot, torch.arange(parent.shape[0], dtype=torch.int32,
                                        device=dev))
    return flat[:-1].view(8, coarse_cap)


def up_order(kpos: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Fine rows stably sorted by kpos, invalid rows last
    (``host_plan.up_order``).  A plan field that no kernel reads: K2
    walks the child table's pair list."""
    key = torch.where(valid, kpos, 8)
    return torch.sort(key, stable=True).indices.to(torch.int32)
