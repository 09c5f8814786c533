"""Deterministic segment means (K3, ``csrc/segment_mean_gather.cu``) and
the pooling's gradient (K5, ``csrc/segment_grad.cu``).

Counterpart of ``segdino3d_tpu/ops/scatter.py:segment_mean`` and
``segment_mean_stack``; with ``gather_idx`` it also fuses
``ops/voxelize.py:devoxelize`` into the pooling, so voxel features are
averaged over the points of a segment without building the per-point
tensor.

Segments are built as CSR over a stable sort of the segment ids
(``segment_csr``, once per forward and segment set) and cut into chunks on
the member array's ``CHUNK``-member blocks, a warp a block.  K3 reads its
columns where they lie, from a short list of column sources (2D tensors
whose columns are contiguous, in fp32, fp16 or bf16), in one launch: a
segment within one block writes its mean directly, a longer one adds its
chunks' partial sums in chunk order, with no atomics.  For a CPU tensor
the wrapper runs ``segment_mean_gather_plain``.

``pool_gathered`` is differentiable in the voxel features only (the
coordinates pooled beside them are data): its backward, ``segment_grad``,
walks the voxel CSR of the forward's voxel mean, so each voxel adds its
points' superpoint gradients in one fixed order.  The voxel mean itself
pools input data and raises if asked for a gradient.

While ``torch.export`` traces a model, ``segment_csr`` and
``segment_mean_gather`` put their kernels in the graph as
``ops.custom_ops``' registered ops instead.
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Union

import torch
import torch.nn.functional as F

from segdino3d_tpu_torch.ops import cuda_build
from segdino3d_tpu_torch.ops.sparse_conv import as_sum_type

CHUNK = 32   # members per work item of the kernel (csrc: kChunk)

Columns = Union[torch.Tensor, Sequence[torch.Tensor]]


class SegmentCSR(NamedTuple):
    """The rows of segment s are ``members[offsets[s]:offsets[s+1]]``, in
    ascending order; ``sorted_ids`` holds each member's segment id (the
    dropped rows last, as S); ``counters`` (S,) int32 zeros are the
    kernel's per-segment arrival counters, which it leaves zero."""
    offsets: torch.Tensor      # (S+1,) int64
    members: torch.Tensor      # (N,) int64: the kept rows first
    sorted_ids: torch.Tensor   # (N,) int32
    counters: torch.Tensor     # (S,) int32


def _kept_ids(seg_ids: torch.Tensor, num_segments: int,
              valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Segment ids with invalid rows and ids outside [0, S) moved to the
    dropped slot S, in seg_ids' integer type."""
    keep = (seg_ids >= 0) & (seg_ids < num_segments)
    if valid is not None:
        keep = keep & valid
    return torch.where(keep, seg_ids, num_segments)


def segment_csr_plain(seg_ids: torch.Tensor, num_segments: int,
                      valid: Optional[torch.Tensor] = None) -> SegmentCSR:
    """Plain version of ``segment_csr``'s two kernels, on any device."""
    sorted_ids, members = torch.sort(
        _kept_ids(seg_ids, num_segments, valid).to(torch.int32), stable=True)
    offsets = torch.searchsorted(sorted_ids, torch.arange(
        num_segments + 1, dtype=torch.int32, device=seg_ids.device))
    return SegmentCSR(offsets, members, sorted_ids, torch.zeros(
        num_segments, dtype=torch.int32, device=seg_ids.device))


def segment_csr(seg_ids: torch.Tensor, num_segments: int,
                valid: Optional[torch.Tensor] = None) -> SegmentCSR:
    """The CSR of ``seg_ids``: rows that are invalid or whose id lies
    outside [0, S) belong to no segment.  A stable sort of int32 keys; on
    the card the keys and the offsets are two launches of K3's library
    around ``torch.sort`` (which also zero the counters).  Nothing here
    waits for the device."""
    n, dev = seg_ids.shape[0], seg_ids.device
    if torch.compiler.is_exporting():
        from segdino3d_tpu_torch.ops import custom_ops
        return custom_ops.segment_csr(seg_ids, num_segments, valid)
    if dev.type == "cpu":
        return segment_csr_plain(seg_ids, num_segments, valid)
    present = [seg_ids] + ([] if valid is None else [valid])
    if any(t.device.type != "cuda" or not t.is_contiguous()
           for t in present):
        raise ValueError("segment_csr: tensors must be contiguous and on "
                         "one CUDA device")
    if seg_ids.dtype not in (torch.int32, torch.int64) or (
            valid is not None and valid.dtype != torch.bool):
        raise TypeError("segment_csr: ids must be int32 or int64, valid "
                        "bool")
    lib = cuda_build.library("segment_mean_gather")
    stream = cuda_build.stream_ptr(seg_ids)
    keys = torch.empty(n, dtype=torch.int32, device=dev)
    cuda_build.check(lib.segment_csr_keys(
        seg_ids.data_ptr(), int(seg_ids.dtype == torch.int64),
        None if valid is None else valid.data_ptr(), n, num_segments,
        keys.data_ptr(), stream), "segment_csr_keys")
    sorted_ids, members = torch.sort(keys, stable=True)
    offsets = torch.empty(num_segments + 1, dtype=torch.int64, device=dev)
    counters = torch.empty(num_segments, dtype=torch.int32, device=dev)
    cuda_build.check(lib.segment_csr_offsets(
        sorted_ids.data_ptr(), n, num_segments, offsets.data_ptr(),
        counters.data_ptr(), stream), "segment_csr_offsets")
    segment_csr.launches += 1
    return SegmentCSR(offsets, members, sorted_ids, counters)


segment_csr.launches = 0


def _as_columns(d: Optional[Columns]) -> List[torch.Tensor]:
    if d is None:
        return []
    return [d] if isinstance(d, torch.Tensor) else list(d)


def segment_mean_gather_plain(seg_ids: torch.Tensor, num_segments: int,
                              valid: Optional[torch.Tensor],
                              g: Optional[torch.Tensor] = None,
                              gather_idx: Optional[torch.Tensor] = None,
                              d: Optional[Columns] = None,
                              round_to: Optional[torch.dtype] = None
                              ) -> torch.Tensor:
    """Plain version of K3: (S, cg + cd) fp32 means of the concatenated
    columns, ``d``'s elements first rounded to ``round_to``."""
    cols = []
    if g is not None:
        gf = as_sum_type(g)
        if gather_idx is not None:
            gf = torch.cat([gf, gf.new_zeros(1, gf.shape[1])])[
                torch.where(gather_idx < 0, g.shape[0], gather_idx).long()]
        cols.append(gf)
    cols += [as_sum_type(x if round_to is None else x.to(round_to))
             for x in _as_columns(d)]
    x = torch.cat(cols, dim=1)
    seg = _kept_ids(seg_ids, num_segments, valid).long()
    sums = x.new_zeros(num_segments + 1, x.shape[1]).index_add_(0, seg, x)
    cnts = torch.bincount(seg, minlength=num_segments + 1).to(x.dtype)
    return (sums / cnts.clamp(min=1.0)[:, None])[:num_segments]


# the kernel's source flags (csrc/segment_mean_gather.cu)
_SRC_DTYPE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_GATHERED, _ROUND, _VEC = 1 << 4, 1 << 5, 1 << 6
MAX_SOURCES = 8


def _source(t: torch.Tensor, rows: int, gathered: bool, round_bf16: bool
            ) -> tuple:
    """(pointer, row bytes, columns, flags) of one column source."""
    if t.dim() != 2 or t.shape[0] != rows or (
            t.shape[1] > 1 and t.stride(1) != 1):
        raise ValueError(f"segment_mean_gather: a column source must be "
                         f"({rows}, C) with contiguous columns, got "
                         f"{tuple(t.shape)} strides {t.stride()}")
    if t.dtype not in _SRC_DTYPE:
        raise TypeError(f"segment_mean_gather: sources are fp32, fp16 or "
                        f"bf16, not {t.dtype}")
    row_bytes = t.stride(0) * t.element_size()
    flags = _SRC_DTYPE[t.dtype] | (_GATHERED if gathered else 0) \
        | (_ROUND if round_bf16 else 0)
    if t.data_ptr() % 16 == 0 and row_bytes % 16 == 0 \
            and t.shape[1] * t.element_size() >= 16:
        flags |= _VEC
    return t.data_ptr(), row_bytes, t.shape[1], flags


def _widened(out: torch.Tensor, width: int) -> torch.Tensor:
    """``out`` with zero columns up to ``width``."""
    return out if out.shape[1] == width else F.pad(
        out, (0, width - out.shape[1]))


def segment_mean_gather(seg_ids: torch.Tensor, num_segments: int,
                        valid: Optional[torch.Tensor] = None,
                        g: Optional[torch.Tensor] = None,
                        gather_idx: Optional[torch.Tensor] = None,
                        d: Optional[Columns] = None,
                        csr: Optional[SegmentCSR] = None,
                        round_to: Optional[torch.dtype] = None,
                        width: Optional[int] = None) -> torch.Tensor:
    """Per-segment means of ``[g[gather_idx[p]] | d_0[p] | d_1[p] | ...]``
    over the valid rows p of each segment, as (S, cg + cd) fp32, or with
    ``width`` as (S, width) fp32 rows zero past the means (the kernel
    writes them at that pitch); empty segments give 0.

    ``g`` (Vg, cg) is read through ``gather_idx`` (N,) int32 (-1 = zero
    row; the identity when absent).  ``d`` is one (N, c) tensor or a list
    of them, each read where it lies (a column slice of a wider tensor
    too), fp32, fp16 or bf16; with ``round_to=torch.bfloat16`` each of its
    elements is rounded to bf16 before it is added, as ``torch.cat(d).to(
    torch.bfloat16)`` would round it.  ``csr`` is ``segment_csr(seg_ids,
    num_segments, valid)`` where the caller already has it.  Not
    differentiable: raises if ``g`` or ``d`` requires a gradient."""
    cols = _as_columns(d)
    if g is None and not cols:
        raise ValueError("segment_mean_gather needs g or d")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in [g] + cols):
        raise RuntimeError("segment_mean_gather has no gradient: pool data, "
                           "or call pool_gathered for voxel features")
    if round_to not in (None, torch.float32, torch.bfloat16):
        raise TypeError(f"segment_mean_gather: round_to {round_to}")
    ref = g if g is not None else cols[0]
    ctot = sum(t.shape[1] for t in ([] if g is None else [g]) + cols)
    width = ctot if width is None else width
    if width < ctot:
        raise ValueError(f"segment_mean_gather: width {width} < {ctot} "
                         "columns")
    if torch.compiler.is_exporting():
        from segdino3d_tpu_torch.ops import custom_ops
        return _widened(custom_ops.segment_mean_gather(
            seg_ids, num_segments, valid, g, gather_idx, cols, csr, round_to),
            width)
    if ref.device.type == "cpu":
        return _widened(segment_mean_gather_plain(
            seg_ids, num_segments, valid, g, gather_idx, cols, round_to),
            width)
    whole = [t for t in (seg_ids, valid, g, gather_idx) if t is not None]
    if any(t.device.type != "cuda" for t in whole + cols) \
            or not all(t.is_contiguous() for t in whole):
        raise ValueError("segment_mean_gather: tensors must be on one CUDA "
                         "device; the ids, g and gather_idx contiguous")
    if gather_idx is not None and gather_idx.dtype != torch.int32:
        raise TypeError("segment_mean_gather: gather_idx must be int32")
    n = seg_ids.shape[0]
    if g is not None and gather_idx is None and g.shape[0] < n:
        raise ValueError("segment_mean_gather: g read without gather_idx "
                         "needs a row per id")
    srcs = ([] if g is None else [_source(
        g, g.shape[0], gather_idx is not None, False)]) + [
        _source(x, n, False, round_to == torch.bfloat16) for x in cols]
    if len(srcs) > MAX_SOURCES:
        raise ValueError(f"segment_mean_gather: at most {MAX_SOURCES} "
                         f"column sources")
    csr = csr if csr is not None else segment_csr(seg_ids, num_segments,
                                                   valid)
    if csr.members.shape[0] != n or csr.counters.shape[0] != num_segments:
        raise ValueError("segment_mean_gather: csr is not of these ids")
    out = torch.empty(num_segments, width, dtype=torch.float32,
                      device=ref.device)
    # two partial rows per 32-member block of the members: the run that
    # began before the block, the run that goes on past it
    partial = torch.empty(max(2, 2 * -(-n // CHUNK)), ctot,
                          dtype=torch.float32, device=ref.device)
    k = len(srcs)
    lib = cuda_build.library("segment_mean_gather")
    cuda_build.check(lib.segment_mean_gather(
        csr.offsets.data_ptr(), csr.members.data_ptr(),
        csr.sorted_ids.data_ptr(), csr.counters.data_ptr(),
        partial.data_ptr(),
        None if gather_idx is None else gather_idx.data_ptr(), k,
        (ctypes.c_void_p * k)(*[s[0] for s in srcs]),
        (ctypes.c_longlong * k)(*[s[1] for s in srcs]),
        (ctypes.c_int * k)(*[s[2] for s in srcs]),
        (ctypes.c_int * k)(*[s[3] for s in srcs]),
        out.data_ptr(), width, num_segments, n,
        cuda_build.stream_ptr(ref)), "segment_mean_gather")
    segment_mean_gather.launches += 1
    return out


segment_mean_gather.launches = 0


def segment_mean(x: torch.Tensor, seg_ids: torch.Tensor, num_segments: int,
                 valid: Optional[torch.Tensor] = None,
                 csr: Optional[SegmentCSR] = None) -> torch.Tensor:
    """Mean of rows of ``x`` grouped by ``seg_ids`` (scatter_mean parity);
    ids outside [0, num_segments) and invalid rows are dropped."""
    return segment_mean_gather(seg_ids, num_segments, valid, d=x,
                               csr=csr).to(x.dtype)


def segment_mean_columns(xs: Sequence[torch.Tensor], seg_ids: torch.Tensor,
                         num_segments: int, dtype: torch.dtype,
                         valid: Optional[torch.Tensor] = None,
                         csr: Optional[SegmentCSR] = None,
                         width: Optional[int] = None) -> torch.Tensor:
    """``segment_mean(torch.cat(xs, 1).to(dtype), ...)`` without the
    concatenation: each (N, c) block is read where it lies, in its own
    dtype, each element rounded to ``dtype`` before it is added.  With
    ``width`` the rows are that wide, zero past the columns of ``xs`` (the
    stems' aligned pitch, ``narrow.row_pitch``): in fp32 the kernel writes
    the means at that pitch, in bf16 the cast writes into the wider rows,
    so no further copy is made."""
    if dtype == torch.float32:
        return segment_mean_gather(seg_ids, num_segments, valid, d=xs,
                                   csr=csr, round_to=dtype, width=width)
    means = segment_mean_gather(seg_ids, num_segments, valid, d=xs, csr=csr,
                                round_to=dtype)
    c = means.shape[1]
    if width is None or width == c:
        return means.to(dtype)
    out = means.new_empty(num_segments, width, dtype=dtype)
    out[:, c:] = 0
    out[:, :c] = means
    return out


def segment_mean_stack(xs: Sequence[torch.Tensor], seg_ids: torch.Tensor,
                       num_segments: int,
                       valid: Optional[torch.Tensor] = None
                       ) -> List[torch.Tensor]:
    """Means of several row-aligned arrays over one set of segment ids, in
    one kernel launch that reads each where it lies; each result keeps its
    input's dtype."""
    d = [x if x.dtype in _SRC_DTYPE or x.device.type == "cpu" else x.float()
         for x in xs]
    return _split(segment_mean_gather(seg_ids, num_segments, valid, d=d), xs)


def segment_counts(offsets: torch.Tensor, dtype=torch.float32
                   ) -> torch.Tensor:
    """(S,) each segment's row count from its CSR offsets, at least 1."""
    return (offsets[1:] - offsets[:-1]).clamp(min=1).to(dtype)


def segment_grad_plain(g: torch.Tensor, seg_ids: torch.Tensor,
                       num_segments: int, sp_offsets: torch.Tensor,
                       inverse: torch.Tensor, valid: torch.Tensor,
                       num_rows: int) -> torch.Tensor:
    """Plain version of K5: (num_rows, C) in g's sum type,
    ``out[v] = sum_{p: inverse[p] = v, valid, seg kept} g[seg[p]] / n``
    with n the count of segment seg[p] from its CSR ``sp_offsets``."""
    seg = seg_ids.long()
    keep = valid & (inverse >= 0) & (seg >= 0) & (seg < num_segments)
    gf = as_sum_type(g)
    gf = gf / segment_counts(sp_offsets, gf.dtype)[:, None]
    return gf.new_zeros(num_rows, g.shape[1]).index_add_(
        0, inverse[keep].long(), gf[seg[keep]])


def segment_grad(g: torch.Tensor, seg_ids: torch.Tensor, num_segments: int,
                 sp_offsets: torch.Tensor, inverse: torch.Tensor,
                 valid: torch.Tensor, vox_csr: SegmentCSR,
                 out_dtype=torch.float32) -> torch.Tensor:
    """Transpose of the fused pooling's gather: (V, C) in ``out_dtype``,
    ``out[v] = sum of g[seg[p]] / n`` over the valid points p of voxel v
    whose segment is kept, each quotient in fp32, summed in fp32 in
    ascending point order; n is the count of segment seg[p] (at least 1)
    from the segments' CSR offsets ``sp_offsets`` (S + 1,) int64.
    ``vox_csr = segment_csr(inverse, V, valid)``, the voxel CSR of the
    forward's voxel mean, gives V and each voxel's points.  On the card
    ``g`` (S, C) is read where it lies (any row stride, unit column
    stride, fp32), so a column slice of the pool's gradient costs no
    copy: one launch."""
    num_rows = vox_csr[0].shape[0] - 1
    if g.device.type == "cpu":
        return segment_grad_plain(g, seg_ids, num_segments, sp_offsets,
                                  inverse, valid, num_rows).to(out_dtype)
    offsets, members = vox_csr[0], vox_csr[1]
    seg = seg_ids if seg_ids.dtype == torch.int32 else \
        seg_ids.to(torch.int32)
    gf = g if g.dtype == torch.float32 else g.float()
    if gf.dim() != 2 or gf.stride(1) != 1:
        gf = gf.contiguous()
    for t in (offsets, members, seg, gf, sp_offsets):
        if t.device.type != "cuda" or (t.dim() == 1 and not t.is_contiguous()):
            raise ValueError("segment_grad: tensors must be contiguous and "
                             "on one CUDA device")
    if members.shape[0] > seg.shape[0] or offsets.dtype != torch.int64:
        raise ValueError("segment_grad: vox_csr does not index these points")
    if gf.shape[0] < num_segments or sp_offsets.dtype != torch.int64 \
            or sp_offsets.shape != (num_segments + 1,):
        raise ValueError("segment_grad: g or sp_offsets does not hold the "
                         f"{num_segments} segments")
    out = torch.empty(num_rows, g.shape[1], dtype=out_dtype, device=g.device)
    lib = cuda_build.library("segment_grad")
    cuda_build.check(lib.segment_grad(
        offsets.data_ptr(), members.data_ptr(), seg.data_ptr(), gf.data_ptr(),
        gf.stride(0), sp_offsets.data_ptr(),
        out.data_ptr(), num_rows, num_segments, g.shape[1],
        cuda_build.dtype_code(out_dtype), cuda_build.stream_ptr(g)),
        "segment_grad")
    segment_grad.launches += 1
    return out


segment_grad.launches = 0


class _PoolGathered(torch.autograd.Function):
    """Segment means of ``[vox[inverse[p]] | d_0[p] | ...]`` (K3); the
    gradient reaches ``vox`` only (K5, the whole backward in one launch)."""

    @staticmethod
    def forward(ctx, vox, inverse, d, seg_ids, num_segments, valid,
                vox_offsets, vox_members):
        csr = segment_csr(seg_ids, num_segments, valid)
        ctx.save_for_backward(inverse, seg_ids, valid, csr[0], vox_offsets,
                              vox_members)
        ctx.num_segments = num_segments
        ctx.vox_cols_dtype = (vox.shape[1], vox.dtype)
        return segment_mean_gather(seg_ids, num_segments, valid, g=vox,
                                   gather_idx=inverse, d=d, csr=csr)

    @staticmethod
    def backward(ctx, dmeans):
        inverse, seg_ids, valid, offsets, vox_offsets, vox_members = \
            ctx.saved_tensors
        cg, dtype = ctx.vox_cols_dtype
        dvox = None
        if ctx.needs_input_grad[0]:
            dvox = segment_grad(dmeans[:, :cg], seg_ids, ctx.num_segments,
                                offsets, inverse, valid,
                                (vox_offsets, vox_members), dtype)
        return dvox, None, None, None, None, None, None, None


def pool_gathered(vox: torch.Tensor, inverse: torch.Tensor,
                  extra: Sequence[torch.Tensor], seg_ids: torch.Tensor,
                  num_segments: int, valid: torch.Tensor,
                  vox_csr: Optional[SegmentCSR] = None
                  ) -> List[torch.Tensor]:
    """Fused ``devoxelize`` + ``segment_mean_stack``: segment means of
    ``vox[inverse[p]]`` (voxel -> point unpooling) and of each ``extra``
    point array, in one kernel launch that reads each where it lies.
    Differentiable in ``vox``; the backward walks ``vox_csr =
    segment_csr(inverse, V, valid)`` (built here when the caller has
    none)."""
    if any(x.requires_grad for x in extra):
        raise RuntimeError("pool_gathered: only the voxel features take a "
                           "gradient")
    if vox_csr is None:
        vox_csr = segment_csr(inverse, vox.shape[0], valid)
    means = _PoolGathered.apply(vox, inverse, list(extra), seg_ids,
                                num_segments, valid, vox_csr[0], vox_csr[1])
    return _split(means, [vox, *extra])


def _split(means: torch.Tensor, xs: Sequence[torch.Tensor]
           ) -> List[torch.Tensor]:
    outs, col = [], 0
    for x in xs:
        w = x.shape[1]
        outs.append(means[:, col:col + w].to(x.dtype))
        col += w
    return outs
