"""Deterministic segment means (K3, ``csrc/segment_mean_gather.cu``) and
the pooling's gradient (K5, ``csrc/segment_grad.cu``).

Counterpart of ``segdino3d_tpu/ops/scatter.py:segment_mean`` and
``segment_mean_stack``; with ``gather_idx`` it also fuses
``ops/voxelize.py:devoxelize`` into the pooling, so voxel features are
averaged over the points of a segment without building the per-point
tensor.

Segments are built as CSR over a stable sort of the segment ids
(``segment_csr``) and cut into chunks of at most ``CHUNK`` members
(``chunk_offsets``); the kernel sums chunks, then each segment's chunk
sums, in one fixed order, with no atomics.  For a CPU tensor the wrapper
runs ``segment_mean_gather_plain``.

``pool_gathered`` is differentiable in the voxel features only (the
coordinates pooled beside them are data): its backward, ``segment_grad``,
walks the voxel CSR of the forward's voxel mean, so each voxel adds its
points' superpoint gradients in one fixed order.  The voxel mean itself
pools input data and raises if asked for a gradient.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from segdino3d_tpu_torch.ops import cuda_build
from segdino3d_tpu_torch.ops.sparse_conv import as_sum_type

CHUNK = 32   # members per block in the kernel's first pass


def _kept_ids(seg_ids: torch.Tensor, num_segments: int,
              valid: Optional[torch.Tensor]) -> torch.Tensor:
    """int64 segment ids with invalid rows and ids outside [0, S) moved to
    the dropped slot S."""
    seg = seg_ids.long()
    keep = (seg >= 0) & (seg < num_segments)
    if valid is not None:
        keep = keep & valid
    return torch.where(keep, seg, num_segments)


def segment_csr(seg_ids: torch.Tensor, num_segments: int,
                valid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(offsets (S+1,) int64, members int64): the ids of rows in segment s
    are ``members[offsets[s]:offsets[s+1]]`` in ascending row order.  Rows
    that are invalid or whose id lies outside [0, S) belong to no segment.
    Nothing here waits for the device."""
    sorted_seg, members = torch.sort(
        _kept_ids(seg_ids, num_segments, valid), stable=True)
    offsets = torch.searchsorted(
        sorted_seg, torch.arange(num_segments + 1, device=seg_ids.device))
    return offsets, members


def chunk_offsets(offsets: torch.Tensor, chunk: int = CHUNK) -> torch.Tensor:
    """(S+1,) int64: segment s owns chunks ``[c[s], c[s+1])`` of at most
    ``chunk`` members each, in member order."""
    n_chunks = (offsets[1:] - offsets[:-1] + chunk - 1) // chunk
    out = torch.zeros_like(offsets)
    out[1:] = torch.cumsum(n_chunks, 0)
    return out


def segment_mean_gather_plain(seg_ids: torch.Tensor, num_segments: int,
                              valid: Optional[torch.Tensor],
                              g: Optional[torch.Tensor] = None,
                              gather_idx: Optional[torch.Tensor] = None,
                              d: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Plain version of K3: (S, cg + cd) fp32 means."""
    cols = []
    if g is not None:
        gf = as_sum_type(g)
        if gather_idx is not None:
            gf = torch.cat([gf, gf.new_zeros(1, gf.shape[1])])[
                torch.where(gather_idx < 0, g.shape[0], gather_idx).long()]
        cols.append(gf)
    if d is not None:
        cols.append(as_sum_type(d))
    x = torch.cat(cols, dim=1)
    seg = _kept_ids(seg_ids, num_segments, valid)
    sums = x.new_zeros(num_segments + 1, x.shape[1]).index_add_(0, seg, x)
    cnts = torch.bincount(seg, minlength=num_segments + 1).to(x.dtype)
    return (sums / cnts.clamp(min=1.0)[:, None])[:num_segments]


def segment_mean_gather(seg_ids: torch.Tensor, num_segments: int,
                        valid: Optional[torch.Tensor] = None,
                        g: Optional[torch.Tensor] = None,
                        gather_idx: Optional[torch.Tensor] = None,
                        d: Optional[torch.Tensor] = None,
                        csr: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                        ) -> torch.Tensor:
    """Per-segment means of ``[g[gather_idx[p]] | d[p]]`` over the valid
    rows p of each segment, as (S, cg + cd) fp32; empty segments give 0.

    ``g`` (Vg, cg) is read through ``gather_idx`` (N,) (-1 = zero row; the
    identity when absent), ``d`` (N, cd) directly.  Either may be None.
    ``csr`` is ``segment_csr(seg_ids, num_segments, valid)`` where the
    caller already has it.  Not differentiable: raises if ``g`` or ``d``
    requires a gradient."""
    if g is None and d is None:
        raise ValueError("segment_mean_gather needs g or d")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (g, d)):
        raise RuntimeError("segment_mean_gather has no gradient: pool data, "
                           "or call pool_gathered for voxel features")
    ref = g if g is not None else d
    if ref.device.type == "cpu":
        return segment_mean_gather_plain(seg_ids, num_segments, valid, g,
                                         gather_idx, d)
    present = [t for t in (seg_ids, valid, g, gather_idx, d) if t is not None]
    for t in present:
        if t.device.type != "cuda" or not t.is_contiguous():
            raise ValueError("segment_mean_gather: tensors must be "
                             "contiguous and on one CUDA device")
    if gather_idx is not None and gather_idx.dtype != torch.int32:
        raise TypeError("segment_mean_gather: gather_idx must be int32")
    offsets, members = csr if csr is not None else segment_csr(
        seg_ids, num_segments, valid)
    coff = chunk_offsets(offsets)
    # an upper bound on the chunk count, known without waiting for the card
    max_chunks = num_segments + seg_ids.shape[0] // CHUNK
    cg = 0 if g is None else g.shape[1]
    cd = 0 if d is None else d.shape[1]
    out = torch.empty(num_segments, cg + cd, dtype=torch.float32,
                      device=ref.device)
    partial = torch.empty(max_chunks, cg + cd, dtype=torch.float32,
                          device=ref.device)
    lib = cuda_build.library("segment_mean_gather")
    cuda_build.check(lib.segment_mean_gather(
        offsets.data_ptr(), members.data_ptr(), coff.data_ptr(), max_chunks,
        CHUNK, None if g is None else g.data_ptr(),
        None if gather_idx is None else gather_idx.data_ptr(),
        None if d is None else d.data_ptr(), partial.data_ptr(),
        out.data_ptr(), num_segments, cg, cd,
        0 if g is None else cuda_build.dtype_code(g.dtype),
        0 if d is None else cuda_build.dtype_code(d.dtype),
        cuda_build.stream_ptr(ref)), "segment_mean_gather")
    segment_mean_gather.launches += 1
    return out


segment_mean_gather.launches = 0


def segment_mean(x: torch.Tensor, seg_ids: torch.Tensor, num_segments: int,
                 valid: Optional[torch.Tensor] = None,
                 csr: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                 ) -> torch.Tensor:
    """Mean of rows of ``x`` grouped by ``seg_ids`` (scatter_mean parity);
    ids outside [0, num_segments) and invalid rows are dropped."""
    return segment_mean_gather(seg_ids, num_segments, valid, d=x,
                               csr=csr).to(x.dtype)


def segment_mean_stack(xs: Sequence[torch.Tensor], seg_ids: torch.Tensor,
                       num_segments: int,
                       valid: Optional[torch.Tensor] = None
                       ) -> List[torch.Tensor]:
    """Means of several row-aligned arrays over one set of segment ids, in
    one kernel launch; each result keeps its input's dtype."""
    d = torch.cat([x.float() for x in xs], dim=1)
    means = segment_mean_gather(seg_ids, num_segments, valid, d=d)
    return _split(means, xs)


def segment_grad_plain(g: torch.Tensor, seg_ids: torch.Tensor,
                       num_segments: int, inverse: torch.Tensor,
                       valid: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Plain version of K5: (num_rows, C) fp32,
    ``out[v] = sum_{p: inverse[p] = v, valid, seg kept} g[seg[p]]``."""
    seg = seg_ids.long()
    keep = valid & (inverse >= 0) & (seg >= 0) & (seg < num_segments)
    gf = as_sum_type(g)
    return gf.new_zeros(num_rows, g.shape[1]).index_add_(
        0, inverse[keep].long(), gf[seg[keep]])


def segment_grad(g: torch.Tensor, seg_ids: torch.Tensor, num_segments: int,
                 inverse: torch.Tensor, valid: torch.Tensor,
                 vox_csr: Tuple[torch.Tensor, torch.Tensor],
                 out_dtype=torch.float32) -> torch.Tensor:
    """Transpose of the fused pooling's gather: (V, C) in ``out_dtype``,
    ``out[v] = sum of g[seg[p]]`` over the valid points p of voxel v whose
    segment is kept, summed in fp32 in ascending point order.
    ``vox_csr = segment_csr(inverse, V, valid)``, the voxel CSR of the
    forward's voxel mean, gives V and each voxel's points."""
    num_rows = vox_csr[0].shape[0] - 1
    if g.device.type == "cpu":
        return segment_grad_plain(g, seg_ids, num_segments, inverse, valid,
                                  num_rows).to(out_dtype)
    offsets, members = vox_csr
    seg = seg_ids.to(torch.int32).contiguous()
    gf = g.float().contiguous()
    for t in (offsets, members, seg, gf):
        if t.device.type != "cuda" or not t.is_contiguous():
            raise ValueError("segment_grad: tensors must be contiguous and "
                             "on one CUDA device")
    if members.shape[0] > seg.shape[0] or offsets.dtype != torch.int64:
        raise ValueError("segment_grad: vox_csr does not index these points")
    out = torch.empty(num_rows, g.shape[1], dtype=out_dtype, device=g.device)
    lib = cuda_build.library("segment_grad")
    cuda_build.check(lib.segment_grad(
        offsets.data_ptr(), members.data_ptr(), seg.data_ptr(), gf.data_ptr(),
        out.data_ptr(), num_rows, num_segments, g.shape[1],
        cuda_build.dtype_code(out_dtype), cuda_build.stream_ptr(g)),
        "segment_grad")
    segment_grad.launches += 1
    return out


segment_grad.launches = 0


class _PoolGathered(torch.autograd.Function):
    """Segment means of ``[vox[inverse[p]] | d[p]]`` (K3); the gradient
    reaches ``vox`` only (K5)."""

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
            g = as_sum_type(dmeans[:, :cg])
            cnt = (offsets[1:] - offsets[:-1]).clamp(min=1).to(g.dtype)
            dvox = segment_grad(g / cnt[:, None], seg_ids, ctx.num_segments,
                                inverse, valid, (vox_offsets, vox_members),
                                dtype)
        return dvox, None, None, None, None, None, None, None


def pool_gathered(vox: torch.Tensor, inverse: torch.Tensor,
                  extra: Sequence[torch.Tensor], seg_ids: torch.Tensor,
                  num_segments: int, valid: torch.Tensor,
                  vox_csr: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                  ) -> List[torch.Tensor]:
    """Fused ``devoxelize`` + ``segment_mean_stack``: segment means of
    ``vox[inverse[p]]`` (voxel -> point unpooling) and of each ``extra``
    point array, in one kernel launch.  Differentiable in ``vox``; the
    backward walks ``vox_csr = segment_csr(inverse, V, valid)`` (built
    here when the caller has none)."""
    if any(x.requires_grad for x in extra):
        raise RuntimeError("pool_gathered: only the voxel features take a "
                           "gradient")
    if vox_csr is None:
        vox_csr = segment_csr(inverse, vox.shape[0], valid)
    d = torch.cat([as_sum_type(x) for x in extra], dim=1) if extra else None
    means = _PoolGathered.apply(vox, inverse, d, seg_ids, num_segments, valid,
                                *vox_csr)
    return _split(means, [vox, *extra])


def _split(means: torch.Tensor, xs: Sequence[torch.Tensor]
           ) -> List[torch.Tensor]:
    outs, col = [], 0
    for x in xs:
        w = x.shape[1]
        outs.append(means[:, col:col + w].to(x.dtype))
        col += w
    return outs
