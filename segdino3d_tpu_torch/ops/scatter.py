"""Deterministic segment means (K3, ``csrc/segment_mean_gather.cu``).

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
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from segdino3d_tpu_torch.ops import cuda_build

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
        gf = g.float()
        if gather_idx is not None:
            gf = torch.cat([gf, gf.new_zeros(1, gf.shape[1])])[
                torch.where(gather_idx < 0, g.shape[0], gather_idx).long()]
        cols.append(gf)
    if d is not None:
        cols.append(d.float())
    x = torch.cat(cols, dim=1)
    seg = _kept_ids(seg_ids, num_segments, valid)
    sums = x.new_zeros(num_segments + 1, x.shape[1]).index_add_(0, seg, x)
    cnts = torch.bincount(seg, minlength=num_segments + 1).to(x.dtype)
    return (sums / cnts.clamp(min=1.0)[:, None])[:num_segments]


def segment_mean_gather(seg_ids: torch.Tensor, num_segments: int,
                        valid: Optional[torch.Tensor] = None,
                        g: Optional[torch.Tensor] = None,
                        gather_idx: Optional[torch.Tensor] = None,
                        d: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-segment means of ``[g[gather_idx[p]] | d[p]]`` over the valid
    rows p of each segment, as (S, cg + cd) fp32; empty segments give 0.

    ``g`` (Vg, cg) is read through ``gather_idx`` (N,) (-1 = zero row; the
    identity when absent), ``d`` (N, cd) directly.  Either may be None."""
    if g is None and d is None:
        raise ValueError("segment_mean_gather needs g or d")
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
    offsets, members = segment_csr(seg_ids, num_segments, valid)
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
                 valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean of rows of ``x`` grouped by ``seg_ids`` (scatter_mean parity);
    ids outside [0, num_segments) and invalid rows are dropped."""
    return segment_mean_gather(seg_ids, num_segments, valid,
                               d=x).to(x.dtype)


def segment_mean_stack(xs: Sequence[torch.Tensor], seg_ids: torch.Tensor,
                       num_segments: int,
                       valid: Optional[torch.Tensor] = None
                       ) -> List[torch.Tensor]:
    """Means of several row-aligned arrays over one set of segment ids, in
    one kernel launch; each result keeps its input's dtype."""
    d = torch.cat([x.float() for x in xs], dim=1)
    means = segment_mean_gather(seg_ids, num_segments, valid, d=d)
    return _split(means, xs)


def pool_gathered(vox: torch.Tensor, inverse: torch.Tensor,
                  extra: Sequence[torch.Tensor], seg_ids: torch.Tensor,
                  num_segments: int, valid: torch.Tensor
                  ) -> List[torch.Tensor]:
    """Fused ``devoxelize`` + ``segment_mean_stack``: segment means of
    ``vox[inverse[p]]`` (voxel -> point unpooling) and of each ``extra``
    point array, in one kernel launch."""
    d = torch.cat([x.float() for x in extra], dim=1) if extra else None
    means = segment_mean_gather(seg_ids, num_segments, valid, g=vox,
                                gather_idx=inverse, d=d)
    return _split(means, [vox, *extra])


def _split(means: torch.Tensor, xs: Sequence[torch.Tensor]
           ) -> List[torch.Tensor]:
    outs, col = [], 0
    for x in xs:
        w = x.shape[1]
        outs.append(means[:, col:col + w].to(x.dtype))
        col += w
    return outs
