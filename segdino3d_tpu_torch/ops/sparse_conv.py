"""Sparse 3D convolutions over host-built index tables (gather layout).

Counterpart of ``segdino3d_tpu/ops/sparse_conv.py``.  Every convolution of
the Res16UNet34C, forward and backward, is one of three hand-written CUDA
kernels:

* ``gather_conv`` (K1, ``csrc/gather_gemm_conv.cu``):
  ``out[i] = sum_o x[nbr[o, i]] @ W[o]`` for any offset count.  It runs the
  submanifold convs (27 offsets), the k5 stem (125 offsets) and the stride-2
  down convs, whose (8, V_coarse) child table ``child[kpos, parent] = fine``
  (``ops.host_plan``) turns the TPU version's scatter into a gather;
* ``up_conv_rows`` (K2, ``csrc/up_conv.cu``):
  ``fine[i] = x[parent[i]] @ W[kpos[i]]``;
* ``gather_wgrad`` (K4, ``csrc/gather_wgrad.cu``): the weight gradients,
  ``dW[o] = sum_r A[ia[o, r]]^T @ B[ib[o, r]]``.

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
"""
from __future__ import annotations

import itertools
from typing import Optional

import numpy as np
import torch

from segdino3d_tpu_torch.ops import cuda_build


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


def gather_conv(feats: torch.Tensor, nbr: torch.Tensor, weights: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """``out[i] = sum_o feats[nbr[o, i]] @ weights[o]``, 0 on invalid rows.

    feats (V_in, Cin); nbr (n_off, V) int32, -1 = absent; weights
    (n_off, Cin, Cout) in feats' dtype; valid (V,) bool.  Returns (V, Cout)
    in feats' dtype, summed in fp32."""
    n_off, cin, cout = weights.shape
    if nbr.shape[0] != n_off or feats.shape[1] != cin:
        raise ValueError(f"gather_conv: nbr {tuple(nbr.shape)}, feats "
                         f"{tuple(feats.shape)}, weights {tuple(weights.shape)}")
    if feats.device.type == "cpu":
        return gather_conv_plain(feats, nbr, weights, valid)
    _require_cuda("gather_conv", feats, nbr, weights, valid)
    if weights.dtype != feats.dtype or nbr.dtype != torch.int32 \
            or valid.dtype != torch.bool:
        raise TypeError("gather_conv: weights must match feats' dtype, nbr "
                        "must be int32 and valid bool")
    v = nbr.shape[1]
    out = torch.empty(v, cout, dtype=feats.dtype, device=feats.device)
    lib = cuda_build.library("gather_gemm_conv")
    cuda_build.check(lib.gather_gemm_conv(
        feats.data_ptr(), nbr.data_ptr(), weights.data_ptr(),
        valid.data_ptr(), out.data_ptr(), v, cin, cout, n_off,
        cuda_build.dtype_code(feats.dtype), cuda_build.stream_ptr(feats)),
        "gather_gemm_conv")
    gather_conv.launches += 1
    return out


gather_conv.launches = 0


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


def up_conv_rows(feats: torch.Tensor, parent: torch.Tensor,
                 kpos: torch.Tensor, order: torch.Tensor,
                 weights: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """``fine[i] = feats[parent[i]] @ weights[kpos[i]]``, 0 where invalid.

    ``order`` is a permutation of the fine rows grouped by ``kpos``
    (``ops.host_plan``); the kernel walks rows in that order."""
    cin, cout = weights.shape[1:]
    if weights.shape[0] != 8 or feats.shape[1] != cin:
        raise ValueError(f"up_conv: feats {tuple(feats.shape)}, weights "
                         f"{tuple(weights.shape)}")
    if feats.device.type == "cpu":
        return up_conv_plain(feats, parent, kpos, weights, valid)
    _require_cuda("up_conv", feats, parent, kpos, order, weights, valid)
    if weights.dtype != feats.dtype or valid.dtype != torch.bool or any(
            t.dtype != torch.int32 for t in (parent, kpos, order)):
        raise TypeError("up_conv: weights must match feats' dtype, index "
                        "tables must be int32 and valid bool")
    v = parent.shape[0]
    out = torch.empty(v, cout, dtype=feats.dtype, device=feats.device)
    lib = cuda_build.library("up_conv")
    cuda_build.check(lib.up_conv(
        feats.data_ptr(), parent.data_ptr(), kpos.data_ptr(),
        order.data_ptr(), weights.data_ptr(), valid.data_ptr(),
        out.data_ptr(), v, cin, cout, cuda_build.dtype_code(feats.dtype),
        cuda_build.stream_ptr(feats)), "up_conv")
    up_conv_rows.launches += 1
    return out


up_conv_rows.launches = 0


# the weight gradient's split scratch: at most this many bytes, and splits
# of at least this many table rows
WGRAD_SCRATCH_BYTES = 64 << 20
WGRAD_ROWS_PER_SPLIT = 2048


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


def gather_wgrad(a: torch.Tensor, ia: Optional[torch.Tensor], b: torch.Tensor,
                 ib: Optional[torch.Tensor], mirror: bool = False
                 ) -> torch.Tensor:
    """``dW[o] = sum_r a[ia[o, r]]^T @ b[ib[o, r]]`` as (n_off, Cin, Cout)
    fp32; ``mirror`` stores offset o's sum at ``n_off - 1 - o``.

    a (rows_a, Cin) and b (rows_b, Cout) share one dtype; ia, ib (n_off, R)
    int32 index tables, -1 = no row, at least one of them given; an absent
    table is the identity over the first R rows."""
    table = ia if ia is not None else ib
    if table is None:
        raise ValueError("gather_wgrad needs ia or ib")
    n_off, rows = table.shape
    for t in (ia, ib):
        if t is not None and tuple(t.shape) != (n_off, rows):
            raise ValueError(f"gather_wgrad: index tables {tuple(t.shape)} "
                             f"and {(n_off, rows)} differ")
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
    per_split = n_off * cin * cout * 4
    splits = max(1, min(-(-rows // WGRAD_ROWS_PER_SPLIT),
                        WGRAD_SCRATCH_BYTES // max(per_split, 1)))
    out = torch.empty(n_off, cin, cout, dtype=torch.float32, device=a.device)
    partial = out if splits == 1 else torch.empty(
        splits, n_off, cin, cout, dtype=torch.float32, device=a.device)
    lib = cuda_build.library("gather_wgrad")
    cuda_build.check(lib.gather_wgrad(
        a.data_ptr(), None if ia is None else ia.data_ptr(), b.data_ptr(),
        None if ib is None else ib.data_ptr(), partial.data_ptr(),
        out.data_ptr(), rows, cin, cout, n_off, splits, int(mirror),
        cuda_build.dtype_code(a.dtype), cuda_build.stream_ptr(a)),
        "gather_wgrad")
    gather_wgrad.launches += 1
    return out


gather_wgrad.launches = 0


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
            dx = gather_conv(dy, nbr, _transposed(weights.flip(0)), valid)
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
    def forward(ctx, feats, child, weights, coarse_valid, parent, kpos, order,
                fine_valid):
        ctx.save_for_backward(feats, child, weights, coarse_valid, parent,
                              kpos, order, fine_valid)
        return gather_conv(feats, child, weights, coarse_valid)

    @staticmethod
    def backward(ctx, dout):
        (feats, child, weights, coarse_valid, parent, kpos, order,
         fine_valid) = ctx.saved_tensors
        dy = _masked(dout, coarse_valid, feats.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = up_conv_rows(dy, parent, kpos, order, _transposed(weights),
                              fine_valid)
        if ctx.needs_input_grad[2]:
            dw = gather_wgrad(feats, child, dy, None).to(weights.dtype)
        return dx, None, dw, None, None, None, None, None


class _UpConv(torch.autograd.Function):
    """``fine[i] = x[parent[i]] @ W[kpos[i]]``; dX is the gather conv of dF
    over the child table with transposed weights (K1), dW gathers dF
    through the child table (K4).  The child table holds exactly the live
    fine rows, so dF needs no mask."""

    @staticmethod
    def forward(ctx, feats, parent, kpos, order, weights, valid, child):
        ctx.save_for_backward(feats, weights, child)
        return up_conv_rows(feats, parent, kpos, order, weights, valid)

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
        return dx, None, None, None, dw, None, None


def subm_conv(feats, nbr, weights, valid):
    """Submanifold convolution: output coordinates == input coordinates."""
    return _SubmConv.apply(feats, nbr, weights, valid)


def down_conv(feats, fine, coarse, weights):
    """Strided conv k=2 s=2: ``coarse[j] = sum_k W[k] fine[child[k, j]]``.

    ``fine.child`` is the (8, V_coarse) child table of the fine level."""
    return _DownConv.apply(feats, fine.child, weights, coarse.valid,
                           fine.parent, fine.kpos, fine.up_order, fine.valid)


def up_conv(feats, fine, weights):
    """Transposed conv k=2 s=2 restoring the fine coordinate set."""
    return _UpConv.apply(feats, fine.parent, fine.kpos, fine.up_order,
                         weights, fine.valid, fine.child)
