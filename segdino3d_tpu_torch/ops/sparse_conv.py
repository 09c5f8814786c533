"""Sparse 3D convolutions over host-built index tables (gather layout).

Counterpart of ``segdino3d_tpu/ops/sparse_conv.py``.  Every convolution of
the Res16UNet34C is one of two hand-written CUDA kernels:

* ``gather_conv`` (K1, ``csrc/gather_gemm_conv.cu``):
  ``out[i] = sum_o x[nbr[o, i]] @ W[o]`` for any offset count.  It runs the
  submanifold convs (27 offsets), the k5 stem (125 offsets) and the stride-2
  down convs, whose (8, V_coarse) child table ``child[kpos, parent] = fine``
  (``ops.host_plan``) turns the TPU version's scatter into a gather;
* ``up_conv_rows`` (K2, ``csrc/up_conv.cu``):
  ``fine[i] = x[parent[i]] @ W[kpos[i]]``.

Each wrapper launches its kernel for a CUDA tensor and counts the launch in
its ``launches`` attribute; for a CPU tensor it runs the plain PyTorch
version beside it (``*_plain``), which the CPU tests hold against the JAX
package and ``chip_smoke.py`` holds the kernel against on the card.
Kernel offsets follow the canonical ``itertools.product`` order.
"""
from __future__ import annotations

import itertools

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
    wf = weights.float()
    acc = feats.new_zeros(nbr.shape[1], weights.shape[2], dtype=torch.float32)
    xf = feats.float()
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
    g = _gather_rows(feats.float(), torch.where(live, parent, -1))
    out = g.new_zeros(g.shape[0], weights.shape[2])
    for o in range(8):
        sel = (live & (kpos == o))[:, None]
        out += torch.where(sel, g @ weights[o].float(), 0.0)
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


def subm_conv(feats, nbr, weights, valid):
    """Submanifold convolution: output coordinates == input coordinates."""
    return gather_conv(feats, nbr, weights, valid)


def down_conv(feats, fine, coarse, weights):
    """Strided conv k=2 s=2: ``coarse[j] = sum_k W[k] fine[child[k, j]]``.

    ``fine.child`` is the (8, V_coarse) child table of the fine level."""
    return gather_conv(feats, fine.child, weights, coarse.valid)


def up_conv(feats, fine, weights):
    """Transposed conv k=2 s=2 restoring the fine coordinate set."""
    return up_conv_rows(feats, fine.parent, fine.kpos, fine.up_order,
                        weights, fine.valid)
