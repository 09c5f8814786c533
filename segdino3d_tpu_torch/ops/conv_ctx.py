"""Submanifold-conv execution contexts: gather layout vs block-dense.

Counterpart of ``segdino3d_tpu/ops/conv_ctx.py``.  A context holds one
level's tables and validity mask and gives the U-Net the same four
members whichever layout the level runs, so the parameters are the same
for both:

* ``subm(feats, w)``: submanifold conv with canonical (k^3, Cin, Cout)
  weights;
* ``enter(x)`` / ``exit(x)``: the stage-boundary layout conversion
  (identity in the gather layout; voxel rows <-> dense rows, kernel K9, in
  the block-dense one);
* ``valid``: the row-validity mask in the context's layout (batch norms
  and output masks).

The JAX package's ``CompactStemCtx`` is not ported yet.
"""
from __future__ import annotations

import torch

from segdino3d_tpu_torch.ops import block_dense as BD
from segdino3d_tpu_torch.ops import sparse_conv as SC


class GatherCtx:
    """Gather-GEMM execution over a (n_off, V) neighbour table (K1)."""

    def __init__(self, nbr: torch.Tensor, valid: torch.Tensor):
        self.nbr = nbr
        self.valid = valid

    def subm(self, feats, w):
        return SC.subm_conv(feats, self.nbr, w, self.valid)

    def enter(self, x):
        return x

    def exit(self, x):
        return x


class DenseCtx:
    """Block-dense execution: features live as (B*edge^3, C) flat rows;
    ``valid`` is the occupied-cell mask (K9 at the boundaries, K10 and K11
    in the convs)."""

    def __init__(self, tables: BD.BlockTables):
        self.tables = tables
        self.valid = BD.occupancy(tables)

    def subm(self, feats, w):
        return BD.dense_subm_conv(feats, self.valid, self.tables, w)

    def enter(self, x):
        return BD.scatter_to_dense(x, self.tables)

    def exit(self, x):
        return BD.gather_from_dense(x, self.tables)
