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

``CompactStemCtx`` runs only the k5 stem, on the degree-compacted tables
(inference only: ``SC.stem_compact_conv``, K12).
"""
from __future__ import annotations

import weakref

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


class CompactStemCtx:
    """The degree-compacted stem (``SC.stem_compact_conv``): one wide
    matmul, then K12 sums each voxel's slot and overflow rows."""

    def __init__(self, slots: torch.Tensor, ov_src: torch.Tensor,
                 ov_dst: torch.Tensor, valid: torch.Tensor):
        self.slots = slots
        self.ov_src = ov_src
        self.ov_dst = ov_dst
        self.valid = valid

    def subm(self, feats, w):
        return SC.stem_compact_conv(feats, w, self.slots, self.ov_src,
                                    self.ov_dst, self.valid)

    def enter(self, x):
        return x

    def exit(self, x):
        return x


class DenseCtx:
    """Block-dense execution: features live as (B*edge^3, C) flat rows;
    ``valid`` is the occupied-cell mask (K9 at the boundaries, K10 and K11
    in the convs).  A conv whose input is the tensor ``enter`` returned
    (the dense stem's) states that it is zero outside the occupancy
    (``scatter_to_dense`` writes 0 at every empty cell), which lets K10
    and K11 skip its unoccupied sources; every other conv's input has
    passed a norm or an activation and states nothing."""

    def __init__(self, tables: BD.BlockTables):
        self.tables = tables
        self.valid = BD.occupancy(tables)
        self._entered = None   # a weak reference to enter's last output

    def subm(self, feats, w):
        entered = self._entered is not None and self._entered() is feats
        return BD.dense_subm_conv(feats, self.valid, self.tables, w,
                                  zero_outside=entered)

    def enter(self, x):
        out = BD.scatter_to_dense(x, self.tables)
        self._entered = weakref.ref(out)
        return out

    def exit(self, x):
        return BD.gather_from_dense(x, self.tables)
