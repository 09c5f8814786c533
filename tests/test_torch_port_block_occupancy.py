"""The occupied-row list and the k-dilation that the block conv (K10) runs on.

K10 computes only the rows of its output mask: in the forward the
occupancy, in the input gradient's role the occupancy's k-dilation, outside
which that gradient is zero.  Here the port's plain helpers are held to
their definitions and to the JAX package's ``block_dense.occupancy`` and
``halo_pad`` on the host plans of ``test_torch_port_block_dense.py``, for
block edges 4 and 8 and kernel sizes 3 and 5; and the plain versions show
that the dX role is zero outside the dilation, so masking it there is
exact.  Everything compared here is exact (masks, row ids, and a conv
compared with itself).
"""
import functools
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from test_torch_port_jaxlib import load_jax_sparseplan  # noqa: E402

from segdino3d_tpu.ops import block_dense as JBD  # noqa: E402
from segdino3d_tpu_torch.ops import block_dense as TBD  # noqa: E402
from segdino3d_tpu_torch.ops.sparse_conv import _transposed  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _setup():
    load_jax_sparseplan()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _level(edge):
    """(port BlockTables, JAX occupancy as numpy, JAX block_nbr) of level 0
    of ``test_torch_port_block_dense.py``'s scene with blocks of ``edge``."""
    from test_torch_port_block_dense import _tables

    t, j, jvalid = _tables(edges=(edge,) * 5)
    return t, np.asarray(JBD.occupancy(j, jvalid)), j.block_nbr


def _jax_dilation(jocc, jnbr, edge, k):
    """The definition on the JAX side: a cell is in the k-dilation when the
    k^3 window around it in JAX's halo-padded block holds an occupied cell."""
    b = jnbr.shape[1]
    blocks = jnp.asarray(jocc.reshape(b, edge, edge, edge, 1)
                         .astype(np.float32))
    padded = np.asarray(JBD.halo_pad(blocks, jnbr, (k - 1) // 2))[..., 0]
    win = np.lib.stride_tricks.sliding_window_view(padded, (k, k, k),
                                                   axis=(1, 2, 3))
    return win.any(axis=(-3, -2, -1)).reshape(-1)


@pytest.mark.parametrize("edge", [4, 8])
def test_occupied_rows_follow_jax_occupancy(edge):
    """The row list is JAX's occupied cells in ascending order, which is
    block-major, -1 past the count, at the capacity of the level's rows."""
    t, jocc, _ = _level(edge)
    occ = TBD.occupancy(t)
    np.testing.assert_array_equal(occ.numpy(), jocc)
    rows, count = TBD.occupied_rows_plain(occ)
    want = np.flatnonzero(jocc)
    assert rows.shape == occ.shape and rows.dtype == torch.int32
    assert int(count) == len(want) == int(jocc.sum())
    np.testing.assert_array_equal(rows[:len(want)].numpy(), want)
    assert (rows[len(want):] == -1).all()
    blocks = rows[:len(want)] // edge ** 3
    assert bool((blocks[1:] >= blocks[:-1]).all())
    got, got_count = TBD.occupied_rows(occ)       # the CPU branch
    assert torch.equal(got, rows) and int(got_count) == len(want)


@pytest.mark.parametrize("edge", [4, 8])
@pytest.mark.parametrize("k", [3, 5])
def test_dilation_matches_its_definition_and_jax(edge, k):
    """The plain dilation against JAX's halo padding of JAX's occupancy,
    and against a cell-by-cell walk of the shell-neighbour table."""
    t, jocc, jnbr = _level(edge)
    occ = TBD.occupancy(t)
    got = TBD.occupancy_dilation_plain(occ, t.block_nbr, edge, k)
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_dilation(jocc, jnbr, edge, k))
    assert bool((got | ~occ).all()) and not bool(got.all())
    # the definition, for a sample of cells: some offset's source exists
    # and is occupied
    nbr, h = t.block_nbr.numpy(), (k - 1) // 2
    dirs = TBD._shell_dirs()
    rng = np.random.RandomState(edge * 10 + k)
    for row in rng.choice(occ.shape[0], 300, replace=False):
        b, c = divmod(int(row), edge ** 3)
        cell = np.array([c // edge ** 2, (c // edge) % edge, c % edge])
        hit = False
        for off in np.ndindex(k, k, k):
            q = cell + np.array(off) - h
            d = tuple(int(v) for v in np.where(q < 0, -1,
                                               np.where(q >= edge, 1, 0)))
            src = b if d == (0, 0, 0) else nbr[dirs.index(d), b]
            if src >= 0:
                lx, ly, lz = q - np.array(d) * edge
                hit |= bool(occ[((src * edge + lx) * edge + ly) * edge + lz])
        assert hit == bool(got[row]), (edge, k, row)
    assert torch.equal(TBD.dilated_rows(occ, t.block_nbr, edge, k)[0],
                       got)                       # the CPU branch


@pytest.mark.parametrize("edge", [4, 8])
@pytest.mark.parametrize("k", [3, 5])
def test_dx_role_is_zero_outside_the_dilation(edge, k):
    """The input gradient's conv (flipped, transposed weights on a
    cotangent masked to the occupancy) is zero outside the dilation, and
    computing it under the dilation gives the unmasked result exactly."""
    t, _, _ = _level(edge)
    occ = TBD.occupancy(t)
    dil = TBD.occupancy_dilation_plain(occ, t.block_nbr, edge, k)
    rng = np.random.RandomState(21)
    dy = torch.where(occ[:, None], torch.from_numpy(
        rng.randn(occ.shape[0], 6).astype(np.float32)), 0.0)
    w = torch.from_numpy(rng.randn(k ** 3, 5, 6).astype(np.float32))
    wt = _transposed(w.flip(0))
    full = TBD.dense_subm_conv_plain(dy, t.block_nbr, wt, None, edge)
    assert not full[~dil].any()
    assert bool((full[dil] != 0).any(1).float().mean() > 0.9)
    assert torch.equal(TBD.block_conv(dy, t.block_nbr, wt, dil, edge), full)


def test_backward_builds_one_dilation_per_level_and_size(monkeypatch):
    """``dense_subm_conv``'s backward takes the dilation and its row list
    from its tables: built once for a level's convs of one kernel size, and
    equal to the plain dilation and its occupied rows."""
    t, _, _ = _level(4)
    t.dilations.clear()
    occ = TBD.occupancy(t)
    calls = []
    real = TBD.dilated_rows

    def counted(*args):
        calls.append(args[-1])
        return real(*args)

    monkeypatch.setattr(TBD, "dilated_rows", counted)
    rng = np.random.RandomState(22)
    x = torch.from_numpy(rng.randn(occ.shape[0], 4).astype(np.float32))
    x = torch.where(occ[:, None], x, 0.0).requires_grad_()
    w3 = [torch.from_numpy(rng.randn(27, 4, 4).astype(np.float32) * 0.2)
          .requires_grad_() for _ in range(2)]
    y = x
    for w in w3:
        y = TBD.dense_subm_conv(y, occ, t, w)
    y.sum().backward()
    assert calls == [3]
    want = TBD.occupancy_dilation_plain(occ, t.block_nbr, 4, 3)
    np.testing.assert_array_equal(t.dilations[3][1].numpy(), want.numpy())
    rows, count = TBD.occupied_rows_plain(want)
    assert torch.equal(t.dilations[3][2].rows, rows)
    assert int(t.dilations[3][2].count) == int(count)
    assert x.grad is not None and w3[0].grad is not None
    t.dilations.clear()
