"""The pair lists that the weight-gradient kernels (K4, K11) reduce over.

On the card K4 (``gather_wgrad``) reduces, per offset, only the rows at
which every given index table holds a row (``gather_pairs``, built once per
table set), and K11 (``block_wgrad``) only the level's occupied rows
(``row_list``, built once per level).  Here, on the CPU:

* the plain pair list against its definition on the tables of a small host
  plan and of a small device plan (ascending order, counts, -1 past the
  count; a table on either side; the down and up roles of a child table
  share one list), and the cache that keeps it;
* the cached row list against ``occupied_rows_plain``, one per level;
* the plain reductions over the lists equal to the plain versions over the
  full tables (``gather_wgrad_plain``, ``block_wgrad_plain``);
* with JAX on the CPU, the stem's and a k3 level's dW, and the block conv's
  dW at k3 and k5, through the port's plain path and over the lists,
  against ``jax.vjp`` of ``sparse_conv._subm_conv_impl`` and
  ``block_dense._chunked_conv_cd``.

Tolerance: ``1e-5 x max |reference|`` for dW (the same fp32 products
summed in another order); lists and counts are equal.
"""
import gc
import itertools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from test_torch_port_jaxlib import load_jax_sparseplan  # noqa: E402

from segdino3d_tpu.ops import block_dense as JBD  # noqa: E402
from segdino3d_tpu.ops import host_plan as JH  # noqa: E402
from segdino3d_tpu.ops import sparse_conv as JSC  # noqa: E402
from segdino3d_tpu_torch.models.backbone.res16unet import build_unet_plan  # noqa: E402
from segdino3d_tpu_torch.ops import block_dense as TBD  # noqa: E402
from segdino3d_tpu_torch.ops import host_plan as TH  # noqa: E402
from segdino3d_tpu_torch.ops import sparse_conv as TSC  # noqa: E402
from segdino3d_tpu_torch.ops import voxelize as TV  # noqa: E402

CAPS = [1024, 512, 256, 128, 64]
REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _setup():
    load_jax_sparseplan()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _points(seed, n=900, box=16):
    rng = np.random.RandomState(seed)
    coords = rng.uniform(0, box, (n, 3)).astype(np.float32)
    return coords, np.zeros(n, np.int32), rng.rand(n) > 0.05


def _plan(kind, seed=4):
    coords, bidx, valid = _points(seed)
    if kind == "host":
        return TH.host_plan_to_device(
            TH.build_host_plan(coords, bidx, valid, CAPS), "cpu")
    grid = TV.voxelize(torch.from_numpy(bidx), torch.from_numpy(coords),
                       torch.from_numpy(valid), CAPS[0])
    plan, overflow = build_unet_plan(grid, 5, 5, CAPS)
    assert not bool(overflow)
    return plan


def _tables(plan):
    """(name, ia, ib, a rows, b rows, mirror) of every weight-gradient role
    of a gather-layout step: the stem (mirrored, B gathered), each level's
    k3 table (A gathered), each child table as the down and the up conv."""
    lv = plan.levels
    v = [t.valid.shape[0] for t in lv]
    roles = [("stem", None, plan.stem_nbr, v[0], v[0], True)]
    roles += [(f"subm L{i}", t.nbr, None, v[i], v[i], False)
              for i, t in enumerate(lv)]
    for i, t in enumerate(lv[:-1]):
        roles += [(f"down L{i}", t.child, None, v[i], v[i + 1], False),
                  (f"up L{i}", None, t.child, v[i + 1], v[i], False)]
    return roles


def _defined_lists(ia, ib):
    live = np.ones((ia if ia is not None else ib).shape, bool)
    for t in (ia, ib):
        if t is not None:
            live &= t.numpy() >= 0
    return [np.nonzero(row)[0] for row in live]


@pytest.mark.parametrize("kind", ["host", "device"])
def test_pair_lists_match_their_definition(kind):
    plan = _plan(kind)
    for name, ia, ib, _, _, _ in _tables(plan):
        got = TSC.gather_pairs(ia, ib)        # the CPU branch: plain
        want = _defined_lists(ia, ib)
        n_off, rows = (ia if ia is not None else ib).shape
        assert got.rows.shape == (n_off, rows) and got.ws is None
        assert got.counts.tolist() == [len(w) for w in want], name
        assert sum(len(w) for w in want) > 0, name
        for o, w in enumerate(want):
            np.testing.assert_array_equal(got.rows[o, :len(w)].numpy(), w,
                                          err_msg=f"{name} offset {o}")
            assert (got.rows[o, len(w):] == -1).all(), name
    # a child table lists the same rows in either role
    child = plan.levels[0].child
    a, b = TSC.gather_pairs(child, None), TSC.gather_pairs(None, child)
    assert torch.equal(a.rows, b.rows) and torch.equal(a.counts, b.counts)


def test_pair_list_cache_is_per_table_set():
    plan = _plan("host")
    child, nbr = plan.levels[1].child, plan.levels[1].nbr
    down = TSC.cached_pairs(child, None)
    assert TSC.cached_pairs(None, child) is down          # the up role
    assert TSC.cached_pairs(child, None) is down
    other = TSC.cached_pairs(nbr, None)
    assert other is not down and other.rows.shape == nbr.shape
    table = nbr.clone()
    TSC.cached_pairs(None, table)
    n = len(TSC._PAIR_LISTS)
    del table
    gc.collect()
    assert len(TSC._PAIR_LISTS) == n - 1                # gone with its table


@pytest.mark.parametrize("level", range(5))
def test_row_lists_match_occupied_rows_plain(level):
    coords, bidx, valid = _points(5)
    plan = TH.host_plan_to_device(TH.build_host_plan(
        coords, bidx, valid, CAPS, block_edges=[4] * 5), "cpu")
    t = plan.blocks[level]
    occ = TBD.occupancy(t)
    rows = TBD.row_list(t, occ)
    assert TBD.row_list(t, occ) is rows                  # kept on the level
    want_rows, want_count = TBD.occupied_rows_plain(occ)
    assert int(rows.count) == int(want_count) == int(occ.sum()) > 0
    assert torch.equal(rows.rows, want_rows)
    np.testing.assert_array_equal(
        rows.rows[:int(rows.count)].numpy(), np.nonzero(occ.numpy())[0])
    other = occ.clone()
    assert TBD.row_list(t, other) is not rows            # a new mask


def _close(got, want, what=""):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    assert scale > 0, what
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=REL * scale, err_msg=what)


@pytest.mark.parametrize("kind", ["host", "device"])
def test_gather_wgrad_over_lists_equals_full_tables(kind):
    plan = _plan(kind)
    rng = np.random.RandomState(7)
    for name, ia, ib, ra, rb, mirror in _tables(plan):
        a = torch.from_numpy(rng.randn(ra, 6).astype(np.float32))
        b = torch.from_numpy(rng.randn(rb, 5).astype(np.float32))
        n_off, rows = (ia if ia is not None else ib).shape
        full = TSC.gather_wgrad_plain(a, ia, b, ib, n_off, rows, mirror)
        listed = TSC.gather_wgrad_pairs_plain(
            a, ia, b, ib, TSC.gather_pairs(ia, ib), mirror)
        _close(listed, full, name)


def _block_tables(edge, seed=6):
    coords, bidx, valid = _points(seed)
    kw = dict(block_edges=[edge] * 5)
    jplan, _ = JH.host_plan_to_device(JH.build_host_plan(
        coords, bidx, valid, CAPS, stem_compact=False, **kw), device=False)
    tplan = TH.host_plan_to_device(
        TH.build_host_plan(coords, bidx, valid, CAPS, **kw), "cpu")
    return tplan.blocks[0], jplan.blocks[0], jplan.levels[0].valid


@pytest.mark.parametrize("edge,k", [(4, 3), (4, 5), (8, 3)])
def test_block_wgrad_over_row_list_equals_full(edge, k):
    t, _, _ = _block_tables(edge)
    occ = TBD.occupancy(t)
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.randn(occ.shape[0], 6).astype(np.float32))
    dy = torch.where(occ[:, None], torch.from_numpy(
        rng.randn(occ.shape[0], 5).astype(np.float32)), 0.0)
    full = TBD.block_wgrad_plain(x, dy, t.block_nbr, occ, edge, k)
    listed = TBD.block_wgrad_rows_plain(x, dy, t.block_nbr,
                                        TBD.row_list(t, occ), edge, k)
    _close(listed, full)


def test_halo_rows_plain_matches_the_padded_window():
    """``halo_rows_plain`` names the source cell of every (cell, offset)
    that ``halo_pad_plain``'s window reads: a padded window of row ids."""
    t, _, _ = _block_tables(4)
    b, e, h = t.num_blocks, t.edge, 1
    ids = torch.arange(b * e ** 3, dtype=torch.float64)
    padded = TBD.halo_pad_plain((ids + 1).reshape(b, e, e, e, 1),
                                t.block_nbr, h)[..., 0]
    rows = torch.arange(b * e ** 3)
    for o, s in enumerate(itertools.product(range(-h, h + 1), repeat=3)):
        i, j, m = (d + h for d in s)
        want = padded[:, i:i + e, j:j + e, m:m + e].reshape(-1) - 1
        got = TBD.halo_rows_plain(rows, t.block_nbr, e, s)
        assert torch.equal(got.long(), want.long()), o


@pytest.mark.parametrize("role", ["stem_k5", "subm_k3"])
def test_gather_dw_matches_jax(role):
    """dW of the gather layout's convs: ``jax.vjp`` of
    ``_subm_conv_impl`` against the port's backward on the CPU (the plain
    K4) and the plain reduction over the compacted pair list."""
    coords, bidx, valid = _points(9)
    jplan, _ = JH.host_plan_to_device(JH.build_host_plan(
        coords, bidx, valid, CAPS, stem_compact=False), device=False)
    tplan = TH.host_plan_to_device(
        TH.build_host_plan(coords, bidx, valid, CAPS), "cpu")
    stem = role == "stem_k5"
    lvl = 0 if stem else 1
    nbr_j = jplan.stem_nbr if stem else jplan.subm_nbr[1]
    nbr_t = tplan.stem_nbr if stem else tplan.levels[1].nbr
    valid_t = tplan.levels[lvl].valid
    cin, cout = (35, 8) if stem else (16, 24)    # the stem: Cin > 2 Cout
    rng = np.random.RandomState(10)
    v, n_off = nbr_t.shape[1], nbr_t.shape[0]
    x = rng.randn(v, cin).astype(np.float32)
    w = (rng.randn(n_off, cin, cout) / np.sqrt(cin)).astype(np.float32)
    g = rng.randn(v, cout).astype(np.float32)
    _, vjp = jax.vjp(lambda wt: JSC._subm_conv_impl(
        jnp.asarray(x), jnp.asarray(nbr_j), wt,
        jnp.asarray(jplan.levels[lvl].valid)), jnp.asarray(w))
    (want,) = vjp(jnp.asarray(g))
    wt = torch.from_numpy(w).requires_grad_()
    TSC.subm_conv(torch.from_numpy(x), nbr_t, wt, valid_t).backward(
        torch.from_numpy(g))
    _close(wt.grad.numpy(), want, "port backward")
    dy = torch.where(valid_t[:, None], torch.from_numpy(g), 0.0)
    xt = torch.from_numpy(x)
    if stem:       # the narrow side gathered, mirrored, as the backward does
        listed = TSC.gather_wgrad_pairs_plain(
            xt, None, dy, nbr_t, TSC.gather_pairs(None, nbr_t), mirror=True)
    else:
        listed = TSC.gather_wgrad_pairs_plain(
            xt, nbr_t, dy, None, TSC.gather_pairs(nbr_t, None))
    _close(listed.numpy(), want, "over the pair lists")


@pytest.mark.parametrize("k", [3, 5])
def test_block_dw_matches_jax(k):
    """dW of the block conv: ``jax.vjp`` of ``_chunked_conv_cd`` (chunks of
    16 blocks, so the JAX side scans several) against the port's backward
    on the CPU (the plain K11) and the plain reduction over the level's
    occupied-row list."""
    t, j, jvalid = _block_tables(4, seed=11)
    occ = TBD.occupancy(t)
    rng = np.random.RandomState(12)
    cin, cout = 7, 5
    dense = np.where(occ.numpy()[:, None], rng.randn(occ.shape[0], cin),
                     0.0).astype(np.float32)
    w = (rng.randn(k ** 3, cin, cout) * 0.2).astype(np.float32)
    g = rng.randn(occ.shape[0], cout).astype(np.float32)
    jocc = JBD.occupancy(j, jvalid)
    assert j.block_nbr.shape[1] > 16
    _, vjp = jax.vjp(lambda wt: JBD._chunked_conv_cd(
        jnp.asarray(dense), jocc, wt, j.block_nbr, j.edge, k, 16),
        jnp.asarray(w))
    (want,) = vjp(jnp.asarray(g))
    wt = torch.from_numpy(w).requires_grad_()
    TBD.dense_subm_conv(torch.from_numpy(dense), occ, t, wt).backward(
        torch.from_numpy(g))
    _close(wt.grad.numpy(), want, "port backward")
    dy = torch.where(occ[:, None], torch.from_numpy(g), 0.0)
    listed = TBD.block_wgrad_rows_plain(torch.from_numpy(dense), dy,
                                        t.block_nbr, TBD.row_list(t, occ),
                                        t.edge, k)
    _close(listed.numpy(), want, "over the row list")
