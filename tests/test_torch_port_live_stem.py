"""The dense k5 stem on its live pairs (K10's and K11's live-pair path).

The flagship trains on block-dense levels with a dense k5 stem.  The
stem's input comes straight from ``scatter_to_dense``, which writes 0 at
every unoccupied cell, so a (listed row, offset) pair whose source cell is
unoccupied multiplies a zero row: K10's forward and K11's dW skip those
pairs on the card, over a live-pair list built once per level and step.
Here, on the CPU:

* the plain live-pair list (``live_pairs_plain``) against its definition
  from the halo-padded window of row ids and the occupancy (edges 4 and
  8, k 3 and 5), and the list kept on the tables;
* the invariant: the stem's input is zero at every unoccupied row of host
  block-dense training plans (``host_plan_args(cfg, train=True)``), fp32
  and in bf16 at its aligned pitch, as every block conv's is, and every
  conv states it (``tests/test_torch_port_live_k3.py`` holds the k3
  convs);
* the live-pair path's plain versions (``block_conv_live_plain``,
  ``block_wgrad_live_plain``) and the autograd path that runs them,
  against JAX's ``dense_subm_conv`` and ``jax.vjp`` of
  ``_chunked_conv_cd`` on such an input, and against the row-tile path's
  plain versions;
* the wrappers' path choice and its forced switch.

Tolerance: ``1e-5 x max |reference|`` against JAX (the same fp32 products
summed in another order), ``1e-6 x max`` against the port's own plain
versions; lists are equal.
"""
import functools
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
from segdino3d_tpu_torch.ops import block_dense as TBD  # noqa: E402
from segdino3d_tpu_torch.ops import host_plan as TH  # noqa: E402
from segdino3d_tpu_torch.ops import narrow as TN  # noqa: E402

CAPS = [1024, 512, 256, 128, 64]
REL_JAX, REL_PLAIN = 1e-5, 1e-6


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


@functools.lru_cache(maxsize=None)
def _block_tables(edge, seed=6):
    """(port level-0 BlockTables, JAX BlockTables, JAX level-0 valid) of
    one seeded scene with blocks of ``edge``."""
    coords, bidx, valid = _points(seed)
    kw = dict(block_edges=[edge] * 5)
    jplan, _ = JH.host_plan_to_device(JH.build_host_plan(
        coords, bidx, valid, CAPS, stem_compact=False, **kw), device=False)
    tplan = TH.host_plan_to_device(
        TH.build_host_plan(coords, bidx, valid, CAPS, **kw), "cpu")
    return tplan.blocks[0], jplan.blocks[0], jplan.levels[0].valid


def _fresh(t):
    """The tables without their kept lists."""
    return TBD.BlockTables(t.vox_slot, t.block_nbr, t.slot_vox, t.edge)


def _close(got, want, rel, what=""):
    want = np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    assert scale > 0, what
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=rel * scale, err_msg=what)


def _stem_input(t, cin, seed):
    """Seeded rows, zero at every unoccupied cell."""
    occ = TBD.occupancy(t)
    rng = np.random.RandomState(seed)
    x = rng.randn(occ.shape[0], cin).astype(np.float32)
    return torch.from_numpy(np.where(occ.numpy()[:, None], x, 0.0)
                            .astype(np.float32))


@pytest.mark.parametrize("edge,k", [(4, 3), (4, 5), (8, 3), (8, 5)])
def test_live_pairs_match_their_definition(edge, k):
    """Per offset, in list order, the occupied rows whose source cell in
    the halo-padded block (a window of row ids) is occupied; the map names
    each listed row's pair; -1 past the counts."""
    t = _fresh(_block_tables(edge)[0])
    occ = TBD.occupancy(t)
    b, h = t.num_blocks, (k - 1) // 2
    ids = torch.arange(b * edge ** 3, dtype=torch.float64)
    padded = TBD.halo_pad_plain((ids + 1).reshape(b, edge, edge, edge, 1),
                                t.block_nbr, h)[..., 0]
    listed = torch.nonzero(occ).flatten()
    cap = TBD.live_capacity(t)
    assert listed.shape[0] <= cap < occ.shape[0]
    lp = TBD.live_pairs(t, occ, k)
    assert lp.src.shape == (k ** 3, cap) and lp.rows is TBD.row_list(t, occ)
    for o, (i, j, m) in enumerate(itertools.product(range(k), repeat=3)):
        window = padded[:, i:i + edge, j:j + edge, m:m + edge].reshape(-1)
        src = (window[listed] - 1).long()
        live = src >= 0
        live[live.clone()] = occ[src[live]]
        n = int(live.sum())
        assert int(lp.counts[o]) == n, o
        assert torch.equal(lp.src[o, :n].long(), src[live]), o
        assert torch.equal(lp.dst[o, :n].long(), listed[live]), o
        assert bool((lp.src[o, n:] == -1).all() & (lp.dst[o, n:] == -1).all())
        want_map = torch.full((cap,), -1, dtype=torch.long)
        want_map[:listed.shape[0]][live] = torch.arange(n)
        assert torch.equal(lp.map[o].long(), want_map), o
    # kept on the tables: one list per level and kernel size
    assert TBD.live_pairs(t, occ, k) is lp
    assert TBD.live_pairs(t, occ, 8 - k) is not lp
    assert TBD.live_pairs(t, occ.clone(), k) is not lp


def _step_model(dtype):
    """A small flagship-shaped model (k5 stem) in training mode and its
    block-dense training batch (``host_plan_args(cfg, train=True)``)."""
    from segdino3d_tpu_torch.builder import (Capacities, build_model,
                                             host_plan_args, random_init_)
    from segdino3d_tpu_torch.data import collate as TC
    from segdino3d_tpu_torch.data.synthetic import synthetic_scene

    feat2d = 16
    cfg = dict(
        type="SegDINO3D", query_thr=0.5, mode_3d_center="median",
        pointcloud_backbone_cfg=dict(
            type="Res16UNet34C", in_channels=feat2d + 3, out_channels=96,
            voxel_size=0.02, block_edges=(4,) * 5, stem_gather=True,
            block_edges_train=(4,) * 5,
            config=dict(conv1_kernel_size=5, bn_momentum=0.02),
            **({} if dtype == torch.float32 else
               dict(compute_dtype="bfloat16"))),
        decoder_cfg=dict(num_layers=1, num_instance_classes=18,
                         num_semantic_classes=20, in_channels=96, d_model=32,
                         num_heads=4, hidden_dim=64, temperature=20,
                         dropout=0.0))
    caps = Capacities(num_superpoints=32, num_voxels=512)
    model, _ = build_model(cfg, caps, device="cpu", train=True)
    random_init_(model, seed=0)
    rec = synthetic_scene(3, n_points=512, n_superpoints=32, n_classes=18,
                          n_queries2d=8, feat_dim_2d=feat2d,
                          point_density=500.0)
    spec = TC.PadSpec(512, 32, 16, 16, 20)
    layout = host_plan_args(cfg, train=True)
    assert "stem_gather" not in layout
    batch = TC.attach_host_plan(
        TC.collate([rec], spec, "cpu"), [rec], spec, voxel_cap=512,
        level_cap_ratios=caps.level_cap_ratios, **layout)
    assert all(t is not None for t in batch.plan.blocks)
    assert batch.plan.stem_nbr is None
    return model, batch, feat2d + 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_only_the_stem_states_its_input_zero_outside(dtype, monkeypatch):
    """On block-dense training plans every block conv, the stem's first,
    states that its input is zero outside the occupancy; the stem's input
    is zero at every unoccupied row, at the bf16 pitch too; the live-pair
    plain versions run where ``narrow.live_path`` takes each role (fp32:
    every forward, every k3 dX and (with the backward) every dW; bf16: the
    stem and the k3 roles its measured rule takes), on one list per level
    and kernel size for the forwards and dW, one per level for the dX."""
    calls, live = [], {"conv": 0, "wgrad": 0, "lists": 0}
    inner = TBD.dense_subm_conv
    wrapped = {n: getattr(TBD, n) for n in ("block_conv_live_plain",
                                            "block_wgrad_live_plain",
                                            "live_pairs_plain")}

    def spy(feats, occ, tables, weights, zero_outside=False):
        calls.append((feats.detach().clone(), occ, weights.shape[0],
                      zero_outside, tuple(weights.shape[1:]),
                      TBD.live_capacity(tables), id(tables)))
        return inner(feats, occ, tables, weights, zero_outside)

    def counted(name, key):
        def run(*args, **kw):
            live[key] += 1
            return wrapped[name](*args, **kw)
        return run

    monkeypatch.setattr(TBD, "dense_subm_conv", spy)
    monkeypatch.setattr(TBD, "block_conv_live_plain",
                        counted("block_conv_live_plain", "conv"))
    monkeypatch.setattr(TBD, "block_wgrad_live_plain",
                        counted("block_wgrad_live_plain", "wgrad"))
    monkeypatch.setattr(TBD, "live_pairs_plain",
                        counted("live_pairs_plain", "lists"))
    model, batch, cin = _step_model(dtype)
    torch.manual_seed(0)
    out = model.backbone(batch).sp_feats
    if dtype == torch.float32:   # the dW's path once, on the forward's list
        out.square().sum().backward()
    stated = [c for c in calls if c[3]]
    assert len(calls) == 46 + 1 and len(stated) == 47
    x, occ, n_off = stated[0][:3]
    assert n_off == 125 and [c[2] for c in calls[1:]] == [27] * 46
    assert x.dtype == dtype and x.shape[1] == TN.row_pitch(cin, dtype)
    assert bool((x[~occ] == 0).all()) and bool((x[occ] != 0).any())
    k3 = [(c[4], c[5], c[6]) for c in calls[1:]]
    forward = sum(TN.live_path(27, ci, co, dtype, True, cap=cap)
                  for (ci, co), cap, _ in k3)
    if dtype == torch.float32:   # every role of every conv, 11 lists
        assert forward == 46
        assert all(TN.live_path(27, co, ci, dtype, True, dx=True, cap=cap)
                   for (ci, co), cap, _ in k3)
        assert live == {"conv": 47 + 46, "wgrad": 47, "lists": 6 + 5}
    else:
        levels = {level for (ci, co), cap, level in k3
                  if TN.live_path(27, ci, co, dtype, True, cap=cap)}
        assert live == {"conv": 1 + forward, "wgrad": 0,
                        "lists": 1 + len(levels)}
    if dtype == torch.float32:
        stem = model.backbone.unet.conv0p1s1.kernel
        assert stem.grad is not None and bool(torch.isfinite(stem.grad).all())


@functools.lru_cache(maxsize=None)
def _jax_stem(cin, cout, seed=21):
    """A k5 conv of an input zero outside the occupancy: (port tables,
    x, w, g, JAX forward, JAX dW by ``jax.vjp`` of ``_chunked_conv_cd``
    in chunks of 16 blocks)."""
    t, j, jvalid = _block_tables(4, seed=11)
    k = 5
    x = _stem_input(t, cin, seed)
    rng = np.random.RandomState(seed + 1)
    w = (rng.randn(k ** 3, cin, cout) / np.sqrt(k ** 3 * cin)).astype(
        np.float32)
    g = rng.randn(x.shape[0], cout).astype(np.float32)
    jocc = JBD.occupancy(j, jvalid)
    assert j.block_nbr.shape[1] > 16
    want_y = JBD.dense_subm_conv(jnp.asarray(x.numpy()), jocc, j,
                                 jnp.asarray(w))
    _, vjp = jax.vjp(lambda wt: JBD._chunked_conv_cd(
        jnp.asarray(x.numpy()), jocc, wt, j.block_nbr, j.edge, k, 16),
        jnp.asarray(w))
    (want_dw,) = vjp(jnp.asarray(g))
    return t, x, torch.from_numpy(w), torch.from_numpy(g), \
        np.asarray(want_y), np.asarray(want_dw)


@pytest.mark.parametrize("cin", [7, 19])
def test_live_plain_versions_match_jax(cin):
    """The live-pair path's plain versions and the autograd path that runs
    them (``zero_outside``) against JAX, and against the row-tile path's
    plain versions on the same input."""
    t, x, w, g, want_y, want_dw = _jax_stem(cin, 8)
    t = _fresh(t)
    occ = TBD.occupancy(t)
    lp = TBD.live_pairs(t, occ, 5)
    y = TBD.block_conv_live_plain(x, w, lp)
    _close(y, want_y, REL_JAX, "live plain vs JAX forward")
    _close(y, TBD.dense_subm_conv_plain(x, t.block_nbr, w, occ, t.edge),
           REL_PLAIN, "live plain vs the row-tile plain")
    dy = torch.where(occ[:, None], g, 0.0)
    dw = TBD.block_wgrad_live_plain(x, dy, lp)
    _close(dw, want_dw, REL_JAX, "live dW plain vs jax.vjp")
    _close(dw, TBD.block_wgrad_plain(x, dy, t.block_nbr, occ, t.edge, 5),
           REL_PLAIN, "live dW plain vs the row-tile plain")
    wt = w.clone().requires_grad_()
    out = TBD.dense_subm_conv(x, occ, t, wt, zero_outside=True)
    out.backward(g)
    _close(out.detach(), want_y, REL_JAX, "autograd forward")
    _close(wt.grad, want_dw, REL_JAX, "autograd dW")
    assert TBD.live_pairs(t, occ, 5) is lp


def test_wrappers_pick_the_live_path_from_the_statement_and_shape(
        monkeypatch):
    """``block_conv`` and ``block_wgrad`` run the live-pair path for an
    fp32 conv stated zero outside the occupancy, k5 or k3, above the
    narrow paths' Cin; an unstated input and the Baseline's Cin 3 stem
    keep their paths; the forced switch runs either path and refuses an
    unstated input."""
    t = _fresh(_block_tables(4)[0])
    occ = TBD.occupancy(t)
    ran = []
    for name in ("block_conv_live_plain", "block_wgrad_live_plain",
                 "dense_subm_conv_plain", "block_wgrad_plain"):
        def run(*args, _f=getattr(TBD, name), _n=name, **kw):
            ran.append(_n)
            return _f(*args, **kw)
        monkeypatch.setattr(TBD, name, run)

    def paths(cin, k, zero_outside, live=None):
        ran.clear()
        x = _stem_input(t, cin, 5)
        w = torch.randn(k ** 3, cin, 8, generator=torch.Generator()
                        .manual_seed(0))
        dy = torch.where(occ[:, None], torch.ones(occ.shape[0], 8), 0.0)
        y = TBD.block_conv(x, t.block_nbr, w, occ, t.edge,
                           zero_outside=zero_outside, live=live)
        dw = TBD.block_wgrad(x, dy, t.block_nbr, occ, t.edge, k,
                             zero_outside=zero_outside, live=live)
        return list(ran), y, dw

    live = ["block_conv_live_plain", "block_wgrad_live_plain"]
    tiles = ["dense_subm_conv_plain", "block_wgrad_plain"]
    got, y_live, dw_live = paths(9, 5, True)
    assert got == live
    got, y_tiles, dw_tiles = paths(9, 5, True, live=False)
    assert got == tiles
    _close(y_live, y_tiles, REL_PLAIN)
    _close(dw_live, dw_tiles, REL_PLAIN)
    assert paths(9, 5, False)[0] == tiles
    assert paths(9, 3, True)[0] == live          # every stated fp32 conv
    assert paths(9, 3, False)[0] == tiles
    assert paths(9, 3, True, live=False)[0] == tiles
    assert paths(3, 5, True)[0] == tiles        # the narrow paths' Cin
    assert TN.live_path(125, 259, 32, torch.bfloat16, True)
    assert TN.live_path(125, 5, 32, torch.float32, True)
    assert not TN.live_path(125, 5, 32, torch.float32, True, wgrad=True)
    assert TN.live_path(27, 262, 32, torch.float32, True)
    assert not TN.live_path(27, 262, 32, torch.float32, False)
    assert not TN.live_path(125, 259, 32, torch.float32, False)
    with pytest.raises(ValueError, match="live-pair path"):
        paths(9, 5, False, live=True)
    x = _stem_input(t, 9, 5)
    with pytest.raises(ValueError, match="zero_outside needs occ"):
        TBD.block_conv(x, t.block_nbr, torch.zeros(125, 9, 8), None, t.edge,
                       zero_outside=True)
