"""K10 and K11 on live pairs at the k3 block convs: forward, dX over the
dilation, dW.

Every block conv of the Res16UNet34C (``conv_ctx.DenseCtx``) states that
its input is zero outside the occupancy: ``scatter_to_dense`` writes 0 at
every empty cell and ``MaskedBatchNorm`` zeroes every row outside
``valid``, and ReLU, residual sums and skip concatenations keep those
zeros.  So a (listed row, offset) pair whose source cell is unoccupied
multiplies a zero row, and K10's forward, K10's dX (whose masked cotangent
is zero outside the occupancy whatever the model) and K11's dW skip those
pairs.  Here, on the CPU:

* the invariant: a hook on ``DenseCtx.subm`` finds every conv input exactly
  zero outside ``valid``, for the flagship and the Baseline, in training
  and eval mode, fp32 and bf16, on host block-dense and hybrid plans;
* the dX role's live-pair list (``dilation_pairs``: the k3 dilation's rows,
  sources in the occupancy) against its definition at edges 4 and 8, kept
  on the tables, and a count past either capacity raising;
* the plain live forward, dX and dW at k3 and the autograd path that runs
  them, against JAX's ``dense_subm_conv`` and ``jax.vjp`` of
  ``_chunked_conv_cd`` (1e-5 x max) and against the row-tile path's plain
  versions (1e-6 x max);
* the row groups of K10's live-pair kernel (``csrc/live_rows.cuh``): each
  group's pair range per offset against its definition from the list
  (edges 4 and 8, k3 and k5, the forward's and the dilation's lists, a
  group with no pair, offsets with none, a list at its capacities), and a
  plain model of the kernel's order (row group, then ascending offset)
  bit-equal to the live plain version in fp32 and against JAX;
* the path rule (``narrow.live_path``, ``narrow.live_form``) over every
  conv role of the flagship and the Baseline, fp32 and bf16.
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
from segdino3d_tpu_torch.ops import conv_ctx as TCC  # noqa: E402
from segdino3d_tpu_torch.ops import host_plan as TH  # noqa: E402
from segdino3d_tpu_torch.ops import narrow as TN  # noqa: E402

CAPS = [1024, 512, 256, 128, 64]
REL_JAX, REL_PLAIN = 1e-5, 1e-6
F32, BF16 = torch.float32, torch.bfloat16


@pytest.fixture(scope="module", autouse=True)
def _setup():
    load_jax_sparseplan()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel, what=""):
    want = np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    assert scale > 0, what
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=rel * scale, err_msg=what)


# --------------------------------------------------------------------------
# the invariant
# --------------------------------------------------------------------------

def _model_and_batch(model, layout, dtype):
    """A flagship-shaped or Baseline model (the backbone at its published
    widths, a one-layer decoder) and a host batch on its block-dense
    training plan or its hybrid eval plan."""
    import chip_smoke
    from segdino3d_tpu_torch.builder import (Capacities, build_model,
                                             host_plan_args, random_init_)
    from segdino3d_tpu_torch.data import collate as TC
    from segdino3d_tpu_torch.data.synthetic import synthetic_scene

    feat2d = 16
    if model == "flagship":
        bcfg = dict(type="Res16UNet34C", in_channels=feat2d + 3,
                    out_channels=96, voxel_size=0.02, block_edges=(4,) * 5,
                    stem_gather=True, block_edges_train=(4,) * 5,
                    config=dict(conv1_kernel_size=5, bn_momentum=0.02))
        cfg = dict(type="SegDINO3D", query_thr=0.5, mode_3d_center="median",
                   pointcloud_backbone_cfg=bcfg)
    else:
        cfg = chip_smoke.baseline_model_cfg()
        bcfg = cfg["pointcloud_backbone_cfg"]
    if dtype == BF16:
        bcfg["compute_dtype"] = "bfloat16"
    cfg["decoder_cfg"] = dict(
        num_layers=1, num_instance_classes=18, num_semantic_classes=20,
        in_channels=96, d_model=32, num_heads=4, hidden_dim=64,
        temperature=20, dropout=0.0,
        **({} if model == "flagship" else dict(add_dinox_query_ca=False)))
    caps = Capacities(num_superpoints=32, num_voxels=512)
    net, _ = build_model(cfg, caps, device="cpu", train=True)
    random_init_(net, seed=0)
    rec = synthetic_scene(3, n_points=512, n_superpoints=32, n_classes=18,
                          n_queries2d=8, feat_dim_2d=feat2d,
                          point_density=500.0)
    if model == "baseline":
        rec = dict(rec, points_2dfeats=None, query2d_feats=None,
                   query2d_pos=None)
    spec = TC.PadSpec(512, 32, 16, 16, 20)
    batch = TC.attach_host_plan(
        TC.collate([rec], spec, "cpu"), [rec], spec, voxel_cap=512,
        level_cap_ratios=caps.level_cap_ratios,
        **host_plan_args(cfg, train=layout == "block-dense"))
    assert all(t is not None for t in batch.plan.blocks)
    assert (batch.plan.stem_nbr is None) == (layout == "block-dense")
    return net, batch


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("mode", ["train", "eval"])
@pytest.mark.parametrize("layout", ["block-dense", "hybrid"])
@pytest.mark.parametrize("model", ["flagship", "baseline"])
def test_every_dense_conv_input_is_zero_outside_valid(model, layout, mode,
                                                      dtype, monkeypatch):
    """Every conv of a ``DenseCtx`` level (the 46 k3 convs, and the dense
    k5 stem on block-dense plans) gets an input that is exactly zero at
    every row outside ``valid`` and not zero inside it."""
    seen = []
    inner = TCC.DenseCtx.subm

    def hook(self, feats, w):
        outside = int((feats[~self.valid] != 0).sum())
        seen.append((w.shape[0], outside,
                     bool((feats[self.valid] != 0).any()), feats.dtype))
        return inner(self, feats, w)

    monkeypatch.setattr(TCC.DenseCtx, "subm", hook)
    net, batch = _model_and_batch(model, layout, dtype)
    net.train(mode == "train")
    torch.manual_seed(0)
    with torch.no_grad():
        net.backbone(batch)
    stem = [125] if layout == "block-dense" else []
    assert [s[0] for s in seen] == stem + [27] * 46
    assert [s[1] for s in seen] == [0] * len(seen)
    assert all(s[2] for s in seen) and {s[3] for s in seen} == {dtype}


# --------------------------------------------------------------------------
# the dX role's list
# --------------------------------------------------------------------------

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


@pytest.mark.parametrize("edge", [4, 8])
def test_dilation_pairs_match_their_definition(edge):
    """Per offset, in list order, the rows of the occupancy's k3 dilation
    whose source cell in the halo-padded block (a window of row ids) is
    occupied; the map names each listed row's pair; -1 past the counts; at
    most the level's voxel capacity of pairs an offset, every row of the
    level listable; kept on the tables beside the dilation."""
    t = _fresh(_block_tables(edge)[0])
    occ = TBD.occupancy(t)
    b, k, n_rows = t.num_blocks, 3, occ.shape[0]
    ids = torch.arange(n_rows, dtype=torch.float64)
    padded = TBD.halo_pad_plain((ids + 1).reshape(b, edge, edge, edge, 1),
                                t.block_nbr, 1)[..., 0]
    mask, rows = TBD.dilation(t, occ, k)
    listed = torch.nonzero(mask).flatten()
    assert listed.shape[0] > int(occ.sum())
    cap = TBD.live_capacity(t)
    lp = TBD.dilation_pairs(t, occ, k)
    assert lp.src.shape == (27, cap) and lp.map.shape == (27, n_rows)
    assert lp.rows is rows
    for o, (i, j, m) in enumerate(itertools.product(range(k), repeat=3)):
        window = padded[:, i:i + edge, j:j + edge, m:m + edge].reshape(-1)
        src = (window[listed] - 1).long()
        live = src >= 0
        live[live.clone()] = occ[src[live]]
        n = int(live.sum())
        assert int(lp.counts[o]) == n <= int(occ.sum()), o
        assert torch.equal(lp.src[o, :n].long(), src[live]), o
        assert torch.equal(lp.dst[o, :n].long(), listed[live]), o
        assert bool((lp.src[o, n:] == -1).all() & (lp.dst[o, n:] == -1).all())
        want_map = torch.full((n_rows,), -1, dtype=torch.long)
        want_map[:listed.shape[0]][live] = torch.arange(n)
        assert torch.equal(lp.map[o].long(), want_map), o
    # every occupied source pairs with the dilation row it reaches at
    # each offset whose block exists: the centre's pairs are the occupancy
    assert int(lp.counts[13]) == int(occ.sum())
    # kept: one list per level, kernel size and occupancy
    assert TBD.dilation_pairs(t, occ, k) is lp
    assert TBD.dilation_pairs(t, occ.clone(), k) is not lp
    assert TBD.live_pairs(t, occ, k) is not lp


def test_a_count_past_its_capacity_raises():
    """The list holds what fits or raises: too few pair slots for an
    offset, or too few listed-row slots for the row list."""
    t = _fresh(_block_tables(4)[0])
    occ = TBD.occupancy(t)
    mask, rows = TBD.dilation(t, occ, 3)
    n_occ, n_list = int(occ.sum()), int(rows.count)
    ok = TBD.live_pair_list(rows, occ, t.block_nbr, t.edge, 3, n_occ, n_list)
    assert int(ok.counts.max()) == n_occ
    with pytest.raises(ValueError, match="pairs at offset .* past"):
        TBD.live_pair_list(rows, occ, t.block_nbr, t.edge, 3, n_occ - 1,
                           n_list)
    with pytest.raises(ValueError, match="listed rows past"):
        TBD.live_pair_list(rows, occ, t.block_nbr, t.edge, 3, n_occ,
                           n_list - 1)


# --------------------------------------------------------------------------
# the plain versions against JAX
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_k3(edge, cin, cout, seed=31):
    """A k3 conv of an input zero outside the occupancy: (port tables, x,
    w, g, JAX forward, JAX dX and dW by ``jax.vjp`` of ``_chunked_conv_cd``
    in chunks of 16 blocks at edge 4, 8 at edge 8)."""
    t, j, jvalid = _block_tables(edge, seed=11)
    occ = TBD.occupancy(t)
    rng = np.random.RandomState(seed)
    x = rng.randn(occ.shape[0], cin).astype(np.float32)
    x = np.where(occ.numpy()[:, None], x, 0.0).astype(np.float32)
    w = (rng.randn(27, cin, cout) / np.sqrt(27 * cin)).astype(np.float32)
    g = rng.randn(x.shape[0], cout).astype(np.float32)
    jocc = JBD.occupancy(j, jvalid)
    chunk = 16 if edge == 4 else 8
    assert j.block_nbr.shape[1] > chunk
    want_y = JBD.dense_subm_conv(jnp.asarray(x), jocc, j, jnp.asarray(w))
    _, vjp = jax.vjp(lambda xx, wt: JBD._chunked_conv_cd(
        xx, jocc, wt, j.block_nbr, j.edge, 3, chunk), jnp.asarray(x),
        jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(g))
    return t, torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(g), \
        np.asarray(want_y), np.asarray(want_dx), np.asarray(want_dw)


@pytest.mark.parametrize("edge,cin,cout", [(4, 12, 20), (8, 24, 16)])
def test_live_k3_plain_versions_match_jax(edge, cin, cout, monkeypatch):
    """The live-pair plain versions at k3 in the three roles, and the
    autograd path that runs them (``zero_outside``, fp32: every role
    live), against JAX and against the row-tile path's plain versions."""
    t, x, w, g, want_y, want_dx, want_dw = _jax_k3(edge, cin, cout)
    t = _fresh(t)
    occ = TBD.occupancy(t)
    fwd, dxl = TBD.live_pairs(t, occ, 3), TBD.dilation_pairs(t, occ, 3)
    y = TBD.block_conv_live_plain(x, w, fwd)
    _close(y, want_y, REL_JAX, "live forward vs JAX")
    _close(y, TBD.dense_subm_conv_plain(x, t.block_nbr, w, occ, t.edge),
           REL_PLAIN, "live forward vs the row-tile plain")
    dy = torch.where(occ[:, None], g, 0.0)
    wt = w.flip(0).transpose(1, 2).contiguous()
    mask = TBD.dilation(t, occ, 3)[0]
    dx = TBD.block_conv_live_plain(dy, wt, dxl)
    _close(dx, want_dx, REL_JAX, "live dX vs jax.vjp")
    _close(dx, TBD.dense_subm_conv_plain(dy, t.block_nbr, wt, mask, t.edge),
           REL_PLAIN, "live dX vs the row-tile plain")
    assert bool((dx[~mask] == 0).all()) and bool((dx[mask & ~occ] != 0).any())
    dw = TBD.block_wgrad_live_plain(x, dy, fwd)
    _close(dw, want_dw, REL_JAX, "live dW vs jax.vjp")
    _close(dw, TBD.block_wgrad_plain(x, dy, t.block_nbr, occ, t.edge, 3),
           REL_PLAIN, "live dW vs the row-tile plain")

    ran = []
    for name in ("block_conv_live_plain", "block_wgrad_live_plain",
                 "dense_subm_conv_plain", "block_wgrad_plain"):
        def run(*args, _f=getattr(TBD, name), _n=name, **kw):
            ran.append(_n)
            return _f(*args, **kw)
        monkeypatch.setattr(TBD, name, run)
    t = _fresh(t)
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    out = TBD.dense_subm_conv(xg, occ, t, wg, zero_outside=True)
    out.backward(g)
    assert ran == ["block_conv_live_plain"] * 2 + ["block_wgrad_live_plain"]
    _close(out.detach(), want_y, REL_JAX, "autograd forward")
    _close(xg.grad, want_dx, REL_JAX, "autograd dX")
    _close(wg.grad, want_dw, REL_JAX, "autograd dW")
    assert set(t.live) == {3} and set(t.dilation_live) == {3}


# --------------------------------------------------------------------------
# K10's row groups: each group's pair range per offset, and a model of the
# kernel's order
# --------------------------------------------------------------------------

# group sizes the kernel's per-word starts allow (multiples of 32 listed
# rows); the card's own (``block_dense.live_group_rows``) is held to the
# same plain ranges in the kernels file
GROUP_ROWS = (32, 64, 128, 256)


def _hold_ranges(lp, group_rows):
    """``live_ranges_plain`` against its definition: offset o's pairs whose
    listed row falls in group g (rows ``g * group_rows`` .. of the list)
    are pairs start .. start + count - 1 of o's list, groups in order.
    Returns (start, count)."""
    start, count = TBD.live_ranges_plain(lp, group_rows)
    n = int(lp.rows.count)
    groups = -(-n // group_rows)
    assert start.shape == count.shape == (groups, lp.src.shape[0])
    at = torch.full((lp.rows.rows.shape[0],), -1, dtype=torch.long)
    listed = lp.rows.rows[:n].long()
    at[listed] = torch.arange(n)
    for o in range(lp.src.shape[0]):
        c = int(lp.counts[o])
        grp = at[lp.dst[o, :c].long()] // group_rows
        assert bool((grp >= 0).all()) and bool((grp[1:] >= grp[:-1]).all())
        want = torch.bincount(grp, minlength=groups)
        assert torch.equal(count[:, o], want), o
        assert torch.equal(start[:, o], want.cumsum(0) - want), o
        # the range's pairs are the group's rows that have one, in order
        for g in range(groups):
            s, m = int(start[g, o]), int(count[g, o])
            rows = listed[g * group_rows:(g + 1) * group_rows]
            live = lp.map[o, g * group_rows:g * group_rows + rows.shape[0]]
            assert torch.equal(lp.dst[o, s:s + m].long(), rows[live >= 0])
    return start, count


def _zero_outside(occ, cin, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(occ.shape[0], cin).astype(np.float32)
    return torch.from_numpy(np.where(occ.numpy()[:, None], x, 0.0)
                            .astype(np.float32))


@pytest.mark.parametrize("role", ["forward", "dilation"])
@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("edge", [4, 8])
def test_live_ranges_match_their_definition(edge, k, role):
    """Every group size's ranges on the occupied rows' list and on the
    k-dilation's (edges 4 and 8, k3 and k5), and the kernel-order model
    bit-equal to the live plain version there (fp32)."""
    t = _fresh(_block_tables(edge)[0])
    occ = TBD.occupancy(t)
    if role == "forward":
        lp = TBD.live_pairs(t, occ, k)
    else:
        rows = TBD.dilation(t, occ, k)[1]
        lp = TBD.live_pair_list(rows, occ, t.block_nbr, edge, k,
                                TBD.live_capacity(t), occ.shape[0])
    x = _zero_outside(occ, 6, seed=edge + k)
    w = torch.from_numpy(np.random.RandomState(k).randn(
        k ** 3, 6, 5).astype(np.float32))
    want = TBD.block_conv_live_plain(x, w, lp)
    for g in GROUP_ROWS:
        _hold_ranges(lp, g)
        assert torch.equal(TBD.block_conv_live_rows_plain(x, w, lp, g), want)


@pytest.mark.parametrize("case", ["empty_group", "dead_offsets",
                                  "at_capacity"])
def test_live_ranges_at_the_edges(case):
    """A group with no live pair (every row of the level listed, sources
    in the first block only), offsets with no pairs (two lone
    occupied cells: the centre alone pairs), and a list at both its
    capacities; the kernel-order model bit-equal to the live plain
    version in each."""
    t = _fresh(_block_tables(4)[0])
    occ = TBD.occupancy(t)
    n_rows, k = occ.shape[0], 3
    if case == "empty_group":
        src = occ.clone()
        src[t.edge ** 3:] = False
        rows = TBD.RowList(*TBD.occupied_rows_plain(torch.ones_like(occ)),
                           None)
        lp = TBD.live_pair_list(rows, src, t.block_nbr, 4, k, n_rows, n_rows)
        occ = src
    elif case == "dead_offsets":
        occ = torch.zeros_like(occ)
        occ[5] = occ[n_rows - 60] = True
        lp = TBD.live_pair_list(TBD.RowList(*TBD.occupied_rows_plain(occ),
                                            None), occ, t.block_nbr, 4, k,
                                2, 2)
    else:
        rows = TBD.RowList(*TBD.occupied_rows_plain(occ), None)
        full = TBD.live_pair_list(rows, occ, t.block_nbr, 4, k)
        cap, n = int(full.counts.max()), int(rows.count)
        lp = TBD.live_pair_list(rows, occ, t.block_nbr, 4, k, cap, n)
        assert lp.src.shape[1] == cap and lp.map.shape[1] == n
    x = _zero_outside(occ, 6, seed=3)
    w = torch.from_numpy(np.random.RandomState(4).randn(27, 6, 5)
                         .astype(np.float32))
    want = TBD.block_conv_live_plain(x, w, lp)
    for g in GROUP_ROWS:
        start, count = _hold_ranges(lp, g)
        if case == "empty_group":
            assert bool((count.sum(1) == 0).any()) and bool(
                (count.sum(1) > 0).any())
        elif case == "dead_offsets":
            assert int(count[:, 13].sum()) == 2
            assert int(count.sum()) == 2 and int((lp.counts > 0).sum()) == 1
        else:
            o = int(lp.counts.argmax())
            assert int(start[-1, o] + count[-1, o]) == lp.src.shape[1]
        assert torch.equal(TBD.block_conv_live_rows_plain(x, w, lp, g), want)
    if case == "empty_group":
        assert bool((want[~TBD.occupancy_dilation_plain(
            occ, t.block_nbr, 4, k)] == 0).all())


@pytest.mark.parametrize("edge,cin,cout", [(4, 12, 20), (8, 24, 16)])
def test_live_rows_plain_matches_jax(edge, cin, cout):
    """The kernel-order model (row groups, ascending offsets) at every
    group size, forward and dX: bit-equal to the live plain version in
    fp32, and against JAX's ``dense_subm_conv`` and ``jax.vjp`` of
    ``_chunked_conv_cd`` (1e-5 x max)."""
    t, x, w, g, want_y, want_dx, _ = _jax_k3(edge, cin, cout)
    t = _fresh(t)
    occ = TBD.occupancy(t)
    fwd, dxl = TBD.live_pairs(t, occ, 3), TBD.dilation_pairs(t, occ, 3)
    dy = torch.where(occ[:, None], g, 0.0)
    wt = w.flip(0).transpose(1, 2).contiguous()
    y, dx = TBD.block_conv_live_plain(x, w, fwd), \
        TBD.block_conv_live_plain(dy, wt, dxl)
    for rows in GROUP_ROWS:
        got_y = TBD.block_conv_live_rows_plain(x, w, fwd, rows)
        got_dx = TBD.block_conv_live_rows_plain(dy, wt, dxl, rows)
        assert torch.equal(got_y, y) and torch.equal(got_dx, dx), rows
        _close(got_y, want_y, REL_JAX, f"forward, groups of {rows}")
        _close(got_dx, want_dx, REL_JAX, f"dX, groups of {rows}")


def test_live_form_rule():
    """The form K10's live-pair path takes by role and level: the
    pair-major form, but bf16 dX at a level of
    ``ROW_GROUPS_MIN_CAP`` voxels or more (the flagship's L0) on
    the row-group kernel; the fp32 forward keeps the pair-major form at
    every level the paired measurement timed (up to the stress scene's
    L0)."""
    for cap in (92160, 190976, 262144, 625664):
        assert TN.live_form(3, F32, cap=cap) == TN.PAIR_MAJOR
        assert TN.live_form(5, F32, cap=cap) == TN.PAIR_MAJOR
    caps = [92160, 36864, 13824, 5530, 2304]
    for dt in (F32, BF16):
        for k in (3, 5):
            assert TN.live_form(k, dt) == TN.PAIR_MAJOR
            for li, cap in enumerate(caps):
                for dx in (False, True):
                    rows = dt == BF16 and k == 3 and dx and li == 0
                    assert TN.live_form(k, dt, dx=dx, cap=cap) == (
                        TN.ROW_GROUPS if rows else TN.PAIR_MAJOR)


# --------------------------------------------------------------------------
# the path rule
# --------------------------------------------------------------------------

def _conv_roles(model):
    """(Cin, Cout, level) of each k3 conv of the model's backbone, the
    stem's (Cin, Cout) beside them."""
    from segdino3d_tpu_torch.models.backbone.res16unet import Res16UNet34C

    cin = 259 if model == "flagship" else 3
    net = Res16UNet34C(in_channels=cin)
    level = {"block1": 1, "block2": 2, "block3": 3, "block4": 4,
             "block5": 3, "block6": 2, "block7": 1, "block8": 0}
    k3 = [(m.kernel.shape[1], m.kernel.shape[2], level[n.split(".")[0]])
          for n, m in net.named_modules()
          if n.endswith(("conv1", "conv2")) and m.kernel.shape[0] == 27]
    assert len(k3) == 46
    return (cin, 32), k3


@pytest.mark.parametrize("model", ["flagship", "baseline"])
def test_path_rule(model):
    """fp32: every stated conv on live pairs in every role (the k5 stem
    too), the Baseline's 3-channel stem on its narrow paths; an unstated
    input never.  bf16: the k5 stem on live pairs; a k3 conv by its role
    and level size as ``BF16_K3_LIVE_MAX_CAP`` and
    ``ROW_GROUPS_MIN_CAP`` measured (the flagship's forward at
    L3-L4, dX at L0 and L2-L4, dW everywhere); dX states its input
    whatever the forward stated."""
    (scin, scout), k3 = _conv_roles(model)
    caps = [92160, 36864, 13824, 5530, 2304]   # the flagship's level caps
    for dt in (F32, BF16):
        for cin, cout, li in k3:
            cap = caps[li]
            for role in ("forward", "dx", "wgrad"):
                ci, co = (cout, cin) if role == "dx" else (cin, cout)
                kw = dict(wgrad=role == "wgrad", dx=role == "dx", cap=cap)
                got = TN.live_path(27, ci, co, dt, True, **kw)
                bf16_levels = {"forward": (3, 4), "dx": (0, 2, 3, 4),
                               "wgrad": (0, 1, 2, 3, 4)}[role]
                assert got == (dt == F32 or li in bf16_levels), \
                    (dt, cin, cout, li, role)
                assert not TN.live_path(27, ci, co, dt, False, **kw)
            # no level size known: the forward's rule at no level
            assert TN.live_path(27, cin, cout, dt, True) == (dt == F32)
        stem = TN.live_path(125, scin, scout, dt, True, cap=caps[0])
        stem_dw = TN.live_path(125, scin, scout, dt, True, wgrad=True,
                               cap=caps[0])
        assert (stem, stem_dw) == ((True, True) if model == "flagship"
                                   else (False, False))
    assert TN.live_path(27, 96, 96, torch.float64, True, dx=True)
