"""K1's schedule (``csrc/gather_gemm_conv.cu``, ``csrc/gather_tile.cuh``) in
plain PyTorch, on the CPU.

On the card K1 multiplies each offset's live pairs only: per offset, the
rows that have a neighbour there (K4's pair list, ``gather_pairs``, cached
per table by ``cached_pairs``), in work items of 64 consecutive pairs of
one offset and one column tile; each item's products go to a pair-major
buffer and each pair's index to an (n_off, V) map; then each row adds its
products in ascending offset order.  Here:

* a plain model of that schedule (``pairs_model``) against
  ``gather_conv_plain`` at 1e-6 x max|plain|, on the tables of a small host
  plan and of a small device plan, in every role K1 plays (the k5 stem,
  each level's k3 conv and its dX, the down convs and the up convs' dX),
  and its pair index map against its definition;
* the model and the port's plain path against the JAX package's
  ``_subm_conv_impl`` (its im2col and its matmul-first branch) and
  ``down_conv`` at 1e-5 x max|reference|;
* the work items of the headline scene's stem and k3 convs, which
  outnumber an H100's 132 SMs at every level;
* K1 and K4 keying one cached pair list per table.
"""
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

from segdino3d_tpu.ops import sparse_conv as JSC  # noqa: E402
from segdino3d_tpu.ops.host_plan import \
    build_host_plan as jax_build_host_plan  # noqa: E402
from segdino3d_tpu.ops.host_plan import host_plan_to_device  # noqa: E402
from segdino3d_tpu_torch.models.backbone.res16unet import build_unet_plan  # noqa: E402
from segdino3d_tpu_torch.ops import host_plan as TH  # noqa: E402
from segdino3d_tpu_torch.ops import sparse_conv as TSC  # noqa: E402
from segdino3d_tpu_torch.ops import voxelize as TV  # noqa: E402

CAPS = [1024, 512, 256, 128, 64]
REL = 1e-5
ITEM_PAIRS = 64


@pytest.fixture(scope="module", autouse=True)
def _setup():
    load_jax_sparseplan()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _points(seed=5, n=900, box=16):
    rng = np.random.RandomState(seed)
    coords = rng.uniform(0, box, (n, 3)).astype(np.float32)
    return coords, np.zeros(n, np.int32), rng.rand(n) > 0.05


def _plan(kind):
    coords, bidx, valid = _points()
    if kind == "host":
        return TH.host_plan_to_device(
            TH.build_host_plan(coords, bidx, valid, CAPS), "cpu")
    grid = TV.voxelize(torch.from_numpy(bidx), torch.from_numpy(coords),
                       torch.from_numpy(valid), CAPS[0])
    plan, overflow = build_unet_plan(grid, 5, 5, CAPS)
    assert not bool(overflow)
    return plan


def column_tile(cout):
    """The kernel's column tile: Cout up to 96 rounded up to 32, 64 or 96,
    else 64 (``pair_bn`` in gather_gemm_conv.cu)."""
    return 32 if cout <= 32 else 64 if cout <= 64 or cout > 96 else 96


def work_items(nbr, cout):
    """K1's work items on a table: (64-pair groups of each offset) x
    column tiles."""
    groups = int((-(-(nbr >= 0).sum(1) // ITEM_PAIRS)).sum())
    return groups * -(-cout // column_tile(cout))


def pairs_model(feats, nbr, weights, valid):
    """K1 as the kernel schedules it, in fp32: per offset, its live pairs
    (K4's plain list) multiplied in items of 64 into a pair-major buffer,
    the pair index of (o, row) kept in a map; then each valid row adds its
    products in ascending offset order.  Returns (out, map)."""
    x, w = feats.float(), weights.float()
    pairs = TSC.gather_pairs_plain(None, nbr)
    counts = pairs.counts.tolist()
    first = np.concatenate([[0], np.cumsum(counts)])
    partial = x.new_zeros(int(first[-1]), w.shape[2])
    pos = torch.full(nbr.shape, -1, dtype=torch.long)
    for o, n in enumerate(counts):
        for j0 in range(0, n, ITEM_PAIRS):
            rows = pairs.rows[o, j0:min(n, j0 + ITEM_PAIRS)].long()
            at = int(first[o]) + j0 + torch.arange(rows.shape[0])
            partial[at] = x[nbr[o, rows].long()] @ w[o]
            pos[o, rows] = at
    out = x.new_zeros(nbr.shape[1], w.shape[2])
    for o in range(nbr.shape[0]):
        live = (pos[o] >= 0) & valid
        out[live] += partial[pos[o, live]]
    return out.to(feats.dtype), pos


def _roles(plan):
    """(name, nbr, valid, input rows, Cin, Cout) of every K1 call of a
    gather-layout step: the stem, each level's k3 conv and its dX (the
    mirror identity: Cin and Cout swapped), each down conv over the child
    table and each up conv's dX over it (every row valid)."""
    lv = plan.levels
    v = [t.valid.shape[0] for t in lv]
    widths = [(32, 32), (32, 64), (64, 128), (128, 256), (256, 256)]
    roles = [("stem", plan.stem_nbr, lv[0].valid, v[0], 259, 32)]
    for i, t in enumerate(lv):
        cin, cout = widths[i]
        roles += [(f"k3 L{i}", t.nbr, t.valid, v[i], cin, cout),
                  (f"k3 dX L{i}", t.nbr, t.valid, v[i], cout, cin)]
    for i, t in enumerate(lv[:-1]):
        cin, cout = widths[i][1], widths[i + 1][0]
        every = torch.ones(v[i + 1], dtype=torch.bool)
        roles += [(f"down L{i}", t.child, lv[i + 1].valid, v[i], cin, cout),
                  (f"up dX L{i}", t.child, every, v[i], cout, cin)]
    return roles


@pytest.mark.parametrize("kind", ["host", "device"])
def test_pairs_model_matches_plain(kind):
    plan = _plan(kind)
    rng = np.random.RandomState(7)
    for name, nbr, valid, rows, cin, cout in _roles(plan):
        n_off = nbr.shape[0]
        x = torch.from_numpy(rng.randn(rows, cin).astype(np.float32))
        w = torch.from_numpy((rng.randn(n_off, cin, cout)
                              / np.sqrt(n_off * cin)).astype(np.float32))
        got, pos = pairs_model(x, nbr, w, valid)
        want = TSC.gather_conv_plain(x, nbr, w, valid)
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-6 * float(want.abs().max()),
                                   msg=lambda m: f"{name}: {m}")
        assert not got[~valid].any(), name
        # the map: pair (o, row) is the offset's first pair plus the row's
        # rank among the offset's live rows
        live = (nbr >= 0).long()
        first = torch.cumsum(live.sum(1), 0) - live.sum(1)
        rank = torch.cumsum(live, 1) - live
        assert torch.equal(pos, torch.where(live > 0, first[:, None] + rank,
                                            -1)), name


@pytest.mark.parametrize("case", ["im2col", "matmul_first", "down"])
def test_pairs_model_matches_jax(case):
    coords, bidx, valid = _points(seed=6)
    jplan, _ = host_plan_to_device(jax_build_host_plan(
        coords, bidx, valid, CAPS, stem_compact=False), device=False)
    tplan = TH.host_plan_to_device(
        TH.build_host_plan(coords, bidx, valid, CAPS), "cpu")
    rng = np.random.RandomState(sum(map(ord, case)))
    if case == "down":
        x = rng.randn(CAPS[2], 64).astype(np.float32)
        w = (rng.randn(8, 64, 128) / np.sqrt(8 * 64)).astype(np.float32)
        want = np.asarray(JSC.down_conv(jnp.asarray(x), jplan.levels[2],
                                        jplan.levels[3], jnp.asarray(w)))
        nbr, tvalid = tplan.levels[2].child, tplan.levels[3].valid
    else:
        stem = case == "matmul_first"          # 259 > 2 * 32
        cin, cout = (259, 32) if stem else (96, 96)
        nbr_j = jplan.stem_nbr if stem else jplan.subm_nbr[0]
        nbr, tvalid = (tplan.stem_nbr if stem else tplan.levels[0].nbr,
                       tplan.levels[0].valid)
        x = rng.randn(CAPS[0], cin).astype(np.float32)
        w = (rng.randn(nbr.shape[0], cin, cout)
             / np.sqrt(nbr.shape[0] * cin)).astype(np.float32)
        want = np.asarray(JSC._subm_conv_impl(
            jnp.asarray(x), jnp.asarray(nbr_j), jnp.asarray(w),
            jnp.asarray(jplan.levels[0].valid)))
    scale = float(np.abs(want).max())
    assert scale > 0
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    for got in (pairs_model(xt, nbr, wt, tvalid)[0],
                TSC.gather_conv(xt, nbr, wt, tvalid)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=REL * scale)


def test_headline_levels_fill_the_card():
    """On chip_smoke.py's 120,000-point scene the stem and every level's k3
    conv have more work items than an H100 has SMs (132), the 290-row
    level 4 too.  (The down convs of levels 2 and 3, 8 offsets of a few
    thousand rows, have fewer: a few microseconds of work.)"""
    import chip_smoke as C
    from segdino3d_tpu_torch.data.collate import _plan_coords
    from segdino3d_tpu_torch.data.synthetic import synthetic_scene

    rec = synthetic_scene(0, **dict(C.SCENE, feat_dim_2d=8))
    coords, valid, bidx = _plan_coords([rec], C.SCENE["n_points"], 0.02)
    coords, valid = coords.reshape(-1, 3), valid.reshape(-1)
    cap = TH.voxel_bucket(TH.probe_voxel_count(coords, bidx, valid))
    caps = [max(256, -(-int(cap * r) // 256) * 256)
            for r in C.LEVEL_CAP_RATIOS]
    caps[0] = cap
    plan = TH.build_host_plan(coords, bidx, valid, caps)
    items = {"stem": work_items(plan.stem_nbr, 32)}
    for i, (lv, c) in enumerate(zip(plan.levels, (96, 96, 64, 128, 256))):
        items[f"k3 L{i}"] = work_items(lv.subm_nbr, c)
    assert plan.levels[4].num_voxels < 300
    assert min(items.values()) > 132, items


def test_k1_and_k4_share_a_pair_list_per_table():
    """K1 keys each table's list as (None, table), K4's dW of the same conv
    as (table, None) or (None, table): one list per table and step."""
    plan = _plan("host")
    for table in (plan.stem_nbr, plan.levels[1].nbr, plan.levels[0].child):
        k1 = TSC.cached_pairs(None, table)
        assert TSC.cached_pairs(table, None) is k1
        assert TSC.cached_pairs(None, table) is k1
