"""The block-dense conv layout in both packages.

The port's host-plan block tables, its slot gather (K9), halo padding, block
conv (K10) and weight gradient (K11) in their plain versions, the
Res16UNet34C on hybrid and block-dense plans, each against the JAX package
on the same inputs (made with numpy from seeds).  The eval slice on hybrid
plans is in ``test_torch_port_block_dense_model.py``.

Tolerances: integer tables, the slot gather and the halo padding are
exact; the conv and its gradients ``rtol = atol = 1e-4`` (the same fp32
products summed in another order); the backbone ``1e-4`` of the JAX apply
and ``2e-3`` of ``backbone_frozen.npz["res16"]`` (the fixture's own
allowance, as in ``test_torch_port_backbone.py``).
"""
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
from segdino3d_tpu_torch.builder import host_plan_args  # noqa: E402
from segdino3d_tpu_torch.ops import block_dense as TBD  # noqa: E402
from segdino3d_tpu_torch.ops import host_plan as TH  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
CAPS = [2048, 1280, 512, 128, 64]


@pytest.fixture(scope="module", autouse=True)
def _setup():
    """The JAX plan library (``test_torch_port_jaxlib.py``), and one torch
    thread: the suite runs several test workers at once."""
    load_jax_sparseplan()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _points(seed, n=700, box=22, batches=2):
    rng = np.random.RandomState(seed)
    coords = rng.uniform(0, box, (batches * n, 3)).astype(np.float32)
    bidx = np.repeat(np.arange(batches, dtype=np.int32), n)
    return coords, bidx, rng.rand(batches * n) > 0.05


LAYOUTS = {
    "hybrid": dict(block_edges=[4] * 5, stem_gather=True),
    "block_dense": dict(block_edges=[4] * 5),
    "mixed_edges": dict(block_edges=[8, 4, 0, 4, 8]),
    "pinned_caps": dict(block_edges=[4] * 5, block_caps=[512, 128, 64, 32,
                                                         16]),
    "k3_stem_gather": dict(block_edges=[4] * 5, stem_gather=True,
                           stem_kernel=3),
    "l0_crossover": dict(block_edges=[4] * 5, stem_gather=False,
                         l0_budget_bytes=1),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_host_plan_block_tables_match_jax(layout):
    kw = LAYOUTS[layout]
    coords, bidx, valid = _points(0)
    want = JH.build_host_plan(coords, bidx, valid, CAPS, stem_compact=False,
                              **kw)
    got = TH.build_host_plan(coords, bidx, valid, CAPS, **kw)
    assert got.overflow == want.overflow is False
    np.testing.assert_array_equal(got.inverse_mapping, want.inverse_mapping)
    assert (got.stem_nbr is None) == (want.stem_nbr is None)
    if want.stem_nbr is not None:
        np.testing.assert_array_equal(got.stem_nbr, want.stem_nbr)
    for g, w in zip(got.levels, want.levels, strict=True):
        assert (g.num_voxels, g.num_blocks, g.block_edge) == \
            (w.num_voxels, w.num_blocks, w.block_edge)
        for a, b in ((g.subm_nbr, w.subm_nbr), (g.vox_slot, w.vox_slot),
                     (g.block_nbr, w.block_nbr), (g.parent_idx, w.parent_idx),
                     (g.parent_kpos, w.parent_kpos)):
            assert (a is None) == (b is None)
            if b is not None:
                np.testing.assert_array_equal(a, b)
    if layout == "l0_crossover":
        assert got.levels[0].block_edge == 0 and got.stem_nbr is not None
    if layout == "pinned_caps":
        assert [lv.block_nbr.shape[1] for lv in got.levels] == \
            kw["block_caps"]
    # the device plan: inverse tables, and the stem table only where the
    # stem runs the gather layout
    jplan, _ = JH.host_plan_to_device(want, device=False)
    tplan = TH.host_plan_to_device(got, "cpu")
    assert (tplan.stem_nbr is None) == (jplan.stem_nbr is None)
    for li, (t, j) in enumerate(zip(tplan.blocks, jplan.blocks)):
        assert (t is None) == (j is None)
        if t is not None:
            assert t.edge == j.edge
            np.testing.assert_array_equal(t.slot_vox.numpy(), j.slot_vox)
            np.testing.assert_array_equal(
                TBD.occupancy(t).numpy(),
                np.asarray(JBD.occupancy(j, jplan.levels[li].valid)))
        np.testing.assert_array_equal(tplan.levels[li].valid.numpy(),
                                      np.asarray(jplan.levels[li].valid))


def test_buckets_and_layout_crossover_match_jax():
    for n in list(range(0, 300)) + [1353, 5689, 40000]:
        assert TH.block_bucket(n) == JH.block_bucket(n)
    for b, budget in ((5689, 1 << 30), (5689, 100 << 20), (120000, 1 << 30)):
        assert TH.l0_dense_fits(b, 4, budget) == \
            JH.l0_dense_fits(b, 4, budget=budget)


def test_host_plan_args_follow_the_config():
    cfg = dict(pointcloud_backbone_cfg=dict(
        block_edges=(4,) * 5, stem_gather=True, block_edges_train=(8,) * 5,
        voxel_size=0.02, config=dict(conv1_kernel_size=5)))
    assert host_plan_args(cfg) == dict(voxel_size=0.02, stem_kernel=5,
                                       block_edges=(4,) * 5,
                                       stem_gather=True)
    assert host_plan_args(cfg, train=True) == dict(
        voxel_size=0.02, stem_kernel=5, block_edges=(8,) * 5)
    bare = dict(pointcloud_backbone_cfg=dict(block_edges=(4, 4, 0, 4, 4)))
    assert host_plan_args(bare, train=True)["block_edges"] == (4, 4, 0, 4, 4)
    assert host_plan_args(bare)["stem_gather"] is False
    with pytest.raises(NotImplementedError, match="block edges"):
        host_plan_args(dict(pointcloud_backbone_cfg=dict(block_edges=(2,))))


def _tables(edges=(4,) * 5, seed=2, level=0):
    """(port BlockTables, JAX BlockTables, JAX valid) of one level."""
    coords, bidx, valid = _points(seed)
    kw = dict(block_edges=list(edges))
    jplan, _ = JH.host_plan_to_device(JH.build_host_plan(
        coords, bidx, valid, CAPS, stem_compact=False, **kw), device=False)
    tplan = TH.host_plan_to_device(
        TH.build_host_plan(coords, bidx, valid, CAPS, **kw), "cpu")
    return tplan.blocks[level], jplan.blocks[level], jplan.levels[level].valid


@pytest.mark.parametrize("level", [0, 1])
def test_slot_gather_matches_jax_scatter_and_gather(level):
    """K9's plain version both ways against ``scatter_to_dense`` and
    ``gather_from_dense``, and each one's gradient against ``jax.vjp``."""
    t, j, jvalid = _tables(level=level)
    rng = np.random.RandomState(3)
    v, n_dense = t.vox_slot.shape[0], t.slot_vox.shape[0]
    feats = np.where(np.asarray(jvalid)[:, None],
                     rng.randn(v, 9), 0.0).astype(np.float32)
    g_dense = rng.randn(n_dense, 9).astype(np.float32)
    g_vox = rng.randn(v, 9).astype(np.float32)

    jd, j_bwd = jax.vjp(lambda f: JBD.scatter_to_dense(f, j),
                        jnp.asarray(feats))
    x = torch.from_numpy(feats).requires_grad_()
    td = TBD.scatter_to_dense(x, t)
    np.testing.assert_array_equal(td.detach().numpy(), np.asarray(jd))
    td.backward(torch.from_numpy(g_dense))
    np.testing.assert_array_equal(x.grad.numpy(),
                                  np.asarray(j_bwd(jnp.asarray(g_dense))[0]))

    dense = rng.randn(n_dense, 9).astype(np.float32)
    jv, j_bwd = jax.vjp(lambda d: JBD.gather_from_dense(d, j),
                        jnp.asarray(dense))
    d = torch.from_numpy(dense).requires_grad_()
    tv = TBD.gather_from_dense(d, t)
    np.testing.assert_array_equal(tv.detach().numpy(), np.asarray(jv))
    tv.backward(torch.from_numpy(g_vox))
    np.testing.assert_array_equal(d.grad.numpy(),
                                  np.asarray(j_bwd(jnp.asarray(g_vox))[0]))


@pytest.mark.parametrize("halo", [1, 2])
def test_halo_pad_plain_matches_jax(halo):
    t, j, _ = _tables()
    rng = np.random.RandomState(4)
    x = rng.randn(t.num_blocks, 4, 4, 4, 3).astype(np.float32)
    np.testing.assert_array_equal(
        TBD.halo_pad_plain(torch.from_numpy(x), t.block_nbr, halo).numpy(),
        np.asarray(JBD.halo_pad(jnp.asarray(x), j.block_nbr, halo)))


@pytest.mark.parametrize("halo", [1, 2])
def test_halo_pad_reaches_a_present_diagonal_past_absent_faces(halo):
    """Block 1 is block 0's (+x, +y) diagonal neighbour and both faces
    between them are absent: the diagonal's cells still fill that edge of
    the halo (the trap of ``block_dense.py:161-165``)."""
    shell = TBD._shell_dirs()
    nbr = np.full((26, 2), -1, np.int32)
    nbr[shell.index((1, 1, 0)), 0] = 1
    nbr[shell.index((-1, -1, 0)), 1] = 0
    assert nbr[TBD.FACE_XP, 0] == nbr[TBD.FACE_YP, 0] == -1
    x = np.random.RandomState(5).randn(2, 4, 4, 4, 2).astype(np.float32)
    got = TBD.halo_pad_plain(torch.from_numpy(x), torch.from_numpy(nbr),
                             halo).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(JBD.halo_pad(jnp.asarray(x), jnp.asarray(nbr), halo)))
    h, e = halo, 4
    np.testing.assert_array_equal(got[0, e + h:, e + h:, h:e + h],
                                  x[1, :h, :h])
    np.testing.assert_array_equal(got[1, :h, :h, h:e + h], x[0, e - h:, e - h:])
    assert not got[0, e + h:, h:e + h].any()      # the absent +x face


@pytest.mark.parametrize("edge", [4, 8])
@pytest.mark.parametrize("k", [3, 5])
def test_dense_subm_conv_matches_jax(edge, k):
    """The forward (plain K10) and its gradients (K10 as dX, K11) against
    ``dense_subm_conv`` and ``jax.vjp`` of it, on every dense cell."""
    t, j, jvalid = _tables(edges=(edge,) * 5)
    occ = TBD.occupancy(t)
    rng = np.random.RandomState(6)
    cin, cout = 7, 5
    dense = np.where(occ.numpy()[:, None], rng.randn(occ.shape[0], cin),
                     0.0).astype(np.float32)
    w = (rng.randn(k ** 3, cin, cout) * 0.2).astype(np.float32)
    g = rng.randn(occ.shape[0], cout).astype(np.float32)

    jocc = JBD.occupancy(j, jvalid)
    jout, j_bwd = jax.vjp(lambda d, wt: JBD.dense_subm_conv(d, jocc, j, wt),
                          jnp.asarray(dense), jnp.asarray(w))
    jd, jw = j_bwd(jnp.asarray(g))
    d = torch.from_numpy(dense).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = TBD.dense_subm_conv(d, occ, t, wt)
    out.backward(torch.from_numpy(g))
    assert np.abs(np.asarray(jout)).max() > 0.1
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(jd), **TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jw), **TOL)


@pytest.fixture(scope="module")
def bridged_models():
    from test_torch_port_backbone import bridged_models as models

    return models()


@pytest.mark.parametrize("layout", ["hybrid", "block_dense"])
def test_res16_on_block_plans_matches_jax_and_fixture(bridged_models, layout):
    """The bridged weights of ``test_torch_port_backbone.py`` on the
    ``hybrid`` and ``block_dense`` plans of
    ``test_backbone_frozen_numerics.py``'s variants."""
    from test_backbone_frozen_numerics import FIXTURE
    from test_torch_port_backbone import layout_outputs

    kw = dict(block_edges=[4] * 5, stem_gather=layout == "hybrid")
    port, jax_out = layout_outputs(bridged_models, **kw)
    assert np.abs(jax_out).mean() > 1e-3
    np.testing.assert_allclose(port, jax_out, **TOL)
    np.testing.assert_allclose(port, np.load(FIXTURE)["res16"], rtol=2e-3,
                               atol=2e-3)
