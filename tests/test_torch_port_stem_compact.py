"""The degree-compacted k5 stem in both packages.

The port's compacted-stem host-plan tables (slots, overflow pairs), the
count-only plan probe, the plain version of ``stem_compact_conv`` (the
wide product and K12's slot sum), the Res16UNet34C and the eval slice on
compacted-stem plans, each against the JAX package on the same inputs
(made with numpy from seeds).  K12 itself runs on the card only
(``test_torch_port_kernels.py``).

Tolerances: integer tables and counts are equal; the conv ``rtol = 1e-4,
atol = 2e-4`` (the same fp32 products summed in another order, over ~28
rows of a 125-wide product); the backbone ``1e-4`` of the JAX apply and
``2e-3`` of ``backbone_frozen.npz["res16"]`` (the fixture's allowance);
the eval slice's outputs ``1e-4`` and AP, AP50 and AP25 within ``1e-6``.
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

from segdino3d_tpu.data.synthetic import synthetic_scene as jax_scene  # noqa: E402
from segdino3d_tpu.ops import host_plan as JH  # noqa: E402
from segdino3d_tpu.ops import sparse_conv as JSC  # noqa: E402
from segdino3d_tpu_torch.builder import host_plan_args  # noqa: E402
from segdino3d_tpu_torch.models.backbone.res16unet import make_level_ctxs  # noqa: E402
from segdino3d_tpu_torch.ops import host_plan as TH  # noqa: E402
from segdino3d_tpu_torch.ops import sparse_conv as TSC  # noqa: E402
from segdino3d_tpu_torch.ops.conv_ctx import CompactStemCtx  # noqa: E402

CONV_TOL = dict(rtol=1e-4, atol=2e-4)
TOL = dict(rtol=1e-4, atol=1e-4)
CAPS = [10240, 6144, 3072, 1536, 768]
LAYOUTS = {"gather": {}, "hybrid": dict(block_edges=[4] * 5,
                                        stem_gather=True)}


@pytest.fixture(scope="module", autouse=True)
def _setup():
    """The JAX plan library (``test_torch_port_jaxlib.py``), and one torch
    thread: the suite runs several test workers at once."""
    load_jax_sparseplan()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene_coords():
    """The 12,000-point scene of ``test_host_plan.py``'s compacted-stem
    test, in min-shifted voxel units."""
    r = jax_scene(3, n_points=12000, n_superpoints=96, n_classes=18,
                  feat_dim_2d=8)
    c = np.asarray(r["points"][:, :3], np.float32) / 0.02
    c -= np.floor(c.min(0) / 16.0) * 16.0
    return c, np.zeros(c.shape[0], np.int32), np.ones(c.shape[0], bool)


@pytest.mark.parametrize("ov_cap", ["heuristic", "too_small"])
@pytest.mark.parametrize("slots", [8, 32])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_compact_tables_match_jax(layout, slots, ov_cap):
    """``too_small`` pins an overflow capacity below the pair count, which
    forces the one rebuild at the pairs' bucket."""
    coords, bidx, valid = _scene_coords()
    kw = dict(LAYOUTS[layout], stem_compact=True, stem_compact_slots=slots,
              stem_ov_cap=4096 if ov_cap == "too_small" else None)
    want = JH.build_host_plan(coords, bidx, valid, CAPS, **kw)
    got = TH.build_host_plan(coords, bidx, valid, CAPS, **kw)
    assert got.stem_nbr is None and want.stem_nbr is None
    assert got.stem_slots.shape == (slots, CAPS[0])
    n_pairs = int((got.stem_ov_src >= 0).sum())
    assert n_pairs > 0                      # overflow pairs present
    if ov_cap == "too_small":
        assert n_pairs > 4096 and got.stem_ov_src.shape[0] > 4096
    for k in ("stem_slots", "stem_ov_src", "stem_ov_dst"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
    np.testing.assert_array_equal(got.inverse_mapping, want.inverse_mapping)
    dst = got.stem_ov_dst
    assert (np.diff(dst) >= 0).all()        # voxel-major, K12's contract

    tplan = TH.host_plan_to_device(got, "cpu")
    ctxs, stem = make_level_ctxs(tplan)
    assert isinstance(stem, CompactStemCtx) and tplan.stem_nbr is None
    assert (tplan.blocks is not None) == (layout == "hybrid")


@pytest.mark.parametrize("case", ["gather_stem", "hybrid_stem", "k3_stem",
                                  "no_stem_probe"])
def test_probe_plan_counts_matches_jax(case):
    coords, bidx, valid = _scene_coords()
    kw = {"gather_stem": dict(block_edges=[], stem_kernel=5, stem_slots=8),
          "hybrid_stem": dict(block_edges=[4] * 5, stem_kernel=5,
                              stem_slots=32),
          "k3_stem": dict(block_edges=[8, 4, 0, 4, 8], stem_kernel=3,
                          stem_slots=12),
          "no_stem_probe": dict(block_edges=[4] * 5)}[case]
    want = JH.probe_plan_counts(coords, bidx, valid, **kw)
    got = TH.probe_plan_counts(coords, bidx, valid, **kw)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)
    assert got[2] == want[2]
    assert (got[2] > 0) == (case in ("gather_stem", "hybrid_stem",
                                     "k3_stem"))


def test_stem_buckets_match_jax():
    for d in list(range(1, 140)):
        assert TH.stem_degree_bucket(d) == JH.stem_degree_bucket(d)
    for n in list(range(0, 20000, 97)) + [130895, 10 ** 6]:
        assert TH.overflow_bucket(n) == JH.overflow_bucket(n)
    assert TH.stem_slots_default() == 32
    for d in (5, 8, 20, 32, 100):
        assert TH.stem_slots_default(d) == JH.stem_slots_default(d)


def test_host_plan_args_name_the_compacted_stem():
    bcfg = dict(block_edges=(4,) * 5, stem_gather=True)
    off = host_plan_args(dict(pointcloud_backbone_cfg=bcfg))
    assert "stem_compact" not in off and "stem_compact_slots" not in off
    on = host_plan_args(dict(pointcloud_backbone_cfg=dict(
        bcfg, stem_compact=True, stem_compact_slots=16)))
    assert on["stem_compact"] is True and on["stem_compact_slots"] == 16
    train = host_plan_args(dict(pointcloud_backbone_cfg=dict(
        bcfg, stem_compact=True)), train=True)
    assert "stem_compact" not in train     # eval only


def _compact_inputs(slots, seed=0, cin=19, cout=8):
    coords, bidx, valid = _scene_coords()
    plan = TH.build_host_plan(coords, bidx, valid, CAPS, stem_compact=True,
                              stem_compact_slots=slots)
    gather = TH.build_host_plan(coords, bidx, valid, CAPS)
    v = plan.stem_slots.shape[1]
    rng = np.random.RandomState(seed)
    feats = rng.randn(v, cin).astype(np.float32)
    w = (rng.randn(125, cin, cout) * 0.1).astype(np.float32)
    vmask = np.arange(v) < plan.levels[0].num_voxels
    return plan, gather, feats, w, vmask


@pytest.mark.parametrize("slots", [8, 32])
def test_stem_compact_conv_plain_matches_jax_and_gather_stem(slots):
    plan, gather, feats, w, vmask = _compact_inputs(slots)
    tables = (plan.stem_slots, plan.stem_ov_src, plan.stem_ov_dst)
    want = np.asarray(JSC.stem_compact_conv(
        jnp.asarray(feats), jnp.asarray(w), *map(jnp.asarray, tables),
        jnp.asarray(vmask)))
    got = TSC.stem_compact_conv(
        torch.from_numpy(feats), torch.from_numpy(w),
        *map(torch.from_numpy, tables), torch.from_numpy(vmask))
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, **CONV_TOL)
    with torch.no_grad():
        ref = TSC.subm_conv(torch.from_numpy(feats),
                            torch.from_numpy(gather.stem_nbr),
                            torch.from_numpy(w), torch.from_numpy(vmask))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **CONV_TOL)


def test_stem_slot_sum_plain_takes_any_pair_order():
    """The plain slot sum adds every slot >= 0 and every overflow pair to
    its voxel, with gaps in the slots and pairs in any order (K12's
    contract is narrower: the plan's ascending ``ov_dst``)."""
    rng = np.random.RandomState(1)
    y2 = torch.from_numpy(rng.randn(40, 5).astype(np.float32))
    slots = torch.tensor([[3, -1, 7], [-1, -1, 2], [9, 0, -1]],
                         dtype=torch.int32)
    ov_src = torch.tensor([5, -1, 11, 6], dtype=torch.int32)
    ov_dst = torch.tensor([2, 3, 0, 2], dtype=torch.int32)
    valid = torch.tensor([True, True, False])
    got = TSC.stem_slot_sum(y2, slots, ov_src, ov_dst, valid)
    want = torch.stack([y2[3] + y2[9] + y2[11], y2[0],
                        torch.zeros(5)])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_stem_compact_conv_refuses_a_backward():
    plan, _, feats, w, vmask = _compact_inputs(32)
    args = [torch.from_numpy(a) for a in (plan.stem_slots, plan.stem_ov_src,
                                          plan.stem_ov_dst, vmask)]
    wt = torch.from_numpy(w).requires_grad_()
    with pytest.raises(RuntimeError, match="inference only"):
        TSC.stem_compact_conv(torch.from_numpy(feats), wt, *args)
    with torch.no_grad():
        TSC.stem_compact_conv(torch.from_numpy(feats), wt, *args)


@pytest.fixture(scope="module")
def bridged_models():
    from test_torch_port_backbone import bridged_models as models

    return models()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_res16_on_compact_stem_plans_matches_jax_and_fixture(bridged_models,
                                                             layout):
    """The bridged weights of ``test_torch_port_backbone.py`` on
    compacted-stem plans (``RES16_VARIANTS["compact_stem"]`` of
    ``test_backbone_frozen_numerics.py``, and its hybrid counterpart); D =
    8 so that overflow pairs take part."""
    from test_backbone_frozen_numerics import FIXTURE
    from test_torch_port_backbone import CAPS as BB_CAPS

    m = bridged_models
    coords, bidx, valid = m["points"]
    kw = dict(LAYOUTS[layout], stem_compact=True, stem_compact_slots=8)
    jhost = JH.build_host_plan(coords, bidx, valid, BB_CAPS, **kw)
    assert int((jhost.stem_ov_src >= 0).sum()) > 0
    jplan, _ = JH.host_plan_to_device(jhost, device=False)
    tplan = TH.host_plan_to_device(
        TH.build_host_plan(coords, bidx, valid, BB_CAPS, **kw), "cpu")
    assert tplan.stem_compact is not None
    jout = jax.jit(lambda v, f, p: m["jmodel"].apply(v, f, p, False))(
        m["variables"], jnp.asarray(m["feats"]), jplan)
    with torch.no_grad():
        tout = m["tmodel"](torch.from_numpy(m["feats"]), tplan)
    mask = tplan.levels[0].valid[:, None].numpy().astype(np.float32)
    port, jax_out = tout.numpy() * mask, np.asarray(jout) * mask
    assert np.abs(jax_out).mean() > 1e-3
    np.testing.assert_allclose(port, jax_out, **TOL)
    np.testing.assert_allclose(port, np.load(FIXTURE)["res16"], rtol=2e-3,
                               atol=2e-3)


def test_compact_stem_eval_slice_matches_jax():
    """The small SegDINO3D of ``test_torch_port_model.py`` (seeded weights
    carried into the port) on compacted-stem plans of two of its scenes:
    outputs, then AP of the two eval drivers."""
    import __graft_entry__ as ge
    from test_torch_port_model import (CLASS_IDS, CLASS_NAMES, N_CLS, N_SEM,
                                       PORT_CFG, S_CAP, SCENE,
                                       _seeded_variables)

    from segdino3d_tpu.data import collate as JC
    from segdino3d_tpu.evaluation.evaluate import evaluate as jax_evaluate
    from segdino3d_tpu.evaluation.evaluator import \
        InstanceSeg3DEvaluator as JaxEvaluator
    from segdino3d_tpu_torch.builder import Capacities, build_model
    from segdino3d_tpu_torch.convert import load_jax_variables
    from segdino3d_tpu_torch.data import collate as TC
    from segdino3d_tpu_torch.data.synthetic import synthetic_scene
    from segdino3d_tpu_torch.evaluation.evaluate import evaluate
    from segdino3d_tpu_torch.evaluation.evaluator import \
        InstanceSeg3DEvaluator

    cfg = dict(PORT_CFG, pointcloud_backbone_cfg=dict(
        PORT_CFG["pointcloud_backbone_cfg"], stem_compact=True,
        stem_compact_slots=8))
    args = host_plan_args(cfg)
    jmodel, _, test_cfg, _, _ = ge._build(
        n_points=2048, s_cap=S_CAP, i_cap=16, k2d=16, num_layers=2,
        d_model=64, n_sem=N_SEM, n_inst_cls=N_CLS,
        feat2d=SCENE["feat_dim_2d"], init=False)
    jspec = JC.PadSpec(2048, S_CAP, 16, 16, N_SEM)
    tspec = TC.PadSpec(2048, S_CAP, 16, 16, N_SEM)
    variables = _seeded_variables(jmodel, JC.collate(
        [jax_scene(0, **SCENE)], jspec))
    tmodel, _ = build_model(cfg, Capacities(num_superpoints=S_CAP),
                            device="cpu")
    load_jax_variables(tmodel, variables)
    apply = jax.jit(lambda v, b: jmodel.apply(v, b, False)[0])
    jpairs, tpairs = [], []
    for seed in (0, 1):
        rec, jrec = synthetic_scene(seed, **SCENE), jax_scene(seed, **SCENE)
        jb = JC.attach_host_plan(JC.collate([jrec], jspec), [jrec], jspec,
                                 **args)
        tb = TC.attach_host_plan(TC.collate([rec], tspec, "cpu"), [rec],
                                 tspec, **args)
        assert tb.plan.stem_compact is not None
        assert jb.unet_plan.stem_compact is not None
        with torch.no_grad():
            tout = tmodel(tb)
        jout = jax.device_get(apply(variables, jb))
        for key in ("cls_preds", "masks", "sem_preds", "centers", "sizes"):
            np.testing.assert_allclose(tout[key].numpy(),
                                       np.asarray(jout[key]), **TOL,
                                       err_msg=key)
        jpairs.append(([jrec], jb))
        tpairs.append(([rec], tb))
    want = jax_evaluate(jmodel, variables, jpairs,
                        JaxEvaluator(CLASS_IDS, CLASS_NAMES), test_cfg,
                        progress=False)
    got = evaluate(tmodel, tpairs, InstanceSeg3DEvaluator(CLASS_IDS,
                                                          CLASS_NAMES),
                   test_cfg)
    for key in ("all_ap", "all_ap_50", "all_ap_25"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6,
                                   err_msg=key)
