"""The ScanNet v2 path of the port: SpConvUNet, the wrapper's centred xyz
and exact min shift, their plans, the v2 eval slice and a v2 training step,
each against the JAX package on the CPU (the kernels' plain versions).

* Frozen fixture: the full-width SpConvUNet (in_channels 38) and
  Res16UNet34C (35) under the inverse-constructed reference state dicts of
  ``test_backbone_frozen_numerics.py`` (same scenes, seeds and draws),
  loaded through the port's ``train/torch_import.py``, must match
  ``backbone_frozen.npz`` within its ``rtol = atol = 2e-3``.
* A narrow SpConvUNet (planes 8-24) against the JAX apply on the same
  seeded weights (``convert.load_jax_variables``): eval mode and training
  mode (outputs and running statistics) at ``rtol = atol = 1e-4`` (fp32
  sums in another order), every leaf gradient against ``jax.vjp`` at
  ``rtol = 1e-3``, ``atol = 1e-3 x`` the leaf's largest entry.
* The wrapper (``include_centered_xyz``, ``exact_min_shift``) around an
  identity U-Net, so the superpoint features are the pooled voxel means of
  the [rgb | centred xyz | DINO-X] columns: inverse maps equal and
  features within ``1e-5`` of the JAX wrapper's, on host and device plans,
  on scenes whose minimum is not a whole number of voxels (points where
  ``floor((p - min) / v) != floor(p / v) - floor(min / v)``) and with
  elastic coordinates.
* Plans: ``attach_host_plan(exact_min_shift=True, stem_kernel=3)`` equal to
  JAX's; the ``EvalLoader`` prescan's pinned caps equal to JAX's.
* The eval slice: the model of ``configs/prototypes/SegDINO3D_ScanNetv2.py``
  (read by the JAX config loader) at full width, AP, AP50 and AP25 within
  ``1e-6`` of JAX's on host and device plans; and ``chip_smoke.py``'s
  inline copy of that model dict equal to it.
* A v2 training step (a small SpConvUNet, SparseMatcher, ``accum_steps=2``)
  held to ``tests/fixtures/torch_port_spconv_train_step.npz``, frozen from
  the JAX package's ``make_train_step`` at the tolerances of
  ``test_torch_port_train.py``; regenerate with ``python
  tests/test_torch_port_spconv.py --regen``; the live comparison is
  ``-m slow``.
"""
import dataclasses
import json
import os
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_backbone_frozen_numerics import (FIXTURE, _positivize_running_var,  # noqa: E402
                                           _ScaledRNG)
from test_torch_port_jaxlib import load_jax_sparseplan  # noqa: E402
from test_torch_roundtrip import build_res16_torch_sd, build_spconv_torch_sd  # noqa: E402

from segdino3d_tpu import builder as JBU  # noqa: E402
from segdino3d_tpu.config.config import Config  # noqa: E402
from segdino3d_tpu.data import collate as JC  # noqa: E402
from segdino3d_tpu.data.synthetic import synthetic_scene as jax_scene  # noqa: E402
from segdino3d_tpu.models.backbone.res16unet import \
    Res16UNet34C as JaxRes16  # noqa: E402
from segdino3d_tpu.models.backbone.spconv_unet import \
    SpConvUNet as JaxSpConv  # noqa: E402
from segdino3d_tpu.models.backbone.wrapper import \
    SparseBackboneWrapper as JaxWrapper  # noqa: E402
from segdino3d_tpu.ops.host_plan import build_host_plan as jax_build_host_plan  # noqa: E402
from segdino3d_tpu.ops.host_plan import host_plan_to_device  # noqa: E402
from segdino3d_tpu_torch.builder import (Capacities, build_model,  # noqa: E402
                                         host_plan_args)
from segdino3d_tpu_torch.convert import jax_to_state_dict, load_jax_variables  # noqa: E402
from segdino3d_tpu_torch.data import collate as TC  # noqa: E402
from segdino3d_tpu_torch.data.synthetic import synthetic_scene  # noqa: E402
from segdino3d_tpu_torch.models.backbone.res16unet import Res16UNet34C  # noqa: E402
from segdino3d_tpu_torch.models.backbone.spconv_unet import SpConvUNet  # noqa: E402
from segdino3d_tpu_torch.models.backbone.wrapper import SparseBackboneWrapper  # noqa: E402
from segdino3d_tpu_torch.ops import host_plan as TH  # noqa: E402
from segdino3d_tpu_torch.train.torch_import import import_state_dict  # noqa: E402

import test_torch_port_train as T  # noqa: E402

V2_CONFIG = os.path.join(ROOT, "configs", "prototypes",
                         "SegDINO3D_ScanNetv2.py")
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _setup():
    """The JAX plan library (``test_torch_port_jaxlib.py``), and one torch
    thread: the suite runs several test workers at once."""
    load_jax_sparseplan()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def v2_model_cfg():
    """The ``model`` of the ScanNet v2 config, as the JAX config loader
    reads it, as plain dicts and lists."""
    return json.loads(json.dumps(Config.fromfile(V2_CONFIG).model))


def flax_shapes(jmodel, *args):
    """{collection: {path: shape}} of ``jmodel.init(key, *args)``, in the
    flax tree's insertion order (a traced init returns sorted dicts, so
    the order is recorded while tracing)."""
    order = {}

    def paths(tree, prefix=""):
        for k, v in tree.items():
            p = f"{prefix}/{k}" if prefix else k
            yield from paths(v, p) if isinstance(v, dict) else ((p, v),)

    def init(*a):
        v = jmodel.init(jax.random.PRNGKey(0), *a)
        order.update({c: [p for p, _ in paths(v[c])] for c in v})
        return v

    shapes = jax.eval_shape(init, *args)
    flat = {c: dict(paths(shapes[c])) for c in shapes}
    return {c: {p: flat[c][p].shape for p in keys}
            for c, keys in order.items()}


def unflatten(flat):
    tree = {}
    for path, v in flat.items():
        *mods, leaf = path.split("/")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = v
    return tree


def seeded_variables(shapes, seed):
    """Random variables of the flax tree's shapes, drawn with numpy in its
    order: fan-in scaled kernels, scales near 1, small biases and means,
    positive variances."""
    rng = np.random.RandomState(seed)
    out = {}
    for c, leaves in shapes.items():
        flat = {}
        for path, shape in leaves.items():
            name = path.rsplit("/", 1)[-1]
            x = rng.randn(*shape).astype(np.float32)
            if name == "kernel":
                x = x / np.sqrt(np.prod(shape[:-1]))
            elif name == "var":
                x = np.abs(x) + 0.5
            elif name == "scale":
                x = 1.0 + 0.1 * x
            else:
                x = 0.1 * x
            flat[path] = x.astype(np.float32)
        out[c] = unflatten(flat)
    return out


# --------------------------------------------------------------------------
# the frozen fixture, through the port's loader
# --------------------------------------------------------------------------

def bridged_port_output(jmodel, tmodel, build_sd, coords_seed, feats_seed,
                        draw_seed, in_ch, **plan_kw):
    """The port's U-Net output on the fixture's scene (300 points in a 16^3
    cube, caps [512, 256, 128, 64, 32]) under the inverse-constructed
    reference state dict, loaded through the port's ``import_state_dict``,
    masked to valid voxels."""
    coords = np.random.RandomState(coords_seed).randint(
        0, 16, (300, 3)).astype(np.float32)
    bidx, valid = np.zeros(300, np.int32), np.ones(300, bool)
    caps = [512, 256, 128, 64, 32]
    jplan, _ = host_plan_to_device(jax_build_host_plan(
        coords, bidx, valid, caps, stem_compact=False, **plan_kw),
        device=False)
    feats = np.random.RandomState(feats_seed).randn(512, in_ch).astype(
        np.float32)
    shapes = flax_shapes(jmodel, jnp.asarray(feats), jplan)
    want = {c: {p: np.zeros(s, np.float32) for p, s in leaves.items()}
            for c, leaves in shapes.items()}
    sd = _positivize_running_var(build_sd(want["params"],
                                          want["batch_stats"],
                                          _ScaledRNG(draw_seed)))
    port_sd, unmapped = import_state_dict(sd)
    assert unmapped == []
    prefix = "backbone.unet."
    assert all(k.startswith(prefix) for k in port_sd)
    tmodel.load_state_dict({k[len(prefix):]: v for k, v in port_sd.items()},
                           strict=True)
    tplan = TH.host_plan_to_device(
        TH.build_host_plan(coords, bidx, valid, caps, **plan_kw), "cpu")
    with torch.no_grad():
        out = tmodel.eval()(torch.from_numpy(feats), tplan)
    return out.numpy() * tplan.levels[0].valid[:, None].numpy()


def test_spconv_matches_frozen_fixture():
    out = bridged_port_output(JaxSpConv(in_channels=38),
                              SpConvUNet(in_channels=38),
                              build_spconv_torch_sd, 9, 13, 5, 38,
                              stem_kernel=3)
    assert out.shape == (512, 32)
    np.testing.assert_allclose(out, np.load(FIXTURE)["spconv"], rtol=2e-3,
                               atol=2e-3)


def test_res16_matches_frozen_fixture_through_the_loader():
    out = bridged_port_output(JaxRes16(in_channels=35, out_channels=96),
                              Res16UNet34C(in_channels=35),
                              build_res16_torch_sd, 7, 11, 3, 35)
    np.testing.assert_allclose(out, np.load(FIXTURE)["res16"], rtol=2e-3,
                               atol=2e-3)


# --------------------------------------------------------------------------
# a narrow SpConvUNet against the JAX apply
# --------------------------------------------------------------------------

NARROW = (8, 12, 16, 20, 24)
NARROW_IN = 38


@pytest.fixture(scope="module")
def narrow():
    """The narrow U-Net in both packages on one plan (3,000 points in a
    64^3 cube: every level keeps enough voxels for batch norm in training
    mode), with seeded weights, features and an output cotangent."""
    coords = np.random.RandomState(0).randint(0, 64, (3000, 3)).astype(
        np.float32)
    bidx, valid = np.zeros(3000, np.int32), np.ones(3000, bool)
    caps = [3072, 3072, 2048, 512, 128]
    jplan, _ = host_plan_to_device(jax_build_host_plan(
        coords, bidx, valid, caps, stem_kernel=3), device=False)
    tplan = TH.host_plan_to_device(TH.build_host_plan(
        coords, bidx, valid, caps, stem_kernel=3), "cpu")
    assert [int(lv.valid.sum()) for lv in tplan.levels][4] >= 40
    rng = np.random.RandomState(1)
    feats = rng.randn(caps[0], NARROW_IN).astype(np.float32)
    cot = rng.randn(caps[0], NARROW[0]).astype(np.float32)
    jmodel = JaxSpConv(num_planes=NARROW, in_channels=NARROW_IN)
    variables = seeded_variables(
        flax_shapes(jmodel, jnp.asarray(feats), jplan), seed=2)
    tmodel = load_jax_variables(
        SpConvUNet(num_planes=NARROW, in_channels=NARROW_IN), variables)
    mask = tplan.levels[0].valid[:, None].numpy().astype(np.float32)
    return dict(jmodel=jmodel, jplan=jplan, tplan=tplan, feats=feats,
                cot=cot * mask, mask=mask, variables=variables,
                tmodel=tmodel)


def test_convert_round_trips_the_spconv_tree(narrow):
    """``convert.py`` carries the SpConvUNet tree both ways with its one
    rule (``blocks_l0_1`` -> ``blocks_l0.1``, ``down_norm_2`` ->
    ``down_norm.2``, the ``i_branch`` Dense transposed)."""
    from segdino3d_tpu_torch.convert import state_dict_to_jax
    from test_torch_roundtrip import _flatten

    back = state_dict_to_jax(narrow["tmodel"].state_dict())
    for c in ("params", "batch_stats"):
        got, want = _flatten(back[c]), _flatten(narrow["variables"][c])
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    sd = narrow["tmodel"].state_dict()
    assert sd["tail_l0.0.i_branch.weight"].shape == (NARROW[0], 2 * NARROW[0])
    assert "down_norm.3.running_var" in sd and "blocks_l4.1.conv2.kernel" in sd


def test_narrow_eval_matches_jax_apply(narrow):
    n = narrow
    want = jax.jit(lambda v, f, p: n["jmodel"].apply(v, f, p, False))(
        n["variables"], jnp.asarray(n["feats"]), n["jplan"])
    with torch.no_grad():
        got = n["tmodel"].eval()(torch.from_numpy(n["feats"]), n["tplan"])
    want = np.asarray(want) * n["mask"]
    assert np.abs(want).mean() > 1e-2
    np.testing.assert_allclose(got.numpy() * n["mask"], want, **TOL)


def test_narrow_training_mode_matches_jax(narrow):
    """Outputs, running statistics and every leaf gradient of one
    training-mode forward and backward."""
    n = narrow
    jmodel = n["jmodel"]

    @jax.jit
    def step(v, f, p, g):
        def fwd(params):
            return jmodel.apply({"params": params,
                                 "batch_stats": v["batch_stats"]}, f, p,
                                True, mutable=["batch_stats"])
        out, vjp, upd = jax.vjp(fwd, v["params"], has_aux=True)
        return out, upd["batch_stats"], vjp(g)[0]

    out, stats, grads = jax.device_get(step(
        n["variables"], jnp.asarray(n["feats"]), n["jplan"],
        jnp.asarray(n["cot"])))
    tmodel = load_jax_variables(
        SpConvUNet(num_planes=NARROW, in_channels=NARROW_IN),
        n["variables"]).train()
    got = tmodel(torch.from_numpy(n["feats"]), n["tplan"])
    (got * torch.from_numpy(n["cot"])).sum().backward()

    np.testing.assert_allclose(got.detach().numpy() * n["mask"],
                               np.asarray(out) * n["mask"], **TOL)
    buffers = dict(tmodel.named_buffers())
    want_stats = jax_to_state_dict({"batch_stats": stats})
    assert sorted(want_stats) == sorted(buffers)
    for k, v in want_stats.items():
        np.testing.assert_allclose(buffers[k].numpy(), v.numpy(), err_msg=k,
                                   **TOL)
    want_grads = jax_to_state_dict({"params": grads})
    params = dict(tmodel.named_parameters())
    assert sorted(want_grads) == sorted(params)
    for k, v in want_grads.items():
        w = v.numpy()
        np.testing.assert_allclose(params[k].grad.numpy(), w, rtol=1e-3,
                                   atol=1e-3 * np.abs(w).max(), err_msg=k)


# --------------------------------------------------------------------------
# the wrapper: centred xyz and the exact min shift
# --------------------------------------------------------------------------

WRAP_POINTS, WRAP_S = 2048, 128
WRAP_SCENE = dict(n_points=1800, n_superpoints=100, n_classes=18,
                  n_queries2d=12, feat_dim_2d=32)


class _JaxIdentity(fnn.Module):
    @fnn.compact
    def __call__(self, feats, plan, train=False):
        return feats


class _PortIdentity(torch.nn.Module):
    """The identity of the U-Net's 38 input channels: the wrapper gives the
    stem its rows at their 16-byte pitch (``narrow.row_pitch``, 40 in
    fp32), zero past Cin, which it drops as the stem's padded weight
    does."""
    stem_kernel = 3

    def forward(self, feats, plan):
        assert feats.shape[1] == 40 and not feats[:, 38:].any()
        return feats[:, :38]


def wrapper_records(case):
    """Two seeded scenes; the second shifted by a fraction of a voxel
    ("offgrid"), or both with elastic coordinates ("elastic")."""
    recs = []
    for seed in (3, 4):
        t, j = synthetic_scene(seed, **WRAP_SCENE), jax_scene(seed,
                                                              **WRAP_SCENE)
        for k in j:
            assert np.array_equal(np.asarray(t[k]), np.asarray(j[k])), k
        recs.append(t)
    if case == "offgrid":
        recs[1]["points"] = recs[1]["points"].copy()
        recs[1]["points"][:, :3] += np.float32([0.013, -0.0071, 0.0309])
    elif case == "elastic":
        for i, r in enumerate(recs):
            rng = np.random.RandomState(20 + i)
            r["elastic_coords"] = (r["points"][:, :3] / 0.02 * 1.03
                                   + rng.uniform(-0.4, 0.4, (len(r["points"]),
                                                             3))
                                   ).astype(np.float32)
    return recs


@pytest.mark.parametrize("case", ["offgrid", "elastic"])
def test_wrapper_matches_jax(case):
    recs = wrapper_records(case)
    spec_j = JC.PadSpec(WRAP_POINTS, WRAP_S, 16, 16, 20)
    spec_t = TC.PadSpec(WRAP_POINTS, WRAP_S, 16, 16, 20)
    if case == "offgrid":
        # points that the exact shift puts in another voxel than the
        # integer one would
        xyz = recs[1]["points"][:, :3]
        lo = xyz.min(0)
        assert np.abs(lo / 0.02 - np.round(lo / 0.02)).min() > 0.1
        diff = np.floor((xyz - lo) / 0.02) != \
            np.floor(xyz / 0.02) - np.floor(lo / 0.02)
        assert diff.any(axis=1).sum() > 100
    jw = JaxWrapper(unet=_JaxIdentity(), voxel_size=0.02, s_cap=WRAP_S,
                    voxel_cap=WRAP_POINTS * 2, stem_kernel=3,
                    include_centered_xyz=True, exact_min_shift=True)
    tw = SparseBackboneWrapper(_PortIdentity(), (1.0, 0.7, 0.35, 0.12, 0.05),
                               voxel_size=0.02, s_cap=WRAP_S,
                               voxel_cap=WRAP_POINTS * 2,
                               include_centered_xyz=True,
                               exact_min_shift=True)
    japply = jax.jit(lambda b: jw.apply({}, b, False))
    plan_kw = dict(voxel_size=0.02, stem_kernel=3, exact_min_shift=True)
    jb = JC.attach_host_plan(JC.collate(recs, spec_j), recs, spec_j,
                             **plan_kw)
    tb = TC.attach_host_plan(TC.collate(recs, spec_t, "cpu"), recs, spec_t,
                             **plan_kw)
    host_inverse = np.asarray(jb.plan_inverse_mapping)
    np.testing.assert_array_equal(tb.plan.inverse.numpy(), host_inverse)
    bare = TC.collate(recs, spec_t, "cpu")
    dev_plan, overflow = tw.device_plan(
        bare.points.reshape(-1, 6)[:, :3], bare.point_valid,
        bare.elastic_coords)
    assert not bool(overflow)
    np.testing.assert_array_equal(dev_plan.inverse.numpy(), host_inverse)
    for jbatch, tbatch in ((jb, tb), (JC.collate(recs, spec_j), bare)):
        want = jax.device_get(japply(jbatch))
        with torch.no_grad():
            got = tw(tbatch)
        assert got.sp_feats.shape == (2, WRAP_S, 38)
        assert np.abs(np.asarray(want.sp_feats)[..., 3:6]).max() > 0.1
        for k in ("sp_feats", "sp_pos", "sp_pos_wo_elastic"):
            np.testing.assert_allclose(getattr(got, k).numpy(),
                                       np.asarray(getattr(want, k)),
                                       rtol=1e-5, atol=1e-5, err_msg=k)


def test_host_plans_and_prescan_match_jax(tmp_path):
    """Host plans with the exact shift and a k3 stem equal JAX's, on
    scenes read by the v2 reader through both ``EvalLoader``s, and the
    prescan pins the same caps."""
    from segdino3d_tpu.data import bucketing as JBK
    from segdino3d_tpu.data import loader as JL
    from segdino3d_tpu.data import scannet_dataset as JD
    from segdino3d_tpu_torch.data import bucketing as TBK
    from segdino3d_tpu_torch.data import loader as TL
    from segdino3d_tpu_torch.data import scannet_dataset as TD
    from segdino3d_tpu_torch.data.synthetic import write_scannet_layout
    from test_torch_port_eval_loader import _assert_plans_equal

    root = str(tmp_path)
    write_scannet_layout(root, (0, 1, 2), n_points=2000, n_superpoints=100,
                         n_classes=18, n_instances=5, n_queries2d=12,
                         feat_dim_2d=32)
    kw = dict(scene_set="val", root_scenes=root,
              root_points_2dfeats=os.path.join(root, "features_2d"))
    cfg = host_plan_args(v2_model_cfg())
    assert cfg == dict(voxel_size=0.02, stem_kernel=3, block_edges=None,
                       exact_min_shift=True, stem_gather=False)

    def policy(cls):
        return cls.default(20, max_points=2048, max_superpoints=128,
                           max_instances=16, max_queries2d=16)

    tl = TL.EvalLoader(TD.ScanNetInstanceSeg3D(**kw),
                       bucket_policy=policy(TBK.BucketPolicy),
                       host_plan_cfg=cfg, prefetch=0, device="cpu")
    jl = JL.EvalLoader(JD.ScanNetInstanceSeg3D(**kw),
                       bucket_policy=policy(JBK.BucketPolicy),
                       host_plan_cfg=cfg, prefetch=0)
    got, want = list(tl), list(jl)
    assert len(got) == len(want) == 3
    for (_, tb), (_, jb) in zip(got, want):
        _assert_plans_equal(tb.plan, jb.unet_plan, jb.plan_inverse_mapping)
    caps_t, caps_j = tl._prescan(), jl._prescan()
    assert caps_t and {dataclasses.astuple(k): v for k, v in caps_t.items()} \
        == {dataclasses.astuple(k): v for k, v in caps_j.items()}
    # the integer shift would count the levels on another grid
    recs = [tl.dataset.get_record(i, np.random.RandomState(0))
            for i in range(3)]
    spec = next(iter(caps_t))
    exact = TC._plan_coords(recs, spec.num_points, 0.02, True)[0]
    assert not np.array_equal(
        exact, TC._plan_coords(recs, spec.num_points, 0.02)[0])


# --------------------------------------------------------------------------
# the v2 eval slice at the config's widths
# --------------------------------------------------------------------------

V2_POINTS, V2_S = 2048, 128
V2_SCENE = dict(n_points=2000, n_superpoints=100, n_classes=18,
                n_queries2d=12, feat_dim_2d=256)


def test_chip_smoke_v2_model_is_the_config():
    import chip_smoke

    assert json.loads(json.dumps(chip_smoke.v2_model_cfg())) == \
        v2_model_cfg()


def test_v2_builder():
    model, test_cfg = build_model(v2_model_cfg(),
                                  Capacities(num_superpoints=V2_S),
                                  device="cpu")
    bb = model.backbone
    assert isinstance(bb.unet, SpConvUNet)
    assert bb.include_centered_xyz and bb.exact_min_shift
    assert bb.unet.input_conv.kernel.shape == (27, 262, 32)
    assert bb.unet.blocks_l4[1].norm1.eps == 1e-4
    assert bb.unet.blocks_l4[1].norm1.momentum == 0.1
    assert model.decoder.dinox_ca[0].k_proj.weight.shape == (256, 256)
    assert model.decoder.out_cls.layers[2].weight.shape[0] == 19
    assert test_cfg["topk_insts"] == 600


@pytest.fixture(scope="module")
def v2_pair():
    """The v2 model in both packages, with one set of seeded weights, and
    two seeded scenes."""
    cfg = v2_model_cfg()
    jmodel, _, test_cfg = JBU.build_model(cfg, JBU.Capacities(
        num_points=V2_POINTS, num_voxels=V2_POINTS,
        num_superpoints=V2_S, num_instances=16, num_queries2d=16))
    tmodel, t_test_cfg = build_model(
        cfg, Capacities(num_superpoints=V2_S, num_voxels=V2_POINTS),
        device="cpu")
    assert t_test_cfg == test_cfg
    spec_j = JC.PadSpec(V2_POINTS, V2_S, 16, 16, 20)
    seeds = (0, 1)
    jrecs = [jax_scene(s, **V2_SCENE) for s in seeds]
    variables = seeded_variables(
        _v2_shapes(jmodel, JC.collate(jrecs[:1], spec_j)), seed=0)
    load_jax_variables(tmodel, variables)
    return dict(cfg=cfg, jmodel=jmodel, tmodel=tmodel, test_cfg=test_cfg,
                variables=variables, jrecs=jrecs,
                trecs=[synthetic_scene(s, **V2_SCENE) for s in seeds])


@pytest.mark.parametrize("plan", ["host", "device"])
def test_v2_ap_matches_jax(v2_pair, plan):
    from segdino3d_tpu.evaluation.evaluate import evaluate as jax_evaluate
    from segdino3d_tpu.evaluation.evaluator import \
        InstanceSeg3DEvaluator as JaxEvaluator
    from segdino3d_tpu_torch.data.scannet_constants import (
        SCANNET20_CLASS_NAMES, SCANNET20_RAW_IDS)
    from segdino3d_tpu_torch.evaluation.evaluate import evaluate
    from segdino3d_tpu_torch.evaluation.evaluator import \
        InstanceSeg3DEvaluator

    p = v2_pair
    spec_j = JC.PadSpec(V2_POINTS, V2_S, 16, 16, 20)
    spec_t = TC.PadSpec(V2_POINTS, V2_S, 16, 16, 20)
    jbs = [JC.collate([r], spec_j) for r in p["jrecs"]]
    tbs = [TC.collate([r], spec_t, "cpu") for r in p["trecs"]]
    if plan == "host":
        args = host_plan_args(p["cfg"])
        jbs = [JC.attach_host_plan(b, [r], spec_j, **args)
               for b, r in zip(jbs, p["jrecs"])]
        tbs = [TC.attach_host_plan(b, [r], spec_t, **args)
               for b, r in zip(tbs, p["trecs"])]
    jev = JaxEvaluator(SCANNET20_RAW_IDS, SCANNET20_CLASS_NAMES)
    tev = InstanceSeg3DEvaluator(SCANNET20_RAW_IDS, SCANNET20_CLASS_NAMES)
    want = jax_evaluate(p["jmodel"], p["variables"],
                        [([r], b) for r, b in zip(p["jrecs"], jbs)], jev,
                        p["test_cfg"], bg_class_id=20, progress=False)
    got = evaluate(p["tmodel"], [([r], b) for r, b in zip(p["trecs"], tbs)],
                   tev, p["test_cfg"], bg_class_id=20)
    for key in ("all_ap", "all_ap_50", "all_ap_25"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6,
                                   err_msg=key)
    # random weights score no instance, so the AP alone says little: the
    # instances that the evaluators scored must agree too (a multiset of
    # label, mask and score; slots whose scores tie may trade places)
    for (ta, tp), (ja, jp) in zip(tev._results, jev._results, strict=True):
        np.testing.assert_array_equal(ta["pts_semantic_mask"],
                                      ja["pts_semantic_mask"])
        assert len(jp["instance_labels"]) > 10
        pool = {}
        for m, lab, sc in zip(jp["pts_instance_masks"],
                              jp["instance_labels"], jp["instance_scores"]):
            pool.setdefault((int(lab), np.asarray(m).tobytes()),
                            []).append(float(sc))
        for m, lab, sc in zip(tp["pts_instance_masks"],
                              tp["instance_labels"], tp["instance_scores"]):
            cands = pool.get((int(lab), np.asarray(m).tobytes()), [])
            hit = [i for i, c in enumerate(cands)
                   if np.isclose(c, sc, rtol=1e-4, atol=1e-4)]
            assert hit, f"instance {lab} ({sc:.5f}) has no JAX counterpart"
            cands.pop(hit[0])


def _v2_shapes(jmodel, batch):
    """The whole v2 model's variable shapes (sorted order)."""
    shapes = jax.eval_shape(
        lambda b: jmodel.init({"params": jax.random.PRNGKey(0),
                               "queries": jax.random.PRNGKey(1)}, b, False),
        batch)
    return {c: {"/".join(str(getattr(k, "key", k)) for k in path): leaf.shape
                for path, leaf in jax.tree_util.tree_leaves_with_path(
                    shapes[c])} for c in shapes}


# --------------------------------------------------------------------------
# a v2 training step, held to the frozen JAX step
# --------------------------------------------------------------------------

STEP_FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                            "torch_port_spconv_train_step.npz")
STEP_PLANES = [16, 24, 32, 40, 48]


def step_cfg():
    """The v2 config's model and criterion at reduced size: SpConvUNet
    planes 16-48 on 32-channel DINO-X features, 2 decoder layers of width
    64, the scenes and capacities of ``test_torch_port_train.py``."""
    cfg = v2_model_cfg()
    cfg["pointcloud_backbone_cfg"].update(num_planes=STEP_PLANES,
                                          in_channels=T.FEAT2D + 6)
    cfg["decoder_cfg"].update(num_layers=2, d_model=64,
                              in_channels=STEP_PLANES[0])
    return cfg


def step_plan_args():
    """The v2 training plans at the capacity of ``test_torch_port_train``;
    the sparse scenes keep most voxels at every level, so every level gets
    the full cap."""
    return dict(host_plan_args(step_cfg(), train=True), voxel_cap=T.VOXEL_CAP,
                level_cap_ratios=(1.0,) * 5)


def jax_step_reference():
    """The JAX package's ``accum_steps=2`` step of the v2 step model on
    ``T.records()`` -> the fixture's contents (``T.jax_step``)."""
    cfg = step_cfg()
    jmodel, jcrit, _ = JBU.build_model(cfg, JBU.Capacities(
        num_points=T.N_POINTS, num_voxels=T.VOXEL_CAP,
        num_superpoints=T.S_CAP, num_instances=T.I_CAP,
        num_queries2d=T.K2D))
    spec = JC.PadSpec(T.N_POINTS, T.S_CAP, T.I_CAP, T.K2D, T.N_SEM)
    mbs = [JC.attach_host_plan(JC.collate([r], spec), [r], spec,
                               **step_plan_args()) for r in T.records()]
    return T.jax_step(jmodel, jcrit, mbs, T.initial_variables(cfg=cfg))


def port_v2_step():
    """The port's step of the v2 step model on the same microbatches, from
    the same variables (``T.port_step``)."""
    cfg = step_cfg()
    return T.port_step(T.initial_variables(cfg=cfg), layout=step_plan_args(),
                       cfg=cfg)


def test_v2_train_step_matches_frozen_jax_step():
    assert os.path.exists(STEP_FIXTURE), "fixture missing: run --regen"
    port = port_v2_step()
    assert isinstance(port["model"].backbone.unet, SpConvUNet)
    T.check_against(port, dict(np.load(STEP_FIXTURE, allow_pickle=True)))


@pytest.mark.slow
def test_v2_train_step_matches_live_jax_step():
    T.check_against(port_v2_step(), jax_step_reference())


def regen():
    import time

    jax.config.update("jax_platforms", "cpu")
    load_jax_sparseplan()
    t0 = time.perf_counter()
    out = jax_step_reference()
    np.savez_compressed(STEP_FIXTURE, **out)
    print(f"wrote {STEP_FIXTURE} in {time.perf_counter() - t0:.0f} s: "
          f"metrics {out['metrics'].item()}")


if __name__ == "__main__":
    if "--regen" in sys.argv:
        regen()
    else:
        print(__doc__)
