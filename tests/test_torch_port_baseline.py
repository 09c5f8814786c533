"""The Baseline_ScanNet200 model in the port against the JAX package (CPU).

``configs/prototypes/Baseline_ScanNet200.py`` is the paper's ablation
baseline: rgb-only backbone input (``mode_fuse_2d_feat="only_rgb"``,
``in_channels=3``), no DINO-X cross-attention, and no 2D features read.

* the port builds the config (read by the JAX config loader) and
  ``chip_smoke.baseline_model_cfg()`` is that config;
* the eval slice and the ScanNet200 AP of a small Baseline (2 decoder
  layers of width 64) equal JAX's (AP within 1e-6, scored instances
  matched) on the config's hybrid host plans and on device plans;
* a training step equals the frozen JAX ``make_train_step``
  (``tests/fixtures/torch_port_baseline_train_step.npz``; regenerate with
  ``JAX_PLATFORMS=cpu python tests/test_torch_port_baseline.py --regen``;
  the live comparison is ``-m slow``) on the config's block-dense
  training plans;
* the ScanNet200 reader with ``root_points_2dfeats=None`` and the
  ``EvalLoader`` (prescan included) equal the JAX ones;
* the architecture's options on a second small model (plain decoder with
  objectness and a two-layer semantic head, ``query_num`` top-k,
  ``add_positional_embedding=False``): the top-k indices and the GT
  gathered to them equal JAX's exactly, and the eval AP with objectness
  scores is within 1e-6 of the JAX ``evaluate``;
* weights: ``convert`` round-trips the Baseline tree and the options
  tree, and a Baseline-shaped reference state dict loads bit-equal to the
  JAX ``import_state_dict``, with no missing key.
"""
import copy
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from test_torch_port_jaxlib import load_jax_sparseplan  # noqa: E402
from test_torch_port_reference_import import (assert_bit_equal,  # noqa: E402
                                              export_decoder, jax_side,
                                              tree_of)
from test_torch_port_spconv import _v2_shapes, seeded_variables  # noqa: E402
from test_torch_roundtrip import _flatten, build_res16_torch_sd  # noqa: E402

from segdino3d_tpu import builder as JBU  # noqa: E402
from segdino3d_tpu.config.config import Config  # noqa: E402
from segdino3d_tpu.data import collate as JC  # noqa: E402
from segdino3d_tpu.data.synthetic import synthetic_scene as jax_scene  # noqa: E402
from segdino3d_tpu_torch.builder import (Capacities, build_model,  # noqa: E402
                                         host_plan_args)
from segdino3d_tpu_torch.convert import (load_jax_variables,  # noqa: E402
                                         state_dict_to_jax)
from segdino3d_tpu_torch.data import collate as TC  # noqa: E402
from segdino3d_tpu_torch.data.synthetic import synthetic_scene  # noqa: E402
from segdino3d_tpu_torch.train import torch_import as TI  # noqa: E402

import test_torch_port_train as T  # noqa: E402

BASELINE_CONFIG = os.path.join(ROOT, "configs", "prototypes",
                               "Baseline_ScanNet200.py")
STEP_FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                            "torch_port_baseline_train_step.npz")
POINTS, S_CAP = 2048, 128
SCENE = dict(n_points=2000, n_superpoints=100, n_classes=180, n_instances=8,
             n_queries2d=12, feat_dim_2d=32)
SEEDS = (0, 1)
TOL = dict(rtol=1e-4, atol=1e-4)
N_SEM = 200


@pytest.fixture(scope="module", autouse=True)
def _setup():
    """The JAX plan library, and one torch thread: the suite runs several
    test workers at once."""
    load_jax_sparseplan()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def baseline_cfg():
    """The ``model`` of the Baseline config, as the JAX config loader reads
    it, as plain dicts and lists."""
    return json.loads(json.dumps(Config.fromfile(BASELINE_CONFIG).model))


def small_cfg(**decoder):
    """The Baseline with 2 decoder layers of width 64 (the backbone at its
    published width); ``decoder`` overrides decoder options."""
    cfg = baseline_cfg()
    cfg["decoder_cfg"].update(dict(num_layers=2, d_model=64, hidden_dim=128),
                              **decoder)
    return cfg


def options_cfg():
    """The architecture's options: a plain decoder (no PE, no box heads)
    with objectness and a two-layer semantic head, ``query_num`` top-k
    queries, no query positions."""
    cfg = small_cfg(add_positional_embedding=False, box_modulate_ca=False,
                    add_box_size_pred=False, normalize_box_prediction=False,
                    objectness_flag=True, num_semantic_linears=2)
    cfg.update(query_num=24, add_positional_embedding=False)
    return cfg


def rgb_only(rec):
    """A record as the reader gives it with ``root_points_2dfeats=None``."""
    return dict(rec, points_2dfeats=None, query2d_feats=None,
                query2d_pos=None)


def jax_caps():
    return JBU.Capacities(num_points=POINTS, num_voxels=POINTS,
                          num_superpoints=S_CAP, num_instances=16,
                          num_queries2d=16)


def make_pair(cfg):
    """(JAX model, port model, test_cfg, variables, JAX records, port
    records) of ``cfg`` with one set of seeded weights."""
    jmodel, _, test_cfg = JBU.build_model(cfg, jax_caps())
    tmodel, t_test_cfg = build_model(
        cfg, Capacities(num_superpoints=S_CAP, num_voxels=POINTS),
        device="cpu")
    assert t_test_cfg == test_cfg
    spec = JC.PadSpec(POINTS, S_CAP, 16, 16, N_SEM)
    jrecs = [rgb_only(jax_scene(s, **SCENE)) for s in SEEDS]
    variables = seeded_variables(
        _v2_shapes(jmodel, JC.collate(jrecs[:1], spec)), seed=0)
    load_jax_variables(tmodel, variables)
    return dict(cfg=cfg, jmodel=jmodel, tmodel=tmodel, test_cfg=test_cfg,
                variables=variables, jrecs=jrecs,
                trecs=[rgb_only(synthetic_scene(s, **SCENE)) for s in SEEDS])


@pytest.fixture(scope="module")
def baseline_pair():
    return make_pair(small_cfg())


@pytest.fixture(scope="module")
def options_pair():
    return make_pair(options_cfg())


def batches(p, plan):
    """(JAX batches, port batches) of the pair's scenes on ``plan``: the
    config's eval host plan ("host") or none ("device": each package
    builds it on its device)."""
    spec_j = JC.PadSpec(POINTS, S_CAP, 16, 16, N_SEM)
    spec_t = TC.PadSpec(POINTS, S_CAP, 16, 16, N_SEM)
    jbs = [JC.collate([r], spec_j) for r in p["jrecs"]]
    tbs = [TC.collate([r], spec_t, "cpu") for r in p["trecs"]]
    assert all(b.points_2dfeats is None and b.query2d_feats is None
               for b in jbs + tbs)
    if plan == "host":
        args = host_plan_args(p["cfg"])
        jbs = [JC.attach_host_plan(b, [r], spec_j, **args)
               for b, r in zip(jbs, p["jrecs"])]
        tbs = [TC.attach_host_plan(b, [r], spec_t, **args)
               for b, r in zip(tbs, p["trecs"])]
    return jbs, tbs


def assert_ap_matches(p, jbs, tbs):
    """The two packages' ``evaluate`` on the scenes: AP within 1e-6, and
    each scored instance (label, mask, score) of the port's in JAX's."""
    from segdino3d_tpu.evaluation.evaluate import evaluate as jax_evaluate
    from segdino3d_tpu.evaluation.evaluator import \
        InstanceSeg3DEvaluator as JaxEvaluator
    from segdino3d_tpu_torch.data.scannet_constants import (
        SCANNET200_CLASS_NAMES, SCANNET200_RAW_IDS)
    from segdino3d_tpu_torch.evaluation.evaluate import evaluate
    from segdino3d_tpu_torch.evaluation.evaluator import \
        InstanceSeg3DEvaluator

    # on rgb alone, random weights give superpoint features that vary
    # little, and masks whose logits are all below -1 on the small scenes:
    # a low superpoint threshold, no mask-score normalisation (which
    # zeroes a mask without a positive logit) and a low point threshold
    # keep instances scored, on both sides
    test_cfg = dict(p["test_cfg"], sp_score_thr=0.15, npoint_thr=10,
                    obj_normalization=False)
    jev = JaxEvaluator(SCANNET200_RAW_IDS, SCANNET200_CLASS_NAMES)
    tev = InstanceSeg3DEvaluator(SCANNET200_RAW_IDS, SCANNET200_CLASS_NAMES)
    want = jax_evaluate(p["jmodel"], p["variables"],
                        [([r], b) for r, b in zip(p["jrecs"], jbs)], jev,
                        test_cfg, progress=False)
    got = evaluate(p["tmodel"], [([r], b) for r, b in zip(p["trecs"], tbs)],
                   tev, test_cfg)
    for key in ("all_ap", "all_ap_50", "all_ap_25"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6,
                                   err_msg=key)
    for (ta, tp), (ja, jp) in zip(tev._results, jev._results, strict=True):
        np.testing.assert_array_equal(ta["pts_semantic_mask"],
                                      ja["pts_semantic_mask"])
        assert len(jp["instance_labels"]) > 0
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


# --------------------------------------------------------------------------
# the config and the builder
# --------------------------------------------------------------------------

def test_chip_smoke_baseline_model_is_the_config():
    import chip_smoke

    assert json.loads(json.dumps(chip_smoke.baseline_model_cfg())) == \
        baseline_cfg()


def test_baseline_builder():
    cfg = baseline_cfg()
    model, test_cfg = build_model(cfg, Capacities(num_superpoints=S_CAP),
                                  device="cpu")
    assert model.backbone.mode_fuse_2d_feat == "only_rgb"
    assert model.backbone.unet.conv0p1s1.kernel.shape == (125, 3, 32)
    dec = model.decoder
    assert not hasattr(dec, "dinox_ca") and not dec.add_dinox_query_ca
    assert not any("dinox" in k for k in model.state_dict())
    assert dec.out_cls.layers[2].weight.shape[0] == 199
    assert test_cfg["topk_insts"] == 600
    assert host_plan_args(cfg)["stem_gather"]
    assert host_plan_args(cfg, train=True)["block_edges"] == (4,) * 5


# --------------------------------------------------------------------------
# eval
# --------------------------------------------------------------------------

@pytest.mark.parametrize("plan", ["host", "device"])
def test_baseline_eval_matches_jax(baseline_pair, plan):
    """The eval slice (superpoint features and the decoder's heads) at
    1e-4, then the AP."""
    p = baseline_pair
    jbs, tbs = batches(p, plan)
    if plan == "host":
        assert tbs[0].plan.blocks is not None and \
            tbs[0].plan.stem_nbr is not None
    apply = jax.jit(lambda v, b: p["jmodel"].apply(v, b, False)[0])
    jout = jax.device_get(apply(p["variables"], jbs[0]))
    with torch.no_grad():
        tout = p["tmodel"](tbs[0])
    for k in ("cls_preds", "masks", "sem_preds", "centers", "sizes"):
        np.testing.assert_allclose(tout[k].numpy(), jout[k], err_msg=k, **TOL)
    assert_ap_matches(p, jbs, tbs)


def test_options_model_eval_ap_with_objectness_matches_jax(options_pair):
    p = options_pair
    jbs, tbs = batches(p, "host")
    with torch.no_grad():
        out = p["tmodel"](tbs[0])
    assert out["scores"].shape == (1, 24, 1) and out["centers"] is None
    assert out["masks"].shape == (1, 24, S_CAP)
    assert_ap_matches(p, jbs, tbs)


# --------------------------------------------------------------------------
# the architecture's options
# --------------------------------------------------------------------------

def test_topk_queries_and_gathered_gt_match_jax(options_pair):
    """A training forward: the top-k superpoints (exact indices), their
    validity, the GT gathered to them, and the outputs at 1e-4."""
    p = options_pair
    jbs, tbs = batches(p, "host")
    (jout, jgt), _ = jax.jit(lambda v, b: p["jmodel"].apply(
        v, b, True, rngs={"queries": jax.random.PRNGKey(0)},
        mutable=["batch_stats"]))(p["variables"], jbs[0])
    jout, jgt = jax.device_get((jout, jgt))
    tmodel = copy.deepcopy(p["tmodel"]).train()
    tout, tgt = tmodel(tbs[0])
    np.testing.assert_array_equal(tout["query_sp_idx"].numpy(),
                                  jout["query_sp_idx"])
    np.testing.assert_array_equal(tout["query_valid"].numpy(),
                                  jout["query_valid"])
    assert tout["query_sp_idx"].shape == (1, 24)
    for k in ("query_masks", "query_sem_targets", "query_valid"):
        np.testing.assert_array_equal(tgt[k].numpy(), jgt[k], err_msg=k)
    for k in ("cls_preds", "masks", "sem_preds", "scores"):
        np.testing.assert_allclose(tout[k].detach().numpy(), jout[k],
                                   err_msg=k, **TOL)
    assert jout["centers"] is None and tout["centers"] is None


# --------------------------------------------------------------------------
# a training step, held to the frozen JAX step
# --------------------------------------------------------------------------

def step_cfg():
    """The Baseline at the step size of ``test_torch_port_train.py``: 2
    decoder layers of width 64 on its classes."""
    cfg = baseline_cfg()
    cfg["decoder_cfg"].update(num_layers=2, d_model=64,
                              num_instance_classes=T.N_CLS,
                              num_semantic_classes=T.N_SEM)
    cfg["criterion_cfg"] = copy.deepcopy(T.PORT_CFG["criterion_cfg"])
    return cfg


def step_records():
    return [rgb_only(r) for r in T.records()]


def jax_step_reference():
    """The JAX package's ``accum_steps=2`` step of the step model on the
    gather layout -> the fixture's contents (``T.jax_step``)."""
    cfg = step_cfg()
    jmodel, jcrit, _ = JBU.build_model(cfg, JBU.Capacities(
        num_points=T.N_POINTS, num_voxels=T.VOXEL_CAP,
        num_superpoints=T.S_CAP, num_instances=T.I_CAP,
        num_queries2d=T.K2D))
    spec = JC.PadSpec(T.N_POINTS, T.S_CAP, T.I_CAP, T.K2D, T.N_SEM)
    mbs = [JC.attach_host_plan(JC.collate([r], spec), [r], spec,
                               voxel_size=0.02, voxel_cap=T.VOXEL_CAP,
                               stem_compact=False) for r in step_records()]
    return T.jax_step(jmodel, jcrit, mbs, T.initial_variables(cfg=cfg))


def port_baseline_step(layout=None):
    cfg = step_cfg()
    return T.port_step(T.initial_variables(cfg=cfg), recs=step_records(),
                       layout=layout, cfg=cfg)


def test_baseline_train_step_matches_frozen_jax_step():
    """The port's step on the config's training layout (block-dense
    everywhere, the dense k5 stem over 3 channels) against the JAX step on
    the gather layout.  (The synthetic colours are noise, so the rgb-only
    step is chaotic: a 1e-6 relative move of every weight moves some
    leaves' gradient probes by more than the 1e-3 tolerance, and the
    port's gather-layout step misses one probe by as much; it is not
    held here.)"""
    assert os.path.exists(STEP_FIXTURE), "fixture missing: run --regen"
    port = port_baseline_step(dict(block_edges=host_plan_args(
        step_cfg(), train=True)["block_edges"]))
    for mb in port["batches"]:
        assert mb.points_2dfeats is None
        assert all(t is not None for t in mb.plan.blocks)
    assert port["model"].backbone.unet.conv0p1s1.kernel.shape[1] == 3
    check_step(port, dict(np.load(STEP_FIXTURE, allow_pickle=True)))


def hash_stats(ref):
    """The fixture's batch-norm statistics as a norm and a probe each
    (``T.leaf_hash``), which keeps the file under 50 KB."""
    ref = dict(ref)
    names, norms, probes = T.leaf_hash(dict(zip(ref.pop("stat_names"),
                                                ref.pop("stats"))))
    ref.update(stat_names=np.array(names), stat_norms=norms,
               stat_probes=probes)
    return ref


def check_step(port, ref):
    """``T.check_against`` with the statistics held by their hashes at the
    statistics' tolerance (rtol = atol = 1e-4 of the largest norm)."""
    names, norms, probes = T.leaf_hash(
        {n: b.numpy() for n, b in port["model"].named_buffers()
         if n in set(ref["stat_names"])})
    assert names == list(ref["stat_names"])
    scale = float(ref["stat_norms"].max())
    for got, want in ((norms, ref["stat_norms"]),
                      (probes, ref["stat_probes"])):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)
    T.check_against(port, dict(ref, stat_names=np.array([]),
                               stats=np.array([])))


@pytest.mark.slow
def test_baseline_train_step_matches_live_jax_step():
    check_step(port_baseline_step(dict(block_edges=host_plan_args(
        step_cfg(), train=True)["block_edges"])),
        hash_stats(jax_step_reference()))


# --------------------------------------------------------------------------
# the reader and the eval loader without 2D features
# --------------------------------------------------------------------------

def test_reader_and_eval_loader_without_2d_match_jax(tmp_path):
    import dataclasses

    from segdino3d_tpu.data import bucketing as JB
    from segdino3d_tpu.data import loader as JL
    from segdino3d_tpu.data import scannet_dataset as JD
    from segdino3d_tpu_torch.data import bucketing as TB
    from segdino3d_tpu_torch.data import loader as TL
    from segdino3d_tpu_torch.data import scannet_dataset as TD
    from segdino3d_tpu_torch.data.synthetic import write_scannet_layout
    from test_torch_port_eval_loader import (BATCH_FIELDS,
                                             _assert_plans_equal,
                                             _assert_records_equal)

    root = str(tmp_path)
    write_scannet_layout(root, (0, 1, 2), features_2d=False,
                         **dict(SCENE, n_classes=18))
    assert not os.listdir(os.path.join(root, "features_2d"))
    kw = dict(scene_set="val", root_scenes=root, root_points_2dfeats=None,
              num_semantic_classes=20, adjust_class_ids=False,
              exclude_stuffs=False)
    port, ref = TD.ScanNet200InstanceSeg3D(**kw), \
        JD.ScanNet200InstanceSeg3D(**kw)
    for i in range(3):
        rec = port.get_record(i, np.random.RandomState(i))
        assert rec["points_2dfeats"] is None and rec["query2d_pos"] is None
        _assert_records_equal(rec, ref.get_record(i,
                                                  np.random.RandomState(i)))
    cfg = dict(host_plan_args(baseline_cfg()),
               level_cap_ratios=(1.0, 0.4, 0.15, 0.06, 0.025))

    def policy(cls):
        return cls.default(20, max_points=2048, max_superpoints=128,
                           max_instances=16, max_queries2d=16)

    tl = TL.EvalLoader(port, bucket_policy=policy(TB.BucketPolicy),
                       host_plan_cfg=cfg, prefetch=1, device="cpu")
    jl = JL.EvalLoader(ref, bucket_policy=policy(JB.BucketPolicy),
                       host_plan_cfg=cfg, prefetch=1)
    got, want = list(tl), list(jl)
    assert len(got) == len(want) == 3
    for (trecs, tb), (jrecs, jb) in zip(got, want):
        for a, b in zip(trecs, jrecs):
            _assert_records_equal(a, b)
        for k in BATCH_FIELDS:
            a, b = getattr(tb, k), getattr(jb, k)
            assert (a is None) == (b is None), k
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                              err_msg=k)
        assert tb.points_2dfeats is None
        _assert_plans_equal(tb.plan, jb.unet_plan, jb.plan_inverse_mapping)
    caps_t, caps_j = tl._prescan(), jl._prescan()
    assert {dataclasses.astuple(k): v for k, v in caps_t.items()} == \
        {dataclasses.astuple(k): v for k, v in caps_j.items()}


# --------------------------------------------------------------------------
# weights
# --------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["baseline", "options"])
def test_convert_round_trips_the_tree(baseline_pair, options_pair, which):
    p = baseline_pair if which == "baseline" else options_pair
    model = copy.deepcopy(p["tmodel"])
    load_jax_variables(model, p["variables"])
    back = state_dict_to_jax(model.state_dict())
    want = dict(jax.tree_util.tree_flatten_with_path(p["variables"])[0])
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert sorted(map(str, got)) == sorted(map(str, want))
    for path, leaf in want.items():
        np.testing.assert_array_equal(got[path], leaf, err_msg=str(path))
    dec = p["variables"]["params"]["decoder"]
    if which == "baseline":
        assert not any(k.startswith("dinox_ca") for k in dec)
    else:
        assert {"plain_ca_0", "plain_sa_1", "out_score"} <= set(dec)
        assert set(dec["out_sem"]) == {"layers_0", "layers_2"}


@pytest.mark.parametrize("decoder", [{}, dict(objectness_flag=True,
                                              num_semantic_linears=2)])
def test_baseline_reference_state_dict_loads_like_jax(decoder, tmp_path):
    """A reference state dict of the Baseline's shape (no
    ``dinox_query_cross_attn_layers.*``; with objectness, ``out_score.*``
    and a two-layer ``out_sem``) loads bit-equal to the JAX importer's,
    every port key filled."""
    cfg = small_cfg(**decoder)
    model, _ = build_model(cfg, Capacities(num_superpoints=S_CAP),
                           device="cpu")
    sd = build_res16_torch_sd(*tree_of(model.backbone.unet),
                              np.random.RandomState(5))
    rng = np.random.RandomState(6)
    tree = state_dict_to_jax(model.state_dict())
    sd.update(export_decoder({
        k: rng.randn(*v.shape).astype(np.float32)
        for k, v in _flatten(tree["params"]["decoder"]).items()}))
    assert not any("dinox" in k for k in sd)
    assert any(k.startswith("decoder.out_score.") for k in sd) == \
        bool(decoder)
    got, unmapped = TI.import_state_dict(sd)
    assert unmapped == []
    assert_bit_equal(got, jax_side(sd))
    path = str(tmp_path / "baseline.pth")
    torch.save({"model": {k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in sd.items()}}, path)
    loaded, unmapped = TI.load_reference_checkpoint(model, path)
    assert unmapped == []
    state = loaded.state_dict()
    assert_bit_equal({k: state[k] for k in got}, got)


def test_learned_query_table_lands_on_the_port_module():
    """The reference's ``decoder.query_embed.weight`` maps onto the learned
    query table of a port decoder that has one."""
    cfg = small_cfg(add_positional_embedding=False, box_modulate_ca=False,
                    add_box_size_pred=False, normalize_box_prediction=False,
                    num_semantic_queries=5)
    model, _ = build_model(cfg, Capacities(num_superpoints=S_CAP),
                           device="cpu")
    table = torch.randn(5, 64)
    got, unmapped = TI.import_state_dict({"decoder.query_embed.weight":
                                          table})
    assert unmapped == []
    assert torch.equal(got["decoder.query_embed.embedding"], table)
    assert model.state_dict()["decoder.query_embed.embedding"].shape == \
        table.shape


def regen():
    import time

    jax.config.update("jax_platforms", "cpu")
    load_jax_sparseplan()
    t0 = time.perf_counter()
    out = hash_stats(jax_step_reference())
    np.savez_compressed(STEP_FIXTURE, **out)
    print(f"wrote {STEP_FIXTURE} in {time.perf_counter() - t0:.0f} s: "
          f"metrics {out['metrics'].item()}")


if __name__ == "__main__":
    if "--regen" in sys.argv:
        regen()
    else:
        print(__doc__)
