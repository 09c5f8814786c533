"""The eval entry point in both packages: ScanNet readers, val transforms,
bucketing, the ``EvalLoader`` (capacity prescan, prefetch thread), the
bit-packed result transfer and the eval driver, and the device plan's
overflow, which the eval driver and the training step act on.

Scenes are written with numpy from seeds to a temp dir by
``write_scannet_layout`` in each package, as ``tests/test_dataset.py``
does, and read back by each package's reader.  Records, batches, plan
tables and pinned capacities must be equal; the eval slice's AP, AP50 and
AP25 within ``1e-6`` of the JAX driver's.
"""
import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from test_torch_port_jaxlib import load_jax_sparseplan  # noqa: E402

from segdino3d_tpu.data import bucketing as JB  # noqa: E402
from segdino3d_tpu.data import loader as JL  # noqa: E402
from segdino3d_tpu.data import scannet_dataset as JD  # noqa: E402
from segdino3d_tpu.data.synthetic import \
    write_scannet_layout as jax_write_layout  # noqa: E402
from segdino3d_tpu.ops.bitpack import pack_bits as jax_pack_bits  # noqa: E402
from segdino3d_tpu_torch.data import bucketing as TB  # noqa: E402
from segdino3d_tpu_torch.data import loader as TL  # noqa: E402
from segdino3d_tpu_torch.data import scannet_dataset as TD  # noqa: E402
from segdino3d_tpu_torch.data.synthetic import write_scannet_layout  # noqa: E402
from segdino3d_tpu_torch.ops.bitpack import pack_bits, unpack_bits_np  # noqa: E402

LAYOUT = dict(n_points=2000, n_superpoints=100, n_classes=18, n_instances=5,
              n_queries2d=12, feat_dim_2d=32)
SEEDS = (0, 1, 2)
N_SEM = 20
PLAN_CFGS = {
    "gather_compact": dict(voxel_size=0.02,
                           level_cap_ratios=(1.0, 0.4, 0.15, 0.06, 0.025),
                           stem_compact=True, stem_compact_slots=8),
    "hybrid_compact": dict(voxel_size=0.02, block_edges=[4] * 5,
                           stem_gather=True, stem_compact=True),
    "hybrid": dict(voxel_size=0.02, block_edges=[4] * 5, stem_gather=True),
}


@pytest.fixture(scope="module", autouse=True)
def _setup():
    """The JAX plan library (``test_torch_port_jaxlib.py``), and one torch
    thread: the suite runs several test workers at once."""
    load_jax_sparseplan()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scannet_layout"))
    assert write_scannet_layout(root, SEEDS, **LAYOUT) == \
        [f"synth{s:04d}" for s in SEEDS]
    return root


def _policy(cls):
    return cls.default(N_SEM, max_points=2048, max_superpoints=128,
                       max_instances=16, max_queries2d=16)


def _readers(root, cls="ScanNet200InstanceSeg3D", **kw):
    kw = dict(dict(scene_set="val", root_scenes=root,
                   root_points_2dfeats=os.path.join(root, "features_2d")),
              **kw)
    return getattr(TD, cls)(**kw), getattr(JD, cls)(**kw)


def _assert_records_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if want[k] is None:
            assert got[k] is None, k
        else:
            a, b = np.asarray(got[k]), np.asarray(want[k])
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b, err_msg=k)


def test_write_scannet_layout_matches_jax(data_root, tmp_path):
    jax_write_layout(str(tmp_path), SEEDS, **LAYOUT)
    for sub in ("points", "instance_mask", "semantic_mask", "super_points"):
        for s in SEEDS:
            with open(os.path.join(data_root, sub, f"synth{s:04d}.bin"),
                      "rb") as a, open(os.path.join(
                          tmp_path, sub, f"synth{s:04d}.bin"), "rb") as b:
                assert a.read() == b.read(), (sub, s)
    for name in ("synth0001.pth", "synth0001_query_feats.pth",
                 "synth0001_query_3dctr.pth"):
        a, b = (torch.load(os.path.join(r, "features_2d", name),
                           weights_only=False)
                for r in (data_root, str(tmp_path)))
        for x, y in zip(a if isinstance(a, list) else [a],
                        b if isinstance(b, list) else [b]):
            assert torch.equal(x, y), name
    for split in ("train", "val", "test"):
        name = os.path.join("meta_data", f"scannetv2_{split}.txt")
        with open(os.path.join(data_root, name)) as a, \
                open(os.path.join(tmp_path, name)) as b:
            assert a.read() == b.read()


READERS = {
    "scannet200_raw": ("ScanNet200InstanceSeg3D",
                       dict(adjust_class_ids=False, exclude_stuffs=False,
                            num_semantic_classes=N_SEM)),
    "scannet200": ("ScanNet200InstanceSeg3D", {}),
    "scannet200_fp16": ("ScanNet200InstanceSeg3D",
                        dict(feats_2d_dtype="float16", scene_set="test")),
    "scannet_v2": ("ScanNetInstanceSeg3D", {}),
    # train scenes through the val pipeline: the DINO-X query dropout
    "train_query_dropout": ("ScanNet200InstanceSeg3D", dict(
        scene_set="train", dropout_rate_2dfeats=0.5,
        transform_cfg=dict(type="Scannet200Transforms", scene_set="val",
                           voxel_size=0.02))),
}


@pytest.mark.parametrize("reader", sorted(READERS))
def test_reader_records_match_jax(data_root, reader):
    cls, kw = READERS[reader]
    port, ref = _readers(data_root, cls, **kw)
    assert len(port) == len(ref) == len(SEEDS)
    for i in range(len(SEEDS)):
        got = port.get_record(i, np.random.RandomState(i))
        want = ref.get_record(i, np.random.RandomState(i))
        _assert_records_equal(got, want)
    if reader == "train_query_dropout":
        assert got["query2d_pos"].shape[0] == LAYOUT["n_queries2d"] // 2


def test_reader_refuses_the_train_pipeline_and_other_transforms(data_root):
    """The train scene set now reads through the training pipeline (its
    records are held to JAX's in ``test_torch_port_train_data.py``); any
    other transform still raises."""
    from segdino3d_tpu_torch.data import transforms as TT

    port, _ = _readers(data_root, scene_set="train")
    assert [type(t) for t in port.transforms.transforms] == [
        TT.RandomFlip3D, TT.GlobalRotScaleTrans, TT.NormalizePointsColor,
        TT.ElasticTransform]
    for cfg in (dict(type="RandomFlip3D"),
                dict(type="Scannet200Transforms", elastic=True)):
        with pytest.raises(NotImplementedError, match="ScanNet pipelines"):
            TD.ScanNet200InstanceSeg3D(scene_set="val", root_scenes=data_root,
                                       transform_cfg=cfg)


def test_bucket_policy_matches_jax(data_root):
    for lo, hi, r, m in ((32768, 524288, 1.4, 8192), (512, 8192, 1.5, 256),
                         (100, 1000, 1.35, 64)):
        assert TB.geometric_ladder(lo, hi, r, m) == \
            JB.geometric_ladder(lo, hi, r, m)
    port, ref = _readers(data_root)
    recs = [ref.get_record(i, np.random.RandomState(0)) for i in range(2)]
    for kw in (dict(), dict(max_points=2048, max_superpoints=128,
                            max_instances=16, max_queries2d=16)):
        t, j = TB.BucketPolicy.default(N_SEM, **kw), \
            JB.BucketPolicy.default(N_SEM, **kw)
        assert dataclasses.astuple(t) == dataclasses.astuple(j)
        assert t.n_programs_bound() == j.n_programs_bound()
        assert dataclasses.astuple(t.spec_for(recs)) == \
            dataclasses.astuple(j.spec_for(recs))
        assert dataclasses.astuple(t.spec_for(recs[:1])) == \
            dataclasses.astuple(j.spec_for(recs[:1]))


def _assert_plans_equal(tp, jp, jinv):
    """The port's ``UNetPlan`` against the JAX plan of one batch."""
    np.testing.assert_array_equal(tp.inverse.numpy(), np.asarray(jinv))
    for li, (tl, jl) in enumerate(zip(tp.levels, jp.levels)):
        np.testing.assert_array_equal(tl.valid.numpy(), np.asarray(jl.valid))
        for got, want in ((tl.nbr, jp.subm_nbr[li]),
                          (tl.parent, jl.parent_idx),
                          (tl.kpos, jl.parent_kpos)):
            assert (got is None) == (want is None), li
            if got is not None:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (tp.stem_nbr is None) == (jp.stem_nbr is None)
    if tp.stem_nbr is not None:
        np.testing.assert_array_equal(tp.stem_nbr.numpy(),
                                      np.asarray(jp.stem_nbr))
    assert (tp.blocks is None) == (jp.blocks is None)
    for tb, jb in zip(tp.blocks or [], jp.blocks or []):
        assert (tb is None) == (jb is None)
        if tb is not None:
            assert tb.edge == jb.edge
            for k in ("vox_slot", "block_nbr", "slot_vox"):
                np.testing.assert_array_equal(getattr(tb, k).numpy(),
                                              np.asarray(getattr(jb, k)))
    assert (tp.stem_compact is None) == (jp.stem_compact is None)
    for got, want in zip(tp.stem_compact or (), jp.stem_compact or ()):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


BATCH_FIELDS = ("points", "point_valid", "superpoint_ids", "num_superpoints",
                "points_2dfeats", "query2d_feats", "query2d_pos",
                "query2d_valid", "inst_labels", "inst_valid",
                "point_inst_ids", "sp_inst_masks", "sp_sem_masks")


@pytest.mark.parametrize("prefetch", [0, 1])
@pytest.mark.parametrize("plan", sorted(PLAN_CFGS))
def test_eval_loader_matches_jax(data_root, plan, prefetch):
    """Records, batches and plan tables of every batch, and the capacities
    that the prescan pins per rung (``stem_ov_cap`` with the compacted
    stem)."""
    port, ref = _readers(data_root, num_semantic_classes=N_SEM,
                         adjust_class_ids=False, exclude_stuffs=False)
    cfg = PLAN_CFGS[plan]
    tl = TL.EvalLoader(port, bucket_policy=_policy(TB.BucketPolicy),
                       host_plan_cfg=cfg, prefetch=prefetch, device="cpu")
    jl = JL.EvalLoader(ref, bucket_policy=_policy(JB.BucketPolicy),
                       host_plan_cfg=cfg, prefetch=prefetch)
    got, want = list(tl), list(jl)
    assert len(got) == len(want) == len(tl) == len(SEEDS)
    for (trecs, tb), (jrecs, jb) in zip(got, want):
        for a, b in zip(trecs, jrecs):
            _assert_records_equal(a, b)
        for k in BATCH_FIELDS:
            np.testing.assert_array_equal(getattr(tb, k).numpy(),
                                          np.asarray(getattr(jb, k)),
                                          err_msg=k)
        _assert_plans_equal(tb.plan, jb.unet_plan, jb.plan_inverse_mapping)
        assert (tb.plan.stem_compact is not None) == ("compact" in plan)
    caps_t, caps_j = tl._prescan(), jl._prescan()
    assert {dataclasses.astuple(k): v for k, v in caps_t.items()} == \
        {dataclasses.astuple(k): v for k, v in caps_j.items()}
    assert all(("stem_ov_cap" in v) == ("compact" in plan)
               for v in caps_t.values())


class _FailingReader:
    def __init__(self, reader):
        self.reader = reader

    def __len__(self):
        return len(self.reader)

    def get_record(self, idx, rng):
        if idx == 1:
            raise ValueError("boom at scene 1")
        return self.reader.get_record(idx, rng)


@pytest.mark.parametrize("prefetch", [0, 1])
def test_eval_loader_raises_reader_errors_in_the_consumer(data_root,
                                                          prefetch):
    port, _ = _readers(data_root, num_semantic_classes=N_SEM)
    loader = TL.EvalLoader(_FailingReader(port),
                           bucket_policy=_policy(TB.BucketPolicy),
                           host_plan_cfg=dict(voxel_size=0.02),
                           prescan_caps=False, prefetch=prefetch,
                           device="cpu")
    it = iter(loader)
    recs, _ = next(it)
    assert recs[0]["scene_id"] == "synth0000"
    with pytest.raises(ValueError, match="boom at scene 1"):
        next(it)


def test_eval_loader_refuses_unported_options(data_root, monkeypatch):
    port, _ = _readers(data_root)
    policy = _policy(TB.BucketPolicy)
    # shards and process shares are ported (test_torch_port_dist.py);
    # values that name no shard are refused
    for kw, what in ((dict(mesh_shards=2), "multiple of mesh_shards"),
                     (dict(process_index=2, process_count=2),
                      "process_index 2 of 2")):
        with pytest.raises(ValueError, match=what):
            TL.EvalLoader(port, bucket_policy=policy, device="cpu", **kw)
    with pytest.raises(ValueError, match="pad_spec or a bucket_policy"):
        TL.EvalLoader(port, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TL.EvalLoader(port, bucket_policy=policy)


@pytest.mark.parametrize("shape", [(3, 8), (5, 37), (2, 4, 1001), (600, 2)])
def test_pack_bits_matches_jax(shape):
    x = np.random.RandomState(sum(shape)).rand(*shape) > 0.4
    got = pack_bits(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_pack_bits(jax.numpy.asarray(x)))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(unpack_bits_np(got, shape[-1]), x)


def _small_model(cfg=None, caps=None, train=False):
    from test_torch_port_model import PORT_CFG, S_CAP

    from segdino3d_tpu_torch.builder import Capacities, build_model, \
        random_init_

    model, test_cfg = build_model(
        cfg or PORT_CFG, caps or Capacities(num_superpoints=S_CAP),
        device="cpu", train=train)
    return random_init_(model, seed=0), test_cfg


@pytest.fixture(scope="module")
def seeded(data_root):
    """The small SegDINO3D of ``test_torch_port_model.py`` with its seeded
    weights in both packages (they keep instances past the thresholds)."""
    import __graft_entry__ as ge
    from test_torch_port_model import (N_CLS, PORT_CFG, S_CAP,
                                       _seeded_variables)

    from segdino3d_tpu.data.collate import PadSpec, collate
    from segdino3d_tpu_torch.builder import Capacities, build_model
    from segdino3d_tpu_torch.convert import load_jax_variables

    _, ref = _readers(data_root, num_semantic_classes=N_SEM)
    jmodel, _, test_cfg, _, _ = ge._build(
        n_points=2048, s_cap=S_CAP, i_cap=16, k2d=16, num_layers=2,
        d_model=64, n_sem=N_SEM, n_inst_cls=N_CLS,
        feat2d=LAYOUT["feat_dim_2d"], init=False)
    variables = _seeded_variables(jmodel, collate(
        [ref.get_record(0, np.random.RandomState(0))],
        PadSpec(2048, S_CAP, 16, 16, N_SEM)))
    tmodel, _ = build_model(PORT_CFG, Capacities(num_superpoints=S_CAP),
                            device="cpu")
    load_jax_variables(tmodel, variables)
    return dict(jmodel=jmodel, variables=variables, tmodel=tmodel,
                test_cfg=test_cfg)


def test_packed_transfer_gives_the_unpacked_ap(data_root, seeded,
                                               monkeypatch):
    """The eval driver's AP with packed masks equals the AP of the whole
    bool masks copied to the host."""
    from test_torch_port_model import CLASS_IDS, CLASS_NAMES

    from segdino3d_tpu_torch.data.collate import eval_annotation
    from segdino3d_tpu_torch.evaluation import evaluate as E
    from segdino3d_tpu_torch.evaluation.evaluator import \
        InstanceSeg3DEvaluator

    model, test_cfg = seeded["tmodel"], seeded["test_cfg"]
    port, _ = _readers(data_root, num_semantic_classes=N_SEM)
    pairs = list(TL.EvalLoader(port, bucket_policy=_policy(TB.BucketPolicy),
                               host_plan_cfg=PLAN_CFGS["gather_compact"],
                               device="cpu"))
    got = E.evaluate(model, pairs, InstanceSeg3DEvaluator(CLASS_IDS,
                                                          CLASS_NAMES),
                     test_cfg)

    monkeypatch.setattr(E, "pack_bits", lambda x: x)
    ev = InstanceSeg3DEvaluator(CLASS_IDS, CLASS_NAMES)
    for recs, batch in pairs:
        with torch.no_grad():
            res = E.postprocess(model(batch), batch, test_cfg)
        for rec, (inst, sem, pan_sem, pan_map) in zip(recs, res):
            n, valid = rec["points"].shape[0], inst.valid.numpy()
            assert inst.point_masks.dtype == torch.bool and valid.any()
            ev.process(eval_annotation(rec), dict(
                pts_instance_masks=inst.point_masks.numpy()[valid, :n],
                instance_labels=inst.labels.numpy()[valid],
                instance_scores=inst.scores.numpy()[valid],
                pts_semantic_mask=sem.numpy()[:n],
                pts_panoptic_sem=pan_sem.numpy()[:n],
                pts_panoptic_inst=pan_map.numpy()[:n]))
    want = ev.evaluate()
    assert np.isfinite(want["all_ap_25"])
    for key in ("all_ap", "all_ap_50", "all_ap_25"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6,
                                   err_msg=key)


def test_eval_entry_point_matches_jax(data_root, seeded):
    """The slice as a whole: scenes read from disk by each package's
    reader, its ``EvalLoader`` (prescan, prefetch thread, compacted-stem
    plans) and its eval driver (packed transfer), under the same seeded
    weights: AP within 1e-6."""
    from test_torch_port_model import CLASS_IDS, CLASS_NAMES

    from segdino3d_tpu.evaluation.evaluate import evaluate as jax_evaluate
    from segdino3d_tpu.evaluation.evaluator import \
        InstanceSeg3DEvaluator as JaxEvaluator
    from segdino3d_tpu_torch.evaluation.evaluate import evaluate
    from segdino3d_tpu_torch.evaluation.evaluator import \
        InstanceSeg3DEvaluator

    port, ref = _readers(data_root, num_semantic_classes=N_SEM)
    cfg = PLAN_CFGS["gather_compact"]
    jl = JL.EvalLoader(ref, bucket_policy=_policy(JB.BucketPolicy),
                       host_plan_cfg=cfg, prefetch=1)
    tl = TL.EvalLoader(port, bucket_policy=_policy(TB.BucketPolicy),
                       host_plan_cfg=cfg, prefetch=1, device="cpu")
    want = jax_evaluate(seeded["jmodel"], seeded["variables"], jl,
                        JaxEvaluator(CLASS_IDS, CLASS_NAMES),
                        seeded["test_cfg"], progress=False)
    got = evaluate(seeded["tmodel"], tl,
                   InstanceSeg3DEvaluator(CLASS_IDS, CLASS_NAMES),
                   seeded["test_cfg"])
    assert np.isfinite(want["all_ap_25"])
    for key in ("all_ap", "all_ap_50", "all_ap_25"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6,
                                   err_msg=key)


def test_eval_driver_raises_on_a_device_plan_overflow(data_root):
    """A scene past the device plan's voxel capacity (no host plan): the
    eval driver raises at the result copy; at an ample capacity it runs."""
    from test_torch_port_model import CLASS_IDS, CLASS_NAMES, S_CAP

    from segdino3d_tpu_torch.builder import Capacities
    from segdino3d_tpu_torch.data.collate import collate
    from segdino3d_tpu_torch.evaluation.evaluate import evaluate
    from segdino3d_tpu_torch.evaluation.evaluator import \
        InstanceSeg3DEvaluator

    port, _ = _readers(data_root, num_semantic_classes=N_SEM)
    rec = port.get_record(0, np.random.RandomState(0))
    spec = _policy(TB.BucketPolicy).spec_for([rec])
    pairs = [([rec], collate([rec], spec, "cpu"))]
    for cap, fails in ((256, True), (2048, False)):
        model, test_cfg = _small_model(
            caps=Capacities(num_superpoints=S_CAP, num_voxels=cap))
        ev = InstanceSeg3DEvaluator(CLASS_IDS, CLASS_NAMES)
        if fails:
            with pytest.raises(ValueError, match="device plan capacity"):
                evaluate(model, pairs, ev, test_cfg)
        else:
            evaluate(model, pairs, ev, test_cfg)


def test_train_step_raises_on_a_device_plan_overflow():
    """The training step's metrics read raises when a microbatch's device
    plan overflowed; at ample capacities it returns the metrics."""
    import test_torch_port_train as T

    from segdino3d_tpu_torch.builder import Capacities, build_criterion
    from segdino3d_tpu_torch.data import collate as TC
    from segdino3d_tpu_torch.parallel.train_step import TrainStep
    from segdino3d_tpu_torch.train.optim import build_optimizer

    recs = T.records()[:1]
    spec = TC.PadSpec(T.N_POINTS, T.S_CAP, T.I_CAP, T.K2D, T.N_SEM)
    mbs = [TC.collate(recs, spec, "cpu")]
    for cap, fails in ((256, True), (T.VOXEL_CAP, False)):
        model, _ = _small_model(T.PORT_CFG, Capacities(
            num_superpoints=T.S_CAP, num_voxels=cap), train=True)
        step = TrainStep(model, build_criterion(T.PORT_CFG),
                         build_optimizer(model.named_parameters(), T.OPT,
                                         T.SCHED, clip_max_norm=T.CLIP))
        metrics = step(mbs, generator=torch.Generator().manual_seed(0))
        if fails:
            with pytest.raises(ValueError, match="device plan capacity"):
                step.host_metrics(metrics)
        else:
            vals = step.host_metrics(metrics)
            assert vals.keys() == metrics.keys()
            assert all(np.isfinite(v) for v in vals.values())
