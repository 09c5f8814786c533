"""The whole eval slice in both packages: a small SegDINO3D (2 decoder
layers, d_model 64, ~2k points, 128 superpoints) with seeded random
weights in the JAX tree's layout, carried into the port by ``convert.py``,
on 3 seeded synthetic scenes.

Tolerances: the model outputs ``rtol = atol = 1e-4`` (fp32, sums in
another order); ``predict_instance`` slots with equal labels, validity and
point masks, scores and boxes at ``1e-4`` (slots whose scores tie up to
rounding may trade places); AP, AP50 and AP25 of the two eval drivers
within ``1e-6``.
"""
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import __graft_entry__ as ge  # noqa: E402
from segdino3d_tpu.data import collate as JC  # noqa: E402
from segdino3d_tpu.data.synthetic import synthetic_scene as jax_scene  # noqa: E402
from segdino3d_tpu.evaluation.evaluate import evaluate as jax_evaluate  # noqa: E402
from segdino3d_tpu.evaluation.evaluator import \
    InstanceSeg3DEvaluator as JaxEvaluator  # noqa: E402
from segdino3d_tpu.models.architecture.postprocess import \
    predict_instance as jax_predict_instance  # noqa: E402
from segdino3d_tpu_torch.builder import Capacities, build_model  # noqa: E402
from segdino3d_tpu_torch.convert import load_jax_variables  # noqa: E402
from segdino3d_tpu_torch.data import collate as TC  # noqa: E402
from segdino3d_tpu_torch.data.synthetic import synthetic_scene  # noqa: E402
from segdino3d_tpu_torch.evaluation.evaluate import evaluate  # noqa: E402
from segdino3d_tpu_torch.evaluation.evaluator import InstanceSeg3DEvaluator  # noqa: E402
from segdino3d_tpu_torch.models.architecture.postprocess import \
    predict_instance  # noqa: E402

SEEDS = (0, 1, 2)
N_CLS, N_SEM, FEAT2D, S_CAP = 18, 20, 32, 128
TOL = dict(rtol=1e-4, atol=1e-4)
SCENE = dict(n_points=2000, n_superpoints=100, n_classes=N_CLS,
             n_queries2d=12, feat_dim_2d=FEAT2D)
PORT_CFG = dict(
    type="SegDINO3D",
    pointcloud_backbone_cfg=dict(
        type="Res16UNet34C", in_channels=FEAT2D + 3, out_channels=96,
        voxel_size=0.02, config=dict(conv1_kernel_size=5)),
    decoder_cfg=dict(num_layers=2, num_instance_classes=N_CLS,
                     num_semantic_classes=N_SEM, in_channels=96, d_model=64,
                     num_heads=8, hidden_dim=1024, temperature=20))
CLASS_IDS = [1, 2] + [100 + i for i in range(N_CLS - 2)]
CLASS_NAMES = ["wall", "floor"] + [f"c{i}" for i in range(N_CLS - 2)]


@pytest.fixture(scope="module", autouse=True)
def _float32_jax_backbone():
    """``__graft_entry__._build`` reads the backbone dtype from
    ``SEGDINO_COMPUTE_DTYPE``, which the JAX package's export tool sets to
    bfloat16 for the rest of a process where it is unset
    (``tools/export_serving.py``): pin the float32 these comparisons are
    made at, whatever ran before in the process."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEGDINO_COMPUTE_DTYPE", "float32")
        yield


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs several test workers at once, and
    torch's default of one thread per core makes them thrash."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seeded_variables(jmodel, batch, seed=0):
    """Random variables of the flax tree's shapes, drawn with numpy (no
    init compile): fan-in scaled kernels, small biases, positive batch-norm
    variances."""
    shapes = jax.eval_shape(
        lambda b: jmodel.init({"params": jax.random.PRNGKey(0),
                               "queries": jax.random.PRNGKey(1)}, b, False),
        batch)
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        x = rng.randn(*shape).astype(np.float32)
        if name == "kernel":
            return x / np.sqrt(np.prod(shape[:-1]))
        if name == "var":
            return np.abs(x) + 0.5
        if name == "scale":
            return 1.0 + 0.1 * x
        return 0.1 * x                        # bias, mean

    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


@pytest.fixture(scope="module")
def slice_pair():
    jmodel, _, test_cfg, _, _ = ge._build(
        n_points=2048, s_cap=S_CAP, i_cap=16, k2d=16, num_layers=2,
        d_model=64, n_sem=N_SEM, n_inst_cls=N_CLS, feat2d=FEAT2D,
        init=False)
    jspec = JC.PadSpec(2048, S_CAP, 16, 16, N_SEM)
    tspec = TC.PadSpec(2048, S_CAP, 16, 16, N_SEM)
    variables = _seeded_variables(jmodel, JC.collate(
        [jax_scene(SEEDS[0], **SCENE)], jspec))
    tmodel, _ = build_model(PORT_CFG, Capacities(num_superpoints=S_CAP),
                            device="cpu")
    load_jax_variables(tmodel, variables)

    apply = jax.jit(lambda v, b: jmodel.apply(v, b, False)[0])
    scenes = []
    for seed in SEEDS:
        rec = synthetic_scene(seed, **SCENE)
        jrec = jax_scene(seed, **SCENE)
        for k, v in jrec.items():
            assert np.array_equal(np.asarray(v), np.asarray(rec[k])), k
        jb = JC.attach_host_plan(JC.collate([jrec], jspec), [jrec], jspec,
                                 voxel_size=0.02)
        tb = TC.attach_host_plan(TC.collate([rec], tspec, "cpu"), [rec], tspec,
                                 voxel_size=0.02)
        with torch.no_grad():
            tout = tmodel(tb)
        scenes.append(dict(rec=rec, jrec=jrec, jb=jb, tb=tb,
                           jout=jax.device_get(apply(variables, jb)),
                           tout=tout))
    return dict(jmodel=jmodel, variables=variables, tmodel=tmodel,
                test_cfg=test_cfg, scenes=scenes)


@pytest.mark.parametrize("seed", range(len(SEEDS)))
def test_slice_outputs_match(slice_pair, seed):
    sc = slice_pair["scenes"][seed]
    for key in ("cls_preds", "masks", "sem_preds", "centers", "sizes"):
        np.testing.assert_allclose(sc["tout"][key].numpy(),
                                   np.asarray(sc["jout"][key]), **TOL,
                                   err_msg=key)


@pytest.mark.parametrize("seed", range(len(SEEDS)))
def test_predict_instance_matches(slice_pair, seed):
    sc, cfg = slice_pair["scenes"][seed], slice_pair["test_cfg"]
    jo, to, jb, tb = sc["jout"], sc["tout"], sc["jb"], sc["tb"]
    want = jax_predict_instance(
        jo["cls_preds"][0], jo["masks"][0], jo["query_valid"][0],
        jo["sp_valid"][0], jb.superpoint_ids[0], jb.point_valid[0],
        jb.points[0, :, :3], 0.0, cfg, centers=jo["centers"][0],
        sizes=jo["sizes"][0], filter_outofbox=True)
    got = predict_instance(
        to["cls_preds"][0], to["masks"][0], to["query_valid"][0],
        to["sp_valid"][0], tb.superpoint_ids[0], tb.point_valid[0],
        tb.points[0, :, :3], 0.0, cfg, centers=to["centers"][0],
        sizes=to["sizes"][0], filter_outofbox=True)
    # the slots are sorted by decayed score: slots whose scores differ by
    # float rounding only may trade places, so the score sequence must match
    # slot by slot and the slots must match as a multiset
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               **TOL)
    pool = {}
    for i in range(len(want.labels)):
        key = (int(want.labels[i]), bool(want.valid[i]),
               np.asarray(want.point_masks[i]).tobytes())
        pool.setdefault(key, []).append(
            (float(want.scores[i]), np.asarray(want.boxes[i])))
    for i in range(len(got.labels)):
        key = (int(got.labels[i]), bool(got.valid[i]),
               got.point_masks[i].numpy().tobytes())
        cands = pool.get(key, [])
        hit = next((j for j, (sc, box) in enumerate(cands)
                    if np.isclose(sc, float(got.scores[i]), **TOL)
                    and np.allclose(box, got.boxes[i].numpy(), **TOL)), None)
        assert hit is not None, f"slot {i} has no JAX counterpart"
        cands.pop(hit)


def test_ap_matches_jax_eval_driver(slice_pair):
    sp, cfg = slice_pair, slice_pair["test_cfg"]
    want = jax_evaluate(
        sp["jmodel"], sp["variables"],
        [([sc["jrec"]], sc["jb"]) for sc in sp["scenes"]],
        JaxEvaluator(CLASS_IDS, CLASS_NAMES), cfg, progress=False)
    got = evaluate(sp["tmodel"], [([sc["rec"]], sc["tb"])
                                  for sc in sp["scenes"]],
                   InstanceSeg3DEvaluator(CLASS_IDS, CLASS_NAMES), cfg)
    for key in ("all_ap", "all_ap_50", "all_ap_25"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6,
                                   err_msg=key)


def test_bf16_backbone_tracks_fp32(slice_pair):
    """``compute_dtype="bfloat16"`` (the JAX bench's backbone setting) runs
    the U-Net in bf16 and stays within bf16 rounding of the fp32 port on
    the superpoint features (rtol = atol = 5e-2, ~6 bf16 ulps, over ~50
    stacked convs)."""
    cfg = dict(PORT_CFG, pointcloud_backbone_cfg=dict(
        PORT_CFG["pointcloud_backbone_cfg"], compute_dtype="bfloat16"))
    bf16, _ = build_model(cfg, Capacities(num_superpoints=S_CAP),
                          device="cpu")
    bf16.load_state_dict(slice_pair["tmodel"].state_dict())
    tb = slice_pair["scenes"][0]["tb"]
    with torch.no_grad():
        got = bf16.backbone(tb).sp_feats
        want = slice_pair["tmodel"].backbone(tb).sp_feats
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want, rtol=5e-2, atol=5e-2)
