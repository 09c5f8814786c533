"""Batched eval in both packages, and ``SEGDINO_CONV_CHUNK_MB``.

The JAX package reads ``SEGDINO_CONV_CHUNK_MB`` at call time
(``host_plan.l0_dense_budget_bytes``, 1024 MiB when unset) for its level-0
layout crossover; ``bench.py`` sets it to 384 for its batched eval and its
stress scene.  The port reads it the same way, and the same budget bounds
K1's and K10's pair-major scratch (``sparse_conv.offset_chunks``).  Here,
on the small SegDINO3D of ``test_torch_port_model.py`` and its seeded
scenes:

* the budget itself against the JAX package's, unset and set;
* a batch of three scenes' plans on the flagship eval layout (a gather k5
  stem, block-dense convs elsewhere) from ``attach_host_plan`` and from the
  ``EvalLoader``'s prescan rung caps, with the variable unset (level 0
  block-dense in both) and set below the batch's level-0 dense buffer
  (level 0 in the gather layout in both): equal to the JAX plans;
* the batch-3 eval forward on the lowered budget's plans against the JAX
  package's on the same converted weights (``rtol = atol = 1e-4``), its
  ``predict_instance`` per scene (as ``test_torch_port_model.py`` holds
  it) and the AP of both eval drivers (``1e-6``);
* the offset-chunk planner: every offset once and in order, each chunk
  within the budget or a single offset, as few chunks as fit; and a plain
  model of K1's pair-major schedule run in those chunks, each adding onto
  the fp32 carry of the chunk before, bit-equal to the model in one chunk
  and within ``1e-6 x max`` of ``gather_conv_plain``.
"""
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

from segdino3d_tpu.data import collate as JC  # noqa: E402
from segdino3d_tpu.ops import host_plan as JH  # noqa: E402
from segdino3d_tpu_torch.builder import host_plan_args  # noqa: E402
from segdino3d_tpu_torch.data import collate as TC  # noqa: E402
from segdino3d_tpu_torch.ops import host_plan as TH  # noqa: E402
from segdino3d_tpu_torch.ops import sparse_conv as TSC  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
BATCH_SEEDS = (0, 1, 2)
N_SEM = 20
ENV = "SEGDINO_CONV_CHUNK_MB"


@pytest.fixture(scope="module", autouse=True)
def _float32_jax_backbone():
    """``__graft_entry__._build`` reads the backbone dtype from
    ``SEGDINO_COMPUTE_DTYPE``, which the JAX package's export tool sets to
    bfloat16 for the rest of a process where it is unset
    (``tools/export_serving.py``): pin the float32 these comparisons are
    made at, whatever ran before in the process.  The budget starts
    unset."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEGDINO_COMPUTE_DTYPE", "float32")
        mp.delenv(ENV, raising=False)
        yield


@pytest.fixture(scope="module", autouse=True)
def _setup():
    """The JAX plan library (``test_torch_port_jaxlib.py``), and one torch
    thread: the suite runs several test workers at once."""
    load_jax_sparseplan()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hybrid_cfg():
    from test_torch_port_model import PORT_CFG

    return dict(PORT_CFG, pointcloud_backbone_cfg=dict(
        PORT_CFG["pointcloud_backbone_cfg"], block_edges=(4,) * 5,
        stem_gather=True))


def _records():
    from test_torch_port_model import SCENE

    from segdino3d_tpu.data.synthetic import synthetic_scene as jax_scene
    from segdino3d_tpu_torch.data.synthetic import synthetic_scene

    return ([synthetic_scene(s, **SCENE) for s in BATCH_SEEDS],
            [jax_scene(s, **SCENE) for s in BATCH_SEEDS])


def _specs():
    from test_torch_port_model import S_CAP

    return (TC.PadSpec(2048, S_CAP, 16, 16, N_SEM),
            JC.PadSpec(2048, S_CAP, 16, 16, N_SEM))


@pytest.fixture(scope="module")
def lowered_mb():
    """``SEGDINO_CONV_CHUNK_MB`` at half the batch's level-0 dense buffer
    (``l0_dense_fits``: blocks x 6^3 x 48 x 2 bytes), counted by the
    port's probe on its blocks."""
    recs, _ = _records()
    tspec, _ = _specs()
    coords, valid, bidx = TC._plan_coords(recs, tspec.num_points, 0.02,
                                          False)
    _, blocks, _ = TH.probe_plan_counts(coords.reshape(-1, 3), bidx,
                                        valid.reshape(-1), [4] * 5)
    buffer = int(blocks[0]) * 6 ** 3 * 48 * 2
    assert buffer > 0
    return f"{buffer / 2 / 2 ** 20:.6f}"


@pytest.mark.parametrize("mb", [None, "384", "0.5", "2048"])
def test_budget_matches_jax(monkeypatch, mb):
    if mb is None:
        monkeypatch.delenv(ENV, raising=False)
    else:
        monkeypatch.setenv(ENV, mb)
    assert TH.l0_dense_budget_bytes() == JH.l0_dense_budget_bytes()
    if mb is None:
        assert TH.l0_dense_budget_bytes() == 1 << 30


def _l0_dense(plan):
    return plan.blocks is not None and plan.blocks[0] is not None


@pytest.mark.parametrize("budget", ["default", "lowered"])
def test_batched_plans_match_jax(monkeypatch, lowered_mb, budget):
    """``attach_host_plan`` of a batch of three on the hybrid layout, in
    both packages, at the default budget and below the batch's level-0
    dense buffer: equal plans, level 0 block-dense at the default and in
    the gather layout below it."""
    from test_torch_port_eval_loader import _assert_plans_equal

    if budget == "lowered":
        monkeypatch.setenv(ENV, lowered_mb)
    recs, jrecs = _records()
    tspec, jspec = _specs()
    args = host_plan_args(_hybrid_cfg())
    tb = TC.attach_host_plan(TC.collate(recs, tspec, "cpu"), recs, tspec,
                             **args)
    jb = JC.attach_host_plan(JC.collate(jrecs, jspec), jrecs, jspec,
                             stem_compact=False, **args)
    _assert_plans_equal(tb.plan, jb.unet_plan, jb.plan_inverse_mapping)
    assert _l0_dense(tb.plan) == (budget == "default")
    assert tb.plan.stem_nbr is not None
    assert all(t is not None for t in tb.plan.blocks[1:])


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    from test_torch_port_eval_loader import LAYOUT

    from segdino3d_tpu_torch.data.synthetic import write_scannet_layout

    root = str(tmp_path_factory.mktemp("batched_layout"))
    write_scannet_layout(root, BATCH_SEEDS, **LAYOUT)
    return root


@pytest.mark.parametrize("budget", ["default", "lowered"])
def test_eval_loader_rung_caps_match_jax(monkeypatch, data_root, budget):
    """The ``EvalLoader`` at batch 3 on the hybrid layout: its prescan's
    rung caps (level 0's edge 0 below the budget: the whole rung in the
    gather layout) and its batch's plan equal the JAX loader's."""
    from test_torch_port_eval_loader import (_assert_plans_equal, _policy,
                                             _readers)

    from segdino3d_tpu.data import bucketing as JB
    from segdino3d_tpu.data import loader as JL
    from segdino3d_tpu_torch.data import bucketing as TB
    from segdino3d_tpu_torch.data import loader as TL

    port, ref = _readers(data_root, num_semantic_classes=N_SEM,
                         adjust_class_ids=False, exclude_stuffs=False)
    cfg = dict(voxel_size=0.02, block_edges=[4] * 5, stem_gather=True)
    tl = TL.EvalLoader(port, batch_size=3, host_plan_cfg=cfg, prefetch=0,
                       bucket_policy=_policy(TB.BucketPolicy), device="cpu")
    jl = JL.EvalLoader(ref, batch_size=3, host_plan_cfg=cfg, prefetch=0,
                       bucket_policy=_policy(JB.BucketPolicy))
    if budget == "lowered":
        # below the pinned rung cap's buffer, which the loader keys on
        cap = next(iter(tl._prescan().values()))["block_caps"][0]
        tl._rung_caps = None
        monkeypatch.setenv(ENV, f"{cap * 6 ** 3 * 48 * 2 / 2 / 2 ** 20:.6f}")
    caps_t, caps_j = tl._prescan(), jl._prescan()
    assert len(caps_t) == 1
    got, want = next(iter(caps_t.values())), next(iter(caps_j.values()))
    assert got == want
    assert (got["block_edges"][0] == 0) == (budget == "lowered")
    (_, tb), = list(tl)
    (_, jb), = list(jl)
    _assert_plans_equal(tb.plan, jb.unet_plan, jb.plan_inverse_mapping)
    assert _l0_dense(tb.plan) == (budget == "default")


@pytest.fixture(scope="module")
def batched_slice(lowered_mb):
    """The eval slice of ``test_torch_port_model.py`` (its seeded weights)
    on one batch of three scenes, the hybrid layout's plans under the
    lowered budget (level 0 in the gather layout), in both packages."""
    import __graft_entry__ as ge
    from test_torch_port_model import (N_CLS, S_CAP, SCENE,
                                       _seeded_variables)

    from segdino3d_tpu.data.synthetic import synthetic_scene as jax_scene
    from segdino3d_tpu_torch.builder import Capacities, build_model
    from segdino3d_tpu_torch.convert import load_jax_variables

    recs, jrecs = _records()
    tspec, jspec = _specs()
    cfg = _hybrid_cfg()
    args = host_plan_args(cfg)
    jmodel, _, test_cfg, _, _ = ge._build(
        n_points=2048, s_cap=S_CAP, i_cap=16, k2d=16, num_layers=2,
        d_model=64, n_sem=N_SEM, n_inst_cls=N_CLS,
        feat2d=SCENE["feat_dim_2d"], init=False)
    variables = _seeded_variables(jmodel, JC.collate(
        [jax_scene(0, **SCENE)], jspec))
    tmodel, _ = build_model(cfg, Capacities(num_superpoints=S_CAP),
                            device="cpu")
    load_jax_variables(tmodel, variables)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(ENV, lowered_mb)
        tb = TC.attach_host_plan(TC.collate(recs, tspec, "cpu"), recs,
                                 tspec, **args)
        jb = JC.attach_host_plan(JC.collate(jrecs, jspec), jrecs, jspec,
                                 stem_compact=False, **args)
    assert not _l0_dense(tb.plan) and tb.plan.blocks[1] is not None
    with torch.no_grad():
        tout = tmodel(tb)
    jout = jax.device_get(jax.jit(
        lambda v, b: jmodel.apply(v, b, False)[0])(variables, jb))
    return dict(jmodel=jmodel, variables=variables, tmodel=tmodel,
                test_cfg=test_cfg, recs=recs, jrecs=jrecs, tb=tb, jb=jb,
                tout=tout, jout=jout)


def test_batched_forward_matches_jax(batched_slice):
    sp = batched_slice
    for key in ("cls_preds", "masks", "sem_preds", "centers", "sizes"):
        got, want = sp["tout"][key].numpy(), np.asarray(sp["jout"][key])
        assert got.shape[0] == len(BATCH_SEEDS), key
        np.testing.assert_allclose(got, want, **TOL, err_msg=key)


@pytest.mark.parametrize("scene", range(len(BATCH_SEEDS)))
def test_batched_predict_instance_matches_jax(batched_slice, scene):
    """Each scene's ``predict_instance`` from the batch's outputs, held as
    ``test_torch_port_model.test_predict_instance_matches`` holds it."""
    from segdino3d_tpu.models.architecture.postprocess import \
        predict_instance as jax_predict_instance
    from segdino3d_tpu_torch.models.architecture.postprocess import \
        predict_instance

    sp, i = batched_slice, scene
    jo, to, jb, tb = sp["jout"], sp["tout"], sp["jb"], sp["tb"]
    want = jax_predict_instance(
        jo["cls_preds"][i], jo["masks"][i], jo["query_valid"][i],
        jo["sp_valid"][i], jb.superpoint_ids[i], jb.point_valid[i],
        jb.points[i, :, :3], 0.0, sp["test_cfg"], centers=jo["centers"][i],
        sizes=jo["sizes"][i], filter_outofbox=True)
    got = predict_instance(
        to["cls_preds"][i], to["masks"][i], to["query_valid"][i],
        to["sp_valid"][i], tb.superpoint_ids[i], tb.point_valid[i],
        tb.points[i, :, :3], 0.0, sp["test_cfg"], centers=to["centers"][i],
        sizes=to["sizes"][i], filter_outofbox=True)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               **TOL)
    pool = {}
    for j in range(len(want.labels)):
        key = (int(want.labels[j]), bool(want.valid[j]),
               np.asarray(want.point_masks[j]).tobytes())
        pool.setdefault(key, []).append(
            (float(want.scores[j]), np.asarray(want.boxes[j])))
    for j in range(len(got.labels)):
        key = (int(got.labels[j]), bool(got.valid[j]),
               got.point_masks[j].numpy().tobytes())
        cands = pool.get(key, [])
        hit = next((k for k, (s, box) in enumerate(cands)
                    if np.isclose(s, float(got.scores[j]), **TOL)
                    and np.allclose(box, got.boxes[j].numpy(), **TOL)), None)
        assert hit is not None, f"scene {i} slot {j} has no JAX counterpart"
        cands.pop(hit)


def test_batched_ap_matches_jax(batched_slice):
    from test_torch_port_model import CLASS_IDS, CLASS_NAMES

    from segdino3d_tpu.evaluation.evaluate import evaluate as jax_evaluate
    from segdino3d_tpu.evaluation.evaluator import \
        InstanceSeg3DEvaluator as JaxEvaluator
    from segdino3d_tpu_torch.evaluation.evaluate import evaluate
    from segdino3d_tpu_torch.evaluation.evaluator import \
        InstanceSeg3DEvaluator

    sp = batched_slice
    want = jax_evaluate(sp["jmodel"], sp["variables"], [(sp["jrecs"],
                                                         sp["jb"])],
                        JaxEvaluator(CLASS_IDS, CLASS_NAMES),
                        sp["test_cfg"], progress=False)
    got = evaluate(sp["tmodel"], [(sp["recs"], sp["tb"])],
                   InstanceSeg3DEvaluator(CLASS_IDS, CLASS_NAMES),
                   sp["test_cfg"])
    for key in ("all_ap", "all_ap_50", "all_ap_25"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6,
                                   err_msg=key)


# phase 12's level caps (``chip_smoke.py``: 8 headline scenes at their
# pinned caps, the 400,000-point scene at its caps) and, per role, the
# levels whose bf16 k3 convs would run on live pairs, and those of them in
# K10's row groups, were the level block-dense (the batch's level 0 is
# not); the batch-1 caps' rule is ``test_torch_port_live_k3.py``'s
SCALED_CAPS = {
    "batched": ([625664, 190976, 45568, 10752, 2560],
                {"forward": (3, 4), "dx": (0, 1, 3, 4),
                 "wgrad": (0, 1, 2, 3, 4)}, (0, 1)),
    "stress": ([262144, 80128, 19712, 4608, 1024],
               {"forward": (3, 4), "dx": (0, 1, 3, 4),
                "wgrad": (0, 1, 2, 3, 4)}, (0, 1))}


@pytest.mark.parametrize("scene", sorted(SCALED_CAPS))
def test_path_rule_at_scaled_caps(scene):
    """bf16 k3 convs at phase 12's caps, by role: the forward on live pairs
    up to L3 at a batch of 8 (10,752 voxels, where the live-pair path won
    the paired measurement), dX in row groups at the levels of at least
    65,536 voxels, on live pairs at the levels of at most 16,384; fp32
    everywhere on live pairs in the pair-major form.  K1's bf16 level-0 k3
    convs (96->96) in row groups at the levels of at least 131,072 rows,
    its fp32 ones and its stems in the pair-major form."""
    from segdino3d_tpu_torch.ops import narrow as TN
    from segdino3d_tpu_torch.tools.conv_bench import K3_CONVS

    caps, live, groups = SCALED_CAPS[scene]
    for li, cin, cout, _ in K3_CONVS:
        for role in ("forward", "dx", "wgrad"):
            ci, co = (cout, cin) if role == "dx" else (cin, cout)
            kw = dict(wgrad=role == "wgrad", dx=role == "dx", cap=caps[li])
            assert TN.live_path(27, ci, co, torch.bfloat16, True, **kw) == \
                (li in live[role]), (li, cin, cout, role)
            assert TN.live_path(27, ci, co, torch.float32, True, **kw)
        assert (TN.live_form(3, torch.bfloat16, dx=True, cap=caps[li])
                == TN.ROW_GROUPS) == (li in groups)
        assert TN.live_form(3, torch.bfloat16, cap=caps[li]) == \
            TN.PAIR_MAJOR
        assert TN.live_form(3, torch.float32, cap=caps[li]) == \
            TN.PAIR_MAJOR
    # K1 on a gather level: bf16 k3 in row groups from 131,072 rows (the
    # batch's L0 and L1, the stress scene's L0), fp32 k3 and the stems
    # pair-major (the paired measurement, ``narrow.K1_ROW_GROUPS_MIN_CAP``)
    for li, cap in enumerate(caps):
        for dx in (False, True):
            rows = TN.ROW_GROUPS if cap >= 131072 else TN.PAIR_MAJOR
            assert TN.gather_form(27, 96, 96, torch.bfloat16, cap=cap,
                                  dx=dx) == rows, (li, dx)
            assert TN.gather_form(27, 96, 96, torch.float32, cap=cap,
                                  dx=dx) == TN.PAIR_MAJOR
    assert (TN.gather_form(27, 96, 96, torch.bfloat16, cap=caps[0])
            == TN.ROW_GROUPS)
    for dt in (torch.float32, torch.bfloat16):
        assert TN.gather_form(125, 264, 32, dt, cap=caps[0]) == TN.PAIR_MAJOR


# (n_off, cap, stride, budget): within the budget; the flagship's k5 stem
# (1.47 GB) at the default budget; a batch of 8 at 384 MiB, the stem and a
# level-0 k3 conv (96 channels); one offset past the budget; an uneven cut
CHUNK_CASES = [(27, 92160, 96, 1 << 30), (125, 92160, 32, 1 << 30),
               (125, 622336, 32, 384 << 20), (27, 622336, 96, 384 << 20),
               (27, 4096, 96, 100), (125, 1000, 32, 1000 * 32 * 4 * 4),
               (1, 1 << 20, 256, 1 << 20), (8, 36864, 128, 1 << 30)]


def set_budget_bytes(monkeypatch, nbytes):
    """``SEGDINO_CONV_CHUNK_MB`` at ``nbytes`` bytes (MiB as an exact
    float string)."""
    monkeypatch.setenv(ENV, repr(nbytes / 2 ** 20))


@pytest.mark.parametrize("n_off,cap,stride,budget", CHUNK_CASES)
def test_offset_chunks_cover_every_offset_within_the_budget(
        monkeypatch, n_off, cap, stride, budget):
    set_budget_bytes(monkeypatch, budget)
    assert TH.l0_dense_budget_bytes() == budget
    chunks = TSC.offset_chunks(n_off, cap, stride)
    assert chunks[0][0] == 0 and chunks[-1][1] == n_off
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    assert all(o1 > o0 for o0, o1 in chunks)
    per_offset = cap * stride * 4
    for o0, o1 in chunks:
        assert (o1 - o0) * per_offset <= budget or o1 - o0 == 1
    fit = max(1, budget // per_offset)
    assert len(chunks) == -(-n_off // fit)
    sizes = [o1 - o0 for o0, o1 in chunks]
    assert len(set(sizes[:-1])) <= 1 and sizes[-1] <= sizes[0]


def test_offset_chunks_read_the_budget(monkeypatch):
    """At 1024 MiB (unset) the flagship stem's 1.47 GB buffer runs in two
    chunks, at 384 MiB in four; the variable is read at each call."""
    monkeypatch.delenv(ENV, raising=False)
    assert TSC.offset_chunks(125, 92160, 32) == [(0, 63), (63, 125)]
    assert TSC.offset_chunks(27, 92160, 96) == [(0, 27)]
    monkeypatch.setenv(ENV, "384")
    assert len(TSC.offset_chunks(125, 92160, 32)) == 4


def chunked_pairs_model(feats, nbr, weights, valid, chunks):
    """K1's pair-major schedule (``test_torch_port_conv_tiles.pairs_model``)
    run in offset chunks, as the kernel runs them: each chunk's live pairs
    in items of 64 into a buffer of its own offsets' pairs with its own
    index map, then each valid row adds its chunk's products in ascending
    offset order onto the fp32 carry the chunk before left."""
    from test_torch_port_conv_tiles import ITEM_PAIRS

    x, w = feats.float(), weights.float()
    pairs = TSC.gather_pairs_plain(None, nbr)
    counts = pairs.counts.tolist()
    carry = x.new_zeros(nbr.shape[1], w.shape[2])
    for o0, o1 in chunks:
        first = np.concatenate([[0], np.cumsum(counts[o0:o1])])
        partial = x.new_zeros(int(first[-1]), w.shape[2])
        pos = torch.full((o1 - o0, nbr.shape[1]), -1, dtype=torch.long)
        for o in range(o0, o1):
            n = counts[o]
            for j0 in range(0, n, ITEM_PAIRS):
                rows = pairs.rows[o, j0:min(n, j0 + ITEM_PAIRS)].long()
                at = int(first[o - o0]) + j0 + torch.arange(rows.shape[0])
                partial[at] = x[nbr[o, rows].long()] @ w[o]
                pos[o - o0, rows] = at
        for o in range(o1 - o0):
            live = (pos[o] >= 0) & valid
            carry[live] += partial[pos[o, live]]
    return carry.to(feats.dtype)


@pytest.mark.parametrize("role", ["stem", "k3"])
@pytest.mark.parametrize("per", [1, 2, 5])
def test_chunked_schedule_is_bit_equal(monkeypatch, role, per):
    from test_torch_port_conv_tiles import _plan, pairs_model

    plan = _plan("host")
    lv = plan.levels[0]
    nbr = plan.stem_nbr if role == "stem" else lv.nbr
    cin, cout = (35, 32) if role == "stem" else (40, 96)
    rng = np.random.RandomState(43)
    x = torch.from_numpy(rng.randn(lv.valid.shape[0], cin).astype(np.float32))
    w = torch.from_numpy((rng.randn(nbr.shape[0], cin, cout)
                          / np.sqrt(nbr.shape[0] * cin)).astype(np.float32))
    cap, stride = nbr.shape[1], cout
    set_budget_bytes(monkeypatch, cap * stride * 4 * per)
    chunks = TSC.offset_chunks(nbr.shape[0], cap, stride)
    assert len(chunks) > 1
    got = chunked_pairs_model(x, nbr, w, lv.valid, chunks)
    want, _ = pairs_model(x, nbr, w, lv.valid)
    assert torch.equal(got, want)
    plain = TSC.gather_conv_plain(x, nbr, w, lv.valid)
    assert float((got - plain).abs().max()) <= 1e-6 * float(
        plain.abs().max())
