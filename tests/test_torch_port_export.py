"""The serving export (``segdino3d_tpu_torch/tools/export_serving.py``) on
the CPU at the JAX tool's tiny sizes: 2 decoder layers, d_model 64,
2,048 points and 256 superpoints, one 1,500-point synthetic scene.

* the port's artifact, loaded from disk, against the port's eager
  function on the same batch, bit for bit, in fp32 (the exported scene
  and a second one served at the pinned capacities) and in bf16;
* the port's fp32 artifact against the JAX artifact
  (``tools/export_serving.export_artifact(tiny=True, platform="cpu")``)
  with the same weights (the JAX tool's ``__graft_entry__._build(seed=0)``
  variables, carried over by ``convert.load_jax_variables``) and the same
  records: labels, validity and packed masks equal and scores within
  1e-4, slots whose scores tie up to rounding matched as a multiset
  (``test_torch_port_model.py``);
* the served superpoint capacity (256) survives the init at 64;
* ``--ckpt`` with a port ``work_dir`` puts its EMA parameters in the
  artifact (the artifact gives the EMA model's outputs, not the raw
  parameters'); the CLI without ``--device`` raises where there is no
  card;
* ``load_artifact`` in a fresh process (started once the fp32 artifact
  exists, so that it runs beside the bf16 export) imports no model module
  and no JAX, and reproduces the outputs;
* ``torch.library.opcheck`` of every registered op (``ops/custom_ops.py``),
  fake against real, on the CPU;
* ``data.collate.probe_plan_caps`` against the JAX function.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import __graft_entry__ as ge  # noqa: E402
from segdino3d_tpu.data import collate as JC  # noqa: E402
from segdino3d_tpu_torch.builder import Capacities, build_model  # noqa: E402
from segdino3d_tpu_torch.convert import load_jax_variables  # noqa: E402
from segdino3d_tpu_torch.data import collate as TC  # noqa: E402
from segdino3d_tpu_torch.ops import block_dense as BD  # noqa: E402
from segdino3d_tpu_torch.ops import custom_ops as CO  # noqa: E402
from segdino3d_tpu_torch.ops import scatter as SS  # noqa: E402
from segdino3d_tpu_torch.tools import export_serving as ES  # noqa: E402

N_POINTS, S_CAP, SCENE_POINTS = 2048, 256, 1500
KEYS = ("scores", "labels", "valid", "masks_packed")
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several test workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _served_records(seeds):
    return ES.scene_records(seeds, SCENE_POINTS, S_CAP, tiny=True)


def _pinned_caps(records):
    """(voxel cap, block caps) that hold every record: the largest of
    ``probe_plan_caps`` over them."""
    spec = ES.pad_spec(N_POINTS, S_CAP, tiny=True)
    plan = ES.plan_args(tiny=True)
    vox, blocks = 0, None
    for r in records:
        v, b = TC.probe_plan_caps(
            TC.collate([r], spec, "cpu"), [r], voxel_size=0.02,
            level_cap_ratios=plan["level_cap_ratios"],
            block_edges=plan["block_edges"])
        vox = max(vox, v)
        blocks = b if blocks is None else [max(x, y)
                                           for x, y in zip(blocks, b)]
    return vox, blocks


@pytest.fixture(scope="module")
def jax_artifact(tmp_path_factory):
    """The JAX tool's fp32 artifact, its outputs, and its weights as the
    JAX tree (``_build(seed=0)``'s variables, which the tool packages)."""
    from tools.export_serving import export_artifact

    with pytest.MonkeyPatch.context() as mp:
        # the JAX tool sets a bf16 backbone where the variable is unset
        mp.setenv("SEGDINO_COMPUTE_DTYPE", "float32")
        exp, var_leaves, batch_leaves, meta, _ = export_artifact(
            str(tmp_path_factory.mktemp("jax_artifact")), platform="cpu",
            n_points=N_POINTS, s_cap=S_CAP, batch_size=1,
            n_scene_points=SCENE_POINTS, tiny=True)
        outs = jax.device_get(exp.call(var_leaves, batch_leaves))
        jmodel, _, _, _, _ = ge._build(
            n_points=1024, s_cap=64, i_cap=8, k2d=16, batch=1, num_layers=2,
            d_model=64, n_sem=20, n_inst_cls=18, feat2d=32, init=False)
    spec = JC.PadSpec(1024, 64, 8, 16, 20)
    rec = ES.scene_records([0], 1000, 64, tiny=True)
    shapes = jax.eval_shape(
        lambda b: jmodel.init({"params": jax.random.PRNGKey(0),
                               "queries": jax.random.PRNGKey(1)}, b, False),
        JC.collate(rec, spec))
    variables = jax.tree.unflatten(jax.tree.structure(shapes),
                                   [np.asarray(x) for x in var_leaves])
    return dict(outs={k: np.asarray(outs[k]) for k in KEYS}, meta=meta,
                variables=variables)


FRESH_PROCESS = f"""
import sys
sys.path.insert(0, {ROOT!r})
import torch
from segdino3d_tpu_torch.tools.export_serving import load_artifact
call, meta = load_artifact(sys.argv[1])
io = torch.load(sys.argv[2])
got = call(io["leaves"])
for k, v in io["want"].items():
    assert torch.equal(got[k], v), k
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "segdino3d_tpu.",
                                            "segdino3d_tpu_torch.models"))
             or m in ("segdino3d_tpu", "segdino3d_tpu_torch.builder",
                      "segdino3d_tpu_torch.registry"))
assert not bad, bad
print("SERVED", int(got["valid"].sum()))
"""


@pytest.fixture(scope="module")
def fp32_artifact(jax_artifact, tmp_path_factory):
    """The port's fp32 artifact with the JAX weights, exported on scene 0
    at capacities pinned for scenes 0 and 1, and a fresh process started
    on it (``FRESH_PROCESS``, waited for by its test)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEGDINO_COMPUTE_DTYPE", "float32")
        init, _ = build_model(
            ES.model_config(True, "float32", "float32"),
            Capacities(num_superpoints=64), device="cpu")
        load_jax_variables(init, jax_artifact["variables"])
        vox, blocks = _pinned_caps(_served_records([0, 1]))
        out = str(tmp_path_factory.mktemp("port_fp32"))
        ep, sd, leaves, meta, eager = ES.export_artifact(
            out, "cpu", N_POINTS, S_CAP, 1, SCENE_POINTS, tiny=True,
            state_dict=init.state_dict(), voxel_cap=vox, block_caps=blocks)
    call, loaded_meta = ES.load_artifact(out)
    got = call(leaves)
    io = str(tmp_path_factory.mktemp("fresh") / "io.pt")
    torch.save({"leaves": leaves, "want": got}, io)
    fresh = subprocess.Popen(
        [sys.executable, "-c", FRESH_PROCESS, out, io],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    yield dict(out=out, ep=ep, leaves=leaves, meta=meta, eager=eager,
               call=call, loaded_meta=loaded_meta, got=got,
               want=eager(*leaves), fresh=fresh)
    if fresh.poll() is None:
        fresh.kill()
        fresh.communicate()


def _perturbed_ema_work_dir(path):
    """A port work_dir whose checkpoint holds seeded parameters and an EMA
    shadow that differs from them."""
    from segdino3d_tpu_torch.builder import random_init_
    from segdino3d_tpu_torch.train.checkpoint import (TrainState,
                                                      save_checkpoint)
    from segdino3d_tpu_torch.train.ema import EMA
    from segdino3d_tpu_torch.train.optim import AdamW

    model, _ = build_model(ES.model_config(True, "bfloat16", "float32"),
                           Capacities(num_superpoints=64), device="cpu")
    random_init_(model, seed=3)
    ema = EMA(model.named_parameters(), 0.9)
    with torch.no_grad():
        for v in ema.shadow.values():
            v.mul_(0.75).add_(0.01)
    opt = AdamW([(list(model.parameters()), lambda step: 1e-4)])
    save_checkpoint(path, TrainState(model, opt, ema))
    return model, ema


@pytest.fixture(scope="module")
def bf16_artifact(tmp_path_factory):
    """The CLI's default bf16 artifact with ``--ckpt`` (a work_dir with an
    EMA shadow) and ``--run`` (its outputs), and the eager bf16 model on
    the same batch with the EMA weights and with the raw ones."""
    work = str(tmp_path_factory.mktemp("work"))
    raw, ema = _perturbed_ema_work_dir(work)
    out = str(tmp_path_factory.mktemp("port_bf16"))
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("SEGDINO_COMPUTE_DTYPE", raising=False)
        got = ES.main(["--out", out, "--tiny", "--device", "cpu", "--run",
                       "--points", str(N_POINTS), "--sp", str(S_CAP),
                       "--scene-points", str(SCENE_POINTS), "--ckpt", work])
    with open(os.path.join(out, "meta.json")) as f:
        meta = json.load(f)
    model, test_cfg = build_model(
        ES.model_config(True, "bfloat16", "float32"),
        Capacities(num_superpoints=S_CAP, num_voxels=N_POINTS),
        device="cpu")
    leaves = ES.serving_batch(_served_records([0]), meta, "cpu")
    batch = _batch_of(leaves, meta)
    infer = ES.build_infer_fn(model, test_cfg, 1)
    with torch.no_grad():
        model.load_state_dict(raw.state_dict())
        want_raw = infer(batch)
        ES._load_ckpt_state(work, model, "x_slowest")
        want = infer(batch)
    return dict(meta=meta, ema=ema, got=got, want=want, want_raw=want_raw,
                params=dict(model.named_parameters()))


def _batch_of(leaves, meta):
    """The ``SceneBatch`` of a served batch's leaves (the structure of a
    batch planned at the artifact's capacities)."""
    recs = _served_records([0])
    p = meta["pad_spec"]
    spec = TC.PadSpec(p["n_points"], p["s_cap"], p["i_cap"], p["k2d"],
                      p["n_sem"])
    batch = TC.attach_host_plan(TC.collate(recs, spec, "cpu"), recs, spec,
                                **meta["plan"])
    return TC.fill_skeleton(TC.batch_skeleton(batch), leaves)


def _assert_equal(got, want):
    for k in KEYS:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def test_fp32_artifact_equals_eager(fp32_artifact):
    a = fp32_artifact
    _assert_equal(a["got"], a["want"])
    assert a["loaded_meta"] == a["meta"]
    assert a["meta"]["platform"] == "cpu"
    assert a["meta"]["compute_dtype"] == "float32"
    assert a["meta"]["n_batch_leaves"] == len(a["leaves"])
    # some slots are valid, so the comparison holds instances
    assert int(a["got"]["valid"].sum()) > 0


def test_fp32_artifact_serves_another_scene(fp32_artifact):
    """Scene 1 at the capacities the artifact was exported at."""
    a = fp32_artifact
    leaves = ES.serving_batch(_served_records([1]), a["meta"], "cpu")
    _assert_equal(a["call"](leaves), a["eager"](*leaves))


def test_bf16_artifact_equals_eager(bf16_artifact):
    a = bf16_artifact
    assert a["meta"]["compute_dtype"] == "bfloat16"
    _assert_equal(a["got"], a["want"])


def test_ckpt_puts_ema_params_in_artifact(bf16_artifact):
    """The eager model the artifact equals holds the EMA shadow, and the
    raw parameters give other outputs."""
    a = bf16_artifact
    for name, shadow in a["ema"].shadow.items():
        assert torch.equal(a["params"][name], shadow), name
    _assert_equal(a["got"], a["want"])
    assert not torch.equal(a["got"]["scores"], a["want_raw"]["scores"])


def test_artifact_matches_jax_artifact(fp32_artifact, jax_artifact):
    got = {k: v.numpy() for k, v in fp32_artifact["got"].items()}
    want = jax_artifact["outs"]
    assert got["scores"].shape == want["scores"].shape
    assert got["masks_packed"].shape == want["masks_packed"].shape
    np.testing.assert_allclose(got["scores"], want["scores"], **TOL)
    np.testing.assert_array_equal(got["valid"].sum(), want["valid"].sum())
    # slots sorted by decayed score may trade places where scores tie up
    # to rounding: match them as a multiset
    pool = {}
    for i in range(want["labels"].shape[1]):
        key = (int(want["labels"][0, i]), bool(want["valid"][0, i]),
               want["masks_packed"][0, i].tobytes())
        pool.setdefault(key, []).append(float(want["scores"][0, i]))
    for i in range(got["labels"].shape[1]):
        key = (int(got["labels"][0, i]), bool(got["valid"][0, i]),
               got["masks_packed"][0, i].tobytes())
        cands = pool.get(key, [])
        hit = next((j for j, s in enumerate(cands)
                    if np.isclose(s, got["scores"][0, i], **TOL)), None)
        assert hit is not None, f"slot {i} has no JAX counterpart"
        cands.pop(hit)


def test_served_s_cap_survives_init(fp32_artifact, jax_artifact):
    """The model is initialised at s_cap 64 and served at 256: the
    artifact's superpoint leaves are 256 wide, as the JAX artifact's."""
    meta = fp32_artifact["meta"]
    assert meta["pad_spec"]["s_cap"] == S_CAP
    shapes = dict(zip(meta["batch_leaf_paths"], meta["batch_leaf_shapes"]))
    assert shapes[".sp_inst_masks"][-1] == S_CAP
    assert any(s[-1] == S_CAP for s in
               jax_artifact["meta"]["batch_leaf_shapes"])
    sp_ids = fp32_artifact["leaves"][
        meta["batch_leaf_paths"].index(".superpoint_ids")]
    assert int(sp_ids.max()) >= 64


def test_cli_without_device_raises_where_no_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ES.main(["--out", str(tmp_path / "a"), "--tiny"])
    assert not (tmp_path / "a").exists()


def test_load_artifact_in_fresh_process(fp32_artifact):
    fresh = fp32_artifact["fresh"]
    stdout, stderr = fresh.communicate(timeout=300)
    assert fresh.returncode == 0, stderr[-3000:]
    assert "SERVED" in stdout


def _op_samples():
    """(op, args) of every registered op on a small hybrid plan."""
    rec = ES.scene_records([0], 600, 32, tiny=True)
    spec = TC.PadSpec(1024, 32, 8, 16, 20)
    batch = TC.attach_host_plan(TC.collate(rec, spec, "cpu"), rec, spec,
                                voxel_size=0.02, voxel_cap=1024,
                                level_cap_ratios=(1.0, 0.6, 0.4, 0.3, 0.2),
                                block_edges=[4] * 5, stem_gather=True)
    plan, gen = batch.plan, torch.Generator().manual_seed(0)
    lv0, t0 = plan.levels[0], plan.blocks[0]
    v0, v1 = lv0.valid.shape[0], plan.levels[1].valid.shape[0]
    occ = t0.slot_vox >= 0
    pvalid = batch.point_valid.reshape(-1)
    pts = batch.points.reshape(-1, 6)

    def randn(*shape):
        return torch.randn(*shape, generator=gen)

    seg = batch.superpoint_ids.reshape(-1)
    csr = list(SS.segment_csr(seg, 32, pvalid))
    rows = CO.block_rows_op(occ)
    cap, n_rows = BD.live_capacity(t0), occ.shape[0]
    live = CO.block_live_pairs_op(rows, occ, t0.block_nbr, 4, 3, cap, cap)
    return [
        (CO.gather_pairs_op, (None, lv0.child)),
        (CO.gather_conv_op, (randn(v0, 5), plan.stem_nbr, randn(125, 5, 4),
                             lv0.valid, None)),
        (CO.up_conv_op, (randn(v1, 6), lv0.child, lv0.parent, lv0.kpos,
                         randn(8, 6, 4), lv0.valid, None)),
        (CO.slot_gather, (randn(v0, 3), t0.slot_vox)),
        (CO.block_rows_op, (occ,)),
        (CO.block_live_pairs_op, (rows, occ, t0.block_nbr, 4, 3, cap,
                                  cap)),
        (CO.block_live_pairs_op, (CO.block_rows_op(
            BD.dilation(t0, occ, 3)[0]), occ, t0.block_nbr, 4, 3, cap,
            n_rows)),
        (CO.block_conv_op, (randn(occ.shape[0], 4), t0.block_nbr,
                            randn(27, 4, 3), occ, 4, None, 0, None, 0, 0)),
        (CO.block_conv_op, (randn(occ.shape[0], 4), t0.block_nbr,
                            randn(27, 4, 3), occ, 4, rows, 0, live, cap,
                            cap)),
        (CO.segment_csr_op, (plan.inverse, v0, pvalid)),
        (CO.segment_mean_gather_op, (seg, 32, pvalid, randn(v0, 3),
                                     plan.inverse, [pts[:, 3:], pts[:, :3]],
                                     csr, None)),
        (CO.segment_mean_gather_op, (seg, 32, pvalid, None, None,
                                     [pts[:, 3:]], csr, torch.bfloat16)),
    ]


def test_every_op_registered_and_sampled():
    names = {op._qualname for op, _ in _op_samples()}
    assert names == {op._qualname for op in CO.OPS}


@pytest.mark.parametrize("case", range(12))
def test_opcheck(case):
    op, args = _op_samples()[case]
    torch.library.opcheck(op, args)


@pytest.mark.parametrize("edges", (None, [4] * 5, [0, 4, 4, 4, 4]))
def test_probe_plan_caps_matches_jax(edges):
    recs = ES.scene_records([0, 1], SCENE_POINTS, S_CAP, tiny=True)
    kw = dict(voxel_size=0.02, level_cap_ratios=(1.0, 0.6, 0.4, 0.3, 0.2),
              block_edges=edges)
    spec_args = (N_POINTS, S_CAP, 8, 16, 20)
    got = TC.probe_plan_caps(TC.collate(recs, TC.PadSpec(*spec_args), "cpu"),
                             recs, **kw)
    want = JC.probe_plan_caps(JC.collate(recs, JC.PadSpec(*spec_args)), recs,
                              **kw)
    assert got == want
