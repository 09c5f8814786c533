"""Distribution in both packages: the port's ``torch.distributed`` step,
sharded eval loading, the eval result gather, and a signal in a group.

Two ``spawn``ed processes (``torch_port_procs.spawn_group``) join one gloo
group over a ``file://`` store (``init_process_group`` timeout 60 s, every
join bounded).  In one run of the group:

* the port's step of the small SegDINO3D of ``test_torch_port_train.py``
  (seeded weights carried by ``convert.py``, the same query selection)
  with ``process_group``: one scene a process, and two a process as
  ``accum_steps=2`` microbatches.  Rank 0 holds it to the JAX package's
  ``make_train_step(mesh=make_mesh(2), stacked_batch=True)`` on two of
  the eight host devices (``tests/conftest.py``), frozen in
  ``tests/fixtures/torch_port_dist_train_step.npz`` (the 2-device step
  compiles for minutes on a CPU): metrics, matches, clipped gradients,
  updates, batch-norm statistics (JAX's ``pmean`` of them) and EMA at
  ``test_torch_port_train.py``'s tolerances.  Every rank's state after
  the step equals rank 0's bit for bit, and a step makes one all-reduce
  whatever ``accum_steps``.  Regenerate with
  ``python tests/test_torch_port_dist.py --regen``; the ``slow`` test
  runs the JAX step live.  The step is as ill-conditioned as the one of
  ``test_torch_port_train.py`` (its docstring), more so on some scene
  sets: ``python tests/test_torch_port_dist.py --conditioning`` moves
  every weight by a relative 1e-6 and reports how far each set's worst
  gradient probe moves, in units of its tolerance: 9.3 for the accum1
  scenes (0, 11), 32.9 for (0, 11, 3, 7) (on which one port-vs-JAX
  probe misses its tolerance), 6.8 for the accum2 scenes (0, 11, 5, 6)
  (the port on the CPU).  ``--witness`` runs each set without the group
  too: on (0, 11, 3, 7) the port's one-process step misses the JAX
  1-device step at the same probe, by the same amount, as the 2-process
  step misses the 2-device one;
* eval of five scenes from disk at batch 2 (``EvalLoader`` with
  ``process_index`` / ``process_count``), gathered through a directory
  that holds an earlier eval's shards: both processes hold one process's
  results (scene order, masks, labels, scores) and its AP, which equals the JAX driver's
  ``evaluate(..., process_count=2, gather_dir=...)`` (random weights: the
  AP is 0, so the JAX side is also held to the port's gathered scene
  order and instance counts);
* a SIGTERM to rank 1 stops both ranks at one step boundary, and only
  rank 0 writes the checkpoint;
* the port's CLI (``train_3d.main``, ``--device cpu``) in the group on
  ``test_torch_port_cli.py``'s tiny config: two steps, rank 0's
  checkpoints and config, a log a rank, an eval cache a rank, the
  in-loop eval gathered through ``eval_gather/step_<N>``.

The ``EvalLoader``'s process shards and ``mesh_shards`` lists (a padded
tail too) are held equal to the JAX loader's in this process.
"""
import os
import sys
import threading

import jax
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_port_jaxlib import load_jax_sparseplan  # noqa: E402
from test_torch_port_train import (FEAT2D, I_CAP, K2D, N_CLS,  # noqa: E402
                                   N_POINTS, N_SEM, S_CAP, SCENE, VOXEL_CAP)
from torch_port_procs import spawn_group  # noqa: E402

from segdino3d_tpu.data import loader as JL  # noqa: E402
from segdino3d_tpu.data import scannet_dataset as JD  # noqa: E402
from segdino3d_tpu_torch.data import collate as TC  # noqa: E402
from segdino3d_tpu_torch.data import loader as TL  # noqa: E402
from segdino3d_tpu_torch.data import scannet_dataset as TD  # noqa: E402
from segdino3d_tpu_torch.data.synthetic import write_scannet_layout  # noqa: E402
from segdino3d_tpu_torch.evaluation.evaluator import \
    InstanceSeg3DEvaluator  # noqa: E402
from segdino3d_tpu_torch.parallel import mesh  # noqa: E402

FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                       "torch_port_dist_train_step.npz")
# each case: (accum_steps, the scenes' seeds, device- / rank-major); the
# accum2 scenes were chosen for their conditioning (``--conditioning``)
CASES = {"accum1": (1, (0, 11)), "accum2": (2, (0, 11, 5, 6))}
EVAL_SEEDS = (0, 1, 2, 3, 4)
# 2,000 points: the AP protocol counts instances of 100 points or more
EVAL_LAYOUT = dict(n_points=2000, n_superpoints=48, n_classes=N_CLS,
                   n_instances=5, n_queries2d=12, feat_dim_2d=FEAT2D)
EVAL_POINTS = 2048
EVAL_PLAN = dict(voxel_size=0.02, voxel_cap=2 * EVAL_POINTS,
                 stem_compact=False)
CLASS_IDS = [1, 2] + [100 + i for i in range(N_CLS - 2)]
CLASS_NAMES = ["wall", "floor"] + [f"c{i}" for i in range(N_CLS - 2)]


# --------------------------------------------------------------------------
# the JAX side
# --------------------------------------------------------------------------

def _jax_model():
    import __graft_entry__ as ge

    load_jax_sparseplan()
    return ge._build(n_points=N_POINTS, s_cap=S_CAP, i_cap=I_CAP, k2d=K2D,
                     num_layers=2, d_model=64, n_sem=N_SEM,
                     n_inst_cls=N_CLS, feat2d=FEAT2D, init=False)


def jax_dist_reference(case):
    """The JAX package's 2-device ``shard_map`` step of ``case`` from
    ``test_torch_port_train.initial_variables()`` -> the fixture's
    contents of that case."""
    from test_torch_port_train import initial_variables, jax_step

    from segdino3d_tpu.data import collate as JC
    from segdino3d_tpu.data.synthetic import synthetic_scene
    from segdino3d_tpu.parallel.mesh import make_mesh

    accum, seeds = CASES[case]
    jmodel, jcrit, _, _, _ = _jax_model()
    spec = JC.PadSpec(N_POINTS, S_CAP, I_CAP, K2D, N_SEM)
    recs = [synthetic_scene(s, **SCENE) for s in seeds]
    mbs = [JC.attach_host_plan(JC.collate([r], spec), [r], spec,
                               voxel_size=0.02, voxel_cap=VOXEL_CAP,
                               stem_compact=False) for r in recs]
    return jax_step(jmodel, jcrit, mbs, initial_variables(),
                    mesh=make_mesh(2), accum_steps=accum)


def regen():
    import time

    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=8")
    jax.config.update("jax_platforms", "cpu")
    t0 = time.perf_counter()
    out = {}
    for case in CASES:
        for k, v in jax_dist_reference(case).items():
            out[f"{case}__{k}"] = v
        print(f"{case}: metrics {out[case + '__metrics'].item()}")
    np.savez_compressed(FIXTURE, **out)
    print(f"wrote {FIXTURE} in {time.perf_counter() - t0:.0f} s")


# --------------------------------------------------------------------------
# the port's group run
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def eval_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dist_layout"))
    write_scannet_layout(root, EVAL_SEEDS, **EVAL_LAYOUT)
    return root


def _reader_kw(root):
    return dict(scene_set="val", root_scenes=root,
                root_points_2dfeats=os.path.join(root, "features_2d"),
                num_semantic_classes=N_SEM, adjust_class_ids=False,
                exclude_stuffs=False)


def _eval_state(root):
    """What the eval processes read: reader, pad spec, plan, batch size,
    classes and the JAX model's test config."""
    test_cfg = _jax_model()[2]
    return dict(reader=_reader_kw(root),
                spec=TC.PadSpec(EVAL_POINTS, S_CAP, I_CAP, K2D, N_SEM),
                plan=EVAL_PLAN, batch_size=2,
                classes=(CLASS_IDS, CLASS_NAMES), test_cfg=dict(test_cfg))


def _cli_args(tmp):
    """The tiny CLI config and scenes of ``test_torch_port_cli.py`` under
    ``tmp``: its arguments for two steps and an eval at step 2."""
    import pathlib

    from test_torch_port_cli import _setup

    cfg, work = _setup(pathlib.Path(tmp) / "cli", [0, 1, 2], **{
        "num_iterations = 4": "num_iterations = 2",
        "save_step = 4": "save_step = 1"})
    return ["--config_file", cfg, "--work_dir", work, "--seed", "1",
            "--device", "cpu", "--num_eval_scenes", "3", "--options",
            "eval_step=2"]


def group_tasks(tmp, fixture, root):
    import pickle

    state_path = os.path.join(tmp, "eval_state.pkl")
    with open(state_path, "wb") as f:
        pickle.dump(_eval_state(root), f)
    # shards an earlier eval left in the gather directory (no scenes):
    # the group's eval must not take them for its own
    gather_dir = os.path.join(tmp, "gather")
    os.makedirs(gather_dir)
    for r in (0, 1):
        with open(os.path.join(gather_dir, f"shard_{r:04d}.pkl"), "wb") as f:
            pickle.dump([], f)
    tasks = [(case, "step", dict(fixture=fixture, case=case, seeds=seeds))
             for case, (_, seeds) in CASES.items()]
    tasks += [("evaluate", "evaluate",
               dict(root=root, state_path=state_path,
                    gather_dir=gather_dir)),
              ("reduce", "reduce", {}),
              ("sigterm", "sigterm",
               dict(work_dir=os.path.join(tmp, "work"), signal_rank=1)),
              ("cli", "cli", dict(args=_cli_args(tmp)))]
    return tasks


@pytest.fixture(scope="module")
def group(tmp_path_factory, eval_root):
    assert os.path.exists(FIXTURE), "fixture missing: run --regen"
    tmp = str(tmp_path_factory.mktemp("group"))
    return tmp, spawn_group(2, tmp, group_tasks(tmp, FIXTURE, eval_root),
                            timeout_s=240.0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_process_step_matches_jax_shard_map_step(group, case):
    """Rank 0 held to the frozen JAX step in its process (an assertion
    there fails the group); every rank ends with rank 0's parameters,
    gradients, buffers and EMA, and the same metrics."""
    _, ranks = group
    assert all(r[case]["same"] for r in ranks)
    assert ranks[0][case]["metrics"] == ranks[1][case]["metrics"]


def test_accum_steps_2_reduces_once(group):
    """Gradients, losses and batch-norm statistics go in one all-reduce a
    step (one dtype), with one microbatch and with two."""
    _, ranks = group
    for r in ranks:
        assert r["accum1"]["n_reduce"] == 1
        assert r["accum2"]["n_reduce"] == 1


def test_all_reduce_mean_one_collective_per_dtype(group):
    _, ranks = group
    for r in ranks:
        assert r["reduce"]["n_reduce"] == 2
        np.testing.assert_array_equal(r["reduce"]["f32"], [0.5, 1.5, 2.5])
        np.testing.assert_array_equal(r["reduce"]["f64"], [[1.5], [10.5]])


def test_sigterm_on_one_rank_stops_every_rank(group):
    """SIGTERM to rank 1: both ranks leave the loop at one step boundary
    (the guard's flag all-reduced there); rank 0 alone writes the
    checkpoint of that step; the handlers come back."""
    from segdino3d_tpu_torch.train.checkpoint import latest_step

    tmp, ranks = group
    done = ranks[0]["sigterm"]["step"]
    assert 0 < done < 10_000
    assert ranks[1]["sigterm"]["step"] == done
    assert ranks[0]["sigterm"]["saves"] == [done]
    assert ranks[1]["sigterm"]["saves"] == []
    assert all(r["sigterm"]["handlers_back"] for r in ranks)
    assert latest_step(os.path.join(tmp, "work")) == done


def test_cli_in_a_group(group):
    """Both ranks train to step 2; process 0 alone wrote the config and
    the checkpoints (one of each step), each rank logged to its own file
    and built its own eval cache, and the in-loop eval gathered both
    shards of step 2, so both ranks logged the same mAP line."""
    import re

    tmp, ranks = group
    assert [r["cli"] for r in ranks] == [2, 2]
    work = os.path.join(tmp, "cli", "work")
    assert sorted(os.listdir(os.path.join(work, "checkpoints"))) == [
        "step_0000000001.pth", "step_0000000002.pth"]
    assert os.path.isfile(os.path.join(work, "config.py"))
    assert sorted(os.listdir(os.path.join(work, "eval_gather",
                                          "step_0000000002"))) == [
        "shard_0000.pkl", "shard_0001.pkl"]
    assert len(os.listdir(os.path.join(work, "eval_cache"))) == 2
    logs = []
    for r in (0, 1):
        with open(os.path.join(work, f"log_{r}", "log.txt")) as f:
            logs.append(f.read())
        assert f"process {r} of 2 (gloo)" in logs[r]
    maps = [re.findall(r"mAP: .*", log) for log in logs]
    assert maps[0] and maps[0] == maps[1]


def _port_eval(root, evaluator=None, **kw):
    from test_torch_port_train import PORT_CFG, initial_variables

    from segdino3d_tpu_torch.builder import Capacities, build_model
    from segdino3d_tpu_torch.convert import load_jax_variables
    from segdino3d_tpu_torch.evaluation.evaluate import evaluate

    st = _eval_state(root)
    model, _ = build_model(PORT_CFG, Capacities(num_superpoints=S_CAP),
                           device="cpu")
    load_jax_variables(model, initial_variables())
    loader = TL.EvalLoader(TD.ScanNet200InstanceSeg3D(**st["reader"]),
                           st["spec"], host_plan_cfg=EVAL_PLAN, batch_size=2,
                           device="cpu", **kw)
    return evaluate(model, loader, evaluator or InstanceSeg3DEvaluator(
        CLASS_IDS, CLASS_NAMES), st["test_cfg"])


def _jax_eval_two_processes(root, gather_dir):
    """JAX's ``evaluate(..., process_count=2, gather_dir=...)``, its two
    processes as two threads sharing one compiled predict."""
    from test_torch_port_train import initial_variables

    from segdino3d_tpu.data.collate import PadSpec
    from segdino3d_tpu.evaluation import evaluate as JE
    from segdino3d_tpu.evaluation.evaluator import \
        InstanceSeg3DEvaluator as JaxEvaluator

    jmodel, _, test_cfg, _, _ = _jax_model()
    variables = initial_variables()
    predict = JE.make_predict_fn(jmodel, test_cfg)
    real = JE.make_predict_fn
    JE.make_predict_fn = lambda *a, **kw: predict
    out, errors = {}, []
    evaluators = {pi: JaxEvaluator(CLASS_IDS, CLASS_NAMES) for pi in (0, 1)}

    def run(pi):
        try:
            loader = JL.EvalLoader(
                JD.ScanNet200InstanceSeg3D(**_reader_kw(root)),
                PadSpec(EVAL_POINTS, S_CAP, I_CAP, K2D, N_SEM),
                host_plan_cfg=EVAL_PLAN, batch_size=2, process_index=pi,
                process_count=2)
            out[pi] = JE.evaluate(jmodel, variables, loader, evaluators[pi],
                                  test_cfg, progress=False,
                                  gather_dir=gather_dir, process_index=pi,
                                  process_count=2)
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=run, args=(pi,)) for pi in (0, 1)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(180.0)
    finally:
        JE.make_predict_fn = real
    assert not any(t.is_alive() for t in threads), "JAX eval hung"
    if errors:
        raise errors[0]
    return out, {pi: ev._results for pi, ev in evaluators.items()}


def test_gathered_ap_matches_one_process_and_jax(group, eval_root,
                                                 tmp_path):
    tmp, ranks = group
    ev = InstanceSeg3DEvaluator(CLASS_IDS, CLASS_NAMES)
    one = _port_eval(eval_root, evaluator=ev)
    want, jax_results = _jax_eval_two_processes(
        eval_root, str(tmp_path / "jax_gather"))
    assert np.isfinite(one["all_ap_25"])
    # merged in rank order: rank 0's global batches 0 and 2, then rank 1's
    scenes = [f"synth{s:04d}" for s in (0, 1, 4, 2, 3)]
    by_scene = {a["lidar_idx"]: (a, p) for a, p in ev._results}
    for r in ranks:
        got = r["evaluate"]
        np.testing.assert_equal(got["ap"], one)
        assert [a["lidar_idx"] for a, _ in got["results"]] == scenes
        for ga, gp in got["results"]:
            oa, op = by_scene[ga["lidar_idx"]]
            for d, o in ((ga, oa), (gp, op)):
                assert d.keys() == o.keys()
                for k in d:
                    np.testing.assert_array_equal(d[k], o[k], k)
    for pi in (0, 1):
        for key in ("all_ap", "all_ap_50", "all_ap_25"):
            np.testing.assert_allclose(one[key], want[pi][key], rtol=0,
                                       atol=1e-6, err_msg=key)
        assert [(a["lidar_idx"], len(p["instance_labels"]))
                for a, p in jax_results[pi]] == \
            [(a["lidar_idx"], len(p["instance_labels"]))
             for a, p in ranks[0]["evaluate"]["results"]]
    shards = sorted(os.listdir(os.path.join(tmp, "gather")))
    assert shards == ["shard_0000.pkl", "shard_0001.pkl"]


def _jax_eval_loader(root, **kw):
    from segdino3d_tpu.data.collate import PadSpec

    return JL.EvalLoader(JD.ScanNet200InstanceSeg3D(**_reader_kw(root)),
                         PadSpec(EVAL_POINTS, S_CAP, I_CAP, K2D, N_SEM),
                         host_plan_cfg=EVAL_PLAN, batch_size=2, **kw)


@pytest.mark.parametrize("pi,pc,shards", [(0, 2, 1), (1, 2, 1), (0, 1, 2),
                                          (1, 2, 2)])
def test_eval_loader_shards_match_jax(eval_root, pi, pc, shards):
    """This process's batches (round-robin over the global batches) and,
    with ``mesh_shards=2``, each batch's list of shards (the tail's last
    scene repeated, only the real records yielded) equal the JAX loader's
    records and stacked batches."""
    from test_torch_port_train_data import _assert_batch_equal

    kw = dict(process_index=pi, process_count=pc, mesh_shards=shards)
    tl = TL.EvalLoader(TD.ScanNet200InstanceSeg3D(**_reader_kw(eval_root)),
                       TC.PadSpec(EVAL_POINTS, S_CAP, I_CAP, K2D, N_SEM),
                       host_plan_cfg=EVAL_PLAN, batch_size=2, device="cpu",
                       **kw)
    jl = _jax_eval_loader(eval_root, **kw)
    got, want = list(tl), list(jl)
    assert len(got) == len(want) == len(tl) == len(jl)
    n_global = -(-len(EVAL_SEEDS) // 2)
    assert len(got) == len(range(pi, n_global, pc))
    for (trecs, tb), (jrecs, jb) in zip(got, want):
        assert [r["scene_id"] for r in trecs] == \
            [r["scene_id"] for r in jrecs]
        for a, b in zip(trecs, jrecs):
            np.testing.assert_array_equal(a["points"], b["points"])
        if shards == 1:
            _assert_batch_equal(tb, jb)
            continue
        assert isinstance(tb, list) and len(tb) == shards
        for i, sb in enumerate(tb):
            assert sb.batch_size == 1
            _assert_batch_equal(
                sb, jax.tree_util.tree_map(lambda x: np.asarray(x)[i], jb),
                pad_ok=True)
    if shards > 1 and (n_global - 1) % pc == pi:
        # the last global batch holds scene 4 alone: its second shard
        # repeats it
        last = got[-1][1]
        assert len(got[-1][0]) == 1
        np.testing.assert_array_equal(last[0].points.numpy(),
                                      last[1].points.numpy())


def test_eval_loader_refuses_bad_shards(eval_root):
    reader = TD.ScanNet200InstanceSeg3D(**_reader_kw(eval_root))
    spec = TC.PadSpec(EVAL_POINTS, S_CAP, I_CAP, K2D, N_SEM)
    with pytest.raises(ValueError, match="multiple of mesh_shards"):
        TL.EvalLoader(reader, spec, batch_size=3, mesh_shards=2,
                      device="cpu")
    with pytest.raises(ValueError, match="process_index 2 of 2"):
        TL.EvalLoader(reader, spec, process_index=2, process_count=2,
                      device="cpu")


def test_load_shards_times_out_on_a_missing_shard(tmp_path):
    ev = InstanceSeg3DEvaluator(CLASS_IDS, CLASS_NAMES)
    ev.save_shard(str(tmp_path), 0)
    with pytest.raises(TimeoutError, match="shard_0001.pkl"):
        ev.load_shards(str(tmp_path), 2, timeout_s=0.5)
    ev.load_shards(str(tmp_path), 1)


def test_multi_process_eval_needs_a_group(tmp_path):
    """Without a process group of ``process_count`` processes the gather
    could not order its clean-up before the other processes' writes:
    ``evaluate`` refuses before it reads a batch."""
    from segdino3d_tpu_torch.evaluation.evaluate import evaluate

    ev = InstanceSeg3DEvaluator(CLASS_IDS, CLASS_NAMES)
    with pytest.raises(ValueError, match="process group of that size"):
        evaluate(None, iter(()), ev, {}, gather_dir=str(tmp_path),
                 process_index=0, process_count=2)
    with pytest.raises(ValueError, match="needs gather_dir"):
        evaluate(None, iter(()), ev, {}, process_index=0, process_count=2)


def test_one_process_without_a_group(monkeypatch):
    """No group in the environment: one process, collectives no-ops."""
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert mesh.init_distributed(torch.device("cpu")) is False
    assert (mesh.process_index(), mesh.process_count()) == (0, 1)
    assert mesh.process_is_main()
    mesh.barrier()
    t = torch.ones(3)
    mesh.all_reduce_mean_([t])
    assert torch.equal(t, torch.ones(3))
    assert mesh.any_flag(True)
    assert mesh.local_device(torch.device("cpu")).type == "cpu"
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert mesh.local_device(torch.device("cuda")) == torch.device("cuda", 3)


def test_a_named_group_that_fails_raises(monkeypatch):
    """The environment names a group that cannot form: the error reaches
    the caller (the JAX package's ``init_distributed`` swallows it)."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("MASTER_PORT", raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        mesh.init_distributed(torch.device("cpu"), timeout_s=5.0)
    assert not torch.distributed.is_initialized()


@pytest.mark.slow
def test_two_process_step_matches_live_jax_step(tmp_path, eval_root):
    out = {}
    for case in CASES:
        for k, v in jax_dist_reference(case).items():
            out[f"{case}__{k}"] = v
    live = str(tmp_path / "live.npz")
    np.savez_compressed(live, **out)
    tasks = [t for t in group_tasks(str(tmp_path), live, eval_root)
             if t[1] == "step"]
    spawn_group(2, str(tmp_path), tasks, timeout_s=240.0)


def conditioning():
    """How far each scene set's gradient probes move (in units of their
    tolerance) when every weight moves by a relative 1e-6 (the port's
    step on the CPU, one process)."""
    from test_torch_port_train import (LEAF_RTOL, initial_variables,
                                       leaf_hash, port_step)

    from segdino3d_tpu_torch.data.synthetic import synthetic_scene

    torch.set_num_threads(1)
    rng = np.random.RandomState(0)

    def perturb(node):
        return {k: perturb(v) if isinstance(v, dict) else
                (v * (1 + 1e-6 * rng.randn(*v.shape))).astype(np.float32)
                for k, v in node.items()}

    v0 = initial_variables()
    v1 = perturb(v0)
    for seeds in ((0, 11), (0, 11, 3, 7), (0, 11, 5, 6)):
        recs = [synthetic_scene(s, **SCENE) for s in seeds]
        hashes = []
        for v in (v0, v1):
            port = port_step(v, recs=recs)
            hashes.append(leaf_hash({n: p.grad.numpy() for n, p in
                                     port["model"].named_parameters()}))
        (names, n0, p0), (_, _, p1) = hashes
        moved = np.abs(p1 - p0) / (LEAF_RTOL * (np.abs(p0) + n0.max()))
        i = int(np.argmax(moved))
        print(f"scenes {seeds}: the probe of {names[i]} moves by "
              f"{moved[i]:.1f} x its tolerance")


def witness():
    """Each scene set's step with and without distribution: the port's
    one-process ``accum_steps=4`` step against the JAX package's 1-device
    step (``mesh=None``) on the same four microbatches, and the port's
    2-process ``accum_steps=2`` step against the JAX 2-device step, both
    held to ``check_against``: whether a set's miss needs the group."""
    import tempfile
    import time

    from test_torch_port_train import (check_against, initial_variables,
                                       jax_step, port_step)

    from segdino3d_tpu.data import collate as JC
    from segdino3d_tpu.data.synthetic import synthetic_scene as jax_scene
    from segdino3d_tpu.parallel.mesh import make_mesh
    from segdino3d_tpu_torch.data.synthetic import synthetic_scene

    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=8")
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    jmodel, jcrit, _, _, _ = _jax_model()
    spec = JC.PadSpec(N_POINTS, S_CAP, I_CAP, K2D, N_SEM)

    def verdict(check):
        try:
            check()
            return "agrees"
        except AssertionError as e:
            lines = [ln for ln in str(e).splitlines()
                     if "probe" in ln or "Max absolute" in ln
                     or "ACTUAL" in ln or "DESIRED" in ln
                     or "tolerance" in ln]
            return "misses: " + " ".join(" ".join(lines).split())[:500]

    for seeds in ((0, 11, 3, 7), (0, 11, 5, 6)):
        t0 = time.perf_counter()
        mbs = [JC.attach_host_plan(JC.collate([r], spec), [r], spec,
                                   voxel_size=0.02, voxel_cap=VOXEL_CAP,
                                   stem_compact=False)
               for r in (jax_scene(s, **SCENE) for s in seeds)]
        ref = jax_step(jmodel, jcrit, mbs, initial_variables(),
                       accum_steps=len(seeds))
        port = port_step(initial_variables(),
                         recs=[synthetic_scene(s, **SCENE) for s in seeds])
        print(f"scenes {seeds}, one process, accum_steps={len(seeds)} "
              f"({time.perf_counter() - t0:.0f} s): the port "
              f"{verdict(lambda: check_against(port, ref))}", flush=True)
        t0 = time.perf_counter()
        ref2 = jax_step(jmodel, jcrit, mbs, initial_variables(),
                        mesh=make_mesh(2), accum_steps=len(seeds) // 2)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "ref.npz")
            np.savez_compressed(path, **{f"w__{k}": v
                                         for k, v in ref2.items()})
            task = [("w", "step", dict(fixture=path, case="w",
                                       seeds=seeds))]
            print(f"scenes {seeds}, two processes, accum_steps="
                  f"{len(seeds) // 2} ({time.perf_counter() - t0:.0f} s): "
                  f"the port "
                  f"{verdict(lambda: spawn_group(2, tmp, task, 600.0))}",
                  flush=True)


if __name__ == "__main__":
    if "--regen" in sys.argv:
        regen()
    elif "--conditioning" in sys.argv:
        conditioning()
    elif "--witness" in sys.argv:
        witness()
    else:
        print(__doc__)
