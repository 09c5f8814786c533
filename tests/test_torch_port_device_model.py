"""The whole eval slice and a training step on plans built on the device.

Eval: the small SegDINO3D of ``test_torch_port_model.py`` on its three
seeded scenes, collated without a host plan, so that both packages build
the plan on the device: model outputs ``rtol = atol = 1e-4`` (fp32 sums in
another order) and AP, AP50 and AP25 of the two evaluations within
``1e-6``.

Training: the port's ``accum_steps=2`` step of ``test_torch_port_train.py``
on device plans, held to the JAX step frozen in that file's fixture at its
tolerances, and to the port's same step on host plans at the same
capacities: the two plans are equal, so the losses and every gradient must
agree within ``1e-6``.
"""
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import __graft_entry__ as ge  # noqa: E402
from segdino3d_tpu.data import collate as JC  # noqa: E402
from segdino3d_tpu.data.synthetic import synthetic_scene as jax_scene  # noqa: E402
from segdino3d_tpu.evaluation.evaluate import evaluate as jax_evaluate  # noqa: E402
from segdino3d_tpu.evaluation.evaluator import \
    InstanceSeg3DEvaluator as JaxEvaluator  # noqa: E402
from segdino3d_tpu_torch.builder import Capacities, build_model  # noqa: E402
from segdino3d_tpu_torch.convert import load_jax_variables  # noqa: E402
from segdino3d_tpu_torch.data import collate as TC  # noqa: E402
from segdino3d_tpu_torch.data.synthetic import synthetic_scene  # noqa: E402
from segdino3d_tpu_torch.evaluation.evaluate import evaluate  # noqa: E402
from segdino3d_tpu_torch.evaluation.evaluator import InstanceSeg3DEvaluator  # noqa: E402

import test_torch_port_model as M  # noqa: E402
import test_torch_port_train as T  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


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
    """One torch thread: the suite runs several test workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def device_pair():
    jmodel, _, test_cfg, _, _ = ge._build(
        n_points=2048, s_cap=M.S_CAP, i_cap=16, k2d=16, num_layers=2,
        d_model=64, n_sem=M.N_SEM, n_inst_cls=M.N_CLS, feat2d=M.FEAT2D,
        init=False)
    jspec = JC.PadSpec(2048, M.S_CAP, 16, 16, M.N_SEM)
    tspec = TC.PadSpec(2048, M.S_CAP, 16, 16, M.N_SEM)
    variables = M._seeded_variables(jmodel, JC.collate(
        [jax_scene(M.SEEDS[0], **M.SCENE)], jspec))
    # the JAX model's capacities (``__graft_entry__._build``): 2,048 voxels
    tmodel, _ = build_model(M.PORT_CFG, Capacities(num_superpoints=M.S_CAP,
                                                   num_voxels=2048),
                            device="cpu")
    load_jax_variables(tmodel, variables)
    apply = jax.jit(lambda v, b: jmodel.apply(v, b, False)[0])
    scenes = []
    for seed in M.SEEDS:
        rec, jrec = synthetic_scene(seed, **M.SCENE), jax_scene(seed, **M.SCENE)
        jb = JC.collate([jrec], jspec)
        tb = TC.collate([rec], tspec, "cpu")
        assert jb.unet_plan is None and tb.plan is None
        with torch.no_grad():
            tout = tmodel(tb)
        scenes.append(dict(rec=rec, jrec=jrec, jb=jb, tb=tb, tout=tout,
                           jout=jax.device_get(apply(variables, jb))))
    return dict(jmodel=jmodel, variables=variables, tmodel=tmodel,
                test_cfg=test_cfg, scenes=scenes)


@pytest.mark.parametrize("seed", range(len(M.SEEDS)))
def test_outputs_match_without_host_plan(device_pair, seed):
    sc = device_pair["scenes"][seed]
    for key in ("cls_preds", "masks", "sem_preds", "centers", "sizes"):
        np.testing.assert_allclose(sc["tout"][key].numpy(),
                                   np.asarray(sc["jout"][key]), **TOL,
                                   err_msg=key)


def test_ap_matches_without_host_plan(device_pair):
    dp, cfg = device_pair, device_pair["test_cfg"]
    want = jax_evaluate(
        dp["jmodel"], dp["variables"],
        [([sc["jrec"]], sc["jb"]) for sc in dp["scenes"]],
        JaxEvaluator(M.CLASS_IDS, M.CLASS_NAMES), cfg, progress=False)
    got = evaluate(dp["tmodel"], [([sc["rec"]], sc["tb"])
                                  for sc in dp["scenes"]],
                   InstanceSeg3DEvaluator(M.CLASS_IDS, M.CLASS_NAMES), cfg)
    for key in ("all_ap", "all_ap_50", "all_ap_25"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6,
                                   err_msg=key)


def test_train_step_on_device_plans_matches_host_plans():
    """The device-plan step against the JAX step frozen in
    ``test_torch_port_train.py``'s fixture (its tolerances), then against
    the port's host-plan step at the same capacities."""
    dev = T.port_step(T.initial_variables(), device_plan=True)
    T.check_against(dev, dict(np.load(T.FIXTURE, allow_pickle=True)))
    host = T.port_step(T.initial_variables())
    m_dev, m_host = ({k: float(v) for k, v in r["metrics"].items()}
                     for r in (dev, host))
    assert m_dev.keys() == m_host.keys()
    for k in m_host:
        np.testing.assert_allclose(m_dev[k], m_host[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    g_dev, g_host = (dict(r["model"].named_parameters()) for r in (dev, host))
    assert g_dev.keys() == g_host.keys()
    for n in g_host:
        torch.testing.assert_close(g_dev[n].grad, g_host[n].grad, rtol=1e-6,
                                   atol=1e-6, msg=n)
