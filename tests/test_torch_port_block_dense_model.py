"""The eval slice on hybrid plans in both packages.

The small SegDINO3D of ``test_torch_port_model.py`` (seeded weights in the
JAX tree's layout, carried into the port by ``convert.py``) on two of its
seeded scenes, with the flagship eval layout: a gather k5 stem and
block-dense convs everywhere else (``block_edges=(4,)*5, stem_gather=True``,
through ``builder.host_plan_args``).  Tolerances as there: the model
outputs ``rtol = atol = 1e-4``, AP, AP50 and AP25 of the two eval drivers
within ``1e-6``.
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

from segdino3d_tpu_torch.builder import host_plan_args  # noqa: E402

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
def _setup():
    """The JAX plan library (``test_torch_port_jaxlib.py``), and one torch
    thread: the suite runs several test workers at once."""
    load_jax_sparseplan()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def hybrid_slice():
    """The eval slice of ``test_torch_port_model.py`` (seeded weights, two
    of its scenes) on hybrid plans in both packages."""
    import __graft_entry__ as ge
    from test_torch_port_model import (N_CLS, N_SEM, PORT_CFG, S_CAP, SCENE,
                                       _seeded_variables)

    from segdino3d_tpu.data import collate as JC
    from segdino3d_tpu.data.synthetic import synthetic_scene as jax_scene
    from segdino3d_tpu_torch.builder import Capacities, build_model
    from segdino3d_tpu_torch.convert import load_jax_variables
    from segdino3d_tpu_torch.data import collate as TC
    from segdino3d_tpu_torch.data.synthetic import synthetic_scene

    cfg = dict(PORT_CFG, pointcloud_backbone_cfg=dict(
        PORT_CFG["pointcloud_backbone_cfg"], block_edges=(4,) * 5,
        stem_gather=True))
    args = host_plan_args(cfg)
    jmodel, _, test_cfg, _, _ = ge._build(
        n_points=2048, s_cap=S_CAP, i_cap=16, k2d=16, num_layers=2,
        d_model=64, n_sem=N_SEM, n_inst_cls=N_CLS, feat2d=SCENE["feat_dim_2d"],
        init=False)
    jspec = JC.PadSpec(2048, S_CAP, 16, 16, N_SEM)
    tspec = TC.PadSpec(2048, S_CAP, 16, 16, N_SEM)
    variables = _seeded_variables(jmodel, JC.collate(
        [jax_scene(0, **SCENE)], jspec))
    tmodel, _ = build_model(cfg, Capacities(num_superpoints=S_CAP),
                            device="cpu")
    load_jax_variables(tmodel, variables)
    apply = jax.jit(lambda v, b: jmodel.apply(v, b, False)[0])
    scenes = []
    for seed in (0, 1):
        rec, jrec = synthetic_scene(seed, **SCENE), jax_scene(seed, **SCENE)
        jb = JC.attach_host_plan(JC.collate([jrec], jspec), [jrec], jspec,
                                 stem_compact=False, **args)
        tb = TC.attach_host_plan(TC.collate([rec], tspec, "cpu"), [rec],
                                 tspec, **args)
        assert tb.plan.blocks[0] is not None and tb.plan.stem_nbr is not None
        with torch.no_grad():
            tout = tmodel(tb)
        scenes.append(dict(rec=rec, jrec=jrec, jb=jb, tb=tb, tout=tout,
                           jout=jax.device_get(apply(variables, jb))))
    return dict(jmodel=jmodel, variables=variables, tmodel=tmodel,
                test_cfg=test_cfg, scenes=scenes)


def test_hybrid_eval_slice_matches_jax(hybrid_slice):
    from test_torch_port_model import CLASS_IDS, CLASS_NAMES

    from segdino3d_tpu.evaluation.evaluate import evaluate as jax_evaluate
    from segdino3d_tpu.evaluation.evaluator import \
        InstanceSeg3DEvaluator as JaxEvaluator
    from segdino3d_tpu_torch.evaluation.evaluate import evaluate
    from segdino3d_tpu_torch.evaluation.evaluator import \
        InstanceSeg3DEvaluator

    sp = hybrid_slice
    for sc in sp["scenes"]:
        for key in ("cls_preds", "masks", "sem_preds", "centers", "sizes"):
            np.testing.assert_allclose(sc["tout"][key].numpy(),
                                       np.asarray(sc["jout"][key]), **TOL,
                                       err_msg=key)
    want = jax_evaluate(
        sp["jmodel"], sp["variables"],
        [([sc["jrec"]], sc["jb"]) for sc in sp["scenes"]],
        JaxEvaluator(CLASS_IDS, CLASS_NAMES), sp["test_cfg"], progress=False)
    got = evaluate(sp["tmodel"], [([sc["rec"]], sc["tb"])
                                  for sc in sp["scenes"]],
                   InstanceSeg3DEvaluator(CLASS_IDS, CLASS_NAMES),
                   sp["test_cfg"])
    for key in ("all_ap", "all_ap_50", "all_ap_25"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6,
                                   err_msg=key)
