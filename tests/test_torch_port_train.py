"""One training step of a small SegDINO3D in both packages.

The model is the flagship's at reduced size (Res16UNet34C at full width,
2 decoder layers, d_model 64, 1,024-point scenes, 64 superpoints) with the
flagship criterion (SparseMatcher top-1), AdamW 1e-4 / weight decay 0.05
under PolyLR, clipping at 10 and EMA, on two seeded synthetic scenes as
``accum_steps=2`` microbatches.  Weights are seeded in the flax tree's
layout and carried into the port by ``convert.py``.  Both packages take
one query selection (``query_thr`` 0.5's place is taken by a fixed numpy
noise and fraction; the JAX side gets it by monkeypatching
``select_queries_random``).

The JAX side (``make_train_step``) takes over a minute to compile on a
CPU, so its results are frozen in ``tests/fixtures/torch_port_train_step.npz``:
the metrics, the first microbatch's matches per decoder layer, per-leaf
norms and probes (a dot with a fixed random sign vector, as in
``test_train_frozen_numerics.py``) of the clipped gradients, per-leaf
norms of the parameter updates, and the batch-norm running statistics.
Regenerate with ``python tests/test_torch_port_train.py --regen``; the
``slow`` test runs the JAX step live.

The scenes are sparse (500 points per m^2) so that the coarsest U-Net
level keeps ~20 voxels: with the default density it keeps 4, and batch
norm over 4 rows makes the backward so ill-conditioned that a 1e-6
relative change of the weights moves a level-4 conv's gradient by 3.3%
and the global gradient norm by 2.5%; here the same change moves them by
3.6e-4 and 1.8e-4 (``python tests/test_torch_port_train.py
--conditioning``, the port on the CPU).

Tolerances, and why: losses and ``grad_norm`` ``rtol = 1e-4`` (fp32 sums
in another order); per-leaf gradient norms and probes ``rtol = 1e-3``
with ``atol = 1e-3 x`` the largest leaf norm (the conditioning above);
per-leaf update norms ``rtol = 1e-2``, except for leaves whose gradient
is rounding noise (below 1e-6 of the largest, e.g. the attention key
biases, to which the softmax is invariant: the first Adam step turns
noise into a full-size update).  The first Adam step moves each entry by
``lr * (sign(g) + wd * p)``, so an entry whose tiny gradient changes sign
between the two packages moves a 128-entry batch-norm scale's update
norm by 0.08%; 1e-2 allows about a dozen such entries.  The update
itself is held elementwise to optax's first-step formula on the port's
own clipped gradients (to 1e-4 of the update plus two fp32 roundings of
the parameter).  Batch-norm statistics ``rtol = atol = 1e-4``.  The
matches must be equal.
"""
import copy
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from segdino3d_tpu_torch.builder import (Capacities, build_criterion,  # noqa: E402
                                         build_model)
from segdino3d_tpu_torch.convert import (jax_to_state_dict,  # noqa: E402
                                         load_jax_variables,
                                         state_dict_to_jax)
from segdino3d_tpu_torch.data import collate as TC  # noqa: E402
from segdino3d_tpu_torch.data.synthetic import synthetic_scene  # noqa: E402
from segdino3d_tpu_torch.parallel.train_step import TrainStep  # noqa: E402
from segdino3d_tpu_torch.train.ema import EMA  # noqa: E402
from segdino3d_tpu_torch.train.optim import build_optimizer  # noqa: E402

FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_train_step.npz")
SEEDS = (0, 11)
N_POINTS, S_CAP, I_CAP, K2D = 1024, 64, 16, 16
N_CLS, N_SEM, FEAT2D = 18, 20, 32
VOXEL_CAP = 1024
SCENE = dict(n_points=N_POINTS, n_superpoints=S_CAP, n_classes=N_CLS,
             n_queries2d=12, feat_dim_2d=FEAT2D, point_density=500.0)
OPT = dict(lr=1e-4, weight_decay=0.05)
SCHED = dict(total_iters=300 * 129, power=0.9)
CLIP, EMA_DECAY = 10.0, 0.9997
QUERY_NOISE = np.random.RandomState(5).rand(S_CAP).astype(np.float32)
QUERY_FRAC = np.float32(0.8)
COSTS = [dict(type="QueryClassificationCost", weight=0.5),
         dict(type="MaskBCECost", weight=1.0),
         dict(type="MaskDiceCost", weight=1.0),
         dict(type="CenterL1Cost", weight=0.5),
         dict(type="SizeL1Cost", weight=0.5)]
PORT_CFG = dict(
    type="SegDINO3D", query_thr=0.5, mode_3d_center="median",
    pointcloud_backbone_cfg=dict(
        type="Res16UNet34C", in_channels=FEAT2D + 3, out_channels=96,
        voxel_size=0.02, config=dict(conv1_kernel_size=5, bn_momentum=0.02)),
    decoder_cfg=dict(num_layers=2, num_instance_classes=N_CLS,
                     num_semantic_classes=N_SEM, in_channels=96, d_model=64,
                     num_heads=8, hidden_dim=1024, temperature=20,
                     dropout=0.0),
    criterion_cfg=dict(
        type="ScanNetUnifiedCriterion", num_semantic_classes=N_SEM,
        sem_criterion=dict(type="ScanNetSemanticCriterion",
                           ignore_index=N_SEM, loss_weight=0.5),
        inst_criterion=dict(
            type="InstanceCriterion",
            matcher=dict(type="SparseMatcher", topk=1, costs=COSTS),
            loss_weight=[0.5, 1.0, 1.0, 0.5, 0.5, 0.5], num_classes=N_CLS,
            non_object_weight=0.1, fix_dice_loss_weight=True,
            iter_matcher=True, fix_mean_loss=True)))
LOSS_RTOL = 1e-4
LEAF_RTOL = 1e-3
UPDATE_RTOL = 1e-2
STATS_TOL = dict(rtol=1e-4, atol=1e-4)


def numpy_selection(num_superpoints):
    """(q_idx, q_valid) per scene: the valid superpoints ordered by a fixed
    noise, the first floor(QUERY_FRAC * n_valid) of them valid."""
    n = np.asarray(num_superpoints)
    valid = np.arange(S_CAP)[None, :] < n[:, None]
    noise = np.where(valid, QUERY_NOISE[None, :], np.float32(2.0))
    order = np.argsort(noise, axis=-1, kind="stable").astype(np.int32)
    n_sel = np.floor(QUERY_FRAC * n.astype(np.float32)).astype(np.int32)
    return order, np.arange(S_CAP)[None, :] < n_sel[:, None]


def leaf_hash(named):
    """(names, norms, probes) of {name: array}, names sorted."""
    names = sorted(named)
    norms, probes = [], []
    for i, n in enumerate(names):
        g = np.asarray(named[n], np.float64).reshape(-1)
        sign = np.where(np.random.RandomState(1000 + i).rand(g.size) < 0.5,
                        -1.0, 1.0)
        norms.append(np.sqrt((g * g).sum()))
        probes.append((g * sign).sum())
    return names, np.array(norms), np.array(probes)


def records(point_density=SCENE["point_density"]):
    return [synthetic_scene(s, **dict(SCENE, point_density=point_density))
            for s in SEEDS]


def initial_variables(seed=0, cfg=PORT_CFG):
    """Seeded variables in the flax tree's layout of ``cfg``'s model, drawn
    with numpy in the flax tree's leaf order (sorted keys, depth first):
    fan-in scaled kernels, small biases and means, positive variances."""
    model, _ = build_model(cfg, Capacities(num_superpoints=S_CAP),
                           device="cpu")
    rng = np.random.RandomState(seed)

    def draw(name, shape):
        x = rng.randn(*shape).astype(np.float32)
        if name == "kernel":
            return x / np.sqrt(np.prod(shape[:-1]))
        if name == "var":
            return np.abs(x) + 0.5
        if name == "scale":
            return 1.0 + 0.1 * x
        return 0.1 * x                         # bias, mean

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else draw(k, v.shape)
                for k, v in sorted(node.items())}

    return walk(state_dict_to_jax(model.state_dict()))


# --------------------------------------------------------------------------
# the JAX side
# --------------------------------------------------------------------------

def jax_reference():
    """The JAX package's step on the two microbatches, from
    ``initial_variables()`` -> a dict of numpy arrays (the fixture's
    contents)."""
    import __graft_entry__ as ge
    from segdino3d_tpu.data import collate as JC
    from test_torch_port_jaxlib import load_jax_sparseplan

    load_jax_sparseplan()
    jmodel, jcrit, _, _, _ = ge._build(
        n_points=N_POINTS, s_cap=S_CAP, i_cap=I_CAP, k2d=K2D, num_layers=2,
        d_model=64, n_sem=N_SEM, n_inst_cls=N_CLS, feat2d=FEAT2D, init=False)
    spec = JC.PadSpec(N_POINTS, S_CAP, I_CAP, K2D, N_SEM)
    mbs = [JC.attach_host_plan(JC.collate([r], spec), [r], spec,
                               voxel_size=0.02, voxel_cap=VOXEL_CAP,
                               stem_compact=False) for r in records()]
    return jax_step(jmodel, jcrit, mbs, initial_variables())


def jax_step(jmodel, jcrit, mbs, variables, mesh=None, accum_steps=2):
    """The JAX package's ``accum_steps`` step of ``jmodel`` and ``jcrit``
    on the microbatches ``mbs``, from ``variables``, with this file's query
    selection, optimizer and EMA -> the fixture's contents.  With a
    ``mesh`` the step is the ``shard_map`` one over its devices, ``mbs``
    stacked device-major (``accum_steps`` a device)."""
    import jax
    import jax.numpy as jnp
    import optax

    from segdino3d_tpu.data import collate as JC
    from segdino3d_tpu.models.architecture import segdino3d as JA
    from segdino3d_tpu.parallel.train_step import (create_train_state,
                                                   make_train_step)
    from segdino3d_tpu.train.optim import build_optimizer as jax_optimizer

    def select(rng, sp_valid, query_thr):
        del rng, query_thr
        s = sp_valid.shape[1]
        noise = jnp.where(sp_valid, jnp.asarray(QUERY_NOISE)[None, :s], 2.0)
        order = jnp.argsort(noise, axis=-1).astype(jnp.int32)
        n_sel = jnp.floor(QUERY_FRAC * sp_valid.sum(-1).astype(jnp.float32)
                          ).astype(jnp.int32)
        return order, jnp.arange(s)[None, :] < n_sel[:, None]

    tx, _ = jax_optimizer(OPT, SCHED, clip_max_norm=CLIP)
    state = create_train_state(variables, tx, use_ema=True)
    patched = JA.select_queries_random
    JA.select_queries_random = select
    try:
        step = make_train_step(jmodel, jcrit, tx, ema_decay=EMA_DECAY,
                               donate=False, accum_steps=accum_steps,
                               mesh=mesh, stacked_batch=mesh is not None)
        new, metrics = step(state, JC.stack_batches(mbs),
                            jax.random.PRNGKey(3))
        outputs, gt = jax.jit(lambda v, b: jmodel.apply(
            v, b, True, rngs={"queries": jax.random.PRNGKey(0)},
            mutable=["batch_stats"])[0])(variables, mbs[0])
    finally:
        JA.select_queries_random = patched
    ic = jcrit.inst_criterion
    layers = [{k: outputs[k] for k in ("cls_preds", "masks", "scores",
                                       "centers", "sizes")}]
    layers += [dict(a, scores=None) for a in outputs["aux_outputs"]]
    matches = [ic._match_batch(layer, gt) for layer in layers]

    adam = [s for s in jax.tree_util.tree_leaves(
        new.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    # the first Adam moment is (1 - b1) * the clipped gradient
    clipped = jax.tree_util.tree_map(lambda m: np.asarray(m) / np.float32(0.1),
                                     adam.mu)
    delta = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b),
                                   new.params, variables["params"])
    g_names, g_norms, g_probes = leaf_hash(
        {k: v.numpy() for k, v in jax_to_state_dict(
            {"params": clipped}).items()})
    d_names, d_norms, _ = leaf_hash(
        {k: v.numpy() for k, v in jax_to_state_dict(
            {"params": delta}).items()})
    stats = {k: v.numpy() for k, v in jax_to_state_dict(
        {"batch_stats": jax.device_get(new.batch_stats)}).items()}
    out = dict(
        metrics=np.array({k: float(v) for k, v in metrics.items()},
                         dtype=object),
        grad_names=np.array(g_names), grad_norms=g_norms,
        grad_probes=g_probes, delta_names=np.array(d_names),
        delta_norms=d_norms,
        stat_names=np.array(sorted(stats)),
        stats=np.array([stats[k] for k in sorted(stats)], dtype=object),
        match_q=np.array([np.asarray(m.pair_q) for m in matches]),
        match_valid=np.array([np.asarray(m.pair_valid) for m in matches]))
    return out


def regen():
    import time

    import jax

    jax.config.update("jax_platforms", "cpu")
    t0 = time.perf_counter()
    out = jax_reference()
    np.savez_compressed(FIXTURE, **out)
    print(f"wrote {FIXTURE} in {time.perf_counter() - t0:.0f} s: metrics "
          f"{out['metrics'].item()}")


# --------------------------------------------------------------------------
# the port's side
# --------------------------------------------------------------------------

def port_step(variables, recs=None, device_plan=False, layout=None,
              cfg=PORT_CFG, generator=None, process_group=None):
    """The port's step of ``cfg``'s model on one microbatch per record
    (``recs``, default the two of ``records()``), from ``variables``; with
    ``device_plan`` the microbatches carry no host plan and the backbone
    builds theirs on the device, at the host plan's capacities.
    ``layout`` adds or overrides host-plan arguments
    (``attach_host_plan``); ``generator`` goes to the step (it draws the
    decoder's dropout masks), and so does ``process_group``."""
    caps = Capacities(num_superpoints=S_CAP, num_voxels=VOXEL_CAP)
    model, _ = build_model(cfg, caps, device="cpu", train=True)
    load_jax_variables(model, variables)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    spec = TC.PadSpec(N_POINTS, S_CAP, I_CAP, K2D, N_SEM)
    recs = recs or records()
    mbs = [TC.collate([r], spec, "cpu") for r in recs]
    if not device_plan:
        args = dict(dict(voxel_size=0.02, voxel_cap=VOXEL_CAP,
                         level_cap_ratios=caps.level_cap_ratios),
                    **(layout or {}))
        mbs = [TC.attach_host_plan(mb, [r], spec, **args)
               for mb, r in zip(mbs, recs)]
    queries = [tuple(torch.from_numpy(a) for a in
                     numpy_selection(mb.num_superpoints.numpy()))
               for mb in mbs]
    # matches of the first microbatch, on a copy (a training forward moves
    # the batch-norm statistics)
    probe = copy.deepcopy(model)
    crit = build_criterion(cfg)
    with torch.no_grad():
        outputs, gt = probe(mbs[0], queries[0])
    ic = crit.inst_criterion
    matches = [ic.match(layer, gt)
               for layer in [outputs] + outputs["aux_outputs"]]

    opt = build_optimizer(model.named_parameters(), OPT, SCHED,
                          clip_max_norm=CLIP)
    ema = EMA(model.named_parameters(), EMA_DECAY)
    step = TrainStep(model, crit, opt, ema, accum_steps=len(mbs),
                     process_group=process_group)
    metrics = step(mbs, queries, generator)
    return dict(model=model, before=before, metrics=metrics,
                matches=matches, ema=ema, batches=mbs)


def check_against(port, ref):
    """Assert the port's step agrees with the JAX results ``ref``."""
    want = ref["metrics"].item()
    got = {k: float(v) for k, v in port["metrics"].items()}
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL,
                                   err_msg=k)

    for i, m in enumerate(port["matches"]):
        valid = m.pair_valid.numpy()
        np.testing.assert_array_equal(valid, ref["match_valid"][i])
        np.testing.assert_array_equal(m.pair_q.numpy()[valid],
                                      ref["match_q"][i][valid])
        assert valid.any()

    model = port["model"]
    params = dict(model.named_parameters())
    names, norms, probes = leaf_hash({n: p.grad.numpy()
                                      for n, p in params.items()})
    assert names == list(ref["grad_names"])
    ref_norms = ref["grad_norms"]
    scale = float(ref_norms.max())
    for i, n in enumerate(names):
        for got_v, want_v, what in ((norms[i], ref_norms[i], "norm"),
                                    (probes[i], ref["grad_probes"][i],
                                     "probe")):
            np.testing.assert_allclose(got_v, want_v, rtol=LEAF_RTOL,
                                       atol=LEAF_RTOL * scale,
                                       err_msg=f"grad {what} {n}")

    deltas = {n: (p.detach() - port["before"][n]) for n, p in params.items()}
    d_names, d_norms, _ = leaf_hash({n: d.numpy() for n, d in deltas.items()})
    assert d_names == list(ref["delta_names"]) == names
    for i, n in enumerate(names):
        if ref_norms[i] >= 1e-6 * scale:
            np.testing.assert_allclose(d_norms[i], ref["delta_norms"][i],
                                       rtol=UPDATE_RTOL,
                                       err_msg=f"update norm {n}")
    # optax's first step: mu_hat = g, nu_hat = g^2 on the clipped g
    lr = OPT["lr"]
    for n, p in params.items():
        g = p.grad
        want = -lr * (g / (g.abs() + 1e-8)
                      + OPT["weight_decay"] * port["before"][n])
        # the update's own rounding, and two fp32 roundings of p
        allowed = 1e-4 * want.abs() + 2.4e-7 * port["before"][n].abs()
        assert bool(((deltas[n] - want).abs() <= allowed).all()), n

    buffers = dict(model.named_buffers())
    for name, stat in zip(ref["stat_names"], ref["stats"], strict=True):
        np.testing.assert_allclose(buffers[name].numpy(), stat,
                                   err_msg=name, **STATS_TOL)

    # EMA after one step: decay * before + (1 - decay) * after
    for n, p in params.items():
        torch.testing.assert_close(
            port["ema"].shadow[n],
            EMA_DECAY * port["before"][n] + (1 - EMA_DECAY) * p.detach(),
            rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs several test workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frozen():
    assert os.path.exists(FIXTURE), "fixture missing: run --regen"
    return dict(np.load(FIXTURE, allow_pickle=True))


def test_train_step_matches_frozen_jax_step(frozen):
    check_against(port_step(initial_variables()), frozen)


def test_train_step_on_block_dense_plans_matches_frozen_jax_step(frozen):
    """The flagship training layout (``block_edges_train``: every level
    block-dense, the k5 stem too) computes the same step, held to the same
    frozen JAX step at the same tolerances."""
    from segdino3d_tpu_torch.builder import host_plan_args

    cfg = dict(PORT_CFG, pointcloud_backbone_cfg=dict(
        PORT_CFG["pointcloud_backbone_cfg"], block_edges_train=(4,) * 5))
    layout = host_plan_args(cfg, train=True)
    port = port_step(initial_variables(),
                     layout=dict(block_edges=layout["block_edges"]))
    for mb in port["batches"]:
        assert all(t is not None for t in mb.plan.blocks)
        assert mb.plan.stem_nbr is None
    check_against(port, frozen)


def test_random_query_selection():
    """Valid superpoints first, in a random order, and between
    ``query_thr`` and all of them selected."""
    from segdino3d_tpu_torch.models.architecture.segdino3d import \
        select_queries_random

    n_valid = torch.tensor([10, 7, 1])
    sp_valid = torch.arange(12)[None, :] < n_valid[:, None]
    gen = torch.Generator().manual_seed(0)
    orders = []
    for _ in range(4):
        q_idx, q_valid = select_queries_random(sp_valid, 0.5, gen)
        for b in range(3):
            n = int(n_valid[b])
            assert sorted(q_idx[b].tolist()) == list(range(12))
            assert sorted(q_idx[b, :n].tolist()) == list(range(n))
            k = int(q_valid[b].sum())
            assert n // 2 <= k <= n and bool(q_valid[b, :k].all())
        orders.append(q_idx[0, :10].tolist())
    assert len({tuple(o) for o in orders}) > 1


def test_builder_training_mode_and_refusals():
    caps = Capacities(num_superpoints=S_CAP)
    model, _ = build_model(PORT_CFG, caps, device="cpu", train=True)
    assert model.training and model.backbone.unet.bn0.training
    assert model.backbone.unet.block4[0].norm1.momentum == 0.02
    assert not build_model(PORT_CFG, caps, device="cpu")[0].training
    crit = build_criterion(PORT_CFG)
    assert crit.inst_criterion.matcher.topk == 1
    # top-k queries and decoder dropout in training are built; the
    # combinations the JAX decoder rejects raise, as an unknown key does
    assert build_model(dict(PORT_CFG, query_num=100), caps,
                       device="cpu")[0].query_num == 100
    dropped, _ = build_model(dict(PORT_CFG, decoder_cfg=dict(
        PORT_CFG["decoder_cfg"], dropout=0.1)), caps, device="cpu",
        train=True)
    assert dropped.decoder.ffn[0].dropout == 0.1
    for bad in (dict(iter_pred=False), dict(num_instance_queries=4)):
        with pytest.raises(ValueError):
            build_model(dict(PORT_CFG, decoder_cfg=dict(
                PORT_CFG["decoder_cfg"], **bad)), caps, device="cpu")
    with pytest.raises(KeyError, match="unknown decoder option"):
        build_model(dict(PORT_CFG, decoder_cfg=dict(
            PORT_CFG["decoder_cfg"], no_such_option=1)), caps, device="cpu")
    step = TrainStep(model, crit, build_optimizer(
        model.named_parameters(), OPT, SCHED, CLIP), accum_steps=2)
    with pytest.raises(ValueError, match="accum_steps=2"):
        step([None])


@pytest.mark.slow
def test_train_step_matches_live_jax_step():
    check_against(port_step(initial_variables()), jax_reference())


def conditioning():
    """How far the port's own gradients move when every weight moves by a
    relative 1e-6, at the default point density (3,500 per m^2) and at the
    test's (CPU): the reason the test uses sparse scenes."""
    rng = np.random.RandomState(0)

    def perturb(node):
        return {k: perturb(v) if isinstance(v, dict) else
                (v * (1 + 1e-6 * rng.randn(*v.shape))).astype(np.float32)
                for k, v in node.items()}

    v0 = initial_variables()
    v1 = perturb(v0)
    for density in (3500.0, SCENE["point_density"]):
        recs = records(density)
        spec = TC.PadSpec(N_POINTS, S_CAP, I_CAP, K2D, N_SEM)
        plan = TC.attach_host_plan(TC.collate(recs[:1], spec, "cpu"),
                                   recs[:1], spec, voxel_size=0.02,
                                   voxel_cap=VOXEL_CAP).plan
        norms = []
        for v in (v0, v1):
            port = port_step(v, recs)
            gn = float(port["metrics"]["grad_norm"])
            # the clipped gradient times the clip factor: the raw gradient
            g = port["model"].backbone.unet.block4[0].conv1.kernel.grad
            norms.append((gn, float(g.norm()) * gn / CLIP))
        (g0, d0), (g1, d1) = norms
        print(f"{density:g} points/m^2, voxels per level "
              f"{[int(lv.valid.sum()) for lv in plan.levels]}: grad_norm "
              f"moves by {abs(g1 - g0) / g0:.2e}, block4.0.conv1's gradient "
              f"norm by {abs(d1 - d0) / d0:.2e}")


if __name__ == "__main__":
    if "--regen" in sys.argv:
        regen()
    elif "--conditioning" in sys.argv:
        conditioning()
    else:
        print(__doc__)
