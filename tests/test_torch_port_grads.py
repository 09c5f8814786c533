"""Backward passes of the port's autograd Functions, BN training mode, the
criterion, the optimizer and the EMA, against the JAX package (CPU).

Inputs and cotangents are made with numpy from a seed and fed to both
packages.  Tolerances, and why:

* convolution and pooling gradients: ``rtol = atol = 1e-4`` (fp32; the
  same products summed in another order over up to 125 offsets);
* ``gradcheck`` in float64 against finite differences of the plain forward
  (``eps`` 1e-6, ``atol`` 1e-5, ``rtol`` 1e-3, torch's defaults);
* batch norm and the criterion's losses and gradients: ``1e-5`` (one
  reduction over a few hundred rows);
* optimizer and EMA: ``rtol = 1e-6`` on the parameters after 3 steps (the
  same elementwise formulas; ``atol`` 1e-8 for entries near zero).
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from segdino3d_tpu.models import layers as JL
from segdino3d_tpu.models.criterion import losses as JLoss
from segdino3d_tpu.ops import scatter as JS
from segdino3d_tpu.ops import sparse_conv as JSC
from segdino3d_tpu.ops.host_plan import build_host_plan as jax_build_host_plan
from segdino3d_tpu.ops.host_plan import host_plan_to_device
from segdino3d_tpu.ops.voxelize import devoxelize as jax_devoxelize
from segdino3d_tpu.train import ema as JEMA
from segdino3d_tpu.train import optim as JO
from segdino3d_tpu_torch.models.criterion import losses as TLoss
from segdino3d_tpu_torch.models.layers import MaskedBatchNorm
from segdino3d_tpu_torch.ops import host_plan as TH
from segdino3d_tpu_torch.ops import scatter as TS
from segdino3d_tpu_torch.ops import sparse_conv as TSC
from segdino3d_tpu_torch.train.ema import EMA
from segdino3d_tpu_torch.train.optim import build_optimizer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_jaxlib import load_jax_sparseplan  # noqa: E402
from test_torch_port_ops import _one_torch_thread, plans  # noqa: E402,F401

CONV_TOL = dict(rtol=1e-4, atol=1e-4)
TIGHT_TOL = dict(rtol=1e-5, atol=1e-5)
# level caps that the 600-point scene overflows from level 1 down: the
# plans drop the links past each cap (parent -1)
OVERFLOW_CAPS = [512, 96, 48, 24, 16]


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               err_msg=msg, **tol)


def _t(a, requires_grad=False):
    return torch.tensor(np.asarray(a), requires_grad=requires_grad)


@pytest.fixture(scope="module")
def overflow_plans():
    rng = np.random.RandomState(3)
    coords = rng.uniform(0, 12, (600, 3)).astype(np.float32)
    bidx, valid = np.zeros(600, np.int32), np.ones(600, bool)
    load_jax_sparseplan()
    jhost = jax_build_host_plan(coords, bidx, valid, OVERFLOW_CAPS,
                                stem_compact=False)
    thost = TH.build_host_plan(coords, bidx, valid, OVERFLOW_CAPS)
    assert jhost.overflow and thost.overflow
    jplan, _ = host_plan_to_device(jhost, device=False)
    return jplan, TH.host_plan_to_device(thost, "cpu")


def _conv_case(case, jplan, tplan, rng):
    """(jax fn of (x, w), port fn of (x, w), x, w, cotangent)."""
    if case.startswith("subm"):
        k5 = case == "subm_k5_matmul_first"
        lvl = 0 if k5 else 1
        nbr_j = jplan.stem_nbr if k5 else jplan.subm_nbr[1]
        nbr_t = tplan.stem_nbr if k5 else tplan.levels[1].nbr
        valid_j, valid_t = jplan.levels[lvl].valid, tplan.levels[lvl].valid
        cin, cout = (35, 8) if k5 else (16, 24)   # 35 > 2 * 8: matmul-first
        v_in = v_out = nbr_t.shape[1]
        jf = lambda x, w: JSC.subm_conv(x, jnp.asarray(nbr_j), w,
                                        jnp.asarray(valid_j))
        tf = lambda x, w: TSC.subm_conv(x, nbr_t, w, valid_t)
        n_off = nbr_t.shape[0]
    elif case.startswith("down"):
        cin, cout, n_off = 12, 20, 8
        v_in = tplan.levels[1].valid.shape[0]
        v_out = tplan.levels[2].valid.shape[0]
        jf = lambda x, w: JSC.down_conv(x, jplan.levels[1], jplan.levels[2], w)
        tf = lambda x, w: TSC.down_conv(x, tplan.levels[1], tplan.levels[2], w)
    else:
        cin, cout, n_off = 12, 20, 8
        v_in = tplan.levels[2].valid.shape[0]
        v_out = tplan.levels[1].valid.shape[0]
        jf = lambda x, w: JSC.up_conv(x, jplan.levels[1], w)
        tf = lambda x, w: TSC.up_conv(x, tplan.levels[1], w)
    x = rng.randn(v_in, cin).astype(np.float32)
    w = (rng.randn(n_off, cin, cout) / np.sqrt(cin)).astype(np.float32)
    dy = rng.randn(v_out, cout).astype(np.float32)
    return jf, tf, x, w, dy


@pytest.mark.parametrize("case", ["subm_k3", "subm_k5_matmul_first",
                                  "down_child_table", "up",
                                  "down_overflow", "up_overflow"])
def test_conv_backward_matches_jax(plans, overflow_plans, case):
    jplan, tplan = overflow_plans if case.endswith("overflow") else plans
    rng = np.random.RandomState(sum(map(ord, case)))
    jf, tf, x, w, dy = _conv_case(case, jplan, tplan, rng)
    _, vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(dy))
    tx, tw = _t(x, True), _t(w, True)
    tf(tx, tw).backward(_t(dy))
    assert float(np.abs(np.asarray(want_dx)).max()) > 0
    _close(tx.grad, want_dx, CONV_TOL, "dX")
    _close(tw.grad, want_dw, CONV_TOL, "dW")


def test_stem_needs_no_input_gradient(plans, monkeypatch):
    """The stem's input is data: its backward computes dW only."""
    _, tplan = plans
    x = torch.randn(tplan.stem_nbr.shape[1], 35)
    w = torch.randn(125, 35, 8, requires_grad=True)
    plain, seen = TSC.gather_conv_plain, []
    monkeypatch.setattr(TSC, "gather_conv_plain",
                        lambda *a: seen.append(1) or plain(*a))
    TSC.subm_conv(x, tplan.stem_nbr, w, tplan.levels[0].valid).sum() \
        .backward()
    assert len(seen) == 1 and w.grad is not None   # the forward only


def _pool_inputs(seed=5, n=500, s=40, v=60):
    rng = np.random.RandomState(seed)
    seg = rng.randint(0, s + 3, n).astype(np.int32)   # ids >= s dropped
    valid = rng.rand(n) > 0.2
    inverse = rng.randint(-1, v, n).astype(np.int32)
    vox = rng.randn(v, 9).astype(np.float32)
    q = [rng.randn(n, 3).astype(np.float32) for _ in range(2)]
    dys = [rng.randn(s, c).astype(np.float32) for c in (9, 3, 3)]
    return seg, valid, inverse, vox, q, dys, s


@pytest.mark.parametrize("with_csr", [False, True])
def test_pool_backward_matches_jax(with_csr):
    seg, valid, inverse, vox, q, dys, s = _pool_inputs()

    def jf(vx):
        pt = jax_devoxelize(vx, jnp.asarray(inverse), jnp.asarray(valid))
        return JS.segment_mean_stack([pt] + [jnp.asarray(a) for a in q],
                                     jnp.asarray(seg), s, jnp.asarray(valid))

    _, vjp = jax.vjp(jf, jnp.asarray(vox))
    (want,) = vjp([jnp.asarray(d) for d in dys])
    tvox = _t(vox, True)
    t = torch.from_numpy
    csr = None
    if with_csr:
        v = vox.shape[0]
        csr = TS.segment_csr(t(inverse), v, t(valid))
    outs = TS.pool_gathered(tvox, t(inverse), [t(a) for a in q], t(seg), s,
                            t(valid), vox_csr=csr)
    torch.autograd.backward(outs, [t(d) for d in dys])
    _close(tvox.grad, want, TIGHT_TOL)


def test_pool_rejects_gradients_it_does_not_give():
    seg, valid, inverse, vox, q, _, s = _pool_inputs()
    t = torch.from_numpy
    with pytest.raises(RuntimeError, match="only the voxel features"):
        TS.pool_gathered(t(vox), t(inverse), [_t(q[0], True)], t(seg), s,
                         t(valid))
    with pytest.raises(RuntimeError, match="no gradient"):
        TS.segment_mean(_t(q[0], True), t(seg), s, t(valid))


@pytest.fixture(scope="module")
def tiny_plan():
    """A plan small enough for finite differences."""
    rng = np.random.RandomState(4)
    coords = rng.uniform(0, 4, (40, 3)).astype(np.float32)
    plan = TH.build_host_plan(coords, np.zeros(40, np.int32),
                              np.ones(40, bool), [64, 32, 16, 8, 8])
    return TH.host_plan_to_device(plan, "cpu")


@pytest.mark.parametrize("case", ["subm_k3", "subm_k5", "down", "up",
                                  "pool"])
def test_gradcheck_float64(tiny_plan, case):
    lv = tiny_plan.levels
    gen = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float64,
                           requires_grad=True)

    if case == "subm_k3":
        args = (rnd(64, 3), rnd(27, 3, 2))
        fn = lambda x, w: TSC.subm_conv(x, lv[0].nbr, w, lv[0].valid)
    elif case == "subm_k5":
        args = (rnd(64, 3), rnd(125, 3, 1))
        fn = lambda x, w: TSC.subm_conv(x, tiny_plan.stem_nbr, w, lv[0].valid)
    elif case == "down":
        args = (rnd(64, 3), rnd(8, 3, 2))
        fn = lambda x, w: TSC.down_conv(x, lv[0], lv[1], w)
    elif case == "up":
        args = (rnd(32, 3), rnd(8, 3, 2))
        fn = lambda x, w: TSC.up_conv(x, lv[0], w)
    else:
        inverse = tiny_plan.inverse
        n = inverse.shape[0]
        seg = torch.arange(n, dtype=torch.int32) % 7
        valid = torch.arange(n) % 5 != 0
        q = torch.randn(n, 3, generator=gen, dtype=torch.float64)
        args = (rnd(64, 4),)
        fn = lambda vx: TS.pool_gathered(vx, inverse, [q], seg, 7, valid)[0]
    assert torch.autograd.gradcheck(fn, args, eps=1e-6, atol=1e-5)


# --------------------------------------------------------------------------
# batch norm, training mode
# --------------------------------------------------------------------------

def test_batch_norm_training_matches_jax():
    rng = np.random.RandomState(2)
    n, c, m = 300, 16, 0.02
    x = (rng.randn(n, c) * 2 + 0.5).astype(np.float32)
    valid = rng.rand(n) > 0.3
    scale = (1 + 0.1 * rng.randn(c)).astype(np.float32)
    bias = (0.1 * rng.randn(c)).astype(np.float32)
    stats = {"mean": (0.1 * rng.randn(c)).astype(np.float32),
             "var": (0.5 + np.abs(rng.randn(c))).astype(np.float32)}
    dy = rng.randn(n, c).astype(np.float32)

    jbn = JL.MaskedBatchNorm(momentum=m)

    def jf(xx, sc, bi):
        return jbn.apply({"params": {"scale": sc, "bias": bi},
                          "batch_stats": stats}, xx, jnp.asarray(valid),
                         use_running_average=False, mutable=["batch_stats"])

    jy, jstats = jf(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    _, vjp = jax.vjp(lambda *a: jf(*a)[0], jnp.asarray(x), jnp.asarray(scale),
                     jnp.asarray(bias))
    want_dx, want_dscale, want_dbias = vjp(jnp.asarray(dy))

    bn = MaskedBatchNorm(c, momentum=m).train()
    with torch.no_grad():
        bn.weight.copy_(_t(scale))
        bn.bias.copy_(_t(bias))
        bn.running_mean.copy_(_t(stats["mean"]))
        bn.running_var.copy_(_t(stats["var"]))
    tx = _t(x, True)
    ty = bn(tx, _t(valid))
    ty.backward(_t(dy))
    _close(ty, jy, TIGHT_TOL, "output")
    _close(bn.running_mean, jstats["batch_stats"]["mean"], TIGHT_TOL, "mean")
    _close(bn.running_var, jstats["batch_stats"]["var"], TIGHT_TOL, "var")
    _close(tx.grad, want_dx, TIGHT_TOL, "dX")
    _close(bn.weight.grad, want_dscale, TIGHT_TOL, "dscale")
    _close(bn.bias.grad, want_dbias, TIGHT_TOL, "dbias")
    assert float(ty.detach()[~_t(valid)].abs().max()) == 0.0


# --------------------------------------------------------------------------
# criterion
# --------------------------------------------------------------------------

N_CLS, N_SEM = 6, 8
COSTS = [dict(type="QueryClassificationCost", weight=0.5),
         dict(type="MaskBCECost", weight=1.0),
         dict(type="MaskDiceCost", weight=1.0),
         dict(type="CenterL1Cost", weight=0.5),
         dict(type="SizeL1Cost", weight=0.5)]


def _criterion_cfg(matcher):
    m = dict(type="SparseMatcher", topk=1, costs=COSTS) \
        if matcher == "sparse" else dict(type="HungarianMatcher", costs=COSTS)
    return dict(
        num_semantic_classes=N_SEM,
        sem_criterion=dict(type="ScanNetSemanticCriterion",
                           ignore_index=N_SEM, loss_weight=0.5),
        inst_criterion=dict(
            type="InstanceCriterion", matcher=m,
            loss_weight=[0.5, 1.0, 1.0, 0.5, 0.5, 0.5], num_classes=N_CLS,
            non_object_weight=0.1, fix_dice_loss_weight=True,
            iter_matcher=True, fix_mean_loss=True))


def _criterion_inputs(seed, b=2, q=20, s=30, g=5):
    """Decoder outputs of 3 layers (the first without boxes, as the
    decoder's first head) and the training forward's targets."""
    rng = np.random.RandomState(seed)
    f32 = lambda *shape: rng.randn(*shape).astype(np.float32)

    def layer(boxes):
        return dict(cls_preds=f32(b, q, N_CLS + 1), masks=2 * f32(b, q, s),
                    centers=f32(b, q, 3) if boxes else None,
                    sizes=np.abs(f32(b, q, 3)) if boxes else None)

    pred = layer(True)
    pred["sem_preds"] = f32(b, q, N_SEM + 1)
    pred["aux_outputs"] = [layer(False), layer(True)]
    sp_valid = np.arange(s)[None, :] < np.array([s, s - 6])[:, None]
    n_g = np.array([g, g - 2])
    gt_valid = np.arange(g)[None, :] < n_g[:, None]
    query_valid = np.arange(q)[None, :] < np.array([q, q - 4])[:, None]
    gt = dict(
        labels=rng.randint(0, N_CLS, (b, g)).astype(np.int32),
        gt_valid=gt_valid,
        sp_masks=(rng.rand(b, g, s) > 0.6) & sp_valid[:, None, :],
        query_masks=(rng.rand(b, g, q) > 0.4),
        centers=f32(b, g, 3), sizes=np.abs(f32(b, g, 3)),
        query_valid=query_valid, sp_valid=sp_valid,
        query_sem_targets=rng.randint(0, N_SEM + 1, (b, q)).astype(np.int32))
    return pred, gt


_DIFF_KEYS = ("cls_preds", "masks", "centers", "sizes", "sem_preds")


def _jax_pred(pred_np, arrays):
    """The JAX criterion's pred dict with the differentiable leaves taken
    from ``arrays`` (same nesting as ``pred_np``)."""
    def layer(src, dst):
        out = {k: dst.get(k) for k in _DIFF_KEYS if k in src}
        out["scores"] = None
        return out
    p = layer(pred_np, arrays)
    p["aux_outputs"] = [layer(s, d) for s, d in
                        zip(pred_np["aux_outputs"], arrays["aux_outputs"])]
    return p


def _leaves(pred):
    """(path, value) of the differentiable arrays of a pred dict."""
    out = [(k, pred[k]) for k in _DIFF_KEYS if pred.get(k) is not None]
    for i, layer in enumerate(pred["aux_outputs"]):
        out += [(f"aux{i}.{k}", layer[k]) for k in _DIFF_KEYS
                if layer.get(k) is not None]
    return out


@pytest.mark.parametrize("matcher", ["sparse", "hungarian"])
@pytest.mark.parametrize("seed", [0, 1])
def test_criterion_matches_jax(matcher, seed):
    pred_np, gt_np = _criterion_inputs(seed)
    cfg = _criterion_cfg(matcher)
    jcrit = JLoss.ScanNetUnifiedCriterion(**cfg)
    tcrit = TLoss.ScanNetUnifiedCriterion(**cfg)
    jgt = {k: jnp.asarray(v) for k, v in gt_np.items()}
    tgt = {k: torch.from_numpy(np.asarray(v)) for k, v in gt_np.items()}

    arrays = jax.tree_util.tree_map(jnp.asarray, pred_np)
    jpred = _jax_pred(pred_np, arrays)
    want_losses = jcrit(jpred, jgt)
    if matcher == "sparse":
        want_grads = jax.grad(lambda a: sum(jcrit(_jax_pred(pred_np, a),
                                                  jgt).values()))(arrays)
    else:
        # the JAX Hungarian matcher is a host callback with no JVP: take
        # its matches once, then differentiate the losses at them
        jic = jcrit.inst_criterion
        layers = [jpred] + jpred["aux_outputs"]
        matches = [jic._match_batch(layer, jgt) for layer in layers]

        def total(a):
            p = _jax_pred(pred_np, a)
            inst = sum(jic._layer_loss(layer, jgt, m, aux=i > 0)
                       for i, (layer, m) in enumerate(
                           zip([p] + p["aux_outputs"], matches)))
            return inst + jcrit.sem_criterion(
                p["sem_preds"], jgt["query_sem_targets"], jgt["query_valid"])

        want_grads = jax.grad(total)(arrays)

    tpred = jax.tree_util.tree_map(lambda a: _t(a, True), pred_np)
    losses = tcrit(tpred, tgt)
    sum(losses.values()).backward()
    for k in ("seg_loss", "inst_loss"):
        _close(losses[k], want_losses[k], TIGHT_TOL, k)
    for (path, got), (_, want) in zip(_leaves(tpred), _leaves(want_grads),
                                      strict=True):
        _close(got.grad, want, TIGHT_TOL, f"d{path}")

    # the matches of every layer, compared before any loss
    jic, tic = jcrit.inst_criterion, tcrit.inst_criterion
    jlayers = [_jax_pred(pred_np, arrays)] + \
        _jax_pred(pred_np, arrays)["aux_outputs"]
    for jl, tl in zip(jlayers, [tpred] + tpred["aux_outputs"], strict=True):
        want_m = jic._match_batch(jl, jgt)
        got_m = tic.match(tl, tgt)
        np.testing.assert_array_equal(got_m.pair_valid.numpy(),
                                      np.asarray(want_m.pair_valid))
        pv = got_m.pair_valid.numpy()
        np.testing.assert_array_equal(got_m.pair_q.numpy()[pv],
                                      np.asarray(want_m.pair_q)[pv])
        assert pv.any()


def test_sparse_matcher_ties_and_masks():
    """Equal costs keep the lower query index (``lax.top_k``'s order); a
    GT whose (k+1)-th cost equals its k-th gets no match."""
    cost = np.array([[[1.0, 2.0], [1.0, 2.0], [0.5, 2.0], [3.0, 2.0]]],
                    np.float32)                                 # (1, Q=4, G=2)
    qmask = np.array([[[True, True, False, True],
                       [True, True, True, True]]])              # (1, G, Q)
    qvalid = np.ones((1, 4), bool)
    gvalid = np.ones((1, 2), bool)
    want = JLoss.SparseMatcher(COSTS, topk=1)(
        jnp.asarray(cost[0]), jnp.asarray(qmask[0]), jnp.asarray(qvalid[0]),
        jnp.asarray(gvalid[0]))
    got = TLoss.SparseMatcher(COSTS, topk=1)(
        torch.from_numpy(cost), torch.from_numpy(qmask),
        torch.from_numpy(qvalid), torch.from_numpy(gvalid))
    np.testing.assert_array_equal(got.pair_valid[0].numpy(),
                                  np.asarray(want.pair_valid))
    np.testing.assert_array_equal(got.pair_q[0].numpy(),
                                  np.asarray(want.pair_q))
    assert got.pair_valid[0].tolist() == [[False], [False]]


# --------------------------------------------------------------------------
# optimizer and EMA
# --------------------------------------------------------------------------

@pytest.mark.parametrize("lr_backbone", [None, 3e-5])
def test_optimizer_three_steps_match_optax(lr_backbone):
    rng = np.random.RandomState(9)
    tree = {"backbone": {"w": rng.randn(6, 5).astype(np.float32)},
            "decoder": {"b": rng.randn(7).astype(np.float32),
                        "k": rng.randn(3, 4).astype(np.float32)}}
    # steps 1 and 3 clip (global norm > 10), step 2 does not
    grads = [jax.tree_util.tree_map(
        lambda a, s=s: (rng.randn(*a.shape) * s).astype(np.float32), tree)
        for s in (8.0, 0.3, 20.0)]
    opt_cfg = dict(lr=1e-2, weight_decay=0.05)
    if lr_backbone is not None:
        opt_cfg["lr_backbone"] = lr_backbone
    sched_cfg = dict(total_iters=5, power=0.9)
    tx, _ = JO.build_optimizer(opt_cfg, sched_cfg, clip_max_norm=10.0)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    state = tx.init(params)
    for g in grads:
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state,
                               params)
        params = optax.apply_updates(params, upd)

    named = [(f"{m}.{k}", torch.nn.Parameter(torch.from_numpy(v.copy())))
             for m, d in tree.items() for k, v in d.items()]
    opt = build_optimizer(named, opt_cfg, sched_cfg, clip_max_norm=10.0)
    for g in grads:
        for name, p in named:
            m, k = name.split(".")
            p.grad = torch.from_numpy(g[m][k].copy())
        opt.step()
    for name, p in named:
        m, k = name.split(".")
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(params[m][k]), rtol=1e-6,
                                   atol=1e-8, err_msg=name)
    assert opt.count == 3


def test_ema_matches_jax():
    rng = np.random.RandomState(1)
    tree = {"a": rng.randn(4, 3).astype(np.float32),
            "b": rng.randn(5).astype(np.float32)}
    named = [(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
             for k, v in tree.items()]
    ema = EMA(named, decay=0.9)
    shadow = jax.tree_util.tree_map(jnp.asarray, tree)
    for _ in range(3):
        new = {k: rng.randn(*v.shape).astype(np.float32)
               for k, v in tree.items()}
        with torch.no_grad():
            for k, p in named:
                p.copy_(torch.from_numpy(new[k]))
        ema.update()
        shadow = JEMA.ema_update(shadow, jax.tree_util.tree_map(
            jnp.asarray, new), 0.9)
    for k in tree:
        np.testing.assert_allclose(ema.shadow[k].numpy(),
                                   np.asarray(shadow[k]), rtol=1e-6)
