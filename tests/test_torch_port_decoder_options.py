"""Every option of the port's query decoder against the JAX decoder (CPU).

* the forward of each decoder configuration of
  ``tests/test_decoder_configs.py`` and of the options that file does not
  run (objectness, a two-layer semantic head, unmasked DINO-X
  cross-attention, ``attn_mask=False``, ReLU in the FFN, each box flag
  off) against the JAX apply at 1e-4, on one set of numpy-drawn weights
  carried over by ``convert``; leaf gradients against ``jax.grad`` at 1e-3
  for the plain, learned-query and Fourier decoders;
* activation checkpointing: the forward and the gradients equal to the
  plain forward's at 1e-6, with and without dropout;
* ``compute_dtype="bfloat16"`` against the JAX decoder in bf16 within
  3e-2 x max|.|;
* the two PE combinations the JAX decoder asserts on raise ``ValueError``;
* the objectness loss against the JAX criterion at 1e-5, with equal
  matches;
* dropout, which cannot be held to JAX (its training step passes no
  dropout RNG): eval mode equals rate 0, a training forward is
  bit-reproducible from its generator and differs under another seed, an
  FFN drops 10% of its activation, and at rate 0 (checkpointed) the
  flagship step equals the frozen JAX step;
* the Fourier matrix ``gauss_B`` is a buffer: the port's optimizer step
  leaves it as it is, where the JAX package's AdamW decays it.
"""
import copy
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from segdino3d_tpu.models.criterion.losses import \
    ScanNetUnifiedCriterion as JaxCriterion  # noqa: E402
from segdino3d_tpu.models.decoder.query_decoder import \
    ScanNetQueryDecoder as JaxDecoder  # noqa: E402
from segdino3d_tpu_torch.builder import build_criterion, build_decoder  # noqa: E402
from segdino3d_tpu_torch.convert import jax_to_state_dict  # noqa: E402
from segdino3d_tpu_torch.models.decoder.query_decoder import FFN  # noqa: E402
from segdino3d_tpu_torch.ops.attention import (apply_dropout,  # noqa: E402
                                               dropout_keep)
from segdino3d_tpu_torch.train.optim import build_optimizer  # noqa: E402

B, S, Q, K, D, CIN = 2, 12, 10, 4, 32, 16
N_CLS, N_SEM = 5, 6
TOL = dict(rtol=1e-4, atol=1e-4)
PLAIN = dict(add_positional_embedding=False, box_modulate_ca=False,
             add_box_size_pred=False, normalize_box_prediction=False)
# tests/test_decoder_configs.py's matrix, then the options it does not run
CONFIGS = {
    "pe_iter": dict(),
    "plain_iter": dict(PLAIN),
    "plain_simple": dict(PLAIN, iter_pred=False),
    "plain_simple_nodinox": dict(PLAIN, iter_pred=False,
                                 add_dinox_query_ca=False),
    "pe_iter_remat": dict(use_activation_checkpoint=True),
    "learned_queries": dict(PLAIN, iter_pred=False, num_instance_queries=7),
    "fourier_pe": dict(pos_type="fourier", box_modulate_ca=False),
    "fourier_modulated": dict(pos_type="fourier"),
    "learned_and_projected": dict(PLAIN, num_semantic_queries=3),
    "objectness": dict(objectness_flag=True),
    "semantic_linears_2": dict(num_semantic_linears=2),
    "dinox_unmasked": dict(add_dinox_query_ca_mask=False),
    "attn_mask_off": dict(attn_mask=False, add_dinox_query_ca_mask=False),
    "relu": dict(activation_fn="relu"),
    "no_box_modulate": dict(box_modulate_ca=False),
    "no_size_pred": dict(add_box_size_pred=False),
    "no_box_normalize": dict(normalize_box_prediction=False),
}
OUT_KEYS = ("cls_preds", "sem_preds", "masks", "scores", "centers", "sizes")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def dec_cfg(**kw):
    """A small ``decoder_cfg`` (``builder.build_decoder``'s schema) with
    ``kw``."""
    return dict(dict(type="ScanNetQueryDecoder", num_layers=2,
                     num_instance_classes=N_CLS, num_semantic_classes=N_SEM,
                     in_channels=CIN, d_model=D, num_heads=4, hidden_dim=64,
                     dropout=0.0, fix_attention=True), **kw)


def jax_decoder(cfg):
    kw = {k: v for k, v in cfg.items() if k not in ("type",)}
    return JaxDecoder(**kw)


def inputs(seed=0):
    """numpy inputs; the second scene has two invalid superpoints, one
    invalid query and one invalid DINO-X query."""
    rng = np.random.RandomState(seed)

    def f32(*s):
        return rng.randn(*s).astype(np.float32)

    sp_valid = np.ones((B, S), bool)
    sp_valid[1, -2:] = False
    q_valid = np.ones((B, Q), bool)
    q_valid[1, -1] = False
    k_valid = np.ones((B, K), bool)
    k_valid[1, -1] = False
    rng_ = np.stack([np.full((B, 3), -1.5), np.full((B, 3), 1.5)],
                    1).astype(np.float32)
    return dict(sp_feats=f32(B, S, CIN), sp_valid=sp_valid,
                sp_pos=f32(B, S, 3), sp_pos_wo_elastic=0.3 * f32(B, S, 3),
                queries_feat=f32(B, Q, CIN), query_valid=q_valid,
                queries_pos=f32(B, Q, 3), dinox_queries=f32(B, K, D),
                dinox_query_pos=0.3 * f32(B, K, 3), dinox_valid=k_valid,
                scene_range=rng_)


def jax_inputs(inp):
    return {k: jnp.asarray(v) for k, v in inp.items()}


def torch_inputs(inp):
    return {k: torch.from_numpy(v) for k, v in inp.items()}


def seeded_params(dec, inp, seed=0):
    """numpy weights of the JAX decoder's shapes: fan-in scaled kernels,
    N(0, 1) Fourier matrix, LayerNorm scales near 1, small biases."""
    shapes = jax.eval_shape(lambda: dec.init(jax.random.PRNGKey(0),
                                             **jax_inputs(inp)))["params"]
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        x = rng.randn(*leaf.shape).astype(np.float32)
        if name == "kernel":
            return x / np.sqrt(np.prod(leaf.shape[:-1]))
        if name == "scale":
            return 1.0 + 0.1 * x
        if name == "gauss_B":
            return x
        return 0.1 * x

    return jax.tree_util.tree_map_with_path(draw, shapes)


def port_decoder(cfg, params):
    dec = build_decoder(cfg, dinox_dim=D)
    dec.load_state_dict(jax_to_state_dict({"params": params}), strict=True)
    return dec.eval()


def layers_of(out):
    return [out] + list(out["aux_outputs"])


def assert_outputs_close(tout, jout, **tol):
    assert len(tout["aux_outputs"]) == len(jout["aux_outputs"])
    np.testing.assert_array_equal(tout["query_valid"].numpy(),
                                  np.asarray(jout["query_valid"]))
    for li, (t, j) in enumerate(zip(layers_of(tout), layers_of(jout))):
        for k in OUT_KEYS:
            if j.get(k) is None:
                assert t.get(k) is None, (li, k)
                continue
            np.testing.assert_allclose(t[k].detach().numpy(),
                                       np.asarray(j[k]), err_msg=f"{li} {k}",
                                       **tol)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_decoder_forward_matches_jax(name):
    cfg = dec_cfg(**CONFIGS[name])
    inp = inputs()
    jdec = jax_decoder(cfg)
    params = seeded_params(jdec, inp)
    jout = jdec.apply({"params": params}, **jax_inputs(inp))
    tdec = port_decoder(cfg, params)
    if "gauss_B" in params:
        assert "gauss_B" in dict(tdec.named_buffers())
        assert "gauss_B" not in dict(tdec.named_parameters())
    with torch.no_grad():
        tout = tdec(**torch_inputs(inp))
    assert_outputs_close(tout, jout, **TOL)


def loss_weights(out, seed=7):
    """Fixed random weights for a scalar of every output."""
    rng = np.random.RandomState(seed)
    return [{k: rng.randn(*np.shape(layer[k])).astype(np.float32)
             for k in OUT_KEYS if layer.get(k) is not None}
            for layer in layers_of(out)]


def scalar(out, weights, xp):
    total = 0.0
    for layer, w in zip(layers_of(out), weights):
        for k, wk in w.items():
            total = total + (layer[k] * xp(wk)).sum()
    return total


@pytest.mark.parametrize("name", ["plain_iter", "learned_queries",
                                  "fourier_pe"])
def test_decoder_gradients_match_jax(name):
    cfg = dec_cfg(**CONFIGS[name])
    inp = inputs(1)
    jdec = jax_decoder(cfg)
    params = seeded_params(jdec, inp, seed=1)
    jin = jax_inputs(inp)
    weights = loss_weights(jdec.apply({"params": params}, **jin))
    jgrad = jax.grad(lambda p: scalar(jdec.apply({"params": p}, **jin),
                                      weights, jnp.asarray))(params)
    tdec = port_decoder(cfg, params).train()
    scalar(tdec(**torch_inputs(inp)), weights, torch.from_numpy).backward()
    want = jax_to_state_dict({"params": jax.device_get(jgrad)})
    got = dict(tdec.named_parameters())
    if "gauss_B" in want:
        # a stopped gradient in JAX, a buffer in the port
        assert not want.pop("gauss_B").abs().max()
    assert set(want) == set(got)
    scale = max(float(v.abs().max()) for v in want.values())
    for k, g in want.items():
        np.testing.assert_allclose(got[k].grad.numpy(), g.numpy(), rtol=1e-3,
                                   atol=1e-3 * scale, err_msg=k)


@pytest.mark.parametrize("name,dropout", [("pe_iter", 0.0),
                                          ("plain_iter", 0.1)])
def test_activation_checkpoint_matches_plain(name, dropout):
    """The checkpointed decoder in training mode: outputs and gradients
    equal to the plain decoder's (1e-6), dropout masks drawn from one
    seed included."""
    inp = inputs(2)
    base = build_decoder(dec_cfg(dropout=dropout, **CONFIGS[name]),
                         dinox_dim=D).train()
    ckpt = build_decoder(dec_cfg(dropout=dropout, use_activation_checkpoint=True,
                                 **CONFIGS[name]), dinox_dim=D).train()
    ckpt.load_state_dict(base.state_dict())
    outs = []
    for dec in (base, ckpt):
        out = dec(**torch_inputs(inp),
                  generator=torch.Generator().manual_seed(3))
        scalar(out, loss_weights(out), torch.from_numpy).backward()
        outs.append(out)
    for t, r in zip(layers_of(outs[1]), layers_of(outs[0])):
        for k in OUT_KEYS:
            if r.get(k) is not None:
                torch.testing.assert_close(t[k], r[k], rtol=1e-6, atol=1e-6)
    grads = dict(base.named_parameters())
    for n, p in ckpt.named_parameters():
        torch.testing.assert_close(p.grad, grads[n].grad, rtol=1e-6,
                                   atol=1e-6, msg=n)


@pytest.mark.parametrize("name", ["pe_iter", "plain_iter"])
def test_bf16_decoder_tracks_jax_bf16(name):
    cfg = dec_cfg(compute_dtype="bfloat16", **CONFIGS[name])
    inp = inputs(3)
    jdec = jax_decoder(cfg)
    params = seeded_params(jdec, inp, seed=3)
    jout = jdec.apply({"params": params}, **jax_inputs(inp))
    tdec = port_decoder(cfg, params)
    assert tdec.ffn[0].lin1.weight.dtype == torch.float32
    with torch.no_grad():
        tout = tdec(**torch_inputs(inp))
    for k in ("cls_preds", "masks", "sem_preds"):
        want = np.asarray(jout[k], np.float32)
        got = tout[k].float().numpy()
        assert tout[k].dtype == torch.float32, k
        err = np.abs(got - want).max()
        assert err <= 3e-2 * np.abs(want).max(), (k, err)


@pytest.mark.parametrize("bad", [dict(iter_pred=False),
                                 dict(num_instance_queries=4)])
def test_pe_combinations_jax_rejects_raise(bad):
    cfg = dec_cfg(**bad)
    inp = inputs()
    with pytest.raises(AssertionError):
        jax.eval_shape(lambda: jax_decoder(cfg).init(jax.random.PRNGKey(0),
                                                     **jax_inputs(inp)))
    with pytest.raises(ValueError):
        build_decoder(cfg, dinox_dim=D)


# --------------------------------------------------------------------------
# the objectness loss
# --------------------------------------------------------------------------

def criterion_cfg():
    costs = [dict(type="QueryClassificationCost", weight=0.5),
             dict(type="MaskBCECost", weight=1.0),
             dict(type="MaskDiceCost", weight=1.0),
             dict(type="CenterL1Cost", weight=0.5),
             dict(type="SizeL1Cost", weight=0.5)]
    return dict(type="ScanNetUnifiedCriterion", num_semantic_classes=N_SEM,
                sem_criterion=dict(type="ScanNetSemanticCriterion",
                                   ignore_index=N_SEM, loss_weight=0.5),
                inst_criterion=dict(
                    type="InstanceCriterion",
                    matcher=dict(type="SparseMatcher", topk=1, costs=costs),
                    loss_weight=[0.5, 1.0, 1.0, 0.5, 0.5, 0.5],
                    num_classes=N_CLS, non_object_weight=0.1,
                    fix_dice_loss_weight=True, iter_matcher=True,
                    fix_mean_loss=True))


def objectness_case(seed=4):
    """Predictions of three layers with scores, whose masks follow the GT
    of their query's instance (so that pairs pass IoU 0.5), and the GT."""
    rng = np.random.RandomState(seed)
    G = 3
    inst_of_sp = rng.randint(0, G + 1, size=(B, S))       # G: no instance
    sp_masks = np.stack([inst_of_sp == g for g in range(G)], 1)
    sp_valid = np.ones((B, S), bool)
    sp_valid[1, -2:] = False
    q_sp = np.stack([rng.permutation(S)[:Q] for _ in range(B)])
    query_masks = np.take_along_axis(sp_masks, q_sp[:, None, :], 2)
    q_valid = np.ones((B, Q), bool)
    q_valid[1, -1] = False
    gt_valid = np.ones((B, G), bool)
    gt_valid[1, -1] = False

    def layer(i):
        own = np.take_along_axis(inst_of_sp, q_sp, 1)      # (B, Q)
        signs = np.stack([[2.0 * sp_masks[b, min(own[b, q], G - 1)] - 1.0
                           for q in range(Q)] for b in range(B)])
        return dict(
            cls_preds=rng.randn(B, Q, N_CLS + 1).astype(np.float32),
            masks=(rng.randn(B, Q, S) + 3.0 * signs).astype(np.float32),
            scores=rng.rand(B, Q, 1).astype(np.float32),
            centers=rng.randn(B, Q, 3).astype(np.float32),
            sizes=rng.rand(B, Q, 3).astype(np.float32),
            sem_preds=rng.randn(B, Q, N_SEM + 1).astype(np.float32))

    pred = layer(0)
    pred["aux_outputs"] = [layer(1), layer(2)]
    for a in pred["aux_outputs"]:
        a["sem_preds"] = None
    gt = dict(labels=rng.randint(0, N_CLS, (B, G)).astype(np.int32),
              gt_valid=gt_valid, sp_masks=sp_masks, query_masks=query_masks,
              centers=rng.randn(B, G, 3).astype(np.float32),
              sizes=rng.rand(B, G, 3).astype(np.float32), query_valid=q_valid,
              sp_valid=sp_valid,
              query_sem_targets=rng.randint(0, N_SEM, (B, Q)).astype(np.int32))
    return pred, gt


def _tree(x, fn):
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    if isinstance(x, list):
        return [_tree(v, fn) for v in x]
    return None if x is None else fn(x)


def test_objectness_loss_matches_jax():
    pred, gt = objectness_case()
    jcrit = JaxCriterion(**{k: v for k, v in criterion_cfg().items()
                            if k != "type"})
    tcrit = build_criterion(dict(criterion_cfg=criterion_cfg()))
    jpred, jgt = _tree(pred, jnp.asarray), _tree(gt, jnp.asarray)
    tpred, tgt = _tree(pred, torch.from_numpy), _tree(gt, torch.from_numpy)
    want = jcrit(jpred, jgt)
    got = tcrit(tpred, tgt)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    # the score term is live: its pairs pass IoU 0.5, and it moves the loss
    no_scores = _tree(pred, torch.from_numpy)
    for layer in layers_of(no_scores):
        layer["scores"] = None
    assert float(got["inst_loss"]) != float(
        tcrit(no_scores, tgt)["inst_loss"])
    jic, tic = jcrit.inst_criterion, tcrit.inst_criterion
    for jl, tl in zip(layers_of(jpred), layers_of(tpred)):
        jm = jic._match_batch(jl, jgt)
        tm = tic.match(tl, tgt)
        np.testing.assert_array_equal(tm.pair_valid.numpy(),
                                      np.asarray(jm.pair_valid))
        np.testing.assert_array_equal(
            np.where(tm.pair_valid.numpy(), tm.pair_q.numpy(), -1),
            np.where(np.asarray(jm.pair_valid), np.asarray(jm.pair_q), -1))


# --------------------------------------------------------------------------
# dropout (no JAX counterpart: its step passes no dropout RNG)
# --------------------------------------------------------------------------

def test_dropout_eval_mode_equals_rate_zero():
    inp = torch_inputs(inputs(5))
    for name in ("pe_iter", "plain_iter"):
        dropped = build_decoder(dec_cfg(dropout=0.1, **CONFIGS[name]),
                                dinox_dim=D).eval()
        plain = build_decoder(dec_cfg(**CONFIGS[name]), dinox_dim=D).eval()
        plain.load_state_dict(dropped.state_dict())
        gen = torch.Generator().manual_seed(0)
        state = gen.get_state()
        with torch.no_grad():
            a = dropped(**inp, generator=gen)
            b = plain(**inp)
        assert torch.equal(gen.get_state(), state), "eval mode drew masks"
        for t, r in zip(layers_of(a), layers_of(b)):
            for k in OUT_KEYS:
                if r.get(k) is not None:
                    assert torch.equal(t[k], r[k]), (name, k)


def test_dropout_training_forward_is_reproducible_from_its_seed():
    inp = torch_inputs(inputs(6))
    dec = build_decoder(dec_cfg(dropout=0.1, **CONFIGS["plain_iter"]),
                        dinox_dim=D).train()
    with torch.no_grad():
        runs = [dec(**inp, generator=torch.Generator().manual_seed(s))
                for s in (0, 0, 1)]
        dec.eval()
        clean = dec(**inp)
    assert torch.equal(runs[0]["masks"], runs[1]["masks"])
    assert torch.equal(runs[0]["cls_preds"], runs[1]["cls_preds"])
    assert not torch.equal(runs[0]["masks"], runs[2]["masks"])
    assert not torch.equal(runs[0]["masks"], clean["masks"])


def test_ffn_drops_its_share():
    ffn = FFN(64, 1024, dropout=0.1).train()
    x = torch.randn(8, 200, 64, generator=torch.Generator().manual_seed(0))
    seen = []
    ffn.lin2.register_forward_pre_hook(lambda m, a: seen.append(a[0]))
    keep = dropout_keep([(8, 200, 1024), (8, 200, 64)], 0.1, x.device,
                        torch.Generator().manual_seed(1))
    ffn(x, keep)
    share = float((seen[0] == 0).float().mean())
    assert abs(share - 0.1) <= 0.01, share
    h = torch.randn(1000)
    k = keep[1].reshape(-1)[:1000]
    torch.testing.assert_close(apply_dropout(h, k, 0.1),
                               torch.where(k, h / 0.9, 0.0))
    assert dropout_keep([(4,)], 0.0, x.device) is None


def test_rate_zero_checkpointed_step_equals_frozen_jax_step():
    """The flagship step of ``test_torch_port_train.py`` with dropout 0,
    activation checkpointing and a generator: the frozen JAX step."""
    import test_torch_port_train as T

    cfg = copy.deepcopy(T.PORT_CFG)
    cfg["decoder_cfg"].update(dropout=0.0, use_activation_checkpoint=True)
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    port = T.port_step(T.initial_variables(), cfg=cfg, generator=gen)
    assert port["model"].decoder.use_activation_checkpoint
    assert torch.equal(gen.get_state(), state), "rate 0 drew masks"
    T.check_against(port, dict(np.load(T.FIXTURE, allow_pickle=True)))


# --------------------------------------------------------------------------
# gauss_B: a buffer in the port, a decayed param in the JAX package
# --------------------------------------------------------------------------

def test_gauss_b_is_not_decayed():
    from segdino3d_tpu.train.optim import build_optimizer as jax_optimizer

    opt_cfg, sched = dict(lr=1e-4, weight_decay=0.05), dict(total_iters=100)
    cfg = dec_cfg(**CONFIGS["fourier_pe"])
    inp = inputs(8)
    jdec = jax_decoder(cfg)
    params = seeded_params(jdec, inp, seed=8)
    jin = jax_inputs(inp)
    weights = loss_weights(jdec.apply({"params": params}, **jin))

    def loss(p):
        return scalar(jdec.apply({"params": p}, **jin), weights, jnp.asarray)

    tx, _ = jax_optimizer(opt_cfg, sched, clip_max_norm=10.0)
    grads = jax.grad(loss)(params)
    updates, _ = tx.update(grads, tx.init(params), params)
    b0 = np.asarray(params["gauss_B"])
    b1 = np.asarray(params["gauss_B"] + updates["gauss_B"])
    assert not np.asarray(grads["gauss_B"]).any()
    # the fault: AdamW decays the stopped matrix by lr * weight_decay
    np.testing.assert_allclose(b1, b0 * (1 - 1e-4 * 0.05), rtol=1e-6)
    assert not np.array_equal(b1, b0)

    tdec = port_decoder(cfg, params).train()
    opt = build_optimizer(tdec.named_parameters(), opt_cfg, sched,
                          clip_max_norm=10.0)
    before = tdec.gauss_B.clone()
    scalar(tdec(**torch_inputs(inp)), weights, torch.from_numpy).backward()
    opt.step()
    assert torch.equal(tdec.gauss_B, before)
    assert all(p is not tdec.gauss_B for p in opt.params)
