"""The port's ops (plain PyTorch versions, CPU) against the JAX package's.

Inputs are made with numpy from a seed and fed to both.  Tolerances: fp32
``rtol = atol = 1e-5``; the convolutions' sums ``1e-4`` (hundreds of
products summed in another order).  The kernels themselves are held
against these plain versions on the card by
``tests/test_torch_port_kernels.py`` and ``chip_smoke.py``.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segdino3d_tpu.ops import attention as JA
from segdino3d_tpu.ops import nms as JN
from segdino3d_tpu.ops import pos_embed as JP
from segdino3d_tpu.ops import scatter as JS
from segdino3d_tpu.ops import sparse_conv as JSC
from segdino3d_tpu.ops.host_plan import build_host_plan as jax_build_host_plan
from segdino3d_tpu.ops.host_plan import host_plan_to_device
from segdino3d_tpu.ops.voxelize import devoxelize as jax_devoxelize
from segdino3d_tpu_torch.ops import attention as TA
from segdino3d_tpu_torch.ops import host_plan as TH
from segdino3d_tpu_torch.ops import nms as TN
from segdino3d_tpu_torch.ops import pos_embed as TP
from segdino3d_tpu_torch.ops import scatter as TS
from segdino3d_tpu_torch.ops import sparse_conv as TSC
from segdino3d_tpu_torch.ops.voxelize import devoxelize

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_jaxlib import load_jax_sparseplan  # noqa: E402

OPS_TOL = dict(rtol=1e-5, atol=1e-5)
CONV_TOL = dict(rtol=1e-4, atol=1e-4)
CAPS = [512, 256, 128, 64, 32]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs several test workers at once, and
    torch's default of one thread per core makes them thrash."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


@pytest.fixture(scope="module")
def plans():
    rng = np.random.RandomState(3)
    coords = rng.uniform(0, 12, (600, 3)).astype(np.float32)
    bidx = np.zeros(600, np.int32)
    valid = np.ones(600, bool)
    load_jax_sparseplan()
    jplan, _ = host_plan_to_device(jax_build_host_plan(
        coords, bidx, valid, CAPS, stem_compact=False), device=False)
    tplan = TH.host_plan_to_device(
        TH.build_host_plan(coords, bidx, valid, CAPS), "cpu")
    return jplan, tplan


@pytest.mark.parametrize("case", ["subm_k3", "subm_k5_matmul_first",
                                  "down_child_table", "up"])
def test_sparse_conv(plans, case):
    jplan, tplan = plans
    rng = np.random.RandomState(sum(map(ord, case)))
    if case.startswith("subm"):
        k5 = case == "subm_k5_matmul_first"
        nbr_j = jplan.stem_nbr if k5 else jplan.subm_nbr[1]
        nbr_t = tplan.stem_nbr if k5 else tplan.levels[1].nbr
        valid_j, valid_t = jplan.levels[0 if k5 else 1].valid, \
            tplan.levels[0 if k5 else 1].valid
        cin, cout = (35, 8) if k5 else (16, 24)   # 35 > 2 * 8: matmul-first
        x = rng.randn(nbr_t.shape[1], cin).astype(np.float32)
        w = (rng.randn(nbr_t.shape[0], cin, cout)
             / np.sqrt(cin)).astype(np.float32)
        want = JSC.subm_conv(jnp.asarray(x), jnp.asarray(nbr_j),
                             jnp.asarray(w), jnp.asarray(valid_j))
        got = TSC.subm_conv(torch.from_numpy(x), nbr_t, torch.from_numpy(w),
                            valid_t)
    elif case == "down_child_table":
        x = rng.randn(CAPS[1], 12).astype(np.float32)
        w = (rng.randn(8, 12, 20) / np.sqrt(12)).astype(np.float32)
        want = JSC.down_conv(jnp.asarray(x), jplan.levels[1], jplan.levels[2],
                             jnp.asarray(w))
        got = TSC.down_conv(torch.from_numpy(x), tplan.levels[1],
                            tplan.levels[2], torch.from_numpy(w))
    else:
        x = rng.randn(CAPS[2], 12).astype(np.float32)
        w = (rng.randn(8, 12, 20) / np.sqrt(12)).astype(np.float32)
        want = JSC.up_conv(jnp.asarray(x), jplan.levels[1], jnp.asarray(w))
        got = TSC.up_conv(torch.from_numpy(x), tplan.levels[1],
                          torch.from_numpy(w))
    assert tuple(got.shape) == want.shape
    _close(got, want, CONV_TOL)


def _segments(seed, n=500, s=40):
    rng = np.random.RandomState(seed)
    # ids >= s are dropped (the padding sentinel); segment s-1 stays empty
    seg = rng.randint(0, s + 3, n).astype(np.int32)
    seg[seg == s - 1] = s
    valid = rng.rand(n) > 0.2
    return rng, seg, valid, s


@pytest.mark.parametrize("case", ["segment_mean", "segment_mean_stack",
                                  "devoxelize", "pool_gathered"])
def test_segment_ops(case):
    rng, seg, valid, s = _segments(5)
    n = seg.shape[0]
    t = torch.from_numpy
    if case == "segment_mean":
        x = rng.randn(n, 7).astype(np.float32)
        want = JS.segment_mean(jnp.asarray(x), jnp.asarray(seg), s,
                               jnp.asarray(valid))
        _close(TS.segment_mean(t(x), t(seg), s, t(valid)), want, OPS_TOL)
        return
    if case == "segment_mean_stack":
        xs = [rng.randn(n, 5).astype(np.float32),
              rng.randn(n, 3).astype(np.float32)]
        want = JS.segment_mean_stack([jnp.asarray(x) for x in xs],
                                     jnp.asarray(seg), s, jnp.asarray(valid))
        got = TS.segment_mean_stack([t(x) for x in xs], t(seg), s, t(valid))
        for g, w in zip(got, want, strict=True):
            _close(g, w, OPS_TOL)
        return
    vox = rng.randn(60, 9).astype(np.float32)
    inverse = rng.randint(-1, 60, n).astype(np.int32)
    if case == "devoxelize":
        want = jax_devoxelize(jnp.asarray(vox), jnp.asarray(inverse),
                              jnp.asarray(valid))
        _close(devoxelize(t(vox), t(inverse), t(valid)), want, OPS_TOL)
        return
    # fused devoxelize + superpoint pooling, as the backbone wrapper runs it
    q = [rng.randn(n, 3).astype(np.float32) for _ in range(2)]
    pt = jax_devoxelize(jnp.asarray(vox), jnp.asarray(inverse),
                        jnp.asarray(valid))
    want = JS.segment_mean_stack([pt] + [jnp.asarray(a) for a in q],
                                 jnp.asarray(seg), s, jnp.asarray(valid))
    got = TS.pool_gathered(t(vox), t(inverse), [t(a) for a in q], t(seg), s,
                           t(valid))
    for g, w in zip(got, want, strict=True):
        _close(g, w, OPS_TOL)


@pytest.mark.parametrize("case", ["masked_softmax", "mha", "mha_scaled"])
def test_masked_attention(case):
    rng = np.random.RandomState(7)
    b, nq, s, d, h = 2, 5, 9, 16, 4
    blocked = rng.rand(b, nq, s) > 0.6
    blocked[0, 2, :] = True          # every key blocked: zeros, not NaN
    if case == "masked_softmax":
        logits = rng.randn(b, nq, s).astype(np.float32) * 3
        want = JA.masked_softmax(jnp.asarray(logits), jnp.asarray(blocked))
        got = TA.masked_softmax(torch.from_numpy(logits),
                                torch.from_numpy(blocked))
        assert float(got[0, 2].abs().sum()) == 0.0
    else:
        q, k = (rng.randn(b, n, 2 * d).astype(np.float32) for n in (nq, s))
        v = rng.randn(b, s, d).astype(np.float32)
        scale = float(2 * d // h) ** -0.5 if case == "mha_scaled" else None
        want = JA.multi_head_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), h,
                                       jnp.asarray(blocked), scale)
        got = TA.multi_head_attention(torch.from_numpy(q),
                                      torch.from_numpy(k), torch.from_numpy(v),
                                      h, torch.from_numpy(blocked), scale)
        assert float(got[0, 2].abs().sum()) == 0.0
    assert bool(torch.isfinite(got).all())
    _close(got, want, OPS_TOL)


@pytest.mark.parametrize("modulated", [False, True])
def test_sine_pos_embed(modulated):
    rng = np.random.RandomState(11)
    xyz = rng.uniform(-1, 3, (2, 7, 3)).astype(np.float32)
    lo = xyz.min(1) - 0.1
    hi = xyz.max(1) + 0.1
    mod = rng.uniform(0.5, 2, (2, 7, 3)).astype(np.float32) \
        if modulated else None
    want = JP.sine_pos_embed(jnp.asarray(xyz), 64,
                             (jnp.asarray(lo), jnp.asarray(hi)),
                             temperature=20.0,
                             modulated=None if mod is None
                             else jnp.asarray(mod))
    got = TP.sine_pos_embed(torch.from_numpy(xyz), 64,
                            (torch.from_numpy(lo), torch.from_numpy(hi)),
                            temperature=20.0,
                            modulated=None if mod is None
                            else torch.from_numpy(mod))
    _close(got, want, OPS_TOL)


def test_matrix_nms_tied_scores():
    rng = np.random.RandomState(13)
    n, s = 24, 30
    masks = rng.rand(n, s).astype(np.float32) * (rng.rand(n, s) > 0.5)
    labels = rng.randint(0, 3, n).astype(np.int32)
    scores = np.round(rng.rand(n), 1).astype(np.float32)   # many ties
    scores[5] = scores[9] = scores[17] = 0.5
    valid = rng.rand(n) > 0.15
    want_sc, want_order = JN.mask_matrix_nms(
        jnp.asarray(masks), jnp.asarray(labels), jnp.asarray(scores),
        valid=jnp.asarray(valid))
    got_sc, got_order = TN.mask_matrix_nms(
        torch.from_numpy(masks), torch.from_numpy(labels),
        torch.from_numpy(scores), valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(got_order.numpy(), np.asarray(want_order))
    np.testing.assert_allclose(got_sc.numpy(), np.asarray(want_sc), **OPS_TOL)
