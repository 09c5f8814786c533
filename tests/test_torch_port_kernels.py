"""Each CUDA kernel of the port against its plain PyTorch version, on the card,
and each autograd Function's backward on the card against its CPU run.

Marked ``cuda``: they skip on a machine without a CUDA device (a CUDA kernel
has no CPU mode).  This file imports no JAX, so it also runs where JAX is
not installed, without the JAX package's test settings (`tests/conftest.py`
imports jax):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_kernels.py

Tolerances: fp32 ``rtol = atol = 1e-4`` (the same fp32 products summed in
another order); bf16 ``1e-2`` (both sides sum in fp32 and round once to
bf16, so they may differ by one bf16 ulp).  The weight gradient (K4) sums
hundreds of rows: its tolerance is ``1e-4`` of ``max |plain|``.
"""
import numpy as np
import pytest
import torch

from segdino3d_tpu_torch.ops import host_plan as TH
from segdino3d_tpu_torch.ops import scatter as TS
from segdino3d_tpu_torch.ops import sparse_conv as TSC

CAPS = [512, 256, 128, 64, 32]
TOL = {"float32": 1e-4, "bfloat16": 1e-2}


@pytest.fixture(scope="module")
def levels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return _plan_on("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["gather_gemm_conv_k3", "gather_gemm_conv_k5",
                                    "gather_gemm_conv_down", "up_conv",
                                    "segment_mean_gather"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain(levels, kernel, dtype):
    dt = getattr(torch, dtype)
    lv = levels.levels
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dt)

    if kernel.startswith("gather_gemm_conv"):
        nbr, valid, cin, cout = {
            "gather_gemm_conv_k3": (lv[0].nbr, lv[0].valid, 35, 40),
            "gather_gemm_conv_k5": (levels.stem_nbr, lv[0].valid, 70, 24),
            "gather_gemm_conv_down": (lv[0].child, lv[1].valid, 48, 72),
        }[kernel]
        x = randn(CAPS[0], cin)
        w = randn(nbr.shape[0], cin, cout, scale=(nbr.shape[0] * cin) ** -0.5)
        got = TSC.gather_conv(x, nbr, w, valid)
        want = TSC.gather_conv_plain(x, nbr, w, valid)
    elif kernel == "up_conv":
        x, w = randn(CAPS[1], 24), randn(8, 24, 70, scale=0.2)
        got = TSC.up_conv(x, lv[0], w)
        want = TSC.up_conv_plain(x, lv[0].parent, lv[0].kpos, w, lv[0].valid)
    else:
        g, d = randn(CAPS[0], 13), randn(700, 5)
        idx = torch.randint(-1, CAPS[0], (700,), generator=gen,
                            device="cuda", dtype=torch.int32)
        seg = torch.randint(0, 50, (700,), generator=gen, device="cuda",
                            dtype=torch.int32)
        valid = torch.rand(700, generator=gen, device="cuda") > 0.1
        got = TS.segment_mean_gather(seg, 40, valid, g=g, gather_idx=idx, d=d)
        want = TS.segment_mean_gather_plain(seg, 40, valid, g=g,
                                            gather_idx=idx, d=d)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["gather_a", "mirror", "gather_b",
                                  "gather_a_rows"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wgrad_kernel_matches_plain(levels, form, dtype):
    dt = getattr(torch, dtype)
    lv = levels.levels
    gen = torch.Generator(device="cuda").manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    if form == "gather_a":       # subm: A = X through nbr, B = dY
        a, b, ia, ib, mirror = randn(CAPS[0], 40), randn(CAPS[0], 24), \
            lv[0].nbr, None, False
    elif form == "mirror":       # stem: the narrow side gathered, mirrored
        a, b, ia, ib, mirror = randn(CAPS[0], 70), randn(CAPS[0], 24), \
            None, levels.stem_nbr, True
    elif form == "gather_b":     # up: A = x_coarse, B = dF through child
        a, b, ia, ib, mirror = randn(CAPS[1], 72), randn(CAPS[0], 48), \
            None, lv[0].child, False
    else:                        # down: A = X_fine through child, B = dY
        a, b, ia, ib, mirror = randn(CAPS[0], 32), randn(CAPS[1], 32), \
            lv[0].child, None, False
    got = TSC.gather_wgrad(a, ia, b, ib, mirror=mirror)
    table = ia if ia is not None else ib
    want = TSC.gather_wgrad_plain(a, ia, b, ib, table.shape[0],
                                  table.shape[1], mirror)
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    tol = 1e-4 if dtype == "float32" else 1e-2
    torch.testing.assert_close(got, want, rtol=0, atol=tol * scale)


@pytest.mark.cuda
def test_segment_grad_kernel_matches_plain(levels):
    gen = torch.Generator(device="cuda").manual_seed(2)
    n, v, s = 900, CAPS[0], 40
    inverse = torch.randint(-1, v, (n,), generator=gen, device="cuda",
                            dtype=torch.int32)
    seg = torch.randint(0, s + 3, (n,), generator=gen, device="cuda",
                        dtype=torch.int32)
    valid = torch.rand(n, generator=gen, device="cuda") > 0.1
    g = torch.randn(s, 24, generator=gen, device="cuda")
    got = TS.segment_grad(g, seg, s, inverse, valid,
                          TS.segment_csr(inverse, v, valid))
    want = TS.segment_grad_plain(g, seg, s, inverse, valid, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["subm_k3", "stem_k5", "down", "up",
                                  "pool"])
def test_backward_on_card_matches_cpu(levels, case):
    """The same Function on the card (K1, K2, K4, K5) and on the CPU
    (plain versions): input and weight gradients."""
    lv = levels.levels
    gen = torch.Generator().manual_seed(3)
    if case == "pool":
        n = 700
        inverse = torch.randint(-1, CAPS[0], (n,), generator=gen,
                                dtype=torch.int32)
        seg = torch.randint(0, 50, (n,), generator=gen, dtype=torch.int32)
        valid = torch.rand(n, generator=gen) > 0.1
        q = torch.randn(n, 3, generator=gen)
        vox = torch.randn(CAPS[0], 24, generator=gen)
        dy = torch.randn(40, 24, generator=gen)
        grads = []
        for dev in ("cuda", "cpu"):
            x = vox.to(dev).requires_grad_()
            out = TS.pool_gathered(x, inverse.to(dev), [q.to(dev)],
                                   seg.to(dev), 40, valid.to(dev))[0]
            out.backward(dy.to(dev))
            grads.append([x.grad.cpu()])
    else:
        if case == "subm_k3":
            v_in, cin, cout, n_off = CAPS[0], 40, 24, 27
            fn = lambda x, w, p: TSC.subm_conv(x, p.levels[0].nbr, w,
                                               p.levels[0].valid)
        elif case == "stem_k5":
            v_in, cin, cout, n_off = CAPS[0], 70, 24, 125
            fn = lambda x, w, p: TSC.subm_conv(x, p.stem_nbr, w,
                                               p.levels[0].valid)
        elif case == "down":
            v_in, cin, cout, n_off = CAPS[0], 32, 48, 8
            fn = lambda x, w, p: TSC.down_conv(x, p.levels[0], p.levels[1], w)
        else:
            v_in, cin, cout, n_off = CAPS[1], 48, 32, 8
            fn = lambda x, w, p: TSC.up_conv(x, p.levels[0], w)
        x0 = torch.randn(v_in, cin, generator=gen)
        w0 = torch.randn(n_off, cin, cout, generator=gen) * cin ** -0.5
        cpu_plan = _plan_on("cpu")
        grads = []
        for dev, plan in (("cuda", levels), ("cpu", cpu_plan)):
            x = x0.to(dev).requires_grad_()
            w = w0.to(dev).requires_grad_()
            out = fn(x, w, plan)
            dy = torch.ones_like(out) * torch.linspace(
                -1, 1, out.shape[1], device=dev)
            out.backward(dy)
            grads.append([x.grad.cpu(), w.grad.cpu()])
    torch.cuda.synchronize()
    for got, want in zip(*grads, strict=True):
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * scale)


def _plan_on(device):
    rng = np.random.RandomState(3)
    coords = rng.uniform(0, 12, (600, 3)).astype(np.float32)
    plan = TH.build_host_plan(coords, np.zeros(600, np.int32),
                              np.ones(600, bool), CAPS)
    return TH.host_plan_to_device(plan, device)
