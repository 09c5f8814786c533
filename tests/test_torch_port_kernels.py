"""Each CUDA kernel of the port against its plain PyTorch version, on the card.

Marked ``cuda``: they skip on a machine without a CUDA device (a CUDA kernel
has no CPU mode).  This file imports no JAX, so it also runs where JAX is
not installed, without the JAX package's test settings (`tests/conftest.py`
imports jax):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_kernels.py

Tolerances: fp32 ``rtol = atol = 1e-4`` (the same fp32 products summed in
another order); bf16 ``1e-2`` (both sides sum in fp32 and round once to
bf16, so they may differ by one bf16 ulp).
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
    rng = np.random.RandomState(3)
    coords = rng.uniform(0, 12, (600, 3)).astype(np.float32)
    plan = TH.build_host_plan(coords, np.zeros(600, np.int32),
                              np.ones(600, bool), CAPS)
    return TH.host_plan_to_device(plan, "cuda")


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
