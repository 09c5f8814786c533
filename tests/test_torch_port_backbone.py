"""The port's Res16UNet34C under bridged reference weights.

The weights are those of ``_bridged_res16`` in
``test_backbone_frozen_numerics.py``: an inverse-constructed reference
state dict, imported into the JAX tree, then carried into the port by
``convert.py``.  The port's output must match the frozen fixture
(``backbone_frozen.npz["res16"]``, ``rtol = atol = 2e-3``, the fixture's own
allowance) and the JAX apply on the same plan and features (``1e-4``: the
same fp32 arithmetic summed in another order).
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_backbone_frozen_numerics import (FIXTURE, _positivize_running_var,  # noqa: E402
                                           _ScaledRNG)
from test_torch_port_jaxlib import load_jax_sparseplan  # noqa: E402
from test_torch_roundtrip import build_res16_torch_sd  # noqa: E402

from segdino3d_tpu.models.backbone.res16unet import \
    Res16UNet34C as JaxRes16  # noqa: E402
from segdino3d_tpu.ops.host_plan import build_host_plan as jax_build_host_plan  # noqa: E402
from segdino3d_tpu.ops.host_plan import host_plan_to_device  # noqa: E402
from segdino3d_tpu.train.torch_import import import_state_dict  # noqa: E402
from segdino3d_tpu_torch.convert import load_jax_variables  # noqa: E402
from segdino3d_tpu_torch.models.backbone.res16unet import Res16UNet34C  # noqa: E402
from segdino3d_tpu_torch.ops import host_plan as TH  # noqa: E402

IN_CH, V_CAP = 35, 512
CAPS = [V_CAP, 256, 128, 64, 32]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs several test workers at once, and
    torch's default of one thread per core makes them thrash."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bridged_models():
    """(points, features, JAX model, its bridged variables, the port's
    model under the same weights)."""
    coords = np.random.RandomState(7).randint(0, 16, (300, 3)).astype(
        np.float32)
    bidx, valid = np.zeros(300, np.int32), np.ones(300, bool)
    load_jax_sparseplan()
    jplan, _ = host_plan_to_device(jax_build_host_plan(
        coords, bidx, valid, CAPS, stem_compact=False), device=False)
    feats = np.random.RandomState(11).randn(V_CAP, IN_CH).astype(np.float32)

    jmodel = JaxRes16(in_channels=IN_CH, out_channels=96)
    # the draws of build_res16_torch_sd follow the flax tree's insertion
    # order, as _bridged_res16 gets it from an eager init; a traced init
    # returns sorted dicts, so record the order while tracing
    order = {}

    def paths(tree, prefix=""):
        for k, v in tree.items():
            p = f"{prefix}/{k}" if prefix else k
            yield from paths(v, p) if isinstance(v, dict) else (p,)

    def init(f, p):
        v = jmodel.init(jax.random.PRNGKey(0), f, p, False)
        order.update({c: list(paths(v[c])) for c in v})
        return v

    shapes = jax.eval_shape(init, jnp.asarray(feats), jplan)

    def zeros(tree, path):
        for k in path.split("/"):
            tree = tree[k]
        return np.zeros(tree.shape, np.float32)

    want = {c: {k: zeros(shapes[c], k) for k in keys}
            for c, keys in order.items()}
    sd = _positivize_running_var(build_res16_torch_sd(
        want["params"], want["batch_stats"], _ScaledRNG(3)))
    params, stats, unmapped = import_state_dict(sd)
    assert unmapped == []
    variables = {"params": params["backbone"]["unet"],
                 "batch_stats": stats["backbone"]["unet"]}
    tmodel = load_jax_variables(Res16UNet34C(in_channels=IN_CH).eval(),
                                jax.device_get(variables))
    return dict(points=(coords, bidx, valid), feats=feats, jmodel=jmodel,
                variables=variables, tmodel=tmodel)


def layout_outputs(models, **layout):
    """(port output, JAX output) on plans of ``layout``
    (``build_host_plan`` arguments), both masked to valid voxels."""
    coords, bidx, valid = models["points"]
    jmodel, feats = models["jmodel"], models["feats"]
    jplan, _ = host_plan_to_device(jax_build_host_plan(
        coords, bidx, valid, CAPS, stem_compact=False, **layout),
        device=False)
    tplan = TH.host_plan_to_device(
        TH.build_host_plan(coords, bidx, valid, CAPS, **layout), "cpu")
    jout = jax.jit(lambda v, f, p: jmodel.apply(v, f, p, False))(
        models["variables"], jnp.asarray(feats), jplan)
    with torch.no_grad():
        tout = models["tmodel"](torch.from_numpy(feats), tplan)
    mask = tplan.levels[0].valid[:, None].numpy().astype(np.float32)
    return tout.numpy() * mask, np.asarray(jout) * mask


@pytest.fixture(scope="module")
def bridged():
    return layout_outputs(bridged_models())


def test_res16_matches_frozen_fixture(bridged):
    port, _ = bridged
    np.testing.assert_allclose(port, np.load(FIXTURE)["res16"],
                               rtol=2e-3, atol=2e-3)


def test_res16_matches_jax_apply(bridged):
    port, jax_out = bridged
    assert np.abs(jax_out).mean() > 1e-3      # a real signal, not zeros
    np.testing.assert_allclose(port, jax_out, rtol=1e-4, atol=1e-4)
