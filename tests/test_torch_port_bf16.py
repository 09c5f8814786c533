"""The backbone in bf16 (``compute_dtype="bfloat16"``), the JAX package's
headline dtype, in both packages.

The small backbone of ``test_torch_port_model.py`` (Res16UNet34C, 35 input
channels, k5 stem) with seeded random weights in the JAX tree's layout,
carried into the port by ``convert.py``, on two of its seeded scenes, in the
three plan layouts the port runs: the gather layout, the hybrid eval layout
(gather k5 stem, block-dense e4 levels) and the block-dense training layout
(the dense k5 stem).

Tolerance of the bf16 parity: ``2e-2 x max |JAX|``.  Both packages round
every conv's output, batch norm and residual to bf16, but at places of
their own (XLA fuses some elementwise steps in fp32; the port rounds each
op's output), and sum in fp32 in other orders, so after ~50 stacked convs
their features may differ by a few bf16 ulps of the largest value.
Measured (the test prints ``max_err``): one bf16 ulp of the largest value,
0.0078 of 0.91-0.95, on every layout and seed.

Where the two packages differ on purpose: JAX's superpoint pool
(``segment_mean_stack``) adds the bf16 point features, and counts them, in
bf16, so a superpoint of a few hundred points loses most of its low bits
(on seed 0 one superpoint of 326 points moves by 0.2, against 0.004 for
the port's bf16 against its fp32).  The port's pool (K3) adds in fp32.  So
the U-Net's voxel output is held to JAX's U-Net output, and the superpoint
features to JAX's U-Net output pooled in fp32.

The stem's aligned pitch (``ops.narrow.row_pitch``): a bf16 input row of
Cin channels reaches the stem at Cin rounded up to 8 (35 -> 40 here, 259 ->
264 on the flagship), zero past Cin, and the stem pads its weight inside
the forward.  In fp32 the pitch is Cin itself, and the padded conv is
exactly the unpadded one.
"""
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_port_jaxlib import load_jax_sparseplan  # noqa: E402
from test_torch_port_model import (FEAT2D, S_CAP, SCENE,  # noqa: E402
                                   _seeded_variables)

from segdino3d_tpu.builder import Capacities as JCaps  # noqa: E402
from segdino3d_tpu.builder import build_backbone_wrapper  # noqa: E402
from segdino3d_tpu.data import collate as JC  # noqa: E402
from segdino3d_tpu.data.synthetic import synthetic_scene as jax_scene  # noqa: E402
from segdino3d_tpu_torch.builder import (Capacities, build_model,  # noqa: E402
                                         host_plan_args)
from segdino3d_tpu_torch.convert import load_jax_variables  # noqa: E402
from segdino3d_tpu_torch.data import collate as TC  # noqa: E402
from segdino3d_tpu_torch.data.synthetic import synthetic_scene  # noqa: E402
from segdino3d_tpu_torch.models.backbone.res16unet import SubMConv  # noqa: E402
from segdino3d_tpu_torch.ops import block_dense as TBD  # noqa: E402
from segdino3d_tpu_torch.ops import narrow as TN  # noqa: E402
from segdino3d_tpu_torch.ops import sparse_conv as TSC  # noqa: E402

BF16_TOL = 2e-2
LAYOUTS = {
    "gather": {},
    "hybrid": dict(block_edges=(4,) * 5, stem_gather=True),
    "block_dense": dict(block_edges=(4,) * 5, stem_gather=False),
}
BACKBONE = dict(type="Res16UNet34C", in_channels=FEAT2D + 3, out_channels=96,
                voxel_size=0.02, mode_fuse_2d_feat="early_fusion",
                config=dict(conv1_kernel_size=5))


@pytest.fixture(scope="module", autouse=True)
def _setup():
    """The JAX plan library (``test_torch_port_jaxlib.py``), and one torch
    thread: the suite runs several test workers at once."""
    load_jax_sparseplan()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_cfg(layout, dtype):
    bcfg = dict(BACKBONE, compute_dtype=dtype, **LAYOUTS[layout])
    return dict(type="SegDINO3D", pointcloud_backbone_cfg=bcfg,
                decoder_cfg=dict(num_layers=1, num_instance_classes=4,
                                 num_semantic_classes=5, in_channels=96,
                                 d_model=64, num_heads=8, hidden_dim=128))


@pytest.fixture(scope="module")
def jax_backbone():
    """The JAX bf16 backbone wrapper and its seeded variables."""
    jspec = JC.PadSpec(2048, S_CAP, 16, 16, 20)
    jbb = build_backbone_wrapper(
        dict(BACKBONE, compute_dtype="bfloat16"),
        JCaps(num_points=2048, num_voxels=2048, num_superpoints=S_CAP))
    variables = _seeded_variables(jbb, JC.collate([jax_scene(0, **SCENE)],
                                                  jspec))
    return jbb, variables, jspec


def _port_backbone(variables, layout, dtype):
    model, _ = build_model(_port_cfg(layout, dtype),
                           Capacities(num_superpoints=S_CAP), device="cpu")
    return load_jax_variables(model.backbone, variables)


def _batches(layout, seed, jspec):
    args = host_plan_args(_port_cfg(layout, "bfloat16"))
    rec, jrec = synthetic_scene(seed, **SCENE), jax_scene(seed, **SCENE)
    tspec = TC.PadSpec(2048, S_CAP, 16, 16, 20)
    jb = JC.attach_host_plan(JC.collate([jrec], jspec), [jrec], jspec,
                             stem_compact=False, **args)
    tb = TC.attach_host_plan(TC.collate([rec], tspec, "cpu"), [rec], tspec,
                             **args)
    return jb, tb


def _jax_outputs(jbb, variables, jb):
    """JAX's backbone output and its U-Net's voxel output (bf16)."""
    def run(v, b):
        out, st = jbb.apply(v, b, False, mutable=["intermediates"],
                            capture_intermediates=lambda m, name: (
                                m.name == "unet" and name == "__call__"))
        return out, st["intermediates"]["unet"]["__call__"][0]
    return jax.device_get(jax.jit(run)(variables, jb))


def _pool_fp32(vox, jb):
    """JAX's voxel output gathered to the points and averaged per
    superpoint in fp32 (the port's pooling arithmetic), rounded to bf16."""
    inv = np.asarray(jb.plan_inverse_mapping).reshape(-1)
    pv = np.asarray(jb.point_valid).reshape(-1)
    sp = np.clip(np.asarray(jb.superpoint_ids).reshape(-1), 0, S_CAP - 1)
    pts = np.where((pv & (inv >= 0))[:, None],
                   np.asarray(vox, np.float32)[np.maximum(inv, 0)], 0.0)
    sums = np.zeros((S_CAP, pts.shape[1]), np.float32)
    np.add.at(sums, sp[pv], pts[pv])
    cnt = np.maximum(np.bincount(sp[pv], minlength=S_CAP), 1)
    mean = torch.from_numpy(sums / cnt[:, None].astype(np.float32))
    return mean.to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_backbone_matches_jax_bf16(jax_backbone, layout, seed):
    """The port's bf16 backbone against JAX's bf16 backbone, same weights
    and scene, on each layout's host plans: the U-Net's voxel output (bf16
    in both) and the superpoint features (bf16; against JAX's U-Net output
    pooled in fp32) within ``BF16_TOL x max |JAX|``; superpoint positions
    and validity equal to JAX's."""
    jbb, variables, jspec = jax_backbone
    jb, tb = _batches(layout, seed, jspec)
    if layout != "gather":
        assert tb.plan.blocks[0] is not None
        assert (tb.plan.stem_nbr is not None) == (layout == "hybrid")
    want, jvox = _jax_outputs(jbb, variables, jb)
    port = _port_backbone(variables, layout, "bfloat16").eval()
    tvox = []
    hook = port.unet.register_forward_hook(lambda m, a, o: tvox.append(o))
    try:
        with torch.no_grad():
            got = port(tb)
    finally:
        hook.remove()
    assert got.sp_feats.dtype == tvox[0].dtype == torch.bfloat16
    assert np.asarray(want.sp_feats).dtype == np.asarray(jvox).dtype \
        == jax.numpy.bfloat16
    valid = tb.plan.levels[0].valid.numpy()[:, None]
    for name, g, w in (
            ("voxels", tvox[0].float().numpy() * valid,
             np.asarray(jvox, np.float32) * valid),
            ("superpoints", got.sp_feats[0].float().numpy(),
             _pool_fp32(jvox, jb) * got.sp_valid[0].numpy()[:, None])):
        scale = np.abs(w).max()
        assert scale > 1e-2                  # a real signal, not zeros
        err = np.abs(g - w).max()
        print(f"{layout} seed {seed} {name}: max_err {err:.4g} of max "
              f"{scale:.4g}")
        np.testing.assert_allclose(g, w, rtol=0, atol=BF16_TOL * scale,
                                   err_msg=name)
    np.testing.assert_array_equal(got.sp_valid.numpy(),
                                  np.asarray(want.sp_valid))
    np.testing.assert_allclose(got.sp_pos.numpy(), np.asarray(want.sp_pos),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_bf16_unet_keeps_every_matrix_in_bf16(jax_backbone, layout):
    """Counterpart of ``tests/test_backbone.py``'s bf16 leak test: every
    tensor of two or more dimensions that a module of the port's U-Net
    returns under ``compute_dtype="bfloat16"`` is bf16, the stem's input
    reaches it at the aligned pitch (40 columns, zero past 35) and the
    stem's weight keeps its (125, 35, 32) shape."""
    _, variables, jspec = jax_backbone
    _, tb = _batches(layout, 0, jspec)
    port = _port_backbone(variables, layout, "bfloat16").eval()
    bad, stem_in = [], []

    def hook(mod, args, out):
        for t in (out if isinstance(out, (tuple, list)) else [out]):
            if isinstance(t, torch.Tensor) and t.dim() >= 2 \
                    and t.dtype != torch.bfloat16:
                bad.append((type(mod).__name__, tuple(t.shape), t.dtype))

    handles = [m.register_forward_hook(hook)
               for m in port.unet.modules() if m is not port.unet]
    handles.append(port.unet.conv0p1s1.register_forward_hook(
        lambda m, a, o: stem_in.append(a[0])))
    try:
        with torch.no_grad():
            port(tb)
    finally:
        for h in handles:
            h.remove()
    assert not bad, f"fp32 in the bf16 U-Net: {bad[:5]}"
    x = stem_in[0]
    assert x.dtype == torch.bfloat16 and x.shape[1] == TN.row_pitch(
        FEAT2D + 3, torch.bfloat16) == 40
    assert not x[:, FEAT2D + 3:].float().any()
    assert tuple(port.unet.conv0p1s1.kernel.shape) == (125, FEAT2D + 3, 32)


def test_row_pitch():
    """Stem rows round up to 16 bytes (bf16 8 elements, fp32 4); the
    narrow path's few channels keep Cin."""
    assert TN.row_pitch(259, torch.bfloat16) == 264
    assert TN.row_pitch(3, torch.bfloat16) == 3
    assert TN.row_pitch(262, torch.bfloat16) == 264
    assert TN.row_pitch(96, torch.bfloat16) == 96
    assert TN.row_pitch(259, torch.float32) == 260
    assert TN.wide_stem(264, 32, torch.bfloat16)
    assert not TN.wide_stem(264, 32, torch.float32)
    assert not TN.wide_stem(384, 256, torch.bfloat16)


class _Ctx:
    """A conv context of one conv (the stem's gather or block-dense role)."""

    def __init__(self, fn):
        self.fn = fn

    def subm(self, feats, w):
        return self.fn(feats, w)


def _stem_case(kind, rng):
    """(conv(feats, w), feats (rows, 11)) of the stem in one layout: the k5
    gather conv on a small plan's stem table, or the dense k5 block conv
    on its level-0 block tables."""
    from segdino3d_tpu_torch.ops import host_plan as TH
    coords = rng.uniform(0, 12, (600, 3)).astype(np.float32)
    edges = (4,) * 5 if kind == "block" else None
    plan = TH.host_plan_to_device(TH.build_host_plan(
        coords, np.zeros(600, np.int32), np.ones(600, bool),
        [512, 256, 128, 64, 32], stem_kernel=5, block_edges=edges), "cpu")
    if kind == "block":
        t = plan.blocks[0]
        occ = TBD.occupancy(t)
        rows = occ.shape[0]
        fn = lambda f, w: TBD.dense_subm_conv(f, occ, t, w)   # noqa: E731
    else:
        valid = plan.levels[0].valid
        rows = valid.shape[0]
        fn = lambda f, w: TSC.subm_conv(f, plan.stem_nbr, w,   # noqa: E731
                                        valid)
    return fn, torch.from_numpy(rng.randn(rows, 11).astype(np.float32))


@pytest.mark.parametrize("kind", ["gather", "block"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padded_stem_matches_unpadded(kind, dtype):
    """The stem at an aligned pitch: input rows of 11 channels widened to 16
    with zero columns, the weight padded inside ``SubMConv``, against the
    unpadded conv: outputs and the (unpadded) weight gradient equal in fp32,
    within one bf16 rounding in bf16 (the plain version sums the padded
    products in another blocking); the parameter keeps its shape."""
    dt = getattr(torch, dtype)
    fn, x = _stem_case(kind, np.random.RandomState(40))
    conv = SubMConv(11, 32, kernel_volume=125)
    with torch.no_grad():
        conv.kernel.copy_(torch.from_numpy(np.random.RandomState(41).randn(
            125, 11, 32).astype(np.float32)) / np.sqrt(125 * 11))
    xd = x.to(dt)
    padded = torch.cat([xd, xd.new_zeros(xd.shape[0], 5)], 1)
    ctx = _Ctx(fn)
    outs, grads = [], []
    for inp in (xd, padded):
        conv.kernel.grad = None
        y = conv(inp, ctx)
        (y.float() * torch.linspace(-1, 1, y.shape[1])).sum().backward()
        outs.append(y.detach().float())
        grads.append(conv.kernel.grad.clone())
    assert tuple(conv.kernel.shape) == (125, 11, 32)
    assert grads[1].shape == grads[0].shape
    if dtype == "float32":
        torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=0)
        torch.testing.assert_close(grads[1], grads[0], rtol=0, atol=0)
    else:
        scale = outs[0].abs().max()
        torch.testing.assert_close(outs[1], outs[0], rtol=0,
                                   atol=1e-2 * float(scale))
        gscale = grads[0].abs().max()
        torch.testing.assert_close(grads[1], grads[0], rtol=0,
                                   atol=1e-2 * float(gscale))


@pytest.mark.parametrize("name", ["pe_iter", "learned_queries"])
@pytest.mark.parametrize("decoder_dtype", ["float32", "bfloat16"])
def test_decoder_takes_bf16_backbone_features(name, decoder_dtype):
    """A bf16 backbone feeds the decoder bf16 superpoint and query features;
    as flax's ``Dense()``, the port's fp32 layers promote them to fp32
    (``ops.attention.dense``), and a bf16 decoder casts them.  The same
    bf16 inputs through the JAX decoder: every layer equal at 1e-4 with an
    fp32 decoder (the same fp32 arithmetic); with a bf16 one the first
    head (the initial queries' prediction, before any mask-gated
    attention) within 3e-2 x max (``test_torch_port_decoder_options.py``'s
    bf16 tolerance): later layers pass bf16 logits through the attention
    masks' thresholds, where a flipped gate moves them further (on this
    seed the last layer by 7.5% of its max, on seed 3 by 1.2%)."""
    import jax.numpy as jnp
    from test_torch_port_decoder_options import (CONFIGS, OUT_KEYS, dec_cfg,
                                                 inputs, jax_decoder,
                                                 port_decoder, seeded_params)

    cfg = dec_cfg(**CONFIGS[name], **({} if decoder_dtype == "float32" else
                                       {"compute_dtype": decoder_dtype}))
    inp = inputs(5)
    jdec = jax_decoder(cfg)
    params = seeded_params(jdec, inp, seed=5)
    bf16 = ("sp_feats", "queries_feat")
    jin = {k: jnp.asarray(v, jnp.bfloat16 if k in bf16 else None)
           for k, v in inp.items()}
    tin = {k: torch.from_numpy(v).to(torch.bfloat16) if k in bf16
           else torch.from_numpy(v) for k, v in inp.items()}
    jout = jdec.apply({"params": params}, **jin)
    with torch.no_grad():
        tout = port_decoder(cfg, params)(**tin)
    layers = list(zip([tout] + list(tout["aux_outputs"]),
                      [jout] + list(jout["aux_outputs"])))
    if decoder_dtype == "bfloat16":
        layers = layers[1:2]
    for li, (t, j) in enumerate(layers):
        for k in OUT_KEYS:
            if j.get(k) is None:
                continue
            want = np.asarray(j[k], np.float32)
            got = t[k].float().numpy()
            if decoder_dtype == "float32":
                np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                           err_msg=f"{li} {k}")
            else:
                assert np.abs(got - want).max() <= 3e-2 * np.abs(want).max(), \
                    (li, k)
