"""The port's reference-checkpoint loader (``train/torch_import.py``)
against the JAX package's, on reference-named state dicts built from the
repo's own inverse constructors (``test_torch_roundtrip.py``).

* Res16UNet34C (``build_res16_torch_sd``) and SpConvUNet
  (``build_spconv_torch_sd``, its spconv kernels in the KRSC layout and
  again in RSCK): the port's ``import_state_dict`` must give, key for key
  and bit for bit, what the JAX ``import_state_dict`` gives passed
  through ``convert.jax_to_state_dict``;
* the decoder, through a test-local exporter from a JAX decoder tree to
  the reference's names (the inverse of the JAX ``_translate``), first
  proven by ``import_state_dict(export(tree)) == tree`` in the JAX
  package;
* a whole model's checkpoint written with ``torch.save`` (a ``module.``
  prefix, a ``{"model": sd}`` wrapper) loads with
  ``load_reference_checkpoint``, which reports the unmapped keys and
  raises on a missing one.
"""
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import __graft_entry__ as ge  # noqa: E402
from test_torch_port_jaxlib import load_jax_sparseplan  # noqa: E402
from test_torch_roundtrip import (_flatten, build_res16_torch_sd,  # noqa: E402
                                  build_spconv_torch_sd)

from segdino3d_tpu.data import collate as JC  # noqa: E402
from segdino3d_tpu.data.synthetic import synthetic_scene as jax_scene  # noqa: E402
from segdino3d_tpu.train import torch_import as JI  # noqa: E402
from segdino3d_tpu_torch.builder import Capacities, build_model  # noqa: E402
from segdino3d_tpu_torch.convert import (jax_to_state_dict,  # noqa: E402
                                         state_dict_to_jax)
from segdino3d_tpu_torch.models.backbone.res16unet import Res16UNet34C  # noqa: E402
from segdino3d_tpu_torch.models.backbone.spconv_unet import SpConvUNet  # noqa: E402
from segdino3d_tpu_torch.train import torch_import as TI  # noqa: E402

import test_torch_port_model as M  # noqa: E402

# d_model equals the DINO-X width, as in the released configs: the
# reference's packed in_proj_weight needs it
D_MODEL = FEAT2D = 64
S_CAP = 64
V2_CFG = dict(
    type="SegDINO3D",
    pointcloud_backbone_cfg=dict(type="SpConvUNet",
                                 num_planes=[8, 12, 16, 20, 24],
                                 in_channels=FEAT2D + 6, voxel_size=0.02),
    decoder_cfg=dict(num_layers=2, num_instance_classes=18,
                     num_semantic_classes=20, in_channels=8, d_model=D_MODEL,
                     num_heads=8, hidden_dim=128, temperature=20))


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


def tree_of(module):
    """Flat {flax path: zeros} of ``module``'s params and batch stats (the
    flax tree's names and shapes), for the inverse constructors."""
    tree = state_dict_to_jax(module.state_dict())
    return _flatten(tree["params"]), _flatten(tree["batch_stats"])


def jax_side(sd):
    """The JAX package's import of ``sd``, through ``convert``."""
    params, stats, unmapped = JI.import_state_dict(sd)
    assert unmapped == []
    return jax_to_state_dict({"params": params, "batch_stats": stats})


def assert_bit_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k


def to_rsck(sd):
    """spconv's RSCK layout (k, k, k, Cin, Cout) of every KRSC kernel."""
    return {k: np.moveaxis(v, 0, -1) if np.ndim(v) == 5 else v
            for k, v in sd.items()}


def spconv_sd(seed=1):
    return build_spconv_torch_sd(*tree_of(SpConvUNet(
        num_planes=(8, 12, 16, 20, 24), in_channels=38)),
        np.random.RandomState(seed))


@pytest.mark.parametrize("layout", ["KRSC", "RSCK"])
def test_spconv_import_equals_jax_import(layout):
    sd = spconv_sd()
    if layout == "RSCK":
        sd = to_rsck(sd)
        assert sd["backbone.input_conv.0.weight"].shape == (3, 3, 3, 38, 8)
    got, unmapped = TI.import_state_dict(sd)
    assert unmapped == []
    assert_bit_equal(got, jax_side(sd))
    assert got["backbone.unet.input_conv.kernel"].shape == (27, 38, 8)
    assert got["backbone.unet.tail_l0.0.i_branch.weight"].shape == (8, 16)


def test_res16_import_equals_jax_import():
    sd = build_res16_torch_sd(*tree_of(Res16UNet34C(in_channels=35)),
                              np.random.RandomState(2))
    got, unmapped = TI.import_state_dict(sd)
    assert unmapped == []
    assert_bit_equal(got, jax_side(sd))
    # the same through the transposed ME offset enumeration
    want = JI.import_state_dict(sd, kernel_order="x_fastest")
    assert_bit_equal(TI.import_state_dict(sd, kernel_order="x_fastest")[0],
                     jax_to_state_dict({"params": want[0],
                                        "batch_stats": want[1]}))


# --------------------------------------------------------------------------
# the decoder, through a test-local exporter
# --------------------------------------------------------------------------

_DEC_RENAMES = [
    (r"input_proj_dense/", "input_proj.0."),
    (r"input_proj_norm/", "input_proj.1."),
    (r"(x_mask|query_proj)1/", r"\1.0."),
    (r"(x_mask|query_proj)2/", r"\1.2."),
    (r"(out_cls|out_sem|out_score)/layers_(\d)/", r"\1.\2."),
    (r"ca_norm_(\d+)/", r"norm1.\1."),
    (r"sa_norm_(\d+)/", r"norm2.\1."),
    (r"ca_out_proj_(\d+)/", r"cross_attn_layers.\1.out_proj."),
    (r"sa_out_proj_(\d+)/", r"self_attn_layers.\1.out_proj."),
    (r"((?:ca|sa)_\w+_proj)_(\d+)/", r"\1.\2."),
    (r"ffn_(\d+)/lin1/", r"ffn_layers.\1.net.0."),
    (r"ffn_(\d+)/lin2/", r"ffn_layers.\1.net.3."),
    (r"ffn_(\d+)/norm/", r"ffn_layers.\1.norm."),
    (r"(bbox_embed|bbox_size_embed)_(\d+)/layers_(\d+)/", r"\1.\2.layers.\3."),
    (r"(ref_point_head|ref_anchor_head)/layers_(\d+)/", r"\1.layers.\2."),
    (r"dinox_ca_(\d+)/out_proj/",
     r"dinox_query_cross_attn_layers.\1.attn.out_proj."),
    (r"dinox_ca_(\d+)/norm/", r"dinox_query_cross_attn_layers.\1.norm."),
    (r"(\w+)/", r"\1."),
]
_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias"}


def export_decoder(tree):
    """A flat JAX decoder tree ({path: array} of ``params["decoder"]``) ->
    the reference decoder's state dict (``decoder.*``, torch layouts):
    Dense kernels transposed, LayerNorm scales as weights, the DINO-X
    cross-attention's q/k/v packed into ``in_proj_weight`` / ``_bias``."""
    sd, packed = {}, {}
    for path, arr in tree.items():
        m = re.match(r"dinox_ca_(\d+)/([qkv])_proj/(kernel|bias)$", path)
        if m:
            packed.setdefault((m[1], m[3]), {})[m[2]] = arr
            continue
        if path == "query_embed/embedding":
            sd["decoder.query_embed.weight"] = arr
            continue
        *mods, leaf = path.split("/")
        key = "/".join(mods) + "/"
        for pat, rep in _DEC_RENAMES:
            new, n = re.subn("^" + pat + "$", rep, key)
            if n:
                key = new
                break
        sd[f"decoder.{key}{_LEAVES[leaf]}"] = arr.T if leaf == "kernel" \
            else arr
    for (i, leaf), qkv in packed.items():
        name = "in_proj_weight" if leaf == "kernel" else "in_proj_bias"
        parts = [qkv[c].T if leaf == "kernel" else qkv[c] for c in "qkv"]
        sd[f"decoder.dinox_query_cross_attn_layers.{i}.attn.{name}"] = \
            np.concatenate(parts, 0)
    return sd


@pytest.fixture(scope="module")
def decoder_tree():
    """Seeded variables of a small JAX SegDINO3D (2 decoder layers,
    d_model = DINO-X width = 64), from its traced shapes."""
    load_jax_sparseplan()
    jmodel, _, _, _, _ = ge._build(
        n_points=1024, s_cap=S_CAP, i_cap=16, k2d=16, num_layers=2,
        d_model=D_MODEL, n_sem=20, n_inst_cls=18, feat2d=FEAT2D, init=False)
    spec = JC.PadSpec(1024, S_CAP, 16, 16, 20)
    rec = jax_scene(0, n_points=1000, n_superpoints=50, n_classes=18,
                    n_queries2d=12, feat_dim_2d=FEAT2D)
    variables = M._seeded_variables(jmodel, JC.collate([rec], spec))
    return {k: np.asarray(v) for k, v in
            _flatten(jax.device_get(variables["params"]["decoder"])).items()}


def test_decoder_exporter_round_trips_in_the_jax_package(decoder_tree):
    sd = export_decoder(decoder_tree)
    assert any("in_proj_weight" in k for k in sd)
    params, stats, unmapped = JI.import_state_dict(sd)
    assert unmapped == [] and stats == {}
    got = _flatten(params["decoder"])
    assert sorted(got) == sorted(decoder_tree)
    for k, v in decoder_tree.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_decoder_import_equals_jax_import(decoder_tree):
    sd = export_decoder(decoder_tree)
    got, unmapped = TI.import_state_dict(sd)
    assert unmapped == []
    assert_bit_equal(got, jax_side(sd))


# --------------------------------------------------------------------------
# a checkpoint file
# --------------------------------------------------------------------------

def v2_checkpoint():
    """(a reference-named state dict of the small v2 model as torch
    tensors, the port model it should load into)."""
    model, _ = build_model(V2_CFG, Capacities(num_superpoints=S_CAP),
                           device="cpu")
    tree = state_dict_to_jax(model.state_dict())
    unet = {"params": tree["params"]["backbone"]["unet"],
            "batch_stats": tree["batch_stats"]["backbone"]["unet"]}
    sd = build_spconv_torch_sd(_flatten(unet["params"]),
                               _flatten(unet["batch_stats"]),
                               np.random.RandomState(3))
    rng = np.random.RandomState(4)
    dec = {k: rng.randn(*v.shape).astype(np.float32)
           for k, v in _flatten(tree["params"]["decoder"]).items()}
    sd.update(export_decoder(dec))
    sd["backbone.output_layer.0.num_batches_tracked"] = np.asarray(7)
    for k in sd:
        if k.endswith("running_var"):
            sd[k] = np.abs(sd[k]) + 0.5
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in sd.items()}, model


def test_checkpoint_file_loads(tmp_path):
    sd, model = v2_checkpoint()
    path = str(tmp_path / "segdino3d_v2.pth")
    extra = {"decoder.unknown_head.weight": torch.ones(3)}
    torch.save({"model": {f"module.{k}": v
                          for k, v in {**sd, **extra}.items()},
                "epoch": 12}, path)
    loaded, unmapped = TI.load_reference_checkpoint(model, path)
    assert loaded is model
    assert unmapped == ["decoder.unknown_head.weight"]
    want, _ = TI.import_state_dict(sd)
    got = model.state_dict()
    assert_bit_equal({k: got[k] for k in want}, want)
    assert sorted(got) == sorted(want)

    # a bare state dict (no wrapper, no prefix) loads the same
    torch.save(sd, str(tmp_path / "bare.pth"))
    assert_bit_equal(TI.import_checkpoint(str(tmp_path / "bare.pth"))[0],
                     want)


def test_checkpoint_missing_key_raises(tmp_path):
    sd, model = v2_checkpoint()
    del sd["backbone.u.u.deconv.2.weight"]
    path = str(tmp_path / "partial.pth")
    torch.save({"model": sd}, path)
    with pytest.raises(KeyError, match="up_conv.2.kernel"):
        TI.load_reference_checkpoint(model, path)
    # a value of the wrong shape raises too
    sd, model = v2_checkpoint()
    sd["backbone.output_layer.0.weight"] = torch.ones(9)
    torch.save({"model": sd}, path)
    with pytest.raises(ValueError, match="output_norm.weight"):
        TI.load_reference_checkpoint(model, path)
