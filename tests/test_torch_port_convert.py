"""The weight carrier on the full-width flagship tree, and the port's hygiene.

* ``convert.load_jax_variables`` uses every leaf of the flagship SegDINO3D
  variables exactly once and raises on an extra or a missing leaf;
  ``state_dict_to_jax`` carries them back unchanged;
* no file of the port (nor ``chip_smoke.py``) imports ``jax``, ``flax``,
  ``optax`` or ``segdino3d_tpu``: by its source, and by importing it in a
  subprocess where those modules cannot load;
* the entry point raises on a host with no CUDA device unless the caller
  asks for the CPU.
"""
import ast
import copy
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import __graft_entry__ as ge  # noqa: E402
from segdino3d_tpu.data.collate import PadSpec, collate  # noqa: E402
from segdino3d_tpu.data.synthetic import synthetic_scene  # noqa: E402
from segdino3d_tpu_torch.builder import Capacities, build_model  # noqa: E402
from segdino3d_tpu_torch.convert import (jax_to_state_dict,  # noqa: E402
                                         load_jax_variables,
                                         state_dict_to_jax)
from segdino3d_tpu_torch.device import resolve_device  # noqa: E402

PORT_DIR = os.path.join(ROOT, "segdino3d_tpu_torch")
FLAGSHIP_CFG = dict(
    type="SegDINO3D",
    pointcloud_backbone_cfg=dict(
        type="Res16UNet34C", in_channels=259, out_channels=96,
        voxel_size=0.02, block_edges=(4, 4, 4, 4, 4), stem_gather=True,
        config=dict(conv1_kernel_size=5, bn_momentum=0.02)),
    decoder_cfg=dict(type="ScanNetQueryDecoder", num_layers=6,
                     num_instance_classes=198, num_semantic_classes=200,
                     in_channels=96, d_model=256, num_heads=8,
                     hidden_dim=1024, dropout=0.0, temperature=20))


@pytest.fixture(scope="module")
def flagship_variables():
    """Zero leaves shaped like the flagship tree (shapes only: no init)."""
    model, _, _, _, _ = ge._build(init=False)
    spec = PadSpec(1024, 64, 16, 16, 200)
    batch = collate([synthetic_scene(0, n_points=1000, n_superpoints=64,
                                     n_classes=18, n_queries2d=12)], spec)
    shapes = jax.eval_shape(
        lambda b: model.init({"params": jax.random.PRNGKey(0),
                              "queries": jax.random.PRNGKey(1)}, b, False),
        batch)
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  dict(shapes))


def _port_model():
    model, _ = build_model(FLAGSHIP_CFG, Capacities(), device="cpu")
    return model


def test_carrier_uses_every_flagship_leaf_once(flagship_variables):
    n_leaves = len(jax.tree_util.tree_leaves(flagship_variables))
    sd = jax_to_state_dict(flagship_variables)
    assert len(sd) == n_leaves
    model = load_jax_variables(_port_model(), flagship_variables)
    assert set(sd) == set(model.state_dict())
    # Dense kernels are transposed; sparse-conv kernels keep their layout
    w = flagship_variables["params"]["decoder"]["ffn_0"]["lin1"]["kernel"]
    assert tuple(model.decoder.ffn[0].lin1.weight.shape) == w.T.shape
    k = flagship_variables["params"]["backbone"]["unet"]["conv0p1s1"]["kernel"]
    assert tuple(model.backbone.unet.conv0p1s1.kernel.shape) == k.shape \
        == (125, 259, 32)


def test_carrier_round_trips_to_the_jax_tree(flagship_variables):
    """params and batch_stats go back to the JAX layout leaf for leaf."""
    model = load_jax_variables(_port_model(), flagship_variables)
    back = state_dict_to_jax(model.state_dict())
    want = jax.tree_util.tree_flatten_with_path(flagship_variables)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], leaf, err_msg=str(path))


@pytest.mark.parametrize("fault", ["extra_leaf", "missing_leaf",
                                   "wrong_shape"])
def test_carrier_raises_on_mismatch(flagship_variables, fault):
    bad = copy.deepcopy(flagship_variables)
    ffn = bad["params"]["decoder"]["ffn_0"]
    if fault == "extra_leaf":
        ffn["lin3"] = {"kernel": np.zeros((4, 4), np.float32)}
    elif fault == "missing_leaf":
        del ffn["lin2"]["bias"]
    else:
        ffn["lin2"]["bias"] = np.zeros(7, np.float32)
    with pytest.raises((KeyError, ValueError)):
        load_jax_variables(_port_model(), bad)


def _port_sources():
    for dirpath, _, files in os.walk(PORT_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_port_sources_import_no_jax():
    banned = ("jax", "flax", "optax", "segdino3d_tpu")
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in banned, f"{path} imports {name}"


def test_port_imports_with_jax_unavailable():
    modules = sorted(
        os.path.relpath(p, ROOT)[:-3].replace(os.sep, ".").removesuffix(
            ".__init__") for p in _port_sources())
    code = ("import sys\n"
            "for m in ('jax', 'flax', 'optax', 'segdino3d_tpu'):\n"
            "    sys.modules[m] = None\n"
            f"sys.path.insert(0, {ROOT!r})\n"
            f"for m in {modules!r}:\n"
            "    __import__(m)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_entry_point_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(FLAGSHIP_CFG, Capacities())
    assert resolve_device("cpu") == torch.device("cpu")
