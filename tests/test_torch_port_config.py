"""The port's config system and registries against the JAX package's:
``Config.fromfile`` of every prototype, ``_base_`` override semantics, the
``--options`` merge, the dump round trip, the registries building each
prototype's readers and transforms, and ``Capacities.from_cfg``.

Configs must read to equal plain dicts; readers built from a prototype's
``data`` (roots pointed at tiny scenes written from seeds) must give
records bit-equal to the JAX readers built from the same node.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import segdino3d_tpu.data.scannet_dataset  # noqa: E402,F401 (registry)
import segdino3d_tpu.data.transforms  # noqa: E402,F401 (registry)
from segdino3d_tpu.builder import Capacities as JaxCapacities  # noqa: E402
from segdino3d_tpu.config.config import Config as JaxConfig  # noqa: E402
from segdino3d_tpu.registry import DATASETS as JDATASETS  # noqa: E402
from segdino3d_tpu.registry import TRANSFORMS as JTRANSFORMS  # noqa: E402
import segdino3d_tpu_torch.data.scannet_dataset  # noqa: E402,F401
from segdino3d_tpu_torch.builder import Capacities  # noqa: E402
from segdino3d_tpu_torch.config.config import Config, ConfigDict  # noqa: E402
from segdino3d_tpu_torch.registry import (DATASETS, TRANSFORMS,  # noqa: E402
                                          Registry)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROTOS = [
    "configs/prototypes/SegDINO3D_ScanNet200.py",
    "configs/prototypes/SegDINO3D_ScanNetv2.py",
    "configs/prototypes/Baseline_ScanNet200.py",
]


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    return x


@pytest.mark.parametrize("proto", PROTOS)
def test_prototype_reads_as_jax(proto):
    cfg = Config.fromfile(os.path.join(REPO, proto))
    want = JaxConfig.fromfile(os.path.join(REPO, proto))
    assert _plain(cfg) == _plain(want)
    assert isinstance(cfg.model.decoder_cfg, ConfigDict)
    assert cfg.scheduler["total_iters"] == cfg.num_iterations
    assert cfg.data["train_batch_size"] == 4
    assert cfg.data["worker_mode"] == "process"


def test_base_override_semantics(tmp_path):
    base = tmp_path / "base.py"
    base.write_text("model = dict(a=1, nested=dict(x=1, y=2))\nlr = 0.1\n"
                    "layers = [dict(k=1), dict(k=2)]\n")
    child = tmp_path / "child.py"
    child.write_text(
        "_base_ = ['base.py']\n"
        "_base_.model.nested.x = 5\n"
        "_base_.layers[1].k = 7\n"
        "extra = 'hi'\n"
        "model = dict(b=3, nested=dict(z=4))\n")
    replace = tmp_path / "replace.py"
    replace.write_text(
        "_base_ = 'base.py'\n"
        "model = dict(_delete_=True, c=9)\n")
    for path in (child, replace):
        got, want = Config.fromfile(str(path)), JaxConfig.fromfile(str(path))
        assert _plain(got) == _plain(want)
    cfg = Config.fromfile(str(child))
    assert cfg.model["nested"] == dict(x=5, y=2, z=4)
    assert cfg.model.a == 1 and cfg.model.b == 3
    assert cfg.layers[1].k == 7 and cfg.lr == 0.1 and cfg.extra == "hi"
    assert Config.fromfile(str(replace)).model == dict(c=9)
    with pytest.raises(FileNotFoundError):
        Config.fromfile(str(tmp_path / "missing.py"))


def test_options_merge_as_the_cli_parses_them():
    import train_3d as jax_cli
    from segdino3d_tpu_torch import train_3d as cli

    opts = ["model.lr=0.5", "num_iterations=20", "new.key=3",
            "name=abc", "t=(1, 2)", "flag=True"]
    parsed = cli.parse_options(opts)
    assert parsed == jax_cli.parse_options(opts)
    got = Config.fromdict(dict(model=dict(lr=1.0, keep=2),
                               num_iterations=10))
    want = JaxConfig.fromdict(dict(model=dict(lr=1.0, keep=2),
                                   num_iterations=10))
    got.merge_from_options(parsed)
    want.merge_from_options(parsed)
    assert _plain(got) == _plain(want)
    assert got.model == dict(lr=0.5, keep=2)
    assert got.num_iterations == 20 and got.new.key == 3
    assert got.name == "abc" and got.t == (1, 2) and got.flag is True


@pytest.mark.parametrize("proto", PROTOS)
def test_dump_round_trip(proto, tmp_path):
    cfg = Config.fromfile(os.path.join(REPO, proto))
    cfg.merge_from_options({"data.num_workers": 2})
    path = str(tmp_path / "dumped.py")
    cfg.dump(path)
    assert _plain(Config.fromfile(path)) == _plain(cfg)


def test_registry():
    reg = Registry("things")

    @reg.register_module()
    class Thing:
        def __init__(self, a, b=2):
            self.a, self.b = a, b

    reg.register_module("Alias", Thing)
    t = reg.build(dict(type="Alias", a=1), b=5)
    assert isinstance(t, Thing) and (t.a, t.b) == (1, 5)
    assert "Thing" in reg and reg.build(None) is None
    with pytest.raises(KeyError, match="not found"):
        reg.build(dict(type="Missing"))
    with pytest.raises(KeyError, match="has no 'type'"):
        reg.build(dict(a=1))
    with pytest.raises(KeyError, match="already registered"):
        reg.register_module("Thing", dict)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    from segdino3d_tpu_torch.data.synthetic import write_scannet_layout

    root = str(tmp_path_factory.mktemp("proto_layout"))
    write_scannet_layout(root, (0, 1), n_points=1500, n_superpoints=24,
                         n_classes=180, n_instances=4, n_queries2d=12,
                         feat_dim_2d=256)
    return root


@pytest.mark.parametrize("proto", PROTOS)
def test_registry_builds_the_prototypes_readers(proto, data_root):
    """Each prototype's train and eval reader nodes (the roots pointed at
    tiny scenes), built by each package's registry: records bit-equal
    under the same seeds, the transforms of the node's pipeline."""
    cfg = Config.fromfile(os.path.join(REPO, proto))
    for split in ("train_main", "eval_main"):
        node = dict(cfg.data[split][0])
        node["root_scenes"] = data_root
        if node.get("root_points_2dfeats"):
            node["root_points_2dfeats"] = os.path.join(data_root,
                                                       "features_2d")
        port, ref = DATASETS.build(node), JDATASETS.build(node)
        assert type(port).__name__ == node["type"]
        assert port.scene_set == node["scene_set"]
        assert len(port) == len(ref) == 2
        tpipe = TRANSFORMS.build(dict(node["transform_cfg"],
                                      scene_set=node["scene_set"]))
        jpipe = JTRANSFORMS.build(dict(node["transform_cfg"],
                                       scene_set=node["scene_set"]))
        assert [type(t).__name__ for t in tpipe.transforms] == \
            [type(t).__name__ for t in jpipe.transforms]
        for i in range(2):
            got = port.get_record(i, np.random.RandomState(i),
                                  sync_scale=1.05)
            want = ref.get_record(i, np.random.RandomState(i),
                                  sync_scale=1.05)
            assert got.keys() == want.keys()
            for k, v in want.items():
                if v is None or isinstance(v, (str, int)):
                    assert got[k] == v, k
                else:
                    assert np.asarray(got[k]).dtype == np.asarray(v).dtype
                    np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_capacities_from_cfg():
    cfg = Config.fromfile(os.path.join(REPO, PROTOS[0]))
    caps = Capacities.from_cfg(cfg.capacities)
    want = JaxCapacities.from_cfg(cfg.capacities)
    for f in ("num_points", "num_voxels", "num_superpoints",
              "num_instances", "num_queries2d"):
        assert getattr(caps, f) == getattr(want, f) == cfg.capacities[f], f
    assert caps.level_cap_ratios == Capacities().level_cap_ratios
    assert Capacities.from_cfg(None) == Capacities()
    small = Capacities.from_cfg(dict(num_points=4096, num_voxels=8192,
                                     level_cap_ratios=[1, 1, 1, 1, 1],
                                     not_a_field=3))
    assert small.num_points == 4096 and small.num_voxels == 8192
    assert small.level_cap_ratios == (1, 1, 1, 1, 1)
    assert dataclasses.replace(small, num_points=1).num_points == 1
