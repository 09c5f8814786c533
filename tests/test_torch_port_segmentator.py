"""Offline data preparation and the evaluator's files in both packages.

The port's segmentator binding (its own build of
``native/segmentator/segmentator.cpp``) against the JAX binding: equal
superpoint ids on the two-plane patches of ``tests/test_segmentator.py``
and on a seeded welded mesh of a few thousand vertices.  The port's
``tools/ply_io.py`` and ``tools/prepare_scannet.py`` against ``tools/``:
PLY files read alike and written byte-equal; ``export_scene`` and the
tool's command line write byte-equal files for a seeded synthetic scans
directory, a scene with the aggregation / segs json pair, a label map
and the axis-alignment txt and one with only the mesh and its labels
ply.  The evaluator's result shard, per-scene dump and the ScanNet
submission writers write byte-equal files on the same results.
"""
import json
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import ply_io as jax_ply  # noqa: E402
import prepare_scannet as jax_prep  # noqa: E402
from test_segmentator import grid_patch  # noqa: E402

from segdino3d_tpu.data.segmentator import \
    segment_mesh as jax_segment  # noqa: E402
from segdino3d_tpu.evaluation.evaluator import \
    InstanceSeg3DEvaluator as JaxEvaluator  # noqa: E402
from segdino3d_tpu_torch.data.scannet_constants import \
    SCANNET200_RAW_IDS  # noqa: E402
from segdino3d_tpu_torch.data.segmentator import segment_mesh  # noqa: E402
from segdino3d_tpu_torch.evaluation.evaluator import \
    InstanceSeg3DEvaluator  # noqa: E402
from segdino3d_tpu_torch.tools import ply_io, prepare_scannet  # noqa: E402


def welded_mesh(seed, nx=60, ny=50):
    """A seeded height field over an nx x ny grid: shared vertices, two
    triangles a cell, bumps and folds that give many segments."""
    rng = np.random.RandomState(seed)
    x, y = np.meshgrid(np.arange(nx) * 0.05, np.arange(ny) * 0.05)
    z = (0.3 * np.sin(3 * x + rng.rand()) * np.cos(2 * y)
         + np.where(x > 1.5, 0.8, 0.0) + 0.01 * rng.randn(ny, nx))
    verts = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    a = (np.arange(ny - 1)[:, None] * nx + np.arange(nx - 1)[None, :]).ravel()
    faces = np.concatenate([np.stack([a, a + 1, a + nx], 1),
                            np.stack([a + 1, a + nx + 1, a + nx], 1)])
    return verts, faces[rng.permutation(len(faces))].astype(np.int32)


def two_planes():
    v1, f1 = grid_patch(12, 12, (0, 0, 0), "z")
    v2, f2 = grid_patch(12, 12, (0, 0, 0), "x")
    return np.concatenate([v1, v2]), np.concatenate([f1, f2 + len(v1)])


@pytest.mark.parametrize("mesh,kthr,min_verts", [
    ("two_planes", 0.01, 5), ("two_planes", 0.01, 20),
    ("welded", 0.01, 20), ("welded", 0.05, 50), ("welded", 0.001, 5)])
def test_superpoints_match_jax(mesh, kthr, min_verts):
    verts, faces = two_planes() if mesh == "two_planes" else welded_mesh(3)
    got = segment_mesh(verts, faces, kthr=kthr, seg_min_verts=min_verts)
    want = jax_segment(verts, faces, kthr=kthr, seg_min_verts=min_verts)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    if mesh == "welded":
        assert len(np.unique(got)) > 2


def test_segmentator_refuses_bad_meshes():
    verts, faces = two_planes()
    with pytest.raises(ValueError, match="names a vertex"):
        segment_mesh(verts, faces + len(verts))
    with pytest.raises(ValueError, match=r"\(N, 3\)"):
        segment_mesh(verts[:, :2], faces)


def _scene_files(sdir, sid, seed, with_json, with_axis, n_labels=True):
    verts, faces = welded_mesh(seed, nx=40, ny=30)
    rng = np.random.RandomState(seed)
    colors = rng.randint(0, 256, (len(verts), 3)).astype(np.uint8)
    labels = np.asarray(SCANNET200_RAW_IDS)[
        rng.randint(0, 12, len(verts))].astype(np.uint16)
    os.makedirs(sdir)
    jax_ply.write_ply(os.path.join(sdir, f"{sid}_vh_clean_2.ply"), verts,
                      faces, colors)
    if n_labels:
        ply_io.write_ply(os.path.join(sdir, f"{sid}_vh_clean_2.labels.ply"),
                         verts, faces, colors, labels=labels)
    if with_json:
        seg = (np.arange(len(verts)) * 7 // len(verts)).tolist()
        with open(os.path.join(
                sdir, f"{sid}_vh_clean_2.0.010000.segs.json"), "w") as f:
            json.dump({"segIndices": seg}, f)
        with open(os.path.join(sdir, f"{sid}.aggregation.json"), "w") as f:
            json.dump({"segGroups": [
                {"objectId": i, "label": ["chair", "table", "door"][i % 3],
                 "segments": [i, i + 3] if i < 3 else [i]}
                for i in range(6)]}, f)
    if with_axis:
        m = np.eye(4)
        m[:3, :3] = [[0, -1, 0], [1, 0, 0], [0, 0, 1]]
        m[:3, 3] = rng.randn(3)
        with open(os.path.join(sdir, f"{sid}.txt"), "w") as f:
            f.write("sceneType = Bedroom\naxisAlignment = "
                    + " ".join(f"{v:.6f}" for v in m.ravel()) + "\n")


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scans"))
    _scene_files(os.path.join(root, "scene0000_00"), "scene0000_00", 0,
                 with_json=True, with_axis=True)
    _scene_files(os.path.join(root, "scene0001_00"), "scene0001_00", 1,
                 with_json=False, with_axis=False)
    _scene_files(os.path.join(root, "scene0002_00"), "scene0002_00", 2,
                 with_json=True, with_axis=False, n_labels=False)
    tsv = os.path.join(root, "labels.tsv")
    with open(tsv, "w") as f:
        f.write("raw_category\tid\nchair\t5\ntable\t7\ndoor\tx\n")
    return root, tsv


def _tree_bytes(root):
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            p = os.path.join(d, name)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def test_ply_io_matches_jax(scans, tmp_path):
    root, _ = scans
    mesh = os.path.join(root, "scene0000_00", "scene0000_00_vh_clean_2.ply")
    labels = mesh.replace(".ply", ".labels.ply")
    for path in (mesh, labels):
        got, want = ply_io.read_ply(path), jax_ply.read_ply(path)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], k)
    assert "labels" in ply_io.read_ply(labels)
    m = jax_ply.read_ply(mesh)
    for kw in (dict(faces=m["faces"], colors=m["colors"]),
               dict(colors=m["colors"]), dict(faces=m["faces"]), {}):
        a, b = str(tmp_path / "a.ply"), str(tmp_path / "b.ply")
        ply_io.write_ply(a, m["vertices"], **kw)
        jax_ply.write_ply(b, m["vertices"], **kw)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), sorted(kw)
    # an ascii file with a quad, read row by row by both
    ascii_p = str(tmp_path / "ascii.ply")
    with open(ascii_p, "w") as f:
        f.write("ply\nformat ascii 1.0\ncomment x\nelement vertex 4\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property uchar red\nproperty uchar green\n"
                "property uchar blue\nelement face 2\n"
                "property list uchar int vertex_indices\nend_header\n"
                "0 0 0 1 2 3\n1 0 0 4 5 6\n0 1 0 7 8 9\n1 1 0 1 1 1\n"
                "3 0 1 2\n3 1 3 2\n")
    got, want = ply_io.read_ply(ascii_p), jax_ply.read_ply(ascii_p)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], k)


@pytest.mark.parametrize("scene", ["scene0000_00", "scene0001_00",
                                   "scene0002_00"])
def test_export_scene_matches_jax(scans, tmp_path, scene):
    root, tsv = scans
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    assert prepare_scannet.export_scene(root, scene, a, tsv)
    assert jax_prep.export_scene(root, scene, b, tsv)
    got, want = _tree_bytes(a), _tree_bytes(b)
    assert sorted(got) == sorted(want) == sorted(
        f"{sub}/{scene}.bin" for sub in ("points", "instance_mask",
                                         "semantic_mask", "super_points"))
    for k in want:
        assert got[k] == want[k], k
    inst = np.fromfile(os.path.join(a, "instance_mask", f"{scene}.bin"),
                       np.int64)
    assert (inst >= 0).any() == (scene != "scene0001_00")
    assert not prepare_scannet.export_scene(root, "missing", a)


def test_prepare_scannet_cli_matches_jax(scans, tmp_path, monkeypatch):
    """The command line: every scene with two spawned workers, then the
    split list; and copied split lists with ``--splits_dir``."""
    root, tsv = scans
    scans_dir = str(tmp_path / "scans")
    os.makedirs(scans_dir)
    for s in ("scene0000_00", "scene0001_00"):
        os.symlink(os.path.join(root, s), os.path.join(scans_dir, s))
    splits = str(tmp_path / "splits")
    os.makedirs(splits)
    with open(os.path.join(splits, "scannetv2_val.txt"), "w") as f:
        f.write("scene0001_00\n")
    for extra in ([], ["--splits_dir", splits]):
        a = str(tmp_path / f"port{len(extra)}")
        b = str(tmp_path / f"jax{len(extra)}")
        args = ["--scans_dir", scans_dir, "--label_map", tsv] + extra
        assert prepare_scannet.main(args + ["--output_dir", a,
                                            "--num_workers", "2"]) == 0
        monkeypatch.setattr(sys, "argv", ["prepare_scannet.py"] + args + [
            "--output_dir", b, "--num_workers", "1"])
        jax_prep.main()
        assert _tree_bytes(a) == _tree_bytes(b)
    assert os.listdir(os.path.join(a, "meta_data")) == ["scannetv2_val.txt"]


def _results(seed, n_scenes=3, n_pts=300, n_cls=6):
    rng = np.random.RandomState(seed)
    out = []
    for s in range(n_scenes):
        inst = rng.randint(-1, 5, n_pts)
        sem = np.where(inst >= 0, rng.randint(2, n_cls, n_pts), 1)
        k = rng.randint(1, 5)
        out.append((
            dict(pts_instance_mask=(inst + 2).astype(np.int64),
                 pts_semantic_mask=sem.astype(np.int64),
                 lidar_idx=f"scene{s:04d}_00"),
            dict(pts_instance_masks=rng.rand(k, n_pts) > 0.6,
                 instance_labels=rng.randint(0, n_cls - 2, k),
                 instance_scores=rng.rand(k).astype(np.float32),
                 pts_semantic_mask=rng.randint(-1, n_cls + 1, n_pts),
                 pts_panoptic_sem=rng.randint(0, n_cls, n_pts),
                 pts_panoptic_inst=rng.randint(0, 4, n_pts))))
    return out


def test_evaluator_files_match_jax(tmp_path):
    """The shard pickle, the per-scene metrics json and the instance and
    semantic submission files, byte for byte."""
    ids = [1, 2, 5, 7, 9, 11]
    names = ["wall", "floor", "a", "b", "c", "d"]
    trees = {}
    for tag, cls in (("port", InstanceSeg3DEvaluator),
                     ("jax", JaxEvaluator)):
        out = tmp_path / tag
        ev = cls(ids, names,
                 submission_prefix_instance=str(out / "instance"),
                 submission_prefix_semantic=str(out / "semantic"))
        for ann, pred in _results(0):
            ev.process(ann, pred)
        ev.save_shard(str(out / "gather"), 3)
        per_scene = ev.evaluate_per_scene(str(out / "per_scene.json"))
        assert ev.evaluate() == {}       # the instance files instead
        ev.format_results_semantic()
        trees[tag] = (_tree_bytes(str(out)), per_scene)
    (got, got_scene), (want, want_scene) = trees["port"], trees["jax"]
    assert sorted(got) == sorted(want)
    assert len([k for k in got if "predicted_masks" in k]) > 3
    for k in want:
        assert got[k] == want[k], k
    np.testing.assert_equal(got_scene, want_scene)
    # the shard reads back, in rank order behind the others
    ev = InstanceSeg3DEvaluator(ids, names)
    for p in range(3):
        InstanceSeg3DEvaluator(ids, names).save_shard(
            str(tmp_path / "port" / "gather"), p)
    ev.load_shards(str(tmp_path / "port" / "gather"), 4)
    assert [a["lidar_idx"] for a, _ in ev._results] == [
        f"scene{s:04d}_00" for s in range(3)]
