"""The training data path in both packages: the training augmentations,
the train pipeline, the readers' train records, ``ConcatDataset``, the
``TrainLoader`` in its three worker modes and the shared-memory transport.

Inputs come from numpy seeds (arrays, and tiny scenes written with
``write_scannet_layout``); each package draws from its own
``np.random.RandomState`` of the same seed.  Every comparison is exact:
records, batches and host plans bit-equal to the JAX package's.
"""
import os
import sys
import time

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from test_torch_port_jaxlib import load_jax_sparseplan  # noqa: E402

import segdino3d_tpu.data.scannet_dataset  # noqa: E402,F401 (registry)
from segdino3d_tpu.data import collate as JC  # noqa: E402
from segdino3d_tpu.data import loader as JL  # noqa: E402
from segdino3d_tpu.data import transforms as JT  # noqa: E402
from segdino3d_tpu.registry import DATASETS as JDATASETS  # noqa: E402
from segdino3d_tpu_torch.data import collate as TC  # noqa: E402
from segdino3d_tpu_torch.data import loader as TL  # noqa: E402
from segdino3d_tpu_torch.data import shm_transport as TS  # noqa: E402
from segdino3d_tpu_torch.data import transforms as TT  # noqa: E402
from segdino3d_tpu_torch.data.synthetic import (  # noqa: E402
    synthetic_scene, write_scannet_layout)
from segdino3d_tpu_torch.registry import DATASETS  # noqa: E402

LAYOUT = dict(n_points=1500, n_superpoints=24, n_classes=16, n_instances=4,
              n_queries2d=12, feat_dim_2d=8)
SEEDS = (0, 1, 2)
N_SEM = 16
PLAN = dict(voxel_size=0.05, voxel_cap=4096, block_edges=(4, 4, 4, 4, 4))
BATCH_FIELDS = ("points", "point_valid", "superpoint_ids", "num_superpoints",
                "points_2dfeats", "query2d_feats", "query2d_pos",
                "query2d_valid", "elastic_coords", "inst_labels",
                "inst_valid", "point_inst_ids", "sp_inst_masks",
                "sp_sem_masks", "scene_idx")


@pytest.fixture(scope="module", autouse=True)
def _setup():
    load_jax_sparseplan()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train_layout"))
    write_scannet_layout(root, SEEDS, **LAYOUT)
    return root


def _reader_cfg(root, cls="ScanNet200InstanceSeg3D", **kw):
    return dict(dict(type=cls, scene_set="train", root_scenes=root,
                     adjust_class_ids=False, exclude_stuffs=False,
                     num_semantic_classes=N_SEM,
                     root_points_2dfeats=os.path.join(root, "features_2d"),
                     dropout_rate_2dfeats=0.7,
                     transform_cfg=dict(type="Scannet200Transforms",
                                        voxel_size=0.05)), **kw)


def _assert_equal(got, want, what=""):
    """Arrays (numpy or torch) equal in dtype, shape and every bit."""
    a = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    b = np.asarray(want)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype,
                                                       b.dtype, a.shape,
                                                       b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _assert_records_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if want[k] is None:
            assert got[k] is None, k
        elif isinstance(want[k], (str, int)):
            assert got[k] == want[k], k
        else:
            _assert_equal(got[k], want[k], k)


# --------------------------------------------------------------------------
# the transforms
# --------------------------------------------------------------------------

def _inputs(seed, q2d):
    rng = np.random.RandomState(seed)
    points = np.concatenate([rng.uniform(-2, 2, (400, 3)),
                             rng.uniform(0, 255, (400, 3))],
                            1).astype(np.float32)
    target = {"extra_features": {"query2d_pos": rng.uniform(
        -2, 2, (9, 3)).astype(np.float32) if q2d else None}}
    return points, target


TRANSFORMS = {
    "flip": lambda m: m.RandomFlip3D(0.5, 0.5),
    "rot_scale_trans": lambda m: m.GlobalRotScaleTrans(),
    "normalize": lambda m: m.NormalizePointsColor(m.SCANNET_COLOR_MEAN,
                                                  m.SCANNET_COLOR_STD),
    # p = 1: both noise scales every time
    "elastic": lambda m: m.ElasticTransform((6, 20), (40, 160), 0.05, p=1.0),
    "elastic_p05": lambda m: m.ElasticTransform(voxel_size=0.02),
    "train_pipeline": lambda m: m.Scannet200Transforms("train",
                                                       voxel_size=0.05),
    "val_pipeline": lambda m: m.Scannet200Transforms("val"),
}


@pytest.mark.parametrize("preset_scale", [None, 1.15],
                         ids=["drawn_scale", "preset_scale"])
@pytest.mark.parametrize("q2d", [True, False], ids=["query2d", "no_query2d"])
@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_jax(name, q2d, preset_scale):
    """Each transform (and the train factory) on the same arrays and the
    same ``RandomState``: points, every target entry and the generator's
    state after it, bit-equal, over several seeds."""
    for seed in range(4):
        outs = []
        for mod in (TT, JT):
            points, target = _inputs(seed, q2d)
            if preset_scale is not None:
                target["pcd_scale_factor"] = preset_scale
            rng = np.random.RandomState(100 + seed)
            points, target = TRANSFORMS[name](mod)(points, target, rng)
            outs.append((points, target, rng.rand()))
        (tp, tt, tr), (jp, jt, jr) = outs
        _assert_equal(tp, jp, "points")
        assert tr == jr, "the generators' states differ"
        assert tt.keys() == jt.keys()
        for k in jt:
            if k == "extra_features":
                assert tt[k].keys() == jt[k].keys()
                for kk, v in jt[k].items():
                    if v is None:
                        assert tt[k][kk] is None
                    else:
                        _assert_equal(tt[k][kk], v, kk)
            elif isinstance(jt[k], np.ndarray):
                _assert_equal(tt[k], jt[k], k)
            else:
                assert tt[k] == jt[k], k
        if preset_scale is not None and "pcd_scale_factor" in tt:
            assert tt["pcd_scale_factor"] == preset_scale


def test_train_pipeline_registered():
    from segdino3d_tpu_torch.registry import TRANSFORMS as REG

    for name in ("Scannet200Transforms", "ScannetTransforms"):
        pipe = REG.build(dict(type=name, scene_set="train", voxel_size=0.05))
        assert [type(t) for t in pipe.transforms] == [
            TT.RandomFlip3D, TT.GlobalRotScaleTrans, TT.NormalizePointsColor,
            TT.ElasticTransform]
        assert pipe.transforms[-1].voxel_size == 0.05
    with pytest.raises(ValueError):
        TT.Scannet200Transforms("trainval")


# --------------------------------------------------------------------------
# the readers' train records
# --------------------------------------------------------------------------

@pytest.mark.parametrize("sync_scale", [None, 0.93],
                         ids=["drawn_scale", "sync_scale"])
@pytest.mark.parametrize("cls", ["ScanNet200InstanceSeg3D",
                                 "ScanNetInstanceSeg3D"])
def test_train_records_match_jax(data_root, cls, sync_scale):
    """Train records (DINO-X query dropout 0.7, the train pipeline, a
    sync scale or a drawn one) bit-equal to the JAX reader's, label
    adjustment and stuff exclusion on."""
    cfg = _reader_cfg(data_root, cls, adjust_class_ids=True,
                      exclude_stuffs=True)
    port, ref = DATASETS.build(cfg), JDATASETS.build(cfg)
    assert port.cache_fingerprint() == ref.cache_fingerprint()
    for i in range(len(SEEDS)):
        for seed in range(3):
            got = port.get_record(i, np.random.RandomState(seed),
                                  sync_scale=sync_scale)
            want = ref.get_record(i, np.random.RandomState(seed),
                                  sync_scale=sync_scale)
            _assert_records_equal(got, want)
            assert got["query2d_pos"].shape[0] == int(
                LAYOUT["n_queries2d"] * 0.3)


# --------------------------------------------------------------------------
# ConcatDataset and the TrainLoader
# --------------------------------------------------------------------------

class _Calls:
    """A reader that records its calls (idx, sync_scale)."""

    def __init__(self, n, seed_base=0):
        self.n, self.seed_base, self.calls = n, seed_base, []

    def __len__(self):
        return self.n

    def get_record(self, idx, rng, sync_scale=None):
        self.calls.append((idx, sync_scale))
        return synthetic_scene(self.seed_base + idx, n_points=300,
                               n_superpoints=16, n_classes=8, n_queries2d=4,
                               feat_dim_2d=4)


def test_concat_dataset_routing():
    a, b = _Calls(3), _Calls(5, 100)
    for cat in (TL.ConcatDataset([a, b]), JL.ConcatDataset([a, b])):
        a.calls.clear()
        b.calls.clear()
        assert len(cat) == 8
        for i in (2, 3, 7):
            cat.get_record(i, np.random.RandomState(0), sync_scale=1.1)
        assert a.calls == [(2, 1.1)]
        assert b.calls == [(0, 1.1), (4, 1.1)]
    port = TL.ConcatDataset([a, b]).get_record(6, np.random.RandomState(0))
    want = JL.ConcatDataset([a, b]).get_record(6, np.random.RandomState(0))
    _assert_records_equal(port, want)


def _spec(mod):
    return mod.PadSpec(2048, 32, 8, 16, N_SEM)


def _jax_batches(data_root, n, **kw):
    ds = JDATASETS.build(_reader_cfg(data_root))
    loader = JL.TrainLoader(ds, 2, _spec(JC), seed=3, num_workers=0,
                            host_plan_cfg=PLAN, **kw)
    loader._device = False
    it = iter(loader)
    return [next(it) for _ in range(n)]


def _assert_batch_equal(tb, jb, pad_ok=False):
    """A port ``SceneBatch`` (its host plan too) against a JAX numpy-leaf
    batch; with ``pad_ok`` the JAX leaves may be longer, padded with the
    stacking fill (-1 for integers, else 0) past the port's shape."""

    def cmp(got, want, what):
        if got is None or want is None:
            assert got is None and want is None, what
            return
        got = got.numpy()
        want = np.asarray(want)
        if pad_ok and got.shape != want.shape:
            assert got.ndim == want.ndim and all(
                g <= w for g, w in zip(got.shape, want.shape)), what
            fill = -1 if np.issubdtype(want.dtype, np.integer) else 0
            rest = want.copy()
            rest[tuple(slice(0, g) for g in got.shape)] = fill
            assert (rest == fill).all(), what
            want = want[tuple(slice(0, g) for g in got.shape)]
        _assert_equal(got, want, what)

    for k in BATCH_FIELDS:
        cmp(getattr(tb, k), getattr(jb, k), k)
    tp, jp = tb.plan, jb.unet_plan
    cmp(tp.inverse, jb.plan_inverse_mapping, "inverse")
    for li, (tl, jl) in enumerate(zip(tp.levels, jp.levels)):
        cmp(tl.valid, jl.valid, f"valid {li}")
        cmp(tl.nbr, jp.subm_nbr[li], f"nbr {li}")
        cmp(tl.parent, jl.parent_idx, f"parent {li}")
        cmp(tl.kpos, jl.parent_kpos, f"kpos {li}")
    cmp(tp.stem_nbr, jp.stem_nbr, "stem_nbr")
    assert (tp.blocks is None) == (jp.blocks is None)
    for tbl, jbl in zip(tp.blocks or [], jp.blocks or []):
        assert (tbl is None) == (jbl is None)
        if tbl is not None:
            assert tbl.edge == jbl.edge
            for k in ("vox_slot", "block_nbr", "slot_vox"):
                cmp(getattr(tbl, k), getattr(jbl, k), k)


MODES = {"sync": dict(num_workers=0),
         "thread": dict(num_workers=2, worker_mode="thread"),
         "process_shm": dict(num_workers=2, worker_mode="process",
                             shm_transport=True),
         "process_queue": dict(num_workers=2, worker_mode="process",
                               shm_transport=False)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_train_loader_matches_jax(data_root, mode, monkeypatch):
    """The first three batches (records through the train pipeline, sync
    scale, collate, block-dense host plans) bit-equal to the JAX
    ``TrainLoader``'s numpy-leaf batches from the same seed, in each
    worker mode (shared memory forced on these small batches)."""
    monkeypatch.setenv("SEGDINO_SHM_MIN_BYTES", "1")
    seen = []
    track = TS.track

    def spy(item):    # the segments the consumer receives
        if isinstance(item, TS.ShmBatch):
            seen.append(item.name.lstrip("/"))
        return track(item)

    monkeypatch.setattr(TS, "track", spy)
    want = _jax_batches(data_root, 3)
    loader = TL.TrainLoader(DATASETS.build(_reader_cfg(data_root)), 2,
                            _spec(TC), seed=3, host_plan_cfg=PLAN,
                            device="cpu", **MODES[mode])
    it = iter(loader)
    got = [next(it) for _ in range(3)]
    for tb, jb in zip(got, want):
        _assert_batch_equal(tb, jb)
    it.close()
    # earlier batches stay intact (each in its own segment), and no
    # segment outlives the loader
    _assert_batch_equal(got[0], want[0])
    assert bool(seen) == (mode == "process_shm")
    assert not set(seen) & set(os.listdir("/dev/shm"))


def test_microbatch_list_matches_jax_stacked_shards(data_root):
    """``mesh_shards=2``: a list of two ``SceneBatch``es with their own
    host plans, each equal to its shard of the JAX loader's stacked batch
    (whose plan tables are padded to the larger shard)."""
    ds = DATASETS.build(_reader_cfg(data_root))
    want = _jax_batches(data_root, 2, mesh_shards=2)
    it = iter(TL.TrainLoader(ds, 2, _spec(TC), seed=3, num_workers=0,
                             host_plan_cfg=PLAN, mesh_shards=2,
                             device="cpu"))
    for jb in want:
        got = next(it)
        assert isinstance(got, list) and len(got) == 2
        for i, tb in enumerate(got):
            assert tb.batch_size == 1
            _assert_batch_equal(
                tb, jax.tree_util.tree_map(lambda x: np.asarray(x)[i], jb),
                pad_ok=True)
    with pytest.raises(ValueError, match="multiple of mesh_shards"):
        TL.TrainLoader(ds, 3, _spec(TC), mesh_shards=2, device="cpu")


def test_process_shards_are_disjoint_and_match_jax():
    """Two processes' index streams: disjoint within an epoch, and the
    same (indices, sync scales) as the JAX loader's."""
    seen = {}
    for pi in range(2):
        for mod in (TL, JL):
            ds = _Calls(9)
            kw = dict(device="cpu") if mod is TL else {}
            loader = mod.TrainLoader(ds, 2, _spec(TC if mod is TL else JC),
                                     seed=7, num_workers=0,
                                     process_index=pi, process_count=2, **kw)
            if mod is JL:
                loader._device = False
            it = iter(loader)
            next(it)
            next(it)
            seen[pi, mod.__name__] = ds.calls
        assert seen[pi, TL.__name__] == seen[pi, JL.__name__]
    idx = [{i for i, _ in seen[pi, TL.__name__]} for pi in range(2)]
    assert len(idx[0]) == 4 and idx[0].isdisjoint(idx[1])


@pytest.mark.parametrize("die", [False, True], ids=["raises", "dies"])
def test_process_worker_failure_raised_in_consumer(die):
    """A worker's exception is re-raised in the consumer; a worker that
    dies is reported there too; the pool shuts down after either."""
    from torch_port_procs import FailingDS

    loader = TL.TrainLoader(FailingDS(die), 4, TC.PadSpec(512, 16, 16, 8, 8),
                            seed=0, num_workers=2, worker_mode="process",
                            device="cpu")
    it = iter(loader)
    match = "exited with code 3" if die else "boom at idx 5"
    with pytest.raises((ValueError, RuntimeError), match=match):
        for _ in range(4):   # idx 5 comes within the first two epochs
            next(it)
    it.close()


def test_process_worker_that_sends_nothing_raises_after_the_deadline():
    """Workers that are alive but send no batch within
    ``receive_timeout_s``: the consumer raises, naming the workers and
    the batch it waited for, and the pool shuts down after."""
    from torch_port_procs import StuckDS

    loader = TL.TrainLoader(StuckDS(3.0), 1, TC.PadSpec(512, 16, 16, 8, 8),
                            seed=0, num_workers=2, worker_mode="process",
                            prefetch=0, device="cpu", receive_timeout_s=1.0)
    it = iter(loader)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"workers \[\d+, \d+\], waiting "
                                           r"for batch 0: nothing within "
                                           r"1.0 s"):
        next(it)
    assert time.monotonic() - t0 < 30.0
    it.close()


def test_thread_producer_that_sends_nothing_raises_after_the_deadline():
    from torch_port_procs import StuckDS

    loader = TL.TrainLoader(StuckDS(2.0), 2, TC.PadSpec(512, 16, 16, 8, 8),
                            seed=0, num_workers=2, worker_mode="thread",
                            prefetch=1, device="cpu", receive_timeout_s=0.5)
    it = iter(loader)
    with pytest.raises(RuntimeError, match="nothing within 0.5 s"):
        next(it)
    it.close()


def test_shm_round_trip_leaves_no_segment(monkeypatch):
    """A batch's numpy leaves through a shared-memory segment and back:
    equal, views into the mapping; the name unlinked at decode and the
    mapping closed by the graveyard once the views are gone."""
    rng = np.random.RandomState(0)
    tree = dict(a=rng.randn(64, 3).astype(np.float32),
                b=[np.arange(10, dtype=np.int32), (np.ones(5, bool), 3)],
                c="scene")
    item = TS.encode(tree, min_bytes=1)
    assert isinstance(item, TS.ShmBatch)
    name = item.name.lstrip("/")
    assert name in os.listdir("/dev/shm")
    TS.track(item)
    back, shm = TS.decode(item)
    assert name not in os.listdir("/dev/shm")
    _assert_equal(back["a"], tree["a"])
    _assert_equal(back["b"][0], tree["b"][0])
    _assert_equal(back["b"][1][0], tree["b"][1][0])
    assert back["b"][1][1] == 3 and back["c"] == "scene"
    grave = TS.Graveyard()
    grave.add(shm)
    grave.sweep()
    assert len(grave._pending) == 1      # views still alive
    del back
    grave.sweep()
    assert not grave._pending
    small = TS.encode(tree)              # below MIN_SHM_BYTES: inline
    assert small is tree
    assert TS.decode(small) == (tree, None)


def test_shm_batch_past_the_free_space_raises(monkeypatch):
    """A batch larger than the free space of /dev/shm raises with both
    sizes and creates no segment (a mapping past the end of the tmpfs
    would end in SIGBUS); the queue transport is not taken instead."""
    tree = dict(a=np.zeros((64, 3), np.float32))
    before = set(os.listdir("/dev/shm"))
    monkeypatch.setattr(TS, "shm_free_bytes", lambda: 100)
    with pytest.raises(TS.ShmSpaceError, match="768-byte batch .* has 100 "
                                               "bytes free"):
        TS.encode(tree, min_bytes=1)
    assert set(os.listdir("/dev/shm")) == before
