"""The port's training engine around the step: checkpoints (round trip,
keep-5 rotation, the pretrained merge, the writer's host copy), the train
loop's SIGTERM handling, and the eval batch cache.

Checkpoints must restore every parameter, batch-norm buffer, AdamW moment
and count and the EMA shadow bit-equal; cached eval batches must be
bit-equal to freshly built ones, as ``tests/test_eval_cache.py`` holds the
JAX cache.
"""
import os
import sys
import time

import numpy as np
import pytest
import torch
from torch import nn

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from segdino3d_tpu_torch.train import checkpoint as CK  # noqa: E402
from segdino3d_tpu_torch.train.ema import EMA  # noqa: E402
from segdino3d_tpu_torch.train.optim import build_optimizer  # noqa: E402


class _Net(nn.Module):
    def __init__(self):
        super().__init__()
        self.backbone = nn.Sequential(nn.Linear(4, 6), nn.BatchNorm1d(6))
        self.head = nn.Linear(6, 3)

    def forward(self, x):
        return self.head(torch.relu(self.backbone(x)))


def _state(seed=0, ema=True):
    torch.manual_seed(seed)
    model = _Net()
    opt = build_optimizer(model.named_parameters(),
                          dict(lr=1e-2, lr_backbone=5e-3, weight_decay=0.05),
                          dict(total_iters=10), clip_max_norm=1.0)
    return CK.TrainState(model, opt, EMA(model.named_parameters(), 0.9)
                         if ema else None)


def _train(state, steps, seed=1):
    gen = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        x = torch.randn(8, 4, generator=gen)
        state.optimizer.zero_grad()
        state.model(x).square().mean().backward()
        state.optimizer.step()
        state.ema.update()


def _assert_states_equal(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert a.step == b.step == a.optimizer.count
    for ma, mb in zip(a.optimizer.mu + a.optimizer.nu,
                      b.optimizer.mu + b.optimizer.nu):
        for x, y in zip(ma, mb):
            assert torch.equal(x, y)
    for k in a.ema.shadow:
        assert torch.equal(a.ema.shadow[k], b.ema.shadow[k]), k


def test_checkpoint_round_trip_bit_equal(tmp_path):
    state = _state()
    _train(state, 3)
    assert state.step == 3
    CK.save_checkpoint(str(tmp_path), state)
    fresh = _state(seed=5)
    assert not torch.equal(fresh.model.head.weight, state.model.head.weight)
    assert CK.restore_checkpoint(str(tmp_path), fresh) is fresh
    _assert_states_equal(state, fresh)
    # the batch norm's running statistics moved and came back
    assert not torch.equal(state.model.backbone[1].running_mean,
                           torch.zeros(6))
    # both continue alike
    _train(state, 2, seed=9)
    _train(fresh, 2, seed=9)
    _assert_states_equal(state, fresh)
    ckpt = torch.load(os.path.join(tmp_path, "checkpoints",
                                   "step_0000000003.pth"), weights_only=True)
    assert set(ckpt) == {"model", "optimizer", "step", "ema_model"}
    assert ckpt["step"] == ckpt["optimizer"]["step"] == 3


def test_keep_five_and_latest_step(tmp_path):
    assert CK.latest_step(str(tmp_path)) is None
    assert CK.restore_checkpoint(str(tmp_path / "none"), _state()) is None
    state = _state()
    for _ in range(7):
        _train(state, 1)
        CK.save_checkpoint(str(tmp_path), state)
    names = sorted(os.listdir(tmp_path / "checkpoints"))
    assert names == [f"step_{s:010d}.pth" for s in range(3, 8)]
    assert CK.latest_step(str(tmp_path)) == 7
    with CK.CheckpointWriter(str(tmp_path), keep=2) as writer:
        _train(state, 1)
        writer.save(state)
    assert sorted(os.listdir(tmp_path / "checkpoints")) == [
        "step_0000000007.pth", "step_0000000008.pth"]


def test_restore_without_ema_shadow_raises(tmp_path):
    state = _state(ema=False)
    CK.save_checkpoint(str(tmp_path), state)
    with pytest.raises(KeyError, match="EMA"):
        CK.restore_checkpoint(str(tmp_path), _state())


def test_merge_pretrained_partial_load():
    state = _state()
    model = state.model
    before = {k: v.clone() for k, v in model.state_dict().items()}
    pre = {"head.weight": torch.ones(3, 6),                  # loaded
           "backbone.1.running_mean": torch.full((6,), 2.0),  # loaded
           "backbone.0.weight": torch.ones(5, 4),            # wrong shape
           "decoder.unknown": torch.ones(2)}                 # unknown
    assert CK.merge_pretrained(model, pre) == (2, 2)
    sd = model.state_dict()
    assert torch.equal(sd["head.weight"], torch.ones(3, 6))
    assert torch.equal(sd["backbone.1.running_mean"], torch.full((6,), 2.0))
    for k in ("backbone.0.weight", "head.bias", "backbone.1.running_var"):
        assert torch.equal(sd[k], before[k]), k
    # in place: the optimizer's parameter is the one that was loaded
    assert any(p is model.head.weight for p in state.optimizer.params)


def test_writer_copies_at_save(tmp_path, monkeypatch):
    """The writer's thread serialises the copy taken at ``save()``: a
    model and optimizer changed right after ``save`` returns leave the
    file as it was."""
    real_save = torch.save

    def slow_save(obj, path):
        time.sleep(0.3)     # the thread writes after the changes below
        real_save(obj, path)

    monkeypatch.setattr(CK.torch, "save", slow_save)
    state = _state()
    _train(state, 2)
    want = CK.host_state(state)
    writer = CK.CheckpointWriter(str(tmp_path))
    writer.save(state)
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
        state.model.backbone[1].running_var.mul_(3.0)
        state.optimizer.mu[0][0].add_(1.0)
        state.ema.shadow["head.bias"].add_(1.0)
    state.optimizer.count += 1
    writer.close()
    got = torch.load(os.path.join(tmp_path, "checkpoints",
                                  "step_0000000002.pth"), weights_only=True)
    for k in want["model"]:
        assert torch.equal(got["model"][k], want["model"][k]), k
    for part in ("mu", "nu"):
        for k in want["optimizer"][part]:
            assert torch.equal(got["optimizer"][part][k],
                               want["optimizer"][part][k])
    for k in want["ema_model"]:
        assert torch.equal(got["ema_model"][k], want["ema_model"][k])
    assert got["step"] == 2


class _FakeStep:
    """A train step that only counts: the optimizer's count is the step."""

    def __init__(self, state):
        self.state = state

    def __call__(self, microbatches, generator=None):
        time.sleep(0.05)
        assert len(microbatches) == 1
        self.state.optimizer.count += 1
        return {"total_loss": torch.tensor(1.0)}

    def host_metrics(self, metrics):
        return {k: float(v) for k, v in metrics.items()}


def test_sigterm_checkpoints_at_the_step_boundary(tmp_path):
    """A SIGTERM mid-loop checkpoints at the next step boundary and
    returns; the checkpoint restores that step; the handlers come back.
    The loop runs in a spawned process that signals itself, so that no
    signal reaches the test runner's process
    (``torch_port_procs.sigterm``)."""
    from torch_port_procs import spawn_group

    work = str(tmp_path / "work")
    (res,) = spawn_group(1, str(tmp_path),
                         [("sigterm", "sigterm", dict(work_dir=work))],
                         timeout_s=90.0, group=False)
    done = res["sigterm"]["step"]
    assert 0 < done < 10_000
    assert res["sigterm"]["saves"] == [done]
    assert res["sigterm"]["handlers_back"]
    assert CK.latest_step(work) == done
    fresh = _state(seed=3)
    CK.restore_checkpoint(work, fresh)
    assert fresh.step == done


def test_train_loop_logs_saves_and_evaluates(tmp_path):
    from segdino3d_tpu_torch.train.engine import train_loop

    state = _state()
    lines, evals = [], []

    class Log:
        def info(self, msg):
            lines.append(msg)

    class Loader:
        def __iter__(self):
            while True:
                yield [object()]

    train_loop(step_fn=_FakeStep(state), state=state, train_loader=Loader(),
               num_iterations=5, schedule_fn=lambda s: 0.1 * s, logger=Log(),
               print_freq=2, save_step=2, eval_step=4,
               eval_fn=lambda st: evals.append(st.step),
               work_dir=str(tmp_path))
    iters = [l for l in lines if l.startswith("iter [")]
    assert [l.split("]")[0] for l in iters] == ["iter [0/5", "iter [2/5",
                                                "iter [4/5"]
    assert "total_loss: 1.0000" in iters[0] and "data: " in iters[0]
    assert evals == [4]
    assert sorted(os.listdir(tmp_path / "checkpoints")) == [
        "step_0000000002.pth", "step_0000000004.pth", "step_0000000005.pth"]


# --------------------------------------------------------------------------
# the eval batch cache
# --------------------------------------------------------------------------

def _tree_equal(a, b):
    from segdino3d_tpu_torch.data.collate import map_leaves

    flat_a, flat_b = [], []
    map_leaves(a, flat_a.append)
    map_leaves(b, flat_b.append)
    assert len(flat_a) == len(flat_b)
    for x, y in zip(flat_a, flat_b):
        assert type(x) is type(y), (type(x), type(y))
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        elif isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert np.array_equal(x, y, equal_nan=True)
        else:
            assert x == y


def test_bundle_round_trip_mixed_leaves(tmp_path):
    from segdino3d_tpu_torch.data.eval_cache import load_bundle, save_bundle

    rng = np.random.RandomState(0)
    tree = {
        "f32": rng.randn(7, 3).astype(np.float32),
        "t_f16": torch.from_numpy(rng.randn(5, 4).astype(np.float16)),
        "t_bool": torch.tensor([[True, False], [False, True]]),
        "i64": np.arange(11, dtype=np.int64),
        "t_scalar0d": torch.tensor(3.5),
        "empty": torch.zeros((0, 4), dtype=torch.int32),
        "none": None, "string": "scene0042", "pyint": 7,
        "nested": [{"a": np.uint32([1, 2, 3])}, (torch.tensor([-1],
                                                  dtype=torch.int8), 2.5)],
    }
    path = str(tmp_path / "bundle.bin")
    save_bundle(path, tree)
    back = load_bundle(path)
    _tree_equal(tree, back)
    assert back["t_scalar0d"].shape == ()
    with pytest.raises(ValueError):
        back["i64"][0] = 99           # the map is read-only


class _DS:
    bg_class_id = 200

    def __len__(self):
        return 5

    def get_record(self, i, rng, sync_scale=None):
        from segdino3d_tpu_torch.data.synthetic import synthetic_scene

        return synthetic_scene(i, n_points=900 + 31 * i, n_superpoints=32,
                               n_classes=8, n_queries2d=8, feat_dim_2d=8)


def _loader(cache_dir=None, voxel_cap=2048, prefetch=0, **kw):
    from segdino3d_tpu_torch.data.collate import PadSpec
    from segdino3d_tpu_torch.data.loader import EvalLoader

    return EvalLoader(_DS(), PadSpec(1024, 32, 8, 8, 8), batch_size=2,
                      host_plan_cfg=dict(voxel_size=0.02,
                                         voxel_cap=voxel_cap),
                      cache_dir=cache_dir, prefetch=prefetch, device="cpu",
                      **kw)


def test_cached_batches_bit_equal_and_slim_records(tmp_path):
    from segdino3d_tpu_torch.data.collate import eval_annotation

    fresh = list(_loader())
    cache_dir = str(tmp_path / "evc")
    built = list(_loader(cache_dir))          # first pass: build + write
    served = list(_loader(cache_dir, prefetch=1))   # the cache alone
    assert len(fresh) == len(built) == len(served) == 3
    for (fr, fb), (br, bb), (sr, sb) in zip(fresh, built, served):
        _tree_equal(fb, bb)
        _tree_equal(fb, sb)
        # served tensors are the loader's own (copied out of the map)
        sb.points.add_(0)
        for rec, slim in zip(fr, sr):
            assert slim["n_points"] == rec["points"].shape[0]
            full, thin = eval_annotation(rec), eval_annotation(slim)
            for k in ("pts_instance_mask", "pts_semantic_mask"):
                assert np.array_equal(full[k], thin[k])
            assert full["lidar_idx"] == thin["lidar_idx"]


def test_cache_namespace_rotates_on_config_change(tmp_path):
    cache_dir = str(tmp_path / "evc")
    list(_loader(cache_dir))
    same = _loader(cache_dir)
    assert same.cache.complete()
    other = _loader(cache_dir, voxel_cap=4096)
    assert not other.cache.complete()
    assert other.cache.key != same.cache.key
    assert _loader(cache_dir, limit=3).cache.key != same.cache.key


def test_incomplete_cache_rebuilds(tmp_path):
    cache_dir = str(tmp_path / "evc")
    it = iter(_loader(cache_dir))
    next(it)                                  # abandoned mid-build
    it.close()
    again = _loader(cache_dir)
    assert not again.cache.complete()         # no manifest: rebuilt
    assert len(list(again)) == len(again) == 3
    assert _loader(cache_dir).cache.complete()


# --------------------------------------------------------------------------
# the meters, the zero-gradient check and the profiler
# --------------------------------------------------------------------------

def test_meters_match_jax():
    from segdino3d_tpu.utils.metrics import SmoothedValue as JaxSmoothed
    from segdino3d_tpu_torch.utils.metrics import MetricLogger, SmoothedValue

    vals = np.random.RandomState(0).rand(37)
    ours, theirs = SmoothedValue(window_size=10), JaxSmoothed(window_size=10)
    for v in vals:
        ours.update(v)
        theirs.update(v)
        for k in ("median", "avg", "global_avg", "value"):
            assert getattr(ours, k) == getattr(theirs, k), k
    assert str(ours) == str(theirs)
    lines = []

    class Log:
        def info(self, msg):
            lines.append(msg)

    ml = MetricLogger(logger=Log())
    ml.update(loss=2.0)
    assert [i for i, _ in ml.log_every(range(3), 1, "h")] == [0, 1, 2]
    assert len(lines) == 4 and "loss: 2.0000" in lines[0]


def test_find_zero_grad_params():
    from segdino3d_tpu_torch.utils.metrics import find_zero_grad_params

    model = _Net()
    model(torch.randn(4, 4)).sum().backward()
    assert find_zero_grad_params(model.named_parameters()) == []
    model.head.bias.grad.zero_()
    model.backbone[0].weight.grad = None
    assert find_zero_grad_params(model.named_parameters()) == [
        "backbone.0.weight", "head.bias"]


def test_profiler_writes_a_trace(tmp_path):
    import json

    from segdino3d_tpu_torch.utils import profiling

    with profiling.trace(str(tmp_path / "profile")):
        with profiling.annotate("train_step"):
            _Net()(torch.randn(4, 4)).sum()
    with open(tmp_path / "profile" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "train_step" in names
    with pytest.raises(RuntimeError, match="no trace"):
        profiling.stop_trace()
    assert "unavailable" in profiling.device_memory_summary() or \
        "GiB peak" in profiling.device_memory_summary()
