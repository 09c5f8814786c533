"""The port's CLI, ``python -m segdino3d_tpu_torch.train_3d``, run in-process
with ``--device cpu`` on tiny scenes written from seeds, with the small
model config of ``tests/test_cli.py`` (its capacities cut to the scenes:
a 4,096-voxel cap and shrinking level caps, so a CPU step takes seconds).

It trains with ``--accum_steps 2`` and checkpoints (one run, which two
tests read), then evaluates the checkpoint (``--eval_only --resume``) to
an AP dict; refuses an ``--accum_steps`` that does not divide the batch;
merges
a partial reference-layout checkpoint (``--load_pretrained_ckpt``), whose
parameters and batch-norm running statistics must reach the evaluated
model bit-equal to the port's reference import (the counterpart of
``test_cli_pretrained_ckpt_restores_batch_stats``); evaluates on the EMA
shadow (``--eval_first``, ``--options use_ema=True``); runs the ScanNet
v2 config; and raises without a card when no ``--device`` is named.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from test_cli import CONFIG_TMPL, CONFIG_TMPL_SPCONV  # noqa: E402

from segdino3d_tpu_torch import train_3d  # noqa: E402
from segdino3d_tpu_torch.data.synthetic import write_scannet_layout  # noqa: E402
from segdino3d_tpu_torch.train.checkpoint import latest_step  # noqa: E402

CAPS = ('num_voxels=8192', 'num_voxels=4096'), (
    'level_cap_ratios=(1, 1, 1, 1, 1)',
    'level_cap_ratios=(1.0, 0.5, 0.25, 0.125, 0.0625)')


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(tmp_path, seeds, tmpl=CONFIG_TMPL, n_points=2500, **subs):
    root = str(tmp_path / "data")
    write_scannet_layout(root, seeds=seeds, n_points=n_points,
                         n_superpoints=48, n_classes=16, n_instances=5,
                         feat_dim_2d=16)
    text = tmpl.replace("{root}", root)
    for a, b in CAPS + tuple(subs.items()):
        assert a in text, a
        text = text.replace(a, b)
    cfg = str(tmp_path / "cfg.py")
    with open(cfg, "w") as f:
        f.write(text)
    return cfg, str(tmp_path / "work")


def _run(cfg, work, *flags):
    return train_3d.main(["--config_file", cfg, "--work_dir", work,
                          "--seed", "1", "--device", "cpu", *flags])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two steps of batch 2 as two microbatches of 1 (``--accum_steps
    2``), a checkpoint after each: (config, work dir, state, log)."""
    tmp_path = tmp_path_factory.mktemp("cli_train")
    cfg, work = _setup(tmp_path, [0, 1, 2], **{
        "num_iterations = 4": "num_iterations = 2",
        "save_step = 4": "save_step = 1"})
    state = _run(cfg, work, "--accum_steps", "2")
    with open(os.path.join(work, "log_0", "log.txt")) as f:
        log = f.read()
    return cfg, work, state, log


def test_cli_train_then_eval(trained):
    cfg, work, state, log = trained
    assert state.step == 2
    assert sorted(os.listdir(os.path.join(work, "checkpoints"))) == [
        "step_0000000001.pth", "step_0000000002.pth"]
    assert "iter [0/2]" in log and "total_loss" in log
    res = _run(cfg, work, "--eval_only", "--resume", "--num_eval_scenes",
               "2")
    assert {"all_ap", "all_ap_50", "all_ap_25"} <= set(res)
    assert all(np.isfinite(res[k]) for k in ("all_prec_50",))
    with open(os.path.join(work, "log_0", "log.txt")) as f:
        log = f.read()
    assert "resumed at step 2" in log and "mAP: " in log
    assert "eval_cache" in os.listdir(work)
    assert os.path.isfile(os.path.join(work, "config.py"))


def test_cli_train_accum_steps(trained, tmp_path):
    """--accum_steps 2: a batch of 2 scenes as 2 microbatches of 1."""
    cfg, work, state, _ = trained
    assert state.step == 2 and latest_step(work) == 2
    assert state.optimizer.count == 2
    with pytest.raises(SystemExit, match="not divisible"):
        _run(cfg, str(tmp_path / "w3"), "--accum_steps", "3")


def test_cli_pretrained_ckpt_restores_batch_stats(tmp_path, monkeypatch):
    """A reference-layout backbone checkpoint (``module.``-free,
    ``{"model": sd}``) merged by --load_pretrained_ckpt: the evaluated
    model holds every translated parameter and running statistic
    bit-equal, and the statistics are not the fresh ones."""
    from test_torch_port_reference_import import tree_of
    from test_torch_roundtrip import build_res16_torch_sd

    from segdino3d_tpu_torch.evaluation import evaluate as E
    from segdino3d_tpu_torch.models.backbone.res16unet import Res16UNet34C
    from segdino3d_tpu_torch.train.torch_import import import_state_dict

    cfg, work = _setup(tmp_path, [0], n_points=2000)
    want_p, want_s = tree_of(Res16UNet34C(in_channels=19))
    sd = build_res16_torch_sd(want_p, want_s, np.random.RandomState(7))
    for k, v in sd.items():          # running variances must be positive
        if k.endswith("running_var"):
            np.abs(v, out=v)
    path = str(tmp_path / "pretrained.pth")
    torch.save({"model": {k: torch.from_numpy(np.asarray(v).copy())
                          for k, v in sd.items()}}, path)
    want, unmapped = import_state_dict(
        {k: torch.from_numpy(np.asarray(v).copy()) for k, v in sd.items()})
    assert unmapped == []

    captured = {}
    real = E.evaluate

    def spy(model, *a, **kw):
        captured["sd"] = {k: v.clone() for k, v in
                          model.state_dict().items()}
        return real(model, *a, **kw)

    monkeypatch.setattr(E, "evaluate", spy)
    res = _run(cfg, work, "--eval_only", "--num_eval_scenes", "1",
               "--load_pretrained_ckpt", path)
    assert res is not None and "sd" in captured
    got = captured["sd"]
    assert set(want) <= set(got)
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert stats
    for k, v in want.items():
        assert torch.equal(got[k], v), k

    # without the merge the statistics are the random init's
    monkeypatch.setattr(E, "evaluate", spy)
    _run(cfg, str(tmp_path / "fresh"), "--eval_only", "--num_eval_scenes",
         "1")
    assert any(not torch.equal(captured["sd"][k], want[k]) for k in stats)


def test_cli_ema_eval_first(tmp_path, monkeypatch):
    """``use_ema`` through ``--options``: the eval before training and the
    in-loop eval run on the EMA shadow and leave the trained parameters
    in place; the checkpoint holds the shadow."""
    from segdino3d_tpu_torch.evaluation import evaluate as E

    cfg, work = _setup(tmp_path, [0, 1], n_points=2000, **{
        "save_step = 4": "save_step = 1"})
    seen = []
    real = E.evaluate

    def spy(model, *a, **kw):
        seen.append(next(model.parameters()).clone())
        return real(model, *a, **kw)

    monkeypatch.setattr(E, "evaluate", spy)
    state = _run(cfg, work, "--eval_first", "--num_eval_scenes", "1",
                 "--options", "use_ema=True", "ema_decay=0.5",
                 "num_iterations=1", "eval_step=1")
    assert state.step == 1 and len(seen) == 2
    first = next(state.model.parameters())
    shadow = next(iter(state.ema.shadow.values()))
    assert torch.equal(seen[1], shadow) and not torch.equal(first, shadow)
    ckpt = torch.load(os.path.join(work, "checkpoints",
                                   "step_0000000001.pth"), weights_only=True)
    assert ckpt["ema_model"] is not None
    for k, v in state.ema.shadow.items():
        assert torch.equal(ckpt["ema_model"][k], v), k


def test_cli_spconv_v2_train_eval(tmp_path):
    """The ScanNet v2 / SpConvUNet config path: 2 steps, then eval."""
    cfg, work = _setup(tmp_path, [0, 1], tmpl=CONFIG_TMPL_SPCONV,
                       n_points=2000, **{
                           "num_iterations = 4": "num_iterations = 2",
                           "save_step = 4": "save_step = 2"})
    assert _run(cfg, work).step == 2
    res = _run(cfg, work, "--eval_only", "--resume", "--num_eval_scenes",
               "2")
    assert "all_ap" in res


def test_cli_without_a_card_raises(tmp_path, monkeypatch):
    cfg, work = _setup(tmp_path, [0], n_points=2000)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_3d.main(["--config_file", cfg, "--work_dir", work])
    assert not os.path.exists(work)
