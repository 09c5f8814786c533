"""Process bodies and datasets for the port's multi-process tests.

Each test process is ``spawn``ed and imports torch, the port and the
test modules' port-side helpers, never JAX (so a process starts in a few
seconds); the datasets that the loader tests hand to spawned workers live
here for the same reason.  ``spawn_group`` starts ``world`` processes that join one gloo
group over a ``file://`` store (60 s timeout), run the named tasks in
order and pickle their results; it waits for them within a deadline,
kills them and fails after it, and raises any process's traceback.
"""
import multiprocessing as mp
import os
import pickle
import signal
import threading
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from segdino3d_tpu_torch.parallel import mesh


def spawn_group(world, tmp_dir, tasks, timeout_s=120.0, group=True):
    """Run ``tasks`` ([(key, task name, kwargs), ...]) in order in each of
    ``world`` spawned processes (in one group unless ``group`` is False);
    returns each rank's {key: result}."""
    ctx = mp.get_context("spawn")
    store = os.path.join(tmp_dir, "store")
    procs = [ctx.Process(target=_main,
                         args=(r, world, store if group else None, tmp_dir,
                               tasks))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(5.0)
    errors = []
    for r in range(world):
        path = os.path.join(tmp_dir, f"rank{r}.err")
        if os.path.exists(path):
            with open(path) as f:
                errors.append(f"rank {r}:\n{f.read()}")
    if errors or hung:
        raise AssertionError("\n".join(errors) or
                             f"processes {[p.pid for p in hung]} did not end "
                             f"within {timeout_s} s")
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, codes
    out = []
    for r in range(world):
        with open(os.path.join(tmp_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _main(rank, world, store, tmp_dir, tasks):
    try:
        torch.set_num_threads(1)
        if store is not None:
            mesh.init_distributed(init_method=f"file://{store}", rank=rank,
                                  world_size=world, backend="gloo",
                                  timeout_s=60.0)
        results = {}
        for key, name, kw in tasks:
            results[key] = TASKS[name](rank, world, **kw)
        with open(os.path.join(tmp_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    except BaseException:
        with open(os.path.join(tmp_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        mesh.shutdown_distributed()


class FailingDS:
    """Raises on idx 5, or with ``die`` ends its process there."""

    def __init__(self, die=False):
        self.die = die

    def __len__(self):
        return 8

    def get_record(self, idx, rng, sync_scale=None):
        from segdino3d_tpu_torch.data.synthetic import synthetic_scene

        if idx == 5:
            if self.die:
                os._exit(3)
            raise ValueError("boom at idx 5")
        return synthetic_scene(idx, n_points=300, n_superpoints=16,
                               n_classes=8, n_queries2d=4, feat_dim_2d=4)


class StuckDS(FailingDS):
    """Every record takes ``seconds``: a worker that is alive and sends
    nothing for that long."""

    def __init__(self, seconds):
        super().__init__()
        self.seconds = seconds

    def get_record(self, idx, rng, sync_scale=None):
        time.sleep(self.seconds)
        return super().get_record(0, rng)


class _CountReduces:
    """Counts ``torch.distributed.all_reduce`` calls while entered."""

    def __enter__(self):
        self.n = 0
        self._real = dist.all_reduce

        def counted(*a, **kw):
            self.n += 1
            return self._real(*a, **kw)

        dist.all_reduce = counted
        return self

    def __exit__(self, *exc):
        dist.all_reduce = self._real
        return False


def _same_on_every_rank(tensors):
    """True where rank 0's tensors equal this rank's, bit for bit."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    ref = flat.clone()
    dist.broadcast(ref, 0)
    return bool(torch.equal(flat, ref))


def step(rank, world, fixture, case, seeds):
    """The port's step on this rank's scenes of ``seeds`` (an equal share
    each), held by rank 0 to the frozen JAX step ``case`` of
    ``fixture``; every rank's state after the step must equal rank 0's."""
    from test_torch_port_train import (SCENE, check_against,
                                       initial_variables, port_step)

    from segdino3d_tpu_torch.data.synthetic import synthetic_scene

    per = len(seeds) // world
    recs = [synthetic_scene(s, **SCENE)
            for s in seeds[rank * per:(rank + 1) * per]]
    variables = initial_variables()
    with _CountReduces() as reduces:
        port = port_step(variables, recs=recs,
                         process_group=dist.group.WORLD)
    if rank == 0:
        with np.load(fixture, allow_pickle=True) as z:
            ref = {k.split("__", 1)[1]: z[k] for k in z.files
                   if k.startswith(case + "__")}
        check_against(port, ref)
    model = port["model"]
    state = ([p for p in model.parameters()]
             + [p.grad for p in model.parameters()]
             + list(model.buffers()) + list(port["ema"].shadow.values()))
    return dict(n_reduce=reduces.n, same=_same_on_every_rank(state),
                metrics={k: float(v) for k, v in port["metrics"].items()})


def evaluate(rank, world, root, state_path, gather_dir):
    """This rank's share of the eval set (``EvalLoader`` with
    ``process_index`` / ``process_count``), gathered through
    ``gather_dir``: the AP dict of the whole set."""
    from test_torch_port_train import (PORT_CFG, S_CAP,
                                       initial_variables)

    from segdino3d_tpu_torch.builder import Capacities, build_model
    from segdino3d_tpu_torch.convert import load_jax_variables
    from segdino3d_tpu_torch.data.loader import EvalLoader
    from segdino3d_tpu_torch.data.scannet_dataset import \
        ScanNet200InstanceSeg3D
    from segdino3d_tpu_torch.evaluation.evaluate import evaluate as run
    from segdino3d_tpu_torch.evaluation.evaluator import \
        InstanceSeg3DEvaluator

    with open(state_path, "rb") as f:
        st = pickle.load(f)
    model, _ = build_model(PORT_CFG, Capacities(num_superpoints=S_CAP),
                           device="cpu")
    load_jax_variables(model, initial_variables())
    reader = ScanNet200InstanceSeg3D(**st["reader"])
    loader = EvalLoader(reader, st["spec"], host_plan_cfg=st["plan"],
                        batch_size=st["batch_size"], device="cpu",
                        process_index=rank, process_count=world)
    evaluator = InstanceSeg3DEvaluator(*st["classes"])
    ap = run(model, loader, evaluator, st["test_cfg"], gather_dir=gather_dir,
             process_index=rank, process_count=world)
    return dict(ap=ap, results=evaluator._results)


def sigterm(rank, world, work_dir, signal_rank=0, after_s=0.4):
    """``train_loop`` over a counting step; ``signal_rank`` sends itself a
    SIGTERM after ``after_s``.  Returns the step it stopped at, the number
    of checkpoint saves this rank made, and whether the handlers came
    back."""
    import itertools

    from test_torch_port_engine import _FakeStep, _state

    from segdino3d_tpu_torch.train import checkpoint as CK
    from segdino3d_tpu_torch.train.engine import train_loop

    saves = []
    real = CK.CheckpointWriter.save

    def save(self, state):
        saves.append(state.step)
        return real(self, state)

    CK.CheckpointWriter.save = save
    state = _state()
    timer = None
    if rank == signal_rank:
        timer = threading.Timer(after_s, lambda: os.kill(os.getpid(),
                                                         signal.SIGTERM))
        timer.start()
    try:
        out = train_loop(step_fn=_FakeStep(state), state=state,
                         train_loader=itertools.count(),
                         num_iterations=10_000, print_freq=10_000,
                         save_step=10_000, work_dir=work_dir)
    finally:
        if timer is not None:
            timer.cancel()
        CK.CheckpointWriter.save = real
    return dict(step=out.step, saves=list(saves),
                handlers_back=signal.getsignal(signal.SIGTERM) in (
                    signal.SIG_DFL, signal.default_int_handler))


def reduce(rank, world):
    """``mesh.all_reduce_mean_`` of two fp32 and one fp64 tensors: the
    means, and the number of all-reduces it made."""
    f32 = [torch.tensor([rank, rank + 1.0]), torch.tensor([rank + 2.0])]
    f64 = torch.tensor([[1.0 + rank], [10.0 + rank]], dtype=torch.float64)
    with _CountReduces() as reduces:
        mesh.all_reduce_mean_(f32 + [f64])
    return dict(n_reduce=reduces.n, f32=torch.cat(f32).numpy(),
                f64=f64.numpy())


def cli(rank, world, args):
    """``segdino3d_tpu_torch.train_3d.main(args)`` in the group: the
    step it ended at."""
    from segdino3d_tpu_torch import train_3d

    return train_3d.main(args).step


TASKS = dict(step=step, evaluate=evaluate, sigterm=sigterm, reduce=reduce,
             cli=cli)
