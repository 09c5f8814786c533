"""Training and evaluation entry point of the port.

    python -m segdino3d_tpu_torch.train_3d --config_file CFG --work_dir DIR
    python -m torch.distributed.run --nproc_per_node N \
        -m segdino3d_tpu_torch.train_3d --config_file CFG --work_dir DIR

Counterpart of ``train_3d.py``, with its flags (``--config_file
--work_dir --seed --eval_only --eval_first --resume --load_pretrained_ckpt
--kernel_order --num_eval_scenes --eval_batch_size --profile_steps
--eval_cache_dir --accum_steps --options``) and its run order: the config
(``--options`` merged), the model with seeded random weights, the optional
pretrained merge (a reference ``.pth``: parameters and batch-norm
statistics), AdamW/PolyLR with EMA where the config sets ``use_ema``,
``--resume``, the ``EvalLoader`` on the config's eval plan with buckets
and the eval batch cache, ``--eval_only``, the ``TrainLoader`` on the
config's training plan (``mesh_shards = accum_steps``: the microbatches of
a step) and the train loop.  ``--device`` names the device (default: the
card; without one it raises); the kernels build once into the build
directory, so there is no compile cache flag.

Under ``torch.distributed.run`` each process joins the group
(``parallel.mesh``: NCCL on the cards, ``cuda:LOCAL_RANK`` each; gloo with
``--device cpu``), reads its shard of the training stream and of the eval
batches, and steps its own ``train_batch_size`` scenes; the step averages
gradients, losses and batch-norm statistics over the group.  Process 0
writes the config, the code snapshot and the checkpoints; every process
logs to ``work_dir/log_<rank>``, builds its own eval cache, and gathers
the eval results through ``work_dir/eval_gather/step_<N>``.
"""
from __future__ import annotations

import argparse
import ast
import contextlib
import os
import time


def get_args(argv=None):
    p = argparse.ArgumentParser("SegDINO3D training (PyTorch port)")
    p.add_argument("--config_file", required=True)
    p.add_argument("--work_dir", default="work_dirs/default")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--eval_only", action="store_true")
    p.add_argument("--eval_first", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--load_pretrained_ckpt", default=None)
    p.add_argument("--kernel_order", default="x_slowest",
                   choices=["x_slowest", "x_fastest"],
                   help="ME kernel-offset enumeration of a reference "
                        "checkpoint (train/torch_import.py)")
    p.add_argument("--num_eval_scenes", type=int, default=None)
    p.add_argument("--eval_batch_size", type=int, default=None,
                   help="scenes per eval batch (default: cfg "
                        "data.eval_batch_size or 1)")
    p.add_argument("--profile_steps", default=None,
                   help="START:STOP: a torch.profiler trace of these "
                        "train steps into work_dir/profile")
    p.add_argument("--eval_cache_dir", default="auto",
                   help="eval batch cache (data/eval_cache.py): 'auto' = "
                        "<work_dir>/eval_cache, 'none' disables")
    p.add_argument("--accum_steps", type=int, default=None,
                   help="microbatches per step (default: cfg accum_steps "
                        "or 1); train_batch_size must be a multiple")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs the "
                        "plain PyTorch path)")
    p.add_argument("--options", nargs="*", default=None,
                   help="key=value config overrides (nested keys with dots)")
    return p.parse_args(argv)


def parse_options(opts):
    if not opts:
        return {}
    out = {}
    for kv in opts:
        k, v = kv.split("=", 1)
        try:
            out[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            out[k] = v
    return out


def main(argv=None):
    args = get_args(argv)

    from segdino3d_tpu_torch.device import resolve_device
    from segdino3d_tpu_torch.parallel import mesh

    device = mesh.local_device(resolve_device(args.device))
    mesh.init_distributed(device)
    try:
        return _run(args, device)
    finally:
        mesh.shutdown_distributed()


def _run(args, device):
    import torch

    from segdino3d_tpu_torch.builder import (Capacities, build_criterion,
                                             build_model, host_plan_args,
                                             random_init_)
    from segdino3d_tpu_torch.config.config import Config
    from segdino3d_tpu_torch.data.bucketing import BucketPolicy
    from segdino3d_tpu_torch.data.collate import PadSpec
    from segdino3d_tpu_torch.data.loader import (ConcatDataset, EvalLoader,
                                                 TrainLoader)
    from segdino3d_tpu_torch.data.scannet_constants import (
        SCANNET200_CLASS_NAMES, SCANNET200_RAW_IDS, SCANNET20_CLASS_NAMES,
        SCANNET20_RAW_IDS)
    from segdino3d_tpu_torch.evaluation.evaluate import evaluate
    from segdino3d_tpu_torch.evaluation.evaluator import \
        InstanceSeg3DEvaluator
    from segdino3d_tpu_torch.parallel import mesh
    from segdino3d_tpu_torch.parallel.train_step import TrainStep
    from segdino3d_tpu_torch.registry import DATASETS
    from segdino3d_tpu_torch.train.checkpoint import (TrainState,
                                                      merge_pretrained,
                                                      restore_checkpoint)
    from segdino3d_tpu_torch.train.ema import EMA
    from segdino3d_tpu_torch.train.engine import train_loop
    from segdino3d_tpu_torch.train.optim import build_optimizer, poly_lr
    from segdino3d_tpu_torch.utils.logging import (dump_code, get_git_sha,
                                                   setup_logger)
    import segdino3d_tpu_torch.data.scannet_dataset  # noqa: F401 (registry)

    rank, n_proc = mesh.process_index(), mesh.process_count()
    os.makedirs(args.work_dir, exist_ok=True)
    logger = setup_logger(args.work_dir, process_index=rank)
    logger.info(f"git sha: {get_git_sha()}")
    logger.info(f"device: {device}" + (
        f" ({torch.cuda.get_device_name(device)})"
        if device.type == "cuda" else "")
        + (f", process {rank} of {n_proc} "
           f"({torch.distributed.get_backend()})"
           if torch.distributed.is_initialized() else ""))
    if rank == 0:
        dump_code(args.work_dir)

    cfg = Config.fromfile(args.config_file)
    cfg.merge_from_options(parse_options(args.options))
    if rank == 0:
        cfg.dump(os.path.join(args.work_dir, "config.py"))

    caps = Capacities.from_cfg(cfg.get("capacities"))
    model, test_cfg = build_model(cfg.model, caps, device=device, train=True)
    random_init_(model, args.seed)
    criterion = build_criterion(cfg.model)
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"model parameters: {n_params / 1e6:.2f}M")

    if args.load_pretrained_ckpt:
        from segdino3d_tpu_torch.train.torch_import import import_checkpoint
        pre, unmapped = import_checkpoint(args.load_pretrained_ckpt,
                                          kernel_order=args.kernel_order)
        if unmapped:
            logger.info(f"[torch_import] {len(unmapped)} unmapped keys, "
                        f"e.g. {unmapped[:5]}")
        # parameters and batch-norm running statistics alike: eval on
        # fresh (0, 1) statistics would wreck a converted checkpoint's AP
        loaded, skipped = merge_pretrained(model, pre)
        logger.info(f"pretrained {args.load_pretrained_ckpt}: {loaded} "
                    f"tensors loaded, {skipped} skipped")

    optimizer = build_optimizer(model.named_parameters(), cfg.optimizer,
                                cfg.scheduler, cfg.get("clip_max_norm"))
    sched = poly_lr(cfg.optimizer.get("lr", 1e-4),
                    cfg.scheduler.get("total_iters", 100_000),
                    cfg.scheduler.get("power", 0.9))
    ema = (EMA(model.named_parameters(), cfg.get("ema_decay", 0.9997))
           if cfg.get("use_ema", False) else None)
    state = TrainState(model, optimizer, ema)
    if args.resume:
        if restore_checkpoint(args.work_dir, state) is not None:
            logger.info(f"resumed at step {state.step}")

    # ---- data ----
    n_sem = cfg.model["decoder_cfg"]["num_semantic_classes"]
    spec = PadSpec(caps.num_points, caps.num_superpoints, caps.num_instances,
                   caps.num_queries2d, n_sem)
    ratios = (cfg.get("capacities") or {}).get("level_cap_ratios")
    eval_ds = DATASETS.build(dict(cfg.data["eval_main"][0]))
    n_stuff = len(cfg.get("evaluator_cfg", {}).get("stuff_class_inds",
                                                    [0, 1]))
    if n_sem == 200:
        valid_ids, names = SCANNET200_RAW_IDS, SCANNET200_CLASS_NAMES
    else:
        valid_ids, names = SCANNET20_RAW_IDS, SCANNET20_CLASS_NAMES
    evaluator = InstanceSeg3DEvaluator(
        valid_class_ids=valid_ids, class_names=names,
        stuff_class_inds=list(range(n_stuff)))
    eval_plan_cfg = host_plan_args(cfg.model, train=False)
    if ratios:
        eval_plan_cfg["level_cap_ratios"] = tuple(ratios)
    eval_cache = (os.path.join(args.work_dir, "eval_cache")
                  if args.eval_cache_dir == "auto" else
                  (None if args.eval_cache_dir == "none"
                   else args.eval_cache_dir))
    eval_loader = EvalLoader(
        eval_ds, spec, limit=args.num_eval_scenes,
        batch_size=(args.eval_batch_size or cfg.data.get("eval_batch_size")
                    or 1),
        bucket_policy=BucketPolicy.default(
            n_sem, caps.num_points, caps.num_superpoints,
            caps.num_instances, caps.num_queries2d),
        host_plan_cfg=eval_plan_cfg, cache_dir=eval_cache, device=device,
        process_index=rank, process_count=n_proc)

    def run_eval(st):
        cache = eval_loader.cache
        if cache is not None:
            logger.info(f"eval cache {cache.dir}: "
                        + ("serving" if cache.complete() else "building"))
        st.model.eval()
        t0 = time.perf_counter()
        try:
            with (st.ema.applied() if st.ema is not None
                  else contextlib.nullcontext()):
                res = evaluate(
                    st.model, eval_loader, evaluator, test_cfg,
                    filter_outofbox=cfg.model.get(
                        "filter_outofbox_points_eval", True),
                    bg_class_id=eval_ds.bg_class_id,
                    # a directory per step: shards of an earlier eval
                    # round must never satisfy this one's wait
                    gather_dir=(os.path.join(args.work_dir, "eval_gather",
                                             f"step_{st.step:010d}")
                                if n_proc > 1 else None),
                    process_index=rank, process_count=n_proc)
        finally:
            st.model.train()
        dt = time.perf_counter() - t0
        n = eval_loader.num_scenes
        logger.info(f"eval: {n} scenes in {dt:.3f} s ({n / dt:.3f} "
                    f"scenes/s)")
        if res:
            logger.info(
                f"mAP: {res['all_ap']:.4f}  mAP50: {res['all_ap_50']:.4f}  "
                f"mAP25: {res['all_ap_25']:.4f}")
        return res

    if args.eval_only:
        return run_eval(state)

    train_sets = [DATASETS.build(dict(c)) for c in cfg.data["train_main"]]
    dataset = ConcatDataset(train_sets)
    bsz = cfg.data.get("train_batch_size", 4)
    accum = args.accum_steps or cfg.get("accum_steps", 1)
    if bsz % accum != 0:
        raise SystemExit(f"train_batch_size={bsz} not divisible by "
                         f"accum_steps={accum}")
    train_plan_cfg = dict(host_plan_args(cfg.model, train=True),
                          voxel_cap=caps.num_voxels)
    if ratios:
        train_plan_cfg["level_cap_ratios"] = tuple(ratios)
    train_loader = TrainLoader(
        dataset, bsz, spec, seed=args.seed,
        sync_scale=cfg.data.get("sync_scale", True),
        num_workers=cfg.data.get("num_workers", 4),
        worker_mode=cfg.data.get("worker_mode", "thread"),
        shm_transport=cfg.data.get("shm_transport", True),
        process_index=rank, process_count=n_proc,
        mesh_shards=accum, host_plan_cfg=train_plan_cfg, device=device)
    step = TrainStep(model, criterion, optimizer, ema, accum_steps=accum,
                     process_group=(torch.distributed.group.WORLD
                                    if torch.distributed.is_initialized()
                                    else None))
    return train_loop(
        step_fn=step, state=state, train_loader=train_loader,
        num_iterations=cfg.get("num_iterations", 1000),
        schedule_fn=sched, logger=logger,
        print_freq=cfg.get("print_freq", 10),
        save_step=cfg.get("save_step", 1000),
        eval_step=cfg.get("eval_step"), eval_fn=run_eval,
        work_dir=args.work_dir, seed=args.seed,
        eval_first=args.eval_first,
        profile_steps=(tuple(int(x) for x in args.profile_steps.split(":"))
                       if args.profile_steps else None))


if __name__ == "__main__":
    main()
