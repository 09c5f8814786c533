"""Serving export: a ``torch.export`` artifact of the inference step that
runs without the model code.

Counterpart of ``tools/export_serving.py`` (``jax.export``).  The flagship
inference step (backbone + decoder + each scene's ``predict_instance``,
the instance masks bit-packed) is traced by ``torch.export`` into one
graph with the weights inside.  Every hand-written kernel of the eval
forward is a registered op of that graph (``ops/custom_ops.py``), so on
the card the artifact launches the same kernels as the eager forward.  A
serving process loads the artifact with ``load_artifact``, which imports
``ops/custom_ops.py`` and nothing of ``models/``, the builder or the
registry, and runs it; the host keeps only collate and the C++ sparse plan
(``serving_batch``).

Usage:
    python -m segdino3d_tpu_torch.tools.export_serving --out DIR \\
        [--device cuda|cpu] [--points 131072] [--sp 1536] [--batch 1] \\
        [--scene-points 120000] [--tiny] [--run] [--ckpt WORK_DIR|FILE.pth] \\
        [--kernel_order x_slowest|x_fastest]

With ``--tiny`` the sizes default to 2,048 points, 64 superpoints and
1,500-point scenes.  The device is the card unless ``--device`` names one;
without a card and without ``--device`` the tool raises.
``SEGDINO_COMPUTE_DTYPE`` sets the backbone's dtype (bf16 by default, as
the JAX tool) and ``SEGDINO_DECODER_DTYPE`` the decoder's (fp32 by
default).

Artifact layout:
    model.pt2   ``torch.export.save`` of f(*batch_leaves), weights inside
    meta.json   the device, the dtypes, PadSpec, the plan's arguments (with
                the block capacities the graph was traced at) and, per
                batch leaf, its shape, dtype and key path
                (``batch_leaf_paths``, ``data.collate.batch_leaves``
                order): the input contract.  Every served batch is built
                at these capacities (``serving_batch``).
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from segdino3d_tpu_torch.data.collate import (PadSpec, attach_host_plan,
                                              batch_leaves, batch_skeleton,
                                              collate, fill_skeleton)
from segdino3d_tpu_torch.device import resolve_device

# the hybrid host plan the JAX tool exports (``tools/export_serving.py``)
VOXEL_CAP = 92160
LEVEL_CAP_RATIOS = (1.0, 0.4, 0.15, 0.06, 0.025)
TINY_VOXEL_CAP = 4096
TINY_LEVEL_CAP_RATIOS = (1.0, 0.6, 0.4, 0.3, 0.2)
BLOCK_EDGES = (4, 4, 4, 4, 4)


def model_config(tiny: bool, compute_dtype: str, decoder_dtype: str
                 ) -> Dict:
    """The model of ``__graft_entry__._build`` (the JAX tool's): the
    flagship at full width (6 decoder layers, d_model 256, 200 semantic
    and 198 instance classes, 256-channel DINO-X features), or its tiny
    form (2 layers, d_model 64, 20 / 18 classes, 32 channels)."""
    n_inst, n_sem, layers, d_model, feat2d = (
        (18, 20, 2, 64, 32) if tiny else (198, 200, 6, 256, 256))
    return dict(
        type="SegDINO3D", num_classes=n_inst, query_thr=0.5,
        mode_3d_center="median", add_positional_embedding=True,
        pointcloud_backbone_cfg=dict(
            type="Res16UNet34C", in_channels=feat2d + 3, out_channels=96,
            voxel_size=0.02, mode_fuse_2d_feat="early_fusion",
            compute_dtype=compute_dtype,
            config=dict(conv1_kernel_size=5, bn_momentum=0.02)),
        decoder_cfg=dict(
            type="ScanNetQueryDecoder", num_layers=layers,
            num_instance_classes=n_inst, num_semantic_classes=n_sem,
            in_channels=96, d_model=d_model, num_heads=8, hidden_dim=1024,
            compute_dtype=decoder_dtype, dropout=0.0, activation_fn="gelu",
            iter_pred=True, attn_mask=True, fix_attention=True,
            objectness_flag=False, add_dinox_query_ca=True,
            add_dinox_query_ca_mask=True, add_positional_embedding=True,
            pos_type="sine", temperature=20, add_box_size_pred=True,
            box_modulate_ca=True, normalize_box_prediction=True),
        test_cfg=dict(topk_insts=600, inst_score_thr=0.0, pan_score_thr=0.5,
                      npoint_thr=100, obj_normalization=True,
                      sp_score_thr=0.4, nms=True,
                      matrix_nms_kernel="linear", stuff_classes=[0, 1]))


def pad_spec(n_points: int, s_cap: int, tiny: bool) -> PadSpec:
    """The served ``PadSpec``: the JAX tool's instance, query and class
    capacities."""
    return PadSpec(n_points, s_cap, 8 if tiny else 64, 16 if tiny else 128,
                   20 if tiny else 200)


def scene_records(seeds: Sequence[int], n_scene_points: int, s_cap: int,
                  tiny: bool) -> List[Dict]:
    """Synthetic scenes: the JAX tool's tiny scenes, or the headline scene
    of ``chip_smoke.py`` and the JAX bench (24 instances, 180 classes,
    fp16 DINO-X features)."""
    from segdino3d_tpu_torch.data.synthetic import synthetic_scene

    if tiny:
        return [synthetic_scene(i, n_points=n_scene_points, n_instances=6,
                                n_superpoints=s_cap, n_classes=18,
                                n_queries2d=8, feat_dim_2d=32)
                for i in seeds]
    recs = []
    for i in seeds:
        r = synthetic_scene(i, n_points=n_scene_points, n_instances=24,
                            n_superpoints=s_cap, n_classes=180,
                            feat_dim_2d=256)
        r["points_2dfeats"] = r["points_2dfeats"].astype(np.float16)
        recs.append(r)
    return recs


def plan_args(tiny: bool, voxel_cap: Optional[int] = None,
              block_caps: Optional[Sequence[int]] = None) -> Dict:
    """``attach_host_plan``'s arguments: the hybrid layout (a gather k5
    stem, block-dense levels of edge 4) at a fixed voxel cap (the JAX
    tool's unless ``voxel_cap`` is given)."""
    if voxel_cap is None:
        voxel_cap = TINY_VOXEL_CAP if tiny else VOXEL_CAP
    return dict(voxel_size=0.02, voxel_cap=int(voxel_cap),
                level_cap_ratios=(TINY_LEVEL_CAP_RATIOS if tiny
                                  else LEVEL_CAP_RATIOS),
                block_edges=list(BLOCK_EDGES), stem_gather=True,
                block_caps=None if block_caps is None else list(block_caps))


def build_infer_fn(model, test_cfg: Dict, batch_size: int):
    """batch -> per-scene packed instance predictions, stacked: the eval
    forward and ``evaluation.evaluate.served_instances``."""
    from segdino3d_tpu_torch.evaluation.evaluate import served_instances

    def infer(batch):
        if batch.batch_size != batch_size:
            raise ValueError(f"a batch of {batch.batch_size} scenes, the "
                             f"artifact serves {batch_size}")
        if batch.plan is None:
            raise ValueError("the artifact serves batches with a host plan")
        return served_instances(model(batch), batch, test_cfg)

    return infer


class _Served(torch.nn.Module):
    """``infer`` over the batch's leaves (``batch_leaves`` order)."""

    def __init__(self, model, test_cfg: Dict, batch_size: int, skeleton):
        super().__init__()
        self.model = model
        self.infer = build_infer_fn(model, test_cfg, batch_size)
        self.skeleton = skeleton

    def forward(self, *leaves):
        return self.infer(fill_skeleton(self.skeleton, leaves))


def _load_ckpt_state(ckpt: str, model, kernel_order: str) -> None:
    """Trained weights into ``model``: a port ``work_dir`` written by the
    training loop (its newest checkpoint; the EMA parameters where it holds
    them, as eval swaps them in) or a reference ``.pth`` translated by
    ``train/torch_import`` and merged."""
    from segdino3d_tpu_torch.train import checkpoint as C

    if ckpt.endswith((".pth", ".pt", ".pkl")):
        from segdino3d_tpu_torch.train.torch_import import import_checkpoint

        sd, unmapped = import_checkpoint(ckpt, kernel_order=kernel_order)
        if unmapped:
            print(f"[export] {len(unmapped)} unmapped torch keys, "
                  f"e.g. {unmapped[:3]}")
        C.merge_pretrained(model, sd)
        return
    step = C.latest_step(ckpt)
    if step is None:
        raise SystemExit(f"no checkpoint found under {ckpt}")
    blob = torch.load(C._path(ckpt, step), map_location="cpu",
                      weights_only=True)
    model.load_state_dict(blob["model"], strict=True)
    ema = blob.get("ema_model")
    if ema is not None:
        params = dict(model.named_parameters())
        with torch.no_grad():
            for k, v in ema.items():
                params[k].copy_(v)
    print(f"[export] restored step {step} from {ckpt} "
          f"({'EMA' if ema is not None else 'raw'} params)")


def export_artifact(out_dir: str, device=None, n_points: int = 131072,
                    s_cap: int = 1536, batch_size: int = 1,
                    n_scene_points: int = 120000, tiny: bool = False,
                    ckpt: Optional[str] = None,
                    kernel_order: str = "x_slowest", *,
                    records: Optional[List[Dict]] = None,
                    voxel_cap: Optional[int] = None,
                    block_caps: Optional[Sequence[int]] = None,
                    state_dict: Optional[Dict] = None,
                    test_cfg: Optional[Dict] = None):
    """Export the inference step at the served capacities into
    ``out_dir``; returns (exported program, the model's state dict, the
    batch's leaves, meta, the eager function of the leaves).

    The weights: ``ckpt`` (``_load_ckpt_state``), else ``state_dict``,
    else seeded random ones (smoke runs).  The batch: ``records`` (else
    ``batch_size`` synthetic scenes) collated on ``device`` with the hybrid
    host plan at ``voxel_cap`` and ``block_caps`` where given
    (``data.collate.probe_plan_caps`` of the scenes to serve pins one
    shape for all of them), else at the JAX tool's voxel cap and the
    batch's bucketed block capacities; the meta records them either way.
    ``test_cfg`` entries replace the model config's post-processing
    settings that ``predict_instance`` reads (``topk_insts``,
    ``sp_score_thr``, ``obj_normalization``...: seeded random weights
    keep no instance under the flagship's own); the score threshold stays
    0.0, as in the JAX tool.  The meta records the result."""
    from segdino3d_tpu_torch.builder import (Capacities, build_model,
                                             random_init_)
    from segdino3d_tpu_torch.ops import cuda_build

    dev = resolve_device(device)
    compute_dtype = os.environ.get("SEGDINO_COMPUTE_DTYPE", "bfloat16")
    decoder_dtype = os.environ.get("SEGDINO_DECODER_DTYPE", "float32")
    cfg = model_config(tiny, compute_dtype, decoder_dtype)
    cfg["test_cfg"].update(test_cfg or {})
    if dev.type == "cuda":
        cuda_build.build_all()
    # initialise on tiny capacities (the weights do not depend on them),
    # then build the model again at the served ones: the backbone clips
    # superpoint ids to s_cap - 1, so a model built smaller than the
    # served batch would fold superpoints >= s_cap into its last slot
    init, _ = build_model(cfg, Capacities(num_superpoints=64,
                                          num_voxels=1024), device="cpu")
    if ckpt:
        _load_ckpt_state(ckpt, init, kernel_order)
    elif state_dict is not None:
        init.load_state_dict(state_dict)
    else:
        random_init_(init, seed=0)
    spec = pad_spec(n_points, s_cap, tiny)
    model, served_cfg = build_model(cfg, Capacities(
        num_superpoints=s_cap, num_voxels=n_points * batch_size,
        num_points=n_points, num_instances=spec.num_instances,
        num_queries2d=spec.num_queries2d), device=dev)
    model.load_state_dict(init.state_dict())
    model.eval()
    assert model.backbone.s_cap == spec.num_superpoints, \
        (model.backbone.s_cap, spec)

    if records is None:
        records = scene_records(range(batch_size), n_scene_points, s_cap,
                                tiny)
    if len(records) != batch_size:
        raise ValueError(f"{len(records)} records for a batch of "
                         f"{batch_size}")
    plan_kw = plan_args(tiny, voxel_cap, block_caps)
    batch = attach_host_plan(collate(records, spec, dev), records, spec,
                             **plan_kw)
    plan_kw["block_caps"] = [0 if t is None else t.num_blocks
                             for t in batch.plan.blocks]
    paths, leaves = batch_leaves(batch)
    served = _Served(model, served_cfg, batch_size, batch_skeleton(batch))
    with torch.no_grad():
        ep = torch.export.export(served, tuple(leaves), strict=False)

    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(ep, os.path.join(out_dir, "model.pt2"))
    meta = dict(
        platform=dev.type, batch_size=batch_size,
        compute_dtype=compute_dtype, decoder_dtype=decoder_dtype,
        n_batch_leaves=len(leaves),
        batch_leaf_shapes=[list(x.shape) for x in leaves],
        batch_leaf_dtypes=[str(x.dtype).replace("torch.", "")
                           for x in leaves],
        batch_leaf_paths=paths, ckpt=ckpt,
        pad_spec=dict(n_points=n_points, s_cap=s_cap,
                      i_cap=spec.num_instances, k2d=spec.num_queries2d,
                      n_sem=spec.num_semantic_classes),
        plan=dict((k, list(v) if isinstance(v, (tuple, list)) else v)
                  for k, v in plan_kw.items()),
        n_scene_points=n_scene_points, tiny=tiny, test_cfg=served_cfg)
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)

    def eager(*batch_tensors):
        with torch.no_grad():
            return served(*batch_tensors)

    return ep, model.state_dict(), leaves, meta, eager


def serving_batch(records: List[Dict], meta: Dict, device=None
                  ) -> List[torch.Tensor]:
    """The leaves of ``records`` as the artifact takes them: collated and
    planned on ``device`` at the artifact's capacities (``meta``), in
    ``batch_leaf_paths`` order.  A scene past a capacity raises."""
    dev = resolve_device(device)
    p = meta["pad_spec"]
    spec = PadSpec(p["n_points"], p["s_cap"], p["i_cap"], p["k2d"],
                   p["n_sem"])
    plan = dict(meta["plan"])
    plan["level_cap_ratios"] = tuple(plan["level_cap_ratios"])
    batch = attach_host_plan(collate(records, spec, dev), records, spec,
                             **plan)
    paths, leaves = batch_leaves(batch)
    shapes = [list(x.shape) for x in leaves]
    if paths != meta["batch_leaf_paths"] or \
            shapes != meta["batch_leaf_shapes"]:
        raise ValueError("the batch does not match the artifact's input "
                         "contract (batch_leaf_paths / batch_leaf_shapes)")
    return leaves


def load_artifact(out_dir: str):
    """Returns (call, meta): ``call(batch_leaves) -> outputs``, the
    exported graph with its weights; it needs the registered ops
    (``ops/custom_ops.py``), not the model code."""
    from segdino3d_tpu_torch.ops import custom_ops  # noqa: F401 (the ops)

    ep = torch.export.load(os.path.join(out_dir, "model.pt2"))
    with open(os.path.join(out_dir, "meta.json")) as f:
        meta = json.load(f)
    module = ep.module()

    def call(batch_leaves):
        with torch.no_grad():
            return module(*batch_leaves)

    return call, meta


def main(argv: Optional[Sequence[str]] = None
         ) -> Optional[Dict[str, torch.Tensor]]:
    """The command line; returns the reloaded artifact's outputs under
    ``--run``, else None."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default=None,
                    help="cuda|cpu; default the card (raises without one)")
    ap.add_argument("--points", type=int, default=None,
                    help="padded points a scene (131072; --tiny 2048)")
    ap.add_argument("--sp", type=int, default=None,
                    help="superpoint capacity (1536; --tiny 64)")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--scene-points", type=int, default=None,
                    help="points of the synthetic scenes (120000; --tiny "
                         "1500)")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny model and shapes (tests, smoke runs)")
    ap.add_argument("--run", action="store_true",
                    help="reload the artifact and execute it once")
    ap.add_argument("--ckpt", default=None,
                    help="trained weights: a work_dir of the port's "
                         "training loop, or a reference .pth; default "
                         "seeded random weights (smoke only)")
    ap.add_argument("--kernel_order", default="x_slowest",
                    choices=["x_slowest", "x_fastest"])
    args = ap.parse_args(argv)
    points, sp, scene_points = (2048, 64, 1500) if args.tiny \
        else (131072, 1536, 120000)

    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    _ep, _sd, leaves, meta, _fn = export_artifact(
        args.out, dev, args.points or points, args.sp or sp, args.batch,
        args.scene_points or scene_points, tiny=args.tiny, ckpt=args.ckpt,
        kernel_order=args.kernel_order)
    size = os.path.getsize(os.path.join(args.out, "model.pt2"))
    print(f"exported device={dev.type} model.pt2={size / 1e6:.1f}MB in "
          f"{time.perf_counter() - t0:.1f} s ({meta['n_batch_leaves']} "
          f"batch leaves, backbone {meta['compute_dtype']})")
    if args.run:
        call, meta = load_artifact(args.out)
        out = call(leaves)
        v = out["valid"].cpu().numpy()
        print(f"ran: {int(v.sum())} valid instances / {v.size} slots; "
              f"score[0]={float(out['scores'][0, 0]):.4f}")
        return out
    return None


if __name__ == "__main__":
    main()
