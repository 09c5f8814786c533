"""Config-driven model assembly, on the config schema of the JAX package.

Counterpart of ``segdino3d_tpu/builder.py:build_model`` for the
Res16UNet34C + ScanNetQueryDecoder model, with its criterion
(``build_criterion``).  The conv layout is a property of the plan, and the
backbone config's layout settings are honoured through the host plan:
``host_plan_args`` turns ``block_edges`` and ``stem_gather`` (eval) or
``block_edges_train`` (training, falling back to ``block_edges``) into the
arguments of ``data.collate.attach_host_plan``, as ``train_3d.py`` does.
The flagship config's eval plan is the hybrid layout (a gather k5 stem,
block-dense convs everywhere else), its training plan block-dense with a
dense stem.  A batch with a host plan runs on it; a batch without one gets
a gather-layout plan built on the device by the backbone, at the
capacities of ``Capacities``.  Options the port does not implement raise
instead of being ignored.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from segdino3d_tpu_torch.device import resolve_device
from segdino3d_tpu_torch.models.architecture.segdino3d import SegDINO3D
from segdino3d_tpu_torch.models.backbone.res16unet import Res16UNet34C
from segdino3d_tpu_torch.models.backbone.wrapper import SparseBackboneWrapper
from segdino3d_tpu_torch.models.criterion.losses import \
    ScanNetUnifiedCriterion
from segdino3d_tpu_torch.models.decoder.query_decoder import \
    ScanNetQueryDecoder
from segdino3d_tpu_torch.models.layers import MaskedBatchNorm
from segdino3d_tpu_torch.ops.block_dense import EDGES


@dataclass(frozen=True)
class Capacities:
    """Static shape capacities the model is built for.  ``num_voxels`` and
    ``level_cap_ratios`` size the device plan of a batch without a host
    plan: its level-0 voxels (``None``: the batch's point count) and each
    level's share of them, by default the JAX wrapper's ratios.  (The JAX
    ``Capacities`` field of this name sizes host plans instead.)"""
    num_superpoints: int = 2048
    num_voxels: Optional[int] = 131072
    level_cap_ratios: Tuple[float, ...] = (1.0, 0.7, 0.35, 0.12, 0.05)


# decoder options with the one value the port implements
_DECODER_FIXED = dict(
    iter_pred=True, attn_mask=True, fix_attention=True,
    objectness_flag=False, add_dinox_query_ca=True,
    add_dinox_query_ca_mask=True, add_positional_embedding=True,
    pos_type="sine", add_box_size_pred=True, box_modulate_ca=True,
    normalize_box_prediction=True, num_instance_queries=0,
    num_semantic_queries=0, num_semantic_linears=1, activation_fn="gelu",
    compute_dtype="float32")
_DECODER_ARGS = ("num_layers", "num_instance_classes", "num_semantic_classes",
                 "in_channels", "d_model", "num_heads", "hidden_dim",
                 "mask_attention_threshold", "dinox_query_ca_mask_threshold",
                 "temperature")
# training-only options, without effect on the eval forward
_DECODER_IGNORED = ("type", "dropout", "use_activation_checkpoint",
                    "gauss_scale")


def build_decoder(cfg: Dict, dinox_dim: int) -> ScanNetQueryDecoder:
    kwargs = {}
    for key, value in cfg.items():
        if key in _DECODER_FIXED:
            if value != _DECODER_FIXED[key]:
                raise NotImplementedError(
                    f"decoder option {key}={value!r} is not ported")
        elif key in _DECODER_ARGS:
            kwargs[key] = value
        elif key not in _DECODER_IGNORED:
            raise KeyError(f"unknown decoder option {key}")
    return ScanNetQueryDecoder(dinox_dim=dinox_dim, **kwargs)


def build_model(model_cfg: Dict, caps: Capacities, device=None,
                train: bool = False) -> Tuple[SegDINO3D, Dict]:
    """(SegDINO3D on ``device``, test_cfg); in training mode with
    ``train``, else in eval mode.  The device is the card unless the
    caller names one."""
    device = resolve_device(device)
    cfg = dict(model_cfg)
    if cfg.get("type", "SegDINO3D") not in ("Baseline3D", "SegDINO3D"):
        raise KeyError(f"unknown architecture {cfg['type']}")
    if cfg.get("query_num", -1) > 0:
        raise NotImplementedError("top-k query selection (query_num > 0) "
                                  "is not ported")
    if train and cfg["decoder_cfg"].get("dropout", 0.0):
        raise NotImplementedError("decoder dropout in training is not ported")
    bcfg = dict(cfg["pointcloud_backbone_cfg"])
    if bcfg.get("type") != "Res16UNet34C":
        raise NotImplementedError(f"backbone {bcfg.get('type')} is not ported")
    in_channels = bcfg.get("in_channels", 259)
    voxel_size = bcfg.get("voxel_size", 0.02)
    unet = Res16UNet34C(in_channels=in_channels,
                        out_channels=bcfg.get("out_channels", 96),
                        config=bcfg.get("config"))
    backbone = SparseBackboneWrapper(
        unet, caps.level_cap_ratios, voxel_size=voxel_size,
        s_cap=caps.num_superpoints,
        mode_fuse_2d_feat=bcfg.get("mode_fuse_2d_feat", "early_fusion"),
        compute_dtype=bcfg.get("compute_dtype", "float32"),
        voxel_cap=caps.num_voxels)
    # DINO-X query features share the per-point 2D feature width
    decoder = build_decoder(dict(cfg["decoder_cfg"]), dinox_dim=in_channels - 3)
    model = SegDINO3D(backbone, decoder, voxel_size=voxel_size,
                      query_thr=cfg.get("query_thr", 0.5),
                      mode_3d_center=cfg.get("mode_3d_center", "median"))
    return model.to(device).train(train), dict(cfg.get("test_cfg", {}))


def host_plan_args(model_cfg: Dict, train: bool = False) -> Dict:
    """The host-plan arguments (``data.collate.attach_host_plan``) that
    the backbone config names: voxel size, stem kernel and layout; for
    training ``block_edges_train``, else ``block_edges`` and
    ``stem_gather`` (``train_3d.py``'s eval and training plans)."""
    bcfg = model_cfg["pointcloud_backbone_cfg"]
    edges = bcfg.get("block_edges")
    if train:
        edges = bcfg.get("block_edges_train", edges)
    if edges is not None:
        edges = tuple(int(e) for e in edges)
        if any(e and e not in EDGES for e in edges):
            raise NotImplementedError(f"block edges {edges}: the block conv "
                                      f"takes {EDGES}")
    args = dict(voxel_size=bcfg.get("voxel_size", 0.02),
                stem_kernel=(bcfg.get("config") or {}).get(
                    "conv1_kernel_size", 5),
                block_edges=edges)
    if not train:
        args["stem_gather"] = bool(bcfg.get("stem_gather", False))
    return args


def build_criterion(model_cfg: Dict) -> ScanNetUnifiedCriterion:
    """The criterion of ``model_cfg["criterion_cfg"]``."""
    ccfg = dict(model_cfg["criterion_cfg"])
    if ccfg.pop("type", "ScanNetUnifiedCriterion") != \
            "ScanNetUnifiedCriterion":
        raise NotImplementedError(f"criterion {model_cfg['criterion_cfg']} "
                                  "is not ported")
    return ScanNetUnifiedCriterion(**ccfg)


@torch.no_grad()
def random_init_(model: nn.Module, seed: int) -> nn.Module:
    """Seeded random weights that stay finite through the full-width U-Net:
    every kernel is N(0, 1/fan_in) (raw N(0, 1) convs overflow over ~40
    convs), biases 0, batch-norm running statistics near (0, 1) with a
    positive variance."""
    gen = torch.Generator().manual_seed(seed)

    def normal(shape, std):
        return torch.randn(shape, generator=gen) * std

    for p in model.parameters():
        if p.dim() == 3:        # conv kernel (k^3, Cin, Cout)
            p.copy_(normal(p.shape, (p.shape[0] * p.shape[1]) ** -0.5))
        elif p.dim() == 2:      # nn.Linear (out, in)
            p.copy_(normal(p.shape, p.shape[1] ** -0.5))
    for m in model.modules():
        if isinstance(m, MaskedBatchNorm):
            m.running_mean.copy_(normal(m.running_mean.shape, 0.1))
            m.running_var.copy_(0.5 + normal(m.running_var.shape, 1.0).abs())
        if isinstance(m, nn.Linear) and m.bias is not None:
            m.bias.zero_()
    return model
