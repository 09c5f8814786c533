"""Config-driven model assembly, on the config schema of the JAX package.

Counterpart of ``segdino3d_tpu/builder.py:build_model`` for the
Res16UNet34C or SpConvUNet + ScanNetQueryDecoder model, with its criterion
(``build_criterion``).  The conv layout is a property of the plan, and the
backbone config's layout settings are honoured through the host plan:
``host_plan_args`` turns ``block_edges`` and ``stem_gather`` (eval) or
``block_edges_train`` (training, falling back to ``block_edges``) into the
arguments of ``data.collate.attach_host_plan``, as ``train_3d.py`` does.
The flagship config's eval plan is the hybrid layout (a gather k5 stem,
block-dense convs everywhere else), its training plan block-dense with a
dense stem.  A batch with a host plan runs on it; a batch without one gets
a gather-layout plan built on the device by the backbone, at the
capacities of ``Capacities``.  Every decoder option and every
``SegDINO3D`` argument the JAX builder reads is built; an unknown decoder
key raises ``KeyError``, and a combination the JAX decoder rejects
``ValueError``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from segdino3d_tpu_torch.device import resolve_device
from segdino3d_tpu_torch.models.architecture.segdino3d import SegDINO3D
from segdino3d_tpu_torch.models.backbone.res16unet import Res16UNet34C
from segdino3d_tpu_torch.models.backbone.spconv_unet import SpConvUNet
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
    ``Capacities`` field of this name sizes host plans instead.)
    ``num_points``, ``num_instances`` and ``num_queries2d`` (with
    ``num_superpoints``) are the training entry point's ``PadSpec``."""
    num_superpoints: int = 2048
    num_voxels: Optional[int] = 131072
    level_cap_ratios: Tuple[float, ...] = (1.0, 0.7, 0.35, 0.12, 0.05)
    num_points: int = 262144
    num_instances: int = 256
    num_queries2d: int = 256

    @staticmethod
    def from_cfg(cfg: Optional[Dict]) -> "Capacities":
        """The config's ``capacities`` dict (``configs/models/base_3d.py``);
        keys that are no field are ignored, as in the JAX package."""
        if cfg is None:
            return Capacities()
        kw = {k: v for k, v in cfg.items()
              if k in Capacities.__dataclass_fields__}
        if kw.get("level_cap_ratios") is not None:
            kw["level_cap_ratios"] = tuple(kw["level_cap_ratios"])
        return Capacities(**kw)


# every field of the JAX ScanNetQueryDecoder, a constructor argument here
_DECODER_ARGS = (
    "num_layers", "num_instance_classes", "num_semantic_classes",
    "num_instance_queries", "num_semantic_queries", "num_semantic_linears",
    "in_channels", "d_model", "num_heads", "hidden_dim", "dropout",
    "activation_fn", "iter_pred", "attn_mask", "objectness_flag",
    "add_dinox_query_ca", "add_dinox_query_ca_mask",
    "dinox_query_ca_mask_threshold", "mask_attention_threshold",
    "add_positional_embedding", "pos_type", "temperature", "gauss_scale",
    "add_box_size_pred", "box_modulate_ca", "normalize_box_prediction",
    "use_activation_checkpoint", "compute_dtype")
# the registry key, and fix_attention, which the JAX decoder declares and
# never reads
_DECODER_IGNORED = ("type", "fix_attention")


def build_decoder(cfg: Dict, dinox_dim: int) -> ScanNetQueryDecoder:
    """The decoder of ``cfg`` (a ``decoder_cfg``); an unknown key raises
    ``KeyError``, a combination the JAX decoder rejects ``ValueError``."""
    kwargs = {}
    for key, value in cfg.items():
        if key in _DECODER_ARGS:
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
    bcfg = dict(cfg["pointcloud_backbone_cfg"])
    voxel_size = bcfg.get("voxel_size", 0.02)
    spconv = bcfg.get("type") == "SpConvUNet"
    if spconv:
        in_channels = bcfg.get("in_channels", 262)
        unet = SpConvUNet(num_planes=bcfg.get("num_planes",
                                              (32, 64, 96, 128, 160)),
                          block_reps=bcfg.get("block_reps", 2),
                          in_channels=in_channels,
                          bn_momentum=bcfg.get("bn_momentum", 0.1))
    elif bcfg.get("type") == "Res16UNet34C":
        in_channels = bcfg.get("in_channels", 259)
        unet = Res16UNet34C(in_channels=in_channels,
                            out_channels=bcfg.get("out_channels", 96),
                            config=bcfg.get("config"))
    else:
        raise NotImplementedError(f"backbone {bcfg.get('type')} is not ported")
    # the SpConvUNet path adds the centred xyz to the point features and
    # shifts its grid by each scene's exact minimum (see the wrapper)
    backbone = SparseBackboneWrapper(
        unet, caps.level_cap_ratios, voxel_size=voxel_size,
        s_cap=caps.num_superpoints,
        mode_fuse_2d_feat=bcfg.get("mode_fuse_2d_feat", "early_fusion"),
        compute_dtype=bcfg.get("compute_dtype", "float32"),
        voxel_cap=caps.num_voxels, include_centered_xyz=spconv,
        exact_min_shift=spconv)
    # DINO-X query features share the per-point 2D feature width: the
    # input less rgb and, on the SpConvUNet path, the centred xyz (0 with
    # "only_rgb", where the decoder has no DINO-X cross-attention)
    decoder = build_decoder(dict(cfg["decoder_cfg"]),
                            dinox_dim=in_channels - (6 if spconv else 3))
    model = SegDINO3D(backbone, decoder, voxel_size=voxel_size,
                      query_thr=cfg.get("query_thr", 0.5),
                      mode_3d_center=cfg.get("mode_3d_center", "median"),
                      query_num=cfg.get("query_num", -1),
                      add_positional_embedding=cfg.get(
                          "add_positional_embedding", True),
                      num_classes=cfg.get("num_classes", 198))
    return model.to(device).train(train), dict(cfg.get("test_cfg", {}))


def host_plan_args(model_cfg: Dict, train: bool = False) -> Dict:
    """The host-plan arguments (``data.collate.attach_host_plan``) that
    the backbone config names: voxel size, stem kernel and layout; for
    training ``block_edges_train``, else ``block_edges``, ``stem_gather``
    and, where the config names them, ``stem_compact`` and
    ``stem_compact_slots`` (``train_3d.py``'s eval and training plans).
    SpConvUNet's plans have a k3 stem and the exact min shift."""
    bcfg = model_cfg["pointcloud_backbone_cfg"]
    edges = bcfg.get("block_edges")
    if train:
        edges = bcfg.get("block_edges_train", edges)
    if edges is not None:
        edges = tuple(int(e) for e in edges)
        if any(e and e not in EDGES for e in edges):
            raise NotImplementedError(f"block edges {edges}: the block conv "
                                      f"takes {EDGES}")
    spconv = bcfg.get("type") == "SpConvUNet"
    args = dict(voxel_size=bcfg.get("voxel_size", 0.02),
                stem_kernel=3 if spconv else (bcfg.get("config") or {}).get(
                    "conv1_kernel_size", 5),
                block_edges=edges)
    if spconv:
        args["exact_min_shift"] = True
    if not train:
        args["stem_gather"] = bool(bcfg.get("stem_gather", False))
        # the compacted stem is eval only; off unless the config names it
        for key in ("stem_compact", "stem_compact_slots"):
            if key in bcfg:
                args[key] = bcfg[key]
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
    positive variance, and a Fourier PE's Gaussian matrix N(0,
    gauss_scale^2)."""
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
        if isinstance(m, ScanNetQueryDecoder) and hasattr(m, "gauss_B"):
            m.gauss_B.copy_(normal(m.gauss_B.shape, m.gauss_scale))
    return model
