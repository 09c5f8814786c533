"""The reference's torch checkpoints (``.pth``) loaded into the port.

Counterpart of ``segdino3d_tpu/train/torch_import.py``, which translates
the reference's state dict into the JAX package's flax tree.  Here each
reference key maps straight onto the port's state-dict key (the flax
names through ``convert.py``'s rule), and the arrays stay in torch's
layouts where the two agree:

* a ``module.`` prefix is stripped (``clean_state_dict``);
* ``nn.Linear`` and LayerNorm / BatchNorm tensors keep their names and
  layouts (the JAX package's transposes cancel against ``convert.py``'s);
* MinkowskiEngine kernels ``(kernel_volume, Cin, Cout)`` are permuted into
  the canonical offset order (``kernel_permutation``; the default
  ``x_slowest`` is the identity, see the JAX module for its derivation),
  and a 1x1 ME kernel becomes the residual projection's ``(Cout, Cin)``
  weight;
* spconv 5-d kernels in either v2.x layout, KRSC ``(Cout, k, k, k, Cin)``
  or RSCK ``(k, k, k, Cin, Cout)``, sniffed by shape, become ``(k^3, Cin,
  Cout)``; spconv's kernel-volume index is row-major, the canonical order;
* ``nn.MultiheadAttention``'s packed ``in_proj_weight`` / ``in_proj_bias``
  split into the q, k and v projections (the decoder's DINO-X
  cross-attention);
* BN running statistics land on the ``running_mean`` / ``running_var``
  buffers; ``num_batches_tracked`` is dropped.

``import_state_dict`` returns ``(state_dict, unmapped)``;
``import_checkpoint`` reads a file with ``torch.load`` (tensors only);
``load_reference_checkpoint`` loads one into a model and raises unless
every key of the model gets exactly one value of its shape.
"""
from __future__ import annotations

import itertools
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn


def kernel_permutation(k: int, order: str) -> np.ndarray:
    """Permutation from the ME kernel-offset order to the canonical one
    (x slowest): the identity for ``x_slowest``, the transposed
    enumeration for ``x_fastest``."""
    if order == "x_slowest":
        return np.arange(k ** 3)
    if order != "x_fastest":
        raise ValueError(f"unknown kernel order {order!r}")
    perm = np.zeros(k ** 3, np.int64)
    for ours, (x, y, z) in enumerate(itertools.product(range(k), repeat=3)):
        perm[ours] = x + k * y + k * k * z
    return perm


def clean_state_dict(sd: Dict) -> Dict:
    return {(k[7:] if k.startswith("module.") else k): v
            for k, v in sd.items()}


def _me_kernel(t: torch.Tensor, order: str) -> torch.Tensor:
    """(kernel_volume, Cin, Cout) ME kernel -> canonical offset order."""
    vol = t.shape[0]
    k = round(vol ** (1 / 3))
    if k ** 3 == vol and vol > 1:
        return t[torch.from_numpy(kernel_permutation(k, order))]
    return t


def _spconv_kernel(t: torch.Tensor) -> torch.Tensor:
    """spconv 5-d kernel -> (k^3, Cin, Cout): KRSC when dims 1-3 are the
    (equal) spatial ones, else RSCK."""
    if t.dim() != 5:
        return t
    if t.shape[1] == t.shape[2] == t.shape[3]:        # KRSC
        t = t.movedim(0, -1)
    return t.reshape(-1, t.shape[-2], t.shape[-1])


_BN = ("weight", "bias", "running_mean", "running_var")
_RES16_CONV = re.compile(
    r"backbone\.(conv0p1s1|conv\dp\d+s2|convtr\dp\d+s2)\.kernel$")
_RES16_BN = re.compile(r"backbone\.(bn\d|bntr\d)\.bn\.(\w+)$")
_RES16_BLOCK_CONV = re.compile(r"backbone\.block(\d)\.(\d)\.conv(\d)\.kernel$")
_RES16_BLOCK_BN = re.compile(
    r"backbone\.block(\d)\.(\d)\.norm(\d)\.bn\.(\w+)$")
_RES16_DOWN = re.compile(r"backbone\.block(\d)\.(\d)\.downsample\.0\.kernel$")
_RES16_DOWN_BN = re.compile(
    r"backbone\.block(\d)\.(\d)\.downsample\.1\.bn\.(\w+)$")
_SP_BLOCK = re.compile(r"backbone\.((?:u\.)*)(blocks|blocks_tail)\.block(\d)\."
                       r"(conv_branch|i_branch)\.(\d)\.(\w+)$")
_SP_UPDOWN = re.compile(r"backbone\.((?:u\.)*)(conv|deconv)\.(\d)\.(\w+)$")
# the pre-norm block's conv_branch: 0 BN, 1 ReLU, 2 conv1, 3 BN, 4 ReLU,
# 5 conv2
_SP_BRANCH = {0: "norm1", 2: "conv1", 3: "norm2", 5: "conv2"}
_LINEAR = r"(weight|bias)$"


def _bn(base: str, leaf: str, t: torch.Tensor):
    return [(f"{base}.{leaf}", t)] if leaf in _BN else []


def _translate(k: str, t: torch.Tensor, kernel_order: str
               ) -> Optional[List[Tuple[str, torch.Tensor]]]:
    """One reference key -> [(port key, tensor), ...] ([] for a key with
    no counterpart, such as ``num_batches_tracked``), or None if unknown."""
    u = "backbone.unet"
    # ======================= Res16UNet backbone ==========================
    m = _RES16_CONV.match(k)
    if m:
        return [(f"{u}.{m[1]}.kernel", _me_kernel(t, kernel_order))]
    m = _RES16_BN.match(k)
    if m:
        return _bn(f"{u}.{m[1]}", m[2], t)
    m = _RES16_BLOCK_CONV.match(k)
    if m:
        return [(f"{u}.block{m[1]}.{m[2]}.conv{m[3]}.kernel",
                 _me_kernel(t, kernel_order))]
    m = _RES16_BLOCK_BN.match(k)
    if m:
        return _bn(f"{u}.block{m[1]}.{m[2]}.norm{m[3]}", m[4], t)
    m = _RES16_DOWN.match(k)
    if m:
        # a 1x1 ME kernel (1, Cin, Cout) or (Cin, Cout) -> Linear (Cout, Cin)
        a = t[0] if t.dim() == 3 else t
        return [(f"{u}.block{m[1]}.{m[2]}.downsample_conv.weight", a.T)]
    m = _RES16_DOWN_BN.match(k)
    if m:
        return _bn(f"{u}.block{m[1]}.{m[2]}.downsample_norm", m[3], t)

    # ========================= SpConvUNet backbone =======================
    # the recursive "u." * level nesting flattened to per-level names
    m = _SP_BLOCK.match(k)
    if m:
        stage = "blocks" if m[2] == "blocks" else "tail"
        base = f"{u}.{stage}_l{m[1].count('u.')}.{m[3]}"
        branch, idx, leaf = m[4], int(m[5]), m[6]
        if branch == "i_branch":
            if leaf != "weight":
                return []
            # a k1 SubMConv3d (5-d) or a Linear (Cout, Cin)
            a = _spconv_kernel(t)[0].T if t.dim() == 5 else t
            return [(f"{base}.i_branch.weight", a)]
        name = _SP_BRANCH.get(idx)
        if name is None:
            return []
        if name.startswith("conv"):
            return [(f"{base}.{name}.kernel", _spconv_kernel(t))]
        return _bn(f"{base}.{name}", leaf, t)
    m = _SP_UPDOWN.match(k)
    if m:
        lvl, idx, leaf = m[1].count("u."), int(m[3]), m[4]
        kind = "up" if m[2] == "deconv" else "down"
        if idx == 2 and leaf == "weight":   # the strided / inverse conv
            return [(f"{u}.{kind}_conv.{lvl}.kernel", _spconv_kernel(t))]
        if idx == 0:                        # the pre-norm BN
            return _bn(f"{u}.{kind}_norm.{lvl}", leaf, t)
        return []
    if k == "backbone.input_conv.0.weight":
        return [(f"{u}.input_conv.kernel", _spconv_kernel(t))]
    m = re.match(r"backbone\.output_layer\.0\.(\w+)$", k)
    if m:
        return _bn(f"{u}.output_norm", m[1], t)

    # ============================ decoder ================================
    d = "decoder"
    m = re.match(r"decoder\.input_proj\.(0|1)\." + _LINEAR, k)
    if m:
        sub = "input_proj_dense" if m[1] == "0" else "input_proj_norm"
        return [(f"{d}.{sub}.{m[2]}", t)]
    m = re.match(r"decoder\.(x_mask|query_proj)\.(0|2)\." + _LINEAR, k)
    if m:
        return [(f"{d}.{m[1]}{1 if m[2] == '0' else 2}.{m[3]}", t)]
    m = re.match(r"decoder\.out_norm\." + _LINEAR, k)
    if m:
        return [(f"{d}.out_norm.{m[1]}", t)]
    m = re.match(r"decoder\.(out_cls|out_sem|out_score)\.(0|2)\." + _LINEAR, k)
    if m:
        return [(f"{d}.{m[1]}.layers.{m[2]}.{m[3]}", t)]
    m = re.match(r"decoder\.(out_sem|ca_qpos_proj)\." + _LINEAR, k)
    if m:   # out_sem: num_semantic_linears == 1, a plain Linear
        return [(f"{d}.{m[1]}.{m[2]}", t)]
    if k == "decoder.query_embed.weight":
        return [(f"{d}.query_embed.embedding", t)]
    m = re.match(r"decoder\.norm(1|2)\.(\d+)\." + _LINEAR, k)
    if m:
        return [(f"{d}.{'ca' if m[1] == '1' else 'sa'}_norm.{m[2]}.{m[3]}", t)]
    m = re.match(r"decoder\.(cross|self)_attn_layers\.(\d+)\.out_proj\."
                 + _LINEAR, k)
    if m:
        return [(f"{d}.{'ca' if m[1] == 'cross' else 'sa'}_out_proj."
                 f"{m[2]}.{m[3]}", t)]
    m = re.match(r"decoder\.(ca|sa)_(qcontent|kcontent|kpos|qpos|v|qpos_sine)"
                 r"_proj\.(\d+)\." + _LINEAR, k)
    if m:
        return [(f"{d}.{m[1]}_{m[2]}_proj.{m[3]}.{m[4]}", t)]
    m = re.match(r"decoder\.ffn_layers\.(\d+)\.net\.(0|3)\." + _LINEAR, k)
    if m:
        return [(f"{d}.ffn.{m[1]}.{'lin1' if m[2] == '0' else 'lin2'}.{m[3]}",
                 t)]
    m = re.match(r"decoder\.ffn_layers\.(\d+)\.norm\." + _LINEAR, k)
    if m:
        return [(f"{d}.ffn.{m[1]}.norm.{m[2]}", t)]
    m = re.match(r"decoder\.(ref_point_head|ref_anchor_head)\.layers\.(\d+)\."
                 + _LINEAR, k)
    if m:
        return [(f"{d}.{m[1]}.layers.{m[2]}.{m[3]}", t)]
    m = re.match(r"decoder\.(bbox_embed|bbox_size_embed)\.(\d+)\.layers\."
                 r"(\d+)\." + _LINEAR, k)
    if m:
        return [(f"{d}.{m[1]}.{m[2]}.layers.{m[3]}.{m[4]}", t)]
    m = re.match(r"decoder\.dinox_query_cross_attn_layers\.(\d+)\."
                 r"(attn\.in_proj_|attn\.out_proj\.|norm\.)(weight|bias)$", k)
    if m:
        base, part, leaf = f"{d}.dinox_ca.{m[1]}", m[2], m[3]
        if part == "attn.in_proj_":
            n = t.shape[0] // 3
            return [(f"{base}.{p}_proj.{leaf}", t[i * n:(i + 1) * n])
                    for i, p in enumerate("qkv")]
        return [(f"{base}.{'norm' if part == 'norm.' else 'out_proj'}.{leaf}",
                 t)]
    return None


def import_state_dict(sd: Dict, kernel_order: str = "x_slowest"
                      ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """Translate a (cleaned) reference state dict: (the port's state dict,
    the reference keys that map to nothing).  Raises if two reference
    keys map to one port key."""
    out: Dict[str, torch.Tensor] = {}
    unmapped: List[str] = []
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        t = v.detach().cpu() if isinstance(v, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(v))
        res = _translate(k, t, kernel_order)
        if res is None:
            unmapped.append(k)
            continue
        for key, value in res:
            if key in out:
                raise KeyError(f"two reference keys map to {key}")
            out[key] = value.contiguous()
    return out, unmapped


def import_checkpoint(path: str, key: str = "model",
                      kernel_order: str = "x_slowest"
                      ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """Read a reference checkpoint (its ``key`` entry where the file holds
    a dict with one, else the file itself) and translate it.  Only
    tensors and plain containers are unpickled (``weights_only``)."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    sd = blob.get(key, blob) if isinstance(blob, dict) else blob
    return import_state_dict(clean_state_dict(dict(sd)), kernel_order)


def load_reference_checkpoint(model: nn.Module, path: str, key: str = "model",
                              kernel_order: str = "x_slowest"
                              ) -> Tuple[nn.Module, List[str]]:
    """Load a reference checkpoint into ``model``: (model, the checkpoint's
    unmapped keys).  Raises unless every key of the model gets exactly one
    value of its shape and every translated value lands on a key."""
    sd, unmapped = import_checkpoint(path, key, kernel_order)
    want = model.state_dict()
    extra = sorted(set(sd) - set(want))
    missing = sorted(set(want) - set(sd))
    if extra or missing:
        raise KeyError(f"checkpoint values without a port key: {extra[:10]}; "
                       f"port keys without a value: {missing[:10]}")
    for k, v in sd.items():
        if tuple(v.shape) != tuple(want[k].shape):
            raise ValueError(f"{k}: checkpoint shape {tuple(v.shape)}, port "
                             f"shape {tuple(want[k].shape)}")
    model.load_state_dict(sd, strict=True)
    return model, unmapped
