"""ScanNet query decoder (DAB-DETR style) over padded dense batches.

Counterpart of ``segdino3d_tpu/models/decoder/query_decoder.py`` with
every option of its dataclass:

* the iterative path (``iter_pred``): prediction heads after the input
  queries and after each layer, mask-attention gating ``sigmoid(mask) <
  thr`` with the all-blocked-row reset (``attn_mask``), and per layer a
  cross-attention over the superpoints, a self-attention among the
  queries, the DINO-X object-query cross-attention (``add_dinox_query_ca``,
  gated by the L1 distance mask with ``add_dinox_query_ca_mask``) and the
  FFN;
* with positional embeddings (``add_positional_embedding``): the sine or
  Fourier PE (``pos_type``) over the scene range, box-modulated
  (``box_modulate_ca``) concat-PE cross-attention, PE-aware
  self-attention, per-layer center offsets and (``add_box_size_pred``)
  size predictions, normalised by the scene extent with
  ``normalize_box_prediction``; without them the plain decoder's standard
  cross- and self-attention blocks (``plain_ca_i`` / ``plain_sa_i``);
* the simple path (``iter_pred=False``, plain decoder only): the stack
  unmasked, one head at the end;
* learned queries (``num_instance_queries`` / ``num_semantic_queries``)
  first, extending ``query_valid``; the objectness head
  (``objectness_flag``); a two-layer semantic head
  (``num_semantic_linears=2``); the FFN's ``activation_fn``;
* dropout (``dropout``) in the FFN and the standard cross-attention blocks
  only, as in JAX, in training mode; the keep masks are drawn before each
  block from the forward's ``generator``;
* activation checkpointing (``use_activation_checkpoint``):
  ``torch.utils.checkpoint`` around the blocks JAX remats (the FFN, the
  standard cross-attention blocks, the PE path's attention cores);
* ``compute_dtype`` on exactly the projections JAX casts (input
  projection, FFN, every attention projection); parameters stay fp32, and
  LayerNorm, the softmax, the heads, the mask logits and the PE stay fp32.

The Fourier PE's Gaussian matrix ``gauss_B`` is a buffer, as the reference
registers it: no optimizer sees it.  The softmax of the attention is fp32
and all-blocked rows give zero (``ops.attention``).

flax defaults kept: LayerNorm ``eps`` 1e-6 and the tanh GELU.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from segdino3d_tpu_torch.models.layers import MLP
from segdino3d_tpu_torch.ops.attention import (LN_EPS, StandardCrossAttention,
                                               apply_dropout, dense,
                                               dropout_keep,
                                               multi_head_attention)
from segdino3d_tpu_torch.ops.pos_embed import (fourier_pos_embed,
                                               sine_pos_embed)


def inverse_sigmoid(x, eps=1e-5):
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))


def _linears(n: int, din: int, dout: int) -> nn.ModuleList:
    return nn.ModuleList(nn.Linear(din, dout) for _ in range(n))


class FFN(nn.Module):
    """lin1 -> activation -> dropout -> lin2 -> dropout, residual, norm."""

    def __init__(self, d_model: int, hidden_dim: int, dropout: float = 0.0,
                 activation_fn: str = "gelu",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dropout = dropout
        self.relu = activation_fn == "relu"
        self.dtype = dtype
        self.lin1 = nn.Linear(d_model, hidden_dim)
        self.lin2 = nn.Linear(hidden_dim, d_model)
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x, keep=None):
        """``keep``: the two dropout masks ((B, Q, hidden), (B, Q, d)), or
        None (no dropout)."""
        k1, k2 = keep if keep is not None else (None, None)
        h = dense(x, self.lin1, self.dtype)
        h = F.relu(h) if self.relu else F.gelu(h, approximate="tanh")
        h = apply_dropout(h, k1, self.dropout)
        h = apply_dropout(dense(h, self.lin2, self.dtype), k2, self.dropout)
        return self.norm(x + h)


class ClsHead(nn.Module):
    """Dense -> ReLU -> Dense (flax ``nn.Sequential`` names layers_0/_2)."""

    def __init__(self, d_model: int, out_dim: int):
        super().__init__()
        self.layers = nn.Sequential(nn.Linear(d_model, d_model), nn.ReLU(),
                                    nn.Linear(d_model, out_dim))

    def forward(self, x):
        return self.layers(x)


class Embed(nn.Module):
    """The learned query table (flax ``nn.Embed``'s ``embedding``)."""

    def __init__(self, num: int, dim: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.randn(num, dim) * dim ** -0.5)


class ScanNetQueryDecoder(nn.Module):
    def __init__(self, num_layers: int = 6, num_instance_classes: int = 198,
                 num_semantic_classes: int = 200,
                 num_instance_queries: int = 0, num_semantic_queries: int = 0,
                 num_semantic_linears: int = 1, in_channels: int = 96,
                 d_model: int = 256, num_heads: int = 8,
                 hidden_dim: int = 1024, dropout: float = 0.0,
                 activation_fn: str = "gelu", iter_pred: bool = True,
                 attn_mask: bool = True, objectness_flag: bool = False,
                 add_dinox_query_ca: bool = True,
                 add_dinox_query_ca_mask: bool = True,
                 dinox_query_ca_mask_threshold: float = 0.2,
                 mask_attention_threshold: float = 0.5,
                 add_positional_embedding: bool = True,
                 pos_type: str = "sine", temperature: float = 20.0,
                 gauss_scale: float = 1.0, add_box_size_pred: bool = True,
                 box_modulate_ca: bool = True,
                 normalize_box_prediction: bool = True,
                 use_activation_checkpoint: bool = False,
                 compute_dtype: str = "float32", dinox_dim: int = 256):
        super().__init__()
        n_learned = num_instance_queries + num_semantic_queries
        # the JAX decoder asserts on these two at its first call
        if n_learned > 0 and add_positional_embedding:
            raise ValueError("learned queries carry no 3D reference point: "
                             "num_instance_queries / num_semantic_queries > "
                             "0 needs add_positional_embedding=False")
        if not iter_pred and add_positional_embedding:
            raise ValueError("iter_pred=False is implemented for the plain "
                             "(non-PE) decoder only")
        D, L = d_model, num_layers
        dt = None if compute_dtype == "float32" else getattr(torch,
                                                             compute_dtype)
        self.num_layers = num_layers
        self.d_model = d_model
        self.num_heads = num_heads
        self.num_instance_queries = num_instance_queries
        self.n_learned = n_learned
        self.dropout = dropout
        self.iter_pred = iter_pred
        self.attn_mask = attn_mask
        self.objectness_flag = objectness_flag
        self.add_dinox_query_ca = add_dinox_query_ca
        self.add_dinox_query_ca_mask = add_dinox_query_ca_mask
        self.dinox_query_ca_mask_threshold = dinox_query_ca_mask_threshold
        self.mask_attention_threshold = mask_attention_threshold
        self.add_positional_embedding = add_positional_embedding
        self.fourier = pos_type == "fourier"
        self.temperature = temperature
        self.gauss_scale = gauss_scale
        self.add_box_size_pred = add_box_size_pred
        self.box_modulate_ca = box_modulate_ca
        self.normalize_box_prediction = normalize_box_prediction
        self.use_activation_checkpoint = use_activation_checkpoint
        self.dt = dt

        self.input_proj_dense = nn.Linear(in_channels, D)
        self.input_proj_norm = nn.LayerNorm(D, eps=LN_EPS)
        if n_learned > 0:
            self.query_embed = Embed(n_learned, D)
        if num_instance_queries == 0:
            self.query_proj1 = nn.Linear(in_channels, D)
            self.query_proj2 = nn.Linear(D, D)
        self.x_mask1 = nn.Linear(in_channels, D)
        self.x_mask2 = nn.Linear(D, D)
        self.out_norm = nn.LayerNorm(D, eps=LN_EPS)
        self.out_cls = ClsHead(D, num_instance_classes + 1)
        self.out_sem = (ClsHead(D, num_semantic_classes + 1)
                        if num_semantic_linears == 2
                        else nn.Linear(D, num_semantic_classes + 1))
        if objectness_flag:
            self.out_score = ClsHead(D, 1)
        self.ffn = nn.ModuleList(FFN(D, hidden_dim, dropout, activation_fn, dt)
                                 for _ in range(L))

        if add_positional_embedding:
            if self.fourier:
                # a fixed buffer, as the reference registers it
                self.register_buffer("gauss_B",
                                     gauss_scale * torch.randn(3, D // 2))
            self.ref_point_head = MLP(D, D, D, 2)
            self.bbox_embed = nn.ModuleList(MLP(D, D, 3, 3) for _ in range(L))
            if add_box_size_pred:
                self.bbox_size_embed = nn.ModuleList(MLP(D, D, 3, 3)
                                                     for _ in range(L))
            if box_modulate_ca:
                self.ref_anchor_head = MLP(D, D, 3, 2)
            self.ca_qpos_proj = nn.Linear(D, D)    # layer 0 only
            self.ca_qcontent_proj = _linears(L, D, D)
            self.ca_kcontent_proj = _linears(L, D, D)
            self.ca_kpos_proj = _linears(L, D, D)
            self.ca_v_proj = _linears(L, D, D)
            self.ca_qpos_sine_proj = _linears(L, D, D)
            self.ca_out_proj = _linears(L, D, D)
            self.ca_norm = nn.ModuleList(nn.LayerNorm(D, eps=LN_EPS)
                                         for _ in range(L))
            self.sa_qcontent_proj = _linears(L, D, D)
            self.sa_qpos_proj = _linears(L, D, D)
            self.sa_kcontent_proj = _linears(L, D, D)
            self.sa_kpos_proj = _linears(L, D, D)
            self.sa_v_proj = _linears(L, D, D)
            self.sa_out_proj = _linears(L, D, D)
            self.sa_norm = nn.ModuleList(nn.LayerNorm(D, eps=LN_EPS)
                                         for _ in range(L))
        else:
            self.plain_ca = nn.ModuleList(
                StandardCrossAttention(D, num_heads, D, dropout, dt)
                for _ in range(L))
            self.plain_sa = nn.ModuleList(
                StandardCrossAttention(D, num_heads, D, dropout, dt)
                for _ in range(L))
        # the simple path runs no DINO-X cross-attention (JAX creates no
        # dinox_ca_i there)
        if add_dinox_query_ca and iter_pred:
            self.dinox_ca = nn.ModuleList(
                StandardCrossAttention(D, num_heads, dinox_dim, dropout, dt)
                for _ in range(L))

    # ------------------------------------------------------------------
    def _ckpt(self, fn, *args):
        """``fn(*args)``, recomputed in the backward with
        ``use_activation_checkpoint`` (its dropout masks are arguments)."""
        if self.use_activation_checkpoint and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def _keep(self, generator, device, *shapes):
        """The dropout masks of one block in training mode, else None."""
        if not self.training:
            return None
        return dropout_keep(shapes, self.dropout, device, generator)

    def _head(self, queries, mask_feats, sp_valid, last: bool):
        norm_q = self.out_norm(queries)
        cls_pred = self.out_cls(norm_q)
        sem_pred = self.out_sem(norm_q) if last else None
        score = self.out_score(norm_q) if self.objectness_flag else None
        pred_mask = torch.einsum("bqd,bsd->bqs", norm_q, mask_feats)
        blocked = None
        if self.attn_mask:
            blocked = torch.sigmoid(pred_mask) < self.mask_attention_threshold
            invalid = ~sp_valid[:, None, :]
            blocked = blocked | invalid
            # rows where every valid superpoint is blocked -> unblock all
            n_valid = sp_valid.sum(-1)[:, None]
            n_blocked_valid = (blocked & sp_valid[:, None, :]).sum(-1)
            all_blocked = n_blocked_valid >= n_valid
            blocked = torch.where(all_blocked[..., None], False,
                                  blocked) | invalid
        return dict(cls_preds=cls_pred, sem_preds=sem_pred, scores=score,
                    masks=pred_mask), blocked

    def score_superpoints(self, sp_feats):
        """Per-superpoint max class probability, for the architecture's
        ``query_num`` top-k query selection."""
        q = self.query_proj2(F.relu(self.query_proj1(sp_feats)))
        cls = self.out_cls(self.out_norm(q))
        return torch.softmax(cls, dim=-1)[..., :-1].amax(-1)

    def _pe(self, pos, scene_range, modulated=None):
        rng = (scene_range[:, 0], scene_range[:, 1])
        if self.fourier:
            return fourier_pos_embed(pos, self.gauss_B, self.d_model, rng,
                                     modulated=modulated)
        return sine_pos_embed(pos, self.d_model, rng,
                              temperature=self.temperature,
                              modulated=modulated)

    def _interleave_heads(self, content, pos_emb):
        """Per-head [content_head ; pos_head] -> (..., 2*D)."""
        b, n, d = content.shape
        h = self.num_heads
        c = content.reshape(b, n, h, d // h)
        p = pos_emb.reshape(b, n, h, d // h)
        return torch.cat([c, p], dim=-1).reshape(b, n, 2 * d)

    def _ffn(self, i, queries, generator):
        b, q, d = queries.shape
        keep = self._keep(generator, queries.device,
                          (b, q, self.ffn[i].lin1.out_features), (b, q, d))
        return self._ckpt(self.ffn[i], queries, keep)

    def _std_ca(self, block, sources, queries, blocked, generator):
        keep = self._keep(generator, queries.device, queries.shape)
        return self._ckpt(block, sources, queries, blocked,
                          None if keep is None else keep[0])

    def forward(self, sp_feats, sp_valid, sp_pos, sp_pos_wo_elastic,
                queries_feat, query_valid, queries_pos, dinox_queries=None,
                dinox_query_pos=None, dinox_valid=None, scene_range=None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, Any]:
        """``generator`` draws the dropout masks in training mode (the
        global generator without one); eval mode draws nothing."""
        D, dt = self.d_model, self.dt
        B = sp_feats.shape[0]
        dev = sp_feats.device

        inst_feats = F.relu(self.input_proj_norm(
            dense(sp_feats, self.input_proj_dense, dt).float()))
        mask_feats = self.x_mask2(F.relu(self.x_mask1(sp_feats)))
        mask_feats = torch.where(sp_valid[..., None], mask_feats, 0.0)

        # learned queries first, then the projected superpoint queries
        parts = []
        if self.n_learned > 0:
            parts.append(self.query_embed.embedding[None].to(
                queries_feat.dtype).expand(B, -1, -1))
        if self.num_instance_queries == 0:
            parts.append(self.query_proj2(F.relu(self.query_proj1(
                queries_feat))))
        queries = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
        if self.n_learned > 0:
            ones = torch.ones(B, self.n_learned, dtype=torch.bool, device=dev)
            query_valid = (torch.cat([ones, query_valid], dim=1)
                           if self.num_instance_queries == 0 else ones)
        Q = queries.shape[1]

        if not self.iter_pred:
            # the unmasked stack, one head at the end
            kb_sp, kb_q = ~sp_valid[:, None, :], ~query_valid[:, None, :]
            for i in range(self.num_layers):
                queries = self._std_ca(self.plain_ca[i], inst_feats, queries,
                                       kb_sp, generator)
                queries = self._std_ca(self.plain_sa[i], queries, queries,
                                       kb_q, generator)
                queries = self._ffn(i, queries, generator)
            out, _ = self._head(queries, mask_feats, sp_valid, last=True)
            out.update(centers=None, sizes=None, aux_outputs=[],
                       hidden_states=queries, query_valid=query_valid)
            return out

        pe = self.add_positional_embedding
        if pe:
            reference_points = queries_pos
            memory_emb = self._pe(sp_pos, scene_range)
            extent = scene_range[:, 1] - scene_range[:, 0]
            if self.normalize_box_prediction:
                ref_sizes = (0.5 / extent.clamp(min=1e-12))[:, None, :] \
                    .expand(B, Q, 3)
            else:
                ref_sizes = queries.new_full((B, Q, 3), 0.5)

        head, attn_blocked = self._head(queries, mask_feats, sp_valid,
                                        last=False)
        layers = [dict(head, centers=None, sizes=None)]

        dinox = hasattr(self, "dinox_ca") and dinox_queries is not None
        if dinox:
            # the all-ones token is always reachable
            ones_tok = dinox_queries.new_ones(B, 1, dinox_queries.shape[-1])
            dinox_tokens = torch.cat([dinox_queries, ones_tok], dim=1)
            tok_valid = torch.cat([dinox_valid, dinox_valid.new_ones(B, 1)],
                                  dim=1)
            if self.add_dinox_query_ca_mask:
                # L1 distance gate between superpoints and DINO-X queries
                dist = (sp_pos_wo_elastic[:, :, None, :]
                        - dinox_query_pos[:, None, :, :]).abs().sum(-1)
                near = ((dist < self.dinox_query_ca_mask_threshold)
                        & dinox_valid[:, None, :]
                        & sp_valid[:, :, None]).float()       # (B, S, K)
        key_block = ~query_valid[:, None, :]
        scale = float(2 * D // self.num_heads) ** -0.5

        for i in range(self.num_layers):
            # cross attention over the superpoints
            if pe:
                if self.box_modulate_ca:
                    ref_hwl = torch.sigmoid(self.ref_anchor_head(queries))
                    mod = ref_hwl / ref_sizes.clamp(min=1e-12)
                    pos_q_emb = self._pe(reference_points, scene_range,
                                         modulated=mod)
                else:
                    pos_q_emb = self._pe(reference_points, scene_range)
                query_pos = self.ref_point_head(pos_q_emb)
                q = dense(queries, self.ca_qcontent_proj[i], dt)
                k = dense(inst_feats, self.ca_kcontent_proj[i], dt)
                v = dense(inst_feats, self.ca_v_proj[i], dt)
                k_pos = dense(memory_emb, self.ca_kpos_proj[i], dt)
                if i == 0:
                    q = q + dense(query_pos, self.ca_qpos_proj, dt)
                    k = k + k_pos
                q_sine = dense(pos_q_emb, self.ca_qpos_sine_proj[i], dt)
                ca_out = self._ckpt(
                    multi_head_attention, self._interleave_heads(q, q_sine),
                    self._interleave_heads(k, k_pos), v, self.num_heads,
                    attn_blocked, scale)
                queries = self.ca_norm[i](
                    queries + dense(ca_out, self.ca_out_proj[i], dt))
            else:
                queries = self._std_ca(self.plain_ca[i], inst_feats, queries,
                                       attn_blocked, generator)

            # self attention among the queries
            if pe:
                sa_out = self._ckpt(
                    multi_head_attention,
                    dense(queries, self.sa_qcontent_proj[i], dt)
                    + dense(query_pos, self.sa_qpos_proj[i], dt),
                    dense(queries, self.sa_kcontent_proj[i], dt)
                    + dense(query_pos, self.sa_kpos_proj[i], dt),
                    dense(queries, self.sa_v_proj[i], dt), self.num_heads,
                    key_block, None)
                queries = self.sa_norm[i](
                    queries + dense(sa_out, self.sa_out_proj[i], dt))
            else:
                queries = self._std_ca(self.plain_sa[i], queries, queries,
                                       key_block, generator)

            # DINO-X object-query cross attention
            if dinox:
                if self.add_dinox_query_ca_mask:
                    reach = torch.einsum(
                        "bqs,bsk->bqk",
                        queries.new_ones(B, Q, near.shape[1])
                        if attn_blocked is None else (~attn_blocked).float(),
                        near)
                    blocked_2d = torch.cat(
                        [reach == 0,
                         reach.new_zeros(B, Q, 1, dtype=torch.bool)], -1)
                else:
                    blocked_2d = ~tok_valid[:, None, :]
                queries = self._std_ca(self.dinox_ca[i], dinox_tokens,
                                       queries, blocked_2d, generator)

            queries = self._ffn(i, queries, generator)

            # positional query update
            center = size = None
            if pe:
                center = reference_points + self.bbox_embed[i](queries)
                reference_points = center.detach()
                if self.add_box_size_pred:
                    delta = self.bbox_size_embed[i](queries)
                    size = (torch.sigmoid(inverse_sigmoid(ref_sizes) + delta)
                            if self.normalize_box_prediction
                            else ref_sizes + delta)
                    ref_sizes = size.detach()
                    if self.normalize_box_prediction:
                        size = size * extent[:, None, :]

            head, attn_blocked = self._head(
                queries, mask_feats, sp_valid,
                last=i == self.num_layers - 1)
            layers.append(dict(head, centers=center, sizes=size))

        out = dict(layers[-1])
        out["aux_outputs"] = layers[:-1]
        out["hidden_states"] = queries
        out["query_valid"] = query_valid
        return out
