"""ScanNet query decoder (DAB-DETR style) over padded dense batches.

Counterpart of ``segdino3d_tpu/models/decoder/query_decoder.py`` on the
flagship path: iterative prediction heads with mask-attention gating, the
sine PE over the scene range with box-modulated, concat-PE cross-attention,
PE-aware self-attention, DINO-X object-query cross-attention gated by the
L1 distance mask, per-layer center and size updates, and the semantic head
on the last layer.  Dense algebra stays stock PyTorch; the attention
softmax is fp32 and all-blocked rows give zero (``ops.attention``).

flax defaults kept: LayerNorm ``eps`` 1e-6 and the tanh GELU.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch import nn

from segdino3d_tpu_torch.models.layers import MLP
from segdino3d_tpu_torch.ops.attention import multi_head_attention
from segdino3d_tpu_torch.ops.pos_embed import sine_pos_embed

LN_EPS = 1e-6   # flax nn.LayerNorm default


def inverse_sigmoid(x, eps=1e-5):
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))


def _linears(n: int, din: int, dout: int) -> nn.ModuleList:
    return nn.ModuleList(nn.Linear(din, dout) for _ in range(n))


class FFN(nn.Module):
    def __init__(self, d_model: int, hidden_dim: int):
        super().__init__()
        self.lin1 = nn.Linear(d_model, hidden_dim)
        self.lin2 = nn.Linear(hidden_dim, d_model)
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x):
        h = self.lin2(F.gelu(self.lin1(x), approximate="tanh"))
        return self.norm(x + h)


class StandardCrossAttention(nn.Module):
    """Full q/k/v in-projections + MHA + residual + norm."""

    def __init__(self, d_model: int, num_heads: int, source_dim: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(d_model, d_model)
        self.k_proj = nn.Linear(source_dim, d_model)
        self.v_proj = nn.Linear(source_dim, d_model)
        self.out_proj = nn.Linear(d_model, d_model)
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, sources, queries, blocked=None):
        out = multi_head_attention(self.q_proj(queries), self.k_proj(sources),
                                   self.v_proj(sources), self.num_heads,
                                   blocked)
        return self.norm(queries + self.out_proj(out))


class ClsHead(nn.Module):
    """Dense -> ReLU -> Dense (flax ``nn.Sequential`` names layers_0/_2)."""

    def __init__(self, d_model: int, out_dim: int):
        super().__init__()
        self.layers = nn.Sequential(nn.Linear(d_model, d_model), nn.ReLU(),
                                    nn.Linear(d_model, out_dim))

    def forward(self, x):
        return self.layers(x)


class ScanNetQueryDecoder(nn.Module):
    def __init__(self, num_layers: int = 6, num_instance_classes: int = 198,
                 num_semantic_classes: int = 200, in_channels: int = 96,
                 d_model: int = 256, num_heads: int = 8,
                 hidden_dim: int = 1024, dinox_dim: int = 256,
                 mask_attention_threshold: float = 0.5,
                 dinox_query_ca_mask_threshold: float = 0.2,
                 temperature: float = 20.0):
        super().__init__()
        D, L = d_model, num_layers
        self.num_layers = num_layers
        self.d_model = d_model
        self.num_heads = num_heads
        self.mask_attention_threshold = mask_attention_threshold
        self.dinox_query_ca_mask_threshold = dinox_query_ca_mask_threshold
        self.temperature = temperature

        self.input_proj_dense = nn.Linear(in_channels, D)
        self.input_proj_norm = nn.LayerNorm(D, eps=LN_EPS)
        self.query_proj1 = nn.Linear(in_channels, D)
        self.query_proj2 = nn.Linear(D, D)
        self.x_mask1 = nn.Linear(in_channels, D)
        self.x_mask2 = nn.Linear(D, D)
        self.out_norm = nn.LayerNorm(D, eps=LN_EPS)
        self.out_cls = ClsHead(D, num_instance_classes + 1)
        self.out_sem = nn.Linear(D, num_semantic_classes + 1)
        self.ffn = nn.ModuleList(FFN(D, hidden_dim) for _ in range(L))

        self.ref_point_head = MLP(D, D, D, 2)
        self.bbox_embed = nn.ModuleList(MLP(D, D, 3, 3) for _ in range(L))
        self.bbox_size_embed = nn.ModuleList(MLP(D, D, 3, 3) for _ in range(L))
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
        self.dinox_ca = nn.ModuleList(
            StandardCrossAttention(D, num_heads, dinox_dim) for _ in range(L))

    def _head(self, queries, mask_feats, sp_valid, last: bool):
        norm_q = self.out_norm(queries)
        cls_pred = self.out_cls(norm_q)
        sem_pred = self.out_sem(norm_q) if last else None
        pred_mask = torch.einsum("bqd,bsd->bqs", norm_q, mask_feats)
        blocked = torch.sigmoid(pred_mask) < self.mask_attention_threshold
        invalid = ~sp_valid[:, None, :]
        blocked = blocked | invalid
        # rows where every valid superpoint is blocked -> unblock all
        n_valid = sp_valid.sum(-1)[:, None]
        n_blocked_valid = (blocked & sp_valid[:, None, :]).sum(-1)
        all_blocked = n_blocked_valid >= n_valid
        blocked = torch.where(all_blocked[..., None], False, blocked) | invalid
        return cls_pred, sem_pred, pred_mask, blocked

    def _pe(self, pos, scene_range, modulated=None):
        return sine_pos_embed(pos, self.d_model,
                              (scene_range[:, 0], scene_range[:, 1]),
                              temperature=self.temperature,
                              modulated=modulated)

    def _interleave_heads(self, content, pos_emb):
        """Per-head [content_head ; pos_head] -> (..., 2*D)."""
        b, n, d = content.shape
        h = self.num_heads
        c = content.reshape(b, n, h, d // h)
        p = pos_emb.reshape(b, n, h, d // h)
        return torch.cat([c, p], dim=-1).reshape(b, n, 2 * d)

    def forward(self, sp_feats, sp_valid, sp_pos, sp_pos_wo_elastic,
                queries_feat, query_valid, queries_pos, dinox_queries,
                dinox_query_pos, dinox_valid, scene_range
                ) -> Dict[str, Any]:
        D = self.d_model
        B = sp_feats.shape[0]
        Q = queries_feat.shape[1]

        inst_feats = F.relu(self.input_proj_norm(
            self.input_proj_dense(sp_feats)))
        mask_feats = self.x_mask2(F.relu(self.x_mask1(sp_feats)))
        mask_feats = torch.where(sp_valid[..., None], mask_feats, 0.0)
        queries = self.query_proj2(F.relu(self.query_proj1(queries_feat)))

        reference_points = queries_pos
        memory_emb = self._pe(sp_pos, scene_range)
        extent = scene_range[:, 1] - scene_range[:, 0]
        ref_sizes = (0.5 / extent.clamp(min=1e-12))[:, None, :].expand(
            B, Q, 3)

        cls_p, sem_p, mask_p, attn_blocked = self._head(
            queries, mask_feats, sp_valid, last=False)
        layers = [dict(cls_preds=cls_p, sem_preds=sem_p, masks=mask_p,
                       centers=None, sizes=None)]

        ones_tok = dinox_queries.new_ones(B, 1, dinox_queries.shape[-1])
        dinox_tokens = torch.cat([dinox_queries, ones_tok], dim=1)
        # L1 distance gate between superpoints and DINO-X queries (B, S, K)
        dist = (sp_pos_wo_elastic[:, :, None, :]
                - dinox_query_pos[:, None, :, :]).abs().sum(-1)
        near = ((dist < self.dinox_query_ca_mask_threshold)
                & dinox_valid[:, None, :] & sp_valid[:, :, None]).float()
        key_block = ~query_valid[:, None, :]
        scale = float(2 * D // self.num_heads) ** -0.5

        for i in range(self.num_layers):
            # cross attention over superpoints, box-modulated concat PE
            ref_hwl = torch.sigmoid(self.ref_anchor_head(queries))
            mod = ref_hwl / ref_sizes.clamp(min=1e-12)
            pos_q_emb = self._pe(reference_points, scene_range, modulated=mod)
            query_pos = self.ref_point_head(pos_q_emb)
            q = self.ca_qcontent_proj[i](queries)
            k = self.ca_kcontent_proj[i](inst_feats)
            v = self.ca_v_proj[i](inst_feats)
            k_pos = self.ca_kpos_proj[i](memory_emb)
            if i == 0:
                q = q + self.ca_qpos_proj(query_pos)
                k = k + k_pos
            q_sine = self.ca_qpos_sine_proj[i](pos_q_emb)
            ca_out = multi_head_attention(
                self._interleave_heads(q, q_sine),
                self._interleave_heads(k, k_pos), v, self.num_heads,
                attn_blocked, scale)
            queries = self.ca_norm[i](queries + self.ca_out_proj[i](ca_out))

            # self attention among queries
            sa_out = multi_head_attention(
                self.sa_qcontent_proj[i](queries)
                + self.sa_qpos_proj[i](query_pos),
                self.sa_kcontent_proj[i](queries)
                + self.sa_kpos_proj[i](query_pos),
                self.sa_v_proj[i](queries), self.num_heads, key_block)
            queries = self.sa_norm[i](queries + self.sa_out_proj[i](sa_out))

            # DINO-X object-query cross attention; the ones token is
            # always reachable
            reach = torch.einsum("bqs,bsk->bqk", (~attn_blocked).float(),
                                 near)
            blocked_2d = torch.cat(
                [reach == 0, reach.new_zeros(B, Q, 1, dtype=torch.bool)], -1)
            queries = self.dinox_ca[i](dinox_tokens, queries, blocked_2d)

            queries = self.ffn[i](queries)

            pred_center = reference_points + self.bbox_embed[i](queries)
            reference_points = pred_center.detach()
            pred_size = torch.sigmoid(inverse_sigmoid(ref_sizes)
                                      + self.bbox_size_embed[i](queries))
            ref_sizes = pred_size.detach()

            last = i == self.num_layers - 1
            cls_p, sem_p, mask_p, attn_blocked = self._head(
                queries, mask_feats, sp_valid, last=last)
            layers.append(dict(cls_preds=cls_p, sem_preds=sem_p, masks=mask_p,
                               centers=pred_center,
                               sizes=pred_size * extent[:, None, :]))

        out = dict(layers[-1])
        out["aux_outputs"] = layers[:-1]
        out["hidden_states"] = queries
        out["query_valid"] = query_valid
        return out
