"""Masked multi-head attention over padded dense batches (plain PyTorch).

Counterpart of ``segdino3d_tpu/ops/attention.py``.  ``blocked`` masks use
True = not allowed; the softmax is max-subtracted and computed in fp32;
rows whose keys are all blocked give **zero** output, not NaN (torch's
softmax and ``scaled_dot_product_attention`` give NaN there).

Also the decoder's standard cross-attention block (JAX
``models/decoder/query_decoder.py:StandardCrossAttention``) and the
dropout it and the FFN share: flax ``nn.Dropout`` semantics (each element
kept with probability ``1 - rate`` and scaled by its inverse), with the
keep masks drawn from an explicit ``torch.Generator`` by the caller, so a
training forward is reproducible from its seed and a checkpointed block
recomputes with the masks of its first run.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from segdino3d_tpu_torch.models.layers import linear

LN_EPS = 1e-6   # flax nn.LayerNorm default


def masked_softmax(logits: torch.Tensor, blocked: Optional[torch.Tensor]
                   ) -> torch.Tensor:
    """Stable softmax over the last axis; all-blocked rows give zeros."""
    if blocked is not None:
        logits = logits.masked_fill(blocked, torch.finfo(logits.dtype).min)
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    if blocked is not None:
        e = e.masked_fill(blocked, 0.0)
    denom = e.sum(dim=-1, keepdim=True)
    return e / denom.clamp(min=1e-30)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         num_heads: int,
                         blocked: Optional[torch.Tensor] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Projection-free MHA core: q (B, Q, Dq), k (B, S, Dq), v (B, S, Dv),
    ``blocked`` (B, Q, S) or (B, 1, S).  Returns (B, Q, Dv) in v's dtype:
    the logits and the softmax are fp32, the probabilities cast back to
    v's dtype.  ``scale`` defaults to (Dq / num_heads)^-0.5."""
    b, nq, dq = q.shape
    s, dv = k.shape[1], v.shape[2]
    hd_q, hd_v = dq // num_heads, dv // num_heads
    if scale is None:
        scale = float(hd_q) ** -0.5
    qh = q.reshape(b, nq, num_heads, hd_q)
    kh = k.reshape(b, s, num_heads, hd_q)
    vh = v.reshape(b, s, num_heads, hd_v)
    logits = torch.einsum("bqhd,bshd->bhqs", (qh * scale).float(), kh.float())
    if blocked is not None:
        blocked = blocked[:, None, :, :]
    p = masked_softmax(logits, blocked).to(v.dtype)
    out = torch.einsum("bhqs,bshd->bqhd", p, vh)
    return out.reshape(b, nq, dv)


def dense(x: torch.Tensor, layer: nn.Linear,
          dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``layer(x)``; with ``dtype`` the flax ``Dense(dtype=...)`` pattern:
    the input cast to ``dtype``, the product in it (the parameters stay
    fp32).  Without ``dtype``, as flax's ``Dense()``, the input and the
    parameters are promoted to a common dtype first (a bf16 backbone's
    features meet an fp32 head in fp32)."""
    if dtype is not None:
        return linear(x.to(dtype), layer)
    return layer(x.to(torch.promote_types(x.dtype, layer.weight.dtype)))


def dropout_keep(shapes: Sequence[Sequence[int]], rate: float,
                 device: torch.device,
                 generator: Optional[torch.Generator] = None
                 ) -> Optional[list]:
    """Keep masks (True: kept, with probability ``1 - rate``) of the given
    shapes, drawn in order from ``generator`` (the global generator of
    ``device`` without one) on its device; None where ``rate`` is 0."""
    if rate <= 0.0:
        return None
    gdev = generator.device if generator is not None else device
    return [(torch.rand(tuple(s), generator=generator, device=gdev)
             >= rate).to(device) for s in shapes]


def apply_dropout(x: torch.Tensor, keep: Optional[torch.Tensor],
                  rate: float) -> torch.Tensor:
    """flax ``nn.Dropout``: kept elements scaled by 1 / (1 - rate), the
    rest zero; ``keep`` None is the identity (eval mode or rate 0)."""
    if keep is None:
        return x
    return torch.where(keep, x / (1.0 - rate), 0.0)


class StandardCrossAttention(nn.Module):
    """nn.MultiheadAttention-equivalent cross-attention: full q/k/v
    in-projections, MHA, the out projection, dropout, then the residual
    and LayerNorm.  ``dtype`` is the projections' compute dtype (the
    softmax stays fp32, the norm fp32)."""

    def __init__(self, d_model: int, num_heads: int,
                 source_dim: Optional[int] = None, dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        source_dim = source_dim or d_model
        self.num_heads = num_heads
        self.dropout = dropout
        self.dtype = dtype
        self.q_proj = nn.Linear(d_model, d_model)
        self.k_proj = nn.Linear(source_dim, d_model)
        self.v_proj = nn.Linear(source_dim, d_model)
        self.out_proj = nn.Linear(d_model, d_model)
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, sources, queries, blocked=None,
                keep: Optional[torch.Tensor] = None):
        """``keep``: the (B, Q, d_model) dropout mask of the output, or
        None (no dropout)."""
        dt = self.dtype
        out = multi_head_attention(
            dense(queries, self.q_proj, dt), dense(sources, self.k_proj, dt),
            dense(sources, self.v_proj, dt), self.num_heads, blocked)
        out = apply_dropout(dense(out, self.out_proj, dt), keep, self.dropout)
        return self.norm(queries + out)
