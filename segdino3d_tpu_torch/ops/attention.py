"""Masked multi-head attention over padded dense batches (plain PyTorch).

Counterpart of ``segdino3d_tpu/ops/attention.py``.  ``blocked`` masks use
True = not allowed; the softmax is max-subtracted and computed in fp32;
rows whose keys are all blocked give **zero** output, not NaN (torch's
softmax and ``scaled_dot_product_attention`` give NaN there).
"""
from __future__ import annotations

from typing import Optional

import torch


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
    ``blocked`` (B, Q, S) or (B, 1, S).  Returns (B, Q, Dv).  ``scale``
    defaults to (Dq / num_heads)^-0.5."""
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
