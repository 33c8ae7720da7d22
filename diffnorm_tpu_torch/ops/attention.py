"""Scaled dot-product attention with a key-padding mask (plain PyTorch).

Counterpart of diffnorm_tpu/ops/attention.py:masked_attention, with its
numerics: scores and softmax in f32; masked keys set to finfo(float32).min
rather than -inf, so a fully masked row comes out uniform, never NaN; the
probabilities cast to bf16 for probs @ v when v is bf16.

The JAX package routes keys of length >= 2048 to a Pallas flash-attention
kernel (diffnorm_tpu/ops/pallas_attention.py); that kernel is not ported yet,
and the DDIM path runs at T=128.
"""

from __future__ import annotations

from typing import Optional

import torch


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B, H, Tq, D], k/v [B, H, Tk, D], mask [B, Tk] bool (True = valid).
    Returns [B, H, Tq, D] in q.dtype."""
    scale = q.shape[-1] ** -0.5
    sim = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        sim = sim.masked_fill(~mask[:, None, None, :], torch.finfo(torch.float32).min)
    attn = sim.softmax(dim=-1)
    if v.dtype == torch.bfloat16:
        out = torch.matmul(attn.to(torch.bfloat16), v)
    else:
        out = torch.matmul(attn, v.float())
    return out.to(q.dtype)
