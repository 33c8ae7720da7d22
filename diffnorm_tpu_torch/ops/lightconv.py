"""Lightweight and dynamic convolutions (Pay Less Attention; the port of
diffnorm_tpu/ops/lightconv.py, reference fairseq/modules/lightconv_layer
and dynamicconv_layer): a softmax over the kernel axis in float32, each
head's weights shared by its C / H channels, and K shifted multiply-adds
summed in float32, cast back to the input's type at the end.

* lightconv: weights [H, K], the same at every position;
* dynamicconv: weights [B, T, H, K], one kernel a position.

`padding` "causal" reads x[t - (K - 1) + k], "same" x[t - K // 2 + k],
zeros outside the sequence. No caller in either package uses them; JAX
lowers them to XLA, not to a Pallas kernel, so they run as plain PyTorch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _shift(x: torch.Tensor, offset: int) -> torch.Tensor:
    """x [B, T, ...] shifted so out[t] = x[t + offset], zero-padded."""
    if offset == 0:
        return x
    pad = [0, 0] * (x.dim() - 2)
    if offset > 0:
        return F.pad(x[:, offset:], pad + [0, offset])
    return F.pad(x[:, :offset], pad + [-offset, 0])


def _normalized(weights: torch.Tensor, softmax_normalize: bool) -> torch.Tensor:
    w = weights.float()
    return torch.softmax(w, dim=-1) if softmax_normalize else w


def lightconv(x: torch.Tensor, weights: torch.Tensor, padding: str = "causal",
              softmax_normalize: bool = True) -> torch.Tensor:
    """x [B, T, C], weights [H, K] -> [B, T, C]."""
    c = x.shape[-1]
    h, k = weights.shape
    if c % h:
        raise ValueError(f"{c} channels do not split into {h} heads")
    w = _normalized(weights, softmax_normalize).repeat_interleave(c // h, dim=0)  # [C, K]
    base = -(k - 1) if padding == "causal" else -(k // 2)
    xf = x.float()
    out = torch.zeros_like(xf)
    for i in range(k):
        out = out + _shift(xf, base + i) * w[:, i]
    return out.to(x.dtype)


def dynamicconv(x: torch.Tensor, weights: torch.Tensor, padding: str = "causal",
                softmax_normalize: bool = True) -> torch.Tensor:
    """x [B, T, C], weights [B, T, H, K] -> [B, T, C]. The per-position
    weights broadcast over each head's channels rather than being repeated
    to [B, T, C, K]: the same products, summed in the same order."""
    b, t, c = x.shape
    h, k = weights.shape[2:]
    if c % h:
        raise ValueError(f"{c} channels do not split into {h} heads")
    w = _normalized(weights, softmax_normalize)[..., None, :]  # [B, T, H, 1, K]
    base = -(k - 1) if padding == "causal" else -(k // 2)
    xf = x.float().reshape(b, t, h, c // h)
    out = torch.zeros_like(xf)
    for i in range(k):
        out = out + _shift(xf, base + i) * w[..., i]
    return out.reshape(b, t, c).to(x.dtype)
