"""Non-causal attention with a key-padding mask, online softmax, f32 sums.

Replaces diffnorm_tpu/ops/pallas_attention.py:flash_attention. The kernel is
`csrc/flash_attention.cu`: one block per (64 queries, batch x head), K/V in
64-key tiles through shared memory, bf16 mma.sync with f32 sums for q k^T
and for P V (P split into bf16 hi + lo, so the probabilities keep f32
precision as on the TPU), an f32 FMA kernel for float32 inputs. At the S2ST
decoder's encoder attention (q [2,8,256,64], k/v [2,8,2112,64], bf16) it is
bound by bytes on an H100: 9.7 MB, 2.9 us at 3.35 TB/s.
`ops.attention.masked_attention` routes here for keys of length >= 2048 on
the card.

The function (pallas_attention.py:26-80), in f32:
    s = (q / sqrt(D)) k^T, s = -1e30 where the key is masked
    out = softmax(s) v = exp(s - max) v / max(sum exp(s - max), 1e-30)
Keys past Tk take no part, so a fully masked row is the mean of v over the
Tk keys, as `masked_attention` gives. The TPU kernel pads Tk to its block
and masks the padding like real keys, which gives sum(v) / Tk_pad on such a
row (ROADMAP Queue 3).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from diffnorm_tpu_torch.ops import _build

MASKED = -1.0e30  # pallas_attention.py NEG_INF
BF16_DIMS = (32, 64, 96, 128)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function in PyTorch, f32 products and sums; arguments as
    for `flash_attention`."""
    scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    if mask is not None:
        s = s.masked_fill(~mask.bool()[:, None, None, :], MASKED)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = torch.matmul(p, v.float()) / p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    return out.to(q.dtype)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B, H, Tq, D]; k/v [B, H, Tk, D]; mask [B, Tk] bool (True = valid
    key) or None. Returns [B, H, Tq, D] in q.dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (bf16 with D in 32/64/96/128, or float32 with D <= 128) or raises."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, mask)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q, k, v must be [B, H, T, D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention: q, k, v differ in type: {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dtype == torch.bfloat16:
        if d not in BF16_DIMS:
            raise ValueError(f"flash_attention: the bf16 kernel takes D in {BF16_DIMS}, got {d}")
        symbol = "flash_attention_bf16"
    elif q.dtype == torch.float32:
        if not 0 < d <= 128:
            raise ValueError(f"flash_attention: the f32 kernel takes D <= 128, got {d}")
        symbol = "flash_attention_f32"
    else:
        raise TypeError(f"flash_attention: the kernel takes bf16 or float32, got {q.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    if b * h > 65535 or tq == 0 or tk == 0:
        raise ValueError(f"flash_attention: unsupported shape B*H={b * h}, Tq={tq}, Tk={tk}")
    if mask is not None:
        if mask.shape != (b, tk) or mask.device != q.device:
            raise ValueError(f"flash_attention: mask must be [{b}, {tk}] on {q.device}, "
                             f"got {tuple(mask.shape)}")
        mask = mask.to(torch.bool).contiguous()
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    fn = _build.function("flash_attention", symbol, [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                         + [ctypes.c_float, ctypes.c_void_p])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    None if mask is None else mask.data_ptr(), out.data_ptr(),
                    b * h, h, tq, tk, d, d ** -0.5, stream), "flash_attention")
    _build.launch_counts["flash_attention"] += 1
    return out
