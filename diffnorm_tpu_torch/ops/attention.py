"""Scaled dot-product attention with a key-padding mask.

Counterpart of diffnorm_tpu/ops/attention.py:masked_attention, with its
numerics: scores and softmax in f32; masked keys set to finfo(float32).min
rather than -inf, so a fully masked row comes out uniform, never NaN; the
probabilities cast to bf16 for probs @ v when v is bf16.

Keys of length >= 2048 on the card go to the flash-attention kernel
(`ops/flash_attention.py`), as the JAX package routes them to its Pallas
kernel on a TPU (attention.py:53-63), where `flash_attention.supports` says
the kernel takes the shapes and types (checked before any launch, as JAX
checks its length threshold). Every other call, on any device, is the
module math below, JAX's default path, which takes any shape. The kernel
serves JAX's plain masked case: a causal call (the aux heads' causal
self-attention, `models/ar_transformer.py`) and a call with dropout (a
training forward) take the module math, as JAX keeps both off the kernel;
the port's callers pass no bias. JAX takes the route only
under DIFFNORM_FLASH_ATTENTION=1, on the strength of a TPU v5e
measurement; on the card it is on by default. On the CPU masked_attention
stays plain, as JAX's does off the TPU. The S2ST
chain reaches the kernel through the NAR decoder's encoder attention when
the subsampled source has >= 2048 frames (about 82 s of speech); the
conformer's rel-pos attention computes its scores inline and never calls
this function. HuBERT's self-attention (`models/hubert.py`, prep) reaches
it for utterances of 41 s or more (2048 frames at 20 ms), in float32 from
`cli.prepare`. The multitask aux heads' cross-attention over the tapped
encoder states (`models/ar_transformer.py`) reaches it at the same source
lengths as the NAR decoder's encoder attention, and so do, in eval, the AR
S2UT decoder's encoder attention (D = 64), UnitY's first-pass decoder's
(`models/unity.py`, D = 32), Translatotron2's first-pass decoder's
(`models/s2spect2.py`, D = 128) and s2spect's mel decoder's
(`models/tts_transformer.py`, D = 128), one query a row in a cached decode.
UnitY's unit decoder and Translatotron2's mel decoder attend the first
pass's text positions (at most 256) and never reach it.
"""

from __future__ import annotations

from typing import Optional

import torch

from diffnorm_tpu_torch.ops import flash_attention as flash_ops

FLASH_MIN_LEN = 2048  # attention.py:_PALLAS_MIN_LEN


def apply_dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax nn.Dropout's draw: keep each element with probability 1 - p and
    scale the kept ones by 1 / (1 - p), from `generator`."""
    if generator is None:
        raise ValueError("dropout needs a generator (set_dropout_generator)")
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), 0.0)


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: Optional[torch.Tensor] = None, dropout: float = 0.0,
                     generator: Optional[torch.Generator] = None,
                     causal: bool = False) -> torch.Tensor:
    """q [B, H, Tq, D], k/v [B, H, Tk, D], mask [B, Tk] bool (True = valid).
    Returns [B, H, Tq, D] in q.dtype. `dropout` > 0 drops probabilities as
    JAX does (keep with 1 - dropout, kept ones scaled by 1 / (1 - dropout)),
    drawn from `generator`; `causal` lets query i see keys j <= i + Tk - Tq
    (JAX's tril(k=tk-tq) mask). Neither call takes the kernel."""
    if (q.is_cuda and dropout == 0.0 and not causal and k.shape[-2] >= FLASH_MIN_LEN
            and flash_ops.supports(q, k, v, mask)):
        return flash_ops.flash_attention(q, k, v, mask)
    scale = q.shape[-1] ** -0.5
    sim = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        sim = sim.masked_fill(~mask[:, None, None, :], torch.finfo(torch.float32).min)
    if causal:
        tq, tk = sim.shape[-2:]
        allowed = torch.ones(tq, tk, dtype=torch.bool, device=sim.device).tril(tk - tq)
        sim = sim.masked_fill(~allowed, torch.finfo(torch.float32).min)
    attn = sim.softmax(dim=-1)
    if dropout > 0.0:
        attn = apply_dropout(attn, dropout, generator)
    if v.dtype == torch.bfloat16:
        out = torch.matmul(attn.to(torch.bfloat16), v)
    else:
        out = torch.matmul(attn, v.float())
    return out.to(q.dtype)
