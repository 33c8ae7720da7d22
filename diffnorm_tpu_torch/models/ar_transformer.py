"""The causal unit decoder in its teacher-forced form, what a multitask aux
head of type "transformer" runs (the port's part of
diffnorm_tpu/models/ar_transformer.py:30-241).

JAX's `CachedMultiheadAttention` without its KV cache is the NAR module's
`MultiheadAttention` (fairseq MHA, biased projections) with `causal=True`
for self-attention, and its `ARDecoderLayer` is the NAR `DecoderLayer` with
that causal self-attention: same sublayers, names, dropouts and numerics
(`decode=False`). `ARUnitDecoder` here is JAX's with n_frames_per_step = 1
and the shared input/output embedding, the aux heads' configuration:
embedding x sqrt(dim) + sinusoidal positions, the layers, the final norm,
logits = x @ embed^T; `return_inner` adds the hidden states before the final
norm. Its encoder attention takes the flash-attention kernel on the card
under `ops.attention.masked_attention`'s routing (>= 2048 keys, no
attention dropout).

Not ported here, with the AR S2UT family (ROADMAP Queue 1 item 4): the KV
cache and single-step decoding, the stacked-unit AR decoder,
`ARS2UTModule` and its archs.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from diffnorm_tpu_torch.models.conformer import layer_norm
from diffnorm_tpu_torch.models.layers import Dropout, sinusoidal_positions
from diffnorm_tpu_torch.models.nar_transformer import DecoderLayer

PAD = 1


class ARUnitDecoder(nn.Module):
    """Causal unit decoder, teacher-forced. `context_dim` is the width of
    the encoder states it attends (default `dim`); `attention_dropout` and
    `activation_dropout` fall back to `dropout` where None."""

    def __init__(self, vocab_size: int, dim: int = 512, ffn_dim: int = 2048, layers: int = 6,
                 heads: int = 8, dropout: float = 0.1, attention_dropout: Optional[float] = None,
                 activation_dropout: Optional[float] = None,
                 context_dim: Optional[int] = None):
        super().__init__()
        self.dim, self.n_layers = dim, layers
        attention_dropout = dropout if attention_dropout is None else attention_dropout
        activation_dropout = dropout if activation_dropout is None else activation_dropout
        self.embed_tokens = nn.Embedding(vocab_size, dim)
        nn.init.normal_(self.embed_tokens.weight, std=dim ** -0.5)
        self.embed_dropout = Dropout(dropout)
        for i in range(layers):
            self.add_module(f"layer_{i}", DecoderLayer(
                dim, ffn_dim, heads, dropout, attention_dropout, activation_dropout,
                causal=True, context_dim=context_dim))
        self.layer_norm = layer_norm(dim)

    def forward(self, tokens: torch.Tensor, enc: torch.Tensor, enc_mask: torch.Tensor,
                return_inner: bool = False):
        """tokens [B, T] (teacher-forced prev_output_tokens); enc [B, S, C];
        enc_mask [B, S] True = valid. Returns logits [B, T, vocab] and, with
        `return_inner`, [embed_out, after layer 1, ...]."""
        valid = tokens != PAD
        x = self.embed_tokens(tokens) * math.sqrt(self.dim)
        x = self.embed_dropout(
            x + sinusoidal_positions(valid, self.dim, padding_idx=PAD).to(x.dtype))
        inner = [x]
        for i in range(self.n_layers):
            x = getattr(self, f"layer_{i}")(x, valid, enc, enc_mask)
            inner.append(x)
        logits = F.linear(self.layer_norm(x), self.embed_tokens.weight)
        return (logits, inner) if return_inner else logits
