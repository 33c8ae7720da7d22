"""The text encoder (the port of diffnorm_tpu/models/cmlm_text.py:31-80):
`TextEncoderLayer`, fairseq's pre-norm TransformerEncoderLayer, which
UnitY's synthesizer encoder, the TTS transformer's encoder and
FastSpeech2's encoder and decoder stack; and `TextEncoder`, the token
encoder of FastSpeech2 (the text CMLM that JAX builds on it is not ported).

`TextEncoder` embeds the tokens scaled by sqrt(dim), adds fairseq's
sinusoidal positions keyed on the pad structure (padding_idx PAD), drops
out, runs the layers under the key-padding mask `tokens != PAD` and ends in
a LayerNorm. The self-attention is `MultiheadAttention`, so on the card a
call with >= 2048 keys and no attention dropout (eval) takes the
flash-attention kernel (`ops.attention.masked_attention`): FastSpeech2's
decoder layers over its 2048-frame buffer.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from diffnorm_tpu_torch.models.conformer import layer_norm
from diffnorm_tpu_torch.models.layers import Dense, Dropout, sinusoidal_positions
from diffnorm_tpu_torch.models.nar_transformer import MultiheadAttention

PAD = 1


class TextEncoderLayer(nn.Module):
    """Pre-norm transformer encoder layer (fairseq's TransformerEncoderLayer
    with normalize_before): self-attention under a key-padding mask, then a
    ReLU FF; `dropout` drops attention probabilities, each sublayer's output
    and the FF activation."""

    def __init__(self, dim: int, ffn_dim: int, heads: int, dropout: float = 0.0):
        super().__init__()
        self.self_attn_layer_norm = layer_norm(dim)
        self.self_attn = MultiheadAttention(dim, heads, dropout)
        self.self_attn_dropout = Dropout(dropout)
        self.final_layer_norm = layer_norm(dim)
        self.fc1 = Dense(dim, ffn_dim)
        self.activation_dropout = Dropout(dropout)
        self.fc2 = Dense(ffn_dim, dim)
        self.ff_dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn_dropout(self.self_attn(self.self_attn_layer_norm(x), mask=mask))
        h = self.activation_dropout(F.relu(self.fc1(self.final_layer_norm(x))))
        return x + self.ff_dropout(self.fc2(h))


class TextEncoder(nn.Module):
    """Token encoder (module docstring): tokens [B, S] -> (features [B, S,
    dim], mask [B, S] True = valid)."""

    def __init__(self, vocab_size: int, dim: int = 512, ffn_dim: int = 2048, layers: int = 6,
                 heads: int = 8, dropout: float = 0.1):
        super().__init__()
        self.dim, self.n_layers = dim, layers
        self.embed_tokens = nn.Embedding(vocab_size, dim)
        nn.init.normal_(self.embed_tokens.weight, std=dim ** -0.5)
        self.embed_dropout = Dropout(dropout)
        for i in range(layers):
            self.add_module(f"layer_{i}", TextEncoderLayer(dim, ffn_dim, heads, dropout))
        self.layer_norm = layer_norm(dim)

    def forward(self, tokens: torch.Tensor):
        valid = tokens != PAD
        x = self.embed_tokens(tokens) * math.sqrt(self.dim)
        x = self.embed_dropout(
            x + sinusoidal_positions(valid, self.dim, padding_idx=PAD).to(x.dtype))
        for i in range(self.n_layers):
            x = getattr(self, f"layer_{i}")(x, valid)
        return self.layer_norm(x), valid
