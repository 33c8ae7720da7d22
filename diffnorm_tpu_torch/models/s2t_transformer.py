"""The S2T transformer speech encoder (the port of
diffnorm_tpu/models/s2t_transformer.py:37-125; reference fairseq
s2t_transformer.py's S2TTransformerEncoder), the encoder of the AR
`s2ut_transformer` architectures (`models/ar_transformer.py`).

Conv1dSubsampler (4x) -> x sqrt(dim) (unless `no_scale_embedding`) ->
absolute sinusoidal positions keyed on the mask -> dropout -> pre-LN layers
(self-attention, ReLU FF) -> final LayerNorm. The self-attention runs through
`ops.attention.masked_attention`, so on the card it takes the
flash-attention kernel once the subsampled source has >= 2048 frames and no
attention dropout applies (eval). The S2T model and its task wait with the
s2t family (ROADMAP Queue 1 item 4).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from diffnorm_tpu_torch.models.conformer import Conv1dSubsampler, layer_norm
from diffnorm_tpu_torch.models.layers import Dense, Dropout, sinusoidal_positions
from diffnorm_tpu_torch.models.nar_transformer import MultiheadAttention

PAD = 1


class S2TEncoderLayer(nn.Module):
    """Pre-LN encoder layer (fairseq TransformerEncoderLayer with
    encoder_normalize_before)."""

    def __init__(self, dim: int, ffn_dim: int, heads: int, dropout: float = 0.0,
                 attention_dropout: float = 0.0, activation_dropout: float = 0.0):
        super().__init__()
        self.self_attn_layer_norm = layer_norm(dim)
        self.self_attn = MultiheadAttention(dim, heads, attention_dropout)
        self.self_attn_dropout = Dropout(dropout)
        self.final_layer_norm = layer_norm(dim)
        self.fc1 = Dense(dim, ffn_dim)
        self.activation_dropout = Dropout(activation_dropout)
        self.fc2 = Dense(ffn_dim, dim)
        self.ff_dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn_dropout(self.self_attn(self.self_attn_layer_norm(x), mask=mask))
        h = self.activation_dropout(F.relu(self.fc1(self.final_layer_norm(x))))
        return x + self.ff_dropout(self.fc2(h))


class S2TTransformerEncoder(nn.Module):
    """Returns (features [B, T', dim], mask [B, T'] True = valid) and, with
    `return_all_layers`, each layer's output before the final norm (the
    multitask aux heads' taps)."""

    def __init__(self, in_channels: int = 80, dim: int = 512, ffn_dim: int = 2048,
                 layers: int = 12, heads: int = 8, dropout: float = 0.1,
                 conv_channels: int = 1024, conv_kernel_sizes: Sequence[int] = (5, 5),
                 no_scale_embedding: bool = False, attention_dropout: Optional[float] = None,
                 activation_dropout: Optional[float] = None):
        super().__init__()
        self.dim, self.n_layers, self.scale = dim, layers, not no_scale_embedding
        attention_dropout = dropout if attention_dropout is None else attention_dropout
        activation_dropout = dropout if activation_dropout is None else activation_dropout
        self.subsample = Conv1dSubsampler(in_channels, conv_channels, dim,
                                          tuple(conv_kernel_sizes))
        self.input_dropout = Dropout(dropout)
        for i in range(layers):
            self.add_module(f"layer_{i}", S2TEncoderLayer(
                dim, ffn_dim, heads, dropout, attention_dropout, activation_dropout))
        self.layer_norm = layer_norm(dim)

    def forward(self, src: torch.Tensor, src_lengths: torch.Tensor,
                return_all_layers: bool = False):
        x, lengths = self.subsample(src, src_lengths)
        mask = torch.arange(x.shape[1], device=x.device)[None, :] < lengths[:, None]
        if self.scale:
            x = x * math.sqrt(self.dim)
        x = self.input_dropout(
            x + sinusoidal_positions(mask, self.dim, padding_idx=PAD).to(x.dtype))
        states = []
        for i in range(self.n_layers):
            x = getattr(self, f"layer_{i}")(x, mask)
            states.append(x)
        x = self.layer_norm(x)
        return (x, mask, states) if return_all_layers else (x, mask)
