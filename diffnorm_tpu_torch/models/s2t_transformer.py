"""The S2T transformer speech encoder and the S2T model (the port of
diffnorm_tpu/models/s2t_transformer.py; reference fairseq
s2t_transformer.py and s2t_conformer.py).

`S2TTransformerEncoder` (JAX :37-125), also the encoder of the AR
`s2ut_transformer` architectures (`models/ar_transformer.py`):
Conv1dSubsampler (4x) -> x sqrt(dim) (unless `no_scale_embedding`) ->
absolute sinusoidal positions keyed on the mask -> dropout -> pre-LN layers
(self-attention, ReLU FF) -> final LayerNorm. The self-attention runs through
`ops.attention.masked_attention`, so on the card it takes the
flash-attention kernel once the subsampled source has >= 2048 frames and no
attention dropout applies (eval).

`S2TModule` (JAX :127-197, the model "s2t"): that encoder, or the
conformer (`encoder_type` "conformer", s2t_conformer), and the causal text
decoder `ARUnitDecoder` cross-attending it, its output projection unshared
unless `share_decoder_input_output_embed`. `encode`, `init_cache` and
`decode_step` are `ARS2UTModule`'s, so `generate/beam_search.py`'s
`ar_generate` (beam or sampling) and a teacher-forced scoring drive it as
they drive the AR S2UT model; on the card, in a long-form decode, the
decoder's encoder attention takes the kernel too, one query a row (D = 64
for s2t_transformer, 32 for s2t_conformer's 256-wide, 8-head decoder).
The archs: s2t_transformer (512 x 12, decoder 6), s2t_transformer_s (256
wide, 4 heads), s2t_transformer_xs (6 + 3 layers, FFN 1024; it calls _s,
which calls the base), s2t_conformer (256 x 16, 4 heads; decoder 256 x 6, 8
heads).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from diffnorm_tpu_torch.models.conformer import ConformerEncoder, Conv1dSubsampler, layer_norm
from diffnorm_tpu_torch.models.layers import Dense, Dropout, arch_default, sinusoidal_positions
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


class S2TModule(nn.Module):
    """Speech encoder + causal text decoder (module docstring); widths
    default to s2t_transformer's. `attention_dropout` and
    `activation_dropout` fall back to `dropout` where None."""

    def __init__(self, vocab_size: int, encoder_type: str = "transformer",
                 in_channels: int = 80, encoder_dim: int = 512, encoder_ffn_dim: int = 2048,
                 encoder_layers: int = 12, encoder_heads: int = 8, decoder_dim: int = 512,
                 decoder_ffn_dim: int = 2048, decoder_layers: int = 6, decoder_heads: int = 8,
                 dropout: float = 0.1, attention_dropout: Optional[float] = None,
                 activation_dropout: Optional[float] = None, conv_channels: int = 1024,
                 conv_kernel_sizes: Sequence[int] = (5, 5), depthwise_kernel_size: int = 31,
                 share_decoder_input_output_embed: bool = False):
        # ar_transformer imports this module for the encoder above
        from diffnorm_tpu_torch.models.ar_transformer import ARUnitDecoder

        super().__init__()
        self.vocab_size = vocab_size
        common = dict(in_channels=in_channels, dim=encoder_dim, ffn_dim=encoder_ffn_dim,
                      layers=encoder_layers, heads=encoder_heads, dropout=dropout,
                      attention_dropout=attention_dropout,
                      activation_dropout=activation_dropout, conv_channels=conv_channels,
                      conv_kernel_sizes=tuple(conv_kernel_sizes))
        if encoder_type == "conformer":
            self.encoder = ConformerEncoder(depthwise_kernel_size=depthwise_kernel_size,
                                            **common)
        elif encoder_type == "transformer":
            self.encoder = S2TTransformerEncoder(**common)
        else:
            raise ValueError(f"encoder_type {encoder_type!r}: conformer or transformer")
        self.decoder = ARUnitDecoder(
            vocab_size, decoder_dim, decoder_ffn_dim, decoder_layers, decoder_heads,
            dropout=dropout, attention_dropout=attention_dropout,
            activation_dropout=activation_dropout, context_dim=encoder_dim,
            share_input_output_embed=share_decoder_input_output_embed)

    def encode(self, src: torch.Tensor, src_lengths: torch.Tensor,
               tgt_speaker: Optional[torch.Tensor] = None):
        """(enc [B, S, C], enc_mask [B, S]); the model takes no speaker."""
        if tgt_speaker is not None:
            raise ValueError("the S2T model takes no target speaker")
        return self.encoder(src, src_lengths)

    def init_cache(self, enc: torch.Tensor, enc_mask: torch.Tensor, max_len: int):
        return self.decoder.init_cache(enc, enc_mask, max_len)

    def decode_step(self, tokens: torch.Tensor, cache, position: torch.Tensor):
        """tokens [N, 1] -> (logits [N, V], cache)."""
        return self.decoder.decode_step(tokens, cache, position)

    def forward(self, src: torch.Tensor, src_lengths: torch.Tensor, prev_tokens: torch.Tensor,
                tgt_speaker: Optional[torch.Tensor] = None) -> Dict:
        """Teacher-forced: {"logits" [B, L, V]}."""
        enc, enc_mask = self.encode(src, src_lengths, tgt_speaker)
        return {"logits": self.decoder(prev_tokens, enc, enc_mask)}


def s2t_transformer_arch(cfg: dict) -> None:
    """fairseq's base_architecture (JAX s2t_transformer.py:243-254) for the
    widths left None in `cfg`: the decoder's widths default to the
    encoder's."""
    arch_default(cfg, "encoder_type", "transformer")
    for key, value in (("encoder_embed_dim", 512), ("encoder_ffn_embed_dim", 2048),
                       ("encoder_layers", 12), ("encoder_attention_heads", 8)):
        arch_default(cfg, key, value)
    arch_default(cfg, "decoder_embed_dim", cfg["encoder_embed_dim"])
    arch_default(cfg, "decoder_ffn_embed_dim", cfg["encoder_ffn_embed_dim"])
    for key, value in (("decoder_layers", 6), ("decoder_attention_heads", 8),
                       ("dropout", 0.1), ("depthwise_conv_kernel_size", 31)):
        arch_default(cfg, key, value)


def s2t_transformer_s_arch(cfg: dict) -> None:
    """s2t_transformer_s (JAX :257-264)."""
    for key, value in (("encoder_embed_dim", 256), ("encoder_ffn_embed_dim", 256 * 8),
                       ("encoder_attention_heads", 4), ("decoder_attention_heads", 4)):
        arch_default(cfg, key, value)
    s2t_transformer_arch(cfg)


def s2t_transformer_xs_arch(cfg: dict) -> None:
    """s2t_transformer_xs (JAX :267-273)."""
    for key, value in (("encoder_layers", 6), ("decoder_layers", 3),
                       ("encoder_ffn_embed_dim", 256 * 4)):
        arch_default(cfg, key, value)
    s2t_transformer_s_arch(cfg)


def s2t_conformer_arch(cfg: dict) -> None:
    """s2t_conformer (JAX :276-289): the conformer encoder, 256 x 16."""
    cfg["encoder_type"] = "conformer"
    for key, value in (("encoder_embed_dim", 256), ("encoder_ffn_embed_dim", 2048),
                       ("encoder_layers", 16), ("encoder_attention_heads", 4),
                       ("decoder_embed_dim", 256), ("decoder_ffn_embed_dim", 2048),
                       ("decoder_layers", 6), ("decoder_attention_heads", 8),
                       ("depthwise_conv_kernel_size", 31), ("dropout", 0.1)):
        arch_default(cfg, key, value)


ARCHS = {"s2t_transformer": s2t_transformer_arch, "s2t_transformer_s": s2t_transformer_s_arch,
         "s2t_transformer_xs": s2t_transformer_xs_arch, "s2t_conformer": s2t_conformer_arch}
