"""Non-autoregressive CMLM speech-to-unit translator, inference only.

Counterpart of diffnorm_tpu/models/nar_transformer.py with
n_frames_per_step=1 and the shared input/output embedding: a conformer
encoder over 80-d fbank, a NAT unit decoder (pre-norm layers with
full-context self-attention, encoder attention and a ReLU FF; sinusoidal
positions keyed on the pad structure; logits = x @ embed^T) and a 256-way
length head over the mean-pooled encoder states. The decoder's attention
runs through `ops.attention.masked_attention`, whose encoder attention takes
the flash-attention kernel on the card once the subsampled source reaches
2048 frames. Names follow the flax tree (`weights.from_jax_variables`).

Dictionary layout: bos=0, pad=1, eos=2, unk=3 (mask token), units at +4.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from diffnorm_tpu_torch.models.conformer import ConformerEncoder, layer_norm
from diffnorm_tpu_torch.models.layers import Dense, sinusoidal_positions
from diffnorm_tpu_torch.ops import attention as attention_ops

PAD, BOS, EOS, UNK = 1, 0, 2, 3


class MultiheadAttention(nn.Module):
    """fairseq-style MHA (biased q/k/v/out projections)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.dim, self.heads = dim, heads
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.add_module(name, Dense(dim, dim))

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx = x if context is None else context
        b, tq, _ = x.shape
        h, d = self.heads, self.dim // self.heads

        def heads_of(z):
            return z.reshape(b, z.shape[1], h, d).transpose(1, 2)

        q, k, v = heads_of(self.q_proj(x)), heads_of(self.k_proj(ctx)), heads_of(self.v_proj(ctx))
        out = attention_ops.masked_attention(q, k, v, mask=mask)
        return self.out_proj(out.transpose(1, 2).reshape(b, tq, self.dim))


class DecoderLayer(nn.Module):
    """Pre-norm decoder layer: self-attention, encoder attention, ReLU FF."""

    def __init__(self, dim: int, ffn_dim: int, heads: int):
        super().__init__()
        self.self_attn_layer_norm = layer_norm(dim)
        self.self_attn = MultiheadAttention(dim, heads)
        self.encoder_attn_layer_norm = layer_norm(dim)
        self.encoder_attn = MultiheadAttention(dim, heads)
        self.final_layer_norm = layer_norm(dim)
        self.fc1 = Dense(dim, ffn_dim)
        self.fc2 = Dense(ffn_dim, dim)

    def forward(self, x, self_mask, enc, enc_mask):
        x = x + self.self_attn(self.self_attn_layer_norm(x), mask=self_mask)
        x = x + self.encoder_attn(self.encoder_attn_layer_norm(x), context=enc, mask=enc_mask)
        return x + self.fc2(F.relu(self.fc1(self.final_layer_norm(x))))


class NATUnitDecoder(nn.Module):
    """NAT unit decoder with a length head (n_frames_per_step=1, shared
    input/output embedding)."""

    def __init__(self, vocab_size: int, dim: int = 512, ffn_dim: int = 2048,
                 layers: int = 6, heads: int = 8, max_lengths: int = 256):
        super().__init__()
        self.dim, self.n_layers, self.max_lengths = dim, layers, max_lengths
        self.embed_tokens = nn.Embedding(vocab_size, dim)
        self.embed_length = nn.Embedding(max_lengths, dim)
        for emb in (self.embed_tokens, self.embed_length):
            nn.init.normal_(emb.weight, std=dim ** -0.5)
        for i in range(layers):
            self.add_module(f"layer_{i}", DecoderLayer(dim, ffn_dim, heads))
        self.layer_norm = layer_norm(dim)

    def null_context(self) -> torch.Tensor:
        """The BOS embedding, the CG null encoder feature [1, dim]."""
        return self.embed_tokens.weight[BOS:BOS + 1]

    def forward(self, tokens: torch.Tensor, enc: torch.Tensor,
                enc_mask: torch.Tensor) -> torch.Tensor:
        """tokens [B, T]; enc [B, S, C]; enc_mask [B, S] True = valid.
        Returns logits [B, T, vocab] in the model's dtype."""
        valid = tokens != PAD
        x = self.embed_tokens(tokens) * math.sqrt(self.dim)
        x = x + sinusoidal_positions(valid, self.dim, padding_idx=PAD).to(x.dtype)
        for i in range(self.n_layers):
            x = getattr(self, f"layer_{i}")(x, valid, enc, enc_mask)
        x = self.layer_norm(x)
        return F.linear(x, self.embed_tokens.weight)

    def forward_length(self, enc: torch.Tensor, enc_mask: torch.Tensor) -> torch.Tensor:
        """Mean-pooled encoder states -> [B, max_lengths] logits."""
        m = enc_mask[..., None].to(enc.dtype)
        pooled = (enc * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
        return pooled @ self.embed_length.weight.to(pooled.dtype).t()


class NARS2UTModule(nn.Module):
    """Conformer encoder + NAT unit decoder (inference). Dimensions follow
    the `nar_s2ut_conformer` arch defaults."""

    def __init__(self, vocab_size: int = 1004, in_channels: int = 80,
                 encoder_dim: int = 512, encoder_ffn_dim: int = 2048,
                 encoder_layers: int = 12, encoder_heads: int = 8,
                 decoder_dim: int = 512, decoder_ffn_dim: int = 2048,
                 decoder_layers: int = 6, decoder_heads: int = 8,
                 depthwise_kernel_size: int = 31, conv_channels: int = 1024,
                 conv_kernel_sizes: Sequence[int] = (5, 5)):
        super().__init__()
        self.vocab_size = vocab_size
        self.encoder = ConformerEncoder(in_channels, encoder_dim, encoder_ffn_dim,
                                        encoder_layers, encoder_heads,
                                        depthwise_kernel_size, conv_channels,
                                        conv_kernel_sizes)
        self.decoder = NATUnitDecoder(vocab_size, decoder_dim, decoder_ffn_dim,
                                      decoder_layers, decoder_heads)

    def encode(self, src: torch.Tensor, src_lengths: torch.Tensor):
        return self.encoder(src, src_lengths)

    def apply_cg_drop(self, enc: torch.Tensor, enc_mask: torch.Tensor, drop: torch.Tensor):
        """Replace dropped rows' encoder output with the BOS null context and
        mark every position valid. drop: [B] bool."""
        null = self.decoder.null_context().to(enc.dtype)
        enc = torch.where(drop[:, None, None], null[None], enc)
        enc_mask = torch.where(drop[:, None], True, enc_mask)
        return enc, enc_mask

    def decode(self, tokens, enc, enc_mask):
        return self.decoder(tokens, enc, enc_mask)

    def forward_length(self, enc, enc_mask):
        return self.decoder.forward_length(enc, enc_mask)
