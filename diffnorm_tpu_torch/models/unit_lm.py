"""The decoder-only unit language model (the port of
diffnorm_tpu/models/unit_lm.py; reference fairseq's transformer_lm family,
scored by cli.eval_lm).

Pre-norm layers (LayerNorm, causal self-attention with biased q/k/v/out
projections, residual; LayerNorm, ReLU FFN, residual) over the embedding
scaled by sqrt(dim) plus sinusoidal positions with padding_idx 1, a final
LayerNorm and the output tied to the embedding. A token equal to PAD (1) is
padding: masked as a key and given the zero position. The self-attention is
causal, so it takes the module math on any device (the flash-attention
kernel serves non-causal calls only), as JAX keeps it off its kernel.
`unit_lm` / `transformer_lm`: 512 wide, FF 2048, 6 layers, 8 heads,
dropout 0.1.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from diffnorm_tpu_torch.models.conformer import layer_norm
from diffnorm_tpu_torch.models.layers import Dense, Dropout, arch_default, sinusoidal_positions
from diffnorm_tpu_torch.ops.attention import masked_attention

PAD = 1


class CausalLMLayer(nn.Module):
    def __init__(self, dim: int, ffn_dim: int, heads: int, dropout: float = 0.1):
        super().__init__()
        self.heads = heads
        self.self_attn_layer_norm = layer_norm(dim)
        self.q_proj, self.k_proj, self.v_proj = (Dense(dim, dim) for _ in range(3))
        self.out_proj = Dense(dim, dim)
        self.final_layer_norm = layer_norm(dim)
        self.fc1 = Dense(dim, ffn_dim)
        self.fc2 = Dense(ffn_dim, dim)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, t, dim = x.shape
        h = self.self_attn_layer_norm(x)

        def heads_of(z):
            return z.reshape(b, t, self.heads, -1).transpose(1, 2)

        att = masked_attention(heads_of(self.q_proj(h)), heads_of(self.k_proj(h)),
                               heads_of(self.v_proj(h)), mask=mask, causal=True)
        x = x + self.dropout(self.out_proj(att.transpose(1, 2).reshape(b, t, dim)))
        h = self.fc2(F.relu(self.fc1(self.final_layer_norm(x))))
        return x + self.dropout(h)


class UnitLMModule(nn.Module):
    def __init__(self, vocab_size: int, dim: int = 512, ffn_dim: int = 2048, layers: int = 6,
                 heads: int = 8, dropout: float = 0.1):
        super().__init__()
        self.dim, self.layers = dim, layers
        self.embed_tokens = nn.Embedding(vocab_size, dim)
        nn.init.normal_(self.embed_tokens.weight, std=dim ** -0.5)
        self.dropout = Dropout(dropout)
        for i in range(layers):
            self.add_module(f"layer_{i}", CausalLMLayer(dim, ffn_dim, heads, dropout))
        self.layer_norm = layer_norm(dim)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, T] -> logits [B, T, V] in the model's type."""
        valid = tokens != PAD
        x = self.embed_tokens(tokens.long()) * math.sqrt(self.dim)
        x = x + sinusoidal_positions(valid, self.dim, padding_idx=PAD).to(x.dtype)
        x = self.dropout(x)
        for i in range(self.layers):
            x = getattr(self, f"layer_{i}")(x, valid)
        x = self.layer_norm(x)
        return x @ self.embed_tokens.weight.T.to(x.dtype)


def transformer_lm_arch(cfg: dict) -> None:
    """`unit_lm` / `transformer_lm` (JAX unit_lm.py:86-108)."""
    for key, value in (("decoder_embed_dim", 512), ("decoder_layers", 6),
                       ("decoder_ffn_embed_dim", 2048), ("decoder_attention_heads", 8)):
        arch_default(cfg, key, value)


ARCHS = {"transformer_lm": transformer_lm_arch, "unit_lm": transformer_lm_arch}
