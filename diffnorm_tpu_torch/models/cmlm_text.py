"""The text encoder and the text CMLM (the port of
diffnorm_tpu/models/cmlm_text.py): `TextEncoderLayer`, fairseq's pre-norm
TransformerEncoderLayer, which UnitY's synthesizer encoder, the TTS
transformer's encoder and FastSpeech2's encoder and decoder stack;
`TextEncoder`, the token encoder of FastSpeech2, the text CMLM, the AR text
transformer (`models/transformer_text.py`) and the Levenshtein transformer
(`models/levenshtein.py`); and `TextCMLMModule`, the classifier-free-guided
CMLM for text translation (the "cmlm_cg" task, arch `cmlm_transformer`).

`TextEncoder` embeds the tokens scaled by sqrt(dim), adds fairseq's
sinusoidal positions keyed on the pad structure (padding_idx PAD), drops
out, runs the layers under the key-padding mask `tokens != PAD` and ends in
a LayerNorm. The self-attention is `MultiheadAttention`, so on the card a
call with >= 2048 keys and no attention dropout (eval) takes the
flash-attention kernel (`ops.attention.masked_attention`): FastSpeech2's
decoder layers over its 2048-frame buffer, a document-length source.

JAX's TextEncoderLayer passes its dtype positionally into
MultiheadAttention's `quant` field, so JAX's layer runs its attention
projections in int8 (a fault of the reference,
tests/test_torch_tts.py::test_text_encoder_layer_fault_of_the_reference);
the port's layer is fairseq's float one.

`TextCMLMModule` is that encoder and the NAR S2UT model's NAT unit decoder
with its 256-way length head (`models/nar_transformer.py`), so
`generate.mask_predict.mask_predict_decode` decodes it unchanged: `encode`,
`decode`, `forward_length`, `apply_cg_drop` (the BOS embedding as the null
context) and the training forward, whose classifier-free-guidance drop of
whole sources (`cg_prob`) draws from the model's `cg_generator` (the
trainer's) unless given as `cg_drop`.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from diffnorm_tpu_torch.models.conformer import layer_norm
from diffnorm_tpu_torch.models.layers import Dense, Dropout, arch_default, sinusoidal_positions
from diffnorm_tpu_torch.models.nar_transformer import (
    MultiheadAttention,
    NARS2UTModule,
    NATUnitDecoder,
)

PAD, UNK = 1, 3


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


class TextCMLMModule(nn.Module):
    """Text encoder + NAT unit decoder with its length head (module
    docstring); every dropout of the decoder is `dropout`, as JAX's."""

    n_frames_per_step = 1

    def __init__(self, src_vocab_size: int, tgt_vocab_size: int, dim: int = 512,
                 ffn_dim: int = 2048, encoder_layers: int = 6, decoder_layers: int = 6,
                 heads: int = 8, dropout: float = 0.1, cg_prob: float = 0.0):
        super().__init__()
        self.vocab_size, self.cg_prob = tgt_vocab_size, cg_prob
        self.cg_generator: Optional[torch.Generator] = None
        self.sp_generator: Optional[torch.Generator] = None
        self.encoder = TextEncoder(src_vocab_size, dim, ffn_dim, encoder_layers, heads, dropout)
        self.decoder = NATUnitDecoder(tgt_vocab_size, dim, ffn_dim, decoder_layers, heads,
                                      dropout=dropout, attention_dropout=dropout,
                                      activation_dropout=dropout)

    def encode(self, src_tokens: torch.Tensor, src_lengths: Optional[torch.Tensor] = None,
               tgt_speaker=None):
        """(features [B, S, dim], mask [B, S]); the mask comes from the
        tokens, so `src_lengths` is not read."""
        return self.encoder(src_tokens)

    apply_cg_drop = NARS2UTModule.apply_cg_drop

    def decode(self, tokens, enc, enc_mask):
        return self.decoder(tokens, enc, enc_mask)

    def forward_length(self, enc, enc_mask):
        return self.decoder.forward_length(enc, enc_mask)

    def forward(self, src_tokens: torch.Tensor, src_lengths: torch.Tensor,
                prev_tokens: torch.Tensor, tgt_tokens: Optional[torch.Tensor] = None,
                cg_drop: Optional[torch.Tensor] = None, use_prompt=None,
                multitask_prev: Optional[Dict] = None, tgt_speaker=None) -> Dict:
        """The training and validation forward over the CMLM canvas
        prev_tokens [B, L]: logits [B, L, V], word_ins_mask (the canvas's
        UNK positions), length_logits [B, 256] and length_tgt (the target
        lengths clipped to 255, or the length head's argmax without
        targets). In training mode with cg_prob > 0, rows are CG-dropped
        (drawn from cg_generator unless `cg_drop` [B] bool is given). The
        model has no self-prompt and no aux heads: `use_prompt` is not read
        and `multitask_prev` must be None, as in JAX."""
        if multitask_prev is not None:
            raise ValueError("cmlm_transformer has no --multitask-config-yaml aux decoders")
        enc, enc_mask = self.encoder(src_tokens)
        length_logits = self.decoder.forward_length(enc, enc_mask)
        if tgt_tokens is not None:
            length_tgt = torch.clamp((tgt_tokens != PAD).sum(dim=1), 0,
                                     self.decoder.max_lengths - 1)
        else:
            length_tgt = length_logits.argmax(dim=-1)
        if self.training and self.cg_prob > 0.0:
            if cg_drop is None:
                cg_drop = torch.rand(enc.shape[0], generator=self.cg_generator,
                                     device=enc.device) < self.cg_prob
            enc, enc_mask = self.apply_cg_drop(enc, enc_mask, cg_drop)
        return {"logits": self.decoder(prev_tokens, enc, enc_mask),
                "word_ins_mask": prev_tokens == UNK, "length_logits": length_logits,
                "length_tgt": length_tgt}


def cmlm_transformer_arch(cfg: dict) -> None:
    """`cmlm_transformer` (JAX cmlm_text.py:180-185 and build_model's
    defaults, :157-170): 512 wide, FF 2048, 6 + 6 layers, 8 heads."""
    for key, value in (("encoder_embed_dim", 512), ("encoder_ffn_embed_dim", 2048),
                       ("encoder_layers", 6), ("decoder_layers", 6),
                       ("encoder_attention_heads", 8), ("dropout", 0.1)):
        arch_default(cfg, key, value)


ARCHS = {"cmlm_transformer": cmlm_transformer_arch}
