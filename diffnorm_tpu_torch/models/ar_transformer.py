"""The autoregressive S2UT translator ("speech_to_speech_ar", the paper's
AR baseline, fairseq's s2ut_conformer): the port of
diffnorm_tpu/models/ar_transformer.py.

`ARUnitDecoder` is the causal unit decoder. JAX's `CachedMultiheadAttention`
without its cache is the NAR module's `MultiheadAttention` (fairseq MHA,
biased projections) with `causal=True` for self-attention, and its
`ARDecoderLayer` the NAR `DecoderLayer` with that causal self-attention:
same sublayers, names, dropouts and numerics. Teacher-forced (`forward`):
embedding x sqrt(dim) + sinusoidal positions keyed on the pad structure,
the layers, the final norm, then the logits: x @ embed^T (the shared
embedding), the unshared `output_proj`, or with n_frames_per_step k > 1 a
`StackedEmbedding` input and `out_proj_n_frames` (D -> k D) then
`subframe_out` (D -> V) to logits [B, T, k, V]. `return_features` adds the
features after the final norm, `return_inner` the hidden states before it.
The multitask aux heads of type "transformer" are such decoders.

Decoding one step at a time (`decode_step`, JAX's decode=True) reads and
writes a `KVCache`, explicit state the caller holds: per layer a
preallocated self-attention key and value buffer [N, H, L, D] in the
model's dtype and the write index `length`; the step's key and value go in
at that index and the query attends the positions <= it, without a causal
mask, as in JAX. The encoder attention's keys and values are projected once
per decode, in `init_cache`, where JAX projects them at every step: they
hold the same values. Both go through the layers' own forward
(`MultiheadAttention`'s `kv`). The decoded position's sinusoid is JAX's
(pos + 1 + PAD), the position the teacher-forced form gives it. Decoding
runs in eval mode, without dropout, as JAX's decode does. On the card the encoder attention takes the
flash-attention kernel under `ops.attention.masked_attention`'s routing
(>= 2048 encoder frames, no attention dropout): one query a row in decode.

`ARS2UTModule` is JAX's: a conformer encoder (`encoder_type` "conformer",
s2ut_conformer) or the S2T transformer encoder (`models/s2t_transformer.py`,
s2ut_transformer), the optional target-speaker projection `spk_emb_proj`,
the decoder, and the --multitask-config-yaml aux heads of the NAR model
(`build_aux_heads`), run in the training and validation forward only. As
JAX's, the conformer takes its own subsampler widths (1024 channels,
kernels (5, 5)) whatever `conv_channels` says; the transformer encoder
takes `conv_channels` and `conv_kernel_sizes`.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from diffnorm_tpu_torch.models.conformer import ConformerEncoder, layer_norm
from diffnorm_tpu_torch.models.layers import Dense, Dropout, arch_default, sinusoidal_positions
from diffnorm_tpu_torch.models.nar_transformer import (
    AuxTaskSpec,
    DecoderLayer,
    NARS2UTModule,
    aux_head_outputs,
    build_aux_heads,
)
from diffnorm_tpu_torch.models.s2t_transformer import S2TTransformerEncoder
from diffnorm_tpu_torch.models.stacked import StackedEmbedding

PAD, BOS, EOS, UNK = 1, 0, 2, 3


def decode_position_embedding(position: torch.Tensor, dim: int) -> torch.Tensor:
    """The sinusoid of each row's decoded position [N]: fairseq's table at
    position + 1 + PAD, [N, dim] float32 (JAX ar_transformer.py:192-202)."""
    half = dim // 2
    inv = torch.exp(torch.arange(half, dtype=torch.float32, device=position.device)
                    * -(math.log(10000.0) / (half - 1)))
    args = (position.float() + 1 + PAD)[:, None] * inv[None, :]
    return torch.cat([args.sin(), args.cos()], dim=-1)


class KVCache:
    """The decode state of an `ARUnitDecoder` (module docstring): per layer
    the self-attention keys and values [N, H, L, D], of which the first
    `length` positions are written, and the encoder attention's keys and
    values [N, H, S, D] with the encoder mask [N, S]."""

    def __init__(self, keys: List[torch.Tensor], values: List[torch.Tensor],
                 enc_keys: List[torch.Tensor], enc_values: List[torch.Tensor],
                 enc_mask: torch.Tensor):
        self.keys, self.values = keys, values
        self.enc_keys, self.enc_values, self.enc_mask = enc_keys, enc_values, enc_mask
        self.length = 0

    @property
    def max_len(self) -> int:
        return self.keys[0].shape[2]

    def reorder(self, index: torch.Tensor) -> "KVCache":
        """Row i takes the written keys and values of row index[i] (beam
        selection), in place. Each row keeps to its sentence's block of
        beams, as a beam search selects: the encoder keys and values, equal
        across a sentence's beams, stay as they are."""
        n = self.length
        for buf in self.keys + self.values:
            buf[:, :, :n] = buf[index, :, :n]
        return self


class ARUnitDecoder(nn.Module):
    """Causal unit decoder (module docstring). `context_dim` is the width of
    the encoder states it attends (default `dim`); `attention_dropout` and
    `activation_dropout` fall back to `dropout` where None."""

    def __init__(self, vocab_size: int, dim: int = 512, ffn_dim: int = 2048, layers: int = 6,
                 heads: int = 8, dropout: float = 0.1, attention_dropout: Optional[float] = None,
                 activation_dropout: Optional[float] = None,
                 context_dim: Optional[int] = None, n_frames_per_step: int = 1,
                 share_input_output_embed: bool = True):
        super().__init__()
        self.dim, self.n_layers, self.heads = dim, layers, heads
        self.n_frames_per_step = n_frames_per_step
        attention_dropout = dropout if attention_dropout is None else attention_dropout
        activation_dropout = dropout if activation_dropout is None else activation_dropout
        if n_frames_per_step > 1:
            self.embed_tokens = StackedEmbedding(vocab_size, dim, n_frames_per_step)
            self.out_proj_n_frames = Dense(dim, dim * n_frames_per_step, bias=False)
            self.subframe_out = Dense(dim, vocab_size, bias=False)
        else:
            self.embed_tokens = nn.Embedding(vocab_size, dim)
            nn.init.normal_(self.embed_tokens.weight, std=dim ** -0.5)
            if not share_input_output_embed:
                self.output_proj = Dense(dim, vocab_size, bias=False)
        self.embed_dropout = Dropout(dropout)
        for i in range(layers):
            self.add_module(f"layer_{i}", DecoderLayer(
                dim, ffn_dim, heads, dropout, attention_dropout, activation_dropout,
                causal=True, context_dim=context_dim))
        self.layer_norm = layer_norm(dim)

    def layers(self):
        return [getattr(self, f"layer_{i}") for i in range(self.n_layers)]

    def output_logits(self, x: torch.Tensor) -> torch.Tensor:
        """Final features [N, T, D] -> logits [N, T, V] ([N, T, k, V])."""
        k = self.n_frames_per_step
        if k > 1:
            b, t, _ = x.shape
            return self.subframe_out(self.out_proj_n_frames(x).reshape(b, t, k, self.dim))
        if hasattr(self, "output_proj"):
            return self.output_proj(x)
        return F.linear(x, self.embed_tokens.weight)

    def forward(self, tokens: torch.Tensor, enc: torch.Tensor, enc_mask: torch.Tensor,
                return_inner: bool = False, return_features: bool = False):
        """tokens [B, T] (teacher-forced prev_output_tokens, packed ids when
        stacked); enc [B, S, C]; enc_mask [B, S] True = valid. Returns
        logits, then the final features [B, T, D] with `return_features`,
        then [embed_out, after layer 1, ...] with `return_inner`: a tuple
        where either is asked for, else the logits."""
        valid = tokens != PAD
        x = self.embed_tokens(tokens) * math.sqrt(self.dim)
        x = self.embed_dropout(
            x + sinusoidal_positions(valid, self.dim, padding_idx=PAD).to(x.dtype))
        inner = [x]
        for layer in self.layers():
            x = layer(x, valid, enc, enc_mask)
            inner.append(x)
        x = self.layer_norm(x)
        out = (self.output_logits(x),)
        if return_features:
            out = out + (x,)
        if return_inner:
            out = out + (inner,)
        return out if len(out) > 1 else out[0]

    def init_cache(self, enc: torch.Tensor, enc_mask: torch.Tensor, max_len: int) -> KVCache:
        """An empty cache of `max_len` positions for rows decoding against
        enc [N, S, C] (enc_mask [N, S]): each layer's encoder keys and values
        projected here, once."""
        return init_layer_cache(self.layers(), self.heads, self.dim,
                                self.layer_norm.weight.dtype, enc, enc_mask, max_len)

    def decode_step(self, tokens: torch.Tensor, cache: KVCache, position: torch.Tensor):
        """One step, in eval mode: tokens [N, 1] at `position` [N] ->
        (logits [N, V], or [N, k, V] when stacked; the cache with the step
        written)."""
        x = self.embed_tokens(tokens) * math.sqrt(self.dim)
        x = x + decode_position_embedding(position, self.dim)[:, None, :].to(x.dtype)
        x = cached_layers(self.layers(), x, cache)
        return self.output_logits(self.layer_norm(x))[:, 0], cache


def init_layer_cache(layers: Sequence[nn.Module], heads: int, dim: int, dtype: torch.dtype,
                     enc: torch.Tensor, enc_mask: torch.Tensor, max_len: int) -> KVCache:
    """An empty `KVCache` of `max_len` positions for causal `DecoderLayer`s
    of width `dim` decoding against enc [N, S, C]: each layer's encoder keys
    and values projected here, once."""
    n = enc.shape[0]
    keys, values, enc_keys, enc_values = [], [], [], []
    for layer in layers:
        for buf in (keys, values):
            buf.append(torch.zeros(n, heads, max_len, dim // heads, dtype=dtype,
                                   device=enc.device))
        k, v = layer.encoder_attn.project_kv(enc)
        enc_keys.append(k)
        enc_values.append(v)
    return KVCache(keys, values, enc_keys, enc_values, enc_mask)


def cached_layers(layers: Sequence[nn.Module], x: torch.Tensor, cache: KVCache) -> torch.Tensor:
    """One decode step x [N, 1, D] through `layers` on `cache`, whose write
    index moves on by one."""
    t = cache.length
    if t >= cache.max_len:
        raise ValueError(f"decode_step: the cache holds {cache.max_len} positions")
    for i, layer in enumerate(layers):
        x = layer(x, None, None, cache.enc_mask, self_kv=(cache.keys[i], cache.values[i]),
                  enc_kv=(cache.enc_keys[i], cache.enc_values[i]), write_at=t)
    cache.length = t + 1
    return x


class ARS2UTModule(nn.Module):
    """Speech encoder + causal unit decoder (module docstring). Dimensions
    follow the `s2ut_conformer` arch defaults; `attention_dropout` and
    `activation_dropout` fall back to `dropout` where None."""

    def __init__(self, vocab_size: int = 1004, in_channels: int = 80,
                 encoder_dim: int = 512, encoder_ffn_dim: int = 2048,
                 encoder_layers: int = 12, encoder_heads: int = 8,
                 decoder_dim: int = 512, decoder_ffn_dim: int = 2048,
                 decoder_layers: int = 6, decoder_heads: int = 8, dropout: float = 0.1,
                 attention_dropout: Optional[float] = None,
                 activation_dropout: Optional[float] = None, depthwise_kernel_size: int = 31,
                 encoder_type: str = "conformer", conv_channels: int = 1024,
                 conv_kernel_sizes: Sequence[int] = (5, 5), n_frames_per_step: int = 1,
                 multitask: Sequence[AuxTaskSpec] = (), target_speaker_embed: bool = False,
                 speaker_embed_dim: int = 256):
        super().__init__()
        self.vocab_size, self.n_frames_per_step = vocab_size, n_frames_per_step
        self.multitask = tuple(multitask)
        if target_speaker_embed:
            self.spk_emb_proj = Dense(encoder_dim + speaker_embed_dim, encoder_dim)
        common = dict(in_channels=in_channels, dim=encoder_dim, ffn_dim=encoder_ffn_dim,
                      layers=encoder_layers, heads=encoder_heads, dropout=dropout,
                      attention_dropout=attention_dropout,
                      activation_dropout=activation_dropout)
        if encoder_type == "conformer":
            self.encoder = ConformerEncoder(depthwise_kernel_size=depthwise_kernel_size,
                                            **common)
        elif encoder_type == "transformer":
            self.encoder = S2TTransformerEncoder(conv_channels=conv_channels,
                                                 conv_kernel_sizes=tuple(conv_kernel_sizes),
                                                 **common)
        else:
            raise ValueError(f"encoder_type {encoder_type!r}: conformer or transformer")
        self.decoder = ARUnitDecoder(
            vocab_size, decoder_dim, decoder_ffn_dim, decoder_layers, decoder_heads,
            dropout=dropout, attention_dropout=attention_dropout,
            activation_dropout=activation_dropout, context_dim=encoder_dim,
            n_frames_per_step=n_frames_per_step)
        build_aux_heads(self, self.multitask, encoder_dim, decoder_dim)

    apply_speaker = NARS2UTModule.apply_speaker

    def encode(self, src: torch.Tensor, src_lengths: torch.Tensor,
               tgt_speaker: Optional[torch.Tensor] = None):
        enc, enc_mask = self.encoder(src, src_lengths)
        return self.apply_speaker(enc, tgt_speaker), enc_mask

    def init_cache(self, enc: torch.Tensor, enc_mask: torch.Tensor, max_len: int) -> KVCache:
        return self.decoder.init_cache(enc, enc_mask, max_len)

    def decode_step(self, tokens: torch.Tensor, cache: KVCache, position: torch.Tensor):
        """tokens [N, 1] -> (logits [N, V] ([N, k, V] stacked), cache)."""
        return self.decoder.decode_step(tokens, cache, position)

    def forward(self, src: torch.Tensor, src_lengths: torch.Tensor, prev_tokens: torch.Tensor,
                tgt_tokens: Optional[torch.Tensor] = None,
                multitask_prev: Optional[Dict[str, torch.Tensor]] = None,
                tgt_speaker: Optional[torch.Tensor] = None) -> Dict:
        """The teacher-forced forward: src [B, T, F], prev_tokens [B, L]
        (packed when stacked). `tgt_tokens` only turns the aux heads on (the
        training and validation forward; JAX's convention), multitask_prev
        is {task: prev_output_tokens} of the transformer aux heads. Returns
        {"logits" [B, L, V] ([B, L, k, V]), and "multitask" with the aux
        heads}."""
        run_mt = bool(self.multitask) and tgt_tokens is not None
        if run_mt:
            enc, enc_mask, enc_states = self.encoder(src, src_lengths, return_all_layers=True)
        else:
            enc, enc_mask = self.encoder(src, src_lengths)
        enc = self.apply_speaker(enc, tgt_speaker)
        need_inner = run_mt and any(s.input_from == "decoder" for s in self.multitask)
        logits = self.decoder(prev_tokens, enc, enc_mask, return_inner=need_inner)
        inner = None
        if need_inner:
            logits, inner = logits
        out = {"logits": logits}
        if run_mt:
            out["multitask"] = aux_head_outputs(self, self.multitask, multitask_prev,
                                                enc_states, enc_mask, inner, prev_tokens)
        return out


def s2ut_conformer_arch(cfg: dict) -> None:
    """The `s2ut_conformer` defaults for every width left None in `cfg`
    (JAX ar_transformer.py:408-417, and build_model's depthwise kernel, :394):
    the decoder's widths default to 512 and 2048, not to the encoder's."""
    for key, value in (("encoder_embed_dim", 512), ("encoder_ffn_embed_dim", 2048),
                       ("encoder_layers", 12), ("encoder_attention_heads", 8),
                       ("decoder_embed_dim", 512), ("decoder_ffn_embed_dim", 2048),
                       ("decoder_layers", 6), ("decoder_attention_heads", 8),
                       ("dropout", 0.1), ("encoder_type", "conformer"),
                       ("depthwise_conv_kernel_size", 31)):
        arch_default(cfg, key, value)


def s2ut_transformer_arch(cfg: dict) -> None:
    """`s2ut_transformer` (reference s2ut_architecture_base): the S2T
    transformer encoder, the decoder's widths defaulting to the encoder's."""
    cfg["encoder_type"] = "transformer"
    arch_default(cfg, "encoder_embed_dim", 512)
    arch_default(cfg, "encoder_ffn_embed_dim", 2048)
    arch_default(cfg, "decoder_embed_dim", cfg["encoder_embed_dim"])
    arch_default(cfg, "decoder_ffn_embed_dim", cfg["encoder_ffn_embed_dim"])
    s2ut_conformer_arch(cfg)


def s2ut_transformer_fisher_arch(cfg: dict) -> None:
    """`s2ut_transformer_fisher` (reference s2ut_architecture_fisher)."""
    arch_default(cfg, "encoder_embed_dim", 256)
    arch_default(cfg, "encoder_attention_heads", 4)
    s2ut_transformer_arch(cfg)


ARCHS = {"s2ut_conformer": s2ut_conformer_arch,
         "s2ut_transformer": s2ut_transformer_arch,
         "s2ut_transformer_fisher": s2ut_transformer_fisher_arch}
