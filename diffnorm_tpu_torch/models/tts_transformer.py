"""The Tacotron-style autoregressive spectrogram decoder (the decoder half
of diffnorm_tpu/models/tts_transformer.py; reference
fairseq/models/text_to_speech/tts_transformer.py:139-315 and the Tacotron2
prenet and postnet, tacotron2.py:96-141), which `s2spect` and
Translatotron2 (`models/s2spect.py`, `models/s2spect2.py`) carry.

Each step reads the previous frame through `dec_prenet` (Linear + ReLU
layers with dropout that stays on at inference too, the Tacotron trick)
and `dec_prenet_proj`, adds `dec_pos_alpha` times the sinusoid of its step
(`sinusoidal_position_at`: position step + 1 + PAD, denominator half - 1),
runs the causal decoder layers (the unit decoders' pre-norm layers,
cross-attending the context, whose width may differ from the decoder's),
`dec_norm`, then `feat_proj` to the frame and `eos_proj` to the EOS
logit. `decode_full` is the teacher-forced form (positions 0 .. T-1 whatever
the padding), which adds the postnet's residual; `decode_step` one cached
step on a `KVCache` (no postnet: the rollout applies it once over all its
frames, `apply_postnet`). The postnet is `postnet_layers` SAME convolutions
with BatchNorm (running statistics in eval mode, the batch's over every
frame, padding included, in training, as JAX's) and tanh but the last.

The prenet's dropout draws from the `generator` its callers pass, or in
training from the trainer's dropout stream (`set_dropout_generator`); JAX's
PRNG stream cannot be reproduced, so the port's draws are its own.

`tts_loss` is JAX's Tacotron2 criterion: masked L1 + MSE on the pre- and
post-net frames, BCE with logits on the EOS head, positive at each row's
last valid frame and weighted by `bce_pos_weight`, means over the valid
frames.

`TTSTransformerModule` is the text-input model (`tts_transformer`, JAX
tts_transformer.py:131-202; reference TTSTransformerEncoder :45-131): the
token embedding (not scaled), `conv_layers` x (SAME conv of
`conv_kernel`, BatchNorm with flax's momentum 0.99, ReLU, dropout
`conv_dropout`), `prenet_proj`, plus `enc_pos_alpha` times the sinusoidal
positions keyed on the pad structure (padding_idx PAD), dropout, the
`TextEncoderLayer`s under the mask `tokens != PAD` and `enc_norm`; then the
spectrogram decoder above over the encoder's width. Its encoder takes no
lengths (`encode_needs_lengths` False, which `generate/speech_ar.py`
reads). It attends a few hundred text tokens at most, so it never reaches
the flash-attention kernel.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from diffnorm_tpu_torch.models.ar_transformer import KVCache, cached_layers, init_layer_cache
from diffnorm_tpu_torch.models.cmlm_text import TextEncoderLayer
from diffnorm_tpu_torch.models.conformer import BatchNorm, Conv1d, layer_norm
from diffnorm_tpu_torch.models.layers import (
    Dense,
    Dropout,
    DropoutSite,
    arch_default,
    sinusoidal_positions,
)
from diffnorm_tpu_torch.models.nar_transformer import DecoderLayer
from diffnorm_tpu_torch.ops import attention as attention_ops
from diffnorm_tpu_torch.parallel.mesh import global_sum

PAD = 1


def sinusoidal_position_at(index: torch.Tensor, dim: int, padding_idx: int = PAD) -> torch.Tensor:
    """The sinusoid [*, dim] of the 0-based steps `index` [*]: fairseq's
    table at index + 1 + padding_idx (JAX tts_transformer.py:33-46), float32."""
    pos = index.float() + 1.0 + padding_idx
    half = dim // 2
    inv = torch.exp(torch.arange(half, dtype=torch.float32, device=pos.device)
                    * -(math.log(10000.0) / (half - 1)))
    args = pos[..., None] * inv
    emb = torch.cat([args.sin(), args.cos()], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TacotronPrenet(DropoutSite, nn.Module):
    """`n_layers` x (Linear `fc_i`, ReLU, dropout), the dropout on in eval
    mode too, drawn from the `generator` passed or the module's own."""

    def __init__(self, in_dim: int, n_layers: int = 2, n_units: int = 256,
                 dropout: float = 0.5):
        super().__init__()
        self.n_layers, self.p = n_layers, dropout
        for i in range(n_layers):
            self.add_module(f"fc_{i}", Dense(in_dim if i == 0 else n_units, n_units))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for i in range(self.n_layers):
            x = F.relu(getattr(self, f"fc_{i}")(x))
            if self.p > 0.0:
                x = attention_ops.apply_dropout(x, self.p, generator or self.generator)
        return x


class TacotronPostnet(nn.Module):
    """`n_layers` SAME convolutions (`conv_i`) with BatchNorm (`bn_i`,
    flax's default momentum 0.99), tanh but the last, dropout in training;
    over [B, T, C]. The caller adds the residual."""

    def __init__(self, out_dim: int, channels: int = 512, kernel: int = 5, n_layers: int = 5,
                 dropout: float = 0.5):
        super().__init__()
        self.n_layers = n_layers
        # flax's SAME: k - 1 frames of zeros, the odd one after
        self.pad = ((kernel - 1) // 2, kernel // 2)
        for i in range(n_layers):
            c_in = out_dim if i == 0 else channels
            c_out = out_dim if i == n_layers - 1 else channels
            self.add_module(f"conv_{i}", Conv1d(c_in, c_out, kernel))
            self.add_module(f"bn_{i}", BatchNorm(c_out, momentum=0.99))
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"conv_{i}")(F.pad(x, (0, 0) + self.pad))
            x = getattr(self, f"bn_{i}")(x)
            if i < self.n_layers - 1:
                x = torch.tanh(x)
            x = self.dropout(x)
        return x


class TTSDecoderMixin:
    """The spectrogram decoder's fields and methods on the model itself, as
    JAX's `_setup_tts_decoder` puts them (their names are the flax tree's)."""

    def _setup_tts_decoder(self, dim: int, ffn_dim: int, decoder_layers: int, heads: int,
                           dropout: float, out_dim: int, n_frames_per_step: int,
                           context_dim: int, prenet_layers: int = 2, prenet_dim: int = 256,
                           prenet_dropout: float = 0.5, postnet_layers: int = 5,
                           postnet_dim: int = 512, postnet_kernel: int = 5,
                           postnet_dropout: float = 0.5) -> None:
        self.dim, self.heads, self.out_dim = dim, heads, out_dim
        self.n_frames_per_step, self.n_dec_layers = n_frames_per_step, decoder_layers
        self.dec_dropout = Dropout(dropout)
        self.dec_prenet = TacotronPrenet(out_dim, prenet_layers, prenet_dim, prenet_dropout)
        self.dec_prenet_proj = Dense(prenet_dim, dim)
        self.dec_pos_alpha = nn.Parameter(torch.ones(1))
        for i in range(decoder_layers):
            self.add_module(f"dec_layer_{i}", DecoderLayer(
                dim, ffn_dim, heads, dropout, dropout, dropout, causal=True,
                context_dim=context_dim))
        self.dec_norm = layer_norm(dim)
        self.feat_proj = Dense(dim, out_dim)
        self.eos_proj = Dense(dim, 1)
        self.postnet = TacotronPostnet(out_dim, postnet_dim, postnet_kernel, postnet_layers,
                                       postnet_dropout)

    def dec_layers(self):
        return [getattr(self, f"dec_layer_{i}") for i in range(self.n_dec_layers)]

    def _dec_input(self, prev_feats: torch.Tensor, positions: torch.Tensor,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
        x = self.dec_prenet_proj(self.dec_prenet(prev_feats, generator))
        return x + self.dec_pos_alpha * sinusoidal_position_at(positions, self.dim).to(x.dtype)

    def decode_full(self, prev_feats: torch.Tensor, tgt_mask: torch.Tensor,
                    enc: torch.Tensor, enc_mask: torch.Tensor, return_inner: bool = False,
                    generator: Optional[torch.Generator] = None):
        """Teacher-forced: prev_feats [B, T, out_dim] (the targets shifted
        right behind a zero frame), tgt_mask [B, T] True = valid. Returns
        (post_feat, feat [B, T, out_dim], eos_logits [B, T]), and with
        `return_inner` the hidden states [embed_out, after layer 1, ...]
        before the final norm."""
        t = prev_feats.shape[1]
        x = self._dec_input(prev_feats, torch.arange(t, device=prev_feats.device)[None, :],
                            generator)
        x = self.dec_dropout(x)
        inner = [x]
        for layer in self.dec_layers():
            x = layer(x, tgt_mask, enc, enc_mask)
            inner.append(x)
        x = self.dec_norm(x)
        feat = self.feat_proj(x)
        eos_logits = self.eos_proj(x)[..., 0]
        post = feat + self.postnet(feat)
        if return_inner:
            return post, feat, eos_logits, inner
        return post, feat, eos_logits

    def init_cache(self, enc: torch.Tensor, enc_mask: torch.Tensor, max_len: int) -> KVCache:
        """An empty cache of `max_len` steps decoding against enc [N, S, C]."""
        return init_layer_cache(self.dec_layers(), self.heads, self.dim,
                                self.dec_norm.weight.dtype, enc, enc_mask, max_len)

    def decode_step(self, prev_feat: torch.Tensor, cache: KVCache, position: int,
                    generator: Optional[torch.Generator] = None):
        """One cached step in eval mode: prev_feat [N, 1, out_dim] at step
        `position` -> (feat [N, out_dim], eos_logit [N], cache)."""
        pos = torch.full((1, 1), position, device=prev_feat.device)
        x = cached_layers(self.dec_layers(), self._dec_input(prev_feat, pos, generator), cache)
        x = self.dec_norm(x)
        return self.feat_proj(x)[:, 0], self.eos_proj(x)[:, 0, 0], cache

    def apply_postnet(self, feat: torch.Tensor) -> torch.Tensor:
        return feat + self.postnet(feat)


class TTSTransformerModule(TTSDecoderMixin, nn.Module):
    """Text encoder + spectrogram decoder (module docstring); widths default
    to tts_transformer_base's, the decoder as wide as the encoder."""

    encode_needs_lengths = False

    def __init__(self, vocab_size: int, dim: int = 512, ffn_dim: int = 2048,
                 encoder_layers: int = 6, decoder_layers: int = 6, heads: int = 4,
                 dropout: float = 0.1, out_dim: int = 80, n_frames_per_step: int = 1,
                 conv_layers: int = 3, conv_kernel: int = 5, conv_dropout: float = 0.5,
                 prenet_layers: int = 2, prenet_dim: int = 256, prenet_dropout: float = 0.5,
                 postnet_layers: int = 5, postnet_dim: int = 512, postnet_kernel: int = 5,
                 postnet_dropout: float = 0.5):
        super().__init__()
        self.n_conv, self.n_enc_layers = conv_layers, encoder_layers
        self.embed_tokens = nn.Embedding(vocab_size, dim)
        nn.init.normal_(self.embed_tokens.weight, std=dim ** -0.5)
        # flax's SAME: k - 1 frames of zeros, the odd one after
        self.conv_pad = ((conv_kernel - 1) // 2, conv_kernel // 2)
        for i in range(conv_layers):
            self.add_module(f"enc_conv_{i}", Conv1d(dim, dim, conv_kernel))
            self.add_module(f"enc_bn_{i}", BatchNorm(dim, momentum=0.99))
        self.prenet_proj = Dense(dim, dim)
        for i in range(encoder_layers):
            self.add_module(f"enc_layer_{i}", TextEncoderLayer(dim, ffn_dim, heads, dropout))
        self.enc_norm = layer_norm(dim)
        self.enc_pos_alpha = nn.Parameter(torch.ones(1))
        self.enc_conv_dropout = Dropout(conv_dropout)
        self.enc_dropout = Dropout(dropout)
        self._setup_tts_decoder(dim, ffn_dim, decoder_layers, heads, dropout, out_dim,
                                n_frames_per_step, dim, prenet_layers, prenet_dim,
                                prenet_dropout, postnet_layers, postnet_dim, postnet_kernel,
                                postnet_dropout)

    def encode(self, src_tokens: torch.Tensor):
        """(enc [B, S, dim], enc_mask [B, S] True = valid) of tokens [B, S]."""
        valid = src_tokens != PAD
        x = self.embed_tokens(src_tokens)
        for i in range(self.n_conv):
            x = getattr(self, f"enc_conv_{i}")(F.pad(x, (0, 0) + self.conv_pad))
            x = self.enc_conv_dropout(F.relu(getattr(self, f"enc_bn_{i}")(x)))
        x = self.prenet_proj(x)
        x = x + self.enc_pos_alpha * sinusoidal_positions(valid, self.dim,
                                                          padding_idx=PAD).to(x.dtype)
        x = self.enc_dropout(x)
        for i in range(self.n_enc_layers):
            x = getattr(self, f"enc_layer_{i}")(x, valid)
        return self.enc_norm(x), valid

    def forward(self, src_tokens: torch.Tensor, src_lengths: Optional[torch.Tensor],
                prev_feats: torch.Tensor, tgt_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Dict:
        """Teacher-forced: {"post_feat", "feat" [B, T, out_dim], "eos_logits"
        [B, T]}; `src_lengths` is not read (the mask comes from the pad id),
        the prenet draws from `generator`."""
        enc, enc_mask = self.encode(src_tokens)
        post, feat, eos_logits = self.decode_full(prev_feats, tgt_mask, enc, enc_mask,
                                                  generator=generator)
        return {"post_feat": post, "feat": feat, "eos_logits": eos_logits}


def tts_loss(out: Dict, feat_tgt: torch.Tensor, tgt_lengths: torch.Tensor,
             bce_pos_weight: float = 1.0):
    """(loss, {"loss", "l1_loss", "mse_loss", "eos_loss"}) of the decoder's
    {"post_feat", "feat", "eos_logits"} against feat_tgt [B, T, D] with
    tgt_lengths [B] (module docstring; JAX tts_transformer.py:262-290)."""
    b, t, d = feat_tgt.shape
    steps = torch.arange(t, device=feat_tgt.device)[None, :]
    mask = steps < tgt_lengths[:, None]
    eos_tgt = (steps == (tgt_lengths - 1)[:, None]).float()
    denom = torch.clamp(global_sum(mask.sum()), min=1)  # the global frames under a split
    tgt = feat_tgt.float()

    def masked_mean(x):
        return torch.where(mask[..., None], x, 0.0).sum() / (denom * d)

    feat, post = out["feat"].float(), out["post_feat"].float()
    l1 = masked_mean((feat - tgt).abs()) + masked_mean((post - tgt).abs())
    mse = masked_mean((feat - tgt).square()) + masked_mean((post - tgt).square())
    z = out["eos_logits"].float()
    soft = torch.log1p(torch.exp(-z.abs()))
    per = torch.clamp(z, min=0.0) - z * eos_tgt + soft
    per = per + (bce_pos_weight - 1.0) * eos_tgt * (soft + torch.clamp(-z, min=0.0))
    eos_loss = torch.where(mask, per, 0.0).sum() / denom
    loss = l1 + mse + eos_loss
    return loss, {"loss": loss, "l1_loss": l1, "mse_loss": mse, "eos_loss": eos_loss}


def tts_transformer_base_arch(cfg: dict) -> None:
    """tts_transformer_base's defaults for the widths left None in `cfg`
    (JAX tts_transformer.py:327-337, and build_model's defaults, :296-322)."""
    for key, value in (("encoder_embed_dim", 512), ("encoder_ffn_embed_dim", 2048),
                       ("encoder_transformer_layers", 6), ("decoder_transformer_layers", 6),
                       ("encoder_attention_heads", 4), ("dropout", 0.1),
                       ("output_frame_dim", 80), ("prenet_dim", 256),
                       ("postnet_conv_dim", 512), ("encoder_conv_layers", 3),
                       ("encoder_conv_kernel_size", 5), ("encoder_dropout", 0.5)):
        arch_default(cfg, key, value)


ARCHS = {"tts_transformer": tts_transformer_base_arch,
         "tts_transformer_base": tts_transformer_base_arch}
