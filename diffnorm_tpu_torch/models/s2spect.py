"""Speech-to-spectrogram S2ST, single pass (fairseq's s2spect_transformer /
s2spect_conformer): the port of diffnorm_tpu/models/s2spect.py.

A speech encoder (the S2T transformer encoder, or the conformer with
`encoder_type` "conformer") and the Tacotron-style AR spectrogram decoder
of `models/tts_transformer.py` cross-attending it: decoder widths `dim` /
`ffn_dim` / `heads` / `decoder_layers`, the encoder's `enc_*`, the
cross-attention projecting from the encoder's width. Trained with the
Tacotron2 criterion (`criterions/tts_loss.py`), decoded by the AR mel
rollout (`generate/speech_ar.py`). Unlike the AR S2UT conformer, the
conformer here takes `conv_channels` and `conv_kernel_sizes`, as JAX's.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from diffnorm_tpu_torch.models.conformer import ConformerEncoder
from diffnorm_tpu_torch.models.layers import arch_default
from diffnorm_tpu_torch.models.s2t_transformer import S2TTransformerEncoder
from diffnorm_tpu_torch.models.tts_transformer import TTSDecoderMixin


class S2SpecTModule(TTSDecoderMixin, nn.Module):
    """Speech encoder + spectrogram decoder (module docstring); widths
    default to s2spect_transformer's. The decoder cross-attends features of
    `context_dim` (default the encoder's width)."""

    encode_needs_lengths = True  # generate/speech_ar.py

    def __init__(self, in_channels: int = 80, enc_dim: int = 512, enc_ffn_dim: int = 2048,
                 enc_layers: int = 12, enc_heads: int = 8, encoder_type: str = "transformer",
                 conv_channels: int = 1024, conv_kernel_sizes: Sequence[int] = (5, 5),
                 depthwise_kernel_size: int = 31, dim: int = 512, ffn_dim: int = 2048,
                 decoder_layers: int = 6, heads: int = 4, dropout: float = 0.1,
                 out_dim: int = 80, n_frames_per_step: int = 1, prenet_layers: int = 2,
                 prenet_dim: int = 256, prenet_dropout: float = 0.5, postnet_layers: int = 5,
                 postnet_dim: int = 512, postnet_kernel: int = 5,
                 postnet_dropout: float = 0.5, context_dim: Optional[int] = None):
        super().__init__()
        common = dict(in_channels=in_channels, dim=enc_dim, ffn_dim=enc_ffn_dim,
                      layers=enc_layers, heads=enc_heads, dropout=dropout,
                      conv_channels=conv_channels, conv_kernel_sizes=tuple(conv_kernel_sizes))
        if encoder_type == "conformer":
            self.encoder = ConformerEncoder(depthwise_kernel_size=depthwise_kernel_size,
                                            **common)
        elif encoder_type == "transformer":
            self.encoder = S2TTransformerEncoder(**common)
        else:
            raise ValueError(f"encoder_type {encoder_type!r}: conformer or transformer")
        self._setup_tts_decoder(dim, ffn_dim, decoder_layers, heads, dropout, out_dim,
                                n_frames_per_step, context_dim or enc_dim, prenet_layers,
                                prenet_dim, prenet_dropout, postnet_layers, postnet_dim,
                                postnet_kernel, postnet_dropout)

    def encode(self, src: torch.Tensor, src_lengths: torch.Tensor):
        return self.encoder(src, src_lengths)

    def forward(self, src: torch.Tensor, src_lengths: torch.Tensor, prev_feats: torch.Tensor,
                tgt_mask: torch.Tensor, generator: Optional[torch.Generator] = None):
        """Teacher-forced: {"post_feat", "feat" [B, T, out_dim], "eos_logits"
        [B, T]}; the prenet draws from `generator` (module docstring of
        `models/tts_transformer.py`)."""
        enc, enc_mask = self.encode(src, src_lengths)
        post, feat, eos_logits = self.decode_full(prev_feats, tgt_mask, enc, enc_mask,
                                                  generator=generator)
        return {"post_feat": post, "feat": feat, "eos_logits": eos_logits}


def _spect_decoder_defaults(cfg: dict) -> None:
    for key, value in (("decoder_embed_dim", 512), ("decoder_ffn_embed_dim", 2048),
                       ("decoder_transformer_layers", 6), ("decoder_attention_heads", 4),
                       ("output_frame_dim", 80), ("dropout", 0.1),
                       ("depthwise_conv_kernel_size", 31)):
        arch_default(cfg, key, value)


def s2spect_transformer_arch(cfg: dict) -> None:
    """fairseq's s2spect_architecture_base (JAX s2spect.py:118-130) for the
    widths left None in `cfg`."""
    arch_default(cfg, "encoder_type", "transformer")
    for key, value in (("encoder_embed_dim", 512), ("encoder_ffn_embed_dim", 2048),
                       ("encoder_layers", 12), ("encoder_attention_heads", 8)):
        arch_default(cfg, key, value)
    _spect_decoder_defaults(cfg)


def s2spect_transformer_fisher_arch(cfg: dict) -> None:
    """s2spect_architecture_fisher (JAX s2spect.py:133-141)."""
    for key, value in (("encoder_embed_dim", 256), ("encoder_ffn_embed_dim", 256 * 8),
                       ("encoder_attention_heads", 4), ("prenet_dim", 32)):
        arch_default(cfg, key, value)
    s2spect_transformer_arch(cfg)


def s2spect_conformer_arch(cfg: dict) -> None:
    """The conformer-encoder variant (JAX s2spect.py:144-152): encoder 256 x
    16, 4 heads."""
    cfg["encoder_type"] = "conformer"
    for key, value in (("encoder_embed_dim", 256), ("encoder_ffn_embed_dim", 2048),
                       ("encoder_layers", 16), ("encoder_attention_heads", 4)):
        arch_default(cfg, key, value)
    s2spect_transformer_arch(cfg)


ARCHS = {"s2spect_transformer": s2spect_transformer_arch,
         "s2spect_transformer_fisher": s2spect_transformer_fisher_arch,
         "s2spect_conformer": s2spect_conformer_arch}
