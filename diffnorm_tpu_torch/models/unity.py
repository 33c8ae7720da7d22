"""UnitY, two-pass direct S2ST (fairseq's unity_conformer): the port of
diffnorm_tpu/models/unity.py.

A conformer speech encoder, a first-pass text decoder, an optional
text-to-unit encoder, and a second-pass unit decoder:

* the first-pass decoder (`mt_<task>_decoder`) is the causal
  `ARUnitDecoder` of the --multitask-config-yaml task flagged
  is_first_pass_decoder (or named target*): --translation-decoder-layers
  layers at the main decoder's width and heads, its task's dropout, the
  shared embedding;
* the second pass reads the first pass's features after its final norm,
  refined by `synthesizer_encoder` (`TextEncoderNoEmb`: pre-norm layers
  with a ReLU FF, `models/cmlm_text.py`'s `TextEncoderLayer`, and a final
  LayerNorm) when --synthesizer-encoder-layers > 0;
* the unit decoder (`decoder`) cross-attends those features under the
  first-pass token mask;
* the other multitask tasks are the NAR model's aux heads over encoder or
  decoder taps, run in the training and validation forward only.

Each pass decodes one step at a time on its own `KVCache`
(`init_mt_cache` / `decode_mt_step`, `init_cache` / `decode_step`);
`generate/unity.py` runs the two beam passes and the handoff between them.
The forward (`forward`) is the teacher-forced two-pass forward, whose
first-pass logits come back as that task's entry in out["multitask"]. Names
follow the flax tree (`weights.from_jax_variables`).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from diffnorm_tpu_torch.models.ar_transformer import ARUnitDecoder, KVCache
from diffnorm_tpu_torch.models.cmlm_text import TextEncoderLayer
from diffnorm_tpu_torch.models.conformer import ConformerEncoder, layer_norm
from diffnorm_tpu_torch.models.layers import Dense, arch_default
from diffnorm_tpu_torch.models.nar_transformer import (
    AuxTaskSpec,
    NARS2UTModule,
    aux_head_outputs,
    build_aux_heads,
)

PAD, BOS, EOS, UNK = 1, 0, 2, 3


class TextEncoderNoEmb(nn.Module):
    """Transformer encoder over features already embedded (fairseq's
    TransformerEncoderNoEmb): `layers` TextEncoderLayers, then LayerNorm."""

    def __init__(self, dim: int, ffn_dim: int, layers: int, heads: int, dropout: float = 0.0):
        super().__init__()
        self.n_layers = layers
        for i in range(layers):
            self.add_module(f"layer_{i}", TextEncoderLayer(dim, ffn_dim, heads, dropout))
        self.layer_norm = layer_norm(dim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"layer_{i}")(x, mask)
        return self.layer_norm(x)


class FirstPassMixin:
    """The first pass and the handoff shared by UnitY and Translatotron2:
    the `mt_<task>_decoder` cached step, the teacher-forced features after
    its final norm, and the optional synthesizer encoder."""

    mt_task_name: str

    @property
    def mt_decoder(self) -> ARUnitDecoder:
        return getattr(self, f"mt_{self.mt_task_name}_decoder")

    def init_mt_cache(self, enc: torch.Tensor, enc_mask: torch.Tensor,
                      max_len: int) -> KVCache:
        return self.mt_decoder.init_cache(enc, enc_mask, max_len)

    def decode_mt_step(self, tokens: torch.Tensor, cache: KVCache, position: torch.Tensor):
        """A first-pass step: tokens [N, 1] -> (text logits [N, Vmt], cache)."""
        return self.mt_decoder.decode_step(tokens, cache, position)

    def mt_features(self, prev_tokens_mt: torch.Tensor, enc: torch.Tensor,
                    enc_mask: torch.Tensor) -> torch.Tensor:
        """Teacher-forced first-pass features [B, L, D] after the final norm."""
        return self.mt_decoder(prev_tokens_mt, enc, enc_mask, return_features=True)[1]

    def synthesize(self, feats: torch.Tensor, mask: torch.Tensor):
        """(the synthesizer encoder over `feats`, or `feats` as they are; mask)."""
        if hasattr(self, "synthesizer_encoder"):
            return self.synthesizer_encoder(feats, mask), mask
        return feats, mask


class UnityS2UTModule(FirstPassMixin, nn.Module):
    """UnitY (module docstring). Dimensions follow the unity_conformer arch
    defaults; `multitask` holds the aux tasks other than the first pass's,
    whose spec is `mt_spec`."""

    def __init__(self, vocab_size: int = 1004, mt_spec: Optional[AuxTaskSpec] = None,
                 in_channels: int = 80, encoder_dim: int = 256, encoder_ffn_dim: int = 2048,
                 encoder_layers: int = 16, encoder_heads: int = 4, decoder_dim: int = 256,
                 decoder_ffn_dim: int = 2048, decoder_layers: int = 6, decoder_heads: int = 8,
                 translation_decoder_layers: int = 4, synthesizer_encoder_layers: int = 0,
                 dropout: float = 0.1, attention_dropout: Optional[float] = None,
                 activation_dropout: Optional[float] = None, depthwise_kernel_size: int = 31,
                 n_frames_per_step: int = 1, multitask: Sequence[AuxTaskSpec] = (),
                 target_speaker_embed: bool = False, speaker_embed_dim: int = 256):
        super().__init__()
        if mt_spec is None:
            raise ValueError("unity_conformer needs a first-pass decoder task: a "
                             "--multitask-config-yaml transformer task named 'target*' or "
                             "flagged is_first_pass_decoder")
        self.vocab_size, self.n_frames_per_step = vocab_size, n_frames_per_step
        self.mt_task_name, self.mt_vocab_size = mt_spec.name, mt_spec.vocab_size
        self.multitask = tuple(multitask)
        if target_speaker_embed:
            self.spk_emb_proj = Dense(encoder_dim + speaker_embed_dim, encoder_dim)
        self.encoder = ConformerEncoder(
            in_channels=in_channels, dim=encoder_dim, ffn_dim=encoder_ffn_dim,
            layers=encoder_layers, heads=encoder_heads,
            depthwise_kernel_size=depthwise_kernel_size, dropout=dropout,
            attention_dropout=attention_dropout, activation_dropout=activation_dropout)
        self.add_module(f"mt_{self.mt_task_name}_decoder", ARUnitDecoder(
            mt_spec.vocab_size, decoder_dim, decoder_ffn_dim, translation_decoder_layers,
            decoder_heads, dropout=mt_spec.dropout, context_dim=encoder_dim))
        if synthesizer_encoder_layers > 0:
            self.synthesizer_encoder = TextEncoderNoEmb(
                decoder_dim, decoder_ffn_dim, synthesizer_encoder_layers, decoder_heads,
                dropout)
        self.decoder = ARUnitDecoder(
            vocab_size, decoder_dim, decoder_ffn_dim, decoder_layers, decoder_heads,
            dropout=dropout, attention_dropout=attention_dropout,
            activation_dropout=activation_dropout, n_frames_per_step=n_frames_per_step)
        build_aux_heads(self, self.multitask, encoder_dim, decoder_dim)

    apply_speaker = NARS2UTModule.apply_speaker

    def encode(self, src: torch.Tensor, src_lengths: torch.Tensor,
               tgt_speaker: Optional[torch.Tensor] = None):
        enc, enc_mask = self.encoder(src, src_lengths)
        return self.apply_speaker(enc, tgt_speaker), enc_mask

    def init_cache(self, t2u: torch.Tensor, t2u_mask: torch.Tensor, max_len: int) -> KVCache:
        return self.decoder.init_cache(t2u, t2u_mask, max_len)

    def decode_step(self, tokens: torch.Tensor, cache: KVCache, position: torch.Tensor):
        """A unit step over the t2u context: tokens [N, 1] -> (logits [N, V]
        ([N, k, V] stacked), cache)."""
        return self.decoder.decode_step(tokens, cache, position)

    def forward(self, src: torch.Tensor, src_lengths: torch.Tensor, prev_tokens: torch.Tensor,
                prev_tokens_mt: torch.Tensor, tgt_tokens: Optional[torch.Tensor] = None,
                multitask_prev: Optional[Dict[str, torch.Tensor]] = None,
                tgt_speaker: Optional[torch.Tensor] = None) -> Dict:
        """The teacher-forced two-pass forward: prev_tokens [B, L] units,
        prev_tokens_mt [B, Lmt] first-pass text. `tgt_tokens` turns the aux
        heads on (JAX's convention). Returns {"logits" [B, L, V], "multitask":
        {first-pass task: {"logits" [B, Lmt, Vmt]}, and the aux heads}}."""
        run_mt = bool(self.multitask) and tgt_tokens is not None
        if run_mt:
            enc, enc_mask, enc_states = self.encoder(src, src_lengths, return_all_layers=True)
        else:
            enc, enc_mask = self.encoder(src, src_lengths)
        enc = self.apply_speaker(enc, tgt_speaker)
        mt_logits, mt_feats = self.mt_decoder(prev_tokens_mt, enc, enc_mask,
                                              return_features=True)
        t2u, t2u_mask = self.synthesize(mt_feats, prev_tokens_mt != PAD)
        need_inner = run_mt and any(s.input_from == "decoder" for s in self.multitask)
        logits = self.decoder(prev_tokens, t2u, t2u_mask, return_inner=need_inner)
        inner = None
        if need_inner:
            logits, inner = logits
        out = {"logits": logits, "multitask": {self.mt_task_name: {"logits": mt_logits}}}
        if run_mt:
            out["multitask"].update(aux_head_outputs(self, self.multitask, multitask_prev,
                                                     enc_states, enc_mask, inner, prev_tokens))
        return out


def unity_conformer_arch(cfg: dict) -> None:
    """unity_conformer's defaults for every width left None in `cfg` (JAX
    unity.py:331-345): encoder 256 x 16, 4 heads, FFN 2048, depthwise kernel
    31; the decoder's widths default to the encoder's, 6 layers, 8 heads;
    the first pass 4 layers, no synthesizer encoder."""
    for key, value in (("encoder_embed_dim", 256), ("encoder_ffn_embed_dim", 2048),
                       ("encoder_layers", 16), ("encoder_attention_heads", 4),
                       ("depthwise_conv_kernel_size", 31)):
        arch_default(cfg, key, value)
    for key, value in (("decoder_embed_dim", cfg["encoder_embed_dim"]),
                       ("decoder_ffn_embed_dim", cfg["encoder_ffn_embed_dim"]),
                       ("decoder_layers", 6), ("decoder_attention_heads", 8),
                       ("translation_decoder_layers", 4), ("synthesizer_encoder_layers", 0),
                       ("dropout", 0.1), ("encoder_type", "conformer")):
        arch_default(cfg, key, value)


ARCHS = {"unity_conformer": unity_conformer_arch,
         # fairseq registers the same model under a legacy name
         "s2ut_conformer_translatotron2": unity_conformer_arch}
