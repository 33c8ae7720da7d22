"""Translatotron2-style two-pass speech-to-spectrogram S2ST (fairseq's
s2spect2_conformer): the port of diffnorm_tpu/models/s2spect2.py.

`S2SpecTModule`'s conformer encoder and spectrogram decoder, with UnitY's
first pass between them (`models/unity.py`'s `FirstPassMixin`): the
first-pass text decoder `mt_<task>_decoder` (--translation-decoder-layers
layers at the decoder's width and heads, cross-attending the encoder), the
optional `synthesizer_encoder`, and the spectrogram decoder cross-attending
the first pass's features (its context width the decoder's). The other
multitask tasks are aux heads, run in the training and validation forward
only; a decoder-tapped CTC head's mask comes from synthetic ids, EOS where
the target frame is valid and PAD elsewhere, as JAX's. `generate/
translatotron2.py` runs the first-pass beam, the handoff and the mel
rollout.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from diffnorm_tpu_torch.models.ar_transformer import ARUnitDecoder
from diffnorm_tpu_torch.models.layers import arch_default
from diffnorm_tpu_torch.models.nar_transformer import (
    AuxTaskSpec,
    aux_head_outputs,
    build_aux_heads,
)
from diffnorm_tpu_torch.models.s2spect import S2SpecTModule
from diffnorm_tpu_torch.models.unity import FirstPassMixin, TextEncoderNoEmb

PAD, BOS, EOS, UNK = 1, 0, 2, 3


class S2SpecT2Module(FirstPassMixin, S2SpecTModule):
    """Conformer encoder, first pass, synthesizer encoder, spectrogram
    decoder (module docstring); widths default to s2spect2_conformer's.
    `multitask` holds the aux tasks other than the first pass's (`mt_spec`)."""

    def __init__(self, mt_spec: Optional[AuxTaskSpec] = None,
                 translation_decoder_layers: int = 4, synthesizer_encoder_layers: int = 0,
                 multitask: Sequence[AuxTaskSpec] = (), enc_dim: int = 256,
                 enc_layers: int = 16, enc_heads: int = 4, dim: int = 512,
                 ffn_dim: int = 2048, heads: int = 4, dropout: float = 0.1, **kw):
        if mt_spec is None:
            raise ValueError("s2spect2_conformer needs a first-pass decoder task: a "
                             "--multitask-config-yaml transformer task flagged "
                             "is_first_pass_decoder")
        super().__init__(enc_dim=enc_dim, enc_layers=enc_layers, enc_heads=enc_heads,
                         encoder_type="conformer", dim=dim, ffn_dim=ffn_dim, heads=heads,
                         dropout=dropout, context_dim=dim, **kw)
        self.mt_task_name, self.mt_vocab_size = mt_spec.name, mt_spec.vocab_size
        self.multitask = tuple(multitask)
        self.add_module(f"mt_{self.mt_task_name}_decoder", ARUnitDecoder(
            mt_spec.vocab_size, dim, ffn_dim, translation_decoder_layers, heads,
            dropout=mt_spec.dropout, context_dim=enc_dim))
        if synthesizer_encoder_layers > 0:
            self.synthesizer_encoder = TextEncoderNoEmb(dim, ffn_dim, synthesizer_encoder_layers,
                                                        heads, dropout)
        build_aux_heads(self, self.multitask, enc_dim, dim)

    def forward(self, src: torch.Tensor, src_lengths: torch.Tensor, prev_feats: torch.Tensor,
                tgt_mask: torch.Tensor, prev_tokens_mt: Optional[torch.Tensor] = None,
                tgt_tokens: Optional[torch.Tensor] = None,
                multitask_prev: Optional[Dict[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None) -> Dict:
        """The teacher-forced two-pass forward: {"post_feat", "feat",
        "eos_logits", "multitask": {first-pass task: {"logits"}, and the aux
        heads where `tgt_tokens` is given}}."""
        run_aux = bool(self.multitask) and tgt_tokens is not None
        if run_aux:
            enc, enc_mask, enc_states = self.encoder(src, src_lengths, return_all_layers=True)
        else:
            enc, enc_mask = self.encoder(src, src_lengths)
        mt_logits, mt_feats = self.mt_decoder(prev_tokens_mt, enc, enc_mask,
                                              return_features=True)
        ctx, ctx_mask = self.synthesize(mt_feats, prev_tokens_mt != PAD)
        need_inner = run_aux and any(s.input_from == "decoder" for s in self.multitask)
        dec = self.decode_full(prev_feats, tgt_mask, ctx, ctx_mask, return_inner=need_inner,
                               generator=generator)
        out = {"post_feat": dec[0], "feat": dec[1], "eos_logits": dec[2],
               "multitask": {self.mt_task_name: {"logits": mt_logits}}}
        if run_aux:
            dec_tokens = torch.where(tgt_mask, EOS, PAD)
            out["multitask"].update(aux_head_outputs(
                self, self.multitask, multitask_prev, enc_states, enc_mask,
                dec[3] if need_inner else None, dec_tokens))
        return out


def s2spect2_conformer_arch(cfg: dict) -> None:
    """s2spect2_conformer's defaults (JAX s2spect2.py:233-250): encoder 256 x
    16, 4 heads, FFN 2048; decoder 512 x 6, 4 heads, FFN 4 x its width; 80
    mel bins; the first pass 4 layers, no synthesizer encoder."""
    cfg["encoder_type"] = "conformer"
    for key, value in (("encoder_embed_dim", 256), ("encoder_ffn_embed_dim", 2048),
                       ("encoder_layers", 16), ("encoder_attention_heads", 4),
                       ("depthwise_conv_kernel_size", 31), ("dropout", 0.1),
                       ("decoder_embed_dim", 512)):
        arch_default(cfg, key, value)
    for key, value in (("decoder_ffn_embed_dim", 4 * cfg["decoder_embed_dim"]),
                       ("decoder_transformer_layers", 6), ("decoder_attention_heads", 4),
                       ("output_frame_dim", 80), ("translation_decoder_layers", 4),
                       ("synthesizer_encoder_layers", 0)):
        arch_default(cfg, key, value)


ARCHS = {"s2spect2_conformer": s2spect2_conformer_arch,
         # fairseq registers the same model under a legacy name
         "s2spect_conformer_translatotron2": s2spect2_conformer_arch}
