"""AR S2UT training ("speech_to_speech_ar", the port's copy of
diffnorm_tpu/tasks/ar_s2ut_task.py:61-124; reference
fairseq/tasks/ar_speech_to_speech.py): the NAR task's data (fbank sources,
unit targets, the multitask and speaker joins), teacher-forced: each
batch's prev_output_tokens is its target shifted right behind an EOS.
With --n-frames-per-step k > 1 the decoder reads the packed ids
(`models.stacked.stack_target`) and the loss the per-sub-frame view
[B, T, k]. The criterion is --criterion's: label_smoothed_cross_entropy,
or speech_to_unit with the aux tasks' terms. UnitY (--arch unity_conformer
or s2ut_conformer_translatotron2, `models/unity.py`) trains here too, its
first-pass decoder the multitask task `mt_task_name` picks, with
speech_to_unit_2pass. `dummy_batch` is the NAR task's batch, its
canvas dropped, prepared again (JAX ar_s2ut_task.py:120-123)."""

from __future__ import annotations

from typing import Dict

import numpy as np

from diffnorm_tpu_torch.criterions.ce_loss import CRITERIONS
from diffnorm_tpu_torch.models.ar_transformer import ARS2UTModule
from diffnorm_tpu_torch.models.stacked import stack_target
from diffnorm_tpu_torch.models.unity import ARCHS as UNITY_ARCHS
from diffnorm_tpu_torch.models.unity import UnityS2UTModule
from diffnorm_tpu_torch.tasks.nar_s2ut_task import NARS2UTTask

PAD, EOS = 1, 2


def shift_right(target: np.ndarray) -> np.ndarray:
    """prev_output_tokens [eos, t0, t1, ...] (fairseq's collate); positions
    that are pad in the target stay pad."""
    prev = np.full_like(target, PAD)
    prev[:, 0] = EOS
    prev[:, 1:] = target[:, :-1]
    prev[target == PAD] = PAD
    return prev


class ARS2UTTask(NARS2UTTask):
    def prepare_batch(self, batch: Dict[str, np.ndarray], rng: np.random.Generator) -> Dict:
        """prev_output_tokens from the target (stacked: `target` becomes the
        sub-frame view, `target_packed` the packed ids it shifts), then the
        aux tasks' loss weights. Draws nothing from `rng`."""
        k = self.args.n_frames_per_step
        target = batch["target"]
        if k > 1 and target.ndim == 2:
            packed, batch["target"] = stack_target(target, self.args.target_code_size, k)
            batch["target_packed"] = packed
            batch["prev_output_tokens"] = shift_right(packed)
        elif target.ndim == 2:
            batch["prev_output_tokens"] = shift_right(target)
        self.inject_loss_weights(batch)
        return batch

    def dummy_batch(self, batch_size: int = 2, seq_len: int = 48) -> Dict:
        batch = super().dummy_batch(batch_size, seq_len)
        batch.pop("prev_target", None)
        return self.prepare_batch(batch, np.random.default_rng(0))

    def build_model(self):
        a = self.args
        if a.arch in UNITY_ARCHS:
            mt_spec, others = self.first_pass_spec()
            return UnityS2UTModule(
                vocab_size=len(self.tgt_dict), mt_spec=mt_spec,
                in_channels=a.input_feat_per_channel, encoder_dim=a.encoder_embed_dim,
                encoder_ffn_dim=a.encoder_ffn_embed_dim, encoder_layers=a.encoder_layers,
                encoder_heads=a.encoder_attention_heads, decoder_dim=a.decoder_embed_dim,
                decoder_ffn_dim=a.decoder_ffn_embed_dim, decoder_layers=a.decoder_layers,
                decoder_heads=a.decoder_attention_heads,
                translation_decoder_layers=a.translation_decoder_layers,
                synthesizer_encoder_layers=a.synthesizer_encoder_layers, dropout=a.dropout,
                attention_dropout=a.attention_dropout, activation_dropout=a.relu_dropout,
                depthwise_kernel_size=a.depthwise_conv_kernel_size,
                n_frames_per_step=a.n_frames_per_step, multitask=others,
                target_speaker_embed=bool(a.target_speaker_embed),
                speaker_embed_dim=a.speaker_embed_dim)
        return ARS2UTModule(
            vocab_size=len(self.tgt_dict), in_channels=a.input_feat_per_channel,
            encoder_dim=a.encoder_embed_dim, encoder_ffn_dim=a.encoder_ffn_embed_dim,
            encoder_layers=a.encoder_layers, encoder_heads=a.encoder_attention_heads,
            decoder_dim=a.decoder_embed_dim, decoder_ffn_dim=a.decoder_ffn_embed_dim,
            decoder_layers=a.decoder_layers, decoder_heads=a.decoder_attention_heads,
            dropout=a.dropout, attention_dropout=a.attention_dropout,
            activation_dropout=a.relu_dropout,
            depthwise_kernel_size=a.depthwise_conv_kernel_size, encoder_type=a.encoder_type,
            conv_channels=a.conv_channels, conv_kernel_sizes=a.conv_kernel_sizes,
            n_frames_per_step=a.n_frames_per_step, multitask=self.aux_task_specs(),
            target_speaker_embed=bool(a.target_speaker_embed),
            speaker_embed_dim=a.speaker_embed_dim)

    def build_criterion(self):
        name = self.args.criterion
        if name == "speech_to_unit":
            return CRITERIONS[name](self.args.label_smoothing, multitask=self.multitask_tasks)
        if name == "speech_to_unit_2pass":
            return CRITERIONS[name](self.args.label_smoothing, multitask=self.multitask_tasks,
                                    mt_task_name=self.mt_task_name)
        return CRITERIONS[name](self.args.label_smoothing)
