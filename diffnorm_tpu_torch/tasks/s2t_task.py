"""Speech-to-text training ("speech_to_text", the port of
diffnorm_tpu/tasks/s2t_task.py:28-110; reference
fairseq/tasks/speech_to_text.py): ASR or speech translation with the S2T
model (`models/s2t_transformer.py`: s2t_transformer, _s, _xs,
s2t_conformer) and label_smoothed_cross_entropy.

The target dictionary is the data config's `vocab_filename` (default
dict.txt under the manifest root) where it exists, else the unit
dictionary of --target-code-size symbols; the manifests are
`data/s2t_dataset.py`'s. Each batch is teacher-forced on its target shifted
right behind an EOS (`prev_output_tokens`). cli.generate decodes it with
the AR branch (`ar_generation`): beam search, sampling or
--score-reference. `DummyS2TTask` ("dummy_s2t") trains on `dataset_size`
copies of `dummy_batch`, in process or through cli.train without DATA.

"audio_finetuning" (`AudioFinetuningTask`, JAX s2t_task.py:111-220;
reference fairseq/tasks/audio_finetuning.py) is the CTC fine-tune on the
same manifests with the data config's `use_audio_input` (raw waveforms
[T, 1]) and letter or character targets: `models/hubert.py:HubertCTCModule`
(hubert_ctc, wav2vec_ctc), criterion "ctc". With --apply-mask its
`prepare_batch` draws the time mask over the valid frames and, with
--mask-channel-prob, the channel mask over the embedding's channels, on the
host from the generator it is given, as JAX's; the model applies them in
training. --w2v-path warm-starts the encoder (and mask_emb) from a
pretraining checkpoint (`utils.convert_weights.load_pretrained_encoder`: a
fairseq .pt or a cli.train step directory of hubert_pretraining or
audio_pretraining) when the model is built; cli.train drops it when it
resumes its own checkpoint. cli.generate decodes it greedily
(`ctc_generation`). `DummyCTCTask` ("dummy_ctc") serves copies of JAX's
unprepared `dummy_batch`, in process or through cli.train.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from diffnorm_tpu_torch.criterions.ce_loss import CRITERIONS
from diffnorm_tpu_torch.criterions.ctc_loss import CtcLoss
from diffnorm_tpu_torch.data.dictionary import Dictionary
from diffnorm_tpu_torch.data.s2s_dataset import load_s2t_data_cfg
from diffnorm_tpu_torch.data.s2t_dataset import SpeechToTextDataset
from diffnorm_tpu_torch.models.hubert import HubertCTCModule, build_hubert_ctc
from diffnorm_tpu_torch.models.s2t_transformer import S2TModule
from diffnorm_tpu_torch.tasks.ar_s2ut_task import shift_right
from diffnorm_tpu_torch.tasks.base import Task
from diffnorm_tpu_torch.tasks.cmlm_cg_task import dummy_dataset
from diffnorm_tpu_torch.tasks.hubert_pretrain_task import frame_padding, model_config, span_mask
from diffnorm_tpu_torch.utils.masking import compute_mask_indices

EOS = 2


class S2TTask(Task):
    ar_generation = True  # cli.generate's AR branch

    def __init__(self, args):
        super().__init__(args)
        self.tgt_dict = self._load_dict()

    def _load_dict(self) -> Dictionary:
        if self.args.data:
            root = self.data_path(1)
            vocab = load_s2t_data_cfg(root, self.args.config_yaml).get("vocab_filename",
                                                                       "dict.txt")
            path = vocab if os.path.isabs(vocab) else os.path.join(root, vocab)
            if os.path.exists(path):
                return Dictionary.load(path)
        return Dictionary.unit_dictionary(self.args.target_code_size)

    def load_dataset(self, split: str, epoch: int = 1) -> None:
        self.datasets[split] = SpeechToTextDataset.from_tsv(
            self.data_path(epoch), split, self.tgt_dict, config_yaml=self.args.config_yaml,
            is_train=split.startswith("train"))

    def prepare_batch(self, batch: Dict, rng: np.random.Generator) -> Dict:
        """prev_output_tokens where the batch has none; draws nothing."""
        if "prev_output_tokens" not in batch:
            batch["prev_output_tokens"] = shift_right(batch["target"])
        return batch

    def build_model(self) -> S2TModule:
        a = self.args
        return S2TModule(
            vocab_size=len(self.tgt_dict), encoder_type=a.encoder_type,
            in_channels=a.input_feat_per_channel, encoder_dim=a.encoder_embed_dim,
            encoder_ffn_dim=a.encoder_ffn_embed_dim, encoder_layers=a.encoder_layers,
            encoder_heads=a.encoder_attention_heads, decoder_dim=a.decoder_embed_dim,
            decoder_ffn_dim=a.decoder_ffn_embed_dim, decoder_layers=a.decoder_layers,
            decoder_heads=a.decoder_attention_heads, dropout=a.dropout,
            attention_dropout=a.attention_dropout, activation_dropout=a.relu_dropout,
            conv_channels=a.conv_channels, conv_kernel_sizes=a.conv_kernel_sizes,
            depthwise_kernel_size=a.depthwise_conv_kernel_size,
            share_decoder_input_output_embed=bool(a.share_decoder_input_output_embed))

    def build_criterion(self):
        return CRITERIONS[self.args.criterion](self.args.label_smoothing)

    def dummy_batch(self, batch_size: int = 2, seq_len: int = 48) -> Dict:
        """A synthetic batch from a generator seeded 0 (JAX s2t_task.py:
        79-97): normal sources [B, seq_len, F], max(seq_len // 8, 4) target
        tokens a row ending in EOS, prepared."""
        rng = np.random.default_rng(0)
        tgt_len = max(seq_len // 8, 4)
        src = rng.normal(size=(batch_size, seq_len, self.args.input_feat_per_channel)
                         ).astype(np.float32)
        tgt = rng.integers(4, len(self.tgt_dict), size=(batch_size, tgt_len)).astype(np.int32)
        tgt[:, -1] = EOS
        batch = {"src_tokens": src, "src_lengths": np.full((batch_size,), seq_len, np.int32),
                 "target": tgt, "target_lengths": np.full((batch_size,), tgt_len, np.int32),
                 "ntokens": int(batch_size * tgt_len), "nsentences": batch_size}
        return self.prepare_batch(batch, rng)


class DummyS2TTask(S2TTask):
    """`dataset_size` identical batches of `dummy_batch(batch_size,
    tokens_per_sample)` (defaults 8, 4 and 48, JAX's), as a list."""

    synthetic = True

    def load_dataset(self, split: str, epoch: int = 1) -> None:
        a = self.args
        batch = self.dummy_batch(getattr(a, "batch_size", None) or 4,
                                 getattr(a, "tokens_per_sample", None) or 48)
        self.datasets[split] = [batch] * (getattr(a, "dataset_size", None) or 8)


class AudioFinetuningTask(S2TTask):
    ar_generation = False
    ctc_generation = True  # cli.generate's greedy CTC branch

    def build_model(self) -> HubertCTCModule:
        cfg = model_config(self.args)
        model = build_hubert_ctc(cfg, len(self.tgt_dict))
        w2v = self.args.w2v_path
        if w2v:
            from diffnorm_tpu_torch.utils.convert_weights import (
                graft_encoder_params,
                load_pretrained_encoder,
            )
            from diffnorm_tpu_torch.weights import from_jax_variables, to_jax_variables

            enc, mask_emb = load_pretrained_encoder(str(w2v), layers=self.args.encoder_layers)
            from_jax_variables(model, graft_encoder_params(to_jax_variables(model), enc,
                                                           mask_emb=mask_emb))
        return model

    def build_criterion(self) -> CtcLoss:
        return CtcLoss()

    def prepare_batch(self, batch: Dict, rng: np.random.Generator) -> Dict:
        """The fine-tune's masks with --apply-mask (JAX :127-171): the time
        mask over the valid frames where --mask-prob > 0, the channel mask
        where --mask-channel-prob > 0."""
        a = self.args
        if not a.apply_mask:
            return batch
        padding = frame_padding(a, batch)
        if a.mask_prob > 0:
            batch["mask_indices"] = span_mask(a, padding.shape, padding, rng)
        if a.mask_channel_prob > 0:
            batch["channel_mask"] = compute_mask_indices(
                (len(padding), a.encoder_embed_dim), None, mask_prob=a.mask_channel_prob,
                mask_length=a.mask_channel_length, mask_type=a.mask_channel_selection,
                mask_other=a.mask_channel_other, no_overlap=a.no_mask_channel_overlap,
                min_space=a.mask_channel_min_space, rng=rng)
        return batch

    def dummy_batch(self, batch_size: int = 2, seq_len: int = 2000) -> Dict:
        """JAX's (:195-208), unprepared: normal waveforms [B, T, 1] and 4
        target tokens a row from a generator seeded 0."""
        rng = np.random.default_rng(0)
        src = rng.normal(size=(batch_size, seq_len, 1)).astype(np.float32)
        tgt = rng.integers(4, len(self.tgt_dict), size=(batch_size, 4)).astype(np.int32)
        return {"src_tokens": src, "src_lengths": np.full((batch_size,), seq_len, np.int32),
                "target": tgt, "target_lengths": np.full((batch_size,), 4, np.int32),
                "ntokens": int(batch_size * 4), "nsentences": batch_size}


class DummyCTCTask(AudioFinetuningTask):
    synthetic = True

    def load_dataset(self, split: str, epoch: int = 1) -> None:
        self.datasets[split] = dummy_dataset(self, 2000, default_batch=2, default_size=4)
