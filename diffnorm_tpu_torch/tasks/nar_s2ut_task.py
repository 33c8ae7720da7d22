"""NAR S2UT training ("speech_to_speech_fasttranslate", the port's copy of
diffnorm_tpu/tasks/nar_s2ut_task.py; reference nat_s2s_task.py): the CMLM
canvas of each batch, the unit dictionary, the speech-to-unit dataset, the
conformer NAR model and its criterion.

The masks draw from the numpy generator they are given, exactly as JAX's:
the training CLI hands every batch one `np.random.default_rng(seed)`, each
training micro-batch in order, then each validation batch.

With --n-frames-per-step k > 1 the canvas is the packed-id sequence
(`models.stacked.stack_target`) and the target the per-sub-frame view
[B, T, k]. --multitask-config-yaml adds the aux tasks (`MultitaskTaskMixin`):
their heads in the model, their text targets in the dataset, their loss
weights in each batch. --multitask-ctc-vocab adds the model's `ctc_proj`
head, scored against a batch's `ctc_target` where one is given;
--target-speaker-embed the speaker projection, fed the dataset's
`tgt_speaker` (the data config's `target_speaker_embed` directory).
`dummy_batch` is JAX's synthetic batch, prepared (nar_s2ut_task.py:139-160).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from diffnorm_tpu_torch.criterions.nar_loss import NARSpeechToUnitLoss
from diffnorm_tpu_torch.data.dictionary import Dictionary
from diffnorm_tpu_torch.data.s2s_dataset import SpeechToUnitDataset
from diffnorm_tpu_torch.models.nar_transformer import NARS2UTModule
from diffnorm_tpu_torch.models.stacked import stack_target
from diffnorm_tpu_torch.tasks.base import Task
from diffnorm_tpu_torch.tasks.multitask_mixin import MultitaskTaskMixin

PAD, BOS, EOS, UNK = 1, 0, 2, 3


def _maskable(target: np.ndarray) -> np.ndarray:
    return (target != PAD) & (target != BOS) & (target != EOS)


def random_mask(target: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Uniform-count masking (nat_s2s_task.py:79-99): per sequence a budget
    of int(U(0, 1) * len + 1) masked tokens, taken at the lowest random
    scores; the masked ones become <unk>."""
    masks = _maskable(target)
    score = rng.random(target.shape)
    score[~masks] = 2.0
    lengths = masks.sum(axis=1).astype(np.float64)
    budget = (lengths * rng.random(lengths.shape) + 1).astype(np.int64)
    rank = np.argsort(score, axis=1)
    cutoff = np.zeros_like(masks)
    rows = np.arange(target.shape[0])[:, None]
    cutoff[rows, rank] = np.arange(target.shape[1])[None, :] < budget[:, None]
    out = target.copy()
    out[cutoff] = UNK
    return out


def side_mask(target: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Gaussian "bowl" masking (nat_s2s_task.py:36-77): each position is
    masked with a randomly shifted and scaled Gaussian probability peaked
    mid-sequence. As the reference: the shift's bound is the integer
    division len // 6, and the peak is normalized by the batch-global
    maximum, not per row."""
    masks = _maskable(target)
    int_lengths = masks.sum(axis=1)
    lengths = int_lengths.astype(np.float64)
    bz, max_len = target.shape
    shift = rng.random(bz) * (int_lengths // 6).astype(np.float64)
    scale = rng.random(bz) * 6 + 2
    mean = lengths / 2 - shift
    std = np.maximum(lengths / scale, 1e-6)
    idx = np.arange(max_len)[None, :]
    probs = np.exp(-0.5 * ((idx - mean[:, None]) / std[:, None]) ** 2)
    probs = probs / np.maximum(probs.max(), 1e-9)
    probs = np.clip(probs * (rng.random((bz, 1)) + 0.5), 0, 1)
    drawn = (rng.random(target.shape) < probs) & masks
    out = target.copy()
    out[drawn] = UNK
    return out


class NARS2UTTask(MultitaskTaskMixin, Task):
    def __init__(self, args):
        super().__init__(args)
        self.tgt_dict = Dictionary.unit_dictionary(args.target_code_size)
        self._init_multitask(args)

    def load_dataset(self, split: str, epoch: int = 1) -> None:
        # the dataset's seed stays 1 (its tie shuffle and SpecAugment
        # stream), as JAX's task passes none
        ds = SpeechToUnitDataset.from_tsv(
            self.data_path(epoch), split, tgt_dict=self.tgt_dict, config_yaml=self.args.config_yaml,
            is_train=split.startswith("train"))
        self.attach_multitask(ds, split)
        self.datasets[split] = ds

    def prepare_batch(self, batch: Dict[str, np.ndarray], rng: np.random.Generator) -> Dict:
        """The CMLM canvas `prev_target`: with use_side, the side mask when
        a draw is > 0.5, else the random mask. Stacked (k > 1): `target`
        becomes the sub-frame view [B, T, k], `target_packed` the packed
        ids the canvas masks. Then the aux tasks' loss weights."""
        k = self.args.n_frames_per_step
        target = batch["target"]
        if k > 1 and target.ndim == 2:
            target, batch["target"] = stack_target(target, self.args.target_code_size, k)
            batch["target_packed"] = target
        elif target.ndim == 3:
            target = batch["target_packed"]
        if self.args.use_side and rng.random() > 0.5:
            batch["prev_target"] = side_mask(target, rng)
        else:
            batch["prev_target"] = random_mask(target, rng)
        self.inject_loss_weights(batch)
        return batch

    def dummy_batch(self, batch_size: int = 2, seq_len: int = 48) -> Dict:
        """Normal fbank sources [B, seq_len, 80] (the last row's length
        max(seq_len // 2, 9)) and max(seq_len // 4, 4) target units a row
        ending in EOS (the last row's EOS at half length, pad after it), from
        a generator seeded 0 that `prepare_batch` then draws from (JAX
        nar_s2ut_task.py:139-160)."""
        rng = np.random.default_rng(0)
        tgt_len = max(seq_len // 4, 4)
        src_lengths = np.full((batch_size,), seq_len, dtype=np.int32)
        src_lengths[-1] = max(seq_len // 2, 9)
        target = rng.integers(4, 4 + self.args.target_code_size,
                              size=(batch_size, tgt_len)).astype(np.int32)
        target[:, -1] = EOS
        # the short row keeps an EOS before its pad tail
        target[-1, tgt_len // 2:] = PAD
        target[-1, tgt_len // 2] = EOS
        feat = self.args.input_feat_per_channel
        batch = {"src_tokens": rng.normal(size=(batch_size, seq_len, feat)).astype(np.float32),
                 "src_lengths": src_lengths, "target": target}
        return self.prepare_batch(batch, rng)

    def build_model(self) -> NARS2UTModule:
        a = self.args
        return NARS2UTModule(
            vocab_size=len(self.tgt_dict), in_channels=a.input_feat_per_channel,
            encoder_dim=a.encoder_embed_dim, encoder_ffn_dim=a.encoder_ffn_embed_dim,
            encoder_layers=a.encoder_layers, encoder_heads=a.encoder_attention_heads,
            decoder_dim=a.decoder_embed_dim, decoder_ffn_dim=a.decoder_ffn_embed_dim,
            decoder_layers=a.decoder_layers, decoder_heads=a.decoder_attention_heads,
            depthwise_kernel_size=a.depthwise_conv_kernel_size, conv_channels=a.conv_channels,
            conv_kernel_sizes=a.conv_kernel_sizes, dropout=a.dropout,
            attention_dropout=a.attention_dropout, activation_dropout=a.relu_dropout,
            cg_prob=a.cg_prob, use_sp=a.use_sp, n_frames_per_step=a.n_frames_per_step,
            multitask=self.aux_task_specs(), ctc_vocab=a.multitask_ctc_vocab,
            target_speaker_embed=bool(a.target_speaker_embed),
            speaker_embed_dim=a.speaker_embed_dim,
            encoder_remat=a.encoder_remat, quant_int8=bool(getattr(a, "quant_int8", False)))

    def build_criterion(self) -> NARSpeechToUnitLoss:
        return NARSpeechToUnitLoss(self.args.label_smoothing, multitask=self.multitask_tasks)
