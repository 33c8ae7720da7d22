"""wav2vec 2.0 pretraining, "audio_pretraining" (the port of
diffnorm_tpu/tasks/audio_pretrain_task.py; reference
fairseq/tasks/audio_pretraining.py with the model-side draws of
wav2vec2.py apply_mask :414-485 and sample_negatives :684-744 on the host):
the manifest `{split}.tsv` without labels (`data/hubert_dataset.py`),
models `models/wav2vec2.py` (wav2vec2, wav2vec2_base, wav2vec2_large),
criterion "wav2vec".

`prepare_batch`, from the generator it is given, as JAX's:
* the span mask over the valid frames (require_same_masks: every row masks
  the same count M; --mask-dropout);
* the static budget `mask_budget(F)` of slots: `masked_pos` [B, M_pad] and
  `masked_valid`; a draw over the budget (which the bound should rule out)
  is subsampled to it;
* --num-negatives N negatives a slot from the other M - 1 masked slots of
  its row: integers in [0, M - 1), shifted by one at or above the slot;
* the Gumbel temperature max(max_t * decay ** updates, min_t) of
  --latent-temp (max_t, min_t, decay), the update count set by
  `set_num_updates` (cli.train calls it).
`DummyWav2Vec2Task` ("dummy_wav2vec2") serves copies of `dummy_batch`, in
process.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from diffnorm_tpu_torch.criterions.wav2vec_loss import Wav2VecLoss
from diffnorm_tpu_torch.models.wav2vec2 import Wav2Vec2PretrainModule, build_wav2vec2
from diffnorm_tpu_torch.tasks.base import Task
from diffnorm_tpu_torch.tasks.cmlm_cg_task import dummy_dataset
from diffnorm_tpu_torch.tasks.hubert_pretrain_task import (
    frame_padding,
    model_config,
    pretrain_dataset,
    span_mask,
)


class AudioPretrainingTask(Task):
    def __init__(self, args):
        super().__init__(args)
        self.max_temp, self.min_temp, self.temp_decay = (
            float(t) for t in args.latent_temp or (2.0, 0.5, 0.999995))
        self._num_updates = 0

    def set_num_updates(self, num_updates: int) -> None:
        self._num_updates = int(num_updates)

    @property
    def gumbel_temp(self) -> float:
        return max(self.max_temp * self.temp_decay ** self._num_updates, self.min_temp)

    def load_dataset(self, split: str, epoch: int = 1) -> None:
        self.datasets[split] = pretrain_dataset(
            self.args, os.path.join(self.data_path(epoch), f"{split}.tsv"), split)

    def build_model(self) -> Wav2Vec2PretrainModule:
        return build_wav2vec2(model_config(self.args))

    def build_criterion(self) -> Wav2VecLoss:
        return Wav2VecLoss(self.args.loss_weights)

    def mask_budget(self, n_frames: int) -> int:
        """The static bound on a row's masked count (JAX :84-99): at most
        max(int(prob * F / L) + 1, 2) spans of L (static) or 2L (uniform);
        normal and poisson lengths are unbounded, so F."""
        a = self.args
        spans = max(int(a.mask_prob * n_frames / a.mask_length) + 1, 2)
        if a.mask_selection == "static":
            span_len = a.mask_length
        elif a.mask_selection == "uniform":
            span_len = 2 * a.mask_length
        else:
            return n_frames
        return min(spans * span_len, n_frames)

    def prepare_batch(self, batch: Dict, rng: np.random.Generator) -> Dict:
        padding = frame_padding(self.args, batch)
        bsz, n_frames = padding.shape
        mask = span_mask(self.args, padding.shape, padding, rng, require_same_masks=True,
                         mask_dropout=self.args.mask_dropout)
        m_pad = self.mask_budget(n_frames)
        counts = mask.sum(1)
        if counts.max() > m_pad:
            # the defensive subsample of JAX :111-119, equal counts kept
            for b in range(bsz):
                idx = np.nonzero(mask[b])[0]
                mask[b, rng.choice(idx, len(idx) - m_pad, replace=False)] = False
            counts = mask.sum(1)
        masked_pos = np.zeros((bsz, m_pad), np.int32)
        masked_valid = np.zeros((bsz, m_pad), bool)
        for b in range(bsz):
            idx = np.nonzero(mask[b])[0]
            masked_pos[b, :len(idx)] = idx
            masked_valid[b, :len(idx)] = True
        n = self.args.num_negatives
        m_act = int(counts.min()) if bsz else 0
        neg = np.zeros((bsz, m_pad, n), np.int32)
        if m_act > 1:
            draws = rng.integers(0, m_act - 1, size=(bsz, m_pad, n))
            draws = draws + (draws >= np.arange(m_pad)[None, :, None])
            neg = np.minimum(draws, m_act - 1).astype(np.int32)
        batch.update(mask_indices=mask, masked_pos=masked_pos, masked_valid=masked_valid,
                     neg_idxs=neg, gumbel_temp=np.float32(self.gumbel_temp))
        return batch

    def dummy_batch(self, batch_size: int = 2, seq_len: int = 8000) -> Dict:
        """JAX's (:171-185): a generator seeded 0, prepared."""
        rng = np.random.default_rng(0)
        lengths = np.full((batch_size,), seq_len, np.int32)
        if batch_size > 1:
            lengths[-1] = max(seq_len * 3 // 4, 1)
        batch = {"src_tokens": rng.normal(size=(batch_size, seq_len)).astype(np.float32) * 0.1,
                 "src_lengths": lengths, "nsentences": batch_size, "ntokens": int(lengths.sum())}
        return self.prepare_batch(batch, rng)


class DummyWav2Vec2Task(AudioPretrainingTask):
    synthetic = True

    def load_dataset(self, split: str, epoch: int = 1) -> None:
        self.datasets[split] = dummy_dataset(self, 8000, default_batch=2, default_size=4)
