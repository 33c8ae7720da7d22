"""The Levenshtein transformer's task, "translation_lev" (the port of
diffnorm_tpu/tasks/levenshtein_task.py): the "cmlm_cg" task's bitext and
dictionaries, and each batch's canvases made on the host from the numpy
generator it is given, with JAX's draws in JAX's order:

* a keep probability U(0, 1) a row, then each token kept with it (the
  specials always): `prev_ins` is the target with the dropped tokens <unk>
  (the word-fill canvas), `prev_kept` the kept tokens left-packed (the
  insertion canvas), `ins_target` / `ins_valid` the dropped tokens between
  each adjacent kept pair;
* a substitution probability U(0, 0.3) a row, then each non-special token
  replaced with it by a random non-special one: `prev_del` (the deletion
  canvas), `del_target` 1 where replaced.

The keep probability reaches 0, so the empty [BOS, EOS] canvas, where a
decode starts, stays in the training distribution. The model is
`models/levenshtein.py`'s, the criterion levenshtein_loss (nat_loss
dispatches to it). `DummyLevenshteinTask` ("dummy_lev") trains on
`dataset_size` copies of `dummy_batch`, in process or through cli.train.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from diffnorm_tpu_torch.criterions.levenshtein_loss import LevenshteinLoss
from diffnorm_tpu_torch.models.levenshtein import LevenshteinModule
from diffnorm_tpu_torch.tasks.cmlm_cg_task import CMLMCGTask, dummy_dataset

PAD, BOS, EOS, UNK = 1, 0, 2, 3


class LevenshteinTask(CMLMCGTask):
    def prepare_batch(self, batch: Dict, rng: np.random.Generator) -> Dict:
        """The canvases (module docstring)."""
        target = batch["target"]
        b, t = target.shape
        special = (target == PAD) | (target == BOS) | (target == EOS)
        keep_prob = rng.uniform(0.0, 1.0, size=(b, 1))
        keep = (rng.random(target.shape) < keep_prob) | special
        prev_kept = np.full_like(target, PAD)
        ins_target = np.zeros((b, t + 1), np.int32)
        ins_valid = np.zeros((b, t + 1), bool)
        for i in range(b):
            kept = np.flatnonzero(keep[i] & (target[i] != PAD))
            prev_kept[i, :len(kept)] = target[i, kept]
            n = max(len(kept) - 1, 0)  # the slots between adjacent kept tokens
            ins_target[i, :n] = np.diff(kept) - 1
            ins_valid[i, :n] = True
        sub_prob = rng.uniform(0.0, 0.3, size=(b, 1))
        sub = (rng.random(target.shape) < sub_prob) & ~special
        noise = rng.integers(4, len(self.tgt_dict), size=target.shape)
        batch.update(prev_ins=np.where(keep, target, UNK).astype(np.int32),
                     prev_kept=prev_kept, ins_target=ins_target, ins_valid=ins_valid,
                     prev_del=np.where(sub, noise, target).astype(np.int32),
                     del_target=sub.astype(np.int32))
        return batch

    def build_model(self) -> LevenshteinModule:
        return LevenshteinModule(**self.model_widths())

    def build_criterion(self) -> LevenshteinLoss:
        return LevenshteinLoss(self.args.label_smoothing)

    def dummy_batch(self, batch_size: int = 2, seq_len: int = 12) -> Dict:
        """A synthetic batch from a generator seeded 0, BOS first and EOS
        last a row, prepared (JAX levenshtein_task.py:79-93)."""
        rng = np.random.default_rng(0)
        src, tgt = self.random_pair(batch_size, seq_len, rng)
        tgt[:, 0] = BOS
        return self.prepare_batch({"src_tokens": src,
                                   "src_lengths": np.full((batch_size,), seq_len, np.int32),
                                   "target": tgt}, rng)


class DummyLevenshteinTask(LevenshteinTask):
    synthetic = True

    def load_dataset(self, split: str, epoch: int = 1) -> None:
        self.datasets[split] = dummy_dataset(self, 12)
