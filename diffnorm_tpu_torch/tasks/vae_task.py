"""The speech VAE stage ("speech_decoder", the port's copy of
diffnorm_tpu/tasks/vae_task.py): the 1000 + 4 unit dictionary, the
repr -> repr-unit dataset, SpeechVAEModule and SpeechVAELoss; `dummy_batch`
is JAX's synthetic batch (vae_task.py:51-67)."""

from __future__ import annotations

from typing import Dict

import numpy as np

from diffnorm_tpu_torch.criterions.vae_loss import SpeechVAELoss
from diffnorm_tpu_torch.data.dictionary import Dictionary
from diffnorm_tpu_torch.data.repr_unit_dataset import ReprToReprUnitDataset
from diffnorm_tpu_torch.models.vae import SpeechVAEModule
from diffnorm_tpu_torch.tasks.base import Task


class SpeechDecoderTask(Task):
    def __init__(self, args):
        super().__init__(args)
        self.tgt_dict = Dictionary.unit_dictionary(args.target_code_size)

    def load_dataset(self, split: str, epoch: int = 1) -> None:
        train = split.startswith("train")
        self.datasets[split] = ReprToReprUnitDataset.from_tsv(
            root=self.data_path(epoch), tgt_feat_dir=self.args.tgt_feat_dir, split=split,
            tgt_dict=self.tgt_dict, is_train=train, max_samples=None if train else 4000)

    def build_model(self) -> SpeechVAEModule:
        a = self.args
        return SpeechVAEModule(
            dim=a.feature_dim, latent_dim=a.latent_dim, vocab_size=len(self.tgt_dict),
            decoder_depth=a.vae_decoder_depth, decoder_dim_head=a.vae_decoder_dim_head,
            decoder_heads=a.vae_decoder_heads, chan_mults=a.chan_mults, dropout=a.dropout)

    def build_criterion(self) -> SpeechVAELoss:
        return SpeechVAELoss()

    def dummy_batch(self, batch_size: int = 2, seq_len: int = 16) -> Dict:
        """Normal features [B, seq_len, feature_dim] and units from a
        generator seeded 0, the last row half length, its tail 0 (JAX
        vae_task.py:51-67)."""
        rng = np.random.default_rng(0)
        lengths = np.full((batch_size,), seq_len, dtype=np.int32)
        lengths[-1] = max(seq_len // 2, 1)
        units = rng.integers(4, 4 + self.args.target_code_size,
                             size=(batch_size, seq_len)).astype(np.int32)
        for i, n in enumerate(lengths):
            units[i, n:] = 0
        return {"reduce_target": rng.normal(size=(batch_size, seq_len, self.args.feature_dim)
                                            ).astype(np.float32),
                "reduce_target_unit": units, "reduce_target_lengths": lengths}
