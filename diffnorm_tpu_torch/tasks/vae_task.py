"""The speech VAE stage ("speech_decoder", the port's copy of
diffnorm_tpu/tasks/vae_task.py): the 1000 + 4 unit dictionary, the
repr -> repr-unit dataset, SpeechVAEModule and SpeechVAELoss."""

from __future__ import annotations

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
