"""AR text machine translation, fairseq's "translation" task (the port of
diffnorm_tpu/tasks/translation_task.py; reference
fairseq/tasks/translation.py): the "cmlm_cg" task's bitext and
dictionaries (`tasks/cmlm_cg_task.py`), teacher-forced on each target
shifted right behind an EOS (`prev_output_tokens`), the AR text transformer
(`models/transformer_text.py`: transformer, transformer_iwslt_de_en,
transformer_wmt_en_de_big) and label_smoothed_cross_entropy. cli.generate
decodes it with the AR branch (`ar_generation`): fairseq's beam search.
`DummyTranslationTask` ("dummy_translation") trains on `dataset_size`
copies of `dummy_batch`, in process or through cli.train.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from diffnorm_tpu_torch.criterions.ce_loss import LabelSmoothedCrossEntropy
from diffnorm_tpu_torch.models.transformer_text import TextTransformerModule
from diffnorm_tpu_torch.tasks.ar_s2ut_task import shift_right
from diffnorm_tpu_torch.tasks.cmlm_cg_task import CMLMCGTask, dummy_dataset


class TranslationTask(CMLMCGTask):
    ar_generation = True  # cli.generate's AR branch

    def prepare_batch(self, batch: Dict, rng: np.random.Generator) -> Dict:
        """prev_output_tokens where the batch has none; draws nothing."""
        if "prev_output_tokens" not in batch:
            batch["prev_output_tokens"] = shift_right(batch["target"])
        return batch

    def build_model(self) -> TextTransformerModule:
        a = self.args
        return TextTransformerModule(
            src_vocab_size=a.src_vocab_size or len(self.src_dict),
            tgt_vocab_size=len(self.tgt_dict), encoder_dim=a.encoder_embed_dim,
            encoder_ffn_dim=a.encoder_ffn_embed_dim, encoder_layers=a.encoder_layers,
            encoder_heads=a.encoder_attention_heads, decoder_dim=a.decoder_embed_dim,
            decoder_ffn_dim=a.decoder_ffn_embed_dim, decoder_layers=a.decoder_layers,
            decoder_heads=a.decoder_attention_heads, dropout=a.dropout,
            attention_dropout=a.attention_dropout, activation_dropout=a.relu_dropout,
            share_decoder_input_output_embed=bool(a.share_decoder_input_output_embed))

    def build_criterion(self) -> LabelSmoothedCrossEntropy:
        return LabelSmoothedCrossEntropy(self.args.label_smoothing)


class DummyTranslationTask(TranslationTask):
    synthetic = True

    def load_dataset(self, split: str, epoch: int = 1) -> None:
        self.datasets[split] = dummy_dataset(self, 16)
