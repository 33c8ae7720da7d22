"""The SEDD tasks and the unit LM task (the port of
diffnorm_tpu/tasks/sedd_task.py and the "language_modeling" alias of
tasks/aliases.py; reference "sedd" / "sedd_lm",
fairseq/tasks/score_entropy_diffusion_task.py, and fairseq's
language_modeling): language modeling over the unit sequences of the
translation manifests' targets (`{split}.tsv`, the `tgt_audio` column), on
the unit dictionary of --target-code-size units.

`--tokens-per-sample` and `--sample-break-mode` (none, complete,
complete_doc, eos), either given, concatenate the sequences and re-cut them
into blocks of --tokens-per-sample tokens (default 1024); without them each
utterance is one item. Each sequence is cut to --max-target-positions
(default 1024) first. --arch picks the model and its criterion: SEDD
(`models/sedd.py`, sedd_absorb or sedd, --criterion sedd_loss) or the unit
LM (`models/unit_lm.py`, transformer_lm or unit_lm, --criterion
lm_cross_entropy). "sedd" and "sedd_lm" take either, SEDD by default (JAX's
eval_lm scores the unit LM under "sedd_lm"); "unit_lm" and its alias
"language_modeling" take the unit LM. The dummy tasks ("dummy_sedd",
"dummy_unit_lm" and its alias "dummy_lm") train on `dataset_size` copies of
`dummy_batch(batch_size, tokens_per_sample)` (defaults 8, 4, 32), in
process.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
from torch import nn

from diffnorm_tpu_torch.criterions.ce_loss import LMCrossEntropy
from diffnorm_tpu_torch.criterions.sedd_loss import SEDDLoss
from diffnorm_tpu_torch.data.dictionary import Dictionary
from diffnorm_tpu_torch.data.unit_lm_dataset import UnitLMDataset
from diffnorm_tpu_torch.models.sedd import ARCHS as SEDD_ARCHS
from diffnorm_tpu_torch.models.sedd import SEDDModule
from diffnorm_tpu_torch.models.unit_lm import ARCHS as LM_ARCHS
from diffnorm_tpu_torch.models.unit_lm import UnitLMModule
from diffnorm_tpu_torch.tasks.base import Task
from diffnorm_tpu_torch.tasks.cmlm_cg_task import dummy_dataset

# each arch's criterion
ARCH_CRITERIONS = {**dict.fromkeys(SEDD_ARCHS, ("sedd_loss",)),
                   **dict.fromkeys(LM_ARCHS, ("lm_cross_entropy",))}


class SEDDTask(Task):
    def __init__(self, args):
        super().__init__(args)
        self.tgt_dict = Dictionary.unit_dictionary(args.target_code_size)

    def load_dataset(self, split: str, epoch: int = 1) -> None:
        a = self.args
        block = 0
        if a.sample_break_mode or a.tokens_per_sample:
            block = a.tokens_per_sample or 1024
        self.datasets[split] = UnitLMDataset.from_tsv(
            self.data_path(epoch), split, self.tgt_dict,
            max_positions=a.max_target_positions or 1024, block_size=block,
            break_mode=a.sample_break_mode or "none",
            is_train=split.startswith("train"))

    def build_model(self) -> nn.Module:
        a = self.args
        if a.arch in LM_ARCHS:
            return UnitLMModule(len(self.tgt_dict), dim=a.decoder_embed_dim,
                                ffn_dim=a.decoder_ffn_embed_dim, layers=a.decoder_layers,
                                heads=a.decoder_attention_heads,
                                dropout=0.1 if a.dropout is None else a.dropout)
        return SEDDModule(len(self.tgt_dict), dim=a.sedd_dim, depth=a.sedd_depth,
                          heads=a.sedd_heads)

    def build_criterion(self):
        if self.args.arch in LM_ARCHS:
            return LMCrossEntropy(self.args.label_smoothing or 0.0)
        return SEDDLoss()

    def dummy_batch(self, batch_size: int = 2, seq_len: int = 16) -> Dict:
        """Units from a generator seeded 0, the last row half length, pad 0
        (JAX sedd_task.py:64-75)."""
        rng = np.random.default_rng(0)
        lengths = np.full((batch_size,), seq_len, np.int32)
        lengths[-1] = max(seq_len // 2, 2)
        units = rng.integers(4, 4 + self.args.target_code_size,
                             size=(batch_size, seq_len)).astype(np.int32)
        for i, n in enumerate(lengths):
            units[i, n:] = 0
        return {"target_unit": units, "target_lengths": lengths}


class DummySEDDTask(SEDDTask):
    synthetic = True

    def load_dataset(self, split: str, epoch: int = 1) -> None:
        self.datasets[split] = dummy_dataset(self, 32)
