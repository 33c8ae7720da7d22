"""The --multitask-config-yaml plumbing of a task (the port's copy of
diffnorm_tpu/tasks/multitask_mixin.py; reference
fairseq/tasks/speech_to_speech.py:229-245 and :511-516): the config, the
aux heads' specs, the loss weights' schedule by update count, and the text
targets joined onto a dataset. The transformer heads' prev_output_tokens
reach the model through the criterion (`criterions/nar_loss.py`).
`mt_task_name` picks the first-pass decoder's task of UnitY and
Translatotron2 (JAX multitask_mixin.py:37): the last flagged
is_first_pass_decoder, else the last transformer task named target*."""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from diffnorm_tpu_torch.data.multitask import MultitaskConfig, SingleTaskConfig, TextTargetData
from diffnorm_tpu_torch.models.nar_transformer import AuxTaskSpec


class MultitaskTaskMixin:
    """Mixin over Task: call `_init_multitask(args)` from __init__ and
    `attach_multitask(ds, split)` from load_dataset."""

    def _init_multitask(self, args) -> None:
        self.multitask_tasks: Dict[str, SingleTaskConfig] = {}
        self.multitask_config: Optional[MultitaskConfig] = None
        self._num_updates = 0
        mt_yaml = getattr(args, "multitask_config_yaml", None)
        if mt_yaml:
            if not os.path.isabs(mt_yaml):
                mt_yaml = os.path.join(self.data_path(1), mt_yaml)
            self.multitask_config = MultitaskConfig(mt_yaml)
            self.multitask_tasks = self.multitask_config.get_all_tasks()

    @property
    def mt_task_name(self) -> Optional[str]:
        """The first-pass decoder's task (module docstring), or None."""
        if self.multitask_config is None:
            return None
        idx = self.multitask_config.first_pass_decoder_task_index
        return list(self.multitask_tasks)[idx] if idx >= 0 else None

    def first_pass_spec(self) -> Tuple[Optional[AuxTaskSpec], Tuple[AuxTaskSpec, ...]]:
        """(the first pass's spec or None, the other aux tasks' specs)."""
        specs, name = self.aux_task_specs(), self.mt_task_name
        return (next((s for s in specs if s.name == name), None),
                tuple(s for s in specs if s.name != name))

    def first_pass_prev_tokens(self, batch: Dict, pad: int = 1, eos: int = 2) -> np.ndarray:
        """The first-pass decoder's prev_output_tokens of `batch`, or where the
        split has no first-pass text a [B, 2] stub, [EOS, PAD] a row (JAX
        multitask_mixin.py:104)."""
        prev_mt = batch.get("multitask", {}).get(self.mt_task_name, {}).get(
            "prev_output_tokens")
        if prev_mt is None:
            tgt = batch.get("target")
            b = (tgt if tgt is not None else batch["feat_tgt"]).shape[0]
            prev_mt = np.full((b, 2), pad, np.int32)
            prev_mt[:, 0] = eos
        return prev_mt

    def aux_task_specs(self) -> Tuple[AuxTaskSpec, ...]:
        """The aux heads' specs (reference build_multitask_decoder and the
        defaults of base_multitask_text_transformer_decoder_arch,
        s2s_transformer.py:171-230,582-616)."""
        specs = []
        for name, tc in self.multitask_tasks.items():
            if tc.tgt_dict is None:
                raise ValueError(f"multitask '{name}': missing dictionary")
            dargs = tc.decoder_args
            specs.append(AuxTaskSpec(
                name=name, decoder_type=tc.decoder_type, vocab_size=len(tc.tgt_dict),
                input_from=tc.input_from, input_layer=tc.input_layer,
                decoder_layers=int(dargs.get("decoder_layers", 2)),
                decoder_dim=int(dargs.get("decoder_embed_dim", 256)),
                decoder_heads=int(dargs.get("decoder_attention_heads", 4)),
                decoder_ffn_dim=int(dargs.get("decoder_ffn_embed_dim", 2048)),
                dropout=float(dargs.get("dropout", 0.3))))
        return tuple(specs)

    def set_num_updates(self, num_updates: int) -> None:
        """The update count the loss weights' decay follows (reference
        speech_to_speech.py:511-516 set_multitask_loss_weight)."""
        self._num_updates = int(num_updates)

    def attach_multitask(self, ds, split: str) -> None:
        """Join each aux task's per-sample text targets onto the dataset."""
        for name, tc in self.multitask_tasks.items():
            ds.add_multitask(name, TextTargetData(tc, split), tc.decoder_type)

    def inject_loss_weights(self, batch: Dict) -> None:
        """Each task's loss weight (fixed, or decaying with the update
        count) into its batch entry, as a float32 scalar."""
        for name, tc in self.multitask_tasks.items():
            if name in batch.get("multitask", {}):
                batch["multitask"][name]["loss_weight"] = np.float32(
                    tc.get_loss_weight(self._num_updates))
