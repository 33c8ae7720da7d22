"""The --multitask-config-yaml surface (the port's copy of
diffnorm_tpu/data/multitask.py; reference data_cfg.py:244-387 and
speech_to_text_dataset.py:393-480):

* `MultitaskConfig` / `SingleTaskConfig`: per task its dictionary, text
  data directory, decoder type and arguments, label smoothing, the tap
  (`encoder_layer: k` / `decoder_layer: k`, 1-based, as `input_layer` the
  Python index k - 1; absent or 0 the final layer, -1) and a fixed or
  linearly decaying loss weight;
* `TextTargetData`: a split's `{split}.tsv` (columns id, tgt_text) joined on
  the sample id, tokenized and dictionary-encoded, EOS appended unless the
  task's decoder is CTC;
* `collate_text_targets`: padding, and prev_output_tokens by fairseq's
  move-eos-to-beginning.

The aux heads are in `models/nar_transformer.py` (`AuxTaskSpec`), their
losses in `criterions/nar_loss.py`; the loss weights follow the update count
(`tasks/multitask_mixin.py`).
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional

import numpy as np

from diffnorm_tpu_torch.data.dictionary import Dictionary
from diffnorm_tpu_torch.data.encoders import build_bpe, build_tokenizer

PAD, BOS, EOS, UNK = 1, 0, 2, 3


def _read_yaml(path: str) -> dict:
    import yaml

    if not os.path.isfile(path):
        raise FileNotFoundError(f"{path} not found")
    with open(path) as f:
        return yaml.safe_load(f) or {}


class SingleTaskConfig:
    """One task block of the multitask YAML (data_cfg.py:279-387)."""

    def __init__(self, name: str, config: dict, root: Optional[str] = None):
        self.task_name = name
        self.config = dict(config or {})
        self.root = root
        dict_path = self.config.get("dict", "")
        if dict_path and root is not None and not os.path.isabs(dict_path):
            dict_path = os.path.join(root, dict_path)
        self.tgt_dict = (
            Dictionary.load(dict_path)
            if dict_path and os.path.exists(dict_path)
            else None
        )

    @property
    def data(self) -> str:
        d = self.config.get("data", "")
        if d and self.root is not None and not os.path.isabs(d):
            d = os.path.join(self.root, d)
        return d

    @property
    def decoder_type(self) -> str:
        return self.config.get("decoder_type", "transformer")

    @property
    def decoder_args(self) -> dict:
        return dict(self.config.get("decoder_args", {}) or {})

    @property
    def label_smoothing(self) -> float:
        return float(self.config.get("label_smoothing", 0.2))

    @property
    def zero_infinity(self) -> bool:
        return bool(self.config.get("zero_infinity", True))

    @property
    def input_from(self) -> str:
        """Tap the main model's encoder or decoder (data_cfg.py:317-320)."""
        return "decoder" if "decoder_layer" in self.config else "encoder"

    @property
    def input_layer(self) -> int:
        """Reference indexing (data_cfg.py:322-328): ``encoder_layer: k``
        means the k-th layer's output (1-based); 0/absent means the final
        layer (python index -1)."""
        if self.input_from == "decoder":
            return int(self.config["decoder_layer"]) - 1
        return int(self.config.get("encoder_layer", 0)) - 1

    @property
    def loss_weight_schedule(self) -> str:
        return (
            "decay"
            if "loss_weight_max" in self.config
            and "loss_weight_decay_steps" in self.config
            else "fixed"
        )

    def get_loss_weight(self, num_updates: int) -> float:
        """Fixed weight, or the reference's linear decay from
        loss_weight_max to loss_weight_min over loss_weight_decay_steps
        (data_cfg.py:339-355)."""
        if self.loss_weight_schedule == "fixed":
            return float(self.config.get("loss_weight", 1.0))
        decay_steps = float(self.config.get("loss_weight_decay_steps", 0))
        if decay_steps <= 0:
            raise ValueError(
                "loss_weight_decay_steps must be greater than 0 for a decay "
                "schedule"
            )
        lo = float(self.config.get("loss_weight_min", 0.0001))
        hi = float(self.config["loss_weight_max"])
        step = (hi - lo) / decay_steps
        return max(hi - step * num_updates, lo)

    @property
    def prepend_bos_and_append_tgt_lang_tag(self) -> bool:
        return bool(self.config.get("prepend_bos_and_append_tgt_lang_tag", False))

    @property
    def eos_token(self) -> str:
        return self.config.get("eos_token", "<eos>")

    @property
    def lang_tag_mapping(self) -> dict:
        return self.config.get("lang_tag_mapping", {}) or {}

    @property
    def rdrop_alpha(self) -> float:
        return float(self.config.get("rdrop_alpha", 0.0) or 0.0)

    @property
    def is_first_pass_decoder(self) -> bool:
        flag = bool(self.config.get("is_first_pass_decoder", False))
        if flag and self.decoder_type == "ctc":
            raise ValueError(
                "First-pass decoder in the multi-decoder model must not be CTC."
            )
        return flag


class MultitaskConfig:
    """The whole multitask YAML: {task_name: SingleTaskConfig}."""

    def __init__(self, yaml_path: str):
        config = _read_yaml(yaml_path)
        root = os.path.dirname(os.path.abspath(yaml_path))
        self.config: Dict[str, SingleTaskConfig] = {}
        for k, v in config.items():
            self.config[k] = SingleTaskConfig(k, v, root=root)

    def get_all_tasks(self) -> Dict[str, SingleTaskConfig]:
        return self.config

    def get_single_task(self, name: str) -> SingleTaskConfig:
        if name not in self.config:
            raise KeyError(f"multitask '{name}' does not exist!")
        return self.config[name]

    @property
    def first_pass_decoder_task_index(self) -> int:
        """data_cfg.py:260-276: the last is_first_pass_decoder task; else the
        last 'target*' task with a transformer decoder."""
        idx = -1
        for i, (k, v) in enumerate(self.config.items()):
            if v.is_first_pass_decoder:
                idx = i
        if idx < 0:
            for i, (k, v) in enumerate(self.config.items()):
                if k.startswith("target") and v.decoder_type == "transformer":
                    idx = i
        return idx


class TextTargetData:
    """Per-split text targets for one aux task, keyed by sample id
    (TextTargetMultitaskData parity; tokenizers from the task YAML blocks
    go through data/encoders.py)."""

    KEY_ID, KEY_TEXT = "id", "tgt_text"

    def __init__(self, task_cfg: SingleTaskConfig, split: str,
                 tgt_dict: Optional[Dictionary] = None):
        self.task_cfg = task_cfg
        self.dict = tgt_dict or task_cfg.tgt_dict
        if self.dict is None:
            raise ValueError(
                f"multitask '{task_cfg.task_name}': no dictionary "
                f"(dict: {task_cfg.config.get('dict', '')!r} not found)"
            )
        self.append_eos = task_cfg.decoder_type != "ctc"
        self.prepend_bos_and_append_tgt_lang_tag = (
            task_cfg.prepend_bos_and_append_tgt_lang_tag
        )
        path = os.path.join(task_cfg.data, f"{split}.tsv")
        self.data: Dict[str, str] = {}
        with open(path) as f:
            reader = csv.DictReader(
                f, delimiter="\t", quoting=csv.QUOTE_NONE, doublequote=False,
                lineterminator="\n",
            )
            for row in reader:
                if row.get(self.KEY_ID):
                    self.data[row[self.KEY_ID]] = row.get(self.KEY_TEXT, "")
        self.pre_tokenizer = build_tokenizer(task_cfg.config.get("pre_tokenizer"))
        self.bpe_tokenizer = build_bpe(task_cfg.config.get("bpe_tokenizer"))

    @staticmethod
    def _tokenize(tokenizer, text: str) -> str:
        return text if tokenizer is None else tokenizer.encode(text)

    def get(self, sample_id: str, tgt_lang: Optional[str] = None
            ) -> Optional[np.ndarray]:
        """Encoded target for one sample id, or None if absent (the
        reference warns and returns an empty tensor; absent rows are a data
        bug either way)."""
        text = self.data.get(sample_id)
        if text is None:
            return None
        text = self._tokenize(self.pre_tokenizer, text)
        text = self._tokenize(self.bpe_tokenizer, text)
        ids = self.dict.encode_line(text, append_eos=self.append_eos)
        if self.prepend_bos_and_append_tgt_lang_tag:
            if not tgt_lang:
                raise ValueError(
                    "prepend_bos_and_append_tgt_lang_tag requires tgt_lang"
                )
            lang_tag = f"<lang:{tgt_lang}>"
            lang_tag = self.task_cfg.lang_tag_mapping.get(lang_tag, lang_tag)
            lang_idx = self.dict.index(lang_tag)
            if lang_idx == self.dict.unk():
                raise ValueError(f"unknown language tag {lang_tag}")
            ids = np.concatenate(
                [[self.dict.bos()], ids[:-1], [lang_idx]]
            )
        return np.asarray(ids, dtype=np.int32)


def collate_text_targets(
    targets: List[np.ndarray],
    pad: int = PAD,
    eos: int = EOS,
    with_prev: bool = True,
    pad_to: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Pad a list of encoded targets and (for transformer aux decoders)
    build prev_output_tokens with move-eos-to-beginning semantics
    (fairseq data_utils.collate_tokens: prev[0]=eos, prev[1:n]=tgt[:n-1])."""
    lens = np.asarray([len(t) for t in targets], dtype=np.int32)
    max_len = int(pad_to) if pad_to else int(max(1, lens.max(initial=1)))
    bsz = len(targets)
    tgt = np.full((bsz, max_len), pad, dtype=np.int32)
    for i, t in enumerate(targets):
        tgt[i, : len(t)] = t
    out = {
        "target": tgt,
        "target_lengths": lens,
        "ntokens": int(lens.sum()),
    }
    if with_prev:
        prev = np.full((bsz, max_len), pad, dtype=np.int32)
        for i, t in enumerate(targets):
            n = len(t)
            if n == 0:
                continue
            # the reference rotates the true final token (eos, or the lang
            # tag when appended) to the front
            prev[i, 0] = t[-1] if len(t) else eos
            prev[i, 1:n] = t[: n - 1]
        out["prev_output_tokens"] = prev
    return out
