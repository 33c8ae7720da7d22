"""Speech-to-text data (the port of diffnorm_tpu/data/s2t_dataset.py;
reference fairseq/data/audio/speech_to_text_dataset.py): TSV manifests with
a header row and the columns `id, audio, n_frames, tgt_text`, and a data
config whose `vocab_filename` (default dict.txt) names the target
dictionary. The source side (fbank or `.npy` features, the feature
transforms, `audio_root`) is the S2UT dataset's; the targets are the text
encoded through the dictionary with </s> appended."""

from __future__ import annotations

import csv
import os
from typing import Dict, List

import numpy as np

from diffnorm_tpu_torch.data.dictionary import Dictionary
from diffnorm_tpu_torch.data.s2s_dataset import SpeechToUnitDataset, load_s2t_data_cfg

S2T_COLUMNS = ["id", "audio", "n_frames", "tgt_text"]


def read_s2t_manifest(path: str) -> List[Dict[str, str]]:
    """The rows of an S2T manifest that have an id."""
    with open(path) as f:
        reader = csv.DictReader(f, delimiter="\t", quoting=csv.QUOTE_NONE,
                                doublequote=False, lineterminator="\n")
        return [row for row in reader if row.get("id")]


def write_s2t_manifest(path: str, rows: List[Dict[str, str]]) -> None:
    """The header, then each row's S2T_COLUMNS (other keys are left out)."""
    with open(path, "w") as f:
        writer = csv.DictWriter(f, fieldnames=S2T_COLUMNS, delimiter="\t",
                                quoting=csv.QUOTE_NONE, doublequote=False, lineterminator="\n")
        writer.writeheader()
        for row in rows:
            writer.writerow({k: row[k] for k in S2T_COLUMNS})


class SpeechToTextDataset(SpeechToUnitDataset):
    """The S2UT dataset's items and collater ([B, T, 80] `src_tokens`, the
    padded ids `target`), its targets from `tgt_text`."""

    @classmethod
    def from_tsv(cls, root: str, split: str, tgt_dict: Dictionary,
                 config_yaml: str = "config.yaml", is_train: bool = True,
                 seed: int = 1) -> "SpeechToTextDataset":
        rows = read_s2t_manifest(os.path.join(root, f"{split}.tsv"))
        data_cfg = load_s2t_data_cfg(root, config_yaml)
        audio_root = data_cfg.get("audio_root", root)
        return cls(
            ids=[r["id"] for r in rows],
            src_audio_paths=[r["audio"] if os.path.isabs(r["audio"])
                             else os.path.join(audio_root, r["audio"]) for r in rows],
            src_n_frames=[int(r["n_frames"]) for r in rows],
            tgt_units=[tgt_dict.encode_line(r["tgt_text"], append_eos=True).astype(np.int32)
                       for r in rows],
            data_cfg=data_cfg, is_train=is_train, seed=seed)
