"""TSV manifest readers and writers (reference formats).

The port's copy of diffnorm_tpu/data/manifest.py:

* feature manifests `{split}.manifest.tsv`: first line the feature directory,
  then `name.feat.npy\\tlength` rows
* translation manifests `{split}.tsv`: a header, then
  `id\\tsrc_audio\\tsrc_n_frames\\ttgt_audio\\ttgt_n_frames` rows where
  `tgt_audio` is a space-separated unit string
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Tuple

TRANSLATION_COLUMNS = ["id", "src_audio", "src_n_frames", "tgt_audio", "tgt_n_frames"]


def read_feature_manifest(path: str) -> Dict[str, Tuple[str, int]]:
    """-> {utt_id: (feat_path, length)}"""
    out = {}
    with open(path) as f:
        feat_dir = f.readline().strip()
        for line in f:
            line = line.strip()
            if not line:
                continue
            name, length = line.split("\t")
            out[name.split(".")[0]] = (os.path.join(feat_dir, name), int(length))
    return out


def write_feature_manifest(path: str, feat_dir: str, rows: List[Tuple[str, int]]) -> None:
    """The feature directory, then one `name\\tlength` row per utterance."""
    with open(path, "w") as f:
        f.write(feat_dir + "\n")
        for name, length in rows:
            f.write(f"{name}\t{length}\n")


def read_translation_manifest(path: str) -> List[Dict[str, str]]:
    with open(path) as f:
        reader = csv.DictReader(f, delimiter="\t", quoting=csv.QUOTE_NONE,
                                doublequote=False, lineterminator="\n")
        return [row for row in reader if row.get("id")]


def write_translation_manifest(path: str, rows: List[Dict[str, str]]) -> None:
    with open(path, "w") as f:
        f.write("\t".join(TRANSLATION_COLUMNS) + "\n")
        for row in rows:
            f.write("\t".join(str(row[c]) for c in TRANSLATION_COLUMNS) + "\n")
