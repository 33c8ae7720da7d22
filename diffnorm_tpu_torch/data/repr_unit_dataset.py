"""Repr -> repr-unit dataset of the VAE and normalizer stages (the port's
copy of diffnorm_tpu/data/repr_unit_dataset.py, target side only).

Joins the translation manifest `{root}/{split}.tsv` with the per-utterance
feature dumps of `{feat_dir}/{split}.manifest.tsv`, derives the reduced
units and the kept frame indices, and collates zero-padded batches (padded
lengths bucketed as in JAX) sorted by descending reduced length.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from diffnorm_tpu_torch.data.batching import bucket_length
from diffnorm_tpu_torch.data.dictionary import Dictionary
from diffnorm_tpu_torch.data.manifest import read_feature_manifest, read_translation_manifest
from diffnorm_tpu_torch.ops.unit_reduce import reduce_units


class ReprToReprUnitDataset:
    def __init__(self, ids: List[str], tgt_feat_paths: List[str],
                 tgt_units: List[List[int]], tgt_dict: Dictionary, shuffle: bool = True):
        self.ids, self.tgt_feat_paths, self.tgt_units = ids, tgt_feat_paths, tgt_units
        self.tgt_dict, self.shuffle = tgt_dict, shuffle
        self.sizes = np.asarray([len(u) for u in tgt_units], dtype=np.int64)

    def __len__(self) -> int:
        return len(self.ids)

    def num_tokens(self, index: int) -> int:
        return int(self.sizes[index])

    def ordered_indices(self) -> np.ndarray:
        """Descending frame count, ties in a shuffle seeded 1 (train, as
        JAX's default) or in manifest order."""
        order = (np.random.default_rng(1).permutation(len(self)) if self.shuffle
                 else np.arange(len(self)))
        return np.lexsort((order, -self.sizes))

    def __getitem__(self, index: int) -> Dict:
        feat = np.load(self.tgt_feat_paths[index]).astype(np.float32)
        units = np.asarray(self.tgt_units[index], dtype=np.int64)
        dedup, _, keep = reduce_units(units)
        return {"index": index,
                "reduce_tgt_unit": (dedup + self.tgt_dict.nspecial).astype(np.int32),
                "reduce_tgt_feat": feat[keep]}

    def collater(self, samples: List[Dict]) -> Dict[str, np.ndarray]:
        samples = sorted(samples, key=lambda s: s["reduce_tgt_feat"].shape[0], reverse=True)
        lengths = np.asarray([s["reduce_tgt_unit"].shape[0] for s in samples], np.int32)
        max_len = bucket_length(int(lengths.max()))
        feat_dim = samples[0]["reduce_tgt_feat"].shape[1]
        feat = np.zeros((len(samples), max_len, feat_dim), np.float32)
        units = np.zeros((len(samples), max_len), np.int32)
        for i, s in enumerate(samples):
            feat[i, :lengths[i]] = s["reduce_tgt_feat"]
            units[i, :lengths[i]] = s["reduce_tgt_unit"]
        return {"id": np.asarray([s["index"] for s in samples], np.int64),
                "reduce_target": feat, "reduce_target_unit": units,
                "reduce_target_lengths": lengths}

    @classmethod
    def from_tsv(cls, root: str, tgt_feat_dir: str, split: str, tgt_dict: Dictionary,
                 is_train: bool = True,
                 max_samples: Optional[int] = None) -> "ReprToReprUnitDataset":
        """Utterances present in both manifests whose unit count equals
        their feature length; at most max_samples + 1 of them."""
        feats = read_feature_manifest(os.path.join(tgt_feat_dir, f"{split}.manifest.tsv"))
        ids, paths, units = [], [], []
        for row in read_translation_manifest(os.path.join(root, f"{split}.tsv")):
            if row["id"] not in feats:
                continue
            toks = [int(x) for x in row["tgt_audio"].split()]
            path, feat_len = feats[row["id"]]
            if len(toks) != feat_len:
                continue
            ids.append(row["id"])
            paths.append(path)
            units.append(toks)
            if max_samples and len(ids) > max_samples:
                break
        return cls(ids, paths, units, tgt_dict, shuffle=is_train)
