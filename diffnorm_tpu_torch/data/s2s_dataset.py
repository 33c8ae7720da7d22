"""Speech-to-unit dataset of the S2ST stages: the sources and unit targets of
a `{split}.tsv` (the port's copy of diffnorm_tpu/data/s2s_dataset.py).

Sources are `.npy` fbank dumps or audio files (the kaldi fbank of
`data/audio.py`) under the config's `audio_root`, run through the feature
transforms of `config.yaml` (SpecAugment on train splits, drawn from the
dataset's generator). Targets are unit strings encoded through the unit
dictionary with EOS appended; without a dictionary (inference) none are
read. `ordered_indices` sorts by descending source length, ties in a shuffle
seeded from `seed` on train splits and in manifest order otherwise; the
collater sorts a batch by descending source length and pads the source (with
zeros) and the target (with pad = 1) to their length buckets, as JAX's does.

Not ported, and raising: `use_audio_input`, `target_speaker_embed`, the
dataset transforms (`concataugment`, `noisyoverlapaugment`) and multitask
targets.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from diffnorm_tpu_torch.data.audio import (
    SpecAugment,
    build_feature_transforms,
    get_features_or_waveform,
)
from diffnorm_tpu_torch.data.batching import bucket_length
from diffnorm_tpu_torch.data.dictionary import Dictionary
from diffnorm_tpu_torch.data.manifest import read_translation_manifest

PAD = 1
UNPORTED_CONFIG = ("use_audio_input", "target_speaker_embed")


class SpeechToUnitDataset:
    def __init__(self, ids: List[str], src_audio_paths: List[str], src_n_frames: List[int],
                 tgt_units: Optional[List[np.ndarray]] = None, data_cfg: Optional[dict] = None,
                 is_train: bool = False, seed: int = 1):
        """tgt_units: dictionary-encoded targets with EOS appended (None for
        inference)."""
        self.ids = ids
        self.src_audio_paths = src_audio_paths
        self.src_n_frames = np.asarray(src_n_frames, dtype=np.int64)
        self.tgt_units = tgt_units
        self.data_cfg = data_cfg or {}
        self.is_train, self.seed = is_train, seed
        for key in UNPORTED_CONFIG:
            if self.data_cfg.get(key):
                raise NotImplementedError(f"{key} is not ported")
        transforms = self.data_cfg.get("dataset_transforms") or {}
        names = list(transforms.get("*", [])) + list(
            transforms.get("_train" if is_train else "_eval", []))
        if names:
            raise NotImplementedError(f"dataset transforms {names} are not ported")
        self.feature_transforms = build_feature_transforms(self.data_cfg, is_train)
        self._rng = np.random.default_rng(seed)  # SpecAugment's draws

    def __len__(self):
        return len(self.ids)

    def num_tokens(self, index: int) -> int:
        return int(self.src_n_frames[index])

    def size(self, index: int):
        """(source frames, target length with EOS): filtering compares each
        against (max_source_positions, max_target_positions)."""
        return int(self.src_n_frames[index]), len(self.tgt_units[index])

    def ordered_indices(self) -> np.ndarray:
        order = (np.random.default_rng(self.seed).permutation(len(self)) if self.is_train
                 else np.arange(len(self)))
        return np.lexsort((order, -self.src_n_frames))

    def __getitem__(self, index: int) -> Dict:
        feat = np.asarray(get_features_or_waveform(self.src_audio_paths[index]),
                          dtype=np.float32)
        for t in self.feature_transforms:
            feat = t(feat, rng=self._rng) if isinstance(t, SpecAugment) else t(feat)
        sample = {"index": index, "source": feat}
        if self.tgt_units is not None:
            sample["target"] = self.tgt_units[index]
        return sample

    def collater(self, samples: List[Dict]) -> Dict:
        samples = sorted(samples, key=lambda s: s["source"].shape[0], reverse=True)
        src_lens = np.asarray([s["source"].shape[0] for s in samples], np.int32)
        src = np.zeros((len(samples), bucket_length(int(src_lens.max())),
                        samples[0]["source"].shape[1]), np.float32)
        for i, s in enumerate(samples):
            src[i, :src_lens[i]] = s["source"]
        batch = {"id": np.asarray([s["index"] for s in samples], np.int64),
                 "src_tokens": src, "src_lengths": src_lens}
        if "target" in samples[0]:
            tgt_lens = np.asarray([len(s["target"]) for s in samples], np.int32)
            tgt = np.full((len(samples), bucket_length(int(tgt_lens.max()))), PAD, np.int32)
            for i, s in enumerate(samples):
                tgt[i, :tgt_lens[i]] = s["target"]
            batch.update(target=tgt, target_lengths=tgt_lens, ntokens=int(tgt_lens.sum()),
                         nsentences=len(samples))
        return batch

    @classmethod
    def from_tsv(cls, root: str, split: str, tgt_dict: Optional[Dictionary] = None,
                 config_yaml: str = "config.yaml", is_train: bool = False,
                 seed: int = 1) -> "SpeechToUnitDataset":
        """The split's manifest under `root` and the data config
        `config_yaml` (relative to `root`); targets encoded with `tgt_dict`
        where one is given."""
        rows = read_translation_manifest(os.path.join(root, f"{split}.tsv"))
        data_cfg = {}
        cfg_path = os.path.join(root, config_yaml)
        if os.path.exists(cfg_path):
            import yaml

            with open(cfg_path) as f:
                data_cfg = yaml.safe_load(f) or {}
        audio_root = data_cfg.get("audio_root", root)
        paths = [r["src_audio"] if os.path.isabs(r["src_audio"])
                 else os.path.join(audio_root, r["src_audio"]) for r in rows]
        units = None if tgt_dict is None else [
            tgt_dict.encode_line(r["tgt_audio"], append_eos=True) for r in rows]
        return cls(ids=[r["id"] for r in rows], src_audio_paths=paths,
                   src_n_frames=[int(r["src_n_frames"]) for r in rows], tgt_units=units,
                   data_cfg=data_cfg, is_train=is_train, seed=seed)
