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

The config's `target_speaker_embed` names a directory whose `{split}.tsv`
(columns id, speaker_embed) gives each utterance's speaker-embedding `.npy`,
joined by id (reference speech_to_speech_dataset.py:90-96); the collater
stacks them as `tgt_speaker` [B, D]. `add_multitask` joins an aux task's
text targets (`data/multitask.py`), collated per task under
`batch["multitask"][name]` and padded to their length bucket.

The config's `dataset_transforms` (data/augment.py) apply: with
`concataugment`, an item draws a partner index from the dataset's
generator before SpecAugment does, on the same generator; the sources are
concatenated, and so are the targets, the first one's EOS dropped. Its
speaker embedding and aux targets are the first item's, as JAX's.
`noisyoverlapaugment` is built and unused here, as in JAX (the vocoder
dataset applies it).

The config's `use_audio_input` (reference data_cfg.py:116-119, the CTC
fine-tune's) gives the raw waveform as the source, [T, 1], with no feature
transform, and the item's own target (JAX s2s_dataset.py:107-125).
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
from diffnorm_tpu_torch.data.augment import (
    ConcatAugment,
    build_dataset_transforms,
    get_transform,
)
from diffnorm_tpu_torch.data.batching import bucket_length
from diffnorm_tpu_torch.data.dictionary import Dictionary
from diffnorm_tpu_torch.data.manifest import read_translation_manifest
from diffnorm_tpu_torch.data.multitask import collate_text_targets

PAD = 1


class SpeechToUnitDataset:
    def __init__(self, ids: List[str], src_audio_paths: List[str], src_n_frames: List[int],
                 tgt_units: Optional[List[np.ndarray]] = None, data_cfg: Optional[dict] = None,
                 is_train: bool = False, seed: int = 1,
                 tgt_speakers: Optional[List[str]] = None):
        """tgt_units: dictionary-encoded targets with EOS appended (None for
        inference); tgt_speakers: each utterance's speaker-embedding path."""
        self.ids = ids
        self.src_audio_paths = src_audio_paths
        self.src_n_frames = np.asarray(src_n_frames, dtype=np.int64)
        self.tgt_units = tgt_units
        self.data_cfg = data_cfg or {}
        self.is_train, self.seed = is_train, seed
        self.feature_transforms = build_feature_transforms(self.data_cfg, is_train)
        self.dataset_transforms = build_dataset_transforms(self.data_cfg, is_train)
        self._rng = np.random.default_rng(seed)  # ConcatAugment's and SpecAugment's draws
        self.tgt_speakers = tgt_speakers
        self.multitask_data: Dict[str, Dict] = {}

    def add_multitask(self, name: str, text_data, decoder_type: str) -> None:
        """Attach one aux task's per-sample text targets (TextTargetData);
        a transformer task's batch entry also gets prev_output_tokens."""
        self.multitask_data[name] = {"data": text_data, "with_prev": decoder_type != "ctc"}

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
        indices = [index]
        concat = get_transform(self.dataset_transforms, ConcatAugment)
        if concat is not None:
            indices = concat.find_indices(index, self.src_n_frames, len(self), rng=self._rng)
        raw_audio = bool(self.data_cfg.get("use_audio_input", False))
        feat = np.concatenate([
            np.asarray(get_features_or_waveform(self.src_audio_paths[i], need_waveform=raw_audio),
                       dtype=np.float32)
            for i in indices], axis=0)
        if raw_audio:
            sample = {"index": index, "source": feat[:, None] if feat.ndim == 1 else feat}
            if self.tgt_units is not None:
                sample["target"] = self.tgt_units[index]
            if self.tgt_speakers is not None:
                sample["tgt_speaker"] = np.asarray(
                    get_features_or_waveform(self.tgt_speakers[index]), np.float32).reshape(-1)
            return sample
        for t in self.feature_transforms:
            feat = t(feat, rng=self._rng) if isinstance(t, SpecAugment) else t(feat)
        sample = {"index": index, "source": feat}
        if self.tgt_units is not None and len(indices) == 1:
            sample["target"] = self.tgt_units[index]
        elif self.tgt_units is not None:  # each target ends in EOS: the first one's goes
            sample["target"] = np.concatenate(
                [self.tgt_units[index][:-1]] + [self.tgt_units[i] for i in indices[1:]])
        if self.tgt_speakers is not None:
            sample["tgt_speaker"] = np.asarray(
                get_features_or_waveform(self.tgt_speakers[index]), np.float32).reshape(-1)
        if self.multitask_data:
            sample["multitask"] = {}
            for name, mt in self.multitask_data.items():
                enc = mt["data"].get(self.ids[index])
                # an absent id gets an empty target (the reference warns)
                sample["multitask"][name] = np.zeros((0,), np.int32) if enc is None else enc
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
        if self.tgt_speakers is not None:
            batch["tgt_speaker"] = np.stack([s["tgt_speaker"] for s in samples])
        if self.multitask_data:
            batch["multitask"] = {}
            for name, mt in self.multitask_data.items():
                targets = [s["multitask"][name] for s in samples]
                pad_to = bucket_length(max(1, max(len(t) for t in targets)))
                batch["multitask"][name] = collate_text_targets(
                    targets, with_prev=mt["with_prev"], pad_to=pad_to)
        return batch

    @classmethod
    def from_tsv(cls, root: str, split: str, tgt_dict: Optional[Dictionary] = None,
                 config_yaml: str = "config.yaml", is_train: bool = False,
                 seed: int = 1) -> "SpeechToUnitDataset":
        """The split's manifest under `root` and the data config
        `config_yaml` (relative to `root`); targets encoded with `tgt_dict`
        where one is given."""
        rows = read_translation_manifest(os.path.join(root, f"{split}.tsv"))
        data_cfg = load_s2t_data_cfg(root, config_yaml)
        audio_root = data_cfg.get("audio_root", root)
        paths = [r["src_audio"] if os.path.isabs(r["src_audio"])
                 else os.path.join(audio_root, r["src_audio"]) for r in rows]
        units = None if tgt_dict is None else [
            tgt_dict.encode_line(r["tgt_audio"], append_eos=True) for r in rows]
        ids = [r["id"] for r in rows]
        return cls(ids=ids, src_audio_paths=paths,
                   src_n_frames=[int(r["src_n_frames"]) for r in rows], tgt_units=units,
                   data_cfg=data_cfg, is_train=is_train, seed=seed,
                   tgt_speakers=_speaker_paths(root, split, data_cfg, ids))


def load_s2t_data_cfg(root: str, config_yaml: str = "config.yaml") -> Dict:
    """The data config `config_yaml` under `root`, {} where there is none
    (JAX data/s2t_dataset.py:49-56)."""
    cfg_path = os.path.join(root, config_yaml)
    if not os.path.exists(cfg_path):
        return {}
    import yaml

    with open(cfg_path) as f:
        return yaml.safe_load(f) or {}


def _speaker_paths(root: str, split: str, data_cfg: dict,
                   ids: List[str]) -> Optional[List[str]]:
    """The config's `target_speaker_embed` directory (relative to `root`)
    joined by id: its `{split}.tsv` maps each id to a speaker-embedding
    path, relative to the directory. None without the key."""
    spk_dir = data_cfg.get("target_speaker_embed")
    if not spk_dir:
        return None
    import csv

    if not os.path.isabs(spk_dir):
        spk_dir = os.path.join(root, spk_dir)
    with open(os.path.join(spk_dir, f"{split}.tsv")) as f:
        spk_map = {r["id"]: r["speaker_embed"] for r in csv.DictReader(f, delimiter="\t")}
    return [spk_map[i] if os.path.isabs(spk_map[i]) else os.path.join(spk_dir, spk_map[i])
            for i in ids]
