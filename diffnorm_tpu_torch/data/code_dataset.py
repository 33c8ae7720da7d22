"""Unit-to-waveform dataset of the code-HiFi-GAN fine-tune (the port's copy
of diffnorm_tpu/data/code_dataset.py; reference fairseq/tasks/code_hifigan.py
"unit_to_speech"): a `name|u1 u2 ...` units file beside 16 kHz waveforms.
A training item is a random crop of `crop_units` units (drawn from the
dataset's one `np.random.default_rng(seed)`) with its aligned waveform
segment, 320 samples a unit, zero-padded where the utterance is short, so
every batch has one shape. With `dedup_dur` an item also carries the crop's
run-length labels: `dur_code` (the reduced units) and `durations` (their
run lengths, -100 on padded slots), the duration predictor's targets.

`data_cfg` (a data config's `waveform_transforms` and `dataset_transforms`
blocks, data/augment.py) runs the waveform transforms on each training
crop in `__getitem__` and `noisyoverlapaugment` over the batch's crops in
`collater`, both drawing from the dataset's generator after the crop draws,
as JAX's do.

`FeatureToSpeechDataset` (repr_to_speech) pairs per-utterance feature
dumps (50 Hz frames, e.g. `cli.prepare dump-features`' 768-d mHuBERT
features) with the 16 kHz waveforms: a training item is a random crop of
`crop_units` frames and its 320-sample-a-frame waveform segment.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from diffnorm_tpu_torch.data.audio import read_audio
from diffnorm_tpu_torch.data.augment import (
    NoisyOverlapAugment,
    build_dataset_transforms,
    build_waveform_transforms,
    get_transform,
)
from diffnorm_tpu_torch.data.manifest import read_feature_manifest

SAMPLES_PER_UNIT = 320  # 16000 Hz / 50 Hz unit rate


def read_units_file(path: str) -> Dict[str, np.ndarray]:
    """{name: int32 units} of a `name|u1 u2 ...` file."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            name, units = line.split("|", 1)
            out[name] = np.asarray([int(x) for x in units.split()], np.int32)
    return out


def run_lengths(u: np.ndarray, n: int):
    """(dur_code [n], durations [n]): the runs of `u` as reduced units and
    their lengths, zero / -100 past the last run."""
    edges = np.concatenate([[True], u[1:] != u[:-1]])
    uniq = u[edges].astype(np.int32)
    durs = np.diff(np.concatenate([np.nonzero(edges)[0], [len(u)]])).astype(np.int32)
    dur_code = np.zeros((n,), np.int32)
    durations = np.full((n,), -100, np.int32)
    k = min(len(uniq), n)
    dur_code[:k] = uniq[:k]
    durations[:k] = durs[:k]
    return dur_code, durations


class CodeToSpeechDataset:
    def __init__(self, names: List[str], audio_paths: List[str], units: List[np.ndarray],
                 crop_units: int = 32, is_train: bool = True, seed: int = 1,
                 dedup_dur: bool = False, data_cfg: Optional[Dict] = None):
        self.names, self.audio_paths, self.units = names, audio_paths, units
        self.crop_units, self.is_train, self.shuffle = crop_units, is_train, is_train
        self.seed, self.dedup_dur = seed, dedup_dur
        self._rng = np.random.default_rng(seed)
        self.waveform_transforms = build_waveform_transforms(data_cfg or {}, is_train)
        self.dataset_transforms = build_dataset_transforms(data_cfg or {}, is_train)

    def __len__(self) -> int:
        return len(self.names)

    def num_tokens(self, index: int) -> int:
        return self.crop_units

    def ordered_indices(self) -> np.ndarray:
        """One seeded permutation in training (the same every epoch; the
        iterator shuffles the batches per epoch), in order otherwise."""
        if self.shuffle:
            return np.random.default_rng(self.seed).permutation(len(self))
        return np.arange(len(self))

    def __getitem__(self, index: int) -> Dict:
        wav, sr = read_audio(self.audio_paths[index])
        if sr != 16000:
            raise ValueError(f"{self.audio_paths[index]}: expected 16 kHz, got {sr}")
        units = self.units[index]
        n = self.crop_units
        start = 0
        if len(units) > n and self.is_train:
            start = int(self._rng.integers(0, len(units) - n))
        u = units[start:start + n]
        seg = wav[start * SAMPLES_PER_UNIT:(start + n) * SAMPLES_PER_UNIT]
        if len(u) < n:
            u = np.pad(u, (0, n - len(u)))
        want = n * SAMPLES_PER_UNIT
        if len(seg) < want:
            seg = np.pad(seg, (0, want - len(seg)))
        for t in self.waveform_transforms:
            seg, _ = t(seg, 16000, rng=self._rng)
        item = {"index": index, "code": u.astype(np.int32), "wav": np.asarray(seg, np.float32)}
        if self.dedup_dur:
            item["dur_code"], item["durations"] = run_lengths(u, n)
        return item

    def collater(self, samples: List[Dict]) -> Dict:
        wavs = [s["wav"] for s in samples]
        overlap = get_transform(self.dataset_transforms, NoisyOverlapAugment)
        if overlap is not None:
            wavs = [np.asarray(w, np.float32) for w in overlap(wavs, rng=self._rng)]
        batch = {"id": np.asarray([s["index"] for s in samples], np.int64),
                 "code": np.stack([s["code"] for s in samples]),
                 "wav": np.stack(wavs),
                 "ntokens": len(samples) * self.crop_units, "nsentences": len(samples)}
        if "durations" in samples[0]:
            batch["dur_code"] = np.stack([s["dur_code"] for s in samples])
            batch["durations"] = np.stack([s["durations"] for s in samples])
        return batch

    @classmethod
    def from_files(cls, units_file: str, audio_dir: str, crop_units: int = 32,
                   is_train: bool = True, seed: int = 1, dedup_dur: bool = False,
                   data_cfg: Optional[Dict] = None) -> "CodeToSpeechDataset":
        """The units file's utterances whose `{name}.wav` exists under
        `audio_dir`, in the file's order."""
        names, paths, units = [], [], []
        for name, u in read_units_file(units_file).items():
            p = os.path.join(audio_dir, name + ".wav")
            if os.path.exists(p):
                names.append(name)
                paths.append(p)
                units.append(u)
        return cls(names, paths, units, crop_units=crop_units, is_train=is_train, seed=seed,
                   dedup_dur=dedup_dur, data_cfg=data_cfg)


class FeatureToSpeechDataset(CodeToSpeechDataset):
    """Feature dumps (`{utt}.feat.npy`, [frames, dim] at 50 Hz) beside 16 kHz
    waveforms, for the repr_to_speech fine-tune (JAX's
    data/code_dataset.py:167-221, reference repr_to_speech_dataset.py): a
    training item is a random crop of `crop_units` frames (its start drawn
    from the dataset's generator) and its aligned waveform segment, both
    zero-padded where the utterance is short. No transforms, as JAX's."""

    def __init__(self, names: List[str], audio_paths: List[str], feat_paths: List[str],
                 crop_units: int = 32, is_train: bool = True, seed: int = 1):
        super().__init__(names, audio_paths, [None] * len(names), crop_units=crop_units,
                         is_train=is_train, seed=seed)
        self.feat_paths = feat_paths

    def __getitem__(self, index: int) -> Dict:
        wav, sr = read_audio(self.audio_paths[index])
        if sr != 16000:
            raise ValueError(f"{self.audio_paths[index]}: expected 16 kHz, got {sr}")
        feat = np.load(self.feat_paths[index]).astype(np.float32)
        n = self.crop_units
        start = 0
        if len(feat) > n and self.is_train:
            start = int(self._rng.integers(0, len(feat) - n))
        f = feat[start:start + n]
        seg = wav[start * SAMPLES_PER_UNIT:(start + n) * SAMPLES_PER_UNIT]
        if len(f) < n:
            f = np.pad(f, ((0, n - len(f)), (0, 0)))
        want = n * SAMPLES_PER_UNIT
        if len(seg) < want:
            seg = np.pad(seg, (0, want - len(seg)))
        return {"index": index, "features": f, "wav": seg.astype(np.float32)}

    def collater(self, samples: List[Dict]) -> Dict:
        return {"id": np.asarray([s["index"] for s in samples], np.int64),
                "features": np.stack([s["features"] for s in samples]),
                "wav": np.stack([s["wav"] for s in samples]),
                "ntokens": len(samples) * self.crop_units, "nsentences": len(samples)}

    @classmethod
    def from_manifest(cls, feat_manifest: str, audio_dir: str, crop_units: int = 32,
                      is_train: bool = True, seed: int = 1) -> "FeatureToSpeechDataset":
        """A feature manifest's utterances (`cli.prepare dump-features`'
        `{split}.manifest.tsv`) whose `{utt}.wav` exists under `audio_dir`,
        in the manifest's order."""
        names, audio_paths, feat_paths = [], [], []
        for utt, (feat_path, _) in read_feature_manifest(feat_manifest).items():
            audio = os.path.join(audio_dir, utt + ".wav")
            if os.path.exists(audio):
                names.append(utt)
                audio_paths.append(audio)
                feat_paths.append(feat_path)
        return cls(names, audio_paths, feat_paths, crop_units=crop_units, is_train=is_train,
                   seed=seed)
