"""HuBERT and wav2vec2 pretraining data (the port's copy of
diffnorm_tpu/data/hubert_dataset.py; reference
fairseq/data/audio/hubert_dataset.py): 16 kHz waveforms from a wav2vec-style
manifest `{split}.tsv` (the first line the root directory, then
"relpath\\tnum_samples" lines), with, for HuBERT, frame-level k-means labels
(`{split}.{label}`, one space-separated line an utterance) encoded through
the unit dictionary.

Utterances shorter than `min_sample_size` are dropped. Every row is cropped
to one static `max_sample_size` canvas, at a random start drawn from the
dataset's generator in training (`random_crop`), at 0 in validation, and a
shorter row padded with zeros behind its length. The labels of the crop are
aligned to the conv extractor's frames at `label_rate` (fairseq's feat2tar
ratio), -1 beyond the labels or the valid waveform. The collater stacks the
canvases; `ntokens` is the valid labels, or without labels the valid
frames. Batches are JAX's bit for bit.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from diffnorm_tpu_torch.data.audio import read_audio
from diffnorm_tpu_torch.models.hubert import CONV_LAYERS, frames_for_samples


def host_frames_for_samples(n: int, conv_layers=None) -> int:
    """The conv extractor's frames for n samples, at least 0."""
    return max(frames_for_samples(n, conv_layers), 0)


class HubertPretrainDataset:
    def __init__(self, audio_paths: List[str], n_samples: List[int],
                 labels: Optional[List[np.ndarray]] = None, max_sample_size: int = 250_000,
                 min_sample_size: int = 32_000, sample_rate: int = 16_000,
                 label_rate: float = 50.0, normalize: bool = False, is_train: bool = True,
                 random_crop: bool = True, seed: int = 1, conv_layers=None):
        keep = [i for i, n in enumerate(n_samples) if n >= min_sample_size]
        self.audio_paths = [audio_paths[i] for i in keep]
        self.n_samples = [n_samples[i] for i in keep]
        # without labels: wav2vec2's pretraining, no frame targets
        self.labels = None if labels is None else [labels[i] for i in keep]
        self.max_sample_size, self.sample_rate = max_sample_size, sample_rate
        self.label_rate, self.normalize = label_rate, normalize
        self.is_train, self.random_crop = is_train, random_crop
        self._rng = np.random.default_rng(seed)
        self.conv_layers = tuple(conv_layers) if conv_layers else CONV_LAYERS
        self.feat2tar_ratio = (label_rate * int(np.prod([s for _, _, s in self.conv_layers]))
                               / sample_rate)
        self.n_frames = host_frames_for_samples(max_sample_size, self.conv_layers)

    def __len__(self) -> int:
        return len(self.audio_paths)

    def num_tokens(self, index: int) -> int:
        return min(self.n_samples[index], self.max_sample_size)

    @property
    def sizes(self) -> np.ndarray:
        return np.minimum(np.asarray(self.n_samples), self.max_sample_size)

    def ordered_indices(self) -> np.ndarray:
        return np.argsort(self.sizes, kind="stable")[::-1].copy()

    def __getitem__(self, index: int) -> Dict:
        wav, sr = read_audio(self.audio_paths[index])
        if sr != self.sample_rate:
            raise ValueError(f"{self.audio_paths[index]}: {sr} Hz, expected {self.sample_rate}")
        if self.normalize:
            wav = (wav - wav.mean()) / np.sqrt(wav.var() + 1e-5)
        canvas, start = self.max_sample_size, 0
        if len(wav) > canvas:
            if self.is_train and self.random_crop:
                start = int(self._rng.integers(0, len(wav) - canvas + 1))
            wav = wav[start:start + canvas]
        n_valid = len(wav)
        if n_valid < canvas:
            wav = np.pad(wav, (0, canvas - n_valid))
        out = {"index": index, "wav": np.asarray(wav, np.float32), "length": n_valid}
        if self.labels is None:
            return out
        label = self.labels[index]
        lab_start = int(round(start / self.sample_rate * self.label_rate))
        inds = lab_start + (np.arange(self.n_frames) * self.feat2tar_ratio).astype(np.int64)
        target = np.full((self.n_frames,), -1, np.int64)
        ok = inds < len(label)
        target[ok] = label[inds[ok]]
        target[host_frames_for_samples(n_valid, self.conv_layers):] = -1
        out["target"] = target
        return out

    def collater(self, samples: List[Dict]) -> Dict:
        batch = {"id": np.asarray([s["index"] for s in samples], np.int64),
                 "src_tokens": np.stack([s["wav"] for s in samples]),
                 "src_lengths": np.asarray([s["length"] for s in samples], np.int32),
                 "nsentences": len(samples)}
        if self.labels is None:
            batch["ntokens"] = int(sum(host_frames_for_samples(int(s["length"]),
                                                               self.conv_layers)
                                       for s in samples))
            return batch
        batch["target"] = np.stack([s["target"] for s in samples])
        batch["ntokens"] = int(sum((np.asarray(s["target"]) >= 0).sum() for s in samples))
        return batch

    @classmethod
    def from_manifest(cls, manifest: str, label_file: Optional[str] = None, tgt_dict=None,
                      **kwargs) -> "HubertPretrainDataset":
        """The manifest's utterances, and the labels of `label_file`
        (encoded with `tgt_dict`, no EOS) where one is given."""
        with open(manifest) as f:
            root = f.readline().strip()
            paths, ns = [], []
            for line in f:
                if not line.strip():
                    continue
                p, n = line.rstrip("\n").split("\t")
                paths.append(os.path.join(root, p) if root else p)
                ns.append(int(n))
        if label_file is None:
            return cls(paths, ns, None, **kwargs)
        with open(label_file) as f:
            labels = [np.asarray(tgt_dict.encode_line(line.strip(), append_eos=False), np.int64)
                      for line in f]
        if len(labels) != len(paths):
            raise ValueError(f"{manifest}: {len(paths)} audio rows against {len(labels)} "
                             f"label rows in {label_file}")
        return cls(paths, ns, labels, **kwargs)
