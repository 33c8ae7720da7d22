"""Speech-to-unit dataset, inference only: the sources of a `{split}.tsv`.

The port's copy of what diffnorm_tpu/data/s2s_dataset.py does for an eval
split: `.npy` fbank sources under the config's `audio_root`, the eval-time
feature transforms of `config.yaml`, `ordered_indices` by descending source
length and a collater that sorts a batch by descending length and pads it to
a length bucket, as the JAX CLI's batches are padded. Targets are not read:
inference needs none. `use_audio_input` raises.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from diffnorm_tpu_torch.data.audio import build_feature_transforms, get_features_or_waveform
from diffnorm_tpu_torch.data.batching import bucket_length
from diffnorm_tpu_torch.data.manifest import read_translation_manifest


class SpeechToUnitDataset:
    def __init__(self, ids: List[str], src_audio_paths: List[str], src_n_frames: List[int],
                 data_cfg: Optional[dict] = None):
        self.ids = ids
        self.src_audio_paths = src_audio_paths
        self.src_n_frames = np.asarray(src_n_frames, dtype=np.int64)
        self.data_cfg = data_cfg or {}
        if self.data_cfg.get("use_audio_input", False):
            raise NotImplementedError("use_audio_input (raw waveform sources) is not ported")
        self.feature_transforms = build_feature_transforms(self.data_cfg)

    def __len__(self):
        return len(self.ids)

    def ordered_indices(self) -> np.ndarray:
        """Descending source length, ties by index."""
        return np.lexsort((np.arange(len(self)), -self.src_n_frames))

    def __getitem__(self, index: int) -> Dict:
        feat = np.asarray(get_features_or_waveform(self.src_audio_paths[index]),
                          dtype=np.float32)
        for t in self.feature_transforms:
            feat = t(feat)
        return {"index": index, "source": feat}

    def collater(self, samples: List[Dict]) -> Dict:
        samples = sorted(samples, key=lambda s: s["source"].shape[0], reverse=True)
        src_lens = np.asarray([s["source"].shape[0] for s in samples], np.int32)
        max_src = bucket_length(int(src_lens.max()))
        src = np.zeros((len(samples), max_src, samples[0]["source"].shape[1]), np.float32)
        for i, s in enumerate(samples):
            src[i, :src_lens[i]] = s["source"]
        return {"id": np.asarray([s["index"] for s in samples], np.int64),
                "src_tokens": src, "src_lengths": src_lens}

    @classmethod
    def from_tsv(cls, root: str, split: str) -> "SpeechToUnitDataset":
        rows = read_translation_manifest(os.path.join(root, f"{split}.tsv"))
        data_cfg = {}
        cfg_path = os.path.join(root, "config.yaml")
        if os.path.exists(cfg_path):
            import yaml

            with open(cfg_path) as f:
                data_cfg = yaml.safe_load(f) or {}
        audio_root = data_cfg.get("audio_root", root)
        paths = [r["src_audio"] if os.path.isabs(r["src_audio"])
                 else os.path.join(audio_root, r["src_audio"]) for r in rows]
        return cls(ids=[r["id"] for r in rows], src_audio_paths=paths,
                   src_n_frames=[int(r["src_n_frames"]) for r in rows], data_cfg=data_cfg)
