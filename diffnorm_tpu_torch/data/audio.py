"""Source features and the eval-time feature transforms of the S2ST chain.

The port's copy of the parts of diffnorm_tpu/data/audio.py that inference
over fbank dumps needs: `.npy` sources (get_features_or_waveform) and the
utterance / global CMVN transforms (reference feature_transforms/
utterance_cmvn.py, global_cmvn.py). Audio files (the kaldi fbank), raw
waveforms and the training-time transforms (SpecAugment, delta-deltas) are
not ported and raise.
"""

from __future__ import annotations

from typing import List

import numpy as np


def get_features_or_waveform(path: str) -> np.ndarray:
    """Per-utterance features from a `.npy` dump."""
    if not path.endswith(".npy"):
        raise NotImplementedError(
            f"{path}: the port reads .npy fbank features only (audio input and "
            f"the fbank front end are not ported)")
    return np.load(path)


class UtteranceCMVN:
    """Per-utterance mean/variance normalization."""

    def __init__(self, norm_means: bool = True, norm_vars: bool = True):
        self.norm_means, self.norm_vars = norm_means, norm_vars

    def __call__(self, x: np.ndarray) -> np.ndarray:
        mean = x.mean(axis=0)
        square_sums = (x ** 2).sum(axis=0)
        if self.norm_means:
            x = x - mean
        if self.norm_vars:
            var = square_sums / x.shape[0] - mean ** 2
            x = x / np.sqrt(np.maximum(var, 1e-10))
        return x.astype(np.float32)


class GlobalCMVN:
    """Global CMVN from precomputed stats (an npz with `mean` and `std`)."""

    def __init__(self, stats_npz_path: str):
        stats = np.load(stats_npz_path)
        self.mean, self.std = stats["mean"], stats["std"]

    def __call__(self, x: np.ndarray) -> np.ndarray:
        return ((x - self.mean) / np.maximum(self.std, 1e-10)).astype(np.float32)


def build_feature_transforms(cfg: dict) -> List:
    """The eval-time transforms of a data config's `transforms` block
    (`*` then `_eval`)."""
    transforms_cfg = (cfg or {}).get("transforms", {})
    names = list(transforms_cfg.get("*", [])) + list(transforms_cfg.get("_eval", []))
    out = []
    for name in names:
        if name == "utterance_cmvn":
            c = cfg.get("utterance_cmvn", {})
            out.append(UtteranceCMVN(c.get("norm_means", True), c.get("norm_vars", True)))
        elif name == "global_cmvn":
            out.append(GlobalCMVN(cfg["global_cmvn"]["stats_npz_path"]))
        else:
            raise NotImplementedError(f"feature transform {name!r} is not ported")
    return out
