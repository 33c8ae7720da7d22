"""Mel-cepstral distortion (MCD) between synthesized and reference audio
(the port's copy of diffnorm_tpu/eval/mcd.py; reference fairseq's
batch_mel_cepstral_distortion): mel cepstra from the log-mel fbank of
`data/audio.py` through a DCT-II, DTW alignment over frames, and
MCD = (10 sqrt(2) / ln 10) x the mean aligned euclidean distance over
cepstral dims 1..K. Host numpy; nothing on the eval path calls it."""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from diffnorm_tpu_torch.data.audio import logmel_fbank

MCD_CONST = 10.0 * math.sqrt(2.0) / math.log(10.0)


def mel_cepstra(wav: np.ndarray, sample_rate: int = 16000, num_mels: int = 80,
                num_ceps: int = 13) -> np.ndarray:
    """[T] waveform -> [frames, num_ceps] cepstra (c0 excluded)."""
    logmel = logmel_fbank(wav, sample_rate=sample_rate, num_bins=num_mels)
    n = logmel.shape[1]
    k = np.arange(num_ceps + 1)[:, None]
    m = np.arange(n)[None, :]
    basis = np.cos(np.pi * k * (2 * m + 1) / (2 * n)) * math.sqrt(2.0 / n)  # DCT-II
    return (logmel @ basis.T)[:, 1:]  # drop c0 (energy)


def dtw_distance(x: np.ndarray, y: np.ndarray) -> Tuple[float, int]:
    """DTW with euclidean local cost; returns (total cost, path length)."""
    tx, ty = len(x), len(y)
    dist = np.sqrt(((x[:, None, :] - y[None, :, :]) ** 2).sum(-1))  # [tx, ty]
    acc = np.full((tx + 1, ty + 1), np.inf)
    acc[0, 0] = 0.0
    for i in range(1, tx + 1):
        prev = np.minimum(acc[i - 1, 1:], acc[i - 1, :-1])  # up / diagonal neighbours
        row = np.empty(ty)
        left = np.inf
        for j in range(ty):  # the left neighbour forces the scan
            row[j] = dist[i - 1, j] + min(prev[j], left)
            left = row[j]
        acc[i, 1:] = row
    i, j, steps = tx, ty, 0  # the path length, by backtracking
    while i > 1 or j > 1:
        steps += 1
        choices = [(acc[i - 1, j - 1], i - 1, j - 1), (acc[i - 1, j], i - 1, j),
                   (acc[i, j - 1], i, j - 1)]
        _, i, j = min(choices, key=lambda c: c[0])
    return float(acc[tx, ty]), steps + 1


def mel_cepstral_distortion(wav_pred: np.ndarray, wav_ref: np.ndarray,
                            sample_rate: int = 16000) -> float:
    """MCD (dB) between two waveforms with DTW frame alignment."""
    cp = mel_cepstra(wav_pred, sample_rate)
    cr = mel_cepstra(wav_ref, sample_rate)
    if len(cp) == 0 or len(cr) == 0:
        return float("inf")
    cost, path_len = dtw_distance(cp, cr)
    return MCD_CONST * cost / max(path_len, 1)


def batch_mel_cepstral_distortion(preds, refs, sample_rate: int = 16000):
    """(mean MCD, per-pair MCDs) over pairs."""
    vals = [mel_cepstral_distortion(p, r, sample_rate) for p, r in zip(preds, refs)]
    return float(np.mean(vals)), vals
