"""Log-mel spectrogram of a waveform batch, differentiable (counterpart of
diffnorm_tpu/ops/mel.py), for the code-HiFi-GAN's mel L1 loss.

HiFi-GAN's convention: reflect padding by (n_fft - hop) / 2 on each side,
frames of `win` samples every `hop` (no centring), the periodic Hann window
np.hanning(win + 1)[:-1], |rfft| at n_fft points, a Slaney mel filterbank
with Slaney normalization (librosa's default, HiFi-GAN's meldataset), then
log(clamp(mel, 1e-5)). The frames are explicit strided views, as JAX
gathers them, so the framing is JAX's to the sample.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=8)
def _mel_matrix(num_mels: int, n_fft: int, sample_rate: int,
                fmin: float, fmax: float) -> np.ndarray:
    """Slaney-style mel filterbank [n_fft//2+1, num_mels] (librosa default
    used by HiFi-GAN's meldataset)."""
    def hz_to_mel(f):
        # Slaney scale: linear below 1 kHz, log above
        f = np.asarray(f, dtype=np.float64)
        mel = f / (200.0 / 3)
        log_region = f >= 1000.0
        return np.where(
            log_region,
            15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0),
            mel,
        )

    def mel_to_hz(m):
        m = np.asarray(m, dtype=np.float64)
        f = m * (200.0 / 3)
        log_region = m >= 15.0
        return np.where(log_region, 1000.0 * np.exp((m - 15.0) * np.log(6.4) / 27.0), f)

    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0, sample_rate / 2, n_bins)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), num_mels + 2))
    weights = np.zeros((n_bins, num_mels), dtype=np.float32)
    for i in range(num_mels):
        lower, center, upper = mel_pts[i], mel_pts[i + 1], mel_pts[i + 2]
        up = (fft_freqs - lower) / max(center - lower, 1e-10)
        down = (upper - fft_freqs) / max(upper - center, 1e-10)
        w = np.maximum(0.0, np.minimum(up, down))
        # Slaney normalization
        weights[:, i] = w * (2.0 / (upper - lower))
    return weights


@functools.lru_cache(maxsize=8)
def _constants(win: int, num_mels: int, n_fft: int, sample_rate: int, fmin: float,
               fmax: float, device: torch.device):
    """(periodic Hann window [win], mel filterbank [n_fft//2+1, num_mels])
    on `device`, copied there once."""
    window = torch.from_numpy(np.hanning(win + 1)[:-1].astype(np.float32))
    mel_w = torch.from_numpy(_mel_matrix(num_mels, n_fft, sample_rate, fmin, fmax))
    return window.to(device), mel_w.to(device)


def mel_spectrogram(wav: torch.Tensor, n_fft: int = 1024, hop: int = 256, win: int = 1024,
                    num_mels: int = 80, sample_rate: int = 16000, fmin: float = 0.0,
                    fmax: Optional[float] = None) -> torch.Tensor:
    """wav [B, T] float32 -> log-mel [B, frames, num_mels], frames = 1 +
    (T + 2 * ((n_fft - hop) // 2) - win) // hop."""
    fmax = fmax or sample_rate / 2
    assert wav.shape[1] + (n_fft - hop) >= win, (
        f"waveform too short for mel window: {wav.shape[1]} samples, "
        f"win={win} hop={hop}")
    pad = (n_fft - hop) // 2
    x = F.pad(wav[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(1, win, hop)  # [B, frames, win], views of x
    window, mel_w = _constants(win, num_mels, n_fft, sample_rate, fmin, fmax, wav.device)
    spec = torch.fft.rfft(frames * window, n=n_fft, dim=-1).abs()
    mel = spec @ mel_w
    return torch.log(torch.clamp(mel, min=1e-5))
