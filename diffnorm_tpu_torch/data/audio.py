"""Audio front end and feature transforms of the S2ST data (the port's copy
of diffnorm_tpu/data/audio.py).

The filterbank is a kaldi-style log-mel: 25 ms Povey-windowed frames at
10 ms shift, 80 mel bins, snip_edges, in numpy on the host (the data loader).
Sources are `.npy` fbank dumps or audio files read by `read_audio` (16-bit or
32-bit PCM WAV through the standard library's `wave`, or soundfile where it
is installed). The transforms of a data config's `transforms` block:
utterance and global CMVN, SpecAugment (train splits, drawing from the
dataset's numpy generator in JAX's order) and delta-deltas.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np


# ---------------------------------------------------------------- fbank ----

def _mel(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


def mel_filterbank(num_bins: int, fft_size: int, sample_rate: int,
                   low_freq: float = 20.0, high_freq: Optional[float] = None) -> np.ndarray:
    """[num_bins, fft_size // 2 + 1] triangular mel filters (kaldi-style)."""
    high_freq = high_freq or sample_rate / 2
    n_fft_bins = fft_size // 2 + 1
    fft_freqs = np.arange(n_fft_bins) * sample_rate / fft_size
    mel_points = np.linspace(_mel(low_freq), _mel(high_freq), num_bins + 2)
    mel_fft = _mel(fft_freqs)
    fb = np.zeros((num_bins, n_fft_bins), dtype=np.float32)
    for i in range(num_bins):
        left, center, right = mel_points[i], mel_points[i + 1], mel_points[i + 2]
        up = (mel_fft - left) / (center - left)
        down = (right - mel_fft) / (right - center)
        fb[i] = np.maximum(0.0, np.minimum(up, down))
    return fb


def povey_window(n: int) -> np.ndarray:
    return (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / (n - 1))) ** 0.85


_FBANK_CACHE: Dict = {}


def logmel_fbank(waveform: np.ndarray, sample_rate: int = 16000, num_bins: int = 80,
                 frame_length_ms: float = 25.0, frame_shift_ms: float = 10.0,
                 preemphasis: float = 0.97) -> np.ndarray:
    """waveform [T] float (any scale) -> [frames, num_bins] float32 log-mel."""
    wav = np.asarray(waveform, dtype=np.float32)
    if wav.ndim > 1:
        wav = wav.mean(axis=0) if wav.shape[0] < wav.shape[-1] else wav.mean(axis=-1)
    win = int(sample_rate * frame_length_ms / 1000)
    shift = int(sample_rate * frame_shift_ms / 1000)
    fft_size = 1 << (win - 1).bit_length()
    n_frames = max(0, (len(wav) - win) // shift + 1)
    if n_frames == 0:
        return np.zeros((0, num_bins), dtype=np.float32)
    key = (num_bins, fft_size, sample_rate, win)
    if key not in _FBANK_CACHE:
        _FBANK_CACHE[key] = (mel_filterbank(num_bins, fft_size, sample_rate),
                             povey_window(win).astype(np.float32))
    fb, window = _FBANK_CACHE[key]
    idx = np.arange(win)[None, :] + shift * np.arange(n_frames)[:, None]
    frames = wav[idx]
    # per-frame DC removal, then preemphasis (kaldi order)
    frames = frames - frames.mean(axis=1, keepdims=True)
    pre = np.concatenate([frames[:, :1], frames[:, :-1]], axis=1)
    frames = (frames - preemphasis * pre) * window[None, :]
    spec = np.abs(np.fft.rfft(frames, n=fft_size, axis=1)) ** 2
    return np.log(np.maximum(spec @ fb.T, 1e-10)).astype(np.float32)


def read_audio(path: str):
    """(waveform [T] float32 in [-1, 1), sample rate): soundfile where it is
    installed, else a 16- or 32-bit PCM WAV through `wave` (channels
    averaged)."""
    try:
        import soundfile as sf

        wav, sr = sf.read(path, dtype="float32")
        return wav, sr
    except ImportError:
        import wave

        with wave.open(path, "rb") as w:
            sr, width, channels = w.getframerate(), w.getsampwidth(), w.getnchannels()
            raw = w.readframes(w.getnframes())
        if width == 2:
            wav = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
        elif width == 4:
            wav = np.frombuffer(raw, dtype=np.int32).astype(np.float32) / 2147483648.0
        else:
            raise ValueError(f"{path}: unsupported sample width {width}")
        if channels > 1:
            wav = wav.reshape(-1, channels).mean(axis=1)
        return wav, sr


def get_features_or_waveform(path: str, need_waveform: bool = False) -> np.ndarray:
    """Per-utterance features: a `.npy` dump as it is; an audio file through
    the fbank, or as its waveform where `need_waveform`."""
    if path.endswith(".npy"):
        return np.load(path)
    wav, sr = read_audio(path)
    return wav if need_waveform else logmel_fbank(wav, sample_rate=sr)


# ----------------------------------------------------- feature transforms --

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


class SpecAugment:
    """Frequency and time masking of a [T, F] feature matrix, drawing from
    the generator it is given exactly as JAX's does: exclusive-high widths,
    an offset drawn even for a zero-width mask, no time masks when the
    time budget is below one frame. Time warp (time_warp_W > 0) raises."""

    def __init__(self, time_warp_w: int = 0, freq_mask_n: int = 0, freq_mask_f: int = 0,
                 time_mask_n: int = 0, time_mask_t: int = 0, time_mask_p: float = 0.0,
                 mask_value: Optional[float] = None):
        if time_warp_w > 0:
            raise NotImplementedError("SpecAugment time warp (time_warp_W > 0) is not ported")
        if freq_mask_n > 0 and freq_mask_f <= 0:
            raise ValueError("SpecAugment: freq_mask_F must be > 0 with frequency masks")
        if time_mask_n > 0 and time_mask_t <= 0:
            raise ValueError("SpecAugment: time_mask_T must be > 0 with time masks")
        self.freq_mask_n, self.freq_mask_f = freq_mask_n, freq_mask_f
        self.time_mask_n, self.time_mask_t = time_mask_n, time_mask_t
        self.time_mask_p = time_mask_p
        self.mask_value = mask_value

    def __call__(self, x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        t, f = x.shape
        if t == 0 or f < self.freq_mask_f:
            return x
        x = x.copy()
        mask_value = x.mean() if self.mask_value is None else self.mask_value
        for _ in range(self.freq_mask_n):
            w = int(rng.integers(0, self.freq_mask_f))
            f0 = int(rng.integers(0, f - w))
            if w != 0:
                x[:, f0:f0 + w] = mask_value
        max_t = min(self.time_mask_t, math.floor(t * self.time_mask_p))
        if max_t < 1:
            return x
        for _ in range(self.time_mask_n):
            w = int(rng.integers(0, max_t))
            t0 = int(rng.integers(0, t - w))
            if w != 0:
                x[t0:t0 + w, :] = mask_value
        return x


class DeltaDeltas:
    """Append delta and delta-delta features over a half-window of `win`
    frames (edges repeated)."""

    def __init__(self, win: int = 2):
        self.win = win

    def _delta(self, feat: np.ndarray) -> np.ndarray:
        w, n = self.win, feat.shape[0]
        padded = np.pad(feat, ((w, w), (0, 0)), mode="edge")
        num = sum(k * (padded[w + k:w + k + n] - padded[w - k:w - k + n])
                  for k in range(1, w + 1))
        return num / (2 * sum(k ** 2 for k in range(1, w + 1)))

    def __call__(self, x: np.ndarray) -> np.ndarray:
        d1 = self._delta(x)
        return np.concatenate([x, d1, self._delta(d1)], axis=1).astype(np.float32)


def build_feature_transforms(cfg: dict, is_train: bool) -> List:
    """The transforms of a data config's `transforms` block: `*`, then
    `_train` or `_eval`."""
    transforms_cfg = (cfg or {}).get("transforms", {})
    names = list(transforms_cfg.get("*", []))
    names += list(transforms_cfg.get("_train" if is_train else "_eval", []))
    out = []
    for name in names:
        if name == "utterance_cmvn":
            c = cfg.get("utterance_cmvn", {})
            out.append(UtteranceCMVN(c.get("norm_means", True), c.get("norm_vars", True)))
        elif name == "specaugment":
            # a bare `specaugment:` block is all zeros, a no-op, as in JAX
            c = cfg.get("specaugment", {})
            out.append(SpecAugment(
                time_warp_w=c.get("time_warp_W", 0), freq_mask_n=c.get("freq_mask_N", 0),
                freq_mask_f=c.get("freq_mask_F", 0), time_mask_n=c.get("time_mask_N", 0),
                time_mask_t=c.get("time_mask_T", 0), time_mask_p=c.get("time_mask_p", 0.0),
                mask_value=c.get("mask_value")))
        elif name == "global_cmvn":
            out.append(GlobalCMVN(cfg["global_cmvn"]["stats_npz_path"]))
        elif name == "delta_deltas":
            # win_length is the full tap count (torchaudio's compute_deltas)
            wl = (cfg.get("delta_deltas") or {}).get("win_length", 5)
            out.append(DeltaDeltas(win=(wl - 1) // 2))
        else:
            raise ValueError(f"unknown feature transform: {name}")
    return out
