"""TranSpeech's baseline speech and speaker normalization (the port of
diffnorm_tpu/ops/speech_norm.py; reference research/TranSpeech/hubertCTC/
gen_SN.py, functions/yin.py and Resample.py:InterpLnr), the normalization
DiffNorm's diffusion normalizer replaces.

* The YIN pitch tracker runs on the device, in float32, as JAX forms it:
  framing, the difference function from the cumulative energy and an rFFT
  autocorrelation at nfft = the next power of two of W + tau_max, the
  cumulative-mean-normalized difference (CMNDF), the lag pick (the first
  sub-threshold dip, then the local minimum that follows it, else the
  CMNDF's argmin), a voiced gate on the frame's RMS and a parabolic
  refinement of the lag. `pitch_median` takes an utterance's median voiced
  f0 from it.
* The waveform work runs on the host in numpy, as JAX's does, because its
  output lengths are ragged: the pitch shift (a linear resample, then a
  phase-vocoder time stretch back to the utterance's length), the energy
  normalization to a target mean |x| and InterpLnr's random segment-wise
  resampling, whose draws come from a `np.random.Generator` in JAX's order.

`pitch_shift` takes praat's "Change gender" (formant-preserving) where
`parselmouth` imports, as JAX's does; neither the CPU test machine nor the
GPU machine has it, so the phase-vocoder path is the one both run.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import numpy as np
import torch

from diffnorm_tpu_torch.device import resolve_device

# ------------------------------------------------------------------ YIN ---


def _frame(x: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """[T] -> [N, frame_length] strided frames (the tail truncated; a
    signal shorter than a frame repeats its last sample, as JAX's clamped
    gather does)."""
    n = 1 + max(0, x.shape[-1] - frame_length) // hop
    idx = (torch.arange(n, device=x.device)[:, None] * hop
           + torch.arange(frame_length, device=x.device)[None, :])
    return x[idx.clamp(max=x.shape[-1] - 1)]


def yin_difference(frames: torch.Tensor, tau_max: int) -> torch.Tensor:
    """YIN's difference function d(tau) = sum_j (x_j - x_{j+tau})^2 over
    the trailing axis, from the cumulative energy and the rFFT
    autocorrelation. frames [..., W] -> [..., tau_max]."""
    w = frames.shape[-1]
    tau_max = min(tau_max, w)
    frames = frames.float()
    sq = frames * frames
    zero = torch.zeros(frames.shape[:-1] + (1,), dtype=torch.float32, device=frames.device)
    cum = torch.cat([zero, torch.cumsum(sq, -1)], -1)  # [..., W+1]
    nfft = 1 << (w + tau_max - 1).bit_length()
    fc = torch.fft.rfft(frames, nfft)
    ac = torch.fft.irfft(fc * torch.conj(fc), nfft)[..., :tau_max]
    head = cum[..., w - torch.arange(tau_max, device=frames.device)]
    return head + cum[..., w:w + 1] - cum[..., :tau_max] - 2.0 * ac


def yin_cmndf(d: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """The cumulative-mean-normalized difference: cmndf(0) = 1,
    cmndf(tau) = d(tau) * tau / sum_{1..tau} d."""
    tau = torch.arange(1, d.shape[-1], dtype=torch.float32, device=d.device)
    cs = torch.cumsum(d[..., 1:], -1)
    body = d[..., 1:] * tau / (cs + eps)
    return torch.cat([torch.ones_like(d[..., :1]), body], -1)


def yin_pitch(wav: torch.Tensor, sr: int, frame_length: int = 2048, hop: int = 256,
              fmin: float = 75.0, fmax: float = 600.0, threshold: float = 0.15
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-frame YIN f0 of one waveform [T] on its device: (f0 [N], 0 where
    unvoiced; voiced [N] bool). The lag is the first tau in [sr/fmax,
    sr/fmin] whose CMNDF dips under `threshold`, moved on to the local
    minimum that follows (argmin where none dips), refined by a parabola
    through its neighbours; a frame is voiced iff it dips and its RMS
    exceeds 1e-5."""
    tau_min = max(2, int(sr / fmax))
    tau_max = min(int(sr / fmin) + 1, frame_length)
    frames = _frame(wav.float(), frame_length, hop)
    cmndf = yin_cmndf(yin_difference(frames, tau_max))  # [N, tau_max]

    lags = torch.arange(tau_max, device=cmndf.device)
    in_range = (lags >= tau_min) & (lags < tau_max)
    masked = torch.where(in_range, cmndf, torch.inf)
    below = masked < threshold
    # a silent frame's CMNDF is identically zero: gate on its energy
    rms = torch.sqrt(torch.mean(frames * frames, dim=-1))
    voiced = below.any(-1) & (rms > 1e-5)
    first_dip = torch.argmax(below.to(torch.uint8), dim=-1)
    fallback = torch.argmin(masked, dim=-1)
    # YIN takes the local minimum that follows the first threshold crossing
    nxt = torch.cat([cmndf[..., 1:], torch.full_like(cmndf[..., :1], torch.inf)], -1)
    follow = (nxt >= cmndf) & in_range & (lags >= first_dip[..., None])
    tau_voiced = torch.where(follow.any(-1), torch.argmax(follow.to(torch.uint8), dim=-1),
                             fallback)
    tau = torch.where(voiced, tau_voiced, fallback)  # [N]

    def gather(off: int) -> torch.Tensor:
        return torch.gather(cmndf, -1, (tau + off).clamp(0, tau_max - 1)[:, None])[:, 0]

    y0, y1, y2 = gather(-1), gather(0), gather(1)
    denom = y0 - 2.0 * y1 + y2
    delta = torch.where(denom.abs() > 1e-12,
                        0.5 * (y0 - y2) / torch.where(denom == 0, 1.0, denom), 0.0)
    delta = delta.clamp(-0.5, 0.5)
    f0 = sr / (tau.float() + delta)
    return torch.where(voiced, f0, 0.0), voiced


def pitch_median(wav: Union[np.ndarray, torch.Tensor], sr: int,
                 device: Union[str, torch.device] = "cuda", **kw) -> float:
    """The median voiced f0 of an utterance (gen_SN.py takes praat's median
    pitch quantile; this is YIN's), 0.0 where no frame is voiced. The
    tracker runs on `device` (the card unless "cpu" is asked for)."""
    x = torch.as_tensor(np.asarray(wav, np.float32), device=resolve_device(device))
    f0, voiced = yin_pitch(x, sr, **kw)
    f0 = f0[voiced].cpu().numpy()
    return float(np.median(f0)) if f0.size else 0.0


# --------------------------------------------- phase-vocoder pitch shift --


def _stft(x: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    win = np.hanning(n_fft).astype(np.float32)
    pad = n_fft // 2
    x = np.pad(x, (pad, pad))
    n = 1 + (len(x) - n_fft) // hop
    idx = np.arange(n)[:, None] * hop + np.arange(n_fft)[None, :]
    return np.fft.rfft(x[idx] * win, axis=-1)  # [N, F]


def _istft(S: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    win = np.hanning(n_fft).astype(np.float32)
    frames = np.fft.irfft(S, n_fft, axis=-1).real * win
    out_len = hop * (S.shape[0] - 1) + n_fft
    out = np.zeros(out_len, np.float32)
    norm = np.zeros(out_len, np.float32)
    wsq = win * win
    for i in range(S.shape[0]):
        out[i * hop:i * hop + n_fft] += frames[i]
        norm[i * hop:i * hop + n_fft] += wsq
    out = out / np.maximum(norm, 1e-8)
    pad = n_fft // 2
    return out[pad:-pad] if pad else out


def _phase_vocoder(S: np.ndarray, rate: float, hop: int) -> np.ndarray:
    """Stretch an STFT [N, F] to ~N/rate frames at constant pitch; the phase
    runs on in float64."""
    n, f = S.shape
    steps = np.arange(0, n - 1, rate)
    omega = 2.0 * math.pi * hop * np.arange(f) / ((f - 1) * 2)
    out = np.zeros((len(steps), f), np.complex128)
    phase = np.angle(S[0])
    for i, t in enumerate(steps):
        k = int(t)
        frac = t - k
        mag = (1.0 - frac) * np.abs(S[k]) + frac * np.abs(S[k + 1])
        out[i] = mag * np.exp(1j * phase)
        dphi = np.angle(S[k + 1]) - np.angle(S[k]) - omega
        dphi -= 2.0 * math.pi * np.round(dphi / (2.0 * math.pi))
        phase = phase + omega + dphi
    return out


def _linear_resample(x: np.ndarray, out_len: int) -> np.ndarray:
    pos = np.linspace(0.0, len(x) - 1.0, out_len)
    lo = np.floor(pos).astype(int)
    hi = np.minimum(lo + 1, len(x) - 1)
    lam = (pos - lo).astype(np.float32)
    return (1.0 - lam) * x[lo] + lam * x[hi]


def pitch_shift(wav: np.ndarray, sr: int, ratio: float, n_fft: int = 1024,
                hop: int = 256) -> np.ndarray:
    """Every frequency times `ratio` at the same duration: resample to
    T / ratio, then time-stretch back with the phase vocoder. The reference
    (functional.py:369-382) calls praat's "Change gender", which also keeps
    the formants; that path runs where `parselmouth` imports (on neither
    machine this repository runs on)."""
    wav = np.asarray(wav, np.float32)
    if abs(ratio - 1.0) < 1e-4 or len(wav) < n_fft * 2:
        return wav
    try:
        import parselmouth

        sound = parselmouth.Sound(wav.astype(np.float64), sampling_frequency=sr)
        pitch = parselmouth.praat.call(sound, "To Pitch", 0.8 / 75, 75, 600)
        median = parselmouth.praat.call(pitch, "Get quantile", 0.0, 0.0, 0.5, "Hertz")
        new = parselmouth.praat.call((sound, pitch), "Change gender", 1.0, median * ratio,
                                     1.0, 1.0)
        return np.asarray(new.values, np.float32).squeeze(0)
    except ImportError:
        pass
    squeezed = _linear_resample(wav, max(int(round(len(wav) / ratio)), n_fft * 2))
    S = _stft(squeezed, n_fft, hop)
    stretched = _phase_vocoder(S, rate=len(squeezed) / len(wav), hop=hop)
    out = _istft(stretched, n_fft, hop)
    return _linear_resample(out, len(wav))


def shift_to_median(wav: np.ndarray, sr: int, new_median: float,
                    device: Union[str, torch.device] = "cuda") -> np.ndarray:
    """The reference's `manipulate_median`: shift the utterance so that its
    median f0 (YIN on `device`) lands on `new_median`."""
    med = pitch_median(wav, sr, device=device)
    if med <= 0 or new_median <= 0:
        return np.asarray(wav, np.float32)
    return pitch_shift(wav, sr, new_median / med)


# ------------------------------------------------------------ energy norm --


def mean_abs_energy(wav: np.ndarray) -> float:
    """gen_SN.py's energy of an utterance: mean |x|."""
    return float(np.mean(np.abs(np.asarray(wav, np.float32))))


def normalize_energy(wav: np.ndarray, target: float) -> np.ndarray:
    """The utterance scaled to mean |x| = target (gen_SN.py:46-51)."""
    wav = np.asarray(wav, np.float32)
    e = np.mean(np.abs(wav))
    return wav if e < 1e-8 else wav / e * target


# --------------------------------------------------- rhythm perturbation --


def random_segment_resample(x: np.ndarray, len_seq: Optional[int], rng: np.random.Generator,
                            min_len_seg: int = 19, max_len_seg: int = 32) -> np.ndarray:
    """InterpLnr's rhythm perturbation (reference Resample.py:352-432): the
    first `len_seq` frames of x [T, C] cut into segments of a random length
    in [min_len_seg, max_len_seg), each linearly resampled by a random
    scale in [0.5, 1.5) and laid end to end, each cut at the last
    interpolation pair inside the sequence (index < len_seq - 1). Draws
    from `rng` in JAX's order: a segment's length, then its scale."""
    x = np.asarray(x)
    if x.ndim == 1:
        x = x[:, None]
    len_seq = x.shape[0] if len_seq is None else int(len_seq)
    out = []
    offset = 0
    while offset < len_seq - 1:
        seg_len = int(rng.integers(min_len_seg, max_len_seg))
        scale = float(rng.random()) + 0.5
        idx = np.arange(2 * max_len_seg, dtype=np.float64) / scale
        fl = np.floor(idx).astype(int)
        keep = (fl < seg_len - 1) & (fl + offset < len_seq - 1)
        if keep.any():
            f = fl[keep] + offset
            lam = (idx - np.floor(idx))[keep][:, None].astype(x.dtype)
            out.append((1.0 - lam) * x[f] + lam * x[f + 1])
        offset += seg_len
    if not out:
        return x[:1]
    return np.concatenate(out, 0)
