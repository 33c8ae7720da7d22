"""Vocoder loading and WAV writing for the port's S2ST CLI.

The port's copy of diffnorm_tpu/cli/generate_waveform.py:write_wav, and a
`load_vocoder` that reads the vocoder as a `.npz` written by
`weights.save_npz` (its JAX variables tree) plus its config JSON. The
standalone unit-file CLI of that module is not ported.
"""

from __future__ import annotations

import json
import wave

import numpy as np
import torch

from diffnorm_tpu_torch.device import resolve_device
from diffnorm_tpu_torch.models.hifigan import CodeHiFiGANVocoder
from diffnorm_tpu_torch.weights import as_variables, load_npz


def write_wav(path: str, wav: np.ndarray, sample_rate: int = 16000) -> None:
    """16-bit PCM mono, clipped to [-1, 1]."""
    wav = np.clip(np.asarray(wav, np.float32), -1.0, 1.0)
    pcm = (wav * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.tobytes())


def load_vocoder(npz_path: str, cfg_path: str, device="cuda",
                 dtype: torch.dtype = torch.float32) -> CodeHiFiGANVocoder:
    """The code-HiFi-GAN of config `cfg_path` with the weights of
    `npz_path` ({"params": ...} or a bare params tree), on `device`: the
    card unless `device="cpu"` is asked for (raises without CUDA)."""
    device = resolve_device(device)
    with open(cfg_path) as f:
        cfg = json.load(f)
    variables = as_variables(load_npz(npz_path))
    return CodeHiFiGANVocoder.from_config(cfg, variables, device=device, dtype=dtype)
