"""FastSpeech2, non-autoregressive TTS (the port of
diffnorm_tpu/models/fastspeech2.py; reference
fairseq/models/text_to_speech/fastspeech2.py and speech_generator.py's
NonAutoregressiveSpeechGenerator).

The `TextEncoder` over the tokens (`models/cmlm_text.py`); three
`VariancePredictor`s (`models/hifigan.py`) for log(1 + duration), pitch and
energy; pitch and energy, given or predicted, quantized into 256 bins over
[-4, 4] (`quantize`: truncated toward zero, then clipped, as JAX's
astype(int32)) and their embeddings added; durations, given or predicted
as max(round(exp(log_dur) - 1), 0) (round half to even, as jnp.round),
zero at pad; `length_regulate` expands the states to a fixed buffer of
`max_frames` frames (`max_target_positions`, 2048 by default), whatever the
utterance's length; sinusoidal frame positions keyed on the frame mask with
padding_idx 0 (not PAD); `decoder_layers` TextEncoderLayers under the frame
mask; `mel_head`; and its own postnet: 5 convolutions of kernel 5 and 256
channels (the last `n_mels`), tanh on the first four, no BatchNorm, added
as a residual.

The decoder's self-attention attends the whole buffer, Tq = Tk =
`max_frames`, with the frame mask: on the card, in eval (no attention
dropout), each of the decoder layers' calls takes the flash-attention
kernel (`ops.attention.masked_attention`), [B, heads, 2048, dim / heads] =
[B, 2, 2048, 128] at fastspeech2_base's widths; float32 (the default
dtype) takes the three-pass tf32 kernel, bf16 the wgmma one. Training drops
attention probabilities, which keeps it on the module math, as JAX keeps
dropout off its kernel.

As in JAX, the model's dropout is 0.1 whatever --dropout says (its
build_model passes none), and the variance predictors' hidden width 256.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from diffnorm_tpu_torch.models.cmlm_text import TextEncoder, TextEncoderLayer
from diffnorm_tpu_torch.models.conformer import Conv1d
from diffnorm_tpu_torch.models.hifigan import VariancePredictor
from diffnorm_tpu_torch.models.layers import Dense, arch_default, sinusoidal_positions

PAD = 1
N_BINS = 256


def length_regulate(x: torch.Tensor, durations: torch.Tensor, max_frames: int):
    """Expand x [B, T, D] by integer durations [B, T] into ([B, max_frames,
    D], frame_mask [B, max_frames]): frame f takes x[t] where cum[t - 1] <= f
    < cum[t] (a token of duration 0 takes none); frames past a row's total
    take the state at its last position (S - 1) and are masked; a total
    above max_frames is cut."""
    cum = torch.cumsum(durations, dim=1)
    frames = torch.arange(max_frames, device=x.device)
    src_idx = (frames[None, :, None] >= cum[:, None, :]).sum(dim=-1)
    src_idx = torch.clamp(src_idx, max=x.shape[1] - 1)
    out = torch.gather(x, 1, src_idx[..., None].expand(-1, -1, x.shape[2]))
    return out, frames[None, :] < cum[:, -1:]


def quantize(value: torch.Tensor, lo: float = -4.0, hi: float = 4.0) -> torch.Tensor:
    """The bin of each value in N_BINS over [lo, hi], int32: truncated toward
    zero, then clipped (JAX's astype(int32) before jnp.clip)."""
    return torch.clamp(((value - lo) / (hi - lo) * N_BINS).to(torch.int32), 0, N_BINS - 1)


class FastSpeech2Module(nn.Module):
    """FastSpeech2 (module docstring); widths default to fastspeech2_base's."""

    def __init__(self, vocab_size: int, dim: int = 256, ffn_dim: int = 1024,
                 encoder_layers: int = 4, decoder_layers: int = 4, heads: int = 2,
                 n_mels: int = 80, max_frames: int = 2048, var_hidden: int = 256,
                 dropout: float = 0.1):
        super().__init__()
        self.dim, self.n_dec_layers, self.max_frames = dim, decoder_layers, max_frames
        self.encoder = TextEncoder(vocab_size, dim, ffn_dim, encoder_layers, heads, dropout)
        self.dur_predictor = VariancePredictor(dim, var_hidden)
        self.pitch_predictor = VariancePredictor(dim, var_hidden)
        self.energy_predictor = VariancePredictor(dim, var_hidden)
        self.pitch_emb = nn.Embedding(N_BINS, dim)
        self.energy_emb = nn.Embedding(N_BINS, dim)
        for i in range(decoder_layers):
            self.add_module(f"dec_layer_{i}", TextEncoderLayer(dim, ffn_dim, heads, dropout))
        self.mel_head = Dense(dim, n_mels)
        for i in range(5):
            self.add_module(f"postnet_{i}", Conv1d(n_mels if i == 0 else 256,
                                                   n_mels if i == 4 else 256, 5, padding=2))

    def forward(self, tokens: torch.Tensor, durations: Optional[torch.Tensor] = None,
                pitches: Optional[torch.Tensor] = None,
                energies: Optional[torch.Tensor] = None) -> Dict:
        """tokens [B, S]; durations [B, S] int (gold, else predicted), pitches
        and energies [B, S] (gold, else predicted). Returns {"mel",
        "mel_post" [B, max_frames, n_mels], "frame_mask" [B, max_frames],
        "log_dur", "pitch", "energy" [B, S]}."""
        enc, valid = self.encoder(tokens)
        log_dur = self.dur_predictor(enc)
        pitch = self.pitch_predictor(enc)
        energy = self.energy_predictor(enc)
        pitch_in = pitch if pitches is None else pitches
        energy_in = energy if energies is None else energies
        enc = enc + self.pitch_emb(quantize(pitch_in)).to(enc.dtype)
        enc = enc + self.energy_emb(quantize(energy_in)).to(enc.dtype)
        if durations is None:
            durations = torch.clamp(torch.round(torch.exp(log_dur) - 1.0).to(torch.int32),
                                    min=0)
        durations = torch.where(valid, durations, 0)
        x, frame_mask = length_regulate(enc, durations, self.max_frames)
        x = x + sinusoidal_positions(frame_mask, self.dim).to(x.dtype)
        for i in range(self.n_dec_layers):
            x = getattr(self, f"dec_layer_{i}")(x, frame_mask)
        mel = self.mel_head(x)
        h = mel
        for i in range(5):
            h = getattr(self, f"postnet_{i}")(h)
            if i < 4:
                h = torch.tanh(h)
        return {"mel": mel, "mel_post": mel + h, "frame_mask": frame_mask,
                "log_dur": log_dur, "pitch": pitch, "energy": energy}


def fastspeech2_arch(cfg: dict) -> None:
    """fastspeech2_base's defaults for the widths left None in `cfg` (JAX
    fastspeech2.py:165-170, and build_model's, :149-160); the frame buffer,
    `max_target_positions`, is left to the model's default (2048), as JAX
    leaves it, so the batches' size filter does not take it."""
    for key, value in (("encoder_embed_dim", 256), ("encoder_ffn_embed_dim", 1024),
                       ("encoder_layers", 4), ("decoder_layers", 4),
                       ("encoder_attention_heads", 2), ("output_frame_dim", 80)):
        arch_default(cfg, key, value)


ARCHS = {"fastspeech2": fastspeech2_arch, "fastspeech2_base": fastspeech2_arch}


class NonARSpeechGenerator:
    """fairseq's NonAutoregressiveSpeechGenerator: the FastSpeech2 forward
    with predicted variances in eval mode, and optionally a vocoder (frames
    [n, n_mels] -> samples) over each row's valid frames."""

    def __init__(self, model: FastSpeech2Module, vocoder=None):
        self.model, self.vocoder = model, vocoder

    @torch.no_grad()
    def generate(self, tokens: torch.Tensor) -> Dict:
        """{"feature" [B, max_frames, n_mels], "frame_mask" [B, max_frames]}
        as float32 / bool numpy, and "waveform" (one per row) with a
        vocoder."""
        out = self.model(tokens)
        result = {"feature": out["mel_post"].float().cpu().numpy(),
                  "frame_mask": out["frame_mask"].cpu().numpy()}
        if self.vocoder is not None:
            result["waveform"] = [self.vocoder(feat[mask]) for feat, mask
                                  in zip(result["feature"], result["frame_mask"])]
        return result
