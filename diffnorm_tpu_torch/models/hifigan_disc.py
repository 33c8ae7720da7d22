"""HiFi-GAN discriminators and GAN losses for the code-HiFi-GAN fine-tune
(counterpart of diffnorm_tpu/models/hifigan_disc.py; reference
research/TranSpeech/hifigan/models.py:128-283):

  MultiPeriodDiscriminator: per period p (2, 3, 5, 7, 11) the waveform,
  reflect-padded to a multiple of p, folded into [B, 1, T/p, p]; four (5, 1)
  convs of stride (3, 1) and one of stride 1, leaky ReLU 0.1, a (3, 1)
  conv_post
  MultiScaleDiscriminator: 3 scales of seven grouped 1-D convs and a
  conv_post, the waveform average-pooled (k 4, stride 2, zero pad 2 counted
  in the mean) between scales
  LSGAN losses and the L1 feature matching, reduced in float32

Names follow the flax tree (`mpd/period_2/conv_0/kernel` is
`mpd.period_2.conv_0.weight`); `weights.from_jax_variables` permutes flax's
[kh, kw, in, out] and [k, in / groups, out] kernels. Neither JAX nor the
reference fine-tune here applies weight or spectral norm. Parameters are
float32; `dtype` is the type the convs compute in (bf16 for --bf16-disc),
as flax's Conv(dtype=...) casts inputs, kernel and bias. Each
discriminator takes the real and the fake waveforms as one batch: the convs
act on each row alone, so this is JAX's two calls in one. Feature maps are
[B, C, H, W] (MPD) and [B, C, T] (MSD), the transposes of JAX's.
"""

from __future__ import annotations

from math import gcd
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

LRELU_SLOPE = 0.1
PERIOD_CHANNELS = (32, 128, 512, 1024)
# (channels, kernel, stride, groups) of the scale discriminator's convs
SCALE_SPECS = ((128, 15, 1, 1), (128, 41, 2, 4), (256, 41, 2, 16), (512, 41, 4, 16),
               (1024, 41, 4, 16), (1024, 41, 1, 16), (1024, 5, 1, 1))

Scores = Tuple[torch.Tensor, List[torch.Tensor]]


def _conv(conv: nn.Module, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`conv` (an nn.Conv1d or nn.Conv2d) in `dtype`: input, weight and bias
    cast for the product, the parameters kept float32."""
    return conv._conv_forward(x.to(dtype), conv.weight.to(dtype), conv.bias.to(dtype))


class PeriodDiscriminator(nn.Module):
    """width=1 is the reference topology (channels 32/128/512/1024); smaller
    widths keep the layer structure."""

    def __init__(self, period: int, width: float = 1.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.period, self.dtype = period, dtype
        chans = [max(4, int(c * width)) for c in PERIOD_CHANNELS]
        c_in = 1
        for i, ch in enumerate(chans):
            self.add_module(f"conv_{i}", nn.Conv2d(c_in, ch, (5, 1), (3, 1), padding=(2, 0)))
            c_in = ch
        self.conv_4 = nn.Conv2d(c_in, c_in, (5, 1), padding=(2, 0))
        self.conv_post = nn.Conv2d(c_in, 1, (3, 1), padding=(1, 0))
        self.n_convs = len(chans) + 1

    def forward(self, wav: torch.Tensor) -> Scores:
        """wav [B, T] -> (score [B, n], feature maps)."""
        b, t = wav.shape
        p = self.period
        pad = (p - t % p) % p
        if pad:
            wav = F.pad(wav[:, None], (0, pad), mode="reflect" if t > 1 else "constant")[:, 0]
        x = wav.reshape(b, 1, -1, p)
        fmaps = []
        for i in range(self.n_convs):
            x = F.leaky_relu(_conv(getattr(self, f"conv_{i}"), x, self.dtype), LRELU_SLOPE)
            fmaps.append(x)
        x = _conv(self.conv_post, x, self.dtype)
        fmaps.append(x)
        return x.reshape(b, -1), fmaps


def scale_specs(width: float) -> List[Tuple[int, int, int, int]]:
    """SCALE_SPECS at `width`: where width != 1 the output channels round up
    to the lcm of the layer's own groups and the next layer's (JAX
    hifigan_disc.py:74-88), so every grouped conv divides its channels."""
    if width == 1.0:
        return list(SCALE_SPECS)
    scaled = []
    for i, (c, k, s, g) in enumerate(SCALE_SPECS):
        ng = SCALE_SPECS[i + 1][3] if i + 1 < len(SCALE_SPECS) else 1
        mult = g * ng // gcd(g, ng)
        ch = max(int(c * width), mult)
        scaled.append((((ch + mult - 1) // mult) * mult, k, s, g))
    return scaled


class ScaleDiscriminator(nn.Module):
    def __init__(self, width: float = 1.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        specs = scale_specs(width)
        c_in = 1
        for i, (ch, k, s, g) in enumerate(specs):
            self.add_module(f"conv_{i}", nn.Conv1d(c_in, ch, k, s, padding=k // 2, groups=g))
            c_in = ch
        self.conv_post = nn.Conv1d(c_in, 1, 3, padding=1)
        self.n_convs = len(specs)

    def forward(self, wav: torch.Tensor) -> Scores:
        """wav [B, T] -> (score [B, n], feature maps)."""
        x = wav[:, None]
        fmaps = []
        for i in range(self.n_convs):
            x = F.leaky_relu(_conv(getattr(self, f"conv_{i}"), x, self.dtype), LRELU_SLOPE)
            fmaps.append(x)
        x = _conv(self.conv_post, x, self.dtype)
        fmaps.append(x)
        return x.reshape(wav.shape[0], -1), fmaps


def avg_pool1d(x: torch.Tensor, k: int = 4, stride: int = 2) -> torch.Tensor:
    """[B, T] -> [B, T // stride + 1]: the mean over k samples with k // 2
    zeros on each side counted in it."""
    return F.avg_pool1d(x[:, None], k, stride, padding=k // 2, count_include_pad=True)[:, 0]


def _real_and_fake(d: nn.Module, both: torch.Tensor, b: int) -> Tuple[Scores, Scores]:
    score, fmaps = d(both)
    return (score[:b], [f[:b] for f in fmaps]), (score[b:], [f[b:] for f in fmaps])


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11), width: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.periods = tuple(periods)
        for p in self.periods:
            self.add_module(f"period_{p}", PeriodDiscriminator(p, width, dtype))

    def forward(self, real: torch.Tensor, fake: torch.Tensor) -> List[Tuple[Scores, Scores]]:
        """[((real score, real maps), (fake score, fake maps))] per period."""
        both = torch.cat([real, fake])
        return [_real_and_fake(getattr(self, f"period_{p}"), both, real.shape[0])
                for p in self.periods]


class MultiScaleDiscriminator(nn.Module):
    def __init__(self, scales: int = 3, width: float = 1.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.scales = scales
        for s in range(scales):
            self.add_module(f"scale_{s}", ScaleDiscriminator(width, dtype))

    def forward(self, real: torch.Tensor, fake: torch.Tensor) -> List[Tuple[Scores, Scores]]:
        """[((real score, real maps), (fake score, fake maps))] per scale."""
        both, outs = torch.cat([real, fake]), []
        for s in range(self.scales):
            outs.append(_real_and_fake(getattr(self, f"scale_{s}"), both, real.shape[0]))
            if s < self.scales - 1:
                both = avg_pool1d(both)
        return outs


# ------------------------------------------------------------- losses

def discriminator_loss(outs) -> torch.Tensor:
    """LSGAN: (1 - D(real))^2 + D(fake)^2, each a mean, summed over the
    discriminators, in float32."""
    loss = 0.0
    for (real_score, _), (fake_score, _) in outs:
        loss = loss + torch.mean((1.0 - real_score.float()) ** 2)
        loss = loss + torch.mean(fake_score.float() ** 2)
    return loss


def generator_adv_loss(outs) -> torch.Tensor:
    """LSGAN generator side: (1 - D(fake))^2."""
    loss = 0.0
    for _, (fake_score, _) in outs:
        loss = loss + torch.mean((1.0 - fake_score.float()) ** 2)
    return loss


def feature_matching_loss(outs) -> torch.Tensor:
    """L1 between the real and fake feature maps, a mean per map."""
    loss = 0.0
    for (_, real_maps), (_, fake_maps) in outs:
        for r, f in zip(real_maps, fake_maps):
            loss = loss + torch.mean(torch.abs(r.float() - f.float()))
    return loss
