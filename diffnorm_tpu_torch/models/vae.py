"""Speech VAE: WaveNet down-stack -> diagonal Gaussian latent -> WaveNet
up-stack -> Transformer decoder -> unit LM head.

Counterpart of diffnorm_tpu/models/vae.py: encode, decode and the training
forward with its masked KL. Channel multipliers per latent size:
16 -> [4, 3, 2], 32 -> [4, 3], 128 -> [3].
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from diffnorm_tpu_torch.models.layers import ConditionableTransformer, Dense
from diffnorm_tpu_torch.models.wavenet import Wavenet
from diffnorm_tpu_torch.parallel.mesh import draw_rows

CHAN_MULTS = {16: [4, 3, 2], 32: [4, 3], 128: [3]}


def gaussian_sample(params2c: torch.Tensor, noise: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None):
    """params2c [..., 2C] (mean ++ logvar) -> (z, mean, logvar), logvar
    clipped to [-30, 20]. `noise` is the injected eps; without it eps is
    drawn from `generator`."""
    mean, logvar = params2c.chunk(2, dim=-1)
    logvar = torch.clamp(logvar, -30.0, 20.0)
    std = torch.exp(0.5 * logvar)
    if noise is None:  # drawn over the global batch under a data-parallel split
        eps = draw_rows(lambda n: torch.randn((n,) + tuple(mean.shape[1:]), generator=generator,
                                              device=mean.device, dtype=mean.dtype),
                        mean.shape[0])
    else:
        eps = torch.as_tensor(noise, device=mean.device).to(mean.dtype)
    return mean + std * eps, mean, logvar


def gaussian_kl_masked(mean: torch.Tensor, logvar: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """Per-sequence KL to N(0, I) (reference kl_3d): padded frames zeroed,
    then 0.5 * the mean over (T, C), zeros included. mask [B, T] True =
    valid. Returns [B]."""
    kl = mean.square() + torch.exp(logvar) - 1.0 - logvar
    kl = torch.where(mask[..., None], kl, torch.zeros((), dtype=kl.dtype, device=kl.device))
    return 0.5 * kl.mean(dim=(1, 2))


class SpeechVAEModule(nn.Module):
    """`dropout` is the decoder transformer's attention dropout in a
    training forward."""

    def __init__(self, dim: int = 768, latent_dim: int = 128,
                 vocab_size: int = 1004, decoder_depth: int = 6,
                 decoder_dim_head: int = 96, decoder_heads: int = 8,
                 chan_mults: Optional[Sequence[int]] = None, dropout: float = 0.0):
        super().__init__()
        mults = list(chan_mults) if chan_mults is not None else CHAN_MULTS[latent_dim]
        cur = dim
        for i, m in enumerate(mults):
            self.add_module(f"enc_wave_{i}",
                            Wavenet(cur, cur // m, stacks=2, layers=3))
            cur //= m
        # cur == 2 * latent_dim; the decoder starts from the latent itself
        in_dim = latent_dim
        for i, m in enumerate(reversed(mults)):
            self.add_module(f"dec_wave_{i}",
                            Wavenet(in_dim, cur * m, stacks=2, layers=3))
            cur = in_dim = cur * m
        self.n_waves = len(mults)
        self.decoder_tf = ConditionableTransformer(
            dim, decoder_depth, dim_head=decoder_dim_head, heads=decoder_heads,
            ff_mult=4, ff_causal_conv=True, dropout=dropout)
        self.decoder_lm = Dense(dim, vocab_size)

    def encode_params(self, feature: torch.Tensor) -> torch.Tensor:
        """feature [B, T, dim] -> Gaussian parameters [B, T, 2 * latent]."""
        x = feature
        for i in range(self.n_waves):
            x = getattr(self, f"enc_wave_{i}")(x)
        return x

    def encode(self, feature, noise=None, generator=None) -> torch.Tensor:
        """Sampled latent [B, T, latent]."""
        z, _, _ = gaussian_sample(self.encode_params(feature), noise, generator)
        return z

    def decode(self, latent: torch.Tensor,
               mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """latent [B, T, latent], mask [B, T] True = valid ->
        (decoded feature [B, T, dim], LM logits [B, T, vocab])."""
        x = latent
        for i in range(self.n_waves):
            x = getattr(self, f"dec_wave_{i}")(x)
        feat = self.decoder_tf(x, mask=mask)
        return feat, self.decoder_lm(feat)

    def forward(self, feature: torch.Tensor, mask: torch.Tensor, noise=None,
                generator: Optional[torch.Generator] = None):
        """Training forward (vae.py:122-132): feature [B, T, dim], mask
        [B, T] -> (decoded feature, LM logits, KL per sequence [B]).
        `noise` injects the posterior eps; otherwise it is drawn from
        `generator`."""
        z, mean, logvar = gaussian_sample(self.encode_params(feature), noise, generator)
        feat, logits = self.decode(z, mask)
        return feat, logits, gaussian_kl_masked(mean, logvar, mask)
