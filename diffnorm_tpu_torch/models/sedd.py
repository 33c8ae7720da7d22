"""Score-entropy discrete diffusion (SEDD) over unit sequences (the port of
diffnorm_tpu/models/sedd.py; reference fairseq/models/score_entropy).

The absorbing graph with the log-linear noise schedule, the time-conditioned
transformer score network, the denoising score-entropy loss parts and the
analytic reverse sampler, with JAX's arithmetic:

* sigma(t) = -log1p(-(1 - eps) t), its derivative (1 - eps) / (1 - (1 - eps) t);
* the score network's raw logits are shifted by -log(expm1(sigma)) -
  log(V - 1) (`scale_by_sigma`) and the entry at the current token is 0;
* at absorbed positions, with r = 1 / expm1(sigma), the loss part is
  sum_{v < MASK} exp(s_v) - r s_{x0} + r (log r - 1), weighted by dsigma;
* a reverse step draws from staggered_score(exp(s), dsigma) *
  transp_transition(x, dsigma) by the Gumbel trick, the MASK column dropped
  on the last step.

The math functions run in float32 whatever the model's type, as in JAX.
`SEDDScoreModel` is the port's `ConditionableTransformer` with cond_dim =
4 dim, so each of its norms is a FiLM norm: on the card each goes through
the `rms_norm_film` kernel, and its self-attention (non-causal, key-padding
mask) through `flash_attention` once a sequence reaches 2048 units. The
FiLM projections follow sigma, which changes every step, so each score call
computes its own.

Every draw takes an explicit `torch.Generator` or is handed in: the times
and the perturbation's uniforms of a training forward (`t`, `u`), and the
Gumbel uniforms of each sampler step (`uniforms`), so a test can give both
packages the same numbers.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from diffnorm_tpu_torch.models.layers import (
    ConditionableTransformer,
    Dense,
    LearnedSinusoidalPosEmb,
    arch_default,
    sinusoidal_positions,
)
from diffnorm_tpu_torch.parallel.mesh import draw_rows

PAD, EOS, UNK = 1, 2, 3
NOISE_EPS = 1e-3  # the schedule's and the training times' eps


def loglinear_sigma(t: torch.Tensor, eps: float = NOISE_EPS):
    """(sigma(t), dsigma/dt) for t in (0, 1]."""
    sigma = -torch.log1p(-(1 - eps) * t)
    dsigma = (1 - eps) / (1 - (1 - eps) * t)
    return sigma, dsigma


def score_entropy_absorb(log_score: torch.Tensor, sigma: torch.Tensor, x_t: torch.Tensor,
                         x0: torch.Tensor, mask_id: int) -> torch.Tensor:
    """Per-position denoising score entropy [B, T], zero except where x_t
    is MASK. log_score [B, T, V + 1]; sigma [B]; x_t, x0 [B, T]."""
    ls = log_score.float()
    ratio = 1.0 / torch.expm1(sigma)[:, None]
    neg = ratio * ls.gather(-1, x0.long()[..., None])[..., 0]
    pos = torch.exp(ls[..., :-1]).sum(-1)
    const = ratio * (torch.log(ratio) - 1.0)
    return torch.where(x_t == mask_id, pos - neg + const, 0.0)


def staggered_score_absorb(score: torch.Tensor, dsigma: torch.Tensor) -> torch.Tensor:
    """e^{-dsigma E} on a score vector: scaled by exp(dsigma), and (1 -
    exp(dsigma)) * sum(score) added to the MASK column. score [B, T, V + 1]."""
    extra = (1.0 - torch.exp(dsigma)[:, None]) * score.sum(-1)
    out = score * torch.exp(dsigma[:, None, None])
    return torch.cat([out[..., :-1], out[..., -1:] + extra[..., None]], dim=-1)


def transp_transition_absorb(x: torch.Tensor, dsigma: torch.Tensor, dim: int) -> torch.Tensor:
    """Row x of exp(dsigma Q^T): exp(-dsigma) at the current token, plus
    1 - exp(-dsigma) in every column where x is MASK. x [B, T] -> [B, T, dim]."""
    stay = torch.where(x == dim - 1, -torch.expm1(-dsigma[:, None]), 0.0)
    edge = torch.exp(-dsigma[:, None, None]).expand(*x.shape, 1)
    return torch.zeros(*x.shape, dim, device=x.device).scatter(-1, x.long()[..., None],
                                                               edge) + stay[..., None]


def sample_categorical(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """argmax(probs / (1e-10 - log(u + 1e-10))): the Gumbel-trick draw over
    unnormalized probabilities, from uniforms `u` of probs' shape."""
    gumbel_norm = 1e-10 - torch.log(u + 1e-10)
    return (probs / gumbel_norm).argmax(-1)


def analytic_update_probs(log_score: torch.Tensor, x: torch.Tensor, dsigma: torch.Tensor,
                          mask_id: int, truncate: bool) -> torch.Tensor:
    """One analytic-predictor step's unnormalized probabilities, the MASK
    column zeroed where `truncate` (the last step)."""
    stag = staggered_score_absorb(torch.exp(log_score.float()), dsigma)
    probs = stag * transp_transition_absorb(x, dsigma, mask_id + 1)
    if truncate:
        probs = torch.cat([probs[..., :-1], torch.zeros_like(probs[..., -1:])], dim=-1)
    return probs


class SEDDScoreModel(nn.Module):
    """Log-scores [B, T, V] of (partly masked) tokens at noise level sigma;
    V counts the MASK state, the last index (JAX sedd.py:121-170)."""

    def __init__(self, vocab_size: int, dim: int = 512, depth: int = 8, heads: int = 8,
                 dim_head: int = 64, scale_by_sigma: bool = True):
        super().__init__()
        self.vocab_size, self.dim, self.scale_by_sigma = vocab_size, dim, scale_by_sigma
        self.time_emb = LearnedSinusoidalPosEmb(dim)
        self.time_proj = Dense(dim + 1, dim * 4)
        self.embed = nn.Embedding(vocab_size, dim)
        nn.init.normal_(self.embed.weight, std=dim ** -0.5)
        # dropout 0.1: JAX's ConditionableTransformer default
        self.transformer = ConditionableTransformer(dim, depth, dim_head=dim_head, heads=heads,
                                                    cond_dim=dim * 4, dropout=0.1)
        self.out = Dense(dim, vocab_size)

    def forward(self, tokens: torch.Tensor, sigma: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens [B, T]; sigma [B] float32; mask [B, T] bool (True = valid)."""
        t = F.silu(self.time_proj(self.time_emb(sigma)))
        x = self.embed(tokens.long())
        if mask is None:
            mask = torch.ones(tokens.shape, dtype=torch.bool, device=tokens.device)
        x = x + sinusoidal_positions(mask, self.dim).to(x.dtype)
        logits = self.out(self.transformer(x, cond=t, mask=mask))
        if self.scale_by_sigma:
            esigm1_log = torch.log(torch.expm1(sigma)).to(logits.dtype)
            logits = logits - esigm1_log[:, None, None] - math.log(self.vocab_size - 1)
        return logits.scatter(-1, tokens.long()[..., None], 0.0)  # the current token's


class SEDDModule(nn.Module):
    """The SEDD model over a data vocabulary of `vocab_size` (MASK, the
    absorbing state, is appended). The submodule `score` is JAX's tree
    name; the method JAX calls `score` is `log_score` here."""

    def __init__(self, vocab_size: int, dim: int = 512, depth: int = 8, heads: int = 8):
        super().__init__()
        self.vocab_size = self.mask_id = vocab_size
        self.score = SEDDScoreModel(vocab_size + 1, dim, depth, heads)

    def perturb(self, tokens: torch.Tensor, t: torch.Tensor, u: torch.Tensor,
                able_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The absorbing forward process: each noiseable token becomes MASK
        where its uniform u < 1 - exp(-sigma(t))."""
        sigma, _ = loglinear_sigma(t)
        drop = u < 1.0 - torch.exp(-sigma)[:, None]
        if able_mask is not None:
            drop = drop & able_mask
        return torch.where(drop, self.mask_id, tokens)

    def forward(self, tokens: torch.Tensor, valid_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None, t: Optional[torch.Tensor] = None,
                u: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """The training forward: times t [B] = (1 - eps) U + eps and the
        perturbation's uniforms u [B, T] (drawn from `generator` in that
        order where not given), the perturbed x_t, the scores and the loss
        parts: loss_per_pos [B, T], weight (dsigma) [B], x_t, n_masked [B]."""
        b, device = tokens.shape[0], tokens.device
        if t is None:  # each draw over the global batch under a data-parallel split
            t = ((1.0 - NOISE_EPS) * draw_rows(
                lambda n: torch.rand(n, generator=generator, device=device), b) + NOISE_EPS)
        if u is None:
            u = draw_rows(lambda n: torch.rand((n,) + tuple(tokens.shape[1:]),
                                               generator=generator, device=device), b)
        t = t.float()
        sigma, dsigma = loglinear_sigma(t)
        able = valid_mask & (tokens != EOS)
        x_t = self.perturb(tokens, t, u.float(), able_mask=able)
        scores = self.score(x_t, sigma, mask=valid_mask)
        per_pos = score_entropy_absorb(scores, sigma, x_t, tokens, self.mask_id)
        return dict(loss_per_pos=torch.where(able, per_pos, 0.0), weight=dsigma, x_t=x_t,
                    n_masked=((x_t == self.mask_id) & valid_mask).sum(1))

    def log_score(self, tokens: torch.Tensor, sigma: torch.Tensor,
                  valid_mask: torch.Tensor) -> torch.Tensor:
        return self.score(tokens, sigma, mask=valid_mask)


def jax_linspace(start, stop, num: int, device=None) -> torch.Tensor:
    """jnp.linspace(start, stop, num) in float32, bit for bit: start * (1 -
    s) + stop * s with s = i / (num - 1), the endpoint appended."""
    div = num - 1
    step = torch.arange(div, dtype=torch.float32, device=device) / div
    start = torch.tensor(start, dtype=torch.float32, device=device)
    stop = torch.tensor(stop, dtype=torch.float32, device=device)
    return torch.cat([start * (1 - step) + stop * step, stop[None]])


def _uniform(uniforms, i: int, shape, generator, device) -> torch.Tensor:
    if uniforms is not None:
        return uniforms[i].to(device)
    return torch.rand(shape, generator=generator, device=device)


def _update(model: SEDDModule, x: torch.Tensor, t: torch.Tensor, dt: float,
            valid_mask: torch.Tensor, u: torch.Tensor, truncate: bool) -> torch.Tensor:
    sigma, _ = loglinear_sigma(t)
    sigma_next, _ = loglinear_sigma(t - dt)
    log_score = model.log_score(x, sigma, valid_mask)
    probs = analytic_update_probs(log_score, x, sigma - sigma_next, model.mask_id, truncate)
    return sample_categorical(probs, u)


@torch.no_grad()
def sedd_sample(model: SEDDModule, batch_size: int, seq_len: int, steps: int = 64,
                valid_mask: Optional[torch.Tensor] = None, eps: float = 1e-5,
                generator: Optional[torch.Generator] = None,
                uniforms: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """Reverse sampling from all-MASK with the analytic predictor (JAX
    sedd.py:224-270): times linspace(1, eps, steps + 1) in float32, dt =
    (1 - eps) / steps, the last step's MASK column dropped so every
    position resolves to a data token. Step i's Gumbel uniforms [B, T,
    V + 1] are `uniforms[i]`, else drawn from `generator`. Returns [B, T]."""
    device = next(model.parameters()).device
    if valid_mask is None:
        valid_mask = torch.ones(batch_size, seq_len, dtype=torch.bool, device=device)
    x = torch.full((batch_size, seq_len), model.mask_id, dtype=torch.long, device=device)
    ts = jax_linspace(1.0, eps, steps + 1, device)
    dt = (1.0 - eps) / steps
    shape = (batch_size, seq_len, model.mask_id + 1)
    for i in range(steps):
        t = ts[i].expand(batch_size)
        x = _update(model, x, t, dt, valid_mask,
                    _uniform(uniforms, i, shape, generator, device), truncate=i == steps - 1)
    return x


@torch.no_grad()
def sedd_refine(model: SEDDModule, input_tokens: torch.Tensor, valid_mask: torch.Tensor,
                steps: int = 16, eps: float = 1e-5, unk: int = UNK,
                generator: Optional[torch.Generator] = None,
                uniforms: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """Refine a NAT canvas whose `unk` placeholders become MASK (JAX
    sedd.py:273-316): each row starts at the time its masked share implies
    (sigma0 = -log(1 - n_masked / n_valid), t0 = (exp(-sigma0) - 1) /
    (1e-3 - 1)) and steps linspace(t0, eps, steps + 1), while dsigma takes
    the global dt = (1 - eps) / steps (the reference's quirk, kept); only
    the positions masked at the start change, and a MASK left becomes
    `unk`. Uniforms as in `sedd_sample`."""
    x = torch.where(input_tokens == unk, model.mask_id, input_tokens.long())
    masked = x == model.mask_id
    n_masked = (masked & valid_mask).sum(1).float()
    n_all = valid_mask.sum(1).clamp(min=1).float()
    frac = torch.clamp(n_masked / n_all, 0.0, 1.0 - 1e-6)
    sigma0 = -torch.log1p(-frac)
    start_t = (torch.exp(-sigma0) - 1.0) / (1e-3 - 1.0)
    row_dt = (start_t - eps) / steps
    dt = (1.0 - eps) / steps
    shape = (*x.shape, model.mask_id + 1)
    for i in range(steps):
        draw = _update(model, x, start_t - row_dt * i, dt, valid_mask,
                       _uniform(uniforms, i, shape, generator, x.device),
                       truncate=i == steps - 1)
        x = torch.where(masked, draw, x)
    return torch.where(x == model.mask_id, unk, x)


def sedd_absorb_arch(cfg: dict) -> None:
    """`sedd` / `sedd_absorb` (JAX sedd.py:319-339): 512 wide, 8 layers, 8
    heads."""
    for key, value in (("sedd_dim", 512), ("sedd_depth", 8), ("sedd_heads", 8)):
        arch_default(cfg, key, value)


ARCHS = {"sedd_absorb": sedd_absorb_arch, "sedd": sedd_absorb_arch}
