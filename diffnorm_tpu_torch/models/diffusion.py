"""Latent DDPM "normalizer" over frozen speech-VAE latents, and DDIM sampling.

Counterpart of diffnorm_tpu/models/diffusion.py for the DiffNorm
normalization path: `DDPMSchedule`, the `Denoiser` (1x1 latent -> dim,
FiLM-time WaveNet, sinusoidal positions, adaptive-RMSNorm transformer, proj
back), `LatentDiffusionModule` with its training forward, `ddim_sample` and
`calibrate_act_scales`.

`quant_int8` / `int8_route` select JAX's int8 W8A8 sampling configuration
for the transformer (see `ConditionableTransformer`): route "fused_layer"
is DIFFNORM_FUSED_BLOCK=1, "ffpipe" / "ffpipe2" DIFFNORM_FFPIPE=1 (rows 1 /
2), "module" the int8 module path; `int8_knobs` are JAX's int8 environment
switches. The WaveNet runs its `wavenet_chain` kernel in the model's dtype
(JAX's DIFFNORM_PALLAS_WAVENET=1), except in an int8 model on route
"module", whose WaveNet convs are int8 modules as on JAX's default module
route (the DDIM serving headline, with static scales from
`calibrate_act_scales`).

The prompt-conditioned denoiser (`use_cond`, off in the released recipe):
a `PerceiverResampler` turns a 768-d prompt into cross-attention tokens,
the pooled prompt joins the time condition, and per-row classifier-free
dropout swaps in learned null embeddings (`Denoiser.forward_with_cond_scale`
guides). As in JAX, no sampler feeds it a prompt: `ddim_sample` refuses
such a model. `use_vae=False` runs the diffusion on the features
themselves (`diff_hubert`). `ARCHS` holds JAX's architecture defaults.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from diffnorm_tpu_torch.device import resolve_device
from diffnorm_tpu_torch.models.layers import (
    Attention,
    ConditionableTransformer,
    Dense,
    FeedForward,
    LearnedSinusoidalPosEmb,
    RMSNorm,
    sinusoidal_positions,
)
from diffnorm_tpu_torch.models.vae import SpeechVAEModule
from diffnorm_tpu_torch.models.wavenet import Wavenet
from diffnorm_tpu_torch.ops.quant import Int8Knobs, calibrating, quant_sites
from diffnorm_tpu_torch.parallel.mesh import draw_rows, row_split


def cosine_betas(num_steps: int, max_beta: float = 0.999) -> np.ndarray:
    """The cosine beta schedule (reference latent_module.py:1145-1223)."""
    def alpha_bar(t):
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

    return np.array([min(1 - alpha_bar((i + 1) / num_steps) / alpha_bar(i / num_steps),
                         max_beta) for i in range(num_steps)], dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class DDPMSchedule:
    """Cosine-schedule diffusion tables in float64 numpy; `table` gives one
    as float32."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray

    @classmethod
    def create(cls, timesteps: int) -> "DDPMSchedule":
        betas = cosine_betas(timesteps)
        ac = np.cumprod(1.0 - betas, axis=0)
        return cls(
            betas=betas,
            alphas_cumprod=ac,
            alphas_cumprod_prev=np.append(1.0, ac[:-1]),
            sqrt_alphas_cumprod=np.sqrt(ac),
            sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - ac),
        )

    def table(self, name: str, device) -> torch.Tensor:
        return torch.as_tensor(getattr(self, name), dtype=torch.float32,
                               device=device)

    def extract(self, name: str, t: torch.Tensor, ndim: int) -> torch.Tensor:
        """table[t] for integer times t [B], as float32 [B, 1, ...] of `ndim`
        dims (diffusion.py:extract)."""
        vals = self.table(name, t.device)[t.long()]
        return vals.reshape(vals.shape + (1,) * (ndim - 1))

    def snr(self, t: torch.Tensor) -> torch.Tensor:
        """alpha_bar / (1 - alpha_bar) at integer times t [B], float32."""
        ac = self.table("alphas_cumprod", t.device)[t.long()]
        return ac / (1.0 - ac)


def safe_div(num, den, eps: float = 1e-10):
    return num / torch.clamp(den, min=eps)


def _select(tree, i: int):
    """Step i of a precomputed-conditioning tree whose leaves are [S, ...]."""
    if isinstance(tree, torch.Tensor):
        return tree[i]
    if isinstance(tree, dict):
        return {k: _select(v, i) for k, v in tree.items()}
    return type(tree)(_select(v, i) for v in tree)


def _split_steps(tree, steps: int):
    """Reshape leaves [S * B, ...] -> [S, B, ...]."""
    if isinstance(tree, torch.Tensor):
        return tree.reshape((steps, -1) + tuple(tree.shape[1:]))
    if isinstance(tree, dict):
        return {k: _split_steps(v, steps) for k, v in tree.items()}
    return type(tree)(_split_steps(v, steps) for v in tree)


class PerceiverResampler(nn.Module):
    """A variable-length prompt [B, Tp, dim_context] -> `num_latents` tokens
    [B, N, dim] (JAX diffusion.py:110-149): learned latents plus sinusoidal
    positions; per layer attention of the latents over [latents; projected
    prompt] (the queries included in the context, under the prompt's mask)
    with attention dropout 0.1 in training, and a GEGLU FF; a final RMSNorm."""

    def __init__(self, dim: int, depth: int = 2, dim_context: int = 768,
                 num_latents: int = 64, dim_head: int = 64, heads: int = 8):
        super().__init__()
        self.dim, self.depth = dim, depth
        self.proj_context = Dense(dim_context, dim)
        self.latents = nn.Parameter(torch.randn(num_latents, dim) * 0.02)
        for i in range(depth):
            self.add_module(f"attn_{i}", Attention(dim, dim_head, heads, dropout=0.1))
            self.add_module(f"ff_{i}", FeedForward(dim, 4))
        self.norm = RMSNorm(dim)

    def forward(self, prompt: torch.Tensor,
                prompt_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b = prompt.shape[0]
        ctx = self.proj_context(prompt)
        lat_mask = torch.ones(b, self.latents.shape[0], dtype=torch.bool, device=ctx.device)
        x = self.latents.to(ctx.dtype)[None].expand(b, -1, -1)
        x = x + sinusoidal_positions(lat_mask, self.dim).to(x.dtype)
        if prompt_mask is None:
            prompt_mask = torch.ones(prompt.shape[:2], dtype=torch.bool, device=ctx.device)
        full_mask = torch.cat([lat_mask, prompt_mask.bool()], dim=1)
        for i in range(self.depth):
            x = x + getattr(self, f"attn_{i}")(x, mask=full_mask,
                                               context=torch.cat([x, ctx], dim=1))
            x = x + getattr(self, f"ff_{i}")(x)
        return self.norm(x)


class Denoiser(nn.Module):
    """1x1 latent -> dim, FiLM-time WaveNet (stacks x chains), sinusoidal
    positions, adaptive-RMSNorm transformer with causal-conv FF, proj back.

    The time condition is dim * dim_cond_mult wide. With
    `condition_on_prompt` (JAX diffusion.py:152-231) the mean of the masked
    prompt, projected (`to_prompt_cond`), joins it, so the WaveNet's and the
    transformer's condition is twice as wide, and the transformer
    cross-attends to the prompt's `PerceiverResampler` tokens. A row that
    drops the prompt takes `null_prompt_cond` and `null_prompt_tokens`
    instead: all rows at cond_drop_prob 1, none at 0, else each with
    probability cond_drop_prob from `generator` (JAX's "cg" stream), or as
    the injected bool [B] `cond_drop` says."""

    def __init__(self, dim: int = 512, latent_dim: int = 128, depth: int = 12,
                 wavenet_layers: int = 8, wavenet_stacks: int = 4,
                 quant_int8: bool = False, int8_route: str = "fused_layer",
                 int8_knobs: Int8Knobs = Int8Knobs(), dropout: float = 0.0,
                 dim_head: int = 64, heads: int = 8, dim_cond_mult: int = 4,
                 condition_on_prompt: bool = False, dim_prompt: int = 768,
                 num_latents_m: int = 64, resampler_depth: int = 2):
        super().__init__()
        self.dim, self.condition_on_prompt = dim, condition_on_prompt
        dim_time = dim * dim_cond_mult
        cond_dim = dim_time * (2 if condition_on_prompt else 1)
        self.time_emb = LearnedSinusoidalPosEmb(dim)
        self.time_proj = Dense(dim + 1, dim_time)
        if condition_on_prompt:
            self.to_prompt_cond = Dense(dim_prompt, dim_time)
            self.null_prompt_cond = nn.Parameter(torch.randn(dim_time) * 0.02)
            self.null_prompt_tokens = nn.Parameter(torch.randn(num_latents_m, dim) * 0.02)
            self.perceiver_resampler = PerceiverResampler(
                dim, resampler_depth, dim_prompt, num_latents_m, dim_head, heads)
        self.init_conv = Dense(latent_dim, dim)
        self.wavenet = Wavenet(dim, dim, wavenet_stacks, wavenet_layers,
                               cond_dim=cond_dim, quant=quant_int8, knobs=int8_knobs,
                               chain_kernel=not (quant_int8 and int8_route == "module"))
        self.transformer = ConditionableTransformer(
            dim, depth, dim_head=dim_head, heads=heads, ff_mult=4, ff_causal_conv=True,
            cond_dim=cond_dim, quant_int8=quant_int8, int8_route=int8_route,
            int8_knobs=int8_knobs, dropout=dropout, cross_attn=condition_on_prompt)
        self.final_proj = Dense(dim, latent_dim)

    def time_cond(self, times: torch.Tensor) -> torch.Tensor:
        return F.silu(self.time_proj(self.time_emb(times)))

    def precompute_step_conds(self, times_all: torch.Tensor) -> dict:
        """times_all [S, B] -> every FiLM projection for every step, leaves
        shaped [S, B, ...]: the projection weights are read once per
        sampling call instead of once per step. The unconditioned denoiser
        only, as JAX asserts (diffusion.py:241)."""
        if self.condition_on_prompt:
            raise ValueError("precompute_step_conds: a prompt-conditioned denoiser projects "
                             "its condition per step")
        steps = times_all.shape[0]
        t = self.time_cond(times_all.reshape(-1))
        return _split_steps({
            "wavenet": self.wavenet.precompute_film(t),
            "transformer": self.transformer.precompute_film(t),
        }, steps)

    def _drop_mask(self, b: int, device, cond_drop_prob: float, cond_drop,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
        if cond_drop is not None:
            return torch.as_tensor(cond_drop, device=device).bool().reshape(b)
        if cond_drop_prob >= 1.0:
            return torch.ones(b, dtype=torch.bool, device=device)
        if cond_drop_prob <= 0.0:
            return torch.zeros(b, dtype=torch.bool, device=device)
        if generator is None:
            raise ValueError("classifier-free dropout needs a generator (the trainer's "
                             "cg_generator)")
        return torch.rand(b, generator=generator, device=device) < cond_drop_prob

    def forward(self, x, times=None, mask=None, step_cond=None, pos=None, prompt=None,
                prompt_mask=None, cond_drop_prob: float = 0.0, cond_drop=None,
                generator: Optional[torch.Generator] = None):
        """x [B, T, latent]; times [B]; mask [B, T] bool. `step_cond` is one
        step of `precompute_step_conds`; `pos` the precomputed positions. A
        prompt-conditioned denoiser takes `prompt` [B, Tp, dim_prompt] with
        `prompt_mask` [B, Tp] and the drop arguments (class docstring)."""
        context = None
        if step_cond is not None:
            t = None
            wavenet_film = step_cond["wavenet"]
            transformer_film = step_cond["transformer"]
        else:
            t = self.time_cond(times)
            wavenet_film = transformer_film = None
        if self.condition_on_prompt:
            if prompt is None or t is None:
                raise ValueError("a prompt-conditioned denoiser takes a prompt and the times "
                                 "(not step_cond)")
            b = x.shape[0]
            if prompt_mask is None:
                prompt_mask = torch.ones(prompt.shape[:2], dtype=torch.bool, device=x.device)
            drop = self._drop_mask(b, x.device, cond_drop_prob, cond_drop, generator)
            pooled = torch.where(prompt_mask[..., None], prompt, 0.0).mean(dim=1)
            prompt_cond = F.silu(self.to_prompt_cond(pooled))
            prompt_cond = torch.where(drop[:, None], self.null_prompt_cond.to(prompt_cond.dtype),
                                      prompt_cond)
            t = torch.cat([t, prompt_cond], dim=-1)
            resampled = self.perceiver_resampler(prompt, prompt_mask)
            context = torch.where(drop[:, None, None],
                                  self.null_prompt_tokens.to(resampled.dtype), resampled)
        h = self.wavenet(self.init_conv(x), t, film=wavenet_film)
        if mask is None:
            mask = torch.ones(h.shape[:2], dtype=torch.bool, device=h.device)
        if pos is None:
            pos = sinusoidal_positions(mask, self.dim)
        h = h + pos.to(h.dtype)
        h = self.transformer(h, cond=t, mask=mask, film=transformer_film, context=context)
        return self.final_proj(h)

    def forward_with_cond_scale(self, x, times, mask=None, prompt=None, prompt_mask=None,
                                cond_scale: float = 1.0):
        """Classifier-free guidance (JAX diffusion.py:311-321): null + scale *
        (cond - null), the conditioned output alone at scale 1. Call it in
        eval mode (JAX runs it deterministic)."""
        cond = self(x, times, mask, prompt=prompt, prompt_mask=prompt_mask,
                    cond_drop_prob=0.0)
        if cond_scale == 1.0:
            return cond
        null = self(x, times, mask, prompt=prompt, prompt_mask=prompt_mask,
                    cond_drop_prob=1.0)
        return null + (cond - null) * cond_scale


class LatentDiffusionModule(nn.Module):
    """Frozen speech VAE + latent denoiser (released `diff_discrete` shape by
    default: hidden 512, latent 128, 768-d features, 1004-unit vocab, T=200
    cosine schedule, min-SNR gamma 5, multitask). `quant_int8`,
    `int8_route` and `int8_knobs` go to the denoiser; `dropout` is the
    denoiser's attention dropout in a training forward. The frozen VAE is
    built without dropout: JAX decodes x1_hat through it deterministically
    (`vae.decode`'s `deterministic=True`) in train mode too.

    `use_vae=False` (`diff_hubert`) builds no VAE: `encode` returns the
    feature and the training forward decodes nothing. `use_cond` makes the
    denoiser prompt-conditioned over `feature_dim`-wide prompts; its
    training forward drops the prompt per row with probability 0.1 from
    `cg_generator` (the trainer's "cg" stream), which the trainer sets."""

    cg_generator: Optional[torch.Generator] = None

    def __init__(self, dim: int = 512, latent_dim: int = 128,
                 feature_dim: int = 768, vocab_size: int = 1004,
                 timesteps: int = 200, denoiser_depth: int = 12, wavenet_layers: int = 8,
                 wavenet_stacks: int = 4, vae_decoder_depth: int = 6,
                 vae_decoder_dim_head: int = 96, vae_decoder_heads: int = 8,
                 chan_mults: Optional[Sequence[int]] = None, quant_int8: bool = False,
                 int8_route: str = "fused_layer", int8_knobs: Int8Knobs = Int8Knobs(),
                 min_snr_gamma: float = 5.0,
                 multitask: bool = True, dropout: float = 0.0, use_vae: bool = True,
                 use_cond: bool = False):
        super().__init__()
        if use_vae:
            self.vae = SpeechVAEModule(
                feature_dim, latent_dim, vocab_size, vae_decoder_depth,
                vae_decoder_dim_head, vae_decoder_heads, chan_mults)
        self.denoiser = Denoiser(
            dim, latent_dim, denoiser_depth, wavenet_layers=wavenet_layers,
            wavenet_stacks=wavenet_stacks, quant_int8=quant_int8, int8_route=int8_route,
            int8_knobs=int8_knobs, dropout=dropout, condition_on_prompt=use_cond,
            dim_prompt=feature_dim)
        self.schedule = DDPMSchedule.create(timesteps)
        self.timesteps, self.min_snr_gamma, self.multitask = timesteps, min_snr_gamma, multitask
        self.use_vae, self.use_cond = use_vae, use_cond

    def encode(self, feature, noise=None, generator=None):
        if not self.use_vae:
            return feature
        return self.vae.encode(feature, noise=noise, generator=generator)

    def decode(self, latent, mask):
        return self.vae.decode(latent, mask)

    def denoise(self, x_t, times, mask, step_cond=None, pos=None, prompt=None,
                prompt_mask=None, cond_drop_prob: float = 0.0, cond_drop=None):
        if self.use_cond:
            return self.denoiser(x_t, times, mask, prompt=prompt, prompt_mask=prompt_mask,
                                 cond_drop_prob=cond_drop_prob, cond_drop=cond_drop,
                                 generator=self.cg_generator)
        return self.denoiser(x_t, times, mask, step_cond=step_cond, pos=pos)

    def precompute_step_conds(self, times_all):
        return self.denoiser.precompute_step_conds(times_all)

    def precompute_pos(self, mask):
        """Loop-invariant sinusoidal positions for the denoiser."""
        return sinusoidal_positions(mask, self.denoiser.dim)

    def forward(self, feature, mask, times=None, enc_noise=None, x1_noise=None,
                q_noise=None, generator: Optional[torch.Generator] = None, prompt=None,
                prompt_mask=None, cond_drop=None, decode: bool = True) -> dict:
        """Training forward (diffusion.py:413-467): t ~ U[1, T), the frozen
        VAE's encode under no_grad, the beta_0 jitter x1 = z + eps * beta_0,
        q-sample, the denoiser's noise prediction (with `use_cond`, of the
        `prompt` at drop probability 0.1, or the injected `cond_drop`), the
        min-SNR weights min(snr, gamma) / snr, and x1_hat decoded through
        the VAE (with a VAE, and unless `decode` is False: a criterion that
        reads no reconstruction skips it).

        feature [B, T, feature_dim]; mask [B, T] bool. `times`, `enc_noise`,
        `x1_noise` and `q_noise` inject the draws (JAX's keyword names);
        those not given are drawn from `generator`, in that order. Returns
        {pred_noise, true_noise, loss_weight, times[, recon_feature,
        lm_logits]}."""
        b, device = feature.shape[0], feature.device
        if times is None:  # each per-row draw over the global batch under a split
            times = draw_rows(lambda n: torch.randint(1, self.timesteps, (n,),
                                                      generator=generator, device=device), b)
        times = torch.as_tensor(times, device=device).long()
        with torch.no_grad():
            z = self.encode(feature, noise=enc_noise, generator=generator)

        def draw(injected):  # an injected draw keeps its type, as in JAX
            if injected is None:
                return draw_rows(lambda n: torch.randn((n,) + tuple(z.shape[1:]),
                                                       generator=generator, device=device,
                                                       dtype=z.dtype), b)
            return torch.as_tensor(injected, device=device)

        x1 = z + draw(x1_noise) * float(self.schedule.betas[0])
        true_noise = draw(q_noise)
        sac = self.schedule.extract("sqrt_alphas_cumprod", times, z.dim())
        s1mac = self.schedule.extract("sqrt_one_minus_alphas_cumprod", times, z.dim())
        x_t = sac * x1 + s1mac * true_noise
        pred_noise = self.denoise(x_t, times, mask, prompt=prompt, prompt_mask=prompt_mask,
                                  cond_drop_prob=0.1 if self.use_cond else 0.0,
                                  cond_drop=cond_drop)
        snr = self.schedule.snr(times)
        out = dict(pred_noise=pred_noise, true_noise=true_noise,
                   loss_weight=torch.clamp(snr, max=self.min_snr_gamma) / snr, times=times)
        if self.use_vae and decode:
            x1_hat = safe_div(x_t - s1mac * pred_noise, sac)
            out["recon_feature"], out["lm_logits"] = self.vae.decode(x1_hat, mask)
        return out


def _diff_discrete(cfg: Dict) -> None:
    for key, value in (("hidden_dim", 512), ("latent_dim", 128), ("timesteps", 200),
                       ("multitask", True)):
        _setdefault(cfg, key, value)


def _diff_latent(cfg: Dict) -> None:
    """Continuous latent diffusion (task speech_diffusion). As in JAX
    (diffusion.py:675-680) diff_discrete's defaults come first, so
    multitask stays True unless given; ddpm_latent_loss reads no
    reconstruction either way."""
    _diff_discrete(cfg)
    _setdefault(cfg, "multitask", False)


def _diff_hubert(cfg: Dict) -> None:
    """Diffusion over the 768-d features themselves, no VAE (task
    speech_diffusion_hubert)."""
    for key, value in (("hidden_dim", 512), ("latent_dim", 768), ("timesteps", 200)):
        _setdefault(cfg, key, value)
    cfg["use_vae"], cfg["multitask"] = False, False


def _diffusion_transformer(cfg: Dict) -> None:
    """The WaveNet collapses to one 1x1 stack of one layer and the
    transformer deepens to 16."""
    _diff_discrete(cfg)
    for key, value in (("wavenet_stacks", 1), ("wavenet_layers", 1), ("denoiser_depth", 16)):
        _setdefault(cfg, key, value)


def _setdefault(cfg: Dict, key: str, value) -> None:
    if cfg.get(key) is None:
        cfg[key] = value


# JAX's latent_diffusion architectures (diffusion.py:666-702): each fills
# the unset (None) keys of a config dict with its defaults
ARCHS: Dict[str, Callable[[Dict], None]] = {
    "diff_discrete": _diff_discrete, "diff_latent": _diff_latent,
    "diff_hubert": _diff_hubert, "diffusion_transformer": _diffusion_transformer,
}


@torch.no_grad()
def calibrate_act_scales(model: LatentDiffusionModule, feature, mask, *,
                         start_step: int = 50, n_points: int = 6, enc_noise=None,
                         noise=None, generator: Optional[torch.Generator] = None) -> int:
    """Record every int8 site's activation amax over representative denoise
    steps (diffusion.py:469-512): encode `feature`, q-sample at the times
    unique(linspace(1, start_step - 1, n_points)) from the highest down with
    one shared `noise`, and keep each site's running max across the points.
    `enc_noise` and `noise` inject the VAE posterior eps and the q-sample
    noise; otherwise they are drawn from `generator`. The sites keep their
    mode: turn static scales on with `ops.quant.set_static_scales`. Returns
    the number of sites that hold an amax (0 for a model without int8)."""
    device = next(model.parameters()).device
    feature = torch.as_tensor(feature, device=device)
    mask = torch.as_tensor(mask, device=device, dtype=torch.bool)
    z = model.encode(feature, noise=enc_noise, generator=generator)
    if noise is None:
        noise = torch.randn(z.shape, generator=generator, device=device, dtype=z.dtype)
    noise = torch.as_tensor(noise, device=device).to(z.dtype)
    ts = np.unique(np.linspace(1, start_step - 1, n_points).astype(np.int32))
    with calibrating(model):
        for t_int in ts[::-1]:
            t = torch.full((z.shape[0],), int(t_int), dtype=torch.int32, device=device)
            x = (model.schedule.extract("sqrt_alphas_cumprod", t, z.dim()) * z
                 + model.schedule.extract("sqrt_one_minus_alphas_cumprod", t, z.dim()) * noise)
            model.denoise(x, t, mask)
    return sum(site.act_amax is not None for _, site in quant_sites(model))


@torch.no_grad()
def ddim_sample(model: LatentDiffusionModule, feature, mask, *,
                start_step: int = 50, stride: int = 1, enc_noise=None,
                init_noise=None, generator: Optional[torch.Generator] = None,
                device: Union[str, torch.device] = "cuda", mesh=None):
    """Partial-noise DDIM normalization (eta = 0).

    feature [B, T, feature_dim]; mask [B, T] bool, True = valid. Encodes,
    noises the latent to `start_step`, denoises, decodes. With stride 1 the
    times run start_step-1 .. 1 with alphas_cumprod_prev (the reference's
    loop); with stride > 1 they run start_step, start_step-stride, ... with
    the previous time clamped at 0 (see the JAX ddim_sample's docstring).
    `enc_noise` / `init_noise` inject the VAE posterior eps and the start
    noise; otherwise they are drawn from `generator`.

    Runs on `device` (CUDA by default; raises when CUDA is absent), where
    the model must already be. Returns (pred_units [B, T] int32 with the -4
    dictionary offset applied, recon_feature [B, T, feature_dim]).

    `mesh` (a `parallel.mesh.Mesh` of N ranks, each passing the same global
    batch) splits the rows: each rank samples its contiguous block, the
    noises not given drawn for the global batch, and every rank gets the
    whole batch's outputs back in order (JAX's sharded ddim_sample).
    """
    if mesh is not None and mesh.active:
        n = feature.shape[0]
        lo, hi = mesh.rows(n)
        cut = (lambda x: None if x is None else x[lo:hi])  # noqa: E731
        with row_split(mesh, n, lo, hi):
            units, recon = ddim_sample(model, cut(feature), cut(mask), start_step=start_step,
                                       stride=stride, enc_noise=cut(enc_noise),
                                       init_noise=cut(init_noise), generator=generator,
                                       device=device)
        return mesh.all_gather_rows(units, n), mesh.all_gather_rows(recon, n)
    if model.use_cond:
        raise ValueError("ddim_sample: a prompt-conditioned model (use_cond) has no sampler; "
                         "JAX's ddim_sample passes it no prompt and its Denoiser asserts "
                         "(diffusion.py:271,585)")
    device = resolve_device(device)
    param = next(model.parameters())
    if param.device != device:
        raise ValueError(f"ddim_sample: model is on {param.device}, not {device}")
    feature = torch.as_tensor(feature, device=device)
    mask = torch.as_tensor(mask, device=device, dtype=torch.bool)
    sched = model.schedule
    sac_tab = sched.table("sqrt_alphas_cumprod", device)
    s1mac_tab = sched.table("sqrt_one_minus_alphas_cumprod", device)
    ac_tab = sched.table("alphas_cumprod", device)
    ac_prev_tab = sched.table("alphas_cumprod_prev", device)

    def at(table, time):
        # [1, 1, 1], not 0-d: a 0-d f32 tensor would not promote a bf16
        # operand, and the JAX loop carries x in f32
        return table[time].reshape(1, 1, 1)

    z = model.encode(feature, noise=enc_noise, generator=generator)
    b = z.shape[0]
    if init_noise is None:
        noise0 = draw_rows(lambda n: torch.randn((n,) + tuple(z.shape[1:]), generator=generator,
                                                 device=device, dtype=z.dtype), b)
    else:
        noise0 = torch.as_tensor(init_noise, device=device).to(z.dtype)
    x = at(sac_tab, start_step) * z + at(s1mac_tab, start_step) * noise0

    if stride > 1:
        times = list(range(start_step, 0, -stride))
        prev_times = [max(t - stride, 0) for t in times]
    else:
        times = list(range(start_step - 1, 0, -1))
        prev_times = None
    times_all = torch.tensor(times, dtype=torch.float32, device=device)
    step_conds = model.precompute_step_conds(times_all[:, None].expand(-1, b))
    pos = model.precompute_pos(mask)

    for i, time in enumerate(times):
        t = torch.full((b,), time, dtype=torch.int32, device=device)
        noise = model.denoise(x, t, mask, step_cond=_select(step_conds, i),
                              pos=pos)
        sac_t, s1mac_t = at(sac_tab, time), at(s1mac_tab, time)
        x1_hat = safe_div(x - s1mac_t * noise, sac_t)
        pred_noise = safe_div(x - sac_t * x1_hat, s1mac_t)
        ab_prev = (at(ac_tab, prev_times[i]) if stride > 1
                   else at(ac_prev_tab, time))
        x = x1_hat * torch.sqrt(ab_prev) + torch.sqrt(1.0 - ab_prev) * pred_noise

    recon_feature, lm_logits = model.decode(x, mask)
    pred_units = lm_logits.argmax(dim=-1).to(torch.int32) - 4
    return pred_units, recon_feature
