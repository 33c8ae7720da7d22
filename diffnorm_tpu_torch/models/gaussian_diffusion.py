"""The improved-DDPM (IDDPM) toolkit (the port of
diffnorm_tpu/models/gaussian_diffusion.py; reference improved-diffusion's
gaussian_diffusion.py, respace.py and diffusion/__init__.py:create_diffusion):
learned-sigma posteriors, the variational-bound terms, ancestral and DDIM
sampling, the training losses and the bits-per-dim sweep, over any
`denoise_fn(x, t)`.

The tables are float64 numpy, as JAX's, read as float32 tensors on the
input's device (each table moved once per device). The loops are Python
loops over the steps. Respacing ("50", "10,20", "ddim25") re-derives the
betas of the kept steps, and `map_t` gives the model each kept step's
original index. Every draw takes an explicit `torch.Generator`, or is
handed in (`noise`), so a test can give both packages the same numbers:
the loops' initial and per-step noises, and `calc_bpd_loop`'s per-step
noises (JAX draws those from PRNGKey(0) folded with the step).

Knobs (create_diffusion's): model_mean_type eps | x_start | prev_x;
model_var_type fixed_small | fixed_large | learned_range; loss_type mse |
rescaled_mse | kl | rescaled_kl; timestep_respacing.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from diffnorm_tpu_torch.models.diffusion import cosine_betas


def get_named_beta_schedule(name: str, num_steps: int) -> np.ndarray:
    """The "linear" (scaled to num_steps) or "cosine" betas, float64 (JAX
    models/diffusion.py:53-63)."""
    if name == "linear":
        scale = 1000 / num_steps
        return np.linspace(scale * 0.0001, scale * 0.02, num_steps, dtype=np.float64)
    if name == "cosine":
        return cosine_betas(num_steps)
    raise NotImplementedError(f"unknown beta schedule: {name}")


def space_timesteps(num_timesteps: int, section_counts) -> list:
    """The kept steps: "ddimN" at a fixed stride, else "a,b,c" sections
    (respace.py:space_timesteps)."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired:
                    return list(range(0, num_timesteps, i))
            raise ValueError(f"cannot create exactly {desired} ddim steps")
        section_counts = ([int(x) for x in section_counts.split(",")] if section_counts
                          else [num_timesteps])
    size_per, extra = divmod(num_timesteps, len(section_counts))
    result, start = [], 0
    for i, count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if count > size:
            raise ValueError(f"cannot divide section of {size} into {count}")
        stride = 1 if count <= 1 else (size - 1) / (count - 1)
        cur = 0.0
        for _ in range(count):
            result.append(start + round(cur))
            cur += stride
        start += size
    return result


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=tuple(range(1, x.dim())))


def approx_standard_normal_cdf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x.pow(3))))


def discretized_gaussian_log_likelihood(x, *, means, log_scales):
    """The log-likelihood of a Gaussian discretized to 1/255 bins, x in
    [-1, 1] (diffusion_utils.py:62-89)."""
    centered = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered - 1.0 / 255.0))
    log_cdf_plus = torch.log(torch.clamp(cdf_plus, min=1e-12))
    log_one_minus_cdf_min = torch.log(torch.clamp(1.0 - cdf_min, min=1e-12))
    log_delta = torch.log(torch.clamp(cdf_plus - cdf_min, min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min, log_delta))


def _noise(noise, i: int, shape, generator, device) -> torch.Tensor:
    if noise is not None:
        return noise[i].to(device)
    return torch.randn(shape, generator=generator, device=device)


class GaussianDiffusion:
    def __init__(self, betas, timestep_map: Optional[np.ndarray] = None):
        """betas [T] (float64); `timestep_map` the original index of each
        kept step where respaced."""
        betas = np.asarray(betas, np.float64)
        alphas = 1.0 - betas
        ac = np.cumprod(alphas)
        acp = np.append(1.0, ac[:-1])
        post_var = betas * (1.0 - acp) / (1.0 - ac)
        self.timestep_map = timestep_map
        self.betas, self.alphas_cumprod, self.alphas_cumprod_prev = betas, ac, acp
        self.alphas_cumprod_next, self.one_minus_ac = np.append(ac[1:], 0.0), 1.0 - ac
        self.sqrt_ac, self.sqrt_1mac = np.sqrt(ac), np.sqrt(1 - ac)
        self.sqrt_recip_ac, self.sqrt_recipm1_ac = np.sqrt(1.0 / ac), np.sqrt(1.0 / ac - 1)
        self.posterior_variance = post_var
        self.posterior_log_variance_clipped = np.log(np.append(post_var[1], post_var[1:]))
        self.posterior_mean_coef1 = betas * np.sqrt(acp) / (1.0 - ac)
        self.posterior_mean_coef2 = (1.0 - acp) * np.sqrt(alphas) / (1.0 - ac)
        self.fixed_large_variance = np.append(post_var[1], betas[1:])
        self._on_device: Dict[Tuple[str, torch.device], torch.Tensor] = {}

    @classmethod
    def create(cls, timesteps: int = 1000, schedule: str = "cosine",
               timestep_respacing: str = "") -> "GaussianDiffusion":
        betas = get_named_beta_schedule(schedule, timesteps)
        if not timestep_respacing:
            return cls(betas)
        use = sorted(space_timesteps(timesteps, timestep_respacing))
        ac = np.cumprod(1.0 - betas)
        last, new_betas = 1.0, []
        for t in use:
            new_betas.append(1.0 - ac[t] / last)
            last = ac[t]
        return cls(np.asarray(new_betas), timestep_map=np.asarray(use))

    @property
    def num_timesteps(self) -> int:
        return len(self.betas)

    def _table(self, name: str, device, dtype=torch.float32) -> torch.Tensor:
        """Table `name` as a tensor on `device`, moved there once."""
        key = (name, device)
        if key not in self._on_device:
            self._on_device[key] = torch.as_tensor(getattr(self, name), dtype=dtype,
                                                   device=device)
        return self._on_device[key]

    def _ext(self, name: str, t: torch.Tensor, ndim: int) -> torch.Tensor:
        """Table `name` at the steps t [N], as float32 [N, 1, ...] of rank
        `ndim`."""
        vals = self._table(name, t.device)[t.long()]
        return vals.reshape(vals.shape + (1,) * (ndim - 1))

    def map_t(self, t: torch.Tensor) -> torch.Tensor:
        """A kept step's original model timestep."""
        if self.timestep_map is None:
            return t
        return self._table("timestep_map", t.device, torch.int32)[t.long()]

    def _steps(self, n: int, i: int, device) -> torch.Tensor:
        return torch.full((n,), self.num_timesteps - 1 - i, dtype=torch.int32, device=device)

    # forward process
    def q_sample(self, x0, t, noise):
        return self._ext("sqrt_ac", t, x0.dim()) * x0 + self._ext("sqrt_1mac", t, x0.dim()) * noise

    def q_posterior(self, x0, x_t, t):
        n = x0.dim()
        mean = (self._ext("posterior_mean_coef1", t, n) * x0
                + self._ext("posterior_mean_coef2", t, n) * x_t)
        return (mean, self._ext("posterior_variance", t, n),
                self._ext("posterior_log_variance_clipped", t, n))

    def predict_x0_from_eps(self, x_t, t, eps):
        return (self._ext("sqrt_recip_ac", t, x_t.dim()) * x_t
                - self._ext("sqrt_recipm1_ac", t, x_t.dim()) * eps)

    def predict_eps_from_x0(self, x_t, t, pred_x0):
        return ((self._ext("sqrt_recip_ac", t, x_t.dim()) * x_t - pred_x0)
                / self._ext("sqrt_recipm1_ac", t, x_t.dim()))

    # reverse process
    def p_mean_variance(self, model_out, x_t, t, model_mean_type: str = "eps",
                        model_var_type: str = "fixed_small", clip_x0: bool = False):
        """(mean, variance, log-variance, predicted x0); model_out [..., C],
        [..., 2C] under learned_range."""
        n = x_t.dim()
        if model_var_type == "learned_range":
            model_out, var_frac = model_out.chunk(2, dim=-1)
            min_log = self._ext("posterior_log_variance_clipped", t, n)
            max_log = torch.log(torch.clamp(self._ext("betas", t, n), min=1e-20))
            frac = (var_frac + 1.0) / 2.0
            model_logvar = frac * max_log + (1 - frac) * min_log
            model_var = torch.exp(model_logvar)
        elif model_var_type == "fixed_large":
            model_var = self._ext("fixed_large_variance", t, n)
            model_logvar = torch.log(torch.clamp(model_var, min=1e-20))
        else:
            model_var = self._ext("posterior_variance", t, n)
            model_logvar = self._ext("posterior_log_variance_clipped", t, n)
        if model_mean_type == "prev_x":
            return model_out, model_var, model_logvar, torch.zeros_like(x_t)
        x0 = self.predict_x0_from_eps(x_t, t, model_out) if model_mean_type == "eps" else model_out
        if clip_x0:
            x0 = torch.clamp(x0, -1.0, 1.0)
        mean, _, _ = self.q_posterior(x0, x_t, t)
        return mean, model_var, model_logvar, x0

    def vb_term(self, model_out, x0, x_t, t, model_mean_type: str = "eps",
                model_var_type: str = "learned_range", clip_x0: bool = False,
                freeze_mean: bool = True):
        """The variational-bound term in bits [N]: KL(q(x_{t-1} | x_t, x0) ||
        p(x_{t-1} | x_t)), and at t == 0 the discretized decoder NLL; with
        `freeze_mean` under learned_range the mean head takes no gradient."""
        true_mean, _, true_logvar = self.q_posterior(x0, x_t, t)
        if freeze_mean and model_var_type == "learned_range":
            mean_part, var_part = model_out.chunk(2, dim=-1)
            model_out = torch.cat([mean_part.detach(), var_part], dim=-1)
        mean, _, logvar, _ = self.p_mean_variance(model_out, x_t, t, model_mean_type,
                                                  model_var_type, clip_x0)
        kl = 0.5 * (-1.0 + logvar - true_logvar + torch.exp(true_logvar - logvar)
                    + (true_mean - mean).square() * torch.exp(-logvar))
        kl = mean_flat(kl) / math.log(2.0)
        nll = -discretized_gaussian_log_likelihood(x0, means=mean, log_scales=0.5 * logvar)
        return torch.where(t == 0, mean_flat(nll) / math.log(2.0), kl)

    # sampling
    @torch.no_grad()
    def p_sample_loop(self, denoise_fn: Callable, shape, model_mean_type: str = "eps",
                      model_var_type: str = "fixed_small", clip_x0: bool = False,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[Sequence[torch.Tensor]] = None, device=None):
        """Ancestral sampling; denoise_fn(x, mapped t). `noise[0]` is the
        start, `noise[1 + i]` step i's draw (else from `generator`)."""
        x = _noise(noise, 0, shape, generator, device)
        for i in range(self.num_timesteps):
            t = self._steps(shape[0], i, x.device)
            mean, _, logvar, _ = self.p_mean_variance(denoise_fn(x, self.map_t(t)), x, t,
                                                      model_mean_type, model_var_type, clip_x0)
            z = _noise(noise, 1 + i, shape, generator, x.device)
            nonzero = (t > 0).float().reshape((-1,) + (1,) * (x.dim() - 1))
            x = mean + nonzero * torch.exp(0.5 * logvar) * z
        return x

    def ddim_step(self, model_out, x_t, t, noise, model_mean_type: str = "eps",
                  model_var_type: str = "fixed_small", clip_x0: bool = False,
                  eta: float = 0.0):
        """One DDIM update x_t -> x_{t-1} (Song et al. eq. 12), eps from the
        predicted x0; no noise at t == 0. Returns (x_{t-1}, predicted x0)."""
        _, _, _, pred_x0 = self.p_mean_variance(model_out, x_t, t, model_mean_type,
                                                model_var_type, clip_x0)
        eps = self.predict_eps_from_x0(x_t, t, pred_x0)
        ab = self._ext("alphas_cumprod", t, x_t.dim())
        ab_prev = self._ext("alphas_cumprod_prev", t, x_t.dim())
        sigma = eta * torch.sqrt((1 - ab_prev) / (1 - ab)) * torch.sqrt(1 - ab / ab_prev)
        mean_pred = pred_x0 * torch.sqrt(ab_prev) + torch.sqrt(1 - ab_prev - sigma.square()) * eps
        nonzero = (t != 0).to(x_t.dtype).reshape((-1,) + (1,) * (x_t.dim() - 1))
        return mean_pred + nonzero * sigma * noise, pred_x0

    def ddim_reverse_step(self, model_out, x_t, t, model_mean_type: str = "eps",
                          model_var_type: str = "fixed_small", clip_x0: bool = False):
        """The deterministic encoding x_t -> x_{t+1} (eta 0)."""
        _, _, _, pred_x0 = self.p_mean_variance(model_out, x_t, t, model_mean_type,
                                                model_var_type, clip_x0)
        eps = self.predict_eps_from_x0(x_t, t, pred_x0)
        ab_next = self._ext("alphas_cumprod_next", t, x_t.dim())
        return pred_x0 * torch.sqrt(ab_next) + torch.sqrt(1 - ab_next) * eps

    @torch.no_grad()
    def ddim_sample_loop(self, denoise_fn: Callable, shape, model_mean_type: str = "eps",
                         model_var_type: str = "fixed_small", clip_x0: bool = False,
                         eta: float = 0.0, generator: Optional[torch.Generator] = None,
                         noise: Optional[Sequence[torch.Tensor]] = None, device=None):
        """DDIM sampling from noise; the draws as in `p_sample_loop`."""
        x = _noise(noise, 0, shape, generator, device)
        for i in range(self.num_timesteps):
            t = self._steps(shape[0], i, x.device)
            out = denoise_fn(x, self.map_t(t))
            z = _noise(noise, 1 + i, shape, generator, x.device)
            x, _ = self.ddim_step(out, x, t, z, model_mean_type, model_var_type, clip_x0, eta)
        return x

    # training
    def training_losses(self, denoise_fn: Callable, x0, t, loss_type: str = "rescaled_mse",
                        model_mean_type: str = "eps", model_var_type: str = "learned_range",
                        noise=None, generator: Optional[torch.Generator] = None):
        """({"loss", "mse" and / or "vb"} each [N], x_t): the mean-flattened
        MSE of the mean head (plus the VLB on the frozen-mean variance head
        under learned_range, scaled by T / 1000 for rescaled_mse), or the
        VLB alone for kl (scaled by T for rescaled_kl)."""
        if noise is None:
            noise = torch.randn(x0.shape, generator=generator, device=x0.device)
        x_t = self.q_sample(x0, t, noise)
        out = denoise_fn(x_t, self.map_t(t))
        losses = {}
        if loss_type in ("mse", "rescaled_mse"):
            mean_part = out
            if model_var_type == "learned_range":
                mean_part = out.chunk(2, dim=-1)[0]
                scale = self.num_timesteps / 1000.0 if loss_type == "rescaled_mse" else 1.0
                losses["vb"] = self.vb_term(out, x0, x_t, t, model_mean_type,
                                            model_var_type) * scale
            if model_mean_type == "prev_x":
                target = self.q_posterior(x0, x_t, t)[0]
            else:
                target = noise if model_mean_type == "eps" else x0
            losses["mse"] = mean_flat((target - mean_part).square())
            losses["loss"] = losses["mse"] + losses["vb"] if "vb" in losses else losses["mse"]
        else:
            vb = self.vb_term(out, x0, x_t, t, model_mean_type, model_var_type,
                              freeze_mean=False)
            losses["vb"] = vb * self.num_timesteps if loss_type == "rescaled_kl" else vb
            losses["loss"] = losses["vb"]
        return losses, x_t

    # evaluation
    def prior_bpd(self, x0):
        """KL(q(x_T | x0) || N(0, I)) in bits [N]."""
        t = torch.full((x0.shape[0],), self.num_timesteps - 1, dtype=torch.int32,
                       device=x0.device)
        mean = self._ext("sqrt_ac", t, x0.dim()) * x0
        logvar = torch.log(self._ext("one_minus_ac", t, x0.dim()))
        return mean_flat(0.5 * (-1.0 - logvar + torch.exp(logvar) + mean.square())) / math.log(2.0)

    @torch.no_grad()
    def calc_bpd_loop(self, denoise_fn: Callable, x0, model_mean_type: str = "eps",
                      model_var_type: str = "learned_range", clip_x0: bool = True,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[Sequence[torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """The full bound over every step: total_bpd [N], prior_bpd [N], vb
        and mse [N, T] (t ascending). `noise[i]` is the draw of loop step i
        (t = T - 1 - i), else from `generator`."""
        vbs, mses = [], []
        for i in range(self.num_timesteps):
            t = self._steps(x0.shape[0], i, x0.device)
            x_t = self.q_sample(x0, t, _noise(noise, i, x0.shape, generator, x0.device))
            out = denoise_fn(x_t, self.map_t(t))
            vbs.append(self.vb_term(out, x0, x_t, t, model_mean_type, model_var_type,
                                    clip_x0=clip_x0, freeze_mean=False))
            _, _, _, pred_x0 = self.p_mean_variance(out, x_t, t, model_mean_type,
                                                    model_var_type, clip_x0)
            mses.append(mean_flat((pred_x0 - x0).square()))
        vb = torch.stack(vbs, dim=1).flip(1)
        mse = torch.stack(mses, dim=1).flip(1)
        prior = self.prior_bpd(x0)
        return dict(total_bpd=vb.sum(1) + prior, prior_bpd=prior, vb=vb, mse=mse)


def create_diffusion(timestep_respacing: str = "", noise_schedule: str = "linear",
                     use_kl: bool = False, sigma_small: bool = False, predict_xstart: bool = False,
                     learn_sigma: bool = True, rescale_learned_sigmas: bool = False,
                     diffusion_steps: int = 1000):
    """(GaussianDiffusion, its config) with create_diffusion's flags and
    defaults (diffusion/__init__.py:10-46: the linear schedule, learned
    sigmas, use_kl as rescaled_kl)."""
    gd = GaussianDiffusion.create(diffusion_steps, noise_schedule, timestep_respacing)
    cfg = dict(model_mean_type="x_start" if predict_xstart else "eps",
               model_var_type=("learned_range" if learn_sigma else
                               "fixed_small" if sigma_small else "fixed_large"),
               loss_type=("rescaled_kl" if use_kl else
                          "rescaled_mse" if rescale_learned_sigmas else "mse"))
    return gd, cfg
