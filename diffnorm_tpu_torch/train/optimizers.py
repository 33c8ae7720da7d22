"""The optimizers of the port's trainers, written on tensors.

The port's copy of diffnorm_tpu/train/optimizers.py. JAX builds its
optimizers from optax transforms; so does this module, each a `Transform`
on lists of tensors (one per parameter, in the trainer's order) with the
update rule of its optax or fairseq counterpart, not torch.optim's: their
trajectories differ (eps placement, the form of weight decay, adafactor's
factored moments). A transform maps gradients to updates and keeps its own
state (counts and moments), all of which `state_dict` returns, so a resume
continues exactly. `build_optimizer` chains them as JAX's does, and the
`Optimizer` it returns adds the final updates to the parameters.

"adam" is fairseq's Adam (JAX's scale_by_fairseq_adam with decoupled weight
decay): eps goes in before the bias corrections, update = sqrt(1 - b2^t) /
(1 - b1^t) * m / (sqrt(v) + eps); torch.optim.Adam adds eps to the corrected
sqrt(v_hat) instead, a different trajectory.

`OptaxAdamW` is `optax.adamw(optax.exponential_decay(lr, decay_steps,
decay_rate), b1, b2)` as the GAN trainer builds it: eps 1e-8 added to
sqrt(v_hat), optax's default weight decay 1e-4 on every parameter (torch's
AdamW defaults to 1e-2), and a continuous decay, lr * decay_rate ^
(count / decay_steps) at the count before the update (torch's ExponentialLR
steps once per call).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from diffnorm_tpu_torch.train.lr_schedules import build_lr_schedule

Tensors = List[torch.Tensor]


def _zeros(params: Sequence[torch.Tensor]) -> Tensors:
    return [torch.zeros_like(p) for p in params]


def _copy_into(mine: Tensors, saved: Sequence[torch.Tensor]) -> None:
    if len(mine) != len(saved):
        raise ValueError(f"optimizer state for {len(saved)} parameters, the model trains "
                         f"{len(mine)}")
    with torch.no_grad():
        for t, s in zip(mine, saved):
            t.copy_(s)


def _betas(value, default: Tuple[float, float]) -> Tuple[float, float]:
    if value is None:
        return default
    if isinstance(value, str):
        value = [float(b) for b in value.strip("()[] ").split(",")]
    return tuple(float(b) for b in value)


class Transform:
    """One optax GradientTransformation: `update(updates, params)` maps
    per-parameter tensors to new ones and advances the state. Its state is
    its tensor lists (`_lists`, one tensor a parameter, of its shape) and
    scalars (`_scalars`). `elementwise` transforms act on each element
    alone, so they run on slices of the parameters (--zero-sharding os,
    --fsdp) as on the whole."""

    _lists: Tuple[str, ...] = ()
    _scalars: Tuple[str, ...] = ()
    elementwise = True

    def update(self, updates: Tensors, params: Tensors) -> Tensors:
        raise NotImplementedError

    def children(self) -> List[Tuple["Transform", Optional[List[int]]]]:
        """The inner transforms and the positions of their parameters among
        this one's (None: all of them, in order)."""
        return []

    def param_lists(self, index: Sequence[int]):
        """(owner, attribute, parameter indices): every per-parameter state
        list of this transform and those inside it, each entry's index among
        the optimizer's parameters (`index` maps this transform's
        positions)."""
        for name in self._lists:
            yield self, name, list(index)
        for child, positions in self.children():
            sub = list(index) if positions is None else [index[i] for i in positions]
            yield from child.param_lists(sub)

    def is_elementwise(self) -> bool:
        return self.elementwise and all(c.is_elementwise() for c, _ in self.children())

    def state_dict(self) -> Dict:
        return {name: getattr(self, name) for name in self._lists + self._scalars}

    def load_state_dict(self, state: Mapping) -> None:
        for name in self._lists:
            _copy_into(getattr(self, name), state[name])
        for name in self._scalars:
            setattr(self, name, state[name])


class Chain(Transform):
    def __init__(self, *transforms: Transform):
        self.transforms = list(transforms)

    def children(self):
        return [(t, None) for t in self.transforms]

    def update(self, updates, params):
        for t in self.transforms:
            updates = t.update(updates, params)
        return updates

    def state_dict(self):
        return {"chain": [t.state_dict() for t in self.transforms]}

    def load_state_dict(self, state):
        for t, s in zip(self.transforms, state["chain"]):
            t.load_state_dict(s)


class Scale(Transform):
    def __init__(self, factor: float):
        self.factor = factor

    def update(self, updates, params):
        return torch._foreach_mul(updates, self.factor)


class ScaleBySchedule(Transform):
    """optax.scale_by_schedule: multiply by `fn(count)`, count the updates."""
    _scalars = ("count",)

    def __init__(self, fn: Callable[[int], float]):
        self.fn, self.count = fn, 0

    def update(self, updates, params):
        factor = self.fn(self.count)
        self.count += 1
        return torch._foreach_mul(updates, factor)


def scale_by_learning_rate(schedule: Optional[Callable[[int], float]],
                           flip_sign: bool = True) -> Transform:
    """optax.scale_by_learning_rate: -lr(count) (lr(count) unflipped); the
    identity without a schedule."""
    if schedule is None:
        return Chain()
    sign = -1.0 if flip_sign else 1.0
    return ScaleBySchedule(lambda count: sign * schedule(count))


class AddDecayedWeights(Transform):
    """optax.add_decayed_weights: u + wd * p."""

    def __init__(self, weight_decay: float):
        self.weight_decay = weight_decay

    def update(self, updates, params):
        if not self.weight_decay:
            return updates
        return torch._foreach_add(updates, params, alpha=self.weight_decay)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


class ClipByGlobalNorm(Transform):
    """optax.clip_by_global_norm: u * (max_norm / ||u||) where the global
    norm is at least max_norm (one factor, computed on the device: no host
    sync). `norm_fn` is the norm of the whole from the updates given (the
    sharded trainer's sums over the ranks' slices)."""

    def __init__(self, max_norm: float):
        self.max_norm = max_norm
        self.norm_fn: Callable[[Sequence[torch.Tensor]], torch.Tensor] = global_norm

    def update(self, updates, params):
        norm = self.norm_fn(updates)
        factor = torch.where(norm < self.max_norm, torch.ones_like(norm),
                             self.max_norm / norm)
        return torch._foreach_mul(updates, factor)


class ScaleByFairseqAdam(Transform):
    """fairseq's Adam moments (JAX scale_by_fairseq_adam)."""
    _lists, _scalars = ("exp_avg", "exp_avg_sq"), ("count",)

    def __init__(self, params, b1: float, b2: float, eps: float):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.exp_avg, self.exp_avg_sq, self.count = _zeros(params), _zeros(params), 0

    def update(self, updates, params):
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.exp_avg, b1)
        torch._foreach_add_(self.exp_avg, updates, alpha=1.0 - b1)
        torch._foreach_mul_(self.exp_avg_sq, b2)
        torch._foreach_addcmul_(self.exp_avg_sq, updates, updates, value=1.0 - b2)
        self.count += 1
        scale = math.sqrt(1.0 - b2 ** self.count) / (1.0 - b1 ** self.count)
        denom = torch._foreach_sqrt(self.exp_avg_sq)
        torch._foreach_add_(denom, self.eps)
        out = torch._foreach_mul(self.exp_avg, scale)  # JAX's scale * m / denom
        torch._foreach_div_(out, denom)
        return out


class ScaleByFairseqAdamax(Transform):
    """fairseq's Adamax (JAX scale_by_fairseq_adamax): m an EMA of g,
    u = max(b2 * u, |g|) with no eps inside the max, update = m / ((u + eps)
    * (1 - b1^t)) (bias correction 1 when off)."""
    _lists, _scalars = ("exp_avg", "exp_inf"), ("count",)

    def __init__(self, params, b1: float, b2: float, eps: float, bias_correction: bool = True):
        self.b1, self.b2, self.eps, self.bias_correction = b1, b2, eps, bias_correction
        self.exp_avg, self.exp_inf, self.count = _zeros(params), _zeros(params), 0

    def update(self, updates, params):
        torch._foreach_mul_(self.exp_avg, self.b1)
        torch._foreach_add_(self.exp_avg, updates, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.exp_inf, self.b2)
        torch._foreach_maximum_(self.exp_inf, torch._foreach_abs(updates))
        self.count += 1
        bc = 1.0 - self.b1 ** self.count if self.bias_correction else 1.0
        denom = torch._foreach_add(self.exp_inf, self.eps)
        torch._foreach_mul_(denom, bc)
        return torch._foreach_div(self.exp_avg, denom)


class ScaleByAdam(Transform):
    """optax.scale_by_adam: m_hat / (sqrt(v_hat) + eps), eps after the bias
    corrections."""
    _lists, _scalars = ("mu", "nu"), ("count",)

    def __init__(self, params, b1: float, b2: float, eps: float):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu, self.nu, self.count = _zeros(params), _zeros(params), 0

    def update(self, updates, params):
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, updates, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, updates, updates, value=1.0 - self.b2)
        self.count += 1
        mu_hat = torch._foreach_div(self.mu, 1.0 - self.b1 ** self.count)
        denom = torch._foreach_sqrt(torch._foreach_div(self.nu, 1.0 - self.b2 ** self.count))
        torch._foreach_add_(denom, self.eps)
        return torch._foreach_div(mu_hat, denom)


class ScaleByTrustRatio(Transform):
    """optax.scale_by_trust_ratio: u * ||p|| / ||u|| per parameter (1 where
    either norm is 0)."""
    elementwise = False  # per-parameter norms

    def update(self, updates, params):
        p_norm = torch._foreach_norm(params)
        u_norm = torch._foreach_norm(updates)
        ratios = [torch.where((pn == 0) | (un == 0), torch.ones_like(pn), pn / un)
                  for pn, un in zip(p_norm, u_norm)]
        return torch._foreach_mul(updates, ratios)


class ScaleByAdadelta(Transform):
    """optax.scale_by_adadelta: E[g^2] first, u = sqrt(E[dx^2] + eps) /
    sqrt(E[g^2] + eps) * g, then E[dx^2] from u."""
    _lists = ("e_g", "e_x")

    def __init__(self, params, rho: float, eps: float):
        self.rho, self.eps = rho, eps
        self.e_g, self.e_x = _zeros(params), _zeros(params)

    def update(self, updates, params):
        torch._foreach_mul_(self.e_g, self.rho)
        torch._foreach_addcmul_(self.e_g, updates, updates, value=1.0 - self.rho)
        num = torch._foreach_sqrt(torch._foreach_add(self.e_x, self.eps))
        den = torch._foreach_sqrt(torch._foreach_add(self.e_g, self.eps))
        out = torch._foreach_mul(torch._foreach_div(num, den), updates)
        torch._foreach_mul_(self.e_x, self.rho)
        torch._foreach_addcmul_(self.e_x, out, out, value=1.0 - self.rho)
        return out


class ScaleByRss(Transform):
    """optax.scale_by_rss (adagrad): s += g^2; u = g / sqrt(s + eps), 0 where
    s is 0."""
    _lists = ("sum_of_squares",)

    def __init__(self, params, initial_accumulator_value: float, eps: float = 1e-7):
        self.eps = eps
        self.sum_of_squares = [torch.full_like(p, initial_accumulator_value) for p in params]

    def update(self, updates, params):
        torch._foreach_addcmul_(self.sum_of_squares, updates, updates)
        return [torch.where(s > 0, u * torch.rsqrt(s + self.eps), torch.zeros_like(u))
                for s, u in zip(self.sum_of_squares, updates)]


class Trace(Transform):
    """optax.trace (sgd momentum): t = g + decay * t; nesterov: g + decay * t."""
    _lists = ("trace",)

    def __init__(self, params, decay: float, nesterov: bool = False):
        self.decay, self.nesterov = decay, nesterov
        self.trace = _zeros(params)

    def update(self, updates, params):
        torch._foreach_mul_(self.trace, self.decay)
        torch._foreach_add_(self.trace, updates)
        if self.nesterov:
            return torch._foreach_add(updates, self.trace, alpha=self.decay)
        return [t.clone() for t in self.trace]


def _factored_dims(shape, min_dim_size_to_factor: int):
    """optax's: the two largest dims (second largest, largest) of a tensor of
    rank >= 2 whose second largest dim is >= min_dim_size_to_factor."""
    if len(shape) < 2:
        return None
    order = sorted(range(len(shape)), key=lambda i: shape[i])  # stable, as np.argsort here
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return order[-2], order[-1]


class ScaleByFactoredRms(Transform):
    """optax.scale_by_factored_rms (adafactor's second moments): for a
    factored parameter the row and column means of g^2 + eps, each an EMA
    at decay 1 - (t + 1)^-decay_rate, and u = g * (v_row / mean(v_row))^-1/2
    * v_col^-1/2; otherwise a full EMA v and u = g * v^-1/2."""
    _lists, _scalars = ("v_row", "v_col", "v"), ("count",)
    elementwise = False  # factored moments: row and column means

    def __init__(self, params, decay_rate: float = 0.8, min_dim_size_to_factor: int = 128,
                 eps: float = 1e-30):
        self.decay_rate, self.min_dim, self.eps = decay_rate, min_dim_size_to_factor, eps
        self.count = 0
        self.shapes = [tuple(p.shape) for p in params]
        self.dims = [_factored_dims(shape, min_dim_size_to_factor) for shape in self.shapes]
        one = lambda p: torch.zeros(1, dtype=p.dtype, device=p.device)  # noqa: E731
        self.v_row, self.v_col, self.v = [], [], []
        for p, dims in zip(params, self.dims):
            if dims is None:
                self.v_row.append(one(p))
                self.v_col.append(one(p))
                self.v.append(torch.zeros_like(p))
            else:
                d1, d0 = dims
                self.v_row.append(torch.zeros_like(p).mean(dim=d0))
                self.v_col.append(torch.zeros_like(p).mean(dim=d1))
                self.v.append(one(p))

    def update(self, updates, params):
        beta = 1.0 - (self.count + 1.0) ** (-self.decay_rate)
        self.count += 1
        out = []
        for i, (g, dims) in enumerate(zip(updates, self.dims)):
            g_sq = g.square() + self.eps
            if dims is None:
                self.v[i] = beta * self.v[i] + (1.0 - beta) * g_sq
                out.append(g * self.v[i].rsqrt())
                continue
            d1, d0 = dims
            self.v_row[i] = beta * self.v_row[i] + (1.0 - beta) * g_sq.mean(dim=d0)
            self.v_col[i] = beta * self.v_col[i] + (1.0 - beta) * g_sq.mean(dim=d1)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_factor = (self.v_row[i] / self.v_row[i].mean(dim=reduced_d1, keepdim=True)).rsqrt()
            col_factor = self.v_col[i].rsqrt()
            out.append(g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1))
        return out

    def load_state_dict(self, state):
        for name in self._lists:  # factored moments change shape per parameter
            setattr(self, name, [s.to(p.device) for s, p in zip(state[name], getattr(self, name))])
        self.count = state["count"]


def _rms(x: torch.Tensor, floor: float) -> torch.Tensor:
    rms = x.square().mean().sqrt()
    return torch.where(rms <= floor, torch.full_like(rms, floor), rms)


class ClipByBlockRms(Transform):
    """optax.clip_by_block_rms: u / max(1, rms(u) / threshold) per parameter."""
    elementwise = False  # per-parameter norms

    def __init__(self, threshold: float):
        self.threshold = threshold

    def update(self, updates, params):
        return [u / torch.clamp(u.square().mean().sqrt() / self.threshold, min=1.0)
                for u in updates]


class ScaleByParamBlockRms(Transform):
    """optax.scale_by_param_block_rms: u * max(rms(p), min_scale)."""
    elementwise = False  # per-parameter norms

    def __init__(self, min_scale: float = 1e-3):
        self.min_scale = min_scale

    def update(self, updates, params):
        return [u * _rms(p, self.min_scale) for u, p in zip(updates, params)]


class FairseqNag(Transform):
    """fairseq's NAG (nag.py:62-108) with its lr correction lr / lr_old
    inside the momentum buffer, so it calls the schedule itself:
    u = -lr wd p + m^2 (lr / lr_old) buf - (1 + m) lr g;
    buf <- m (lr / lr_old) buf - lr g."""
    _lists, _scalars = ("buf",), ("count", "lr_old")

    def __init__(self, params, schedule, momentum: float, weight_decay: float):
        self.schedule, self.momentum, self.weight_decay = schedule, momentum, weight_decay
        self.buf, self.count, self.lr_old = _zeros(params), 0, float(schedule(0))

    def update(self, updates, params):
        lr, m = float(self.schedule(self.count)), self.momentum
        correct = lr / self.lr_old if self.lr_old > 0 else lr
        out = torch._foreach_mul(params, -lr * self.weight_decay)
        torch._foreach_add_(out, self.buf, alpha=m * m * correct)
        torch._foreach_add_(out, updates, alpha=-(1.0 + m) * lr)
        torch._foreach_mul_(self.buf, m * correct)
        torch._foreach_add_(self.buf, updates, alpha=-lr)
        self.count, self.lr_old = self.count + 1, lr
        return out


class Composite(Transform):
    """optax.multi_transform: each top-level parameter group (`labels`, one
    per parameter) through its own transform, built on its parameters."""

    def __init__(self, params, labels: Sequence[str], factories: Dict[str, Callable]):
        self.index = {name: [i for i, lab in enumerate(labels) if lab == name]
                      for name in factories}
        self.transforms = {name: make([params[i] for i in self.index[name]])
                           for name, make in factories.items()}

    def children(self):
        return [(t, self.index[name]) for name, t in self.transforms.items()]

    def update(self, updates, params):
        out = list(updates)
        for name, t in self.transforms.items():
            idx = self.index[name]
            if idx:
                for i, u in zip(idx, t.update([updates[i] for i in idx],
                                              [params[i] for i in idx])):
                    out[i] = u
        return out

    def state_dict(self):
        return {name: t.state_dict() for name, t in self.transforms.items()}

    def load_state_dict(self, state):
        for name, t in self.transforms.items():
            t.load_state_dict(state[name])


class FreezeFinetune(Transform):
    """--freeze-finetune-updates (hubert_asr.py:310-316): for the first
    n_updates updates the gradients of the `frozen` parameters are zeroed
    before the inner chain and their updates after it, so they stay
    exactly as they are (their moments stay 0, and clipping sees the gated
    gradients)."""
    _scalars = ("count",)

    def __init__(self, inner: Transform, n_updates: int, frozen: Sequence[bool]):
        self.inner, self.n_updates, self.frozen, self.count = inner, n_updates, list(frozen), 0

    def children(self):
        return [(self.inner, None)]

    def _gate(self, tensors: Tensors, live: bool) -> Tensors:
        if live:
            return tensors
        return [t * 0.0 if f else t for t, f in zip(tensors, self.frozen)]

    def update(self, updates, params):
        live = self.count >= self.n_updates
        out = self._gate(self.inner.update(self._gate(updates, live), params), live)
        self.count += 1
        return out

    def state_dict(self):
        return {"count": self.count, "inner": self.inner.state_dict()}

    def load_state_dict(self, state):
        self.count = state["count"]
        self.inner.load_state_dict(state["inner"])


class Bmuf(Transform):
    """Block-momentum model update filtering (JAX optimizers.py:380-445,
    reference fairseq/optim/bmuf.py; --use-bmuf, --ddp-backend slowmo)
    around `base`: the base chain's update gives the block's parameters
    p' = p + u; every `sync_freq`-th update the block's move from the last
    global model g, p' - g, passes through a momentum filter, m <- bm * m +
    block_lr * (1 - bm) * (p' - g), the global model moves g <- g + m, and
    the parameters snap to g + bm * m (Nesterov, `use_nesterov`) or to g.
    The update returned is the new parameters less the old, as JAX's. Under
    data parallelism the ranks' parameters are equal after the gradient
    all-reduce, so the filter needs no collective of its own, as in JAX."""
    _lists, _scalars = ("global_params", "smoothed"), ("step",)

    def __init__(self, base: Transform, params, sync_freq: int = 50,
                 block_momentum: float = 0.875, block_lr: float = 1.0,
                 use_nesterov: bool = True):
        self.base, self.sync_freq = base, int(sync_freq)
        self.block_momentum, self.block_lr = float(block_momentum), float(block_lr)
        self.use_nesterov, self.step = bool(use_nesterov), 0
        self.global_params = [p.detach().clone() for p in params]
        self.smoothed = _zeros(params)

    def children(self):
        return [(self.base, None)]

    def update(self, updates, params):
        prelim = torch._foreach_add(params, self.base.update(updates, params))
        self.step += 1
        if self.step % self.sync_freq == 0:
            bm = self.block_momentum
            blk = torch._foreach_sub(self.global_params, prelim)  # global - params
            torch._foreach_mul_(self.smoothed, bm)
            torch._foreach_add_(self.smoothed, blk, alpha=-self.block_lr * (1.0 - bm))
            torch._foreach_add_(self.global_params, self.smoothed)
            prelim = (torch._foreach_add(self.global_params, self.smoothed, alpha=bm)
                      if self.use_nesterov else [g.clone() for g in self.global_params])
        return torch._foreach_sub(prelim, params)

    def state_dict(self):
        return {**super().state_dict(), "base": self.base.state_dict()}

    def load_state_dict(self, state):
        super().load_state_dict(state)
        self.base.load_state_dict(state["base"])


def uses_bmuf(cfg: Mapping) -> bool:
    return bool(cfg.get("use_bmuf")) or cfg.get("ddp_backend") == "slowmo"


def zero_axis(shape: Sequence[int], data: int) -> Optional[int]:
    """--zero-sharding os's axis of one optimizer-state tensor (JAX
    shard_optimizer_state, optimizers.py:354-377): the first the data
    degree divides (and that holds at least `data` entries); None keeps it
    whole, as a 0-d state does."""
    if data <= 1:
        return None
    for axis, size in enumerate(shape):
        if size % data == 0 and size >= data:
            return axis
    return None


def shard_optimizer_state(state, mesh):
    """The spec of every tensor of an optimizer's state (a nested dict or
    list of tensors and numbers, `Optimizer.state_dict()`'s or optax's):
    ("data" on the `zero_axis`, None on the others) or () where it stays
    whole (JAX's shard_optimizer_state without the placement). The
    trainer splits each parameter's state on its parameter's axis by this
    rule (Trainer, --zero-sharding os)."""
    data = mesh.shape.get("data", 1)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            specs = [walk(v) for v in node]
            return type(node)(*specs) if hasattr(node, "_fields") else type(node)(specs)
        shape = tuple(getattr(node, "shape", ()))
        axis = zero_axis(shape, data) if shape else None
        if axis is None:
            return ()
        return tuple("data" if a == axis else None for a in range(len(shape)))

    return walk(state)


# ---------------------------------------------------------------- registry

def _opt(cfg: Mapping, key: str, default):
    """cfg[key], or `default` where it is unset (JAX's cfg.get(key, default))."""
    value = cfg.get(key)
    return default if value is None else value


def _adam(cfg, schedule, params):
    b1, b2 = _betas(cfg.get("adam_betas"), (0.9, 0.98))
    return Chain(ScaleByFairseqAdam(params, b1, b2, float(_opt(cfg, "adam_eps", 1e-8))),
                 AddDecayedWeights(float(_opt(cfg, "weight_decay", 0.0))),
                 scale_by_learning_rate(schedule))


def _adamax(cfg, schedule, params):
    b1, b2 = _betas(cfg.get("adamax_betas"), (0.9, 0.999))
    return Chain(ScaleByFairseqAdamax(params, b1, b2, float(_opt(cfg, "adamax_eps", 1e-8)),
                                      bias_correction=not cfg.get("no_bias_correction")),
                 AddDecayedWeights(float(_opt(cfg, "weight_decay", 0.0))),
                 scale_by_learning_rate(schedule))


def _adadelta(cfg, schedule, params):
    """torch's Adadelta placement: L2 decay into the gradient first, where
    it is set (JAX's chain has the transform only then)."""
    wd = float(_opt(cfg, "weight_decay", 0.0))
    return Chain(*([AddDecayedWeights(wd)] if wd else []),
                 ScaleByAdadelta(params, float(_opt(cfg, "adadelta_rho", 0.9)),
                                 float(_opt(cfg, "adadelta_eps", 1e-6))),
                 scale_by_learning_rate(schedule))


def _lamb(cfg, schedule, params):
    b1, b2 = _betas(cfg.get("lamb_betas"), (0.9, 0.999))
    return Chain(ScaleByAdam(params, b1, b2, float(_opt(cfg, "lamb_eps", 1e-8))),
                 AddDecayedWeights(float(_opt(cfg, "weight_decay", 0.0))),
                 ScaleByTrustRatio(), scale_by_learning_rate(schedule))


def _nag(cfg, schedule, params):
    return FairseqNag(params, schedule, float(_opt(cfg, "momentum", 0.99)),
                      float(_opt(cfg, "weight_decay", 0.0)))


def _adafactor(cfg, schedule, params):
    """optax.adafactor as JAX builds it: factored RMS (decay_rate 0.8), block
    RMS clipping at clip_threshold, lr, the parameter-scale factor, weight
    decay (when set), and the sign flip."""
    chain = [ScaleByFactoredRms(params, float(_opt(cfg, "decay_rate", 0.8)))]
    if _opt(cfg, "clip_threshold", 1.0) is not None:
        chain.append(ClipByBlockRms(float(_opt(cfg, "clip_threshold", 1.0))))
    if schedule is not None:  # pass_through: adafactor's relative steps
        chain.append(scale_by_learning_rate(schedule, flip_sign=False))
    chain.append(ScaleByParamBlockRms())
    if cfg.get("weight_decay"):
        chain.append(AddDecayedWeights(float(cfg["weight_decay"])))
    chain.append(Scale(-1.0))
    return Chain(*chain)


def _adagrad(cfg, schedule, params):
    return Chain(ScaleByRss(params, float(_opt(cfg, "initial_accumulator_value", 0.0))),
                 scale_by_learning_rate(schedule))


def _sgd(cfg, schedule, params):
    """optax.sgd: a trace with momentum, the identity without (an empty
    chain, as optax keeps an empty state there)."""
    momentum = cfg.get("momentum") or None
    trace = Trace(params, float(momentum), bool(cfg.get("nesterov"))) if momentum else Chain()
    return Chain(trace, scale_by_learning_rate(schedule))


def _composite(cfg, schedule, params, labels):
    """Per top-level group optimizers (fairseq composite.py): composite_groups
    maps a top-level key to an optimizer name or to a dict of overrides
    ({"optimizer": ..., "lr_scheduler": ..., "lr": ...}), a group with its
    own lr_scheduler following it; the other groups take composite_default."""
    groups = cfg.get("composite_groups") or {}
    default = cfg.get("composite_default") or "adam"

    def factory(spec):
        if isinstance(spec, str):
            return spec, lambda ps: OPTIMIZERS[spec](cfg, schedule, ps)
        sub = {**cfg, **spec}
        sub_schedule = schedule
        if "lr_scheduler" in spec:
            sub_schedule = build_lr_schedule(sub)
            if getattr(sub_schedule, "host_driven", False):
                raise ValueError("composite groups cannot use host-driven lr schedulers "
                                 "(manual / reduce_lr_on_plateau)")
        name = spec.get("optimizer", default)
        label = "::".join(f"{k}={spec[k]}" for k in sorted(spec)) or name
        return label, lambda ps: OPTIMIZERS[name](sub, sub_schedule, ps)

    factories = {default: lambda ps: OPTIMIZERS[default](cfg, schedule, ps)}
    key_label = {}
    for key, spec in groups.items():
        label, make = factory(spec)
        factories[label], key_label[key] = make, label
    return Composite(params, [key_label.get(lab, default) for lab in labels], factories)


OPTIMIZERS = {"adam": _adam, "adamax": _adamax, "adadelta": _adadelta, "lamb": _lamb,
              "nag": _nag, "adafactor": _adafactor, "adagrad": _adagrad, "sgd": _sgd}
OPTIMIZER_NAMES = tuple(sorted(OPTIMIZERS)) + ("composite",)


class Optimizer:
    """A transform chain over float32 master parameters: `step(grads,
    lr_value)` adds the chain's updates to the parameters (scaled by
    `lr_value` under a host-driven schedule). `count` is the number of
    updates applied."""

    def __init__(self, params: Sequence[torch.Tensor], transform: Transform):
        self.params, self.transform, self.count = list(params), transform, 0

    @torch.no_grad()
    def step(self, grads: Tensors, lr_value: Optional[float] = None) -> None:
        updates = self.transform.update(list(grads), self.params)
        if lr_value is not None:
            updates = torch._foreach_mul(updates, float(lr_value))
        torch._foreach_add_(self.params, updates)
        self.count += 1

    def state_dict(self) -> Dict:
        return {"count": self.count, "transform": self.transform.state_dict()}

    def load_state_dict(self, state: Mapping) -> None:
        self.count = int(state["count"])
        self.transform.load_state_dict(state["transform"])


def build_optimizer(cfg: Mapping, schedule, params: Sequence[torch.Tensor],
                    names: Sequence[str], clip_norm: float = 0.0) -> Optimizer:
    """JAX's build_optimizer (optimizers.py:297-351) over `params` (named
    `names`, "top.sub.weight"): the optimizer cfg["optimizer"] (adam by
    default) with `schedule`, after clipping to `clip_norm` and the static
    `loss_scale` (gradients divided by it first), under
    `freeze_finetune_updates` for the top-level keys
    `freeze_finetune_subtrees` (default ("w2v_model",)). A host-driven
    schedule builds it at unit lr (the trainer scales the updates), which
    nag cannot take; pass_through leaves adafactor its relative steps and
    composite groups their own schedules, and refuses other optimizers.
    `use_bmuf` (or `ddp_backend` "slowmo") wraps the chain in `Bmuf`
    (`global_sync_iter`, `block_momentum`, `block_lr`, `use_nbm`), which a
    host-driven schedule cannot take."""
    name = cfg.get("optimizer") or "adam"
    if name not in OPTIMIZER_NAMES:
        raise ValueError(f"unknown optimizer {name!r}; one of {OPTIMIZER_NAMES}"
                         + (" (BMUF wraps one: --use-bmuf)" if name == "bmuf" else ""))
    if getattr(schedule, "host_driven", False):
        if name == "nag":
            raise ValueError("nag's lr-corrected momentum needs the schedule inside the "
                             "optimizer; host-driven lr schedulers (manual, "
                             "reduce_lr_on_plateau) are not supported with --optimizer nag")
        if uses_bmuf(cfg):
            raise ValueError("BMUF's sync-step snap-to-global delta is not lr-linear; "
                             "host-driven lr schedulers (manual, reduce_lr_on_plateau) "
                             "are not supported with --use-bmuf/slowmo")
        schedule = lambda step: 1.0  # noqa: E731
    elif getattr(schedule, "pass_through", False):
        if name == "adafactor":
            schedule = None
        elif name != "composite":
            raise ValueError("--lr-scheduler pass_through needs an optimizer with its own "
                             "schedule (adafactor, or composite groups with per-group "
                             "lr_scheduler)")
    params = list(params)
    tops = [n.split(".")[0] for n in names]
    tx = (_composite(cfg, schedule, params, tops) if name == "composite"
          else OPTIMIZERS[name](cfg, schedule, params))
    chain = ([Scale(1.0 / float(cfg["loss_scale"]))] if cfg.get("loss_scale") else [])
    if clip_norm and clip_norm > 0:
        chain.append(ClipByGlobalNorm(clip_norm))
    tx = Chain(*chain, tx)
    if uses_bmuf(cfg):
        tx = Bmuf(tx, params, sync_freq=_opt(cfg, "global_sync_iter", 50),
                  block_momentum=_opt(cfg, "block_momentum", 0.875),
                  block_lr=_opt(cfg, "block_lr", 1.0), use_nesterov=_opt(cfg, "use_nbm", True))
    n_freeze = int(cfg.get("freeze_finetune_updates") or 0)
    if n_freeze > 0:
        subtrees = cfg.get("freeze_finetune_subtrees") or ("w2v_model",)
        tx = FreezeFinetune(tx, n_freeze, [t in tuple(subtrees) for t in tops])
    return Optimizer(params, tx)


class EMA:
    """An exponential moving average of the parameters (JAX optimizers.py
    EMA): a copy at `decay`, updated after every applied update as
    e * decay + p * (1 - decay)."""

    def __init__(self, params: Sequence[torch.Tensor], decay: float = 0.9999):
        self.decay = decay
        self.params = [p.detach().clone() for p in params]

    @torch.no_grad()
    def update(self, params: Sequence[torch.Tensor]) -> None:
        torch._foreach_mul_(self.params, self.decay)
        torch._foreach_add_(self.params, list(params), alpha=1.0 - self.decay)

    def state_dict(self) -> Dict:
        return {"decay": self.decay, "params": self.params}

    def load_state_dict(self, state: Mapping) -> None:
        _copy_into(self.params, state["params"])


class OptaxAdamW(Optimizer):
    """optax.adamw over float32 parameters with an exponential-decay
    schedule, as the GAN trainer builds it; `step` takes their gradients.
    Per parameter, at count t (1 for the first update): m = b1 m + (1 - b1)
    g, v = b2 v + (1 - b2) g^2, p <- p - lr(t - 1) * (m / (1 - b1^t) /
    (sqrt(v / (1 - b2^t)) + eps) + wd * p), lr(c) = lr * decay_rate ^ (c /
    decay_steps)."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float, betas: Tuple[float, float],
                 eps: float = 1e-8, weight_decay: float = 1e-4, decay_steps: int = 1000,
                 decay_rate: float = 1.0):
        params = list(params)
        super().__init__(params, Chain(
            ScaleByAdam(params, *betas, eps), AddDecayedWeights(weight_decay),
            scale_by_learning_rate(lambda count: lr * decay_rate ** (count / decay_steps))))
