"""The optimizers of the port's trainers, written on tensors.

`FairseqAdam` is fairseq's Adam (the port's copy of
diffnorm_tpu/train/optimizers.py:30-73): eps goes in before the bias
corrections, update = sqrt(1 - b2^t) / (1 - b1^t) * m / (sqrt(v) + eps).
torch.optim.Adam adds eps to the corrected sqrt(v_hat) instead, a different
trajectory. Weight decay is decoupled and lr-scaled: p <- p - lr * (update
+ wd * p).

`OptaxAdamW` is `optax.adamw(optax.exponential_decay(lr, decay_steps,
decay_rate), b1, b2)` as the GAN trainer builds it: eps 1e-8 added to
sqrt(v_hat), optax's default weight decay 1e-4 on every parameter (torch's
AdamW defaults to 1e-2), and a continuous decay, lr * decay_rate ^
(count / decay_steps) at the count before the update (torch's ExponentialLR
steps once per call).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch


class FairseqAdam:
    """Adam over float32 master parameters; `step` takes their gradients."""

    def __init__(self, params: Sequence[torch.Tensor], betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0):
        self.params = list(params)
        self.betas, self.eps, self.weight_decay = tuple(betas), eps, weight_decay
        self.exp_avg = [torch.zeros_like(p) for p in self.params]
        self.exp_avg_sq = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], lr: float) -> None:
        b1, b2 = self.betas
        self.count += 1
        step_size = lr * math.sqrt(1.0 - b2 ** self.count) / (1.0 - b1 ** self.count)
        torch._foreach_mul_(self.exp_avg, b1)
        torch._foreach_add_(self.exp_avg, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.exp_avg_sq, b2)
        torch._foreach_addcmul_(self.exp_avg_sq, grads, grads, value=1.0 - b2)
        denom = torch._foreach_sqrt(self.exp_avg_sq)
        torch._foreach_add_(denom, self.eps)
        if self.weight_decay:
            torch._foreach_add_(self.params, self.params, alpha=-self.weight_decay * lr)
        torch._foreach_addcdiv_(self.params, self.exp_avg, denom, value=-step_size)

    def state_dict(self) -> Dict:
        return {"count": self.count, "exp_avg": self.exp_avg, "exp_avg_sq": self.exp_avg_sq}

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        for mine, saved in ((self.exp_avg, state["exp_avg"]),
                            (self.exp_avg_sq, state["exp_avg_sq"])):
            if len(mine) != len(saved):
                raise ValueError(f"optimizer state for {len(saved)} parameters, "
                                 f"the model trains {len(mine)}")
            for t, s in zip(mine, saved):
                t.copy_(s)


class OptaxAdamW:
    """optax.adamw over float32 parameters with an exponential-decay
    schedule; `step` takes their gradients. Per parameter, at count t (1 for
    the first update): m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2,
    p <- p - lr(t - 1) * (m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps)
    + wd * p)."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float, betas: Tuple[float, float],
                 eps: float = 1e-8, weight_decay: float = 1e-4, decay_steps: int = 1000,
                 decay_rate: float = 1.0):
        self.params = list(params)
        self.lr, self.betas, self.eps, self.weight_decay = lr, tuple(betas), eps, weight_decay
        self.decay_steps, self.decay_rate = decay_steps, decay_rate
        self.exp_avg = [torch.zeros_like(p) for p in self.params]
        self.exp_avg_sq = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def lr_at(self, count: int) -> float:
        """optax.exponential_decay(lr, decay_steps, decay_rate) at `count`."""
        return self.lr * self.decay_rate ** (count / self.decay_steps)

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        b1, b2 = self.betas
        lr = self.lr_at(self.count)
        self.count += 1
        torch._foreach_mul_(self.exp_avg, b1)
        torch._foreach_add_(self.exp_avg, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.exp_avg_sq, b2)
        torch._foreach_addcmul_(self.exp_avg_sq, grads, grads, value=1.0 - b2)
        m_hat = torch._foreach_div(self.exp_avg, 1.0 - b1 ** self.count)
        denom = torch._foreach_sqrt(torch._foreach_div(self.exp_avg_sq, 1.0 - b2 ** self.count))
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(m_hat, denom)
        torch._foreach_add_(update, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, update, alpha=-lr)

    # the same state as FairseqAdam's: the count and both moments
    state_dict = FairseqAdam.state_dict
    load_state_dict = FairseqAdam.load_state_dict
