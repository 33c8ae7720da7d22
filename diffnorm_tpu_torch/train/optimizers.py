"""fairseq's Adam (the port's copy of diffnorm_tpu/train/optimizers.py:30-73).

eps goes in before the bias corrections: update = sqrt(1 - b2^t) /
(1 - b1^t) * m / (sqrt(v) + eps). torch.optim.Adam adds eps to the
corrected sqrt(v_hat) instead, a different trajectory. Weight decay is
decoupled and lr-scaled: p <- p - lr * (update + wd * p).
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
