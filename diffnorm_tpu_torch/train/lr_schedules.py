"""Learning-rate schedules (the port's copy of diffnorm_tpu/train/lr_schedules.py:
inverse_sqrt, the one both DiffNorm recipes use)."""

from __future__ import annotations

import math
from typing import Callable


def inverse_sqrt(lr: float, warmup_updates: int, warmup_init_lr: float
                 ) -> Callable[[int], float]:
    """The lr of the update that follows `step` finished updates: linear
    from warmup_init_lr to lr over warmup_updates, then
    lr * sqrt(warmup_updates / step) (lr_schedules.py:18-32)."""
    lr_step = (lr - warmup_init_lr) / warmup_updates if warmup_updates > 0 else 0.0
    decay = lr * math.sqrt(warmup_updates)

    def schedule(step: int) -> float:
        if step < warmup_updates:
            return warmup_init_lr + lr_step * step
        return decay / math.sqrt(max(step, 1))

    return schedule
