"""Learning-rate schedules (the port's copy of diffnorm_tpu/train/lr_schedules.py).

A schedule is a callable of the update count, as an optax schedule is: the
trainer logs `schedule(num_updates)`, and the optimizer's learning-rate
transform calls it with its own count of applied updates
(`optimizers.ScaleByLearningRate`). The host-driven schedules, `manual` and
`reduce_lr_on_plateau`, are objects whose lr moves on host events instead:
`step_update` after every update, `step_begin_epoch` and `step_epoch` at
epoch boundaries (fairseq's FairseqLRScheduler hooks); the trainer then
builds the optimizer at unit lr and scales its final updates by their lr.

Each schedule reads the same configuration keys, with the same defaults, as
JAX's (`cfg` is a mapping: the training CLI's flags, or a TrainerConfig's
`optimization()` dict). `build_lr_schedule` picks one by `lr_scheduler`.
"""

from __future__ import annotations

import ast
import math
from typing import Callable, Dict, Mapping, Optional

Schedule = Callable[[int], float]


def _get(cfg: Mapping, key: str, default):
    value = cfg.get(key)
    return default if value is None else value


def inverse_sqrt(lr: float, warmup_updates: int, warmup_init_lr: float) -> Schedule:
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


def constant_schedule(value: float) -> Schedule:
    return lambda step: value


def polynomial_schedule(init_value: float, end_value: float, power: float,
                        transition_steps: int) -> Schedule:
    """optax.polynomial_schedule: (init - end) * (1 - min(step, T) / T)^power
    + end; the constant init_value when T <= 0."""
    if transition_steps <= 0:
        return constant_schedule(init_value)

    def schedule(step: int) -> float:
        frac = 1.0 - min(max(step, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac ** power + end_value

    return schedule


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    return polynomial_schedule(init_value, end_value, 1.0, transition_steps)


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """optax.cosine_decay_schedule: init * ((1 - alpha) * (1 + cos(pi *
    min(step, T) / T)) / 2 + alpha)."""
    if decay_steps <= 0:
        raise ValueError(f"the cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(step: int) -> float:
        frac = min(step, decay_steps) / decay_steps
        return init_value * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * frac)) + alpha)

    return schedule


def join_schedules(schedules, boundaries) -> Schedule:
    """optax.join_schedules: past each boundary the next schedule, called
    with the count since that boundary."""
    def schedule(step: int) -> float:
        out = schedules[0](step)
        for boundary, nxt in zip(boundaries, schedules[1:]):
            if step >= boundary:
                out = nxt(step - boundary)
        return out

    return schedule


def fixed(cfg: Mapping) -> Schedule:
    lr = float(_get(cfg, "lr", 5e-4))
    warmup = int(_get(cfg, "warmup_updates", 0))
    init_lr = float(_get(cfg, "warmup_init_lr", lr))
    return constant_schedule(lr) if warmup <= 0 else linear_schedule(init_lr, lr, warmup)


def cosine(cfg: Mapping) -> Schedule:
    """optax.warmup_cosine_decay_schedule: linear warmup (at least one
    update) from warmup_init_lr to lr, then the cosine to min_lr over
    max_updates - warmup."""
    lr = float(_get(cfg, "lr", 5e-4))
    warmup = max(int(_get(cfg, "warmup_updates", 0)), 1)
    init_lr = float(_get(cfg, "warmup_init_lr", 1e-7))
    total = max(int(_get(cfg, "max_updates", 100000)), warmup + 1)
    min_lr = float(_get(cfg, "min_lr", 1e-9))
    alpha = 0.0 if lr == 0.0 else min_lr / lr
    return join_schedules([linear_schedule(init_lr, lr, warmup),
                           cosine_decay_schedule(lr, total - warmup, alpha)], [warmup])


def polynomial_decay(cfg: Mapping) -> Schedule:
    lr = float(_get(cfg, "lr", 5e-4))
    warmup = int(_get(cfg, "warmup_updates", 0))
    total = int(_get(cfg, "max_updates", 100000))
    end_lr = float(_get(cfg, "end_learning_rate", 0.0))
    power = float(_get(cfg, "power", 1.0))
    decay = polynomial_schedule(lr, end_lr, power, max(total - warmup, 1))
    if warmup <= 0:
        return decay
    return join_schedules([linear_schedule(0.0, lr, warmup), decay], [warmup])


def step_lr(cfg: Mapping) -> Schedule:
    """Linear warmup from warmup_init_lr (default min_lr) to lr, then lr *
    lr_decay ^ ((step - warmup) // period), floored at min_lr
    (lr_schedules.py:81-108; the reference's flag is --lr-deacy-period)."""
    max_lr = float(_get(cfg, "lr", 5e-4))
    min_lr = float(_get(cfg, "min_lr", 0.0))
    period = int(_get(cfg, "lr_deacy_period", _get(cfg, "lr_decay_period", 25000)))
    decay = float(_get(cfg, "lr_decay", 0.5))
    warmup = int(_get(cfg, "warmup_updates", 0))
    init_lr = float(_get(cfg, "warmup_init_lr", -1))
    if init_lr < 0:
        init_lr = min_lr
    if not (period > 0 and decay <= 1 and min_lr >= 0 and max_lr > min_lr):
        raise ValueError("step: needs lr_decay_period > 0, lr_decay <= 1 and lr > min_lr >= 0")
    warmup_step = (max_lr - init_lr) / warmup if warmup > 0 else 1.0

    def schedule(step: int) -> float:
        if step < warmup:
            return init_lr + warmup_step * step
        return max(max_lr * decay ** math.floor(max(step - warmup, 0) / period), min_lr)

    return schedule


def triangular(cfg: Mapping) -> Schedule:
    """Cyclical: between lr and max_lr with period lr_period_updates, the
    peak (and with shrink_min the floor) shrunk by lr_shrink each cycle."""
    min_lr = float(_get(cfg, "lr", 5e-4))
    max_lr = float(_get(cfg, "max_lr", min_lr * 10))
    if max_lr <= min_lr:
        raise ValueError("triangular: max_lr must be more than lr")
    stepsize = int(float(_get(cfg, "lr_period_updates", 5000))) // 2
    shrink = float(_get(cfg, "lr_shrink", 0.1))
    shrink_min = bool(_get(cfg, "shrink_min", False))

    def schedule(step: int) -> float:
        cycle = math.floor(step / (2 * stepsize))
        sh = shrink ** cycle
        mx, mn = max_lr * sh, (min_lr * sh if shrink_min else min_lr)
        x = abs(step / stepsize - 2 * (cycle + 1) + 1)
        return mn + (mx - mn) * max(0.0, 1.0 - x)

    return schedule


def pass_through(cfg: Mapping) -> Schedule:
    """The optimizer owns the schedule (adafactor's relative steps, or
    composite groups with their own): the logged lr is 0, and
    `optimizers.build_optimizer` reads the marker."""
    def schedule(step: int) -> float:
        return 0.0

    schedule.pass_through = True
    return schedule


def tri_stage(cfg: Mapping) -> Schedule:
    lr = float(_get(cfg, "lr", 5e-4))
    warmup = int(_get(cfg, "warmup_steps", _get(cfg, "warmup_updates", 4000)))
    hold = int(_get(cfg, "hold_steps", 0))
    decay = int(_get(cfg, "decay_steps", 50000))
    init_scale = float(_get(cfg, "init_lr_scale", 0.01))
    final_scale = float(_get(cfg, "final_lr_scale", 0.01))
    decay_rate = -math.log(final_scale) / max(decay, 1)

    def schedule(step: int) -> float:
        if step < warmup:
            return lr * (init_scale + (1 - init_scale) * min(step / max(warmup, 1), 1.0))
        if step < warmup + hold:
            return lr
        return lr * math.exp(-decay_rate * min(max(step - warmup - hold, 0), decay))

    return schedule


class HostDrivenSchedule:
    """A schedule whose lr moves on host events (the trainer never calls
    it with a count): `step_update` after every update, `step_begin_epoch`
    and `step_epoch` at epoch boundaries, and a state dict that a
    checkpoint keeps."""

    host_driven = True
    lr: float = 0.0

    def __call__(self, step: int) -> float:
        raise TypeError(f"{type(self).__name__} is host-driven: the trainer scales the "
                        "updates by its lr instead of calling it with a count")

    def step_update(self, num_updates: int) -> float:
        return self.lr

    def step_begin_epoch(self, epoch: int) -> float:
        return self.lr

    def step_epoch(self, epoch: int, val_loss: Optional[float] = None) -> float:
        return self.lr

    def state_dict(self) -> Dict:
        return {"lr": self.lr}

    def load_state_dict(self, sd: Mapping) -> None:
        self.lr = float(sd.get("lr", self.lr))


def parse_manual_table(spec) -> Dict[int, float]:
    """--epoch2lr / --update2lr (manual_lr_scheduler.py:34-52): a dict whose
    keys are "1,2,3" (a list), "4-8" (an inclusive range) or "9"."""
    if isinstance(spec, str):
        spec = ast.literal_eval(spec.replace(" ", ""))
    if not isinstance(spec, dict):
        raise ValueError("epoch2lr / update2lr must evaluate to a dict")
    out = {}
    for key, val in spec.items():
        if isinstance(key, int):
            out[key] = float(val)
        elif "," in key:
            out.update({int(k): float(val) for k in key.split(",")})
        elif "-" in key:
            start, end = key.split("-")
            out.update({k: float(val) for k in range(int(start), int(end) + 1)})
        else:
            out[int(key)] = float(val)
    return out


class ManualSchedule(HostDrivenSchedule):
    """--lr-scheduler manual: the lr of the largest --epoch2lr key <= the
    epoch at each epoch start, and of --update2lr after each update; before
    any key the lr is left as it is."""

    def __init__(self, cfg: Mapping):
        self.epoch2lr = parse_manual_table(_get(cfg, "epoch2lr", "{}"))
        self.update2lr = parse_manual_table(_get(cfg, "update2lr", "{}"))
        if 1 in self.epoch2lr:
            self.lr = self.epoch2lr[1]
        elif 1 in self.update2lr:
            self.lr = self.update2lr[1]
        else:
            self.lr = float(_get(cfg, "lr", 5e-4))

    def _lookup(self, table: Dict[int, float], key: int) -> float:
        keys = [k for k in table if k <= key]
        return table[max(keys)] if keys else self.lr

    def step_begin_epoch(self, epoch: int) -> float:
        self.lr = self._lookup(self.epoch2lr, epoch)
        return self.lr

    def step_update(self, num_updates: int) -> float:
        self.lr = self._lookup(self.update2lr, num_updates)
        return self.lr


class ReduceLROnPlateauSchedule(HostDrivenSchedule):
    """--lr-scheduler reduce_lr_on_plateau (reduce_lr_on_plateau.py:57-146
    over torch's ReduceLROnPlateau defaults: relative threshold, cooldown 0,
    min_lr 0, eps 1e-8): an optional linear warmup by update, then lr *
    lr_shrink after more than lr_patience epochs without a validation
    improvement of lr_threshold (relative)."""

    def __init__(self, cfg: Mapping):
        lr = float(_get(cfg, "lr", 5e-4))
        self.factor = float(_get(cfg, "lr_shrink", 0.1))
        self.threshold = float(_get(cfg, "lr_threshold", 1e-4))
        self.patience = int(_get(cfg, "lr_patience", 0))
        self.mode = "max" if cfg.get("maximize_best_checkpoint_metric") else "min"
        self.warmup_updates = int(_get(cfg, "warmup_updates", 0))
        init_lr = float(_get(cfg, "warmup_init_lr", -1))
        if init_lr < 0:
            init_lr = 0.0 if self.warmup_updates > 0 else lr
        self.warmup_init_lr = init_lr
        self.lr_step_size = (lr - init_lr) / self.warmup_updates if self.warmup_updates > 0 else 0.0
        self.warmup_end = self.warmup_updates <= 0
        self.lr = lr if self.warmup_end else init_lr
        self.cooldown, self.min_lr, self.eps = 0, 0.0, 1e-8
        self.best = float("-inf") if self.mode == "max" else float("inf")
        self.num_bad_epochs = self.cooldown_counter = self.last_epoch = 0

    def _is_better(self, a: float, best: float) -> bool:
        if self.mode == "min":
            return a < best * (1.0 - self.threshold)
        return a > best * (1.0 + self.threshold)

    def step_update(self, num_updates: int) -> float:
        if self.warmup_updates > 0:
            if num_updates <= self.warmup_updates:
                self.lr = self.warmup_init_lr + num_updates * self.lr_step_size
            elif not self.warmup_end:
                self.warmup_end = True
        return self.lr

    def step_epoch(self, epoch: int, val_loss: Optional[float] = None) -> float:
        if val_loss is None or not self.warmup_end:
            self.last_epoch = epoch
            return self.lr
        self.last_epoch += 1
        if self._is_better(float(val_loss), self.best):
            self.best, self.num_bad_epochs = float(val_loss), 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            new_lr = max(self.lr * self.factor, self.min_lr)
            if self.lr - new_lr > self.eps:
                self.lr = new_lr
            self.cooldown_counter, self.num_bad_epochs = self.cooldown, 0
        return self.lr

    def state_dict(self) -> Dict:
        return {"lr": self.lr, "best": self.best, "last_epoch": self.last_epoch,
                "num_bad_epochs": self.num_bad_epochs,
                "cooldown_counter": self.cooldown_counter, "warmup_end": self.warmup_end}

    def load_state_dict(self, sd: Mapping) -> None:
        self.lr = float(sd.get("lr", self.lr))
        if "best" in sd:
            self.best = float(sd["best"])
        self.last_epoch = int(sd.get("last_epoch", self.last_epoch))
        self.num_bad_epochs = int(sd.get("num_bad_epochs", 0))
        self.cooldown_counter = int(sd.get("cooldown_counter", 0))
        self.warmup_end = bool(sd.get("warmup_end", self.warmup_end))


LR_SCHEDULES = {
    "inverse_sqrt": lambda cfg: inverse_sqrt(float(_get(cfg, "lr", 5e-4)),
                                             int(_get(cfg, "warmup_updates", 4000)),
                                             float(_get(cfg, "warmup_init_lr", 1e-7))),
    "fixed": fixed,
    "cosine": cosine,
    "polynomial_decay": polynomial_decay,
    "step": step_lr,
    "triangular": triangular,
    "pass_through": pass_through,
    "manual": ManualSchedule,
    "reduce_lr_on_plateau": ReduceLROnPlateauSchedule,
    "tri_stage": tri_stage,
}


def build_lr_schedule(cfg: Mapping):
    """The schedule named by cfg["lr_scheduler"] (inverse_sqrt by default)."""
    name = _get(cfg, "lr_scheduler", "inverse_sqrt")
    if name not in LR_SCHEDULES:
        raise ValueError(f"unknown lr_scheduler {name!r}; one of {sorted(LR_SCHEDULES)}")
    return LR_SCHEDULES[name](cfg)
