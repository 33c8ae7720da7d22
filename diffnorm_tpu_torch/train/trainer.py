"""The trainer (the port's copy of diffnorm_tpu/train/trainer.py:55-409 as
far as the VAE and normalizer stages use it).

* The model's parameters split into trainable and frozen: a top-level
  submodule named in `frozen_keys` (the normalizer's `vae`) takes no
  gradient and is never updated.
* Mixed precision as JAX's `--dtype bfloat16`: the model given is the
  float32 master, which the optimizer updates; a forward and backward in
  bf16 run on a working copy cast from it (so the bf16 kernels run), whose
  gradients are accumulated in float32 for the masters; after each update
  the working copy is refreshed in place from the masters, which moves the
  parameters' version counters, so the WaveNet / FeedForward packs follow.
  In float32 the working copy is the master itself.
* Gradient accumulation over the micro-batches of one update under the
  criterion's "mean_loss" convention: the micro-batch gradients are summed,
  divided by the total sample_size, clipped to `clip_norm` by global norm,
  and applied by fairseq Adam at the inverse_sqrt lr of the update count.
  An update with a non-finite gradient norm is skipped (the count still
  moves, as in JAX).
* Every draw of a training forward (times, noises, dropout) comes from the
  trainer's generator, seeded from `seed`; metrics and the gradient norm
  come to the host in one transfer per update.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from diffnorm_tpu_torch.models.layers import set_dropout_generator
from diffnorm_tpu_torch.train.lr_schedules import inverse_sqrt
from diffnorm_tpu_torch.train.optimizers import FairseqAdam

logger = logging.getLogger("diffnorm_tpu_torch.train")

COUNT_KEYS = ("ntokens", "nsentences", "sample_size")
BATCH_KEYS = ("reduce_target", "reduce_target_unit", "reduce_target_lengths",
              "posterior_noise", "inject_times", "inject_enc_noise", "inject_x1_noise",
              "inject_q_noise")


@dataclasses.dataclass
class TrainerConfig:
    lr: float = 5e-4
    warmup_updates: int = 4000
    warmup_init_lr: float = 1e-7
    adam_betas: Tuple[float, float] = (0.9, 0.98)
    adam_eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: float = 2.0
    dtype: str = "float32"  # the forward's; the masters are float32
    seed: int = 1


class Trainer:
    def __init__(self, cfg: TrainerConfig, model: nn.Module, criterion,
                 frozen_keys: Sequence[str] = ()):
        if getattr(criterion, "grad_accum", None) != "mean_loss":
            raise ValueError(f"{type(criterion).__name__}: the trainer takes criterions of "
                             f"the mean_loss convention")
        self.cfg, self.master, self.criterion = cfg, model, criterion
        self.device = next(model.parameters()).device
        for name, p in model.named_parameters():
            if p.dtype != torch.float32:
                raise TypeError(f"{name}: the master parameters must be float32, got {p.dtype}")
            p.requires_grad_(name.split(".")[0] not in frozen_keys)
        dtype = getattr(torch, cfg.dtype)
        self.model = model if dtype == torch.float32 else copy.deepcopy(model).to(dtype)
        names = [n for n, p in model.named_parameters() if p.requires_grad]
        work = dict(self.model.named_parameters())
        masters = dict(model.named_parameters())
        self.params = [masters[n] for n in names]
        self.work_params = [work[n] for n in names]
        self.optimizer = FairseqAdam(self.params, cfg.adam_betas, cfg.adam_eps, cfg.weight_decay)
        self.schedule = inverse_sqrt(cfg.lr, cfg.warmup_updates, cfg.warmup_init_lr)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        set_dropout_generator(self.model, self.generator)
        self.num_updates = 0
        self.skipped_steps = 0

    def _to_device(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """The criterion's inputs of a batch (numpy arrays or tensors) on the
        model's device."""
        return {key: torch.as_tensor(batch[key]).to(self.device, non_blocking=True)
                for key in BATCH_KEYS if batch.get(key) is not None}

    @torch.no_grad()
    def _refresh_working_copy(self) -> None:
        if self.model is not self.master:
            for w, m in zip(self.work_params, self.params):
                w.copy_(m)

    def train_step(self, batches: List[Dict]) -> Dict[str, float]:
        """One update over `batches` (update_freq micro-batches). Returns the
        logged metrics: the sample-size-weighted means, the summed counts,
        gnorm and lr."""
        self.model.train()
        acc = [torch.zeros_like(p) for p in self.params]
        vecs, keys = [], None
        for batch in batches:
            loss, mets = self.criterion(self.model, self._to_device(batch),
                                        generator=self.generator)
            grads = torch.autograd.grad(loss, self.work_params, allow_unused=True)
            for a, g in zip(acc, grads):
                if g is not None:
                    a.add_(g.float())
            keys = keys or sorted(mets)
            vecs.append(torch.stack([torch.as_tensor(mets[k], dtype=torch.float32,
                                                     device=self.device) for k in keys]).detach())
        vec = torch.stack(vecs)
        ss = vec[:, keys.index("sample_size")]
        grads = torch._foreach_div(acc, torch.clamp(ss.sum(), min=1.0))
        gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        host = torch.cat([vec.reshape(-1), gnorm[None]]).cpu().numpy()  # the one pull
        vec_h, gnorm_h = host[:-1].reshape(vec.shape), float(host[-1])
        lr = self.schedule(self.num_updates)
        if np.isfinite(gnorm_h):
            if self.cfg.clip_norm > 0 and gnorm_h > self.cfg.clip_norm:
                torch._foreach_mul_(grads, self.cfg.clip_norm / gnorm_h)
            self.optimizer.step(grads, lr)
            self._refresh_working_copy()
        else:
            self.skipped_steps += 1
            logger.warning("non-finite gradients at step %d; update skipped", self.num_updates)
        self.num_updates += 1
        out = summarize([dict(zip(keys, row)) for row in vec_h])
        out["gnorm"], out["lr"] = gnorm_h, lr
        return out

    @torch.no_grad()
    def valid_step(self, batch: Dict, generator: torch.Generator) -> Dict[str, float]:
        """The criterion's metrics on one batch, dropout off."""
        self.model.eval()
        _, mets = self.criterion(self.model, self._to_device(batch), generator=generator)
        keys = sorted(mets)
        vec = torch.stack([torch.as_tensor(mets[k], dtype=torch.float32, device=self.device)
                           for k in keys])
        return dict(zip(keys, vec.cpu().numpy().tolist()))

    def state_dict(self) -> Dict:
        """Everything of the trainer a resume needs beside the master
        parameters: the moments, the update count, the generator."""
        return {"optimizer": self.optimizer.state_dict(), "num_updates": self.num_updates,
                "skipped_steps": self.skipped_steps,
                "generator": self.generator.get_state()}

    def load_state_dict(self, state: Dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self.num_updates = int(state["num_updates"])
        self.skipped_steps = int(state["skipped_steps"])
        self.generator.set_state(state["generator"].cpu())
        self._refresh_working_copy()


def summarize(rows: Sequence[Dict[str, float]]) -> Dict[str, float]:
    """Metric rows (one per micro-batch, or per logged update) -> the counts
    summed and every other metric weighted by sample_size
    (trainer.py:337-355). Every row has the keys of the first."""
    keys = list(rows[0])
    vecs = np.asarray([[r[k] for k in keys] for r in rows])
    ss = vecs[:, keys.index("sample_size")]
    total = max(float(ss.sum()), 1.0)
    return {k: float(vecs[:, i].sum()) if k in COUNT_KEYS
            else float((vecs[:, i] * ss).sum()) / total for i, k in enumerate(keys)}
