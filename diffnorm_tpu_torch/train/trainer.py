"""The trainer (the port's copy of diffnorm_tpu/train/trainer.py:55-409 as
far as the VAE, normalizer and NAR S2UT stages use it).

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
* BatchNorm running statistics (the conformer's) are model state: each
  training micro-batch's forward updates them in order, as JAX threads
  `mutated` per micro-batch. The working copy shares the master's float32
  statistics tensors, so the checkpoint of the master holds them.
* Gradient accumulation over the micro-batches of one update under the
  criterion's `grad_accum` convention: "mean_loss" sums the micro-batch
  gradients; "sum_loss" (the reference backwards a summed loss) first
  scales each by its micro-batch's sample_size. Either sum is divided by
  the total sample_size, clipped to `clip_norm` by global norm, and applied
  by fairseq Adam at the inverse_sqrt lr of the update count. An update
  with a non-finite gradient norm is skipped (the count still moves, as in
  JAX).
* Draws come from three generators seeded from `seed` (seed, seed + 1,
  seed + 2), as JAX's NAR criterion splits its key three ways: dropout and
  the criterions' own draws (times, noises), classifier-free-guidance drops
  (`cg`) and self-prompting (`sp`), set on a model that has those draws.
  Metrics and the gradient norm come to the host in one transfer per
  update.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from diffnorm_tpu_torch.models.conformer import BatchNorm
from diffnorm_tpu_torch.models.layers import set_dropout_generator
from diffnorm_tpu_torch.train.lr_schedules import inverse_sqrt
from diffnorm_tpu_torch.train.optimizers import FairseqAdam

logger = logging.getLogger("diffnorm_tpu_torch.train")

COUNT_KEYS = ("ntokens", "nsentences", "sample_size")
BATCH_KEYS = ("reduce_target", "reduce_target_unit", "reduce_target_lengths",
              "posterior_noise", "inject_times", "inject_enc_noise", "inject_x1_noise",
              "inject_q_noise", "src_tokens", "src_lengths", "target", "prev_target",
              "inject_cg_drop", "inject_use_prompt", "tgt_speaker", "ctc_target", "multitask")
GRAD_ACCUM = ("mean_loss", "sum_loss")
GENERATORS = ("generator", "cg_generator", "sp_generator")


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
        if getattr(criterion, "grad_accum", None) not in GRAD_ACCUM:
            raise ValueError(f"{type(criterion).__name__}: the trainer takes criterions of "
                             f"the conventions {GRAD_ACCUM}")
        self.cfg, self.master, self.criterion = cfg, model, criterion
        self.device = next(model.parameters()).device
        for name, p in model.named_parameters():
            if p.dtype != torch.float32:
                raise TypeError(f"{name}: the master parameters must be float32, got {p.dtype}")
            p.requires_grad_(name.split(".")[0] not in frozen_keys)
        dtype = getattr(torch, cfg.dtype)
        self.model = model if dtype == torch.float32 else copy.deepcopy(model).to(dtype)
        if self.model is not model:
            for m, w in zip(model.modules(), self.model.modules()):
                if isinstance(m, BatchNorm):
                    for name in BatchNorm.STATS:
                        w._buffers[name] = m._buffers[name]
        names = [n for n, p in model.named_parameters() if p.requires_grad]
        work = dict(self.model.named_parameters())
        masters = dict(model.named_parameters())
        self.params = [masters[n] for n in names]
        self.work_params = [work[n] for n in names]
        self.optimizer = FairseqAdam(self.params, cfg.adam_betas, cfg.adam_eps, cfg.weight_decay)
        self.schedule = inverse_sqrt(cfg.lr, cfg.warmup_updates, cfg.warmup_init_lr)
        self.generator, self.cg_generator, self.sp_generator = (
            torch.Generator(device=self.device).manual_seed(cfg.seed + i) for i in range(3))
        set_dropout_generator(self.model, self.generator)
        if hasattr(self.model, "cg_generator"):
            self.model.cg_generator, self.model.sp_generator = self.cg_generator, self.sp_generator
        self.num_updates = 0
        self.skipped_steps = 0

    def _to_device(self, batch: Dict) -> Dict:
        """The criterion's inputs of a batch (numpy arrays or tensors, and
        the aux tasks' nested entries under "multitask") on the model's
        device."""
        def put(value):
            if isinstance(value, dict):
                return {k: put(v) for k, v in value.items()}
            return torch.as_tensor(value).to(self.device, non_blocking=True)

        return {key: put(batch[key]) for key in BATCH_KEYS if batch.get(key) is not None}

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
        sum_loss = self.criterion.grad_accum == "sum_loss"
        for batch in batches:
            loss, mets = self.criterion(self.model, self._to_device(batch),
                                        generator=self.generator)
            grads = torch.autograd.grad(loss, self.work_params, allow_unused=True)
            scale = torch.as_tensor(mets["sample_size"], dtype=torch.float32) if sum_loss else None
            for a, g in zip(acc, grads):
                if g is not None:
                    a.add_(g.float() * scale if sum_loss else g.float())
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
        variables: the moments, the update count, the generators."""
        return {"optimizer": self.optimizer.state_dict(), "num_updates": self.num_updates,
                "skipped_steps": self.skipped_steps,
                **{key: getattr(self, key).get_state() for key in GENERATORS}}

    def load_state_dict(self, state: Dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self.num_updates = int(state["num_updates"])
        self.skipped_steps = int(state["skipped_steps"])
        for key in GENERATORS:
            if key in state:  # an older checkpoint holds the first alone
                getattr(self, key).set_state(state[key].cpu())
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
