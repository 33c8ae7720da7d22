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
  the total sample_size; "mean_loss_per_batch" (the reference logs a
  sample_size it does not divide by) sums them and divides by the number
  of micro-batches. The optimizer is `optimizers.build_optimizer`'s chain
  (fairseq Adam and inverse_sqrt by default; `TrainerConfig.optimizer` and
  `lr_scheduler` pick JAX's others, `options` their settings), clipping to
  `clip_norm` by global norm inside it. Under a host-driven schedule
  (manual, reduce_lr_on_plateau) the chain runs at unit lr and its updates
  are scaled by the schedule's `step_update(num_updates)` (JAX
  trainer.py:318-320,364); the epoch hooks are `lr_step_begin_epoch` and
  `lr_step_epoch`. With `ema_decay` an `optimizers.EMA` of the trainable
  masters follows every applied update. An update with a non-finite
  gradient norm is skipped (the count still moves, as in JAX).
* Draws come from three generators seeded from `seed` (seed, seed + 1,
  seed + 2), as JAX's NAR criterion splits its key three ways: dropout and
  the criterions' own draws (times, noises), classifier-free-guidance drops
  (`cg`) and self-prompting (`sp`), set on a model that has those draws.
  Metrics and the gradient norm come to the host in one transfer per
  update; each step's metrics go to the active `train.metrics` aggregators.
* An int8 model (`quant_int8`) trains on the int8 module path: its `Dense`
  sites quantize the current weights at each call (`live_int8`), from the
  float32 masters' values under bf16, and the gradient flows through the
  scales alone, as `jax.grad` through JAX's int8 matmuls.
* Data parallelism over a `parallel.mesh.Mesh` of N ranks gives the
  one-process update on the same global batch, as JAX's SPMD mesh does:
  every rank is handed the global micro-batches and keeps its contiguous
  rows (`shard_batch`); the forward runs under `row_split`, so per-row
  draws are made for the global batch and a "mean_loss" criterion (which
  must declare `data_parallel`) divides by the global counts; a
  "sum_loss" criterion's loss is scaled by its sample_size before the
  backward (the gradient then holds every rank's share of BatchNorm's
  global statistics). The gradient sums and the metric vectors are summed
  over the ranks before the division by the total sample_size, so the
  gradient norm, the skip of a non-finite update and the logged metrics
  are the global ones on every rank. Dropout draws stay rank-local.
* `zero_sharding` "os" (--zero-sharding os) splits each trainable
  parameter's optimizer state on its first axis the data degree divides
  (`optimizers.zero_axis`): each rank updates its slice of the float32
  masters, then the slices are all-gathered before the working copy is
  refreshed. `fsdp` (--fsdp, --ddp-backend fully_sharded) splits the
  masters themselves and their state on their largest such axis
  (`sharding_rules.fsdp_spec`): the gradients are reduce-scattered, each
  rank updates its slice, and the slices are all-gathered into the working
  copy, which the next forward reads; under bf16 the full float32 masters
  are not kept (`gathered_master` rebuilds them for a checkpoint). Both
  take the elementwise optimizers alone (not lamb or adafactor);
  `state_dict` gathers the state in full and `load_state_dict` keeps the
  rank's slice, so a checkpoint does not depend on the world size.
* Tensor parallelism over the mesh's model axis (`Mesh.model` > 1, JAX's
  ("data", "model") mesh, trainer.py:60-63): the master's parameters are
  split by Megatron's rules before the working copy is made
  (`sharding_rules.shard_model`), and the ranks of one model group take
  the same rows. Gradients are summed over the data group only; the clip
  norm counts a parameter split over "model" once over the model group and
  a replicated one once. --zero-sharding os and --fsdp split over the data
  group on top of the model shards (JAX's `fsdp_spec` after `param_spec`),
  elementwise optimizers alone; `state_dict` and `gathered_master` gather
  both axes, so a checkpoint restores at any data x model. Every replicated
  parameter ends each update equal on the model ranks: the layers' inputs
  to the sharded regions enter through `copy_in`, a replicated parameter a
  rank uses a slice of through `split_in`. The generators are seeded alike
  on every rank, so a dropout on a replicated activation draws one mask on
  every rank of a model group; inside a sharded region (the attention
  probabilities, an FF's inner width) each rank draws the mask over the
  whole tensor and keeps its block (`ops.attention.apply_dropout`), so the
  ranks' blocks differ as in JAX's one mask and the update is one
  process's.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import logging
from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from diffnorm_tpu_torch.models.conformer import BatchNorm
from diffnorm_tpu_torch.models.layers import set_dropout_generator, set_live_int8
from diffnorm_tpu_torch.parallel.mesh import Mesh, row_split, shard_batch
from diffnorm_tpu_torch.parallel.sharding_rules import (
    TPSpec,
    data_axis,
    fsdp_spec,
    shard_model,
    tp_gather,
    tp_slice,
    whole_params,
)
from diffnorm_tpu_torch.train import metrics as metrics_mod
from diffnorm_tpu_torch.train import optax_bridge
from diffnorm_tpu_torch.train.lr_schedules import build_lr_schedule
from diffnorm_tpu_torch.train.optimizers import (
    EMA,
    ClipByGlobalNorm,
    build_optimizer,
    global_norm,
    zero_axis,
)
from diffnorm_tpu_torch.weights import jax_param_path

logger = logging.getLogger("diffnorm_tpu_torch.train")

COUNT_KEYS = ("ntokens", "nsentences", "sample_size")
BATCH_KEYS = ("reduce_target", "reduce_target_unit", "reduce_target_lengths",
              "posterior_noise", "inject_times", "inject_enc_noise", "inject_x1_noise",
              "inject_q_noise", "src_tokens", "src_lengths", "target", "prev_target",
              "prev_output_tokens", "inject_cg_drop", "inject_use_prompt", "tgt_speaker",
              "ctc_target", "multitask", "prompt", "prompt_mask", "feat_tgt", "tgt_lengths",
              "prev_feats", "tgt_mask", "durations", "pitches", "energies", "prev_del",
              "prev_kept", "prev_ins", "del_target", "ins_target", "ins_valid", "target_unit",
              "target_lengths", "inject_mask_u", "mask_indices", "masked_pos", "masked_valid",
              "neg_idxs", "gumbel_temp", "channel_mask")
GRAD_ACCUM = ("mean_loss", "sum_loss", "mean_loss_per_batch")
GENERATORS = ("generator", "cg_generator", "sp_generator")
ROWS = "_rows"  # an uploaded batch's (n, lo, hi) where it holds this rank's rows alone


@dataclasses.dataclass
class TrainerConfig:
    lr: float = 5e-4
    # None: the schedule's own default (inverse_sqrt's 4000 and 1e-7)
    warmup_updates: Optional[int] = None
    warmup_init_lr: Optional[float] = None
    adam_betas: Tuple[float, float] = (0.9, 0.98)
    adam_eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: float = 2.0
    dtype: str = "float32"  # the forward's; the masters are float32
    seed: int = 1
    optimizer: str = "adam"
    lr_scheduler: str = "inverse_sqrt"
    ema_decay: float = 0.0
    zero_sharding: str = "none"  # "os": the optimizer state split over the data ranks
    fsdp: bool = False  # the masters and their state split over the data ranks
    # the optimizer's and schedule's other settings under JAX's config keys
    # (max_updates, min_lr, adamax_betas, composite_groups, loss_scale, ...)
    options: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def optimization(self) -> Dict[str, Any]:
        """The keys build_lr_schedule and build_optimizer read; unset (None)
        options are left out, so each takes its own default as in JAX."""
        cfg = {"lr": self.lr, "warmup_updates": self.warmup_updates,
               "warmup_init_lr": self.warmup_init_lr, "adam_betas": self.adam_betas,
               "adam_eps": self.adam_eps, "weight_decay": self.weight_decay,
               "optimizer": self.optimizer, "lr_scheduler": self.lr_scheduler,
               **self.options}
        return {k: v for k, v in cfg.items() if v is not None}


class Shards:
    """The axis of each trainable parameter that splits over the data
    ranks (None: whole on every rank) and its split over the model ranks
    (a `TPSpec`, or None), and the slicing, gathering and reduce-scattering
    along them. A tensor here is a parameter's model-rank slice, cut over
    the data ranks on its data axis."""

    def __init__(self, mesh: Mesh, axes: Sequence[Optional[int]],
                 tp: Sequence[Optional[TPSpec]]):
        self.mesh, self.axes, self.tp = mesh, list(axes), list(tp)

    def slice(self, t: torch.Tensor, i: int) -> torch.Tensor:
        axis = self.axes[i]
        if axis is None:
            return t
        size = t.shape[axis] // self.mesh.data
        return t.narrow(axis, self.mesh.index * size, size)

    def gather(self, t: torch.Tensor, i: int) -> torch.Tensor:
        axis = self.axes[i]
        return t if axis is None else self.mesh.all_gather(t, dim=axis)

    def whole(self, t: torch.Tensor, i: int) -> torch.Tensor:
        """The whole tensor from this rank's slice: gathered over the data
        ranks, then over the model ranks."""
        t = self.gather(t, i)
        spec = self.tp[i]
        return t if spec is None else tp_gather(t, spec, self.mesh.model_axis, spec.whole)

    def unwhole(self, t: torch.Tensor, i: int) -> torch.Tensor:
        """This rank's slice of the whole `t` (`whole`'s inverse)."""
        if self.tp[i] is not None:
            t = tp_slice(t, self.tp[i], self.mesh.model_index, self.mesh.model)
        return self.slice(t, i)

    def norm(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """The global norm of the whole from each rank's slices: the
        squares of a parameter split over the data (model) ranks summed over
        the data (model) group, a replicated one's counted once."""
        sq = torch.stack(torch._foreach_norm(list(tensors))).square()
        dev = sq.device
        on_data = torch.tensor([a is not None for a in self.axes], device=dev)
        on_model = torch.tensor([s is not None for s in self.tp], device=dev)
        parts = torch.stack([torch.where(on_data & ~on_model, sq, 0.0).sum(),
                             torch.where(on_data & on_model, sq, 0.0).sum(),
                             torch.where(~on_data & on_model, sq, 0.0).sum()])
        parts[:2] = self.mesh.all_reduce(parts[:2].clone())
        parts[1:] = self.mesh.model_axis.all_reduce(parts[1:].clone())
        return (parts.sum() + torch.where(on_data | on_model, 0.0, sq).sum()).sqrt()


class Trainer:
    def __init__(self, cfg: TrainerConfig, model: nn.Module, criterion,
                 frozen_keys: Sequence[str] = (), mesh: Optional[Mesh] = None):
        if getattr(criterion, "grad_accum", None) not in GRAD_ACCUM:
            raise ValueError(f"{type(criterion).__name__}: the trainer takes criterions of "
                             f"the conventions {GRAD_ACCUM}")
        self.mesh = mesh or Mesh()
        if (self.mesh.active and criterion.grad_accum != "sum_loss"
                and not getattr(criterion, "data_parallel", False)):
            raise NotImplementedError(
                f"{type(criterion).__name__}: a {criterion.grad_accum} criterion whose means "
                f"do not divide by the global batch's counts cannot train data-parallel "
                f"(parallel.mesh.global_sum)")
        self.cfg, self.master, self.criterion = cfg, model, criterion
        self.device = next(model.parameters()).device
        # tensor parallelism: the master's parameters become this rank's
        # slices (every parameter, the frozen ones too)
        self.tp_specs = shard_model(model, self.mesh.model_axis)
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
        set_live_int8(self.model, model)  # --quant-int8 training
        names = [n for n, p in model.named_parameters() if p.requires_grad]
        work = dict(self.model.named_parameters())
        masters = dict(model.named_parameters())
        self.names = names
        self.work_params = [work[n] for n in names]
        full = [masters[n] for n in names]
        self.shards = self._plan_shards(cfg, full)
        if self.shards is None:
            self.params = full
        elif cfg.fsdp:
            # each rank's slice of the masters, in storage of its own; under
            # bf16 the full masters go (gathered_master rebuilds them)
            self.params = [self.shards.slice(p, i).detach().clone() for i, p in enumerate(full)]
            if self.model is not model:
                for p in full:
                    p.data = p.data.new_empty(0)
        else:  # ZeRO: views of this rank's slices of the full masters
            self.params = [self.shards.slice(p, i) for i, p in enumerate(full)]
        self._full_masters = full
        opt_cfg = cfg.optimization()
        self.schedule = build_lr_schedule(opt_cfg)
        self.host_lr_sched = self.schedule if getattr(self.schedule, "host_driven", False) else None
        self.optimizer = build_optimizer(opt_cfg, self.schedule, self.params, names,
                                         cfg.clip_norm)
        if self.shards is not None:
            if not self.optimizer.transform.is_elementwise():
                raise NotImplementedError(
                    f"--optimizer {cfg.optimizer}: its update reads whole parameters (norms, "
                    f"factored moments), which --zero-sharding os and --fsdp split")
            self._set_clip_norm(self.optimizer.transform)
        self.ema = EMA(self.params, cfg.ema_decay) if cfg.ema_decay else None
        self.generator, self.cg_generator, self.sp_generator = (
            torch.Generator(device=self.device).manual_seed(cfg.seed + i) for i in range(3))
        set_dropout_generator(self.model, self.generator)
        if hasattr(self.model, "cg_generator"):
            self.model.cg_generator, self.model.sp_generator = self.cg_generator, self.sp_generator
        self.num_updates = 0
        self.skipped_steps = 0

    def _plan_shards(self, cfg: TrainerConfig, full: List[torch.Tensor]) -> Optional[Shards]:
        """The split of --zero-sharding os or --fsdp and of the model axis,
        None without either (or without a process group)."""
        if cfg.zero_sharding not in ("none", "os"):
            raise ValueError(f"--zero-sharding {cfg.zero_sharding}: none or os")
        tp = [self.tp_specs.get(n) for n in self.names]
        data_split = (cfg.fsdp or cfg.zero_sharding == "os") and self.mesh.active
        if not data_split and not self.tp_specs:
            return None
        if cfg.fsdp and data_split and getattr(self.master, "quant_int8", False):
            raise NotImplementedError("--fsdp with --quant-int8: the int8 sites read the full "
                                      "float32 masters at every call")
        if not data_split:
            axes = [None] * len(full)
        elif cfg.fsdp:  # JAX's fsdp_spec after param_spec, on the whole shape
            axes = []
            for p, spec in zip(full, tp):
                shape = list(p.shape)
                entries = [None] * len(shape)
                if spec is not None:
                    shape[spec.axis] = spec.whole
                    entries[spec.axis] = "model"
                axes.append(data_axis(fsdp_spec(tuple(entries), SimpleNamespace(shape=shape),
                                                self.mesh)))
        else:
            axes = [zero_axis(tuple(p.shape), self.mesh.data) for p in full]
        return Shards(self.mesh, axes, tp)

    def _set_clip_norm(self, transform) -> None:
        if isinstance(transform, ClipByGlobalNorm):
            transform.norm_fn = self.shards.norm
        for child, _ in transform.children():
            self._set_clip_norm(child)

    def upload(self, batch: Dict) -> Dict:
        """The criterion's inputs of a batch (numpy arrays or tensors, and
        the aux tasks' nested entries under "multitask") on the model's
        device; `train_step` takes a batch before or after it. Under data
        parallelism only this rank's rows are uploaded (their place in the
        global batch kept under ROWS)."""
        def put(value):
            if isinstance(value, dict):
                return {k: put(v) for k, v in value.items()}
            return torch.as_tensor(value).to(self.device, non_blocking=True)

        rows = batch.get(ROWS)
        batch = {key: batch[key] for key in BATCH_KEYS if batch.get(key) is not None}
        if rows is None and self.mesh.active:
            batch, rows = shard_batch(batch, self.mesh)
        out = {key: put(value) for key, value in batch.items()}
        if rows is not None:
            out[ROWS] = rows
        return out

    def _rows(self, batch: Dict):
        """A batch's split: row_split's context (nothing without a process
        group)."""
        rows = batch.get(ROWS)
        if rows is None:
            return contextlib.nullcontext()
        return row_split(self.mesh, *rows)

    @torch.no_grad()
    def _refresh_working_copy(self) -> None:
        """After an update: the rank's slices gathered into the masters
        (ZeRO) or the working copy (FSDP), and the working copy cast from
        the masters; each in place, so the parameters' versions move."""
        if self.shards is not None:
            for i, p in enumerate(self.params):
                if self.shards.axes[i] is None:
                    if self.cfg.fsdp:
                        self.work_params[i].copy_(p)
                    continue
                whole = self.shards.gather(p, i)
                (self.work_params[i] if self.cfg.fsdp else self._full_masters[i]).copy_(whole)
            if self.cfg.fsdp:
                return
        if self.model is not self.master:
            for w, m in zip(self.work_params, self._full_masters):
                w.copy_(m)

    def _reduce(self, vec: torch.Tensor, keys: List[str]) -> torch.Tensor:
        """The micro-batches' metric rows [N, K] summed over the ranks: a
        "sum_loss" criterion's means are weighted by the rank's sample_size
        and divided by the global one, the counts and a data-parallel
        criterion's partial means (over the global counts) are summed."""
        if not self.mesh.active:
            return vec
        mean = torch.tensor([k not in COUNT_KEYS for k in keys], device=vec.device)
        ss = vec[:, keys.index("sample_size"):keys.index("sample_size") + 1]
        weighted = self.criterion.grad_accum == "sum_loss"
        if weighted:
            vec = torch.where(mean, vec * ss, vec)
        vec = self.mesh.all_reduce(vec.contiguous())
        if weighted:
            ss = vec[:, keys.index("sample_size"):keys.index("sample_size") + 1]
            vec = torch.where(mean, vec / torch.clamp(ss, min=1.0), vec)
        return vec

    def train_step(self, batches: List[Dict]) -> Dict[str, float]:
        """One update over `batches` (update_freq micro-batches). Returns the
        logged metrics: the sample-size-weighted means, the summed counts,
        gnorm and lr."""
        self.model.train()
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in self.work_params]
        vecs, keys = [], None
        accum = self.criterion.grad_accum
        dp = self.mesh.active
        for batch in batches:
            batch = self.upload(batch)
            with self._rows(batch):
                loss, mets = self.criterion(self.model, batch, generator=self.generator)
                scale = (torch.as_tensor(mets["sample_size"], dtype=torch.float32)
                         if accum == "sum_loss" else None)
                if dp and scale is not None:  # scaled before the backward (see above)
                    loss, scale = loss * scale.to(loss.device), None
                grads = torch.autograd.grad(loss, self.work_params, allow_unused=True)
            for a, g in zip(acc, grads):
                if g is not None:
                    a.add_(g.float() * scale if scale is not None else g.float())
            keys = keys or sorted(mets)
            vecs.append(torch.stack([torch.as_tensor(mets[k], dtype=torch.float32,
                                                     device=self.device) for k in keys]).detach())
        vec = self._reduce(torch.stack(vecs), keys)
        if self.shards is not None and self.cfg.fsdp:
            acc = [self.mesh.reduce_scatter(a, axis) if axis is not None
                   else self.mesh.all_reduce(a) for a, axis in zip(acc, self.shards.axes)]
        else:
            self.mesh.all_reduce_many(acc)
        if accum == "mean_loss_per_batch":
            denom = float(len(batches))
        else:
            denom = torch.clamp(vec[:, keys.index("sample_size")].sum(), min=1.0)
        grads = torch._foreach_div(acc, denom)
        if self.shards is not None:
            if not self.cfg.fsdp:  # ZeRO: every rank holds the whole gradient
                grads = [self.shards.slice(g, i) for i, g in enumerate(grads)]
            gnorm = self.shards.norm(grads)
        else:
            gnorm = global_norm(grads)
        host = torch.cat([vec.reshape(-1), gnorm[None]]).cpu().numpy()  # the one pull
        vec_h, gnorm_h = host[:-1].reshape(vec.shape), float(host[-1])
        if self.host_lr_sched is not None:
            # fairseq's convention: update k runs at the lr after step_update(k)
            lr = lr_value = self.host_lr_sched.step_update(self.num_updates)
        else:
            lr, lr_value = float(self.schedule(self.num_updates)), None
        if np.isfinite(gnorm_h):
            self.optimizer.step(grads, lr_value)
            if self.ema is not None:
                self.ema.update(self.params)
            self._refresh_working_copy()
        else:
            self.skipped_steps += 1
            logger.warning("non-finite gradients at step %d; update skipped", self.num_updates)
        self.num_updates += 1
        out = summarize([dict(zip(keys, row)) for row in vec_h])
        out["gnorm"], out["lr"] = gnorm_h, lr
        metrics_mod.log_dict(out)
        return out

    def lr_step_begin_epoch(self, epoch: int) -> Optional[float]:
        """The host-driven schedule's epoch-start hook (manual's epoch2lr)."""
        if self.host_lr_sched is not None:
            return self.host_lr_sched.step_begin_epoch(epoch)
        return None

    def lr_step_epoch(self, epoch: int, val_loss: Optional[float] = None) -> Optional[float]:
        """The host-driven schedule's epoch-end hook (reduce_lr_on_plateau
        reads the epoch's validation metric)."""
        if self.host_lr_sched is not None:
            return self.host_lr_sched.step_epoch(epoch, val_loss)
        return None

    def lr_state_dict(self) -> Optional[Dict]:
        return self.host_lr_sched.state_dict() if self.host_lr_sched is not None else None

    def load_lr_state_dict(self, state: Optional[Dict]) -> None:
        if self.host_lr_sched is not None and state:
            self.host_lr_sched.load_state_dict(state)

    @torch.no_grad()
    def valid_step(self, batch: Dict, generator: torch.Generator) -> Dict[str, float]:
        """The criterion's metrics on one batch, dropout off (the global
        batch's under data parallelism)."""
        self.model.eval()
        batch = self.upload(batch)
        with self._rows(batch):
            _, mets = self.criterion(self.model, batch, generator=generator)
        keys = sorted(mets)
        vec = torch.stack([torch.as_tensor(mets[k], dtype=torch.float32, device=self.device)
                           for k in keys])
        vec = self._reduce(vec[None], keys)[0]
        out = dict(zip(keys, vec.cpu().numpy().tolist()))
        metrics_mod.log_dict(out)
        return out

    @contextlib.contextmanager
    def gathered_master(self):
        """The master module with its full float32 weights, for a
        checkpoint: under --fsdp with a bf16 working copy they are gathered
        from the ranks' slices, and under tensor parallelism from the model
        ranks', for the duration (every rank takes part)."""
        freed = self.shards is not None and self.cfg.fsdp and self.model is not self.master
        if freed:
            for i, (m, p) in enumerate(zip(self._full_masters, self.params)):
                m.data = self.shards.gather(p.detach(), i).clone()
        try:
            with whole_params(self.master, self.tp_specs, self.mesh.model_axis) as master:
                yield master
        finally:
            if freed:
                for m in self._full_masters:
                    m.data = m.data.new_empty(0)

    @contextlib.contextmanager
    def _whole_state(self):
        """The optimizer's per-parameter state and the EMA whole for the
        duration (gathered from the ranks' slices), each rank's slice
        again after it: `state_dict` reads, `load_state_dict` writes it."""
        if self.shards is None:
            yield
            return
        lists = list(self.optimizer.transform.param_lists(range(len(self.params))))
        if self.ema is not None:
            lists.append((self.ema, "params", list(range(len(self.params)))))
        for owner, attr, index in lists:
            setattr(owner, attr, [self.shards.whole(t, i)
                                  for t, i in zip(getattr(owner, attr), index)])
        try:
            yield
        finally:
            for owner, attr, index in lists:
                setattr(owner, attr, [self.shards.unwhole(t, i).clone()
                                      for t, i in zip(getattr(owner, attr), index)])

    def state_dict(self) -> Dict:
        """Everything of the trainer a resume needs beside the master
        variables: the optimizer's state, the update count, the generators
        and the EMA, whole under sharding (every rank takes part). (A
        host-driven schedule's state goes to the checkpoint's sidecar,
        `lr_state_dict`, as in JAX.)"""
        with self._whole_state():
            state = {"optimizer": self.optimizer.state_dict(),
                     "num_updates": self.num_updates, "skipped_steps": self.skipped_steps,
                     **{key: getattr(self, key).get_state() for key in GENERATORS}}
            if self.ema is not None:
                state["ema"] = self.ema.state_dict()
        return state

    def load_optax_state(self, bridged: Dict) -> None:
        """A JAX TrainState's optimizer state, update count and EMA
        (`train.checkpoint.load_optax_state` of a bridged step directory).
        The generators keep their seeding from `cfg.seed`: JAX's PRNG keys
        do not carry over."""
        paths = [jax_param_path(self.master, n) for n in self.names]
        params = optax_bridge.ParamPaths([p for p, _ in paths], [k for _, k in paths])
        with self._whole_state():
            optax_bridge.load_transform(self.optimizer.transform, bridged["opt_state"], params)
            optax_bridge.load_ema(self.ema, bridged.get("ema_params"), params)
        self.num_updates = self.optimizer.count = int(bridged["step"])
        self.skipped_steps = 0
        self._refresh_working_copy()

    def load_state_dict(self, state: Dict) -> None:
        """A `state_dict` (written at any world size); each rank keeps its
        slice of the state."""
        with self._whole_state():
            self.optimizer.load_state_dict(state["optimizer"])
            if self.ema is not None:
                if "ema" not in state:
                    raise ValueError("--ema-decay: the checkpoint holds no EMA")
                self.ema.load_state_dict(state["ema"])
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
