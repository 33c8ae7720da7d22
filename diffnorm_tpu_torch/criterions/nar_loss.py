"""The NAR S2UT criterion, "nar_speech_to_unit" (the port's copy of
diffnorm_tpu/criterions/nar_loss.py; reference nar_speech_to_unit.py:125-220
and research/TranSpeech/criterion.py:22-123).

* unit CE, label-smoothed with eps_i = eps / (V - 1), only at the CMLM
  canvas's masked positions (prev == unk) that are not padding; stacked
  (logits [B, T, k, V]) per sub-frame, the canvas mask over every
  sub-frame of a step;
* the 256-way length classifier's CE with the same eps and
  ignore_index = pad = 1, so a target length of exactly 1 counts zero (the
  reference's quirk, kept);
* their sum divided by ntokens, the batch's non-pad target tokens (every
  sub-frame when stacked); sample_size = ntokens, and the trainer
  accumulates micro-batches under the "sum_loss" convention, as JAX's
  criterion (no `grad_accum`) does;
* with the model's `ctc_proj` head and a batch's `ctc_target`, the mean CTC
  loss of the rows (weight 1, JAX's default multitask_loss_weight, which no
  recipe sets);
* the --multitask-config-yaml terms (`apply_multitask_losses`).

CTC (`ctc_loss`) gives optax.ctc_loss's values, JAX's, on either side of
the feasibility boundary: optax scores a row that cannot align with
log-epsilon = -1e5 per missing step, a large finite loss where F.ctc_loss
gives inf, so such rows take optax's recursion and the others
F.ctc_loss.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from diffnorm_tpu_torch.criterions.label_smoothing import label_smoothed_nll_loss
from diffnorm_tpu_torch.parallel.mesh import active_split

PAD = 1


def _ctc_recursion(logprobs: torch.Tensor, logit_paddings: torch.Tensor,
                   labels: torch.Tensor, label_paddings: torch.Tensor, blank_id: int,
                   log_epsilon: float) -> torch.Tensor:
    """optax.ctc_loss's forward recursion over the frames, log(0)
    approximated by `log_epsilon`: the per-row negative log-likelihood."""
    b, t, _ = logprobs.shape
    n = labels.shape[1]
    labellens = n - label_paddings.sum(dim=1).long()
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).to(logprobs.dtype), (0, 1))
    lp_phi = logprobs[:, :, blank_id]  # [B, T]
    lp_emit = logprobs.gather(2, labels.long()[:, None, :].expand(b, t, n))  # [B, T, N]

    def update_phi(phi, added):
        return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], added)], dim=-1)

    phi = torch.full((b, n + 1), log_epsilon, dtype=logprobs.dtype, device=logprobs.device)
    phi[:, 0] = 0.0
    emit = torch.full((b, n), log_epsilon, dtype=logprobs.dtype, device=logprobs.device)
    for i in range(t):
        prev_phi = update_phi(phi, emit + log_epsilon * repeat)
        e, p, pad = lp_emit[:, i], lp_phi[:, i, None], logit_paddings[:, i, None]
        next_emit = torch.logaddexp(prev_phi[:, :-1] + e, emit + e)
        next_phi = update_phi(prev_phi + p, emit + p + log_epsilon * (1.0 - repeat))
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * phi + (1.0 - pad) * next_phi
    return -update_phi(phi, emit).gather(1, labellens[:, None])[:, 0]


def ctc_loss(logits: torch.Tensor, logit_paddings: torch.Tensor, labels: torch.Tensor,
             label_paddings: torch.Tensor, blank_id: int = 0,
             log_epsilon: float = -1e5) -> torch.Tensor:
    """optax.ctc_loss: logits [B, T, K], logit_paddings [B, T] (1.0 = padded
    frame, padding at the end), labels [B, N] right-padded, label_paddings
    [B, N] (1.0 = padded label) -> the per-row negative log-likelihood [B].

    A row with an alignment (frames >= labels + adjacent repeats) scores its
    exact CTC loss, where optax's log-epsilon terms underflow to 0: those
    rows take F.ctc_loss. A row without one, which F.ctc_loss scores inf,
    takes optax's recursion (`_ctc_recursion`), whose log-epsilon paths give
    it a large finite loss, as JAX's."""
    logprobs = torch.log_softmax(logits, dim=-1)
    frames = (1.0 - logit_paddings).sum(dim=1).long()
    valid = label_paddings == 0
    n_labels = valid.sum(dim=1)
    repeats = ((labels[:, 1:] == labels[:, :-1]) & valid[:, 1:]).sum(dim=1)
    feasible = frames >= n_labels + repeats
    per_seq = F.ctc_loss(logprobs.transpose(0, 1), labels.long(), frames, n_labels,
                         blank=blank_id, reduction="none", zero_infinity=True)
    if not bool(feasible.all()):
        rows = (~feasible).nonzero()[:, 0]
        per_seq = per_seq.index_put((rows,), _ctc_recursion(
            logprobs[rows], logit_paddings[rows], labels[rows], label_paddings[rows], blank_id,
            log_epsilon))
    return per_seq


def _multitask_prev(batch: Dict, names) -> Optional[Dict[str, torch.Tensor]]:
    """{task: prev_output_tokens} of the transformer aux heads in `batch`."""
    out = {name: batch["multitask"][name]["prev_output_tokens"]
           for name in names if "prev_output_tokens" in batch.get("multitask", {}).get(name, {})}
    return out or None


def apply_multitask_losses(multitask: Dict, out: Dict, batch: Dict, loss: torch.Tensor,
                           metrics: Dict, ntokens: torch.Tensor) -> torch.Tensor:
    """The --multitask-config-yaml terms (reference get_multitask_loss,
    research/TranSpeech/criterion.py:44-94): loss += weight * task_loss /
    ntokens per task, task_loss the task's SUM: label-smoothed CE at its
    non-pad targets for a transformer head, CTC (blank 0) for a CTC head,
    whose rows that cannot align (more labels than frames) or score
    non-finite are zeroed under the task's zero_infinity. Each task's mean
    per target token goes into `metrics` as multitask_{name}_loss."""
    for name, tc in multitask.items():
        mt_out = out.get("multitask", {}).get(name)
        mt_batch = batch.get("multitask", {}).get(name)
        if mt_out is None or mt_batch is None:
            continue
        weight = mt_batch.get("loss_weight", 1.0)
        mt_tgt = mt_batch["target"].long()
        logits = mt_out["logits"].float()
        if tc.decoder_type == "ctc":
            logit_mask = mt_out["mask"]
            per_seq = ctc_loss(logits, (~logit_mask).float(), mt_tgt, (mt_tgt == PAD).float())
            feasible = ((mt_tgt != PAD).sum(dim=1) <= logit_mask.sum(dim=1)) & torch.isfinite(
                per_seq)
            if tc.zero_infinity:
                per_seq = torch.where(feasible, per_seq, 0.0)
            task_loss = per_seq.sum()
        else:
            lprobs = torch.log_softmax(logits, dim=-1)
            task_loss, _ = label_smoothed_nll_loss(lprobs.reshape(-1, lprobs.shape[-1]),
                                                   mt_tgt.reshape(-1), tc.label_smoothing,
                                                   ignore_index=PAD)
        loss = loss + weight * task_loss / ntokens
        metrics[f"multitask_{name}_loss"] = task_loss / torch.clamp((mt_tgt != PAD).sum(), min=1)
    return loss


class NARSpeechToUnitLoss:
    # the reference backwards the summed loss: the trainer scales each
    # micro-batch's gradients by its sample_size and divides by the total
    grad_accum = "sum_loss"

    def __init__(self, label_smoothing: float = 0.2, multitask: Optional[Dict] = None):
        """multitask: {task: SingleTaskConfig}."""
        self.eps = label_smoothing
        self.multitask = dict(multitask or {})

    def __call__(self, model, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: src_tokens [B, T, F], src_lengths [B], prev_target (the
        CMLM canvas) and target [B, L] ([B, L, k] stacked); where given,
        tgt_speaker [B, D], ctc_target [B, N] and the aux tasks' entries
        under "multitask"; a training forward's CG and SP draws may be
        injected as inject_cg_drop [B] and inject_use_prompt (0-d). The
        model's dropouts draw from its own generators, so `generator` (the
        trainer's, for criterions that draw) is not used. Returns (loss,
        metrics)."""
        tgt = batch["target"].long()
        out = model(batch["src_tokens"], batch["src_lengths"], batch["prev_target"], tgt,
                    cg_drop=batch.get("inject_cg_drop"),
                    use_prompt=batch.get("inject_use_prompt"),
                    multitask_prev=_multitask_prev(batch, self.multitask),
                    tgt_speaker=batch.get("tgt_speaker"))
        logits = out["logits"]
        lprobs = torch.log_softmax(logits.float(), dim=-1).reshape(-1, logits.shape[-1])
        wmask = out["word_ins_mask"]
        if logits.dim() == 4:  # stacked: the canvas mask over every sub-frame
            wmask = wmask[..., None]
        keep = wmask & (tgt != PAD)
        masked_tgt = torch.where(keep, tgt, PAD).reshape(-1)
        ce_sum, nll_sum = label_smoothed_nll_loss(lprobs, masked_tgt, self.eps, ignore_index=PAD)
        len_lprobs = torch.log_softmax(out["length_logits"].float(), dim=-1)
        len_sum, _ = label_smoothed_nll_loss(len_lprobs, out["length_tgt"], self.eps,
                                             ignore_index=PAD)
        ntokens = torch.clamp((tgt != PAD).sum(), min=1)
        loss = (ce_sum + len_sum) / ntokens
        n_correct = ((lprobs.argmax(-1) == masked_tgt) & keep.reshape(-1)).sum()
        metrics = {
            "loss": loss, "nll_loss": nll_sum / ntokens, "loss_length": len_sum / ntokens,
            "acc": n_correct / torch.clamp(keep.sum(), min=1), "ntokens": ntokens,
            "nsentences": tgt.shape[0], "sample_size": ntokens,
        }
        if "ctc_logits" in out and batch.get("ctc_target") is not None:
            if active_split() is not None:
                raise NotImplementedError(
                    "--multitask-ctc-vocab under data parallelism: the CTC term is a mean over "
                    "a rank's rows, not the global batch's (ROADMAP Queue 1 item 8e)")
            ctc_target = batch["ctc_target"].long()
            metrics["ctc_loss"] = ctc_loss(out["ctc_logits"].float(), (~out["ctc_mask"]).float(),
                                           ctc_target, (ctc_target == PAD).float()).mean()
            loss = loss + metrics["ctc_loss"]
            metrics["loss"] = loss
        if self.multitask:
            loss = apply_multitask_losses(self.multitask, out, batch, loss, metrics, ntokens)
            metrics["loss"] = loss
        return loss, metrics
