"""The CTC criterion, "ctc" (the port of diffnorm_tpu/criterions/ctc_loss.py;
reference fairseq/criterions/ctc.py): per-row CTC over the model's frame
logits, blank 0 (bos), the targets padded with 1, summed over the batch and
divided by ntokens, the non-pad target tokens (at least 1); sample_size
ntokens, accumulated under "sum_loss". The rows go through
`nar_loss.ctc_loss`, optax.ctc_loss's values: a row that cannot align
(more labels and repeats than frames) takes a large finite loss, which
JAX's isfinite filter keeps; a non-finite row is zeroed. The fine-tune's
time and channel masks (`mask_indices`, `channel_mask`) go to the model,
which applies them in training only. `n_emit` counts the greedy best path's
emissions (argmax, repeats collapsed, blanks dropped) over the valid
frames.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from diffnorm_tpu_torch.criterions.nar_loss import ctc_loss

PAD, BLANK = 1, 0


def greedy_emissions(pred: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[B, F] bool: the frames whose argmax `pred` is emitted by best-path
    decoding (not blank, not a repeat of the frame before, valid)."""
    prev = F.pad(pred[:, :-1], (1, 0), value=BLANK)
    return (pred != BLANK) & (pred != prev) & mask


class CtcLoss:
    grad_accum = "sum_loss"

    def __call__(self, model, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: src_tokens, src_lengths, target [B, N] (pad 1), and the
        task's masks where it drew them."""
        tgt = batch["target"]
        extra = {k: batch[k].bool() for k in ("mask_indices", "channel_mask") if k in batch}
        out = model(batch["src_tokens"], batch["src_lengths"], **extra)
        logits = out["logits"].float()
        per_seq = ctc_loss(logits, (~out["mask"]).float(), tgt, (tgt == PAD).float(),
                           blank_id=BLANK)
        per_seq = torch.where(torch.isfinite(per_seq), per_seq, 0.0)
        ntokens = (tgt != PAD).sum().clamp_min(1)
        loss = per_seq.sum() / ntokens
        n_emit = greedy_emissions(logits.argmax(-1), out["mask"]).sum()
        return loss, {"loss": loss, "nll_loss": loss, "n_emit": n_emit, "ntokens": ntokens,
                      "nsentences": tgt.shape[0], "sample_size": ntokens}
