"""HuBERT's pretraining criterion, "hubert" (the port of
diffnorm_tpu/criterions/hubert_loss.py; reference
fairseq/criterions/hubert_criterion.py:54-133).

Over the model's [B, F, K] logits: the cross-entropy at the masked valid
frames times `pred_masked_weight`, plus at the unmasked ones times
`pred_nomask_weight`; sample_size the frames those weights count (the
masked ones in every recipe), at least 1; plus `features_pen` times
loss_weights[0] (10 in hubert_base_librispeech.yaml) times sample_size; the
sum divided by sample_size. The trainer accumulates micro-batches under
"sum_loss", as JAX's criterion does. Metrics: loss_m and loss_u (the mean
CE of each set), features_pen, correct_m / count_m and correct_u / count_u
(argmax equal to the label).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch


def loss_weight_list(lw: Union[None, float, Sequence[float]], default) -> list:
    """--loss-weights as a list of floats (a single number one entry)."""
    if lw is None:
        lw = default
    if isinstance(lw, (int, float)):
        lw = [lw]
    return [float(w) for w in lw]


class HubertLoss:
    grad_accum = "sum_loss"

    def __init__(self, pred_masked_weight: float = 1.0, pred_nomask_weight: float = 0.0,
                 loss_weights=None):
        self.pred_masked_weight = float(pred_masked_weight)
        self.pred_nomask_weight = float(pred_nomask_weight)
        lw = loss_weight_list(loss_weights, [10.0])
        self.feature_pen_weight = lw[0] if lw else 0.0

    def __call__(self, model, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: src_tokens, src_lengths, target [B, F] (-1 invalid),
        mask_indices [B, F]. The model's dropouts draw from their own
        generators."""
        target, mask_indices = batch["target"].long(), batch["mask_indices"].bool()
        out = model(batch["src_tokens"], batch["src_lengths"], mask_indices)
        logits = out["logits"]
        valid = out["mask"] & (target >= 0)
        w_m, w_u = mask_indices & valid, ~mask_indices & valid
        tgt = target.clamp_min(0)
        ce = -torch.log_softmax(logits, dim=-1).gather(-1, tgt[..., None])[..., 0]
        pred = logits.argmax(dim=-1)
        loss_m_sum = torch.where(w_m, ce, 0.0).sum()
        loss_u_sum = torch.where(w_u, ce, 0.0).sum()
        count_m, count_u = w_m.sum(), w_u.sum()
        loss = torch.zeros((), device=logits.device)
        sample_size = torch.zeros((), dtype=torch.long, device=logits.device)
        if self.pred_masked_weight > 0:
            loss = loss + self.pred_masked_weight * loss_m_sum
            sample_size = sample_size + count_m
        if self.pred_nomask_weight > 0:
            loss = loss + self.pred_nomask_weight * loss_u_sum
            sample_size = sample_size + count_u
        sample_size = sample_size.clamp_min(1)
        if self.feature_pen_weight:
            loss = loss + self.feature_pen_weight * out["features_pen"] * sample_size
        loss = loss / sample_size
        correct = pred == tgt
        return loss, {"loss": loss, "loss_m": loss_m_sum / count_m.clamp_min(1),
                      "loss_u": loss_u_sum / count_u.clamp_min(1),
                      "features_pen": out["features_pen"],
                      "correct_m": (correct & w_m).sum(), "count_m": count_m,
                      "correct_u": (correct & w_u).sum(), "count_u": count_u,
                      "ntokens": sample_size, "nsentences": target.shape[0],
                      "sample_size": sample_size}
