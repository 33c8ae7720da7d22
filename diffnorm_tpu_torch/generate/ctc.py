"""Greedy best-path CTC decoding (the port of diffnorm_tpu/cli/generate.py's
ctc_generation branch, :355-375; reference ctc.py's valid-step Viterbi and
W2lViterbiDecoder): each frame's argmax of the float32 log-probabilities
(an ensemble's averaged, fairseq's EnsembleModel), repeats collapsed,
blanks (0) and padded frames dropped. A frame that emits nothing gives
PAD, which the output's formatter drops, so the tokens keep their order
without a left-pack; each frame's score is its best log-probability.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from diffnorm_tpu_torch.criterions.ctc_loss import greedy_emissions
from diffnorm_tpu_torch.generate.mask_predict import average_log_probs

PAD = 1


@torch.no_grad()
def ctc_greedy_decode(models: Sequence[torch.nn.Module], src: torch.Tensor,
                      src_lengths: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tokens [B, F] with PAD where a frame emits nothing, scores [B, F])
    of the CTC models (`models.hubert.HubertCTCModule`, eval mode) on a
    waveform batch."""
    lps, mask = [], None
    for model in models:
        out = model(src, src_lengths)
        lps.append(torch.log_softmax(out["logits"].float(), dim=-1))
        mask = out["mask"]
    lp = average_log_probs(lps)
    scores, pred = lp.max(dim=-1)
    return torch.where(greedy_emissions(pred, mask), pred, PAD), scores
