"""Mask-predict iterative refinement decoding (CMLM), PyTorch.

Counterpart of diffnorm_tpu/generate/mask_predict.py for one model:
* canvas init from the 256-way length prediction, or from the lengths the
  caller forces (`true_length`), clamped to >= 2: all unk with EOS at
  len - 1 (JAX's default `place_eos`)
* per step: fill masked positions with the argmax log-probs, with
  classifier-free guidance when cond_scale != 1
  (lp = uncond + scale * (cond - uncond)), then skeptically re-mask the
  floor((1 - (step+1)/max_step) * (len - 2)) lowest-scoring positions
* adaptive exit: a row whose filled canvas repeats is frozen; the loop
  stops once every row is frozen (`early_exit`), which gives the outputs of
  the fixed-trip loop (`early_exit=False`), as the JAX while_loop does;
  `adaptive=False` (fairseq's --iter-decode-force-max-iter) freezes no row,
  so every row runs max_iter + 1 fills
* length beam: rows with lengths l + k - beam//2 (clamped to >= 2 before the
  offset), the best mean-score hypothesis per sentence
* stacked units (the model's n_frames_per_step k > 1): the canvas holds
  packed ids; a fill takes each sub-frame's argmax of the [B, T, k, V]
  log-probs, scores the step by their mean, writes EOS where any sub-frame
  is a special and re-packs the rest; the result is unpacked to the
  full-rate stream [B, T * k] (specials repeated per sub-frame), each
  step's score repeated
* `tgt_speaker` [B, D] conditions the encoder (--target-speaker-embed)
"""

from __future__ import annotations

from typing import Optional

import torch

from diffnorm_tpu_torch.models.stacked import OFFSET, pack_units, unpack_units

PAD, BOS, EOS, UNK = 1, 0, 2, 3


def skeptical_mask(scores: torch.Tensor, non_pad: torch.Tensor, p) -> torch.Tensor:
    """Re-mask the floor((count - 2) * p) lowest-scoring positions per row.
    scores [B, T] (log-probs <= 0; pads carry 0 and sort last); ties keep
    their order, as jnp.argsort (stable) does."""
    boundary = ((non_pad.sum(dim=1, keepdim=True) - 2) * p).to(torch.int32)
    order = torch.argsort(scores, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)
    return rank < boundary


def fill_and_remask(tokens, scores, new_tokens, new_scores, step: int, max_step: int):
    """One iteration's canvas update given the argmax fill. Returns
    (filled_tokens, filled_scores, out_tokens, out_scores)."""
    masks = tokens == UNK
    filled_tokens = torch.where(masks, new_tokens, tokens)
    filled_scores = torch.where(masks, new_scores, scores)
    # p as ONE correctly rounded float32 division, as JAX computes it
    # (mask_predict.py:56-62): 1.0f - (step+1)/max_step in float32 lands
    # one ulp lower and re-masks one position fewer
    p = torch.tensor(float(max_step - 1 - step), dtype=torch.float32) / max_step
    if step + 1 < max_step:
        smask = skeptical_mask(filled_scores, filled_tokens != PAD, p.to(tokens.device))
    else:
        smask = torch.zeros_like(masks)
    out_tokens = torch.where(smask, UNK, filled_tokens)
    out_scores = torch.where(smask, 0.0, filled_scores)
    return filled_tokens, filled_scores, out_tokens, out_scores


def init_canvas(length_tgt: torch.Tensor, max_len: int):
    """[B] lengths -> (tokens [B, max_len] unk/eos/pad, f32 zero scores)."""
    length_tgt = torch.clamp(length_tgt, min=2)
    pos = torch.arange(max_len, device=length_tgt.device)[None, :]
    tokens = torch.where(pos < length_tgt[:, None], UNK, PAD).to(torch.int64)
    tokens = torch.where(pos == (length_tgt - 1)[:, None], EOS, tokens)
    return tokens, torch.zeros(tokens.shape, dtype=torch.float32, device=tokens.device)


@torch.no_grad()
def mask_predict_decode(model, src: torch.Tensor, src_lengths: torch.Tensor, *,
                        max_iter: int = 15, max_len: int = 256, cond_scale: float = 1.0,
                        length_beam: int = 1, true_length: Optional[torch.Tensor] = None,
                        adaptive: bool = True, early_exit: bool = True,
                        tgt_speaker: Optional[torch.Tensor] = None):
    """model: a `models.nar_transformer.NARS2UTModule`. `true_length` [B]
    (int) replaces the length head's prediction (in packed steps when
    stacked). Returns (tokens [B, max_len * k] int64, scores of the same
    shape f32, n_steps [B] int32): the number of decoder iterations each row
    ran before it froze. k is the model's n_frames_per_step, which JAX's
    takes as an argument."""
    kf = model.n_frames_per_step
    sub_vocab = model.vocab_size - OFFSET
    enc, enc_mask = model.encode(src, src_lengths, tgt_speaker=tgt_speaker)
    if true_length is not None:
        length_tgt = true_length.to(device=enc.device, dtype=torch.int64)
    else:
        length_lp = torch.log_softmax(model.forward_length(enc, enc_mask).float(), dim=-1)
        length_tgt = length_lp.argmax(dim=-1)
    if length_beam > 1:
        # clamp before the offset (nar_transformer.py:858,:898 in the
        # reference), or every beam of a < 2 prediction shifts
        length_tgt = torch.clamp(length_tgt, min=2)
        offsets = torch.arange(length_beam, device=enc.device) - length_beam // 2
        length_tgt = (length_tgt[:, None] + offsets[None, :]).reshape(-1)
        enc = enc.repeat_interleave(length_beam, dim=0)
        enc_mask = enc_mask.repeat_interleave(length_beam, dim=0)
    tokens, scores = init_canvas(length_tgt, max_len)

    use_cg = cond_scale != 1.0
    if use_cg:
        null_enc, null_mask = model.apply_cg_drop(
            enc, enc_mask, torch.ones(enc.shape[0], dtype=torch.bool, device=enc.device))

    def decode_lprobs(tok):
        lp = torch.log_softmax(model.decode(tok, enc, enc_mask).float(), dim=-1)
        if use_cg:
            null_lp = torch.log_softmax(model.decode(tok, null_enc, null_mask).float(), dim=-1)
            lp = null_lp + cond_scale * (lp - null_lp)
        return lp

    max_step = max_iter + 1
    n = tokens.shape[0]
    done = torch.zeros(n, dtype=torch.bool, device=tokens.device)
    prev_tokens, res_tokens = tokens, tokens
    res_scores = torch.zeros_like(scores)
    n_steps = torch.zeros(n, dtype=torch.int32, device=tokens.device)
    for step in range(max_step):
        if early_exit and bool(done.all()):
            break  # every later iteration leaves every row as it is
        lp = decode_lprobs(tokens)
        new_scores, new_tokens = lp.max(dim=-1)
        if kf > 1:
            hit_special = (new_tokens < OFFSET).any(dim=-1)
            packed = pack_units(torch.clamp(new_tokens - OFFSET, min=0), sub_vocab, kf)
            new_tokens = torch.where(hit_special, EOS, packed)
            new_scores = new_scores.mean(dim=-1)
        filled_tokens, filled_scores, out_tokens, out_scores = fill_and_remask(
            tokens, scores, new_tokens, new_scores, step, max_step)
        # adaptive loop detection on the FILLED canvas (see the JAX module)
        now_done = (filled_tokens == prev_tokens).all(dim=1) & adaptive
        frozen = done[:, None]
        res_tokens = torch.where(frozen, res_tokens, filled_tokens)
        res_scores = torch.where(frozen, res_scores, filled_scores)
        tokens = torch.where(frozen, tokens, out_tokens)
        scores = torch.where(frozen, scores, out_scores)
        n_steps += (~done).to(torch.int32)
        done = done | now_done
        prev_tokens = filled_tokens
    tokens, scores = res_tokens, res_scores

    if length_beam > 1:
        non_pad = tokens != PAD
        sel = (scores * non_pad).sum(dim=1) / torch.clamp(non_pad.sum(dim=1), min=1)
        best = sel.reshape(-1, length_beam).argmax(dim=1)
        rows = torch.arange(best.shape[0], device=best.device)
        tokens = tokens.reshape(-1, length_beam, tokens.shape[-1])[rows, best]
        scores = scores.reshape(-1, length_beam, scores.shape[-1])[rows, best]
        n_steps = n_steps.reshape(-1, length_beam)[rows, best]
    if kf > 1:
        tokens = unpack_units(tokens, sub_vocab, kf).reshape(tokens.shape[0], -1)
        scores = scores.repeat_interleave(kf, dim=1)
    return tokens, scores, n_steps
