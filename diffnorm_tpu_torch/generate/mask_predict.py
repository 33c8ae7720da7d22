"""Mask-predict iterative refinement decoding (CMLM), PyTorch.

Counterpart of diffnorm_tpu/generate/mask_predict.py:
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
* an ensemble (a list of models of one architecture, fairseq's --path a:b):
  every member encodes, the encoder mask is the first member's, and the
  length and token log-probs are averaged as logsumexp over the members
  minus log M in float32, each member's guidance applied before the average
* `retain_history` (--retain-iter-history) also returns each step's filled
  canvas [max_iter + 1, B, T] (rows frozen by the adaptive exit repeat their
  final canvas, beams selected as the tokens are, stacked units unpacked);
  it runs every step, as JAX turns its early exit off for it
* `mask_predict_decode_chunked` decodes sub-batches of `chunk` rows
  (--decode-chunk), the last padded with copies of the last row
* `mesh` (a `parallel.mesh.Mesh` of N ranks, each passing the same
  batch) splits the rows over the data ranks and gathers the outputs in
  order (`parallel.mesh.split_rows`): each row decodes as it does alone. On
  a data x model mesh the model is split over the model group first
  (`parallel.sharding_rules.shard_model`; JAX's shard_params), and the
  ranks of one model group decode the same rows with their shards
* `reranker` (--rerank-path, an AR S2UT model): a length beam's candidates
  are picked by their mean teacher-forced log-prob under it
  (`ar_rerank_scores`, fairseq's iterative_refinement_generator.py:294-361)
  instead of their mean fill score
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from diffnorm_tpu_torch.models.stacked import OFFSET, pack_units, unpack_units
from diffnorm_tpu_torch.parallel.mesh import split_rows

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


def ar_rerank_scores(ar_model, src: torch.Tensor, src_lengths: torch.Tensor,
                     cand_tokens: torch.Tensor) -> torch.Tensor:
    """The mean log-prob of each candidate [N, T] under an AR model
    (`models.ar_transformer.ARS2UTModule`), src already repeated to N rows:
    position 0 becomes EOS (the decoder's start), the decoder is
    teacher-forced on tokens[:-1], and the log-probs of tokens[1:] are
    averaged over their non-pad positions. One batched forward, float32
    log-probs (JAX mask_predict.py:70-87)."""
    toks = cand_tokens.clone()
    toks[:, 0] = EOS
    lp = torch.log_softmax(ar_model(src, src_lengths, toks[:, :-1])["logits"].float(), dim=-1)
    tgt = toks[:, 1:]
    tok_lp = lp.gather(-1, tgt[..., None])[..., 0]
    m = (tgt != PAD).float()
    return (tok_lp * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)


def init_canvas(length_tgt: torch.Tensor, max_len: int):
    """[B] lengths -> (tokens [B, max_len] unk/eos/pad, f32 zero scores)."""
    length_tgt = torch.clamp(length_tgt, min=2)
    pos = torch.arange(max_len, device=length_tgt.device)[None, :]
    tokens = torch.where(pos < length_tgt[:, None], UNK, PAD).to(torch.int64)
    tokens = torch.where(pos == (length_tgt - 1)[:, None], EOS, tokens)
    return tokens, torch.zeros(tokens.shape, dtype=torch.float32, device=tokens.device)


def average_log_probs(lps):
    """One member's log-probs as they are; an ensemble's as logsumexp over
    the members minus log M (fairseq's EnsembleModel, float32)."""
    if len(lps) == 1:
        return lps[0]
    return torch.logsumexp(torch.stack(lps), dim=0) - math.log(len(lps))


@torch.no_grad()
def mask_predict_decode(model, src: torch.Tensor, src_lengths: torch.Tensor, *,
                        max_iter: int = 15, max_len: int = 256, cond_scale: float = 1.0,
                        length_beam: int = 1, true_length: Optional[torch.Tensor] = None,
                        adaptive: bool = True, early_exit: bool = True,
                        tgt_speaker: Optional[torch.Tensor] = None,
                        retain_history: bool = False, reranker=None, mesh=None):
    """model: a `models.nar_transformer.NARS2UTModule`, or a list of them of
    one architecture (an ensemble). `reranker`: an AR S2UT model (eval mode)
    that picks the length beam's candidate (`ar_rerank_scores`; unit
    canvases only, k = 1). `true_length` [B] (int) replaces the
    length head's prediction (in packed steps when stacked). Returns
    (tokens [B, max_len * k] int64, scores of the same shape f32, n_steps
    [B] int32): the number of decoder iterations each row ran before it
    froze; with `retain_history` also the history [max_iter + 1, B,
    max_len * k]. k is the model's n_frames_per_step, which JAX's takes as
    an argument."""
    if mesh is not None and mesh.active:
        if mesh.model > 1 and not any(getattr(m, "tp_axis", None) is not None
                                      for m in (model if isinstance(model, (list, tuple))
                                                else [model])[0].modules()):
            raise ValueError(f"a mesh of --model-parallel {mesh.model} decodes a model split "
                             f"over its model group: parallel.sharding_rules.shard_model first")
        opts = dict(max_iter=max_iter, max_len=max_len, cond_scale=cond_scale,
                    length_beam=length_beam, adaptive=adaptive, early_exit=early_exit,
                    retain_history=retain_history, reranker=reranker)
        return split_rows(
            mesh, lambda **rows: mask_predict_decode(model, **rows, **opts),
            {"src": src, "src_lengths": src_lengths, "true_length": true_length,
             "tgt_speaker": tgt_speaker}, axes=(0, 0, 0, 1) if retain_history else None)
    models = list(model) if isinstance(model, (list, tuple)) else [model]
    kf = models[0].n_frames_per_step
    sub_vocab = models[0].vocab_size - OFFSET
    pairs = [m.encode(src, src_lengths, tgt_speaker=tgt_speaker) for m in models]
    encs, enc_mask = [e for e, _ in pairs], pairs[0][1]
    if true_length is not None:
        length_tgt = true_length.to(device=enc_mask.device, dtype=torch.int64)
    else:
        length_lp = average_log_probs([
            torch.log_softmax(m.forward_length(e, enc_mask).float(), dim=-1)
            for m, e in zip(models, encs)])
        length_tgt = length_lp.argmax(dim=-1)
    if length_beam > 1:
        # clamp before the offset (nar_transformer.py:858,:898 in the
        # reference), or every beam of a < 2 prediction shifts
        length_tgt = torch.clamp(length_tgt, min=2)
        offsets = torch.arange(length_beam, device=enc_mask.device) - length_beam // 2
        length_tgt = (length_tgt[:, None] + offsets[None, :]).reshape(-1)
        encs = [e.repeat_interleave(length_beam, dim=0) for e in encs]
        enc_mask = enc_mask.repeat_interleave(length_beam, dim=0)
    tokens, scores = init_canvas(length_tgt, max_len)

    use_cg = cond_scale != 1.0
    if use_cg:
        drop = torch.ones(encs[0].shape[0], dtype=torch.bool, device=enc_mask.device)
        nulls = [m.apply_cg_drop(e, enc_mask, drop) for m, e in zip(models, encs)]

    def decode_lprobs(tok):
        lps = []
        for i, (m, e) in enumerate(zip(models, encs)):
            lp = torch.log_softmax(m.decode(tok, e, enc_mask).float(), dim=-1)
            if use_cg:
                null_lp = torch.log_softmax(m.decode(tok, *nulls[i]).float(), dim=-1)
                lp = null_lp + cond_scale * (lp - null_lp)
            lps.append(lp)
        return average_log_probs(lps)

    max_step = max_iter + 1
    n = tokens.shape[0]
    done = torch.zeros(n, dtype=torch.bool, device=tokens.device)
    prev_tokens, res_tokens = tokens, tokens
    res_scores = torch.zeros_like(scores)
    n_steps = torch.zeros(n, dtype=torch.int32, device=tokens.device)
    history = []
    for step in range(max_step):
        if early_exit and not retain_history and bool(done.all()):
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
        if retain_history:
            history.append(res_tokens)
    tokens, scores = res_tokens, res_scores
    history = torch.stack(history) if retain_history else None

    if length_beam > 1:
        if reranker is not None:
            if kf > 1:
                raise ValueError("AR reranking takes unit canvases (n_frames_per_step 1)")
            sel = ar_rerank_scores(reranker, src.repeat_interleave(length_beam, dim=0),
                                   src_lengths.repeat_interleave(length_beam, dim=0), tokens)
        else:
            non_pad = tokens != PAD
            sel = (scores * non_pad).sum(dim=1) / torch.clamp(non_pad.sum(dim=1), min=1)
        best = sel.reshape(-1, length_beam).argmax(dim=1)
        rows = torch.arange(best.shape[0], device=best.device)
        tokens = tokens.reshape(-1, length_beam, tokens.shape[-1])[rows, best]
        scores = scores.reshape(-1, length_beam, scores.shape[-1])[rows, best]
        n_steps = n_steps.reshape(-1, length_beam)[rows, best]
        if history is not None:
            history = history.reshape(max_step, -1, length_beam, history.shape[-1])[:, rows, best]
    if kf > 1:
        tokens = unpack_units(tokens, sub_vocab, kf).reshape(tokens.shape[0], -1)
        scores = scores.repeat_interleave(kf, dim=1)
        if history is not None:
            s, bh = history.shape[:2]
            history = unpack_units(history.reshape(s * bh, -1), sub_vocab, kf).reshape(s, bh, -1)
    if retain_history:
        return tokens, scores, n_steps, history
    return tokens, scores, n_steps


ROW_INPUTS = ("true_length", "tgt_speaker")


def mask_predict_decode_chunked(model, src: torch.Tensor, src_lengths: torch.Tensor, *,
                                chunk: int = 4, **kw):
    """`mask_predict_decode` over sub-batches of `chunk` rows, one after
    another (JAX's lax.map over chunks): B is padded to whole chunks with
    copies of the last row, the per-row inputs (`true_length`,
    `tgt_speaker`) ride along, and the outputs are cut back to B (the
    history reassembled to [S, B, T]). `chunk <= 0` or B <= chunk is the
    plain call. A `mesh` splits the rows over its ranks first, each
    chunking its own."""
    mesh = kw.pop("mesh", None)
    if mesh is not None and mesh.active:
        rows = {"src": src, "src_lengths": src_lengths,
                **{k: kw.pop(k, None) for k in ROW_INPUTS}}
        return split_rows(
            mesh, lambda **r: mask_predict_decode_chunked(model, chunk=chunk, **r, **kw), rows,
            axes=(0, 0, 0, 1) if kw.get("retain_history") else None)
    b = src.shape[0]
    if chunk <= 0 or b <= chunk:
        return mask_predict_decode(model, src, src_lengths, **kw)
    pad = (-b) % chunk

    def pad_rows(x):
        return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])]) if pad else x

    rows = {k: pad_rows(v) for k in ROW_INPUTS if (v := kw.pop(k, None)) is not None}
    src, src_lengths = pad_rows(src), pad_rows(src_lengths)
    outs = [mask_predict_decode(model, src[i:i + chunk], src_lengths[i:i + chunk],
                                **{k: v[i:i + chunk] for k, v in rows.items()}, **kw)
            for i in range(0, b + pad, chunk)]
    merged = [torch.cat([o[j] for o in outs])[:b] for j in range(3)]
    if len(outs[0]) == 4:
        merged.append(torch.cat([o[3] for o in outs], dim=1)[:, :b])
    return tuple(merged)
