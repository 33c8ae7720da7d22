"""AR generation for the unit decoder: fairseq's beam search, ancestral
sampling and the greedy stacked decode (the port of
diffnorm_tpu/generate/beam_search.py:31-472).

`beam_search` keeps JAX's semantics, which are fairseq's
(sequence_generator.py:_generate with search.BeamSearch): 2K candidates a
step, EOS candidates among the top K finalize and leave the beam (the next
best continuations take their slots), ignored slots (cands_to_ignore),
min and max length with the model's own EOS log-prob on the forced last
step, the unk penalty, forced prefixes, ngram blocking, length-normalized
scores, finalized hypotheses in static [B, K, L] buffers. JAX's
lax.while_loop is a Python loop over the steps here, with one host sync a
step for its stop test. Top-k selections break ties by the lower index, as
lax.top_k does. Sequences are [B * K, L] with a sentence's beams
contiguous; the decode state follows each selection through its
`reorder(index)` (a tuple of states, an ensemble's, each; a tensor by its
rows).

Sampling (`sample_generate`, --sampling with --sampling-topk / -topp and
--temperature) draws from an explicit `torch.Generator`: JAX's PRNG stream
cannot be reproduced, so draws match JAX's only where the cut leaves one
token.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from diffnorm_tpu_torch.generate.mask_predict import average_log_probs
from diffnorm_tpu_torch.models.stacked import stack_unit_generate

PAD, BOS, EOS, UNK = 1, 0, 2, 3
NEG_INF = -1.0e7


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, ties broken
    by the lower index (lax.top_k's order)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def ngram_blocking_mask(seqs: torch.Tensor, step: int, vocab_size: int,
                        ngram: int) -> torch.Tensor:
    """The additive ban [N, V] (0 or NEG_INF) of the tokens that would
    complete an n-gram already seen in seqs [N, L], whose positions < step
    are generated."""
    n, length = seqs.shape
    banned = torch.zeros(n, vocab_size, dtype=torch.float32, device=seqs.device)
    n_windows = min(length - ngram + 1, step - ngram + 1)
    if ngram <= 0 or n_windows <= 0:
        return banned
    suffix = seqs[:, [max(step - (ngram - 1) + o, 0) for o in range(ngram - 1)]]  # [N, n - 1]
    windows = seqs.unfold(1, ngram, 1)[:, :n_windows]  # [N, W, n]
    match = (windows[..., :-1] == suffix[:, None, :]).all(dim=-1)
    banned.scatter_add_(1, windows[..., -1], torch.where(match, NEG_INF, 0.0))
    return torch.clamp(banned, min=NEG_INF)


def _reorder(state, index: torch.Tensor):
    if state is None:
        return None
    if isinstance(state, (tuple, list)):
        return type(state)(_reorder(s, index) for s in state)
    if isinstance(state, torch.Tensor):
        return state.index_select(0, index)
    return state.reorder(index)


@torch.no_grad()
def beam_search(decode_step, init_cache, batch_size: int, beam_size: int, max_len: int,
                vocab_size: int, min_len: int = 1, len_penalty: float = 1.0,
                no_repeat_ngram: int = 0, unk_penalty: float = 0.0,
                prefix_tokens: Optional[torch.Tensor] = None, normalize_scores: bool = True,
                device=None):
    """decode_step(cache, tokens [N, 1], positions [N]) -> (log-probs [N, V],
    cache), N = batch_size * beam_size. Returns (seqs [B, K, L], scores
    [B, K]) best first; scores are normalized by length ** len_penalty with
    `normalize_scores`. `max_len` counts the emitted sequence with its final
    EOS. prefix_tokens [B, P]: the first P tokens forced (PAD positions
    free), the forced token keeping its log-prob."""
    n, k = batch_size * beam_size, beam_size
    cand_size = 2 * k
    if cand_size > vocab_size - 1:
        raise ValueError("fairseq takes min(2 * beam, vocab - 1) candidates: use a larger vocab")
    f_max = max_len - 1  # fairseq's max_len, without the final EOS
    neg_inf = -math.inf
    dev = device
    b_idx = torch.arange(batch_size, device=dev)[:, None]
    slots = torch.arange(cand_size, device=dev)[None, :]
    tokens = torch.full((n, max_len), PAD, dtype=torch.int64, device=dev)
    scores_buf = torch.zeros(n, max_len, dtype=torch.float32, device=dev)
    prev = torch.full((n, 1), EOS, dtype=torch.int64, device=dev)
    ignore = torch.zeros(batch_size, k, dtype=torch.bool, device=dev)
    # the finalized hypotheses, and a last slot for the candidates not kept
    fin_tok = torch.full((batch_size, k + 1, max_len), PAD, dtype=torch.int64, device=dev)
    fin_score = torch.full((batch_size, k + 1), neg_inf, dtype=torch.float32, device=dev)
    fin_count = torch.zeros(batch_size, dtype=torch.int64, device=dev)
    finished = torch.zeros(batch_size, dtype=torch.bool, device=dev)
    cache = init_cache
    step = 0
    while step <= f_max and not bool(finished.all()):
        lp, cache = decode_step(cache, prev, torch.full((n,), step, device=dev))
        lp = torch.log_softmax(lp.float(), dim=-1)
        lp = torch.nan_to_num(lp, nan=neg_inf, neginf=neg_inf)
        lp[:, PAD] = neg_inf
        lp[:, UNK] -= unk_penalty
        if step >= f_max:  # force EOS, keeping the model's EOS log-prob
            eos_lp = lp[:, EOS].clone()
            lp.fill_(neg_inf)
            lp[:, EOS] = eos_lp
        prefix_active = False
        if prefix_tokens is not None and prefix_tokens.shape[1] > 0:
            p_len = prefix_tokens.shape[1]
            forced = prefix_tokens[:, min(step, p_len - 1)].long().repeat_interleave(k)
            prefix_active = step < p_len and step < f_max
            if prefix_active:
                use = forced != PAD
                keep = torch.zeros_like(lp, dtype=torch.bool)
                keep[torch.arange(n, device=dev), forced] = True
                lp = torch.where(use[:, None] & ~keep, neg_inf, lp)
        if not prefix_active and step < min_len:
            lp[:, EOS] = neg_inf
        if no_repeat_ngram > 0:
            blk = ngram_blocking_mask(tokens, step, vocab_size, no_repeat_ngram)
            lp = torch.where(blk < 0, neg_inf, lp)

        # search.BeamSearch.step: cumulative scores, the top 2K candidates
        cum_prev = scores_buf[:, step - 1] if step > 0 else torch.zeros_like(scores_buf[:, 0])
        cand = (lp + cum_prev[:, None]).reshape(batch_size, k, vocab_size)
        if step == 0:  # every beam is the same: beam 0 alone
            cand[:, 1:] = neg_inf
        cand_scores, cand_idx = top_k(cand.reshape(batch_size, -1), cand_size)
        cand_beams = torch.div(cand_idx, vocab_size, rounding_mode="floor")
        cand_toks = cand_idx % vocab_size
        cand_bbsz = cand_beams + b_idx * k  # rows of [N]

        # finalize the EOS candidates among the top K slots
        top_slots = slots < k
        eos_mask = (cand_toks == EOS) & torch.isfinite(cand_scores)
        eos_mask &= ~torch.cat([ignore, torch.zeros_like(ignore)], dim=1) | ~top_slots
        fin_this = eos_mask & top_slots & ~finished[:, None]
        rank = fin_count[:, None] + torch.cumsum(fin_this.long(), dim=1) - 1
        write = fin_this & (rank < k)
        tgt = torch.where(write, rank, k)  # slot k takes what is not written
        hyp_tok = tokens[cand_bbsz.reshape(-1)].reshape(batch_size, cand_size, max_len)
        hyp_tok[:, :, step] = EOS
        hyp_score = cand_scores
        if normalize_scores:
            hyp_score = hyp_score / float(step + 1) ** len_penalty
        fin_tok.scatter_(1, tgt[..., None].expand(-1, -1, max_len), hyp_tok)
        fin_score.scatter_(1, tgt, hyp_score)
        fin_count = fin_count + write.sum(dim=1)
        finished = finished | (fin_count >= k) | (step >= f_max)

        # the K lowest of (eos ? 2K : 0) + slot: non-EOS first, in order
        active_mask = eos_mask.long() * cand_size + slots
        neg_top, active_hypos = top_k(-active_mask, k)
        ignore = -neg_top >= cand_size
        flat_src = torch.gather(cand_bbsz, 1, active_hypos).reshape(-1)
        active_scores = torch.gather(cand_scores, 1, active_hypos).reshape(-1)
        active_toks = torch.gather(cand_toks, 1, active_hypos).reshape(-1)
        tokens = tokens[flat_src]
        tokens[:, step] = active_toks
        scores_buf = scores_buf[flat_src]
        scores_buf[:, step] = torch.nan_to_num(active_scores, nan=NEG_INF, neginf=NEG_INF)
        prev = active_toks[:, None]
        cache = _reorder(cache, flat_src)
        step += 1
    fin_tok, fin_score = fin_tok[:, :k], fin_score[:, :k]
    order = torch.sort(-fin_score, dim=1, stable=True).indices
    return fin_tok[b_idx, order], fin_score[b_idx, order]


@torch.no_grad()
def sample_generate(decode_step, init_cache, batch_size: int, max_len: int, vocab_size: int,
                    generator: Optional[torch.Generator] = None, temperature: float = 1.0,
                    sampling_topk: int = 0, sampling_topp: float = 0.0, min_len: int = 1,
                    unk_penalty: float = 0.0, no_repeat_ngram: int = 0,
                    prefix_tokens: Optional[torch.Tensor] = None, device=None):
    """Ancestral sampling (fairseq search.Sampling): each row draws from its
    temperature-scaled distribution, cut to the top-k tokens or to the
    smallest nucleus whose probability reaches p (the crossing token kept),
    after the prefix and ngram constraints, from `generator`. decode_step
    as for `beam_search` with N = batch_size; prefix_tokens [N, P] per row.
    A row stops at its EOS (PAD after it); the loop stops once every row
    has. Returns (seqs [N, L], scores [N], the sum of the drawn log-probs)."""
    n, dev = batch_size, device
    rows = torch.arange(n, device=dev)
    seqs = torch.full((n, max_len), PAD, dtype=torch.int64, device=dev)
    prev = torch.full((n, 1), EOS, dtype=torch.int64, device=dev)
    scores = torch.zeros(n, dtype=torch.float32, device=dev)
    finished = torch.zeros(n, dtype=torch.bool, device=dev)
    cache = init_cache
    for step in range(max_len):
        lp, cache = decode_step(cache, prev, torch.full((n,), step, device=dev))
        lp = torch.log_softmax(lp.float() / temperature, dim=-1)
        lp[:, PAD] = NEG_INF
        lp[:, BOS] = NEG_INF
        lp[:, UNK] -= unk_penalty
        if step < min_len:
            lp[:, EOS] = NEG_INF
        if prefix_tokens is not None and prefix_tokens.shape[1] > 0:
            p_len = prefix_tokens.shape[1]
            forced = prefix_tokens[:, min(step, p_len - 1)].long()
            use = (step < p_len) & (forced != PAD) & ~finished
            keep = torch.zeros_like(lp, dtype=torch.bool)
            keep[rows, forced] = True
            lp = torch.where(use[:, None] & ~keep, NEG_INF, lp)
        if no_repeat_ngram > 0:
            lp = lp + ngram_blocking_mask(seqs, step, vocab_size, no_repeat_ngram)
        if sampling_topk > 0:
            kth = top_k(lp, sampling_topk)[0][:, -1:]
            lp = torch.where(lp < kth, NEG_INF, lp)
        if sampling_topp > 0.0:
            sorted_lp = torch.sort(lp, dim=-1, descending=True).values
            p = sorted_lp.exp()
            inside = p.cumsum(dim=-1) - p < sampling_topp
            cutoff = torch.where(inside, sorted_lp, math.inf).amin(dim=-1, keepdim=True)
            lp = torch.where(lp < cutoff, NEG_INF, lp)
        tok = torch.multinomial(torch.softmax(lp, dim=-1), 1, generator=generator)[:, 0]
        tok = torch.where(finished, PAD, tok)
        tok_lp = lp.gather(1, tok[:, None])[:, 0]
        scores = scores + torch.where(finished, 0.0, tok_lp)
        seqs[:, step] = tok
        finished = finished | (tok == EOS)
        prev = tok[:, None]
        if bool(finished.all()):
            break
    return seqs, scores


@torch.no_grad()
def ar_generate(model, src: torch.Tensor, src_lengths: torch.Tensor, beam_size: int = 5,
                max_len: int = 256, min_len: int = 1, len_penalty: float = 1.0,
                no_repeat_ngram: int = 0, unk_penalty: float = 0.0,
                prefix_tokens: Optional[torch.Tensor] = None, sampling: bool = False,
                sampling_topk: int = 0, sampling_topp: float = 0.0, temperature: float = 1.0,
                generator: Optional[torch.Generator] = None,
                tgt_speaker: Optional[torch.Tensor] = None):
    """AR decoding of an `ARS2UTModule`, or a list of them of one
    architecture (an ensemble: each member encodes and keeps its own cache,
    on the first member's encoder mask; the step's log-probs are the
    members' logsumexp minus log M, float32). The encoder states are
    repeated beam_size-fold, a sentence's rows contiguous. Returns (seqs
    [B, K, L], scores [B, K]) best first: the beam search's, or with
    `sampling` beam_size draws a sentence, each scored by its log-prob over
    length ** len_penalty."""
    models = list(model) if isinstance(model, (list, tuple)) else [model]
    pairs = [m.encode(src, src_lengths, tgt_speaker=tgt_speaker) for m in models]
    b = pairs[0][0].shape[0]
    mask_rep = pairs[0][1].repeat_interleave(beam_size, dim=0)
    caches = tuple(m.init_cache(e.repeat_interleave(beam_size, dim=0), mask_rep, max_len)
                   for m, (e, _) in zip(models, pairs))

    def decode_step(caches, tokens, positions):
        lps = []
        for m, c in zip(models, caches):
            logits, _ = m.decode_step(tokens, c, positions)
            lps.append(torch.log_softmax(logits.float(), dim=-1))
        return average_log_probs(lps), caches

    vocab, dev = models[0].vocab_size, src.device
    if sampling:
        seqs, scores = sample_generate(
            decode_step, caches, b * beam_size, max_len, vocab, generator=generator,
            temperature=temperature, sampling_topk=sampling_topk, sampling_topp=sampling_topp,
            min_len=min_len, unk_penalty=unk_penalty, no_repeat_ngram=no_repeat_ngram,
            prefix_tokens=(None if prefix_tokens is None
                           else prefix_tokens.repeat_interleave(beam_size, dim=0)),
            device=dev)
        lengths = (seqs != PAD).sum(dim=1).float()
        norm = (scores / torch.clamp(lengths, min=1.0) ** len_penalty).reshape(b, beam_size)
        seqs = seqs.reshape(b, beam_size, max_len)
        order = torch.sort(-norm, dim=1, stable=True).indices
        b_idx = torch.arange(b, device=dev)[:, None]
        return seqs[b_idx, order], norm[b_idx, order]
    return beam_search(decode_step, caches, b, beam_size, max_len, vocab, min_len=min_len,
                       len_penalty=len_penalty, no_repeat_ngram=no_repeat_ngram,
                       unk_penalty=unk_penalty, prefix_tokens=prefix_tokens, device=dev)


@torch.no_grad()
def ar_generate_stacked(model, src: torch.Tensor, src_lengths: torch.Tensor,
                        max_len: int = 256, tgt_speaker: Optional[torch.Tensor] = None):
    """Greedy stacked-unit decoding of an n_frames_per_step k > 1
    `ARS2UTModule` (fairseq's StackUnitSequenceGenerator, one model):
    `models.stacked.stack_unit_generate` over its cache. Returns (packed
    [B, max_len], sub [B, max_len, k]): `sub` is the full-rate unit stream."""
    enc, enc_mask = model.encode(src, src_lengths, tgt_speaker=tgt_speaker)
    cache = model.init_cache(enc, enc_mask, max_len)

    def decode_step(cache, prev, positions):
        logits, cache = model.decode_step(prev[:, None], cache, positions)
        return logits, cache

    return stack_unit_generate(decode_step, enc.shape[0], model.vocab_size - 4,
                               model.n_frames_per_step, max_len=max_len, init_state=cache,
                               device=src.device)
