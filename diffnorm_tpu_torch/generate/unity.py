"""UnitY two-pass generation (the port of diffnorm_tpu/generate/unity.py;
reference examples/speech_to_speech/unity/sequence_generator_multi_decoder.py):
beam-search the first-pass text decoder, hand its best hypothesis to the
text-to-unit encoder, then beam-search the unit decoder.

The handoff is JAX's: the best first-pass hypothesis [B, Lmt] (tokens, its
EOS, then PAD) becomes prev_output_tokens_mt = [EOS, t0 .. t_{m-1}, PAD ..],
PAD wherever the hypothesis is PAD; the first pass's teacher-forced
features over it, through the synthesizer encoder where the model has one,
are the second pass's context under the mask prev_mt != PAD. Each pass is
`beam_search.beam_search` over the model's cached step with the encoder
states (the context) repeated beam-fold. `first_pass` is shared with
Translatotron2 (`generate/translatotron2.py`). An ensemble decodes with its
first model, as JAX's does.
"""

from __future__ import annotations

from typing import Optional

import torch

from diffnorm_tpu_torch.generate.beam_search import beam_search

PAD, BOS, EOS, UNK = 1, 0, 2, 3


def beam_pass(init_cache, decode_step, ctx: torch.Tensor, ctx_mask: torch.Tensor,
              beam_size: int, max_len: int, vocab: int, **beam_kwargs):
    """One cached-decoder beam pass over ctx [B, S, C]: init_cache(ctx, mask,
    max_len) and decode_step(tokens [N, 1], cache, positions [N]) -> (logits,
    cache) of one decoder. Returns (seqs [B, K, max_len], scores [B, K])."""
    b = ctx.shape[0]
    cache = init_cache(ctx.repeat_interleave(beam_size, dim=0),
                       ctx_mask.repeat_interleave(beam_size, dim=0), max_len)

    def step(cache, tokens, positions):
        return decode_step(tokens, cache, positions)

    return beam_search(step, cache, b, beam_size, max_len, vocab, device=ctx.device,
                       **beam_kwargs)


def handoff_tokens(best_mt: torch.Tensor) -> torch.Tensor:
    """prev_output_tokens_mt of the best hypotheses [B, Lmt]: the EOS moved
    to the front, PAD where the hypothesis is PAD."""
    shifted = torch.cat([torch.full_like(best_mt[:, :1], EOS), best_mt[:, :-1]], dim=1)
    return torch.where(best_mt == PAD, PAD, shifted)


@torch.no_grad()
def first_pass(model, enc: torch.Tensor, enc_mask: torch.Tensor, beam_size_mt: int = 5,
               max_len_mt: int = 256, min_len: int = 1, len_penalty_mt: float = 1.0,
               no_repeat_ngram: int = 0, unk_penalty: float = 0.0):
    """The first-pass beam and the handoff: (best_mt [B, Lmt], the second
    pass's context [B, Lmt, D] and its mask [B, Lmt])."""
    mt_seqs, _ = beam_pass(model.init_mt_cache, model.decode_mt_step, enc, enc_mask,
                           beam_size_mt, max_len_mt, model.mt_vocab_size, min_len=min_len,
                           len_penalty=len_penalty_mt, no_repeat_ngram=no_repeat_ngram,
                           unk_penalty=unk_penalty)
    best_mt = mt_seqs[:, 0]
    prev_mt = handoff_tokens(best_mt)
    ctx, ctx_mask = model.synthesize(model.mt_features(prev_mt, enc, enc_mask), prev_mt != PAD)
    return best_mt, ctx, ctx_mask


@torch.no_grad()
def unity_generate(model, src: torch.Tensor, src_lengths: torch.Tensor, beam_size: int = 5,
                   beam_size_mt: int = 5, max_len: int = 256, max_len_mt: int = 256,
                   min_len: int = 1, len_penalty: float = 1.0, len_penalty_mt: float = 1.0,
                   no_repeat_ngram: int = 0, unk_penalty: float = 0.0,
                   tgt_speaker: Optional[torch.Tensor] = None):
    """Returns (unit seqs [B, K, L], unit scores [B, K], mt_best [B, Lmt]),
    mt_best the first-pass hypothesis the second pass read (tokens, EOS,
    PAD)."""
    if isinstance(model, (list, tuple)):
        model = model[0]
    enc, enc_mask = model.encode(src, src_lengths, tgt_speaker=tgt_speaker)
    best_mt, t2u, t2u_mask = first_pass(
        model, enc, enc_mask, beam_size_mt=beam_size_mt, max_len_mt=max_len_mt,
        min_len=min_len, len_penalty_mt=len_penalty_mt, no_repeat_ngram=no_repeat_ngram,
        unk_penalty=unk_penalty)
    seqs, scores = beam_pass(model.init_cache, model.decode_step, t2u, t2u_mask, beam_size,
                             max_len, model.vocab_size, min_len=min_len,
                             len_penalty=len_penalty, no_repeat_ngram=no_repeat_ngram,
                             unk_penalty=unk_penalty)
    return seqs, scores, best_mt
