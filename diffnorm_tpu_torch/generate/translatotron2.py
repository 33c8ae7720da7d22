"""Translatotron2 two-pass spectrogram generation (the port of
diffnorm_tpu/generate/translatotron2.py; reference fairseq/speech_generator.py
MultiDecoderSpeechGenerator:129-320): the first-pass text beam and the
handoff of UnitY (`generate/unity.py`'s `first_pass`), then the AR mel
rollout (`generate/speech_ar.py`'s `ar_rollout`) over the synthesizer's
output. An ensemble decodes with its first model, as JAX's does.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from diffnorm_tpu_torch.generate.speech_ar import ar_rollout, finalize
from diffnorm_tpu_torch.generate.unity import first_pass

PAD, BOS, EOS, UNK = 1, 0, 2, 3


@torch.no_grad()
def translatotron2_generate(model, src: torch.Tensor, src_lengths: torch.Tensor,
                            beam_size_mt: int = 5, max_len_mt: int = 256, max_iter: int = 512,
                            eos_prob_threshold: float = 0.5, min_len: int = 1,
                            len_penalty_mt: float = 1.0, no_repeat_ngram: int = 0,
                            unk_penalty: float = 0.0,
                            generator: Optional[torch.Generator] = None,
                            gcmvn_stats: Optional[Dict] = None):
    """Returns (feat [B, max_iter * k, raw_dim], out_lens [B], eos_prob [B,
    max_iter * k], mt_best [B, Lmt]), mt_best the first-pass hypothesis
    (tokens, EOS, PAD)."""
    if isinstance(model, (list, tuple)):
        model = model[0]
    enc, enc_mask = model.encode(src, src_lengths)
    best_mt, ctx, ctx_mask = first_pass(
        model, enc, enc_mask, beam_size_mt=beam_size_mt, max_len_mt=max_len_mt,
        min_len=min_len, len_penalty_mt=len_penalty_mt, no_repeat_ngram=no_repeat_ngram,
        unk_penalty=unk_penalty)
    feat, out_lens, eos_prob = ar_rollout(model, ctx, ctx_mask, max_iter=max_iter,
                                          eos_prob_threshold=eos_prob_threshold,
                                          generator=generator, gcmvn_stats=gcmvn_stats)
    return feat, out_lens, eos_prob, best_mt


class Translatotron2SpeechGenerator:
    """fairseq's MultiDecoderSpeechGenerator: `translatotron2_generate`,
    each sentence cut at its length, and an optional vocoder. Each entry is
    ARSpeechGenerator's with "mt_tokens", the first-pass hypothesis without
    EOS and PAD."""

    def __init__(self, model, vocoder=None, gcmvn_stats: Optional[Dict] = None,
                 max_iter: int = 512, eos_prob_threshold: float = 0.5, beam_size_mt: int = 5,
                 max_len_mt: int = 256, len_penalty_mt: float = 1.0, no_repeat_ngram: int = 0):
        self.model = model[0] if isinstance(model, (list, tuple)) else model
        self.vocoder, self.gcmvn_stats = vocoder, gcmvn_stats
        self.kw = dict(max_iter=max_iter, eos_prob_threshold=eos_prob_threshold,
                       beam_size_mt=beam_size_mt, max_len_mt=max_len_mt,
                       len_penalty_mt=len_penalty_mt, no_repeat_ngram=no_repeat_ngram)

    def generate(self, src: torch.Tensor, src_lengths: torch.Tensor,
                 generator: Optional[torch.Generator] = None) -> List[Dict]:
        feat, out_lens, eos_prob, mt_best = translatotron2_generate(
            self.model, src, src_lengths, generator=generator, gcmvn_stats=self.gcmvn_stats,
            **self.kw)
        entries = finalize(feat, out_lens, eos_prob, self.vocoder)
        for entry, mt in zip(entries, mt_best.cpu().numpy()):
            entry["mt_tokens"] = mt[(mt != PAD) & (mt != EOS)]
        return entries
