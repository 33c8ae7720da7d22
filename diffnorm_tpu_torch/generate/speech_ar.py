"""Autoregressive spectrogram generation (the port of
diffnorm_tpu/generate/speech_ar.py; reference fairseq/speech_generator.py
AutoRegressiveSpeechGenerator:36-127), for the speech-input s2spect and the
text-input tts_transformer.

`ar_rollout` is JAX's shape-static rollout: all `max_iter` steps run, each
on the decoder's `KVCache` from the previous frame (zeros first); a row's
length freezes at its first step whose EOS probability passes the
threshold (step + 1), and the row decodes on after it. The postnet then
runs once over every row's `max_iter` frames, so the frames within its
reach of a row's cut depend on the frames after its EOS, as in JAX; an early
exit would change them, so there is none. With n_frames_per_step k > 1 the
frames come back [B, max_iter * k, out_dim / k], the lengths times k and the
EOS probabilities repeated k-fold. `gcmvn_stats` ({"mean", "std"} per
channel) undo the global CMVN.

The Tacotron prenet drops out at inference, drawing from `generator` (a
torch.Generator on the model's device, seeded 0 where none is given): JAX's
fold_in(rng, 2 + step) streams cannot be reproduced, so only runs at
prenet_dropout 0 agree with JAX's frame for frame.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch


def _generator(generator: Optional[torch.Generator], device) -> torch.Generator:
    return generator if generator is not None else torch.Generator(device=device).manual_seed(0)


@torch.no_grad()
def ar_rollout(model, enc: torch.Tensor, enc_mask: torch.Tensor, max_iter: int = 512,
               eos_prob_threshold: float = 0.5, generator: Optional[torch.Generator] = None,
               gcmvn_stats: Optional[Dict] = None):
    """The rollout over a computed context enc [B, S, C] (enc_mask [B, S]):
    (feat [B, max_iter * k, raw_dim], out_lens [B], eos_prob [B, max_iter *
    k]). Shared by the single-pass generator (the source encoder's output)
    and Translatotron2's (the synthesizer's output over first-pass text)."""
    out_dim, k = model.out_dim, model.n_frames_per_step
    b = enc.shape[0]
    generator = _generator(generator, enc.device)
    cache = model.init_cache(enc, enc_mask, max_iter)
    prev = torch.zeros(b, 1, out_dim, dtype=model.dec_norm.weight.dtype, device=enc.device)
    finished = torch.zeros(b, dtype=torch.bool, device=enc.device)
    out_lens = torch.full((b,), max_iter, dtype=torch.int64, device=enc.device)
    feats, eos_probs = [], []
    for step in range(max_iter):
        feat, eos_logit, cache = model.decode_step(prev, cache, step, generator)
        eos_prob = torch.sigmoid(eos_logit.float())
        fired = eos_prob > eos_prob_threshold
        out_lens = torch.where(~finished & fired, step + 1, out_lens)
        finished = finished | fired
        feats.append(feat)
        eos_probs.append(eos_prob)
        prev = feat[:, None]
    feat = model.apply_postnet(torch.stack(feats, dim=1))
    feat = feat.reshape(b, max_iter * k, out_dim // k)
    eos_prob = torch.stack(eos_probs, dim=1).repeat_interleave(k, dim=1)
    if gcmvn_stats is not None:
        mean, std = (torch.as_tensor(np.asarray(gcmvn_stats[key]), dtype=feat.dtype,
                                     device=feat.device) for key in ("mean", "std"))
        feat = feat * std + mean
    return feat, out_lens * k, eos_prob


@torch.no_grad()
def ar_speech_generate(model, src: torch.Tensor, src_lengths: Optional[torch.Tensor] = None,
                       max_iter: int = 512, eos_prob_threshold: float = 0.5,
                       generator: Optional[torch.Generator] = None,
                       gcmvn_stats: Optional[Dict] = None):
    """The model's encode, then `ar_rollout`: (feat [B, max_iter * k,
    raw_dim] postnet-refined and denormalized, out_lens [B], eos_prob [B,
    max_iter * k]). A speech-input encoder (`encode_needs_lengths`, s2spect)
    takes `src_lengths`; the text-input TTS encoder takes the tokens alone,
    its mask coming from the pad id (JAX speech_ar.py:129-137)."""
    if getattr(model, "encode_needs_lengths", False):
        if src_lengths is None:
            raise ValueError("this encoder needs src_lengths")
        enc, enc_mask = model.encode(src, src_lengths)
    else:
        enc, enc_mask = model.encode(src)
    return ar_rollout(model, enc, enc_mask, max_iter=max_iter,
                      eos_prob_threshold=eos_prob_threshold, generator=generator,
                      gcmvn_stats=gcmvn_stats)


def finalize(feat: torch.Tensor, out_lens: torch.Tensor, eos_prob: torch.Tensor,
             vocoder=None) -> List[Dict]:
    """Per sentence {"feature" [n, raw_dim], "eos_prob" [n]} cut at its
    length, and "waveform" where a vocoder (frames [n, raw_dim] -> samples)
    is given."""
    feat = feat.float().cpu().numpy()
    out_lens, eos_prob = out_lens.cpu().numpy(), eos_prob.float().cpu().numpy()
    out = []
    for i in range(feat.shape[0]):
        n = int(out_lens[i])
        entry = {"feature": feat[i, :n], "eos_prob": eos_prob[i, :n]}
        if vocoder is not None:
            entry["waveform"] = vocoder(feat[i, :n])
        out.append(entry)
    return out


class ARSpeechGenerator:
    """fairseq's AutoRegressiveSpeechGenerator: the rollout, each sentence
    cut at its length, and an optional vocoder."""

    def __init__(self, model, vocoder=None, gcmvn_stats: Optional[Dict] = None,
                 max_iter: int = 512, eos_prob_threshold: float = 0.5):
        self.model, self.vocoder, self.gcmvn_stats = model, vocoder, gcmvn_stats
        self.max_iter, self.eos_prob_threshold = max_iter, eos_prob_threshold

    def generate(self, src: torch.Tensor, src_lengths: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> List[Dict]:
        return finalize(*ar_speech_generate(
            self.model, src, src_lengths, max_iter=self.max_iter,
            eos_prob_threshold=self.eos_prob_threshold, generator=generator,
            gcmvn_stats=self.gcmvn_stats), vocoder=self.vocoder)
