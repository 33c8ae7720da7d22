"""The S2ST serving chain: fbank in, waveform out, on one device.

Counterpart of diffnorm_tpu/generate/s2st.py:
  conformer encode -> mask-predict -> special-token strip + consecutive
  dedup (left-packed) -> duration prediction -> duration expansion
  (cumsum + searchsorted gather) -> code-HiFi-GAN synthesis
with ragged boundaries carried as masks and counts, as in JAX. PyTorch runs
it eagerly; nothing leaves the device between the stages. `tgt_speaker`
conditions the NAR encoder (--target-speaker-embed), `spkr` selects the
multi-speaker vocoder's speaker per row; a stacked-unit model decodes its
packed canvas to the full-rate units (JAX's chain takes k = 1 alone).
`mesh` splits the rows over its data ranks and gathers the outputs in
order (`parallel.mesh.split_rows`), as JAX's chain under a "data" mesh.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from diffnorm_tpu_torch.generate.mask_predict import mask_predict_decode
from diffnorm_tpu_torch.ops.unit_reduce import reduce_units_padded
from diffnorm_tpu_torch.parallel.mesh import split_rows

UNIT_OFFSET = 4  # dictionary specials bos/pad/eos/unk = 0..3


def expand_units_padded(units: torch.Tensor, durations: torch.Tensor,
                        max_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """repeat_interleave on fixed shapes: units [B, T], durations [B, T] (0
    on invalid positions) -> (expanded [B, max_out], mask [B, max_out]).
    What goes past max_out is cut."""
    ends = durations.long().cumsum(dim=-1)
    pos = torch.arange(max_out, device=units.device).expand(units.shape[0], max_out)
    seg = torch.searchsorted(ends, pos.contiguous(), right=True)
    out = torch.gather(units, 1, seg.clamp(max=units.shape[1] - 1))
    mask = pos < ends[:, -1:]
    return torch.where(mask, out, 0), mask


def strip_and_reduce_tokens(tokens: torch.Tensor):
    """Dictionary tokens [B, T] -> (packed units [B, T], packed_valid
    [B, T], reduced units [B, T], counts [B]), 0-based unit ids. Specials are
    stripped first, then runs are reduced (generate_waveform_from_code.py
    order), so a special between two equal units does not break their run."""
    valid = tokens >= UNIT_OFFSET
    units_raw = torch.where(valid, tokens - UNIT_OFFSET, 0)
    t = tokens.shape[1]
    pos = valid.long().cumsum(dim=1) - 1
    idx = torch.where(valid, pos, t)
    packed = torch.zeros(tokens.shape[0], t + 1, dtype=tokens.dtype, device=tokens.device)
    packed.scatter_(1, idx, units_raw)  # specials land in a spill column
    packed = packed[:, :t]
    n_valid = valid.sum(dim=1)
    packed_valid = torch.arange(t, device=tokens.device)[None, :] < n_valid[:, None]
    reduced, _keep, counts = reduce_units_padded(packed, packed_valid)
    return packed, packed_valid, reduced, counts


@torch.no_grad()
def s2st_generate(nar_model, vocoder, src: torch.Tensor, src_lengths: torch.Tensor, *,
                  max_iter: int = 15, max_len: int = 256, cond_scale: float = 1.0,
                  length_beam: int = 1, dur_prediction: bool = True, max_duration: int = 8,
                  max_wav_units: Optional[int] = None, vocoder_chunk: int = 4,
                  return_steps: bool = False, spkr: Optional[torch.Tensor] = None,
                  tgt_speaker: Optional[torch.Tensor] = None, mesh=None):
    """nar_model: `models.nar_transformer.NARS2UTModule`, or a list of them
    (an ensemble, `mask_predict_decode`'s); vocoder:
    `models.hifigan.CodeGenerator`. Returns (wav [B, max_wav_units *
    upsample], wav_lengths [B] in samples, reduced units [B, T] (0-based, 0
    past the count), unit counts [B]) and, with `return_steps`, the per-row
    mask-predict iteration counts [B]. With dur_prediction=False the decoded
    unit stream drives the vocoder unreduced and unexpanded. tgt_speaker
    [B, D] conditions the decode, spkr [B] the vocoder."""
    if mesh is not None and mesh.active:
        opts = dict(max_iter=max_iter, max_len=max_len, cond_scale=cond_scale,
                    length_beam=length_beam, dur_prediction=dur_prediction,
                    max_duration=max_duration, max_wav_units=max_wav_units,
                    vocoder_chunk=vocoder_chunk, return_steps=return_steps)
        return split_rows(
            mesh, lambda **rows: s2st_generate(nar_model, vocoder, **rows, **opts),
            {"src": src, "src_lengths": src_lengths, "spkr": spkr, "tgt_speaker": tgt_speaker})
    tokens, _scores, n_steps = mask_predict_decode(
        nar_model, src, src_lengths, max_iter=max_iter, max_len=max_len,
        cond_scale=cond_scale, length_beam=length_beam, tgt_speaker=tgt_speaker)
    packed, packed_valid, reduced, counts = strip_and_reduce_tokens(tokens)
    t = reduced.shape[1]
    reduced_valid = torch.arange(t, device=tokens.device)[None, :] < counts[:, None]
    reduced = torch.where(reduced_valid, reduced, 0)

    if dur_prediction:
        durs = torch.clamp(vocoder.predict_durations(reduced), 1, max_duration)
        code = reduced
    else:
        durs = torch.ones_like(reduced)
        code, reduced_valid = packed, packed_valid
    durs = torch.where(reduced_valid, durs, 0)

    if max_wav_units is None:
        max_wav_units = code.shape[1] * (max_duration if dur_prediction else 1)
    expanded, wav_unit_mask = expand_units_padded(code, durs, max_wav_units)
    wav = _chunked_vocoder(vocoder, expanded, vocoder_chunk, spkr)
    upsample = wav.shape[-1] // max_wav_units
    wav_lengths = wav_unit_mask.sum(dim=-1) * upsample
    if return_steps:
        return wav, wav_lengths, reduced, counts, n_steps
    return wav, wav_lengths, reduced, counts


def _chunked_vocoder(vocoder, codes: torch.Tensor, chunk: int,
                     spkr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The vocoder over sub-batches of `chunk` rows (JAX's lax.map over
    4-row chunks, which kept the TPU's activations resident; here it bounds
    the waveform-rate activations' memory), `spkr` [B] sliced with the
    codes (JAX pads both to whole chunks). chunk=0 runs one batch."""
    b = codes.shape[0]
    if chunk <= 0 or b <= chunk:
        return vocoder(codes, spkr)
    return torch.cat([vocoder(codes[i:i + chunk], None if spkr is None else spkr[i:i + chunk])
                      for i in range(0, b, chunk)])
