"""The spectrogram decoders' criterions (the port of
diffnorm_tpu/criterions/tts_loss.py:21-180; reference
fairseq/criterions/tacotron2_loss.py, fastspeech2_loss.py and
speech_to_speech_criterion.py:333, :434-520).

* "tacotron2_loss" (also "tacotron2" and "speech_to_spectrogram", the
  single-pass s2spect's): the teacher-forced forward on prev_feats and
  tgt_mask, then `models.tts_transformer.tts_loss` with `bce_pos_weight`
  (default 5.0); sample_size = ntokens, the batch's valid target frames.
  The loss is a mean and the trainer averages it over micro-batches
  (`grad_accum` "mean_loss", as JAX's). The prenet drops out in validation
  too, drawing from the generator the trainer passes.
* "speech_to_spectrogram_2pass" (Translatotron2): the forward also gets
  the first-pass task's prev_output_tokens and, turning the aux heads on,
  tgt_tokens; every multitask term, the first pass's included, is added to
  the mean mel loss with denominator 1, the reference's mix of a mean and
  sums, kept as JAX keeps it.
* "fastspeech2_loss" (also "fastspeech2"; JAX tts_loss.py:126-180,
  reference fastspeech2_loss.py): the FastSpeech2 forward on the gold
  durations, pitches and energies; masked L1 on `mel` and `mel_post`, cut
  to the batch's longest target and over the valid target frames (a mean
  over frames x bins), plus MSE on log(1 + duration), pitch and energy over
  the valid source tokens (`src_tokens != PAD`). sample_size =
  nsentences; the loss is a mean ("mean_loss").
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from diffnorm_tpu_torch.criterions.nar_loss import _multitask_prev, apply_multitask_losses
from diffnorm_tpu_torch.models.tts_transformer import tts_loss
from diffnorm_tpu_torch.parallel.mesh import global_sum

PAD = 1


class Tacotron2Loss:
    grad_accum = "mean_loss"
    data_parallel = True  # tts_loss divides by the global frames under a split

    def __init__(self, bce_pos_weight: float = 5.0):
        self.bce_pos_weight = bce_pos_weight

    def model_kwargs(self, batch: Dict) -> Dict:
        """The forward's extra arguments (none here)."""
        return {}

    def finalize(self, out: Dict, batch: Dict, loss: torch.Tensor, metrics: Dict) -> torch.Tensor:
        """The loss after the mel terms (as it is here)."""
        return loss

    def __call__(self, model, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: src_tokens [B, T, F], src_lengths [B], prev_feats and
        feat_tgt [B, L, D], tgt_mask [B, L], tgt_lengths [B]. Returns (loss,
        metrics)."""
        out = model(batch["src_tokens"], batch["src_lengths"], batch["prev_feats"],
                    batch["tgt_mask"], generator=generator, **self.model_kwargs(batch))
        loss, metrics = tts_loss(out, batch["feat_tgt"], batch["tgt_lengths"],
                                 bce_pos_weight=self.bce_pos_weight)
        ntokens = batch["tgt_lengths"].sum()
        metrics.update(ntokens=ntokens, nsentences=batch["src_tokens"].shape[0],
                       sample_size=ntokens)
        loss = self.finalize(out, batch, loss, metrics)
        metrics["loss"] = loss
        return loss, metrics


class SpeechToSpectrogram2PassLoss(Tacotron2Loss):
    data_parallel = False  # the first pass's multitask terms keep local means
    def __init__(self, bce_pos_weight: float = 5.0, multitask: Optional[Dict] = None,
                 mt_task_name: Optional[str] = None):
        """multitask: {task: SingleTaskConfig}, the first pass's among them
        under `mt_task_name`."""
        if not mt_task_name:
            raise ValueError("speech_to_spectrogram_2pass needs a first-pass decoder multitask "
                             "(is_first_pass_decoder in --multitask-config-yaml)")
        super().__init__(bce_pos_weight)
        self.multitask, self.mt_task_name = dict(multitask or {}), mt_task_name

    def model_kwargs(self, batch: Dict) -> Dict:
        return {"prev_tokens_mt": batch["multitask"][self.mt_task_name]["prev_output_tokens"],
                "tgt_tokens": batch["feat_tgt"],
                "multitask_prev": _multitask_prev(batch, self.multitask)}

    def finalize(self, out, batch, loss, metrics):
        return apply_multitask_losses(self.multitask, out, batch, loss, metrics, 1.0)


class FastSpeech2Loss:
    grad_accum = "mean_loss"
    data_parallel = True  # its means divide by the global counts under a split

    def __call__(self, model, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: src_tokens [B, S], durations [B, S], pitches and energies
        [B, S], feat_tgt [B, T, D], tgt_lengths [B]. Returns (loss,
        metrics); `generator` is not read (the model's dropouts draw from
        the trainer's stream)."""
        durations = batch["durations"]
        pitches, energies = batch["pitches"].float(), batch["energies"].float()
        out = model(batch["src_tokens"], durations=durations, pitches=pitches,
                    energies=energies)
        feat_tgt = batch["feat_tgt"].float()
        b, t, d = feat_tgt.shape
        tgt_mask = (torch.arange(t, device=feat_tgt.device)[None, :]
                    < batch["tgt_lengths"][:, None])
        denom = torch.clamp(global_sum(tgt_mask.sum()), min=1) * d

        def masked_l1(pred):
            diff = (pred[:, :t].float() - feat_tgt).abs()
            return torch.where(tgt_mask[..., None], diff, 0.0).sum() / denom

        l1 = masked_l1(out["mel"]) + masked_l1(out["mel_post"])
        src_valid = batch["src_tokens"] != PAD
        n_src = torch.clamp(global_sum(src_valid.sum()), min=1)

        def masked_mse(pred, tgt):
            return torch.where(src_valid, (pred.float() - tgt).square(), 0.0).sum() / n_src

        dur_loss = masked_mse(out["log_dur"], torch.log1p(durations.float()))
        pitch_loss = masked_mse(out["pitch"], pitches)
        energy_loss = masked_mse(out["energy"], energies)
        loss = l1 + dur_loss + pitch_loss + energy_loss
        return loss, {"loss": loss, "l1_loss": l1, "dur_loss": dur_loss,
                      "pitch_loss": pitch_loss, "energy_loss": energy_loss,
                      "ntokens": batch["tgt_lengths"].sum(), "nsentences": b,
                      "sample_size": b}


CRITERIONS = {"tacotron2_loss": Tacotron2Loss, "tacotron2": Tacotron2Loss,
              "speech_to_spectrogram": Tacotron2Loss,
              "speech_to_spectrogram_2pass": SpeechToSpectrogram2PassLoss,
              "fastspeech2_loss": FastSpeech2Loss, "fastspeech2": FastSpeech2Loss}
