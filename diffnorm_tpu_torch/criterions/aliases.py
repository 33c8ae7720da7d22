"""fairseq's criterion names where the port implements the criterion under
another (the port of diffnorm_tpu/criterions/aliases.py), so that
--criterion flags of fairseq's recipes resolve unchanged. Each is built
from the CLI's arguments and the task, `CRITERIONS[name](args, task)`:

* `cross_entropy` (fairseq/criterions/cross_entropy.py): the AR models'
  label-smoothed CE at eps 0 unless --label-smoothing is given (AR S2UT,
  S2T, text MT);
* `nat_loss` (fairseq/criterions/nat_loss.py): `levenshtein_loss.nat_loss`,
  which dispatches on the arch, with the task's aux heads;
* `ddpm_loss` (fairseq/criterions/ddpm_loss.py): the continuous
  normalizers' latent noise MSE (`ddpm_latent_loss`);
* `speech_decoder_loss` (fairseq/criterions/speech_decoder_loss.py): the
  discrete normalizer's loss (`ddpm_discrete_loss`) with the label
  smoothing at 0.2;
* `unit_to_speech` / `repr_to_speech` (hubert_to_speech.py:57,
  repr_to_speech_loss.py:56): the code-HiFi-GAN fine-tune's generator-side
  terms, 45 x the log-mel L1 plus the duration predictor's MSE (durations
  of -100 masked), which fairseq logs to keep its best checkpoint. The
  adversarial terms need the discriminators: cli.train hands those tasks
  to cli.train_vocoder.

`tacotron2`, `fastspeech2` and `speech_to_spectrogram` are names of
`tts_loss.CRITERIONS` already. `registry.register_criterion` adds a
--user-dir plugin's criterion to CRITERIONS.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from diffnorm_tpu_torch.criterions.ce_loss import LabelSmoothedCrossEntropy
from diffnorm_tpu_torch.criterions.ddpm_loss import DDPMDiscreteLoss, DDPMLatentLoss
from diffnorm_tpu_torch.criterions.levenshtein_loss import nat_loss
from diffnorm_tpu_torch.ops.mel import mel_spectrogram


def _arg(args, name: str, default=None):
    """An argument of an argparse namespace or a dict, `default` where it
    is absent or None."""
    value = args.get(name) if isinstance(args, dict) else getattr(args, name, None)
    return default if value is None else value


class CrossEntropy(LabelSmoothedCrossEntropy):
    def __init__(self, args=None, task=None):
        super().__init__(_arg(args, "label_smoothing", 0.0))


class DDPMLoss(DDPMLatentLoss):
    def __init__(self, args=None, task=None):
        pass


class SpeechDecoderLoss(DDPMDiscreteLoss):
    eps = 0.2  # speech_decoder_loss.py:18

    def __init__(self, args=None, task=None):
        pass


class UnitToSpeechCriterion:
    """model: a CodeGenerator (or FeatureGenerator); batch: the vocoder
    dataset's collation, {code | features} [B, T], wav [B, S], and
    durations [B, T] with a `dur_code` where given. Returns (loss,
    metrics)."""

    mel_weight = 45.0

    def __init__(self, args=None, task=None):
        self.mel_kw = dict(n_fft=_arg(args, "n_fft", 1024), hop=_arg(args, "hop_size", 256),
                           win=_arg(args, "win_size", 1024), num_mels=_arg(args, "num_mels", 80),
                           sample_rate=_arg(args, "sampling_rate", 16000))

    def __call__(self, model, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        code = batch["features"] if "features" in batch else batch["code"]
        fake = model(code)
        # a predicted expansion or a short last segment can make the
        # generated waveform longer: the mel frames align on the shorter
        n = min(fake.shape[1], batch["wav"].shape[1])
        real, fake = batch["wav"][:, :n].float(), fake[:, :n].float()
        mel = (mel_spectrogram(real, **self.mel_kw)
               - mel_spectrogram(fake, **self.mel_kw)).abs().mean()
        loss = self.mel_weight * mel
        metrics = {"mel": mel, "nsentences": real.shape[0], "sample_size": real.shape[0]}
        durations = batch.get("durations")
        if durations is not None and getattr(model, "dur_predictor", None) is not None:
            log_dur = model.log_durations(batch.get("dur_code", code)).float()
            keep = durations != -100  # the reference's duration mask
            target = torch.log(durations.clamp(min=0).float() + 1.0)
            sq = torch.where(keep, (log_dur - target).square(), 0.0)
            dur_mse = sq.sum() / keep.sum().clamp(min=1)
            loss = loss + dur_mse
            metrics["dur_mse"] = dur_mse
        metrics["loss"] = loss
        return loss, metrics


CRITERIONS = {"cross_entropy": CrossEntropy,
              "nat_loss": lambda args=None, task=None: nat_loss(
                  str(_arg(args, "arch", "")), _arg(args, "label_smoothing"),
                  multitask=getattr(task, "multitask_tasks", None)),
              "ddpm_loss": DDPMLoss,
              "speech_decoder_loss": SpeechDecoderLoss,
              "unit_to_speech": UnitToSpeechCriterion, "repr_to_speech": UnitToSpeechCriterion}
