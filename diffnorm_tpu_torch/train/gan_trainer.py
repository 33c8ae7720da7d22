"""The code-HiFi-GAN fine-tune's trainer (counterpart of
diffnorm_tpu/train/gan_trainer.py; reference research/TranSpeech/hifigan/
and fairseq/tasks/code_hifigan.py "unit_to_speech").

One update is JAX's d step, then its g step:
  d: the generator's waveform without gradient, the real waveform cut to its
     length, the LSGAN loss of MPD + MSD, one AdamW update of the
     discriminators
  g: against the updated discriminators, the generator runs again: LSGAN
     adversarial loss + fm_weight (2) x feature matching + mel_weight (45) x
     the L1 of the log-mels, and, with a duration predictor and `durations`
     in the batch, + dur_weight x the masked MSE of the predicted log
     durations of `dur_code` against log(d + 1); one AdamW update of the
     generator
Two optimizers, each `train.optimizers.OptaxAdamW` with betas (0.8, 0.99),
the decay schedule on its own count. The generator is float32; with
`bf16_disc` the discriminators compute in bf16 over float32 parameters.
A `FeatureGenerator` (repr_to_speech) takes the batch's `features` where a
`CodeGenerator` takes its `code`, as JAX's trainer reads
`example.get("features", example.get("code"))`, with no duration term.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch

from diffnorm_tpu_torch.models.hifigan import CodeGenerator, FeatureGenerator
from diffnorm_tpu_torch.models.hifigan_disc import (
    MultiPeriodDiscriminator,
    MultiScaleDiscriminator,
    discriminator_loss,
    feature_matching_loss,
    generator_adv_loss,
)
from diffnorm_tpu_torch.ops.mel import mel_spectrogram
from diffnorm_tpu_torch.train.optimizers import OptaxAdamW
from diffnorm_tpu_torch.weights import from_jax_params, to_jax_params

# JAX GanTrainer's cfg.get keys and their defaults
DEFAULTS = dict(lr=2e-4, adam_b1=0.8, adam_b2=0.99, lr_decay=0.999, decay_steps=1000,
                mel_weight=45.0, fm_weight=2.0, dur_weight=1.0, n_fft=1024, hop_size=256,
                win_size=1024, num_mels=80, sampling_rate=16000,
                mpd_periods=(2, 3, 5, 7, 11), msd_scales=3, disc_width=1.0, bf16_disc=False)


class GanTrainer:
    """cfg: a mapping with any of DEFAULTS' keys. The generator's parameters
    and the discriminators' are trained in place; `train_step(batch)` takes
    a collated batch (numpy) and returns JAX's metrics."""

    def __init__(self, generator: Union[CodeGenerator, FeatureGenerator], cfg: Mapping,
                 device: torch.device):
        cfg = {**DEFAULTS, **{k: v for k, v in cfg.items() if v is not None}}
        self.gen, self.device = generator, device
        dtype = torch.bfloat16 if cfg["bf16_disc"] else torch.float32
        with torch.device(device):
            self.mpd = MultiPeriodDiscriminator(cfg["mpd_periods"], cfg["disc_width"], dtype)
            self.msd = MultiScaleDiscriminator(cfg["msd_scales"], cfg["disc_width"], dtype)
        opt = dict(lr=cfg["lr"], betas=(cfg["adam_b1"], cfg["adam_b2"]),
                   decay_steps=cfg["decay_steps"], decay_rate=cfg["lr_decay"])
        self.g_params = list(self.gen.parameters())
        self.d_params = list(self.mpd.parameters()) + list(self.msd.parameters())
        self.g_opt = OptaxAdamW(self.g_params, **opt)
        self.d_opt = OptaxAdamW(self.d_params, **opt)
        self.mel_weight, self.fm_weight = cfg["mel_weight"], cfg["fm_weight"]
        self.dur_weight = cfg["dur_weight"]
        self.mel_kw = dict(n_fft=cfg["n_fft"], hop=cfg["hop_size"], win=cfg["win_size"],
                           num_mels=cfg["num_mels"], sample_rate=cfg["sampling_rate"])
        self.num_updates = 0

    def _tensor(self, batch: Mapping, key: str):
        value = batch.get(key)
        return None if value is None else torch.as_tensor(np.asarray(value), device=self.device)

    def train_step(self, batch: Mapping) -> Dict[str, float]:
        if isinstance(self.gen, FeatureGenerator):
            inputs = self._tensor(batch, "features").float()
        else:
            inputs = self._tensor(batch, "code").long()
        wav = self._tensor(batch, "wav").float()
        durations = self._tensor(batch, "durations")
        dur_code = self._tensor(batch, "dur_code")

        with torch.no_grad():
            fake = self.gen(inputs)
        real = wav[:, :fake.shape[1]]
        loss_d = (discriminator_loss(self.mpd(real, fake))
                  + discriminator_loss(self.msd(real, fake)))
        self.d_opt.step(list(torch.autograd.grad(loss_d, self.d_params)))

        fake = self.gen(inputs)
        mpd_outs, msd_outs = self.mpd(real, fake), self.msd(real, fake)
        adv = generator_adv_loss(mpd_outs) + generator_adv_loss(msd_outs)
        fm = feature_matching_loss(mpd_outs) + feature_matching_loss(msd_outs)
        mel = torch.mean(torch.abs(mel_spectrogram(real, **self.mel_kw)
                                   - mel_spectrogram(fake, **self.mel_kw)))
        loss_g = adv + self.fm_weight * fm + self.mel_weight * mel
        aux = {"adv": adv, "fm": fm, "mel": mel}
        if durations is not None and self.gen.dur_predictor is not None:
            log_dur = self.gen.log_durations((dur_code if dur_code is not None else inputs).long())
            keep = durations != -100
            target = torch.log(torch.clamp(durations, min=0).float() + 1.0)
            sq = torch.square(log_dur - target)
            dur_mse = torch.where(keep, sq, 0.0).sum() / torch.clamp(keep.sum(), min=1)
            loss_g = loss_g + self.dur_weight * dur_mse
            aux["dur_mse"] = dur_mse
        self.g_opt.step(list(torch.autograd.grad(loss_g, self.g_params)))
        self.num_updates += 1

        names = ["loss_d", "loss_g", *aux]
        values = torch.stack([loss_d.detach(), loss_g.detach(),
                              *(v.detach() for v in aux.values())]).tolist()
        return dict(zip(names, values))

    def state_dict(self) -> Dict:
        return {"num_updates": self.num_updates, "g_opt": self.g_opt.state_dict(),
                "d_opt": self.d_opt.state_dict()}

    def load_state_dict(self, state: Mapping) -> None:
        self.num_updates = int(state["num_updates"])
        self.g_opt.load_state_dict(state["g_opt"])
        self.d_opt.load_state_dict(state["d_opt"])

    def variables(self) -> Dict:
        """{"g_params": ..., "d_params": {"mpd": ..., "msd": ...}} in flax
        paths, the tree a step directory's params.npz holds."""
        return {"g_params": to_jax_params(self.gen),
                "d_params": {"mpd": to_jax_params(self.mpd), "msd": to_jax_params(self.msd)}}

    def load_variables(self, tree: Mapping) -> None:
        from_jax_params(self.gen, tree["g_params"])
        from_jax_params(self.mpd, tree["d_params"]["mpd"])
        from_jax_params(self.msd, tree["d_params"]["msd"])
