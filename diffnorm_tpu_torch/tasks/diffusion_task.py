"""The latent normalizer stages (the port's copy of
diffnorm_tpu/tasks/diffusion_task.py): the VAE stage's data and dictionary
with LatentDiffusionModule.

* speech_diffusion_discrete: the `vae` subtree frozen and restored from
  `--speech-decoder-ckpt` (a checkpoint of the port's VAE stage), and
  DDPMDiscreteLoss;
* speech_diffusion (continuous, `diff_latent`): the same composition with
  DDPMLatentLoss;
* speech_diffusion_hubert (`diff_hubert`): the diffusion on the features
  themselves, no VAE, nothing frozen or loaded, DDPMLatentLoss;
* hubert_vae: the VAE stage with HubertVAELoss (no unit term, `--kl-beta`).

The model's widths come from the CLI's arguments after the architecture's
defaults (`models.diffusion.ARCHS`) filled them.
"""

from __future__ import annotations

import logging

from diffnorm_tpu_torch.criterions.ddpm_loss import DDPMDiscreteLoss, DDPMLatentLoss
from diffnorm_tpu_torch.criterions.vae_loss import HubertVAELoss
from diffnorm_tpu_torch.models.diffusion import LatentDiffusionModule
from diffnorm_tpu_torch.tasks.vae_task import SpeechDecoderTask
from diffnorm_tpu_torch.train.checkpoint import load_params
from diffnorm_tpu_torch.weights import from_jax_params

logger = logging.getLogger("diffnorm_tpu_torch.train")


class SpeechDiffusionDiscreteTask(SpeechDecoderTask):
    frozen_param_keys = ("vae",)

    def build_model(self) -> LatentDiffusionModule:
        a = self.args
        return LatentDiffusionModule(
            dim=a.hidden_dim, latent_dim=a.latent_dim, feature_dim=a.feature_dim,
            vocab_size=len(self.tgt_dict), timesteps=a.timesteps,
            denoiser_depth=a.denoiser_depth, wavenet_layers=a.wavenet_layers,
            wavenet_stacks=a.wavenet_stacks, vae_decoder_depth=a.vae_decoder_depth,
            vae_decoder_dim_head=a.vae_decoder_dim_head,
            vae_decoder_heads=a.vae_decoder_heads, chan_mults=a.chan_mults,
            multitask=a.multitask, dropout=a.dropout, use_vae=a.use_vae,
            # training's int8 is the module route, as JAX's (no kernel has a backward)
            quant_int8=bool(getattr(a, "quant_int8", False)), int8_route="module")

    def build_criterion(self) -> DDPMDiscreteLoss:
        return DDPMDiscreteLoss()

    def load_frozen_params(self, model: LatentDiffusionModule) -> None:
        """The VAE stage's parameters (its tree's root is the VAE) into
        `model.vae`."""
        ckpt = self.args.speech_decoder_ckpt
        if ckpt:
            from_jax_params(model.vae, load_params(ckpt))
            logger.info("restored the frozen VAE from %s", ckpt)


class SpeechDiffusionTask(SpeechDiffusionDiscreteTask):
    def build_criterion(self) -> DDPMLatentLoss:
        return DDPMLatentLoss()


class SpeechDiffusionHubertTask(SpeechDiffusionTask):
    frozen_param_keys = ()

    def load_frozen_params(self, model: LatentDiffusionModule) -> None:
        """No VAE: nothing to restore."""


class HubertVAETask(SpeechDecoderTask):
    def build_criterion(self) -> HubertVAELoss:
        return HubertVAELoss(kl_beta=self.args.kl_beta)
