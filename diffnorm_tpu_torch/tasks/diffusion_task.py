"""The latent normalizer stage ("speech_diffusion_discrete", the port's copy
of diffnorm_tpu/tasks/diffusion_task.py:21-53): the VAE stage's data and
dictionary, LatentDiffusionModule with its `vae` subtree frozen and restored
from `--speech-decoder-ckpt` (a checkpoint of the port's VAE stage), and
DDPMDiscreteLoss."""

from __future__ import annotations

import logging

from diffnorm_tpu_torch.criterions.ddpm_loss import DDPMDiscreteLoss
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
            multitask=a.multitask, dropout=a.dropout)

    def build_criterion(self) -> DDPMDiscreteLoss:
        return DDPMDiscreteLoss()

    def load_frozen_params(self, model: LatentDiffusionModule) -> None:
        """The VAE stage's parameters (its tree's root is the VAE) into
        `model.vae`."""
        ckpt = self.args.speech_decoder_ckpt
        if ckpt:
            from_jax_params(model.vae, load_params(ckpt))
            logger.info("restored the frozen VAE from %s", ckpt)
