"""Training tasks of the PyTorch port (see diffnorm_tpu/tasks): the speech
VAE stage and the HuBERT VAE, the latent normalizer over a frozen VAE and
its continuous variants, and NAR and AR S2UT training."""

from diffnorm_tpu_torch.tasks.ar_s2ut_task import ARS2UTTask
from diffnorm_tpu_torch.tasks.diffusion_task import (
    HubertVAETask,
    SpeechDiffusionDiscreteTask,
    SpeechDiffusionHubertTask,
    SpeechDiffusionTask,
)
from diffnorm_tpu_torch.tasks.nar_s2ut_task import NARS2UTTask
from diffnorm_tpu_torch.tasks.vae_task import SpeechDecoderTask

TASKS = {"speech_decoder": SpeechDecoderTask,
         "speech_diffusion_discrete": SpeechDiffusionDiscreteTask,
         "speech_diffusion": SpeechDiffusionTask,
         "speech_diffusion_hubert": SpeechDiffusionHubertTask,
         "hubert_vae": HubertVAETask,
         "speech_to_speech_fasttranslate": NARS2UTTask,
         "speech_to_speech_ar": ARS2UTTask}
