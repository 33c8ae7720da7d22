"""Training tasks of the PyTorch port (see diffnorm_tpu/tasks): the speech
VAE stage and the latent normalizer over a frozen VAE."""

from diffnorm_tpu_torch.tasks.diffusion_task import SpeechDiffusionDiscreteTask
from diffnorm_tpu_torch.tasks.vae_task import SpeechDecoderTask

TASKS = {"speech_decoder": SpeechDecoderTask,
         "speech_diffusion_discrete": SpeechDiffusionDiscreteTask}
