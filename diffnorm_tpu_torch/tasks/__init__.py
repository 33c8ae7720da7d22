"""Training tasks of the PyTorch port (see diffnorm_tpu/tasks): the speech
VAE stage and the HuBERT VAE, the latent normalizer over a frozen VAE and
its continuous variants, NAR and AR S2UT training (UnitY among the latter),
speech-to-spectrogram training (s2spect, Translatotron2), text-to-speech
(tts_transformer, FastSpeech2), speech-to-text (the S2T model) and text
machine translation (the AR transformer, the text CMLM, the Levenshtein
transformer), SEDD and the unit LM (`sedd`, `sedd_lm`, `unit_lm` and its
alias `language_modeling`), and wav2vec2 and HuBERT pretraining and the CTC
fine-tune (`audio_pretraining`, `hubert_pretraining`, `audio_finetuning`).
Each family has its dummy task, which trains on synthetic batches without
data on disk, through cli.train as in process: `dummy_vae`, `dummy_nar`,
`dummy_ar` (`tasks/dummy.py`), `dummy_s2spect`, `dummy_tts`, `dummy_s2t`,
`dummy_translation` (and JAX's name for it, `dummy_mt`), `dummy_cmlm_cg`,
`dummy_lev`, `dummy_sedd`, `dummy_unit_lm` (and `dummy_lm`),
`dummy_hubert`, `dummy_wav2vec2` and `dummy_ctc`. fairseq's
"speech_to_speech" is not a task here: cli.train's `check_args` sends it to
the AR S2UT task with --target-is-code and otherwise to the spectrogram
task (JAX tasks/aliases.py:25-40). `registry.register_task` adds a task of
a --user-dir plugin to TASKS."""

from diffnorm_tpu_torch.tasks.ar_s2ut_task import ARS2UTTask
from diffnorm_tpu_torch.tasks.audio_pretrain_task import AudioPretrainingTask, DummyWav2Vec2Task
from diffnorm_tpu_torch.tasks.cmlm_cg_task import CMLMCGTask, DummyCMLMCGTask
from diffnorm_tpu_torch.tasks.diffusion_task import (
    HubertVAETask,
    SpeechDiffusionDiscreteTask,
    SpeechDiffusionHubertTask,
    SpeechDiffusionTask,
)
from diffnorm_tpu_torch.tasks.dummy import DummyARTask, DummyNARTask, DummyVAETask
from diffnorm_tpu_torch.tasks.hubert_pretrain_task import DummyHubertTask, HubertPretrainingTask
from diffnorm_tpu_torch.tasks.levenshtein_task import DummyLevenshteinTask, LevenshteinTask
from diffnorm_tpu_torch.tasks.nar_s2ut_task import NARS2UTTask
from diffnorm_tpu_torch.tasks.s2spect_task import DummyS2SpectTask, S2SpectTask
from diffnorm_tpu_torch.tasks.s2t_task import (
    AudioFinetuningTask,
    DummyCTCTask,
    DummyS2TTask,
    S2TTask,
)
from diffnorm_tpu_torch.tasks.sedd_task import DummySEDDTask, SEDDTask
from diffnorm_tpu_torch.tasks.translation_task import DummyTranslationTask, TranslationTask
from diffnorm_tpu_torch.tasks.tts_task import DummyTTSTask, TextToSpeechTask
from diffnorm_tpu_torch.tasks.vae_task import SpeechDecoderTask

TASKS = {"speech_decoder": SpeechDecoderTask,
         "dummy_vae": DummyVAETask,
         "speech_diffusion_discrete": SpeechDiffusionDiscreteTask,
         "speech_diffusion": SpeechDiffusionTask,
         "speech_diffusion_hubert": SpeechDiffusionHubertTask,
         "hubert_vae": HubertVAETask,
         "speech_to_speech_fasttranslate": NARS2UTTask,
         "dummy_nar": DummyNARTask,
         "speech_to_speech_ar": ARS2UTTask,
         "dummy_ar": DummyARTask,
         "speech_to_speech_spect": S2SpectTask,
         "dummy_s2spect": DummyS2SpectTask,
         "text_to_speech": TextToSpeechTask,
         "dummy_tts": DummyTTSTask,
         "speech_to_text": S2TTask,
         "dummy_s2t": DummyS2TTask,
         "translation": TranslationTask,
         "dummy_translation": DummyTranslationTask,
         "dummy_mt": DummyTranslationTask,
         "cmlm_cg": CMLMCGTask,
         "dummy_cmlm_cg": DummyCMLMCGTask,
         "translation_lev": LevenshteinTask,
         "dummy_lev": DummyLevenshteinTask,
         "sedd": SEDDTask,
         "sedd_lm": SEDDTask,
         "dummy_sedd": DummySEDDTask,
         "unit_lm": SEDDTask,
         "language_modeling": SEDDTask,
         "dummy_unit_lm": DummySEDDTask,
         "dummy_lm": DummySEDDTask,
         "hubert_pretraining": HubertPretrainingTask,
         "dummy_hubert": DummyHubertTask,
         "audio_pretraining": AudioPretrainingTask,
         "dummy_wav2vec2": DummyWav2Vec2Task,
         "audio_finetuning": AudioFinetuningTask,
         "dummy_ctc": DummyCTCTask}
