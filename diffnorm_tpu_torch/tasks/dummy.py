"""The dummy tasks of the main path, which train without data on disk (the
port of diffnorm_tpu/tasks/dummy.py and of JAX's dummy_ar,
tasks/ar_s2ut_task.py:126-135; reference fairseq/benchmark/dummy_mt.py):
each split is `dataset_size` synthetic batches of `dummy_batch(batch_size,
tokens_per_sample)`, with JAX's defaults:

* dummy_vae: the VAE stage (4 sequences of 32 frames, 8 batches);
* dummy_nar: NAR S2UT (4 x 96 source frames, 8 batches);
* dummy_ar: AR S2UT (4 x 96, 8 batches).

JAX's `_SyntheticDataset` makes each batch anew from `dummy_batch`, whose
generator is seeded 0, so every batch is the first: the port's
`cmlm_cg_task.dummy_dataset` holds that batch `dataset_size` times, as
every other dummy task of the port does. `cli.train` runs them with no
batch iterator (a dataset without a collater), as JAX's does. JAX's
`dummy_mt` is the `dummy_translation` task (tasks/aliases.py:42).
"""

from __future__ import annotations

from diffnorm_tpu_torch.tasks.ar_s2ut_task import ARS2UTTask
from diffnorm_tpu_torch.tasks.cmlm_cg_task import dummy_dataset
from diffnorm_tpu_torch.tasks.nar_s2ut_task import NARS2UTTask
from diffnorm_tpu_torch.tasks.vae_task import SpeechDecoderTask


class DummyVAETask(SpeechDecoderTask):
    synthetic = True

    def load_dataset(self, split: str, epoch: int = 1) -> None:
        self.datasets[split] = dummy_dataset(self, 32)


class DummyNARTask(NARS2UTTask):
    synthetic = True

    def load_dataset(self, split: str, epoch: int = 1) -> None:
        self.datasets[split] = dummy_dataset(self, 96)


class DummyARTask(ARS2UTTask):
    synthetic = True

    def load_dataset(self, split: str, epoch: int = 1) -> None:
        self.datasets[split] = dummy_dataset(self, 96)
