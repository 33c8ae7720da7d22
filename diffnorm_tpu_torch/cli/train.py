"""Training CLI of the PyTorch port (port of diffnorm_tpu/cli/train.py):
the speech VAE (`--task speech_decoder`, or `hubert_vae`), the latent
normalizer over the frozen VAE (`--task speech_diffusion_discrete`, or the
continuous `speech_diffusion` / `speech_diffusion_hubert`) and the NAR S2UT
translator on unit targets (`--task speech_to_speech_fasttranslate`,
DiffNorm's fourth stage), and the AR S2UT translator, the paper's baseline
(`--task speech_to_speech_ar`, `--arch s2ut_conformer`, `s2ut_transformer`
or `s2ut_transformer_fisher`, `--criterion label_smoothed_cross_entropy` or
`speech_to_unit` with the aux tasks' terms; the NAR model's options apply
but the ones JAX's AR model lacks, and a width left unset takes the arch's
default), UnitY among them (`--arch unity_conformer`, the legacy
`s2ut_conformer_translatotron2`; `--criterion speech_to_unit_2pass`, its only
one; the first pass is the --multitask-config-yaml task flagged
is_first_pass_decoder, `--translation-decoder-layers`,
`--synthesizer-encoder-layers`); the speech-to-spectrogram translators
(`--task speech_to_speech_spect`, `--arch s2spect_transformer`,
`s2spect_transformer_fisher`, `s2spect_conformer` with `--criterion
speech_to_spectrogram` / `tacotron2_loss`, or Translatotron2's
`s2spect2_conformer` with `speech_to_spectrogram_2pass`; mel targets, the
prenet and postnet flags, `--bce-pos-weight`); fairseq's `--task
speech_to_speech` is the AR task with --target-is-code and the spectrogram
task without it; text-to-speech (`--task text_to_speech`, `--arch
tts_transformer` or `tts_transformer_base` with `--criterion
tacotron2_loss` / `tacotron2`, `fastspeech2` or `fastspeech2_base` with
`fastspeech2_loss` / `fastspeech2`; `tasks/tts_task.py`'s manifests, the
encoder's `--encoder-transformer-layers`, `--encoder-conv-layers`,
`--encoder-conv-kernel-size`, `--encoder-dropout` and the prenet and
postnet flags; FastSpeech2's frame buffer is --max-target-positions,
default 2048); speech-to-text (`--task speech_to_text`, `--arch
s2t_transformer`, `s2t_transformer_s`, `s2t_transformer_xs` or
`s2t_conformer`, `--criterion label_smoothed_cross_entropy`,
`--share-decoder-input-output-embed`); text machine translation on a
bitext (`tasks/cmlm_cg_task.py`: `{split}.{src}` / `{split}.{tgt}` line
files, or cli.preprocess's binarized pairs with its dict.{lang}.txt;
`--source-lang`, `--target-lang`, `--src-dict`, `--tgt-dict-path`,
`--src-vocab-size`): the AR transformer (`--task translation`, `--arch
transformer`, `transformer_iwslt_de_en` or `transformer_wmt_en_de_big`,
`--criterion label_smoothed_cross_entropy`; the decoder's output tied to
its embedding unless `--share-decoder-input-output-embed false`;
`--share-all-embeddings` is refused, as JAX refuses it), the text CMLM
(`--task cmlm_cg`, `--arch cmlm_transformer`, `--criterion
nar_speech_to_unit` or `nat_loss`, `--cg-prob`, `--use-side`) and the
Levenshtein transformer (`--task translation_lev`, `--arch
levenshtein_transformer`, `--criterion nat_loss` or `levenshtein_loss`);
discrete diffusion and language modeling over the unit sequences of the
translation manifests' targets (`tasks/sedd_task.py`): SEDD (`--task sedd`
or `sedd_lm`, `--arch sedd_absorb` or `sedd`, `--criterion sedd_loss`,
`--sedd-dim`, `--sedd-depth`, `--sedd-heads`) and the unit LM (`--task
unit_lm` or `language_modeling`, or sedd / sedd_lm with its arch; `--arch
transformer_lm` or `unit_lm`, `--criterion lm_cross_entropy`, the
`--decoder-*` widths), re-cut into
`--tokens-per-sample` blocks under `--sample-break-mode` where either is
given, each sequence cut to `--max-target-positions`;
wav2vec2 and HuBERT pretraining and the CTC fine-tune (`tasks/
{audio_pretrain,hubert_pretrain,s2t}_task.py`): `--task audio_pretraining`
(`--arch wav2vec2`, `wav2vec2_base` or `wav2vec2_large`, `--criterion
wav2vec`; `--num-negatives`, `--latent-temp`, `--loss-weights`) and
`hubert_pretraining` (`hubert`, `hubert_base` or `hubert_large`, `--criterion
hubert`; `--labels`, `--label-dir`, `--label-rate`) on a wav2vec manifest
cropped to `--max-sample-size`, with the span-mask flags (`--mask-prob`,
`--mask-length`, `--mask-selection`, ...), and `audio_finetuning`
(`hubert_ctc` or `wav2vec_ctc`, `--criterion ctc`) on S2T manifests with the
data config's use_audio_input, `--apply-mask` and the channel-mask flags,
`--w2v-path` (a pretraining .pt or step directory, dropped when the run
resumes its own checkpoint) and `--freeze-finetune-updates`; the encoder's
`--conv-feature-layers`, `--extractor-mode`, `--feature-grad-mult`,
`--dropout-input`, `--encoder-layerdrop` and the rest under JAX's names.
`--task unit_to_speech` goes to `cli.train_vocoder` with the
other arguments, as JAX's does, and `--task repr_to_speech` too with
`--input-type features`. It takes every flag of scripts/vae_train.sh,
scripts/diffusion_train.sh and scripts/s2ut_train.sh with the same meaning;
a flag it does not implement is an error. `--quant-int8` trains the
normalizer's and the NAR model's matmuls as int8 W8A8 on the int8 module
path, the gradient reaching inputs and weights through their scales alone,
as JAX's does (the VAE ignores it, as JAX's builder does). --encoder-remat recomputes
each conformer layer in the backward (less activation memory on long
sources, the same update). The NAR model's options:
--n-frames-per-step k (stacked units), --multitask-config-yaml Y (aux
heads, Y relative to DATA; each task's loss weight follows the update
count as JAX's does, which prepares each batch two updates ahead of its
step), --multitask-ctc-vocab N (the CTC head over the encoder, scored
against a batch's ctc_target) and
--target-speaker-embed with --speaker-embed-dim D (the speaker embeddings
named by the data config's target_speaker_embed directory).

  python -m diffnorm_tpu_torch.cli.train $DATA --tgt-feat-dir $FEAT \\
      --task speech_decoder --target-code-size 1000 \\
      --criterion speech_vae_decoder_loss --arch speech_vae_decoder \\
      --latent-dim 128 --dropout 0.1 --save-dir ckpt/vae \\
      --lr 5e-4 --lr-scheduler inverse_sqrt --warmup-init-lr 1e-7 \\
      --warmup-updates 10000 --adam-betas "(0.9,0.98)" --clip-norm 2.0 \\
      --max-update 200000 --max-tokens 15000 --max-target-positions 2048 \\
      --seed 42 --log-interval 50 --dtype bfloat16

  python -m diffnorm_tpu_torch.cli.train $S2UT_DATA --config-yaml config.yaml \\
      --task speech_to_speech_fasttranslate --target-code-size 1000 \\
      --criterion nar_speech_to_unit --label-smoothing 0.2 \\
      --arch nar_s2ut_conformer --dropout 0.1 --save-dir ckpt/nar \\
      --lr 5e-4 --lr-scheduler inverse_sqrt --warmup-init-lr 1e-7 \\
      --warmup-updates 10000 --adam-betas "(0.9,0.98)" --clip-norm 10.0 \\
      --max-update 400000 --max-tokens 40000 --max-target-positions 1024 \\
      --seed 42 --dtype bfloat16

The NAR task reads `{split}.tsv` manifests whose sources are `.npy` fbank
dumps or 16 kHz audio files (the fbank front end) and whose targets are unit
strings; each batch's CMLM canvas is drawn from one
`np.random.default_rng(seed)`, each training micro-batch in order, then each
validation batch.

Batches: --max-tokens and --batch-size (sentences) bound them, in
multiples of --required-batch-size-multiple; --curriculum N keeps them in
order for the first N epochs; --num-workers N loads them on N host threads
(one background thread by default), in order, so batch lists and resume
offsets do not depend on it. The upload of the next two batches to the
card runs while the current update does; each update marks its batches
trained, so a checkpoint taken mid-epoch (--save-interval-updates) resumes
at the first batch not trained. `DATA` may be `dir1:dir2:...`: epoch e
trains on shard (e - 1) % n, validation reads the first (JAX
tasks/base.py:48-80); a resumed mid-epoch position carries into its shard.

Runs on the GPU unless --cpu is given. Logs `epoch E | step N | ...` lines,
`valid | ...`, `saved checkpoint at step N`; a re-run with a higher
--max-update continues from the last checkpoint (`resumed from step N`).

`--restore-file PATH` (fairseq's, as JAX's cli/train.py:180-225) starts a
run whose --save-dir holds no checkpoint of its own from another one; a run
that resumes from its own directory ignores it. With `--reset-optimizer`
only the model weights are taken, from a step directory or a .npz (a
`cli.convert_checkpoint` or `scripts/orbax_to_npz.py` output included), and
the optimizer starts at step 0; a frozen subtree (the normalizer's `vae`) is
the file's where the file has it, else --speech-decoder-ckpt's. Without it
PATH is a step directory of this CLI and the whole trainer state carries
over: weights, the optimizer's state, update count, generators and EMA, and
from the sidecar `PATH.json` the epoch and iterator position, unless
`--reset-dataloader`, and a host-driven schedule's state, unless
`--reset-lr-scheduler`. A step directory that `scripts/orbax_to_npz.py`
bridged from a JAX TrainState holds `optax_state.npz` in place of
trainer.pt: its optimizer state (the chain that the same flags build in
JAX; another chain is refused), update count and EMA load into the
trainer, and the generators, which JAX's PRNG keys cannot become, are
seeded from --seed.

The continuous tasks: `--task speech_diffusion` (`--arch diff_latent`,
ddpm_latent_loss) and `speech_diffusion_hubert` (`--arch diff_hubert`: the
diffusion over the 768-d features, no VAE), `--task hubert_vae`
(hubert_vae_loss, `--kl-beta`); `--arch diffusion_transformer` (one 1x1
WaveNet layer, 16 transformer layers) under either normalizer task. Width
flags left unset take the architecture's defaults (`models.diffusion.ARCHS`).
`--use-cond` is refused: no task feeds the prompt-conditioned denoiser a
prompt, as none does in JAX.

Optimization follows JAX's flags: `--optimizer` adam (fairseq's; default),
adamax, adadelta, lamb, nag, adafactor, adagrad, sgd or composite
(`--composite-groups` JSON: a top-level parameter key to an optimizer name
or to {"optimizer", "lr_scheduler", "lr", ...}), each with its own flags;
`--lr-scheduler` inverse_sqrt (default), fixed, cosine, polynomial_decay,
step, triangular, pass_through, tri_stage, or the host-driven manual
(`--epoch2lr`, `--update2lr`) and reduce_lr_on_plateau (`--lr-shrink`,
`--lr-patience`, `--lr-threshold`: it reads each epoch's validation
`--best-checkpoint-metric`); `--clip-norm`, `--loss-scale`,
`--freeze-finetune-updates` with `--freeze-finetune-subtrees`, and
`--ema-decay` (an EMA of the trainable weights, kept in trainer.pt).
`--log-format json` prints each logged step as JSON, and
`--tensorboard-logdir` writes TensorBoard scalars where the package is
installed.

Every family's dummy task trains without DATA (`Task.synthetic`: dummy_vae,
dummy_nar, dummy_ar, dummy_mt / dummy_translation, dummy_s2spect,
dummy_tts, dummy_s2t, dummy_cmlm_cg, dummy_lev, dummy_sedd, dummy_unit_lm /
dummy_lm, dummy_hubert, dummy_wav2vec2, dummy_ctc) on `--dataset-size`
synthetic batches of `--batch-size` x `--tokens-per-sample`, with the
flags, criterions and architectures of the task it derives from; with no
collater there is no batch iterator (JAX cli/train.py:140-147). fairseq's
criterion names resolve (`criterions/aliases.py`: cross_entropy, nat_loss,
ddpm_loss, speech_decoder_loss). `--user-dir PATH` imports a plugin whose
`registry.register_*` calls add tasks, criterions and architectures before
the flags are read; `--config FILE` reads a YAML of flag defaults under the
explicit flags (hydra's groups flattened); `cli.hydra_train` takes hydra's
dotted overrides.

Data parallelism: one process a rank, launched by torchrun (or JAX's
DIFFNORM_MULTIHOST environment), NCCL on cuda:LOCAL_RANK, gloo with --cpu.
`--data-parallel N` (default -1: every rank) splits each global batch's rows
over the ranks, and the update equals the one-process update on the same
batch (`train.trainer`): every rank builds the same batches from the same
iterator and `--seed`, and its resume position is global. `--zero-sharding
os` splits the optimizer state over the ranks, `--fsdp` (or `--ddp-backend
fully_sharded`) the masters too; `--use-bmuf` (or `--ddp-backend slowmo`)
wraps the optimizer in BMUF (`--global-sync-iter`, `--block-momentum`,
`--block-lr`, `--use-nbm`). `--model-parallel M` runs Megatron's tensor
parallelism over model groups of M ranks (`parallel.sharding_rules.
shard_model`; the ranks of one model group hold the same rows), so a run
takes data x M processes. Rank 0 alone logs and writes; its checkpoints
hold the whole state, which any data x model layout restores.

`--heartbeat-timeout S` starts a watchdog (`utils/watchdog.py`) that every
update pets; after S seconds without one it dumps every thread's stack and
interrupts the process (JAX cli/train.py:237-244). `--profile` records the
run with torch.profiler and writes each rank's Chrome trace under
`--profile-dir` (default SAVE_DIR/profile; JAX cli/train.py:245-247,
380-381).

  torchrun --nproc-per-node 4 -m diffnorm_tpu_torch.cli.train $DATA ... \\
      --data-parallel 2 --model-parallel 2 --fsdp --zero-sharding os
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from diffnorm_tpu_torch import registry
from diffnorm_tpu_torch.criterions import aliases
from diffnorm_tpu_torch.data.iterators import (
    EpochBatchIterator,
    SyntheticEpochIterator,
    grouped,
    iterate_valid,
)
from diffnorm_tpu_torch.parallel.mesh import (
    init_distributed,
    make_mesh,
    prefetch_to_device,
    replicate,
)
from diffnorm_tpu_torch.models.ar_transformer import ARCHS as AR_ARCHS
from diffnorm_tpu_torch.models.cmlm_text import ARCHS as CMLM_ARCHS
from diffnorm_tpu_torch.models.diffusion import ARCHS as DIFFUSION_ARCHS
from diffnorm_tpu_torch.models.hubert import CTC_ARCHS, PRETRAIN_ARCHS
from diffnorm_tpu_torch.models.levenshtein import ARCHS as LEV_ARCHS
from diffnorm_tpu_torch.models.nar_transformer import ARCHS as NAR_ARCHS
from diffnorm_tpu_torch.models.s2t_transformer import ARCHS as S2T_ARCHS
from diffnorm_tpu_torch.models.sedd import ARCHS as SEDD_ARCHS
from diffnorm_tpu_torch.models.transformer_text import ARCHS as MT_ARCHS
from diffnorm_tpu_torch.models.unit_lm import ARCHS as LM_ARCHS
from diffnorm_tpu_torch.models.unity import ARCHS as UNITY_ARCHS
from diffnorm_tpu_torch.models.wav2vec2 import ARCHS as W2V_ARCHS
from diffnorm_tpu_torch.tasks import TASKS
from diffnorm_tpu_torch.utils.compile_cache import enable_compile_cache
from diffnorm_tpu_torch.utils.watchdog import Watchdog
from diffnorm_tpu_torch.tasks.s2spect_task import ARCHS as SPECT_ARCHS
from diffnorm_tpu_torch.tasks.s2spect_task import S2SPECT2_ARCHS
from diffnorm_tpu_torch.tasks.sedd_task import ARCH_CRITERIONS as LM_CRITERIONS
from diffnorm_tpu_torch.tasks.tts_task import ARCH_CRITERIONS as TTS_CRITERIONS
from diffnorm_tpu_torch.tasks.tts_task import ARCHS as TTS_ARCHS
from diffnorm_tpu_torch.train import metrics as metrics_mod
from diffnorm_tpu_torch.train.checkpoint import (
    OPTAX_STATE,
    TRAINER,
    CheckpointManager,
    load_optax_state,
    load_variables,
)
from diffnorm_tpu_torch.train.lr_schedules import LR_SCHEDULES
from diffnorm_tpu_torch.train.optimizers import OPTIMIZER_NAMES
from diffnorm_tpu_torch.train.progress import LOG_FORMATS, ProgressWriter
from diffnorm_tpu_torch.train.trainer import Trainer, TrainerConfig
from diffnorm_tpu_torch.weights import from_jax_variables, to_jax_variables

logger = logging.getLogger("diffnorm_tpu_torch.train")

NAR_TASK, AR_TASK = "speech_to_speech_fasttranslate", "speech_to_speech_ar"
SPECT_TASK = "speech_to_speech_spect"
TTS_TASK, S2T_TASK = "text_to_speech", "speech_to_text"
MT_TASK, CMLM_TASK, LEV_TASK = "translation", "cmlm_cg", "translation_lev"
TEXT_TASKS = (MT_TASK, CMLM_TASK, LEV_TASK)
# the unit LM's dummy names share dummy_sedd's class, so they name their row
SEDD_TASKS = ("sedd", "sedd_lm")
LM_TASKS = ("unit_lm", "language_modeling", "dummy_unit_lm", "dummy_lm")
HUBERT_TASK, W2V_TASK, CTC_TASK = "hubert_pretraining", "audio_pretraining", "audio_finetuning"
AUDIO_TASKS = (HUBERT_TASK, W2V_TASK, CTC_TASK)
# fairseq's speech_to_speech: --target-is-code picks AR_TASK, else SPECT_TASK
S2S_TASK = "speech_to_speech"
STAGES = {  # task: (its criterions, the first the default; its architectures)
    "speech_decoder": (("speech_vae_decoder_loss",), ("speech_vae_decoder",)),
    "hubert_vae": (("hubert_vae_loss",), ("speech_vae_decoder",)),
    "speech_diffusion_discrete": (("ddpm_discrete_loss", "speech_decoder_loss"),
                                  ("diff_discrete", "diffusion_transformer")),
    "speech_diffusion": (("ddpm_latent_loss", "ddpm_loss"),
                         ("diff_latent", "diffusion_transformer")),
    "speech_diffusion_hubert": (("ddpm_latent_loss", "ddpm_loss"), ("diff_hubert",)),
    NAR_TASK: (("nar_speech_to_unit", "nat_loss"), tuple(NAR_ARCHS)),
    AR_TASK: (("label_smoothed_cross_entropy", "speech_to_unit", "speech_to_unit_2pass",
               "cross_entropy"), tuple(AR_ARCHS) + tuple(UNITY_ARCHS)),
    SPECT_TASK: (("speech_to_spectrogram", "tacotron2_loss", "tacotron2",
                  "speech_to_spectrogram_2pass"), tuple(SPECT_ARCHS)),
    TTS_TASK: (("tacotron2_loss", "tacotron2", "fastspeech2_loss", "fastspeech2"),
               tuple(TTS_ARCHS)),
    S2T_TASK: (("label_smoothed_cross_entropy", "cross_entropy"), tuple(S2T_ARCHS)),
    MT_TASK: (("label_smoothed_cross_entropy", "cross_entropy"), tuple(MT_ARCHS)),
    CMLM_TASK: (("nar_speech_to_unit", "nat_loss"), tuple(CMLM_ARCHS)),
    LEV_TASK: (("nat_loss", "levenshtein_loss"), tuple(LEV_ARCHS)),
    **dict.fromkeys(SEDD_TASKS, (("sedd_loss", "lm_cross_entropy"),
                                 tuple(SEDD_ARCHS) + tuple(LM_ARCHS))),
    **dict.fromkeys(LM_TASKS, (("lm_cross_entropy",), tuple(LM_ARCHS))),
    HUBERT_TASK: (("hubert",), tuple(PRETRAIN_ARCHS)),
    W2V_TASK: (("wav2vec",), tuple(W2V_ARCHS)),
    CTC_TASK: (("ctc",), tuple(CTC_ARCHS)),
}
TEXT_ARCHS = {**MT_ARCHS, **CMLM_ARCHS, **LEV_ARCHS}
# the criterions of the archs that pick their own, the first the default
ARCH_CRITERIONS = {**TTS_CRITERIONS, **LM_CRITERIONS}
# the two-pass models' criterions, which they alone train with
TWO_PASS_CRITERIONS = {**dict.fromkeys(UNITY_ARCHS, "speech_to_unit_2pass"),
                       **dict.fromkeys(S2SPECT2_ARCHS, "speech_to_spectrogram_2pass")}
# the criterions' label smoothing where --label-smoothing is not given
LABEL_SMOOTHING = {NAR_TASK: 0.2, AR_TASK: 0.1, S2T_TASK: 0.1, MT_TASK: 0.1, CMLM_TASK: 0.2,
                   LEV_TASK: 0.1}
# the optimizer's and schedule's flags beside --lr, --warmup-*, --adam-*
# and --weight-decay, under JAX's config keys (TrainerConfig.options)
OPTIONS = ("min_lr", "end_learning_rate", "power", "lr_decay_period", "lr_deacy_period",
           "lr_decay", "max_lr", "lr_period_updates", "lr_shrink", "shrink_min", "epoch2lr",
           "update2lr", "lr_threshold", "lr_patience", "maximize_best_checkpoint_metric",
           "warmup_steps", "hold_steps", "decay_steps", "init_lr_scale", "final_lr_scale",
           "adamax_betas", "adamax_eps", "no_bias_correction", "adadelta_rho",
           "adadelta_eps", "lamb_betas", "lamb_eps", "momentum", "nesterov", "decay_rate",
           "clip_threshold", "initial_accumulator_value", "composite_groups",
           "composite_default", "freeze_finetune_updates", "freeze_finetune_subtrees",
           "loss_scale", "use_bmuf", "ddp_backend", "global_sync_iter", "block_momentum",
           "block_lr", "use_nbm")
DDP_BACKENDS = ("c10d", "pytorch_ddp", "legacy_ddp", "no_c10d", "fully_sharded", "slowmo")


def _bool(value: str) -> bool:
    if value.lower() not in ("true", "false", "1", "0"):
        raise argparse.ArgumentTypeError(f"expected true or false, got {value!r}")
    return value.lower() in ("true", "1")


def _betas(value: str):
    return tuple(float(b) for b in value.strip("()[] ").split(","))


def _ints(value: str):
    return tuple(int(k) for k in value.strip("()[] ").replace(",", " ").split())


def _json(value: str):
    """A JSON value with tuples' parentheses as lists, as JAX's args.py
    reads a flag that starts with a bracket."""
    return json.loads(value.replace("(", "[").replace(")", "]"))


def _names(value: str):
    """Top-level parameter keys: a JSON list or comma-separated names."""
    value = value.strip()
    return tuple(_json(value)) if value[:1] in "[(" else tuple(value.split(","))


def _flag(p: argparse.ArgumentParser, name: str, default=False, **kw) -> None:
    """A boolean flag given alone or with true / false, as the JAX CLI's."""
    p.add_argument(name, type=_bool, nargs="?", const=True, default=default, **kw)


def add_two_pass_args(p: argparse.ArgumentParser) -> None:
    """The flags of the two-pass, spectrogram, TTS and S2T models (UnitY,
    s2spect, Translatotron2, tts_transformer, FastSpeech2, the S2T model),
    which cli.generate takes as well."""
    _flag(p, "--target-is-code", help="--task speech_to_speech: unit targets (else mels)")
    for flag in ("--translation-decoder-layers", "--synthesizer-encoder-layers",
                 "--decoder-transformer-layers", "--output-frame-dim", "--prenet-dim",
                 "--encoder-transformer-layers", "--encoder-conv-layers",
                 "--encoder-conv-kernel-size"):
        p.add_argument(flag, type=int, help="default: the architecture's")
    p.add_argument("--encoder-dropout", type=float,
                   help="the TTS encoder's conv dropout (default: the architecture's)")
    _flag(p, "--share-decoder-input-output-embed", default=None,
          help="the decoder's output projection tied to its embedding (default: the S2T "
               "model's not, the text transformer's tied)")
    p.add_argument("--prenet-layers", type=int, default=2)
    p.add_argument("--prenet-dropout", type=float, default=0.5)
    p.add_argument("--postnet-layers", type=int, default=5)
    p.add_argument("--postnet-conv-dim", type=int, default=512)
    p.add_argument("--postnet-conv-kernel-size", type=int, default=5)
    p.add_argument("--postnet-dropout", type=float, default=0.5)
    p.add_argument("--bce-pos-weight", type=float, default=5.0,
                   help="the Tacotron2 criterion's EOS positive weight")


def _floats(value: str):
    """A number, or a list of them ("[0.1, 10]", "(2, 0.5, 0.999995)")."""
    value = value.strip()
    return [float(v) for v in _json(value)] if value[:1] in "[(" else float(value)


def add_audio_args(p: argparse.ArgumentParser) -> None:
    """The flags of wav2vec2 and HuBERT pretraining and the CTC fine-tune,
    under JAX's names (the encoder's widths are --encoder-*)."""
    g = p.add_argument_group("wav2vec2 / HuBERT pretraining and the CTC fine-tune")
    # data (hubert_pretraining, audio_pretraining)
    g.add_argument("--labels", default="km", help="the label files' suffix ({split}.{labels})")
    g.add_argument("--label-dir", help="the labels' and dict.{labels}.txt's directory "
                                        "(default DATA)")
    g.add_argument("--label-rate", type=float, default=50.0)
    g.add_argument("--sample-rate", type=int, default=16000)
    g.add_argument("--max-sample-size", type=int, default=250000,
                   help="every row cropped to this static canvas")
    g.add_argument("--min-sample-size", type=int, default=32000)
    _flag(g, "--normalize", help="normalize each waveform to zero mean, unit variance")
    _flag(g, "--random-crop", default=True, help="crop training rows at a random start")
    # the span masks
    g.add_argument("--mask-prob", type=float, default=0.65)
    g.add_argument("--mask-length", type=int, default=10)
    g.add_argument("--mask-selection", default="static",
                   choices=("static", "uniform", "normal", "poisson"))
    g.add_argument("--mask-other", type=float, default=0.0)
    _flag(g, "--no-mask-overlap")
    g.add_argument("--mask-min-space", type=int, default=1)
    g.add_argument("--mask-dropout", type=float, default=0.0)
    _flag(g, "--apply-mask", help="audio_finetuning: the time and channel masks")
    g.add_argument("--mask-channel-prob", type=float, default=0.0)
    g.add_argument("--mask-channel-length", type=int, default=10)
    g.add_argument("--mask-channel-selection", default="static",
                   choices=("static", "uniform", "normal", "poisson"))
    g.add_argument("--mask-channel-other", type=float, default=0.0)
    _flag(g, "--no-mask-channel-overlap")
    g.add_argument("--mask-channel-min-space", type=int, default=1)
    # the models (defaults: the architecture's, then JAX's build_model's)
    g.add_argument("--conv-feature-layers",
                   help='the extractor\'s "[(dim, kernel, stride), ...]"')
    g.add_argument("--extractor-mode", choices=("default", "layer_norm"))
    _flag(g, "--conv-bias", default=None)
    _flag(g, "--layer-norm-first", default=None)
    # wav2vec2's codebook width is --latent-dim (0 or unset: --final-dim)
    for flag in ("--final-dim", "--latent-vars", "--latent-groups", "--num-classes"):
        g.add_argument(flag, type=int)
    for flag in ("--logit-temp", "--feature-grad-mult", "--dropout-input", "--dropout-features",
                 "--encoder-layerdrop", "--final-dropout"):
        g.add_argument(flag, type=float)
    g.add_argument("--num-negatives", type=int, default=100)
    g.add_argument("--latent-temp", type=_floats,
                   help="the Gumbel temperature (max, min, decay); default (2, 0.5, 0.999995)")
    # the criterions
    g.add_argument("--pred-masked-weight", type=float, default=1.0)
    g.add_argument("--pred-nomask-weight", type=float, default=0.0)
    g.add_argument("--loss-weights", type=_floats,
                   help="the extra losses' weights (hubert [10], wav2vec [0.1, 10])")
    g.add_argument("--w2v-path", help="audio_finetuning: warm-start the encoder from this "
                                      "pretraining checkpoint (fairseq .pt or step directory)")


def build_parser(description: str, train: bool = True,
                 task: Optional[str] = None) -> argparse.ArgumentParser:
    """The flags of cli.train; with `train` False (cli.validate) the model,
    data and task flags alone; `task` the default --task (else required)."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("data", nargs="?",
                   help="directory of the {split}.tsv translation manifests (none for a dummy "
                        "task)")
    p.add_argument("--tgt-feat-dir",
                   help="directory of the {split}.manifest.tsv feature manifests (the VAE and "
                        "normalizer stages)")
    p.add_argument("--task", required=task is None, default=task,
                   choices=sorted(set(STAGES) | set(TASKS)) + [S2S_TASK])
    p.add_argument("--user-dir", help="a plugin package or module whose register_* calls "
                                      "add tasks, criterions and architectures (registry.py)")
    p.add_argument("--config", help="a YAML of flag defaults (flag names with underscores; "
                                    "hydra's groups flattened), under the explicit flags")
    p.add_argument("--dataset-size", type=int,
                   help="a dummy task's batches a split (default: the task's)")
    p.add_argument("--criterion", help="the task's criterion (checked against it)")
    p.add_argument("--arch", help="the task's architecture (checked against it)")
    p.add_argument("--target-code-size", type=int, default=1000)
    p.add_argument("--speech-decoder-ckpt",
                   help="the VAE stage's checkpoint step directory (the normalizer's frozen VAE)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    p.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                   help="the forward's type; the master parameters are float32")
    p.add_argument("--prng-impl", help="JAX-only (its PRNG implementation); accepted and "
                                       "ignored: the port draws from torch.Generators")
    # model
    p.add_argument("--feature-dim", type=int, default=768)
    p.add_argument("--latent-dim", type=int,
                   help="the VAE's latent width (default 128; diff_hubert's 768); wav2vec2's "
                        "quantized width (default --final-dim)")
    p.add_argument("--chan-mults", type=json.loads, default=None,
                   help='VAE channel multipliers as JSON, e.g. "[3]"')
    p.add_argument("--vae-decoder-depth", type=int, default=6)
    p.add_argument("--vae-decoder-dim-head", type=int, default=96)
    p.add_argument("--vae-decoder-heads", type=int, default=8)
    for flag in ("--hidden-dim", "--timesteps", "--denoiser-depth", "--wavenet-layers",
                 "--wavenet-stacks"):
        p.add_argument(flag, type=int, help="default: the architecture's")
    p.add_argument("--multitask", type=_bool, help="default: the architecture's")
    _flag(p, "--use-cond", help="the prompt-conditioned denoiser: refused (no task feeds "
                                "it a prompt)")
    p.add_argument("--kl-beta", type=float, default=1e-4, help="hubert_vae_loss's KL weight")
    p.add_argument("--dropout", type=float, default=None,
                   help="dropout in training (default 0.1)")
    # the NAR model (nar_s2ut_conformer; widths left unset take the arch's)
    for flag in ("--encoder-embed-dim", "--encoder-ffn-embed-dim", "--encoder-layers",
                 "--encoder-attention-heads", "--decoder-embed-dim", "--decoder-ffn-embed-dim",
                 "--decoder-layers", "--decoder-attention-heads",
                 "--depthwise-conv-kernel-size"):
        p.add_argument(flag, type=int)
    p.add_argument("--input-feat-per-channel", type=int, default=80)
    p.add_argument("--conv-channels", type=int, default=1024)
    p.add_argument("--conv-kernel-sizes", type=_ints, default=(5, 5))
    p.add_argument("--attn-type")
    p.add_argument("--pos-enc-type")
    p.add_argument("--attention-dropout", type=float,
                   help="dropout of attention probabilities (default --dropout)")
    p.add_argument("--relu-dropout", "--activation-dropout", dest="relu_dropout", type=float,
                   help="dropout of the FFN activations (default --dropout)")
    p.add_argument("--cg-prob", type=float, default=0.0,
                   help="classifier-free-guidance drop rate of whole sources")
    _flag(p, "--use-sp", help="self-prompting")
    _flag(p, "--use-side", help="the side mask in half of the CMLM canvases")
    p.add_argument("--label-smoothing", type=float,
                   help="default 0.2 (NAR), 0.1 (AR), as JAX's criterions")
    p.add_argument("--n-frames-per-step", type=int, default=1,
                   help="units per decoder step (stacked units when > 1)")
    p.add_argument("--multitask-config-yaml",
                   help="the aux tasks' YAML, relative to DATA")
    p.add_argument("--multitask-ctc-vocab", type=int, default=0,
                   help="the vocabulary of a CTC head over the encoder (0: none)")
    _flag(p, "--target-speaker-embed", help="condition the encoder on a speaker embedding")
    p.add_argument("--speaker-embed-dim", type=int, default=256)
    _flag(p, "--encoder-remat", help="recompute each conformer layer in the backward")
    add_two_pass_args(p)
    _flag(p, "--quant-int8", help="int8 W8A8 matmuls in the normalizer and the NAR model")
    # data
    p.add_argument("--config-yaml", help="the data config, relative to DATA "
                                          "(default config.yaml)")
    p.add_argument("--dummy-config", help="alias of --config-yaml")
    p.add_argument("--train-subset", default="train")
    p.add_argument("--valid-subset", default="dev")
    p.add_argument("--max-tokens", type=int)
    p.add_argument("--batch-size", "--max-sentences", dest="batch_size", type=int,
                   help="sentences per batch at most")
    p.add_argument("--required-batch-size-multiple", type=int, default=1)
    p.add_argument("--num-workers", type=int, default=0,
                   help="host threads that load the batches (0: one background thread)")
    p.add_argument("--curriculum", type=int, default=0,
                   help="the batches in order for the first N epochs")
    p.add_argument("--max-source-positions", type=int)
    p.add_argument("--max-target-positions", type=int)
    p.add_argument("--seed", type=int, default=1)
    # the bitext tasks (translation, cmlm_cg, translation_lev)
    p.add_argument("--source-lang", help="the source files' suffix (default src)")
    p.add_argument("--target-lang", help="the target files' suffix (default tgt)")
    p.add_argument("--src-dict", help="the source dictionary (default DATA/dict.{src}.txt)")
    p.add_argument("--tgt-dict-path", help="the target dictionary (default DATA/dict.{tgt}.txt)")
    p.add_argument("--src-vocab-size", type=int,
                   help="the source vocabulary without a dictionary file (default 1000)")
    _flag(p, "--share-all-embeddings", help="refused: the text transformer's source and "
                                           "target tables are separate, as JAX's")
    # SEDD and the unit LM (tasks/sedd_task.py)
    for flag in ("--sedd-dim", "--sedd-depth", "--sedd-heads"):
        p.add_argument(flag, type=int, help="SEDD's width (default: the architecture's)")
    p.add_argument("--tokens-per-sample", type=int,
                   help="re-cut the unit stream into blocks of this many tokens (default 1024 "
                        "where --sample-break-mode is given)")
    p.add_argument("--sample-break-mode", choices=("none", "complete", "complete_doc", "eos"),
                   help="how the blocks break (default none where --tokens-per-sample is given)")
    add_audio_args(p)
    # parallelism (JAX config.py:133-134)
    p.add_argument("--data-parallel", type=int, default=-1,
                   help="data-parallel ranks (-1: every process of the group)")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="tensor-parallel degree: the ranks of one model group")
    if not train:
        return p
    p.add_argument("--heartbeat-timeout", type=float, default=0.0,
                   help="seconds without an update before the watchdog dumps the stacks "
                        "and interrupts the run (0: no watchdog)")
    _flag(p, "--profile", help="record the run with torch.profiler (a Chrome trace a rank)")
    p.add_argument("--profile-dir", help="where --profile writes (default SAVE_DIR/profile)")
    # optimization (flags left unset take each optimizer's and schedule's
    # own default, as in JAX)
    p.add_argument("--optimizer", choices=OPTIMIZER_NAMES, default="adam")
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--lr-scheduler", choices=sorted(LR_SCHEDULES), default="inverse_sqrt")
    p.add_argument("--warmup-updates", type=int)
    p.add_argument("--warmup-init-lr", type=float)
    p.add_argument("--adam-betas", type=_betas, default=(0.9, 0.98))
    p.add_argument("--adam-eps", type=float, default=1e-8)
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--clip-norm", type=float, default=2.0)
    for flag in ("--min-lr", "--end-learning-rate", "--power", "--lr-decay", "--max-lr",
                 "--lr-period-updates", "--lr-shrink", "--lr-threshold", "--init-lr-scale",
                 "--final-lr-scale", "--adamax-eps", "--adadelta-rho", "--adadelta-eps",
                 "--lamb-eps", "--momentum", "--decay-rate", "--clip-threshold",
                 "--initial-accumulator-value", "--loss-scale"):
        p.add_argument(flag, type=float)
    for flag in ("--lr-decay-period", "--lr-deacy-period", "--lr-patience", "--warmup-steps",
                 "--hold-steps", "--decay-steps", "--freeze-finetune-updates"):
        p.add_argument(flag, type=int)
    for flag in ("--shrink-min", "--no-bias-correction", "--nesterov",
                 "--maximize-best-checkpoint-metric"):
        _flag(p, flag)
    p.add_argument("--adamax-betas", type=_betas)
    p.add_argument("--lamb-betas", type=_betas)
    p.add_argument("--epoch2lr", help="manual: {epoch: lr} (keys '1,2', '3-5' or '6')")
    p.add_argument("--update2lr", help="manual: {update: lr}")
    p.add_argument("--composite-groups", type=_json,
                   help='composite: JSON {"top_key": "sgd" | {"optimizer": ..., '
                        '"lr_scheduler": ..., "lr": ...}}')
    p.add_argument("--composite-default", help="composite: the other groups' optimizer")
    p.add_argument("--freeze-finetune-subtrees", type=_names,
                   help="top-level keys frozen for --freeze-finetune-updates")
    p.add_argument("--ema-decay", type=float, default=0.0,
                   help="keep an EMA of the trainable weights at this decay")
    p.add_argument("--update-freq", type=int, default=1)
    _flag(p, "--fsdp", help="split the float32 masters and their optimizer state over the "
                            "data-parallel ranks")
    p.add_argument("--ddp-backend", choices=DDP_BACKENDS,
                   help="fully_sharded: --fsdp; slowmo: --use-bmuf; the others: the "
                        "data-parallel update")
    p.add_argument("--zero-sharding", choices=("none", "os"), default="none",
                   help="os: split the optimizer state over the data-parallel ranks")
    _flag(p, "--use-bmuf", help="block-momentum model update filtering around the optimizer")
    p.add_argument("--global-sync-iter", type=int, help="BMUF: updates between syncs "
                                                        "(default 50)")
    p.add_argument("--block-momentum", type=float, help="BMUF's momentum (default 0.875)")
    p.add_argument("--block-lr", type=float, help="BMUF's block lr (default 1)")
    p.add_argument("--use-nbm", type=_bool, nargs="?", const=True,
                   help="BMUF's Nesterov block momentum (default true)")
    p.add_argument("--max-update", type=int, required=True)
    # checkpoints and logging
    p.add_argument("--save-dir", default="checkpoints")
    p.add_argument("--restore-file",
                   help="warm start from this step directory (or, with --reset-optimizer, "
                        ".npz) when --save-dir holds no checkpoint")
    _flag(p, "--reset-optimizer", help="--restore-file: the model weights alone")
    _flag(p, "--reset-dataloader", help="--restore-file: not its epoch and iterator position")
    _flag(p, "--reset-lr-scheduler", help="--restore-file: not its schedule state")
    p.add_argument("--keep-best-checkpoints", type=int, default=5)
    p.add_argument("--keep-last-epochs", type=int, default=5)
    p.add_argument("--best-checkpoint-metric", default="loss")
    p.add_argument("--validate-interval", type=int, default=1, help="epochs")
    p.add_argument("--save-interval", type=int, default=1, help="epochs")
    p.add_argument("--save-interval-updates", type=int, default=0,
                   help="also save every N updates, mid-epoch (0: off)")
    p.add_argument("--log-interval", type=int, default=100)
    p.add_argument("--log-format", choices=LOG_FORMATS, default="simple")
    p.add_argument("--tensorboard-logdir")
    p.add_argument("--wandb-project")
    return p


def stage_of(name: str) -> str:
    """The STAGES row of a task: its own, or for a dummy task or a task a
    --user-dir plugin registered, that of the nearest task it derives from."""
    if name in STAGES:
        return name
    for cls in TASKS[name].__mro__[1:]:
        for other, other_cls in TASKS.items():
            if other_cls is cls and other in STAGES:
                return other
    raise ValueError(f"--task {name}: {TASKS[name].__name__} derives from no task cli.train "
                     f"trains")


def check_args(p: argparse.ArgumentParser, args: argparse.Namespace) -> argparse.Namespace:
    """The task's criterion and architecture, the unported flags, and the
    defaults that depend on the task. A dummy task (and a plugin's task)
    takes the checks and defaults of the task it derives from
    (`args.task` stays its own name)."""
    if args.task == S2S_TASK:
        args.task = AR_TASK if args.target_is_code else SPECT_TASK
    task = stage_of(args.task)  # the task whose checks apply
    synthetic = TASKS[args.task].synthetic
    if args.data is None and not synthetic:
        p.error(f"task {args.task} needs its data directory (DATA)")
    criteria, archs = STAGES[task]
    if args.arch is not None and registry.ARCH_BASES.get(args.arch, args.arch) not in archs:
        p.error(f"--arch {args.arch}: task {args.task} trains {' or '.join(archs)}")
    args.arch = args.arch or archs[0]
    base_arch = registry.ARCH_BASES.get(args.arch, args.arch)  # a plugin's: the arch it extends
    if base_arch in TWO_PASS_CRITERIONS:
        want = TWO_PASS_CRITERIONS[base_arch]
        if args.criterion not in (None, want):
            p.error(f"--arch {args.arch} trains with --criterion {want}")
        args.criterion = want
    elif args.criterion in TWO_PASS_CRITERIONS.values():
        p.error(f"--criterion {args.criterion}: a two-pass model's ({args.arch} is not one)")
    elif base_arch in ARCH_CRITERIONS:
        want = ARCH_CRITERIONS[base_arch]
        if args.criterion not in (None,) + want:
            p.error(f"--arch {args.arch} trains with --criterion {' or '.join(want)}")
        args.criterion = args.criterion or want[0]
    if (args.criterion is not None and args.criterion not in criteria
            and args.criterion not in registry.USER_CRITERIONS):
        p.error(f"--criterion {args.criterion}: task {args.task} trains {' or '.join(criteria)}")
    args.criterion = args.criterion or criteria[0]
    if args.criterion == "cross_entropy" and args.label_smoothing is None:
        args.label_smoothing = 0.0  # fairseq's cross_entropy smooths nothing
    if args.use_cond:
        p.error("--use-cond: no task feeds the prompt-conditioned denoiser a prompt (nor does "
                "JAX's: its criterions pass none, and its Denoiser asserts one, "
                "models/diffusion.py:271); build LatentDiffusionModule(use_cond=True) and "
                "pass batches with a prompt instead")
    lm_tasks = SEDD_TASKS + LM_TASKS + AUDIO_TASKS
    if task in (AR_TASK, SPECT_TASK, TTS_TASK, S2T_TASK) + TEXT_TASKS + lm_tasks:
        options = (("--use-sp", args.use_sp),
                   ("--multitask-ctc-vocab", args.multitask_ctc_vocab),
                   ("--encoder-remat", args.encoder_remat), ("--quant-int8", args.quant_int8))
        if task != CMLM_TASK:
            options += (("--cg-prob", args.cg_prob), ("--use-side", args.use_side))
        if task != AR_TASK:
            options += (("--target-speaker-embed", args.target_speaker_embed),)
        if task in (TTS_TASK, S2T_TASK) + TEXT_TASKS + lm_tasks:
            options += (("--multitask-config-yaml", args.multitask_config_yaml),)
        if task in (S2T_TASK,) + TEXT_TASKS + lm_tasks:
            options += (("--n-frames-per-step", args.n_frames_per_step > 1),)
        for flag, value in options:
            if value:
                p.error(f"{flag}: an option of the NAR model; {args.arch} has none, as JAX's")
        if task == TTS_TASK and args.n_frames_per_step > 1:
            p.error("--n-frames-per-step: the text_to_speech dataset does not stack its "
                    "frames (nor does JAX's, whose criterion then fails on the shapes)")
    if args.w2v_path and task != CTC_TASK:
        p.error(f"--w2v-path: the {CTC_TASK} task's warm start")
    if task not in (S2T_TASK, MT_TASK) and args.share_decoder_input_output_embed:
        p.error(f"--share-decoder-input-output-embed: an option of the S2T model and the text "
                f"transformer (--task {S2T_TASK} or {MT_TASK})")
    if args.share_all_embeddings:
        p.error("--share-all-embeddings is not supported (the encoder's and decoder's "
                "embeddings are separate tables); use --share-decoder-input-output-embed")
    if task == TTS_TASK:
        TTS_ARCHS[args.arch](vars(args))
    elif task == S2T_TASK:
        S2T_ARCHS[args.arch](vars(args))
        if args.label_smoothing is None:
            args.label_smoothing = LABEL_SMOOTHING[task]
    elif task == SPECT_TASK:
        SPECT_ARCHS[args.arch](vars(args))
        if args.prenet_dim is None:
            args.prenet_dim = 256
    elif task in TEXT_TASKS:
        {**MT_ARCHS, **CMLM_ARCHS, **LEV_ARCHS}[args.arch](vars(args))  # with plugins' archs
        if task == MT_TASK and args.share_decoder_input_output_embed is None:
            args.share_decoder_input_output_embed = True  # JAX's default
        if args.label_smoothing is None:
            args.label_smoothing = LABEL_SMOOTHING[task]
    elif task in AUDIO_TASKS:
        {**PRETRAIN_ARCHS, **W2V_ARCHS, **CTC_ARCHS}[args.arch](vars(args))
    elif task in lm_tasks:
        {**SEDD_ARCHS, **LM_ARCHS}[args.arch](vars(args))
        if args.label_smoothing is None:
            args.label_smoothing = 0.0  # lm_cross_entropy's default
    elif task in (NAR_TASK, AR_TASK):
        {**NAR_ARCHS, **AR_ARCHS, **UNITY_ARCHS}[args.arch](vars(args))
        if args.label_smoothing is None:
            args.label_smoothing = LABEL_SMOOTHING[task]
    else:
        if args.tgt_feat_dir is None and not synthetic:
            p.error(f"task {task} needs --tgt-feat-dir")
        args.dropout = 0.1 if args.dropout is None else args.dropout
        if task in ("speech_decoder", "hubert_vae"):
            args.latent_dim = 128 if args.latent_dim is None else args.latent_dim
        else:
            widths = vars(args)
            DIFFUSION_ARCHS[args.arch](widths)
            for key, value in (("denoiser_depth", 12), ("wavenet_layers", 8),
                               ("wavenet_stacks", 4), ("use_vae", True)):
                if widths.get(key) is None:
                    widths[key] = value
    args.config_yaml = args.config_yaml or args.dummy_config or "config.yaml"
    return args


def preparse(argv: Optional[Sequence[str]]) -> argparse.Namespace:
    """--user-dir and --config, read before the parser is built: the
    plugin's imports register the names the parser's --task choices list."""
    q = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    q.add_argument("--user-dir")
    q.add_argument("--config")
    pre, _ = q.parse_known_args(argv)
    registry.import_user_module(pre.user_dir)
    return pre


def apply_config(p: argparse.ArgumentParser, path: Optional[str]) -> None:
    """--config's YAML as the parser's defaults, under the explicit flags
    (JAX cli/args.py:38-67): keys are flag names with underscores (dashes
    taken too), a mapping that names no flag is a hydra group whose keys
    are read in turn, and a key that names no flag is an error."""
    if not path:
        return
    import yaml

    with open(path) as f:
        tree = yaml.safe_load(f) or {}
    actions = {a.dest: a for a in p._actions}
    flat = {}

    def walk(node: dict) -> None:
        for key, value in node.items():
            key = str(key).replace("-", "_")
            if isinstance(value, dict) and key not in actions:
                walk(value)
            else:
                flat[key] = value

    walk(tree)
    unknown = sorted(k for k in flat if k not in actions or k in ("help", "config", "user_dir"))
    if unknown:
        p.error(f"--config {path}: no flags {unknown}")
    for key in flat:
        actions[key].required = False
    p.set_defaults(**flat)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    pre = preparse(argv)
    p = build_parser(__doc__.split("\n")[0])
    apply_config(p, pre.config)
    return check_args(p, p.parse_args(argv))


def build_criterion(task, args: argparse.Namespace):
    """The criterion --criterion names: fairseq's name for a ported one or
    a plugin's (`criterions.aliases.CRITERIONS`), else the task's own."""
    named = aliases.CRITERIONS.get(args.criterion)
    return named(args, task) if named is not None else task.build_criterion()


def trainer_config(args: argparse.Namespace) -> TrainerConfig:
    """The trainer's configuration from the optimization flags."""
    return TrainerConfig(
        lr=args.lr, warmup_updates=args.warmup_updates, warmup_init_lr=args.warmup_init_lr,
        adam_betas=args.adam_betas, adam_eps=args.adam_eps, weight_decay=args.weight_decay,
        clip_norm=args.clip_norm, dtype=args.dtype, seed=args.seed, optimizer=args.optimizer,
        lr_scheduler=args.lr_scheduler, ema_decay=args.ema_decay,
        zero_sharding=args.zero_sharding,
        fsdp=bool(args.fsdp) or args.ddp_backend == "fully_sharded",
        options={"max_updates": args.max_update,
                 **{key: getattr(args, key) for key in OPTIONS}})


def max_positions(args: argparse.Namespace):
    """The size cap of filter-by-size, (max_source_positions,
    max_target_positions), or None when neither is set (JAX
    cli/train.py:40-49)."""
    if args.max_source_positions is None and args.max_target_positions is None:
        return None
    return args.max_source_positions, args.max_target_positions


def start_profiler(device: torch.device):
    """torch.profiler over the host and, on the card, CUDA (JAX's
    jax.profiler.start_trace)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    return profiler


def stop_profiler(profiler, out_dir: str, rank: int) -> str:
    """Stop and write the rank's Chrome trace under `out_dir`; its path."""
    profiler.stop()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"trace_rank{rank}.json")
    profiler.export_chrome_trace(path)
    logger.info("profile trace written to %s", path)
    return path


def fmt_metrics(vals: Dict[str, float]) -> str:
    return " ".join(f"{k} {vals[k]:.4g}" for k in sorted(vals)
                    if k not in ("ntokens", "nsentences"))


def restore(args: argparse.Namespace, ckpt: CheckpointManager, model: torch.nn.Module,
            device: torch.device, frozen_keys: Sequence[str]):
    """Load the master weights from the save directory's last checkpoint or
    from --restore-file (see the module docstring). Returns (trainer state,
    sidecar, host-driven schedule state), each None where the run starts
    afresh or keeps its own."""
    last = ckpt.latest_step()
    if last is not None:
        variables, state, extra = ckpt.load(last, device)
        from_jax_variables(model, variables)
        logger.info("resumed from step %d (epoch %d)", last, extra["epoch"])
        return state, extra, extra.get("lr_scheduler")
    rf = args.restore_file
    if not rf:
        return None, None, None
    if args.reset_optimizer:
        variables = load_variables(rf)
        params, mine = variables["params"], to_jax_variables(model)
        missing = [k for k in mine["params"] if k not in params and k not in frozen_keys]
        if missing:
            raise ValueError(f"--restore-file {rf} lacks param subtrees {missing}")
        from_jax_variables(model, {
            col: ({k: params.get(k, v) for k, v in tree.items()} if col == "params"
                  else variables.get(col, tree))
            for col, tree in mine.items()})
        logger.info("warm-started params from %s (optimizer reset)", rf)
        return None, None, None
    if os.path.exists(os.path.join(rf, TRAINER)):
        state = torch.load(os.path.join(rf, TRAINER), map_location=device)
    elif os.path.exists(os.path.join(rf, OPTAX_STATE)):  # bridged from JAX
        state = {OPTAX_STATE: load_optax_state(rf)}
    else:
        raise ValueError(f"--restore-file {rf} holds no trainer state ({TRAINER} or "
                         f"{OPTAX_STATE}), as a converted checkpoint does: add "
                         f"--reset-optimizer")
    sidecar = rf.rstrip("/") + ".json"
    extra = {}
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            extra = json.load(f)
    elif OPTAX_STATE not in state:
        raise ValueError(f"--restore-file {rf}: no sidecar {sidecar}")
    from_jax_variables(model, load_variables(rf))
    logger.info("restored %s at step %s", rf, extra.get("step"))
    if "iterator" not in extra:  # a bridged step directory without its sidecar
        extra = None
    return (state, None if args.reset_dataloader or extra is None else extra,
            None if args.reset_lr_scheduler or extra is None else extra.get("lr_scheduler"))


def validate_split(task, trainer: Trainer, args: argparse.Namespace,
                   np_rng: np.random.Generator, device: torch.device,
                   split: str) -> Optional[Dict[str, float]]:
    """The criterion's metrics over `split` in eval mode, aggregated as
    JAX's MetricsAggregator does (counts summed, the rest weighted by
    sample_size); None when the split has no data. The batches' draws come
    from `np_rng`, the criterion's from a generator seeded 0."""
    try:
        dataset = task.dataset(split)
    except FileNotFoundError as e:
        logger.warning("validation skipped: %s", e)
        return None
    generator = torch.Generator(device=device).manual_seed(0)
    with metrics_mod.aggregate() as agg:
        for batch in iterate_valid(dataset, args.max_tokens, max_positions(args)):
            # on a copy: a dummy task's batch is the same dict every time
            trainer.valid_step(task.prepare_batch(dict(batch), np_rng), generator)
    return agg.get_smoothed_values()


def main(argv: Optional[Sequence[str]] = None) -> int:
    enable_compile_cache()
    argv = sys.argv[1:] if argv is None else list(argv)
    # the vocoder fine-tunes train a GAN, which the Trainer does not model:
    # JAX's cli/train.py:101-106 hands them to cli.train_vocoder
    task_parser = argparse.ArgumentParser(add_help=False)
    task_parser.add_argument("--task")
    chosen, rest = task_parser.parse_known_args(argv)
    if chosen.task in ("unit_to_speech", "repr_to_speech"):
        from diffnorm_tpu_torch.cli import train_vocoder

        if chosen.task == "repr_to_speech":
            rest = rest + ["--input-type", "features"]
        return train_vocoder.main(rest)
    logging.basicConfig(level=logging.INFO, force=True,
                        format="%(asctime)s | %(levelname)s | %(name)s | %(message)s")
    args = parse_args(argv)
    device = init_distributed(cpu=args.cpu)
    mesh = make_mesh(args.data_parallel, args.model_parallel)
    main_rank = mesh.rank == 0
    if not main_rank:  # rank 0 alone logs
        logging.getLogger().setLevel(logging.WARNING)
    if mesh.data > 1 or mesh.model > 1:
        logger.info("training over %d data x %d model ranks (%s)", mesh.data, mesh.model,
                    mesh.backend)
    ckpt = CheckpointManager(args.save_dir, keep_last=args.keep_last_epochs,
                             keep_best=args.keep_best_checkpoints,
                             maximize=args.maximize_best_checkpoint_metric)
    if args.w2v_path and ckpt.latest_step() is not None:
        # the restore overwrites the graft, and the pretraining file may be
        # gone (JAX cli/train.py:150-157)
        logger.info("resuming from %s; ignoring --w2v-path", args.save_dir)
        args.w2v_path = None
    torch.manual_seed(args.seed)  # the model's initialization
    task = TASKS[args.task](args)
    with torch.device(device):
        model = task.build_model()
    task.load_frozen_params(model)

    def make_epoch_itr(ds):
        if not hasattr(ds, "collater"):  # a dummy task's synthetic batches
            return SyntheticEpochIterator(ds)
        return EpochBatchIterator(
            ds, max_tokens=args.max_tokens, max_sentences=args.batch_size,
            required_batch_size_multiple=args.required_batch_size_multiple, seed=args.seed,
            num_workers=args.num_workers, max_positions=max_positions(args),
            ignore_invalid_inputs=True, curriculum=args.curriculum)

    dataset = task.dataset(args.train_subset)
    epoch_itr = make_epoch_itr(dataset)
    if hasattr(dataset, "collater"):
        # JAX builds its example batch from dataset[0] here, on every start,
        # before a checkpoint is restored (cli/train.py:141-144): the item is
        # thrown away, but the draw advances the dataset's SpecAugment
        # generator as JAX's does
        dataset[0]
    # the master weights are restored before the trainer casts its working copy
    state, extra, lr_state = restore(args, ckpt, model, device, task.frozen_param_keys)
    replicate(model, mesh)  # rank 0's weights on every rank, as JAX's replicate
    trainer = Trainer(trainer_config(args), model, build_criterion(task, args),
                      frozen_keys=task.frozen_param_keys, mesh=mesh)
    n_params = sum(p.numel() for p in trainer.params)
    logger.info("model params (trainable): %.2fM on %s, forward in %s", n_params / 1e6,
                device, args.dtype)
    start_epoch = 1
    if state is not None and OPTAX_STATE in state:
        trainer.load_optax_state(state[OPTAX_STATE])
        logger.info("loaded the JAX optimizer state of %s at step %d; the generators are "
                    "seeded from --seed %d (JAX's PRNG keys do not carry over)",
                    args.restore_file, trainer.num_updates, args.seed)
    elif state is not None:
        trainer.load_state_dict(state)
    if extra is not None:
        epoch_itr.load_state_dict(extra["iterator"])
        start_epoch = extra["epoch"]
    trainer.load_lr_state_dict(lr_state)
    np_rng = np.random.default_rng(args.seed)  # the batches' draws (the CMLM canvases)
    if hasattr(task, "set_num_updates"):
        task.set_num_updates(trainer.num_updates)
    progress = (ProgressWriter(args.log_format, args.tensorboard_logdir, args.wandb_project)
                if main_rank else None)

    def run_validation() -> Optional[float]:
        if hasattr(task, "set_num_updates"):
            task.set_num_updates(trainer.num_updates)
        vals = validate_split(task, trainer, args, np_rng, device, args.valid_subset)
        if vals is None:
            return None
        logger.info("valid | %s", fmt_metrics(vals))
        return vals.get(args.best_checkpoint_metric)

    def prepare(micro):
        """A group's batches prepared (their draws, in order, on a copy: a
        dummy task's batch is the same dict every step) and on the card."""
        return [trainer.upload(task.prepare_batch(dict(b), np_rng)) for b in micro]

    def save(epoch: int, metric: Optional[float]) -> None:
        """Every rank takes part (the sharded state is gathered whole);
        rank 0 writes."""
        sidecar = {"epoch": epoch, "iterator": epoch_itr.state_dict()}
        if trainer.lr_state_dict() is not None:  # a host-driven schedule's
            sidecar["lr_scheduler"] = trainer.lr_state_dict()
        with trainer.gathered_master() as master:
            state = trainer.state_dict()
            if main_rank:
                ckpt.save(trainer.num_updates, master, state, metric, sidecar)
        mesh.barrier()
        logger.info("saved checkpoint at step %d (metric=%s)", trainer.num_updates, metric)

    step, done = trainer.num_updates, False
    epoch = start_epoch
    watchdog = Watchdog(args.heartbeat_timeout).start()
    profiler = start_profiler(device) if args.profile else None
    while not done:
        trainer.lr_step_begin_epoch(epoch)  # manual's epoch2lr
        if task.has_sharded_data():
            # --data dir1:dir2:...: a new shard, a new iterator, which takes a
            # resumed mid-epoch position in the first epoch (JAX cli/train.py:295-310)
            ds = task.dataset(args.train_subset, epoch=epoch)
            if ds is not dataset:
                saved = epoch_itr.state_dict() if epoch == start_epoch else None
                dataset, epoch_itr = ds, make_epoch_itr(ds)
                if saved is not None:
                    epoch_itr.load_state_dict(saved)
                else:
                    epoch_itr.epoch = epoch
                logger.info("loaded data shard %s for epoch %d", task.data_path(epoch), epoch)
        interval, t0, first = metrics_mod.MetricsAggregator(), time.time(), step
        with metrics_mod.aggregate(interval):
            # the next two groups are prepared and uploaded while this one
            # trains, as JAX's device prefetch: the multitask loss weights a
            # group takes follow the update count two updates before its own
            groups = grouped(epoch_itr.next_epoch_itr(), args.update_freq)
            for micro in prefetch_to_device(groups, prepare, depth=2, device=device):
                mets = trainer.train_step(micro)
                watchdog.pet()
                step = trainer.num_updates
                if hasattr(task, "set_num_updates"):
                    task.set_num_updates(step)
                epoch_itr.mark_trained(len(micro))  # the resume offset
                if args.save_interval_updates and step % args.save_interval_updates == 0:
                    save(epoch, None)
                if step % args.log_interval == 0:
                    if progress is not None:
                        progress.log(mets, step)
                    ups = args.log_interval / max(time.time() - t0, 1e-6)
                    logger.info("epoch %d | step %d | %s | ups %.2f", epoch, step,
                                fmt_metrics(interval.get_smoothed_values()), ups)
                    interval.reset()
                    t0 = time.time()
                if step >= args.max_update:
                    done = True
                    break
        if step == first:
            raise ValueError(f"epoch {epoch} has no training batch: check "
                             f"--max-tokens and --max-target-positions")
        epoch_itr.finish_epoch()
        metric = run_validation() if epoch % args.validate_interval == 0 or done else None
        trainer.lr_step_epoch(epoch, metric)  # reduce_lr_on_plateau reads the metric
        if epoch % args.save_interval == 0 or done:
            save(epoch + 1, metric)
        epoch += 1
    watchdog.stop()
    if profiler is not None:
        stop_profiler(profiler, args.profile_dir or os.path.join(args.save_dir, "profile"),
                      mesh.rank)
    if progress is not None:
        progress.close()
    logger.info("training done at step %d", step)
    return 0


if __name__ == "__main__":
    sys.exit(main())
