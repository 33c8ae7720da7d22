"""Generation CLI: the NAR and AR S2UT, S2T and speech-synthesis branches
(PyTorch port of diffnorm_tpu/cli/generate.py; reference
fairseq_cli/generate.py).

  python -m diffnorm_tpu_torch.cli.generate $DATA \\
      --task speech_to_speech_fasttranslate --target-code-size 1000 \\
      --arch nar_s2ut_conformer --path ckpt/nar/step_000400000 \\
      --gen-subset test --max-tokens 20000 --iter-decode-max-iter 15 \\
      --cond-scale 1.0 --results-path results/

  python -m diffnorm_tpu_torch.cli.generate $DATA \\
      --task speech_to_speech_ar --target-code-size 1000 \\
      --arch s2ut_conformer --path ckpt/ar/step_000400000 \\
      --gen-subset test --max-tokens 20000 --beam 5 --results-path results/

Decodes `{gen_subset}.tsv` under DATA with mask-predict
(`generate/mask_predict.py`; the AR branch below) in batches of
`--max-tokens` source frames (and at most `--batch-size` sentences), in
the dataset's order (descending source length), and writes
`generate-{split}.txt` under --results-path (stdout without it) with
fairseq's lines per sentence: `T-{id}\\t{ref}`,
`H-{id}\\t{score}\\t{hyp}` and `D-{id}\\t{score}\\t{hyp}`, ids being manifest
indices, then `Generate {split} with beam={beam}: {score}` for the corpus:
BLEU-4 from the counters of `eval/bleu.py` (`--scoring bleu`, the default),
sacrebleu (`--scoring sacrebleu`) or WER (`--scoring wer`).

`--path` is a `weights.save_npz` file or a `cli.train` step directory; the
shape flags are cli.s2st's. `--cond-scale` != 1 decodes with classifier-free
guidance, `--iter-decode-with-beam N` with a length beam,
`--iter-decode-force-max-iter` without the adaptive exit, and
`--init-unit-file F` on canvases of a prior run's lengths (`id\\tunits` lines
keyed by sentence id, or plain unit lines keyed by line number; a canvas is
len(units) + 1). Runs on the GPU (bf16 unless --dtype says otherwise)
unless --cpu is given, which runs in float32.

A stacked-unit model (`--n-frames-per-step k`) decodes packed steps and
writes the full-rate units; `--target-speaker-embed` conditions each
sentence on the speaker embedding the data config names.
`--post-process S` / `--remove-bpe S` detokenize the D- line and the
reference by `data.encoders.post_process` (e.g. letter, subword_nmt), and
the score reads those.

`--quant-int8` decodes with JAX's int8 W8A8 NAR model (per-token dynamic
activation scales); with `--quant-int8-static` as well, every site's static
activation scale is calibrated on the first batch (`calibrate_act_scales`,
its target's canvas) before that batch's decode, and the decode runs on
those scales. `--quant-int8-static` alone does nothing, as in JAX.

Batches load on a background thread, or on `--num-workers N` host
threads, in order; the next two batches' sources are uploaded to the card
while the current one decodes (JAX cli/generate.py:519-588).

`--path a:b:c` decodes with an ensemble of those checkpoints (one
architecture; the members' log-probs averaged each step, each member
calibrated on its own with --quant-int8-static). `--retain-iter-history`
writes each step's filled canvas as `E-{id}_{step}\t{units}` lines after
the sentence's D- line; `--decode-chunk N` decodes each batch in
sub-batches of N rows (`mask_predict_decode_chunked`).

`--rerank-path AR` with `--iter-decode-with-beam N > 1` picks each
sentence's candidate by its mean log-prob under that AR S2UT model
(`mask_predict.ar_rerank_scores`); `--rerank-<flag> V` sets a model flag
(`--rerank-arch`, `--rerank-encoder-layers`, ...) for the reranker alone,
whose other flags are the run's, as JAX's --rerank-<key> overrides.

The AR S2UT branch (`--task speech_to_speech_ar --arch s2ut_conformer`,
`s2ut_transformer` or `s2ut_transformer_fisher`; a width left unset takes
the arch's default) decodes with fairseq's beam search through the KV
cache (`generate/beam_search.py`): `--beam`, `--lenpen`, `--min-len`,
`--no-repeat-ngram-size`, `--unkpen`, `--prefix-size` (the reference's
first tokens forced) and `--path a:b` ensembles; `--sampling` with
`--sampling-topk`, `--sampling-topp` and `--temperature` draws `--beam`
samples a sentence from a torch.Generator seeded with `--seed` (JAX's PRNG
stream cannot be reproduced); `--score-reference` writes each reference
with its teacher-forced log-probs; `--n-frames-per-step k > 1` decodes
greedily k units a step (the first model of an ensemble). Its H- and D-
lines carry the best hypothesis and its normalized score; the summary
line names `--beam` (`--iter-decode-with-beam` for the stacked and the
reference-scoring runs, as JAX's). The decode runs at most
min(--max-target-positions, 256) steps.

The S2T model (`--task speech_to_text --arch s2t_transformer`,
`s2t_transformer_s`, `s2t_transformer_xs` or `s2t_conformer`; the model's
flags as cli.train takes them) decodes through that AR branch (beam,
`--sampling`, `--score-reference`, ensembles) on `tasks/s2t_task.py`'s
manifests; its H-, D- and T- lines are text through the task's dictionary.

UnitY (`--task speech_to_speech --target-is-code --arch unity_conformer`,
or `--task speech_to_speech_ar`; the model's flags as cli.train takes them,
its --multitask-config-yaml among them) decodes both beam passes
(`generate/unity.py`): `--beam`, `--lenpen` and the rest for the units,
`--beam-mt` (default --beam), `--lenpen-mt` and `--max-len-b-mt` (at most
256) for the first pass; the first model of an ensemble; stacked units
raise, as in JAX.

The spectrogram branch (`--task speech_to_speech` without --target-is-code,
or `speech_to_speech_spect`; `--arch s2spect_transformer`,
`s2spect_transformer_fisher`, `s2spect_conformer`, `s2spect2_conformer`)
writes each utterance's frames as `{id}.npy` under --results-path: the AR
mel rollout (`generate/speech_ar.py`) of --max-target-positions steps with
--eos-prob-threshold, after Translatotron2's first pass, whose hypothesis is
logged as `MT-{id}\t{text}` (`generate/translatotron2.py`). The prenet
draws from one generator seeded with --seed. `--vocoder W --vocoder-cfg C`
(a `cli.train_vocoder --input-type features` generator) adds
`{id}_pred.wav`. Text-input TTS (`--task text_to_speech`, `--arch
tts_transformer` or `tts_transformer_base`: the same rollout after the
text encoder; `fastspeech2` or `fastspeech2_base`: one forward on the
predicted variances over its --max-target-positions frame buffer (the
model's flag, default 2048), each row cut by its frame mask) writes the
same files.

Text machine translation (`--task translation`, `cmlm_cg` or
`translation_lev`; the model's flags, the bitext and its dictionaries as
cli.train takes them: `--source-lang`, `--target-lang`, `--src-dict`,
`--tgt-dict-path`) writes the same lines in text through the target
dictionary (JAX cli/generate.py:254-276): the AR transformer through the
AR branch's beam search (`--beam`, `--lenpen`, `--no-repeat-ngram-size`,
the rest of its flags; at most 256 steps), the text CMLM through
mask-predict (`--iter-decode-max-iter`, `--iter-decode-with-beam`,
`--cond-scale`), the Levenshtein transformer through
`models.levenshtein.levenshtein_decode` (`--iter-decode-max-iter`,
`--iter-decode-eos-penalty`) on a canvas of min(--max-target-positions,
256) tokens, each with `--remove-bpe` / `--post-process` and BLEU, WER or
sacrebleu scoring (sacrebleu fails to import where it is not installed,
as in JAX).

The CTC fine-tune (`--task audio_finetuning --arch hubert_ctc` or
`wav2vec_ctc`; the model's and the data's flags as cli.train takes them, the
data config's `use_audio_input` among them) decodes greedily
(`generate/ctc.py`: best path over the frames, an ensemble's frame
log-probabilities averaged) and writes the same lines in text through the
task's dictionary, one step a sentence; it takes no int8 route, as in JAX.

SEDD and the unit LM have no branch here, as in JAX: `models.sedd`'s
`sedd_sample` / `sedd_refine` decode in process and `cli.eval_lm` scores
the LM. Another task or architecture (the pretraining tasks, the VAE and
normalizer stages, whose generation is cli.diff_norm_synthesis) raises
NotImplementedError. `--user-dir` imports a plugin before the flags are
read (registry.py).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from diffnorm_tpu_torch.cli import train as train_cli
from diffnorm_tpu_torch.cli.generate_waveform import write_wav
from diffnorm_tpu_torch.cli.s2st import (
    add_data_parallel_arg,
    add_model_args,
    build_model,
    data_parallel_mesh,
    resolve_device_dtype,
)
from diffnorm_tpu_torch.data.dictionary import Dictionary
from diffnorm_tpu_torch.data.encoders import post_process
from diffnorm_tpu_torch.data.iterators import EpochBatchIterator, read_ahead
from diffnorm_tpu_torch.data.s2s_dataset import SpeechToUnitDataset
from diffnorm_tpu_torch.eval.bleu import BleuAccumulator
from diffnorm_tpu_torch.eval.wer import WerAccumulator
from diffnorm_tpu_torch.generate.beam_search import ar_generate, ar_generate_stacked
from diffnorm_tpu_torch.generate.ctc import ctc_greedy_decode
from diffnorm_tpu_torch.generate.mask_predict import average_log_probs, mask_predict_decode_chunked
from diffnorm_tpu_torch.generate.speech_ar import ARSpeechGenerator
from diffnorm_tpu_torch.generate.translatotron2 import Translatotron2SpeechGenerator
from diffnorm_tpu_torch.generate.unity import unity_generate
from diffnorm_tpu_torch.models.ar_transformer import ARCHS as AR_ARCHS
from diffnorm_tpu_torch.models.ar_transformer import ARS2UTModule
from diffnorm_tpu_torch.models.cmlm_text import ARCHS as CMLM_ARCHS
from diffnorm_tpu_torch.models.fastspeech2 import FastSpeech2Module, NonARSpeechGenerator
from diffnorm_tpu_torch.models.hubert import CTC_ARCHS
from diffnorm_tpu_torch.models.levenshtein import ARCHS as LEV_ARCHS
from diffnorm_tpu_torch.models.levenshtein import levenshtein_decode
from diffnorm_tpu_torch.models.nar_transformer import calibrate_act_scales
from diffnorm_tpu_torch.models.s2t_transformer import ARCHS as S2T_ARCHS
from diffnorm_tpu_torch.models.transformer_text import ARCHS as MT_ARCHS
from diffnorm_tpu_torch.models.unity import ARCHS as UNITY_ARCHS
from diffnorm_tpu_torch.ops.quant import set_static_scales
from diffnorm_tpu_torch.tasks import TASKS
from diffnorm_tpu_torch.tasks.ar_s2ut_task import shift_right
from diffnorm_tpu_torch.tasks.s2spect_task import ARCHS as SPECT_ARCHS
from diffnorm_tpu_torch.tasks.s2spect_task import S2SPECT2_ARCHS
from diffnorm_tpu_torch.tasks.tts_task import ARCHS as TTS_ARCHS
from diffnorm_tpu_torch.train.checkpoint import load_tree, load_variables
from diffnorm_tpu_torch.utils.compile_cache import enable_compile_cache
from diffnorm_tpu_torch.weights import as_variables, from_jax_variables

logger = logging.getLogger("diffnorm_tpu_torch.generate")

PAD, EOS = 1, 2
TASK, ARCH = "speech_to_speech_fasttranslate", "nar_s2ut_conformer"
AR_TASK = train_cli.AR_TASK
SPECT_TASK, S2S_TASK = train_cli.SPECT_TASK, train_cli.S2S_TASK
TTS_TASK, S2T_TASK, CTC_TASK = train_cli.TTS_TASK, train_cli.S2T_TASK, train_cli.CTC_TASK
MT_TASK, CMLM_TASK, LEV_TASK = train_cli.MT_TASK, train_cli.CMLM_TASK, train_cli.LEV_TASK
TASK_ARCHS = {TASK: (ARCH,), AR_TASK: tuple(AR_ARCHS) + tuple(UNITY_ARCHS),
              SPECT_TASK: tuple(SPECT_ARCHS), TTS_TASK: tuple(TTS_ARCHS),
              S2T_TASK: tuple(S2T_ARCHS), MT_TASK: tuple(MT_ARCHS),
              CMLM_TASK: tuple(CMLM_ARCHS), LEV_TASK: tuple(LEV_ARCHS),
              CTC_TASK: tuple(CTC_ARCHS)}  # the first, the default
# the tasks whose model and data their task builds, on cli.train's flags
TASK_BUILT = (SPECT_TASK, TTS_TASK, S2T_TASK, CTC_TASK) + train_cli.TEXT_TASKS
# the tasks that decode with the AR branch (beam search)
AR_DECODED = (AR_TASK, S2T_TASK, MT_TASK)
# the widths an AR arch gives where the flag is not set
AR_WIDTHS = ("encoder_embed_dim", "encoder_ffn_embed_dim", "encoder_layers",
             "encoder_attention_heads", "decoder_embed_dim", "decoder_ffn_embed_dim",
             "decoder_layers", "decoder_attention_heads")


def strip_special(tokens, dictionary: Dictionary) -> str:
    """Drop bos/pad/eos; map dictionary ids back to raw unit strings."""
    return " ".join(dictionary[int(t)] for t in tokens if int(t) not in (0, PAD, EOS))


def read_init_lengths(path: str) -> Dict[Union[int, str], int]:
    """--init-unit-file: {sentence id (or line number): canvas length}, the
    canvas holding the units and the EOS slot (reference nat_gen.py:110-113)."""
    lengths: Dict[Union[int, str], int] = {}
    with open(path) as f:
        for j, line in enumerate(f):
            line = line.rstrip("\n")
            if not line:
                continue
            if "\t" in line:
                sid, units = line.split("\t", 1)
                key = int(sid) if sid.lstrip("-").isdigit() else sid
            else:
                key, units = j, line
            lengths[key] = len(units.split()) + 1
    return lengths


def init_length(lengths: Dict[Union[int, str], int], sid: int) -> int:
    for key in (int(sid), str(sid)):
        if key in lengths:
            return lengths[key]
    raise KeyError(f"--init-unit-file has no units for utterance id {sid!r}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("data", help="directory of the {split}.tsv manifests (and config.yaml)")
    p.add_argument("--task", default=TASK)
    p.add_argument("--arch", default=None, help="default: the task's first (TASK_ARCHS)")
    p.add_argument("--user-dir", help="a plugin imported before the flags are read "
                                      "(registry.py)")
    p.add_argument("--path", required=True,
                   help="the model's weights (weights.save_npz), or a cli.train step directory; "
                        "a:b:c for an ensemble")
    p.add_argument("--config-yaml", default="config.yaml", help="the data config, under DATA")
    p.add_argument("--gen-subset", default="test")
    p.add_argument("--results-path", default=None)
    p.add_argument("--max-tokens", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--num-workers", type=int, default=0,
                   help="host threads that load the batches (0: one background thread)")
    p.add_argument("--max-target-positions", type=int, default=256)
    p.add_argument("--iter-decode-max-iter", type=int, default=15)
    p.add_argument("--iter-decode-with-beam", type=int, default=1)
    p.add_argument("--iter-decode-force-max-iter", action="store_true")
    p.add_argument("--iter-decode-eos-penalty", type=float, default=0.0,
                   help="the Levenshtein decode's penalty on inserting nothing")
    p.add_argument("--cond-scale", type=float, default=1.0)
    p.add_argument("--init-unit-file", default=None)
    p.add_argument("--scoring", choices=("bleu", "sacrebleu", "wer"), default="bleu")
    p.add_argument("--post-process", help="detokenize D- lines and references "
                                          "(data.encoders.post_process)")
    p.add_argument("--remove-bpe", help="--post-process's other name")
    p.add_argument("--seed", type=int, default=1,
                   help="the --sampling draws' generator (mask-predict draws nothing)")
    p.add_argument("--quant-int8", action="store_true", help="the int8 W8A8 NAR model")
    p.add_argument("--quant-int8-static", action="store_true",
                   help="with --quant-int8: static activation scales, calibrated on the "
                        "first batch")
    p.add_argument("--retain-iter-history", action="store_true",
                   help="E-{id}_{step} lines: each step's filled canvas")
    p.add_argument("--decode-chunk", type=int, default=0,
                   help="decode in sub-batches of this many rows (0: whole batches)")
    p.add_argument("--rerank-path", help="an AR S2UT model that picks the length beam's "
                                         "candidate (NAR, --iter-decode-with-beam > 1)")
    # the AR branch (speech_to_speech_ar)
    p.add_argument("--beam", type=int, default=5)
    p.add_argument("--lenpen", type=float, default=1.0)
    p.add_argument("--min-len", type=int, default=1)
    p.add_argument("--no-repeat-ngram-size", type=int, default=0)
    p.add_argument("--unkpen", type=float, default=0.0)
    p.add_argument("--prefix-size", type=int, default=0)
    p.add_argument("--sampling", action="store_true")
    p.add_argument("--sampling-topk", type=int, default=0)
    p.add_argument("--sampling-topp", type=float, default=0.0)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--score-reference", action="store_true")
    # the two-pass models' first pass (UnitY, Translatotron2)
    p.add_argument("--beam-mt", type=int, default=None, help="default: --beam")
    p.add_argument("--lenpen-mt", type=float, default=1.0)
    p.add_argument("--max-len-b-mt", type=int, default=200, help="at most 256")
    # the spectrogram branch (s2spect, Translatotron2)
    p.add_argument("--eos-prob-threshold", type=float, default=0.5)
    p.add_argument("--vocoder", help="a mel-input vocoder's weights (cli.train_vocoder "
                                     "--input-type features): writes {id}_pred.wav")
    p.add_argument("--vocoder-cfg", help="its config JSON")
    p.add_argument("--sample-rate", type=int, default=16000)
    p.add_argument("--multitask-config-yaml", help="the aux tasks' YAML, relative to DATA")
    add_data_parallel_arg(p)
    add_model_args(p)
    train_cli.add_two_pass_args(p)
    return p


def rerank_overrides(extra: Sequence[str]) -> Dict:
    """The `--rerank-<flag> [value]` arguments as {dest: value} of the model
    flags (and --arch) they set for the reranker."""
    q = argparse.ArgumentParser(prog="--rerank-<flag>")
    q.add_argument("--arch")
    add_model_args(q)
    bad = [a for a in extra if a.startswith("-") and not a.startswith("--rerank-")]
    if bad:
        q.error(f"unrecognized arguments: {' '.join(bad)}")
    given = [a[len("--rerank-"):].replace("-", "_") for a in extra if a.startswith("--rerank-")]
    ns = q.parse_args([("--" + a[len("--rerank-"):]) if a.startswith("--rerank-") else a
                       for a in extra], namespace=argparse.Namespace(**dict.fromkeys(given)))
    return {key: getattr(ns, key) for key in given}


def apply_ar_arch(args: argparse.Namespace) -> argparse.Namespace:
    """The AR arch's defaults into the widths left unset (None)."""
    AR_ARCHS[args.arch](vars(args))
    return args


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """The flags, with `rerank` the reranker's flags where --rerank-path is
    given. Raises NotImplementedError for a task or arch without a decode
    branch."""
    train_cli.preparse(argv)
    p = build_parser()
    chosen, _ = p.parse_known_args(argv)
    task = chosen.task
    if task == S2S_TASK:
        task = AR_TASK if chosen.target_is_code else SPECT_TASK
    archs = TASK_ARCHS.get(task)
    if archs is None or (chosen.arch or archs[0]) not in archs:
        raise NotImplementedError(
            f"--task {chosen.task} --arch {chosen.arch}: no decode branch; cli.generate "
            "decodes " + "; ".join(f"{t} ({', '.join(a)})" for t, a in TASK_ARCHS.items())
            + " (SEDD and the unit LM sample in process and score with cli.eval_lm, the "
              "normalizer generates through cli.diff_norm_synthesis, as in JAX)")
    if task == AR_TASK:  # widths left unset take the arch's
        p.set_defaults(**dict.fromkeys(AR_WIDTHS))
    args, extra = p.parse_known_args(argv)
    args.task, args.arch = task, args.arch or archs[0]
    # UnitY, the spectrogram, TTS and S2T models build through their task,
    # on cli.train's model flags
    args.model = None
    if args.arch in UNITY_ARCHS or task in TASK_BUILT:
        q = train_cli.build_parser("the model's flags", train=False)
        margs, unknown = q.parse_known_args(argv)
        margs.task = task
        args.model = train_cli.check_args(q, margs)
        if args.arch in UNITY_ARCHS and args.n_frames_per_step > 1:
            raise NotImplementedError("unity generation with n_frames_per_step>1 (as JAX's)")
        extra = [a for a in extra if a in unknown]  # the model's flags (--dropout) taken
    overrides = rerank_overrides(extra)
    if args.task == AR_TASK and args.model is None:
        apply_ar_arch(args)
    if args.task != TASK and args.quant_int8:
        p.error("--quant-int8: the int8 model is the NAR one")
    if args.task in train_cli.TEXT_TASKS and args.rerank_path:
        p.error("--rerank-path: the reranker, an AR S2UT model, scores the NAR S2UT decode's "
                "length beam")
    args.rerank = None
    if args.rerank_path:
        rerank = argparse.Namespace(**{**vars(args), **overrides})
        rerank.arch = overrides.get("arch", "s2ut_conformer")
        if rerank.arch not in AR_ARCHS:
            p.error(f"--rerank-arch {rerank.arch}: the reranker is an AR S2UT model")
        args.rerank = apply_ar_arch(rerank)
    return args


def build_ar_model(args: argparse.Namespace, path: str, device: torch.device,
                   dtype: torch.dtype) -> ARS2UTModule:
    """The AR S2UT model of the shape flags with the weights of `path` (a
    `weights.save_npz` file or a cli.train step directory), without a
    checkpoint's aux heads (`mt_*`, which no decode runs), in eval mode."""
    with torch.device(device):
        model = ARS2UTModule(
            vocab_size=args.target_code_size + 4, in_channels=args.input_feat_per_channel,
            encoder_dim=args.encoder_embed_dim, encoder_ffn_dim=args.encoder_ffn_embed_dim,
            encoder_layers=args.encoder_layers, encoder_heads=args.encoder_attention_heads,
            decoder_dim=args.decoder_embed_dim, decoder_ffn_dim=args.decoder_ffn_embed_dim,
            decoder_layers=args.decoder_layers, decoder_heads=args.decoder_attention_heads,
            depthwise_kernel_size=args.depthwise_conv_kernel_size,
            encoder_type=args.encoder_type, conv_channels=args.conv_channels,
            conv_kernel_sizes=tuple(int(k) for k in args.conv_kernel_sizes.split(",")),
            n_frames_per_step=args.n_frames_per_step,
            target_speaker_embed=args.target_speaker_embed,
            speaker_embed_dim=args.speaker_embed_dim)
    variables = load_variables(path)
    variables["params"] = {k: v for k, v in variables["params"].items()
                           if not k.startswith("mt_")}
    from_jax_variables(model, variables)
    return model.to(dtype).eval()


def build_task_model(args: argparse.Namespace, path: str, device: torch.device,
                     dtype: torch.dtype):
    """(task, model) of UnitY or a spectrogram model: built by its task from
    cli.train's model flags (`args.model`), every weight of `path` loaded
    (the aux heads' too), in eval mode."""
    task = TASKS[args.model.task](args.model)
    with torch.device(device):
        model = task.build_model()
    from_jax_variables(model, load_variables(path))
    return task, model.to(dtype).eval()


def unity_decoder(args: argparse.Namespace, model, device: torch.device):
    """The UnitY decode of a batch (fn(batch) -> (tokens [B, L], scores [B,
    L], steps [B]) numpy): both beam passes, the first with --beam-mt,
    --lenpen-mt and --max-len-b-mt (JAX cli/generate.py:277-310)."""
    def decode(batch):
        spk = batch.get("tgt_speaker")
        seqs, scores, _ = unity_generate(
            model, batch["src_tokens"], batch["src_lengths"], beam_size=args.beam,
            beam_size_mt=args.beam_mt or args.beam, max_len=min(args.max_target_positions, 256),
            max_len_mt=min(args.max_len_b_mt, 256), min_len=args.min_len,
            len_penalty=args.lenpen, len_penalty_mt=args.lenpen_mt,
            no_repeat_ngram=args.no_repeat_ngram_size, unk_penalty=args.unkpen,
            tgt_speaker=None if spk is None else torch.from_numpy(spk).to(device))
        best = seqs[:, 0]
        return (best.cpu().numpy(), scores[:, :1].expand_as(best).float().cpu().numpy(),
                np.ones(best.shape[0], np.int32))

    return decode


def feature_vocoder(args: argparse.Namespace, device: torch.device, dtype: torch.dtype):
    """--vocoder: frames [n, D] -> waveform, a FeatureGenerator (the
    `--input-type features` fine-tune of cli.train_vocoder) whose input width
    is the config's model_in_dim, else --output-frame-dim."""
    import json

    from diffnorm_tpu_torch.cli.train_vocoder import build_generator

    with open(args.vocoder_cfg) as f:
        vcfg = json.load(f)
    vcfg.setdefault("model_in_dim", args.model.output_frame_dim)
    with torch.device(device):
        gen = build_generator(vcfg, input_type="features")
    tree = load_tree(args.vocoder)
    from_jax_variables(gen, {"params": tree["g_params"]} if "g_params" in tree
                       else as_variables(tree))
    gen = gen.to(dtype).eval()

    @torch.no_grad()
    def vocode(feat: np.ndarray) -> np.ndarray:
        return gen(torch.from_numpy(feat).to(device, dtype)[None]).float().cpu().numpy()[0]

    return vocode


def spectrogram_generate(args: argparse.Namespace, device: torch.device,
                         dtype: torch.dtype) -> int:
    """The spectrogram branch (JAX cli/generate.py:_tts_generate): each
    utterance's frames to `{results_path}/{id}.npy`, with --vocoder its
    waveform to `{id}_pred.wav`; Translatotron2 logs each first-pass
    hypothesis as `MT-{id}\t{text}`. The AR rollout runs
    --max-target-positions steps; the prenet draws from one generator
    seeded with --seed, batch after batch. FastSpeech2 runs its forward on
    predicted variances over its frame buffer, each row cut by its frame
    mask."""
    paths = [p for p in args.path.split(":") if p]
    if len(paths) > 1:
        logger.warning("spectrogram generation uses the first model of the ensemble")
    task, model = build_task_model(args, paths[0], device, dtype)
    logger.info("restored checkpoint from %s", paths[0])
    nar_gen = None
    if isinstance(model, FastSpeech2Module):
        nar_gen = NonARSpeechGenerator(model)
    if args.arch in S2SPECT2_ARCHS:
        mt_dict = task.multitask_tasks[task.mt_task_name].tgt_dict
        gen = Translatotron2SpeechGenerator(
            model, max_iter=args.max_target_positions,
            eos_prob_threshold=args.eos_prob_threshold, beam_size_mt=args.beam_mt or args.beam,
            max_len_mt=min(args.max_len_b_mt, 256), len_penalty_mt=args.lenpen_mt,
            no_repeat_ngram=args.no_repeat_ngram_size)
    else:
        mt_dict = None
        gen = ARSpeechGenerator(model, max_iter=args.max_target_positions,
                                eos_prob_threshold=args.eos_prob_threshold)
    vocode = feature_vocoder(args, device, dtype) if args.vocoder else None
    results = args.results_path or "tts_out"
    os.makedirs(results, exist_ok=True)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    itr = EpochBatchIterator(task.dataset(args.gen_subset), max_tokens=args.max_tokens,
                             max_sentences=args.batch_size, shuffle=False,
                             num_workers=args.num_workers)
    n_utts, n_frames, t0 = 0, 0, time.time()
    for batch in itr.next_epoch_itr():
        src = torch.from_numpy(batch["src_tokens"]).to(device)
        if nar_gen is not None:
            out = nar_gen.generate(src)
            entries = [{"feature": feat[mask]}
                       for feat, mask in zip(out["feature"], out["frame_mask"])]
        else:
            entries = gen.generate(src, torch.from_numpy(batch["src_lengths"]).to(device),
                                   generator)
        for sid, entry in zip(batch["id"].tolist(), entries):
            if mt_dict is not None:
                logger.info("MT-%d\t%s", sid, " ".join(mt_dict[int(t)]
                                                       for t in entry["mt_tokens"]))
            feat = np.asarray(entry["feature"], np.float32)
            np.save(os.path.join(results, f"{sid}.npy"), feat)
            if vocode is not None and feat.shape[0] > 0:
                write_wav(os.path.join(results, f"{sid}_pred.wav"), vocode(feat),
                          args.sample_rate)
            n_frames += feat.shape[0]
            n_utts += 1
    logger.info("synthesized %d utterances (%d frames, %.1f avg) in %.1fs -> %s", n_utts,
                n_frames, n_frames / max(n_utts, 1), time.time() - t0, results)
    return 0


def ar_decoder(args: argparse.Namespace, models, device: torch.device):
    """The AR branch's decode of a batch: (fn(batch) -> (tokens [B, L],
    scores [B, L], steps [B]) numpy, the beam the summary line names)."""
    max_len = min(args.max_target_positions, 256)

    def out(tokens, scores):
        return (tokens.cpu().numpy(), scores.float().cpu().numpy(),
                np.ones(tokens.shape[0], np.int32))

    def speaker(batch):
        spk = batch.get("tgt_speaker")
        return None if spk is None else torch.from_numpy(spk).to(device)

    if args.n_frames_per_step > 1:
        if len(models) > 1:
            logger.warning("stacked-unit generation uses the first model of the ensemble")

        def decode(batch):
            _, sub = ar_generate_stacked(models[0], batch["src_tokens"], batch["src_lengths"],
                                         max_len=max_len, tgt_speaker=speaker(batch))
            tokens = sub.reshape(sub.shape[0], -1)  # the full-rate units
            return out(tokens, torch.zeros(tokens.shape))

        return decode, args.iter_decode_with_beam
    if args.score_reference:
        @torch.no_grad()
        def decode(batch):
            target = torch.from_numpy(batch["target"]).to(device).long()
            prev = torch.from_numpy(shift_right(batch["target"])).to(device).long()
            lps = [torch.log_softmax(m(batch["src_tokens"], batch["src_lengths"], prev,
                                       tgt_speaker=speaker(batch))["logits"].float(), dim=-1)
                   for m in models]
            lp = average_log_probs(lps)
            return out(target, lp.gather(-1, target[..., None])[..., 0])

        return decode, args.iter_decode_with_beam
    generator = (torch.Generator(device=device).manual_seed(args.seed) if args.sampling
                 else None)

    def decode(batch):
        prefix = None
        if args.prefix_size > 0:
            prefix = torch.from_numpy(batch["target"][:, :args.prefix_size]).to(device)
        seqs, scores = ar_generate(
            models, batch["src_tokens"], batch["src_lengths"], beam_size=args.beam,
            max_len=max_len, min_len=args.min_len, len_penalty=args.lenpen,
            no_repeat_ngram=args.no_repeat_ngram_size, unk_penalty=args.unkpen,
            prefix_tokens=prefix, sampling=args.sampling, sampling_topk=args.sampling_topk,
            sampling_topp=args.sampling_topp, temperature=args.temperature,
            generator=generator, tgt_speaker=speaker(batch))
        best = seqs[:, 0]
        return out(best, scores[:, :1].expand_as(best))

    return decode, args.beam


def ctc_decoder(models):
    """The greedy CTC decode of a batch (JAX cli/generate.py:355-375):
    tokens and scores [B, F] and one step a row, numpy."""
    def decode(batch):
        tokens, scores = ctc_greedy_decode(models, batch["src_tokens"], batch["src_lengths"])
        return (tokens.cpu().numpy(), scores.cpu().numpy(),
                np.ones(tokens.shape[0], np.int32))

    return decode


def levenshtein_decoder(args: argparse.Namespace, models):
    """The Levenshtein transformer's decode of a batch (JAX
    cli/generate.py:254-266): the canvas, zero scores and --iter-decode-max-iter
    steps a row, numpy."""
    def decode(batch):
        canvas = levenshtein_decode(
            models, batch["src_tokens"], batch["src_lengths"],
            max_iter=args.iter_decode_max_iter, max_len=min(args.max_target_positions, 256),
            eos_penalty=args.iter_decode_eos_penalty).cpu().numpy()
        return (canvas, np.zeros(canvas.shape, np.float32),
                np.full(canvas.shape[0], args.iter_decode_max_iter, np.int32))

    return decode


def main(argv: Optional[Sequence[str]] = None) -> int:
    enable_compile_cache()
    logging.basicConfig(level=logging.INFO, force=True,
                        format="%(asctime)s | %(levelname)s | %(message)s")
    args = parse_args(argv)
    device, dtype = resolve_device_dtype(args)
    mesh = data_parallel_mesh(args)
    if mesh.data > 1 and (args.task in (SPECT_TASK, TTS_TASK, LEV_TASK, CTC_TASK)
                          or args.task in AR_DECODED or args.arch in UNITY_ARCHS
                          or args.quant_int8_static):
        raise NotImplementedError("--data-parallel splits the NAR mask-predict decode alone "
                                  "(without --quant-int8-static)")
    if args.task in (SPECT_TASK, TTS_TASK):
        return spectrogram_generate(args, device, dtype)
    split = args.gen_subset
    paths = [p for p in args.path.split(":") if p]
    if args.task in TASK_BUILT:  # the dictionary and the data are the task's
        task = TASKS[args.task](args.model)
        tgt_dict, dataset = task.tgt_dict, task.dataset(split)
    else:
        tgt_dict = Dictionary.unit_dictionary(args.target_code_size)
        dataset = SpeechToUnitDataset.from_tsv(args.data, split, tgt_dict=tgt_dict,
                                               config_yaml=args.config_yaml)
    ar = args.task in AR_DECODED
    if args.task in TASK_BUILT:
        models = [build_task_model(args, p, device, dtype)[1] for p in paths]
    elif args.arch in UNITY_ARCHS:
        if len(paths) > 1:
            logger.warning("unity generation uses the first model of the ensemble")
            paths = paths[:1]
        models = [build_task_model(args, paths[0], device, dtype)[1]]
    elif ar:
        models = [build_ar_model(args, p, device, dtype) for p in paths]
    else:
        models = [build_model(args, p, device, dtype, quant_int8=args.quant_int8)
                  for p in paths]
    if len(models) > 1:
        logger.info("restored %d-model ensemble from %s", len(models), ", ".join(paths))
    else:
        logger.info("restored checkpoint from %s", paths[0])
    calibrate = args.quant_int8 and args.quant_int8_static
    pp_symbol = args.post_process or args.remove_bpe
    # a batch's decode where it is not mask-predict's (which the loop drives)
    init_lengths = reranker = decode_batch = None
    if args.arch in UNITY_ARCHS:
        decode_batch, beam = unity_decoder(args, models[0], device), args.beam
    elif ar:
        decode_batch, beam = ar_decoder(args, models, device)
    elif args.task == LEV_TASK:
        decode_batch, beam = levenshtein_decoder(args, models), args.iter_decode_with_beam
    elif args.task == CTC_TASK:
        decode_batch, beam = ctc_decoder(models), args.iter_decode_with_beam
    else:
        beam = args.iter_decode_with_beam
        if args.init_unit_file:
            init_lengths = read_init_lengths(args.init_unit_file)
            logger.info("forcing canvas lengths from %s (%d utts)", args.init_unit_file,
                        len(init_lengths))
        if args.rerank and beam > 1:
            reranker = build_ar_model(args.rerank, args.rerank_path, device, dtype)
            logger.info("reranking beam=%d with AR model from %s", beam, args.rerank_path)

    out_f = sys.stdout
    if mesh.index:  # rank 0 writes
        out_f = open(os.devnull, "w")
    elif args.results_path:
        os.makedirs(args.results_path, exist_ok=True)
        out_f = open(os.path.join(args.results_path, f"generate-{split}.txt"), "w")
    try:
        bleu, wer, sb_hyps, sb_refs = BleuAccumulator(), WerAccumulator(), [], []
        n_sent, total_steps, t0 = 0, 0, time.time()
        itr = EpochBatchIterator(dataset, max_tokens=args.max_tokens,
                                 max_sentences=args.batch_size, shuffle=False,
                                 num_workers=args.num_workers)

        def upload(batch: Dict) -> Dict:
            """The batch with its sources on the card (started ahead of
            their decode)."""
            return {**batch, **{key: torch.from_numpy(batch[key]).to(device, non_blocking=True)
                                for key in ("src_tokens", "src_lengths")}}

        for batch in read_ahead(itr.next_epoch_itr(), upload, depth=2):
            if calibrate:
                target = batch.get("target")
                if target is not None:
                    target = torch.from_numpy(target).to(device)
                for model in models:
                    calibrate_act_scales(model, batch["src_tokens"], batch["src_lengths"],
                                         target)
                    set_static_scales(model, True)
                logger.info("calibrated static int8 activation scales on the first batch")
                calibrate = False
            history = None
            if decode_batch is not None:
                tokens, scores, steps = decode_batch(batch)
            else:
                true_length = None
                if init_lengths is not None:
                    true_length = torch.tensor([init_length(init_lengths, int(i))
                                                for i in batch["id"]], device=device)
                tgt_speaker = batch.get("tgt_speaker")
                out = mask_predict_decode_chunked(
                    models, batch["src_tokens"], batch["src_lengths"], chunk=args.decode_chunk,
                    max_iter=args.iter_decode_max_iter,
                    max_len=min(args.max_target_positions, 256), cond_scale=args.cond_scale,
                    length_beam=beam, true_length=true_length,
                    adaptive=not args.iter_decode_force_max_iter,
                    tgt_speaker=(None if tgt_speaker is None
                                 else torch.from_numpy(tgt_speaker).to(device)),
                    retain_history=args.retain_iter_history, reranker=reranker, mesh=mesh)
                tokens, scores, steps = (t.cpu().numpy() for t in out[:3])
                history = out[3].cpu().numpy() if args.retain_iter_history else None
            total_steps += int(steps.sum())
            for i, sid in enumerate(batch["id"].tolist()):
                hyp = strip_special(tokens[i], tgt_dict)
                ref = strip_special(batch["target"][i].reshape(-1), tgt_dict)
                keep = tokens[i] != PAD
                score = float(scores[i][keep].mean()) if keep.any() else 0.0
                hyp_d = hyp
                if pp_symbol:
                    hyp_d, ref = post_process(hyp, pp_symbol), post_process(ref, pp_symbol)
                print(f"T-{sid}\t{ref}", file=out_f)
                print(f"H-{sid}\t{score:.4f}\t{hyp}", file=out_f)
                print(f"D-{sid}\t{score:.4f}\t{hyp_d}", file=out_f)
                if history is not None:  # fairseq's retain_iter_history lines
                    for st in range(history.shape[0]):
                        print(f"E-{sid}_{st}\t{strip_special(history[st, i], tgt_dict)}",
                              file=out_f)
                if args.scoring == "sacrebleu":
                    sb_hyps.append(hyp_d)
                    sb_refs.append(ref)
                elif args.scoring == "wer":
                    wer.add(ref, hyp_d)
                else:
                    bleu.add(ref.split(), hyp_d.split())
                n_sent += 1
        wall = time.time() - t0
        logger.info("decoded %d sentences in %.1fs (%.2f sent/s, avg %.1f iters)",
                    n_sent, wall, n_sent / max(wall, 1e-6), total_steps / max(n_sent, 1))
        if args.scoring == "sacrebleu":
            import sacrebleu

            score_str = str(sacrebleu.corpus_bleu(sb_hyps, [sb_refs]))
        elif args.scoring == "wer":
            score_str = wer.result_string()
        else:
            score_str = bleu.result_string()
        logger.info("Generate %s with beam=%d: %s", split, beam, score_str)
        if args.results_path:
            print(f"Generate {split} with beam={beam}: {score_str}", file=out_f)
    finally:
        if out_f is not sys.stdout:
            out_f.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
