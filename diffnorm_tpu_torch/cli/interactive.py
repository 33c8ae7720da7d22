"""Translate lines from stdin (the port of diffnorm_tpu/cli/interactive.py;
reference fairseq_cli/interactive.py): each non-empty line is tokenized and
BPE-encoded where --tokenizer / --bpe are given (`data/encoders.py`),
encoded through the source dictionary (</s> appended), decoded alone, and
printed as `H-{i}\\t{hypothesis}` (i the line's number from 0), with
`D-{i}\\t{detokenized}` after it where a tokenizer or BPE is set.

  python -m diffnorm_tpu_torch.cli.interactive DATA --task translation \\
      --arch transformer_wmt_en_de_big --path ckpt/step_000100000 \\
      --source-lang en --target-lang de --beam 4 --lenpen 0.6 \\
      [--tokenizer moses --bpe subword_nmt --bpe-codes codes] < input.txt

DATA holds the dictionaries (cli.preprocess's dict.{lang}.txt); the model's
flags are cli.train's and the decode's cli.generate's. The route is JAX's
(interactive.py:52-86): the AR transformer (`--task translation`) by beam
search (`--beam`, `--lenpen`, `--no-repeat-ngram-size`, at most
min(--max-target-positions, 256) steps), the text CMLM (`--task cmlm_cg`)
by mask-predict (`--iter-decode-max-iter`, `--cond-scale`, a canvas of
--max-target-positions). The Levenshtein transformer (`--task
translation_lev`), which JAX's CLI sends to mask-predict, where it fails
(its model has no length head), decodes here with
`models.levenshtein.levenshtein_decode` (`--iter-decode-max-iter`,
`--iter-decode-eos-penalty`; its BOS is left out of the line). The speech
tasks read each line as an audio or .npy path (`data.audio.
get_features_or_waveform`: the fbank of a waveform, a .npy dump as it is)
and decode its units: NAR S2UT (`--task speech_to_speech_fasttranslate`)
by mask-predict, AR S2UT (`--task speech_to_speech_ar`) by beam search, as
the text CMLM and the AR transformer; another speech task raises
NotImplementedError (JAX's sends it to mask-predict, where its model has
no length head). A hypothesis leaves out PAD and EOS. `--user-dir` imports
a plugin first. Runs on the GPU (bf16 unless --dtype says otherwise)
unless --cpu is given, which runs in float32.
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from diffnorm_tpu_torch.cli import generate
from diffnorm_tpu_torch.cli import train as train_cli
from diffnorm_tpu_torch.cli.s2st import resolve_device_dtype
from diffnorm_tpu_torch.data.audio import get_features_or_waveform
from diffnorm_tpu_torch.data.dictionary import Dictionary
from diffnorm_tpu_torch.data.encoders import build_bpe, build_tokenizer, decode_fn, encode_fn
from diffnorm_tpu_torch.generate.beam_search import ar_generate
from diffnorm_tpu_torch.generate.mask_predict import mask_predict_decode
from diffnorm_tpu_torch.models.levenshtein import levenshtein_decode
from diffnorm_tpu_torch.models.unity import ARCHS as UNITY_ARCHS
from diffnorm_tpu_torch.tasks import TASKS
from diffnorm_tpu_torch.utils.compile_cache import enable_compile_cache

logger = logging.getLogger("diffnorm_tpu_torch.interactive")

PAD, EOS = 1, 2
SPEECH_TASKS = (train_cli.NAR_TASK, train_cli.AR_TASK)  # their lines name utterances
# the encoders' flags (data/encoders.py reads them by these names)
ENCODER_FLAGS = ("--tokenizer", "--bpe", "--bpe-codes", "--bpe-separator",
                 "--sentencepiece-model", "--gpt2-encoder-json", "--gpt2-vocab-bpe",
                 "--bpe-vocab-file")
ENCODER_SWITCHES = ("--bpe-cased", "--moses-no-dash-splits", "--moses-no-escape")


def parse_args(argv: Optional[Sequence[str]] = None):
    """(cli.generate's arguments, the encoders' configuration)."""
    p = argparse.ArgumentParser(add_help=False)
    for flag in ENCODER_FLAGS:
        p.add_argument(flag)
    for flag in ENCODER_SWITCHES:
        p.add_argument(flag, action="store_true")
    enc, rest = p.parse_known_args(argv)
    args = generate.parse_args(rest)
    if args.task not in train_cli.TEXT_TASKS + SPEECH_TASKS or args.arch in UNITY_ARCHS:
        raise NotImplementedError(
            f"--task {args.task} --arch {args.arch}: cli.interactive takes text lines for "
            f"{', '.join(train_cli.TEXT_TASKS)} and audio or .npy paths for "
            f"{', '.join(SPEECH_TASKS)} (the one-pass models)")
    if args.task in SPEECH_TASKS:
        return args, vars(enc)
    cfg = {**vars(enc), "source_lang": args.model.source_lang,
           "target_lang": args.model.target_lang}
    return args, cfg


def decoder(args, models):
    """fn(src [1, S], src_lengths [1]) -> the hypothesis's tokens [L] of the
    task's route (module docstring)."""
    if args.task in (train_cli.MT_TASK, train_cli.AR_TASK):
        def decode(src, lengths):
            seqs, _ = ar_generate(models, src, lengths, beam_size=args.beam,
                                  max_len=min(args.max_target_positions, 256),
                                  len_penalty=args.lenpen,
                                  no_repeat_ngram=args.no_repeat_ngram_size)
            return seqs[0, 0]
    elif args.task in (train_cli.CMLM_TASK, train_cli.NAR_TASK):
        def decode(src, lengths):
            return mask_predict_decode(models, src, lengths, max_iter=args.iter_decode_max_iter,
                                       max_len=args.max_target_positions,
                                       cond_scale=args.cond_scale)[0][0]
    else:
        def decode(src, lengths):
            canvas = levenshtein_decode(models, src, lengths,
                                        max_iter=args.iter_decode_max_iter,
                                        max_len=min(args.max_target_positions, 256),
                                        eos_penalty=args.iter_decode_eos_penalty)[0]
            return canvas[1:]  # the BOS the canvas starts with
    return decode


def main(argv: Optional[Sequence[str]] = None) -> int:
    enable_compile_cache()
    logging.basicConfig(level=logging.INFO, force=True)
    args, enc_cfg = parse_args(argv)
    device, dtype = resolve_device_dtype(args)
    paths = [p for p in args.path.split(":") if p]
    if args.task == train_cli.NAR_TASK:
        models = [generate.build_model(args, p, device, dtype) for p in paths]
    elif args.task == train_cli.AR_TASK:
        models = [generate.build_ar_model(args, p, device, dtype) for p in paths]
    else:
        models = [generate.build_task_model(args, p, device, dtype)[1] for p in paths]
    logger.info("restored %s", args.path)
    if args.task in SPEECH_TASKS:
        src_dict, tgt_dict = None, Dictionary.unit_dictionary(args.target_code_size)
    else:
        task = TASKS[args.task](args.model)
        src_dict, tgt_dict = task.src_dict, task.tgt_dict
    tokenizer, bpe = build_tokenizer(enc_cfg), build_bpe(enc_cfg)
    decode = decoder(args, models)
    print("| enter input (text tokens, or audio/.npy path); ctrl-d to quit", file=sys.stderr)
    for i, line in enumerate(sys.stdin):
        line = line.strip()
        if not line:
            continue
        if src_dict is None:  # a speech task: the line names an utterance
            src = torch.from_numpy(np.asarray(get_features_or_waveform(line), np.float32)
                                   )[None].to(device)
        else:
            ids = src_dict.encode_line(encode_fn(line, bpe=bpe, tokenizer=tokenizer))
            src = torch.from_numpy(ids[None]).long().to(device)
        lengths = torch.tensor([src.shape[1]], device=device)
        tokens = decode(src, lengths).tolist()
        hyp = " ".join(tgt_dict[t] for t in tokens if t not in (PAD, EOS))
        print(f"H-{i}\t{hyp}")
        if bpe is not None or tokenizer is not None:
            print(f"D-{i}\t{decode_fn(hyp, bpe=bpe, tokenizer=tokenizer)}")
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
