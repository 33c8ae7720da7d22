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
`--iter-decode-eos-penalty`; its BOS is left out of the line). A
hypothesis leaves out PAD and EOS. The speech tasks' inputs (audio or .npy
paths) are not taken yet: they raise NotImplementedError (ROADMAP Queue 1
item 7). Runs on the GPU (bf16 unless --dtype says otherwise) unless --cpu
is given, which runs in float32.
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import Optional, Sequence

import torch

from diffnorm_tpu_torch.cli import generate
from diffnorm_tpu_torch.cli import train as train_cli
from diffnorm_tpu_torch.cli.s2st import resolve_device_dtype
from diffnorm_tpu_torch.data.encoders import build_bpe, build_tokenizer, decode_fn, encode_fn
from diffnorm_tpu_torch.generate.beam_search import ar_generate
from diffnorm_tpu_torch.generate.mask_predict import mask_predict_decode
from diffnorm_tpu_torch.models.levenshtein import levenshtein_decode
from diffnorm_tpu_torch.tasks import TASKS

logger = logging.getLogger("diffnorm_tpu_torch.interactive")

PAD, EOS = 1, 2
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
    if args.task not in train_cli.TEXT_TASKS:
        raise NotImplementedError(
            f"--task {args.task}: cli.interactive takes text lines for "
            f"{', '.join(train_cli.TEXT_TASKS)}; the speech tasks' audio and .npy inputs "
            f"are not ported (ROADMAP Queue 1 item 7)")
    cfg = {**vars(enc), "source_lang": args.model.source_lang,
           "target_lang": args.model.target_lang}
    return args, cfg


def decoder(args, models):
    """fn(src [1, S], src_lengths [1]) -> the hypothesis's tokens [L] of the
    task's route (module docstring)."""
    if args.task == train_cli.MT_TASK:
        def decode(src, lengths):
            seqs, _ = ar_generate(models, src, lengths, beam_size=args.beam,
                                  max_len=min(args.max_target_positions, 256),
                                  len_penalty=args.lenpen,
                                  no_repeat_ngram=args.no_repeat_ngram_size)
            return seqs[0, 0]
    elif args.task == train_cli.CMLM_TASK:
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
    logging.basicConfig(level=logging.INFO, force=True)
    args, enc_cfg = parse_args(argv)
    device, dtype = resolve_device_dtype(args)
    task = TASKS[args.task](args.model)
    paths = [p for p in args.path.split(":") if p]
    models = [generate.build_task_model(args, p, device, dtype)[1] for p in paths]
    logger.info("restored %s", args.path)
    tokenizer, bpe = build_tokenizer(enc_cfg), build_bpe(enc_cfg)
    decode = decoder(args, models)
    print("| enter input (text tokens); ctrl-d to quit", file=sys.stderr)
    for i, line in enumerate(sys.stdin):
        line = line.strip()
        if not line:
            continue
        ids = task.src_dict.encode_line(encode_fn(line, bpe=bpe, tokenizer=tokenizer))
        src = torch.from_numpy(ids[None]).long().to(device)
        lengths = torch.tensor([len(ids)], device=device)
        tokens = decode(src, lengths).tolist()
        hyp = " ".join(task.tgt_dict[t] for t in tokens if t not in (PAD, EOS))
        print(f"H-{i}\t{hyp}")
        if bpe is not None or tokenizer is not None:
            print(f"D-{i}\t{decode_fn(hyp, bpe=bpe, tokenizer=tokenizer)}")
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
