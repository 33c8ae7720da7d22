"""Generation CLI, the NAR S2UT branch (PyTorch port of
diffnorm_tpu/cli/generate.py; reference fairseq_cli/generate.py).

  python -m diffnorm_tpu_torch.cli.generate $DATA \\
      --task speech_to_speech_fasttranslate --target-code-size 1000 \\
      --arch nar_s2ut_conformer --path ckpt/nar/step_000400000 \\
      --gen-subset test --max-tokens 20000 --iter-decode-max-iter 15 \\
      --cond-scale 1.0 --results-path results/

Decodes `{gen_subset}.tsv` under DATA with mask-predict
(`generate/mask_predict.py`) in batches of `--max-tokens` source frames
(and at most `--batch-size` sentences), in the dataset's order (descending
source length), and writes `generate-{split}.txt` under --results-path
(stdout without it) with fairseq's lines per sentence: `T-{id}\\t{ref}`,
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

Not ported, and raising NotImplementedError: the other tasks and
architectures (AR S2UT, UnitY, TTS, LevT) and the AR reranker
(--rerank-path), ROADMAP Queue 1 item 4.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time
from typing import Dict, Optional, Sequence, Union

import torch

from diffnorm_tpu_torch.cli.s2st import add_model_args, build_model, resolve_device_dtype
from diffnorm_tpu_torch.data.dictionary import Dictionary
from diffnorm_tpu_torch.data.encoders import post_process
from diffnorm_tpu_torch.data.iterators import EpochBatchIterator, read_ahead
from diffnorm_tpu_torch.data.s2s_dataset import SpeechToUnitDataset
from diffnorm_tpu_torch.eval.bleu import BleuAccumulator
from diffnorm_tpu_torch.eval.wer import WerAccumulator
from diffnorm_tpu_torch.generate.mask_predict import mask_predict_decode_chunked
from diffnorm_tpu_torch.models.nar_transformer import calibrate_act_scales
from diffnorm_tpu_torch.ops.quant import set_static_scales

logger = logging.getLogger("diffnorm_tpu_torch.generate")

PAD, EOS = 1, 2
TASK, ARCH = "speech_to_speech_fasttranslate", "nar_s2ut_conformer"
# flags of the JAX CLI's other branches: flag -> the ROADMAP item that ports it
UNPORTED = {"--rerank-path": "Queue 1 item 4 (the AR reranker)"}


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


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("data", help="directory of the {split}.tsv manifests (and config.yaml)")
    p.add_argument("--task", default=TASK)
    p.add_argument("--arch", default=ARCH)
    p.add_argument("--path", required=True,
                   help="NAR S2UT weights (weights.save_npz), or a cli.train step directory; "
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
    p.add_argument("--cond-scale", type=float, default=1.0)
    p.add_argument("--init-unit-file", default=None)
    p.add_argument("--scoring", choices=("bleu", "sacrebleu", "wer"), default="bleu")
    p.add_argument("--post-process", help="detokenize D- lines and references "
                                          "(data.encoders.post_process)")
    p.add_argument("--remove-bpe", help="--post-process's other name")
    p.add_argument("--seed", type=int, default=1, help="accepted; mask-predict draws nothing")
    p.add_argument("--quant-int8", action="store_true", help="the int8 W8A8 NAR model")
    p.add_argument("--quant-int8-static", action="store_true",
                   help="with --quant-int8: static activation scales, calibrated on the "
                        "first batch")
    p.add_argument("--retain-iter-history", action="store_true",
                   help="E-{id}_{step} lines: each step's filled canvas")
    p.add_argument("--decode-chunk", type=int, default=0,
                   help="decode in sub-batches of this many rows (0: whole batches)")
    add_model_args(p)
    for flag in UNPORTED:
        p.add_argument(flag, nargs="?", const=True, default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    for flag, item in UNPORTED.items():
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            raise NotImplementedError(f"{flag} is not ported (ROADMAP {item})")
    if args.task != TASK or args.arch != ARCH:
        raise NotImplementedError(
            f"--task {args.task} --arch {args.arch}: only the NAR S2UT branch ({TASK}, {ARCH}) "
            "is ported (ROADMAP Queue 1 item 4)")
    return args


def main(argv: Optional[Sequence[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO, force=True,
                        format="%(asctime)s | %(levelname)s | %(message)s")
    args = parse_args(argv)
    device, dtype = resolve_device_dtype(args)
    split, beam = args.gen_subset, args.iter_decode_with_beam
    tgt_dict = Dictionary.unit_dictionary(args.target_code_size)
    dataset = SpeechToUnitDataset.from_tsv(args.data, split, tgt_dict=tgt_dict,
                                           config_yaml=args.config_yaml)
    paths = [p for p in args.path.split(":") if p]
    models = [build_model(args, p, device, dtype, quant_int8=args.quant_int8) for p in paths]
    if len(models) > 1:
        logger.info("restored %d-model ensemble from %s", len(models), ", ".join(paths))
    else:
        logger.info("restored checkpoint from %s", paths[0])
    calibrate = args.quant_int8 and args.quant_int8_static
    pp_symbol = args.post_process or args.remove_bpe
    init_lengths = None
    if args.init_unit_file:
        init_lengths = read_init_lengths(args.init_unit_file)
        logger.info("forcing canvas lengths from %s (%d utts)", args.init_unit_file,
                    len(init_lengths))

    out_f = sys.stdout
    if args.results_path:
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
            true_length = None
            if init_lengths is not None:
                true_length = torch.tensor([init_length(init_lengths, int(i))
                                            for i in batch["id"]], device=device)
            tgt_speaker = batch.get("tgt_speaker")
            out = mask_predict_decode_chunked(
                models, batch["src_tokens"], batch["src_lengths"], chunk=args.decode_chunk,
                max_iter=args.iter_decode_max_iter, max_len=min(args.max_target_positions, 256),
                cond_scale=args.cond_scale, length_beam=beam, true_length=true_length,
                adaptive=not args.iter_decode_force_max_iter,
                tgt_speaker=(None if tgt_speaker is None
                             else torch.from_numpy(tgt_speaker).to(device)),
                retain_history=args.retain_iter_history)
            tokens, scores, steps = (t.cpu().numpy() for t in out[:3])
            history = out[3].cpu().numpy() if args.retain_iter_history else None
            total_steps += int(steps.sum())
            for i, sid in enumerate(batch["id"].tolist()):
                hyp = strip_special(tokens[i], tgt_dict)
                ref = strip_special(batch["target"][i], tgt_dict)
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
