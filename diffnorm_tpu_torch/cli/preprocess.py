"""Binarize a bitext (the port of diffnorm_tpu/cli/preprocess.py; reference
fairseq_cli/preprocess.py): build the dictionaries from the training text
and write each split's token files. Host code, no device.

  python -m diffnorm_tpu_torch.cli.preprocess --source-lang de --target-lang en \\
      --trainpref data/train --validpref data/valid --testpref data/test \\
      --destdir data-bin [--joined-dictionary] [--thresholdsrc N --thresholdtgt N] \\
      [--srcdict D --tgtdict D] [--dataset-impl mmap|native]

Writes `dict.{lang}.txt` (the symbols by descending count, ties in
alphabetical order, those below the threshold left out) and
`{split}.{src}-{tgt}.{lang}.bin/.idx` for train, valid and test, each line
encoded through its dictionary (an unknown token is <unk>, </s> appended),
byte for byte as JAX's CLI: `--dataset-impl mmap` (the default) in
fairseq's mmap layout, which fairseq reads, `native` in the JAX package's
first layout. `--srcdict` / `--tgtdict` take a dictionary file in place of
building one; `--joined-dictionary` builds one from both sides' training
text (at --thresholdsrc) and uses it for both. cli.train, cli.validate and
cli.generate read the directory with `--source-lang` / `--target-lang`.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import Iterable, Optional, Sequence

from diffnorm_tpu_torch.data.dictionary import Dictionary
from diffnorm_tpu_torch.data.indexed_dataset import binarize_file

logger = logging.getLogger("diffnorm_tpu_torch.preprocess")


def build_dictionary(paths: Iterable[str], threshold: int = 0) -> Dictionary:
    """The symbols of the files with their counts, by descending count and
    then alphabetically, those counted fewer than `threshold` times left
    out."""
    counts = {}
    for path in paths:
        with open(path) as f:
            for line in f:
                for w in line.split():
                    counts[w] = counts.get(w, 0) + 1
    d = Dictionary()
    for w, c in sorted(counts.items(), key=lambda kv: (-kv[1], kv[0])):
        if c >= threshold:
            d.add_symbol(w, n=c)
    return d


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--source-lang", "-s", required=True)
    p.add_argument("--target-lang", "-t", required=True)
    p.add_argument("--trainpref", required=True)
    p.add_argument("--validpref")
    p.add_argument("--testpref")
    p.add_argument("--destdir", required=True)
    p.add_argument("--thresholdsrc", type=int, default=0)
    p.add_argument("--thresholdtgt", type=int, default=0)
    p.add_argument("--srcdict", help="the source dictionary file, in place of building one")
    p.add_argument("--tgtdict", help="the target dictionary file, in place of building one")
    p.add_argument("--joined-dictionary", action="store_true")
    p.add_argument("--dataset-impl", default="mmap", choices=("mmap", "native"),
                   help="mmap: fairseq's layout (MMIDIDX); native: DNTPUIDX1")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO, force=True)
    args = build_parser().parse_args(argv)
    os.makedirs(args.destdir, exist_ok=True)
    src, tgt = args.source_lang, args.target_lang
    if args.srcdict:
        src_dict = Dictionary.load(args.srcdict)
    elif args.joined_dictionary:
        src_dict = build_dictionary([f"{args.trainpref}.{src}", f"{args.trainpref}.{tgt}"],
                                    args.thresholdsrc)
    else:
        src_dict = build_dictionary([f"{args.trainpref}.{src}"], args.thresholdsrc)
    if args.tgtdict:
        tgt_dict = Dictionary.load(args.tgtdict)
    elif args.joined_dictionary:
        tgt_dict = src_dict
    else:
        tgt_dict = build_dictionary([f"{args.trainpref}.{tgt}"], args.thresholdtgt)
    src_dict.save(os.path.join(args.destdir, f"dict.{src}.txt"))
    tgt_dict.save(os.path.join(args.destdir, f"dict.{tgt}.txt"))
    for split, pref in (("train", args.trainpref), ("valid", args.validpref),
                        ("test", args.testpref)):
        if not pref:
            continue
        for lang, d in ((src, src_dict), (tgt, tgt_dict)):
            n = binarize_file(f"{pref}.{lang}",
                              os.path.join(args.destdir, f"{split}.{src}-{tgt}.{lang}"), d,
                              impl=args.dataset_impl)
            logger.info("binarized %s.%s: %d sequences", split, lang, n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
