"""Score a hypothesis file against references (the port of
diffnorm_tpu/cli/score.py; reference fairseq_cli/score.py): corpus BLEU
from the counters of `eval/bleu.py`, one sentence a line, a tab-prefixed id
dropped. Host code, no device.

  python -m diffnorm_tpu_torch.cli.score --sys hyp.txt --ref ref.txt \\
      [--order 4] [--ignore-case] [--sentence-bleu | --sacrebleu]

`--sys -` (the default) reads the hypotheses from stdin; `--sentence-bleu`
prints `i BLEU...` for each pair on its own; `--sacrebleu` prints
sacrebleu's corpus score (it fails to import where sacrebleu is not
installed, as JAX's does).
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Sequence

from diffnorm_tpu_torch.eval.bleu import BleuAccumulator


def read_lines(path: str, lower: bool = False) -> List[str]:
    """The lines of `path` ('-': stdin), each without a tab-prefixed id."""
    f = sys.stdin if path == "-" else open(path)
    try:
        out = []
        for line in f:
            line = line.rstrip("\n")
            if "\t" in line:
                line = line.split("\t", 1)[1]
            out.append(line.lower() if lower else line)
        return out
    finally:
        if f is not sys.stdin:
            f.close()


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--sys", "-s", default="-", help="the hypotheses ('-': stdin)")
    p.add_argument("--ref", "-r", required=True, help="the references")
    p.add_argument("--order", "-o", type=int, default=4, help="n-grams up to this order")
    p.add_argument("--ignore-case", action="store_true")
    p.add_argument("--sacrebleu", action="store_true")
    p.add_argument("--sentence-bleu", action="store_true", help="one BLEU a pair")
    args = p.parse_args(argv)
    hyps, refs = read_lines(args.sys, args.ignore_case), read_lines(args.ref, args.ignore_case)
    if len(hyps) != len(refs):
        raise ValueError(f"{len(hyps)} hypotheses against {len(refs)} references")
    if args.sacrebleu:
        import sacrebleu

        print(sacrebleu.corpus_bleu(hyps, [refs]))
        return 0
    if args.sentence_bleu:
        for i, (r, h) in enumerate(zip(refs, hyps)):
            acc = BleuAccumulator()
            acc.add(r.split(), h.split())
            print(i, acc.result_string(args.order))
        return 0
    acc = BleuAccumulator()
    for r, h in zip(refs, hyps):
        acc.add(r.split(), h.split())
    print(acc.result_string(args.order))
    return 0


if __name__ == "__main__":
    sys.exit(main())
