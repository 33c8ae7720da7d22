"""Corpus BLEU over unit sequences (the port's copy of
diffnorm_tpu/eval/bleu.py).

BLEU-4 with brevity penalty, unsmoothed, from pure-Python n-gram counters:
the path JAX takes when its native counters (csrc/diffnorm_data.cpp) are
not built. `corpus_bleu` takes sacrebleu where it imports, these counters
otherwise, as JAX's does; the GPU machine has no sacrebleu, so there it
reports the counters' BLEU.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import List, Sequence


class BleuAccumulator:
    def __init__(self):
        self.reflen = self.predlen = 0
        self.match = [0] * 4
        self.total = [0] * 4
        self._vocab = {}

    def _ids(self, toks: Sequence[str]) -> List[int]:
        out = []
        for t in toks:
            if t not in self._vocab:
                self._vocab[t] = len(self._vocab) + 10  # avoid pad=1/eos=2
            out.append(self._vocab[t])
        return out

    def add(self, ref: Sequence[str], hyp: Sequence[str]) -> None:
        r = self._ids(list(ref))
        h = self._ids(list(hyp))
        self.reflen += len(r)
        self.predlen += len(h)
        for n in range(1, 5):
            rn = Counter(tuple(r[i:i + n]) for i in range(len(r) - n + 1))
            hn = Counter(tuple(h[i:i + n]) for i in range(len(h) - n + 1))
            for g, c in hn.items():
                self.total[n - 1] += c
                self.match[n - 1] += min(c, rn.get(g, 0))

    def score(self, order: int = 4) -> float:
        if not 1 <= order <= 4:
            raise ValueError("counters track ngrams up to order 4")
        if self.predlen == 0:
            return 0.0
        log_p = 0.0
        for m, t in zip(self.match[:order], self.total[:order]):
            if t == 0 or m == 0:  # unsmoothed corpus BLEU
                return 0.0
            log_p += math.log(m / t) / order
        bp = (1.0 if self.predlen >= self.reflen
              else math.exp(1 - self.reflen / max(self.predlen, 1)))
        return 100.0 * bp * math.exp(log_p)

    def precisions(self, order: int = 4) -> List[float]:
        return [100.0 * m / t if t else 0.0
                for m, t in zip(self.match[:order], self.total[:order])]

    def result_string(self, order: int = 4) -> str:
        p = "/".join(f"{x:.1f}" for x in self.precisions(order))
        ratio = self.predlen / max(self.reflen, 1)
        return (f"BLEU{order} = {self.score(order):.2f}, {p} "
                f"(ratio={ratio:.3f}, hyp_len={self.predlen}, ref_len={self.reflen})")


def scorer_name() -> str:
    """The scorer `corpus_bleu` uses here: "sacrebleu" where it imports,
    else "counters"."""
    try:
        import sacrebleu  # noqa: F401
    except ImportError:
        return "counters"
    return "sacrebleu"


def corpus_bleu(refs: List[str], hyps: List[str]) -> float:
    """sacrebleu when it imports (reference research/utils/unit_bleu.py
    path), else the counters of `BleuAccumulator`."""
    try:
        import sacrebleu

        return sacrebleu.corpus_bleu(hyps, [refs]).score
    except ImportError:
        acc = BleuAccumulator()
        for r, h in zip(refs, hyps):
            acc.add(r.split(), h.split())
        return acc.score()
