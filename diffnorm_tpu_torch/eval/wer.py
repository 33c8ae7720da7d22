"""Word error rate (the port's copy of diffnorm_tpu/eval/wer.py; reference
fairseq/scoring/wer.py): the summed word edit distance over the summed
reference length. The edit distance is a pure-Python dynamic program, the
counterpart of JAX's native `edit_distance_batch` and its numpy fallback."""

from __future__ import annotations

from typing import Sequence


def edit_distance(ref: Sequence[str], hyp: Sequence[str]) -> int:
    """Levenshtein distance between two word sequences (unit costs)."""
    prev = list(range(len(hyp) + 1))
    for i, r in enumerate(ref, 1):
        cur = [i]
        for j, h in enumerate(hyp, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (r != h)))
        prev = cur
    return prev[-1]


class WerAccumulator:
    """Corpus WER: per-pair word edit distance / total reference words."""

    def __init__(self):
        self.distance = 0
        self.ref_length = 0

    def add(self, ref: str, hyp: str) -> None:
        ref_words = ref.split()
        self.distance += edit_distance(ref_words, hyp.split())
        self.ref_length += len(ref_words)

    def score(self) -> float:
        return 100.0 * self.distance / max(self.ref_length, 1)

    def result_string(self) -> str:
        return f"WER: {self.score():.2f}"
