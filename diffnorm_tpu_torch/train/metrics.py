"""Metric aggregation (the port's copy of diffnorm_tpu/train/metrics.py;
reference fairseq/logging/metrics.py).

A `MetricsAggregator` keeps weighted sums on the host: the counts
(ntokens, nsentences, sample_size) summed, every other metric weighted by
its row's sample_size. `aggregate()` contexts nest as fairseq's aggregator
stack does: `log_dict` (which the trainer calls after every train and
validation step) reaches every open aggregator, so one step's metrics land
in both the epoch's and the log interval's.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, Iterator, List, Mapping, Optional

COUNT_KEYS = ("ntokens", "nsentences", "sample_size")


class MetricsAggregator:
    def __init__(self):
        self._sum: Dict[str, float] = defaultdict(float)
        self._weight: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, float] = defaultdict(float)

    def log_scalar(self, key: str, value: float, weight: float = 1.0) -> None:
        self._sum[key] += float(value) * float(weight)
        self._weight[key] += float(weight)

    def log_sum(self, key: str, value: float) -> None:
        self._counts[key] += float(value)

    def log_dict(self, metrics: Mapping[str, float], weight_key: str = "sample_size") -> None:
        w = float(metrics.get(weight_key, 1.0))
        for k, v in metrics.items():
            if k in COUNT_KEYS:
                self.log_sum(k, v)
            else:
                self.log_scalar(k, v, w)

    def get_smoothed_values(self) -> Dict[str, float]:
        out = {k: s / self._weight[k] if self._weight[k] > 0 else 0.0
               for k, s in self._sum.items()}
        out.update(self._counts)
        return out

    def reset(self) -> None:
        self._sum.clear()
        self._weight.clear()
        self._counts.clear()


_STACK: List[MetricsAggregator] = []


@contextlib.contextmanager
def aggregate(agg: Optional[MetricsAggregator] = None) -> Iterator[MetricsAggregator]:
    """Open `agg` (a new one by default) for the `log_dict` calls inside."""
    agg = agg or MetricsAggregator()
    _STACK.append(agg)
    try:
        yield agg
    finally:
        _STACK.pop()


def log_dict(metrics: Mapping[str, float]) -> None:
    for agg in _STACK:
        agg.log_dict(metrics)
