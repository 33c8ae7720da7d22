"""Epoch batch iteration with a resumable position (the port's copy of the
parts of diffnorm_tpu/data/iterators.py the training and generation CLIs
use): batches by size and sentence count, shuffled per epoch from (seed,
epoch), resumed from a saved offset, grouped into update_freq
micro-batches. Batches load on the calling thread."""

from __future__ import annotations

import logging
from typing import Any, Dict, Iterator, List, Optional, Sequence, Union

import numpy as np

from diffnorm_tpu_torch.data.batching import batch_by_size

logger = logging.getLogger("diffnorm_tpu_torch.data")

# a size cap: a number, or a (max_source, max_target) pair
MaxPositions = Union[None, int, Sequence[Optional[int]]]


def grouped(iterable, chunk_size: int) -> Iterator[List]:
    """Lists of `chunk_size` items (the last may be shorter)."""
    chunk = []
    for item in iterable:
        chunk.append(item)
        if len(chunk) == chunk_size:
            yield chunk
            chunk = []
    if chunk:
        yield chunk


class EpochBatchIterator:
    """dataset: __len__, __getitem__, collater, ordered_indices, num_tokens.
    `max_positions` drops the samples too long for it (with a warning where
    `ignore_invalid_inputs`, else raises), as fairseq's filter_by_size: a
    (max_source, max_target) pair is compared per component with a
    dataset's `size(i)` pair, where it has one (a None component is no
    limit); a dataset without `size` holds num_tokens to the pair's
    smallest set component, and to a number as it is."""

    def __init__(self, dataset, max_tokens: Optional[int] = None, seed: int = 1,
                 shuffle: bool = True, max_positions: MaxPositions = None,
                 ignore_invalid_inputs: bool = False, max_sentences: Optional[int] = None):
        self.dataset, self.max_tokens, self.seed, self.shuffle = dataset, max_tokens, seed, shuffle
        self.max_sentences = max_sentences
        self.max_positions, self.ignore_invalid_inputs = max_positions, ignore_invalid_inputs
        self.epoch, self.offset = 1, 0
        self._batches: Optional[List[np.ndarray]] = None

    def _too_long(self, sizes: np.ndarray) -> np.ndarray:
        """[len(dataset)] bool: the samples `max_positions` drops."""
        mp = self.max_positions
        if not isinstance(mp, (tuple, list)):
            return sizes > mp
        if hasattr(self.dataset, "size"):
            pairs = np.asarray([self.dataset.size(i) for i in range(len(self.dataset))],
                               dtype=np.int64).reshape(len(self.dataset), -1)
            bad = np.zeros(len(self.dataset), dtype=bool)
            for col, cap in enumerate(mp[:pairs.shape[1]]):
                if cap is not None:
                    bad |= pairs[:, col] > cap
            return bad
        return sizes > min(m for m in mp if m is not None)

    def _make_batches(self, epoch: int) -> List[np.ndarray]:
        indices = self.dataset.ordered_indices()
        sizes = np.asarray([self.dataset.num_tokens(i) for i in range(len(self.dataset))])
        if self.max_positions is not None:
            bad_mask = self._too_long(sizes)
            keep = ~bad_mask[indices]
            bad = indices[~keep].tolist()
            if bad and not self.ignore_invalid_inputs:
                size0 = (self.dataset.size(bad[0]) if hasattr(self.dataset, "size")
                         else sizes[bad[0]])
                raise ValueError(f"Size of sample #{bad[0]} is invalid (={size0}) "
                                 f"since max_positions={self.max_positions}")
            if bad:
                logger.warning("%d samples have invalid sizes and will be skipped, "
                               "max_positions=%s, first few sample ids=%s",
                               len(bad), self.max_positions, bad[:10])
                indices = indices[keep]
        batches = batch_by_size(indices, sizes, self.max_tokens, self.max_sentences)
        if self.shuffle:
            order = np.random.default_rng((self.seed, epoch)).permutation(len(batches))
            batches = [batches[i] for i in order]
        return batches

    def next_epoch_itr(self) -> Iterator[Dict[str, np.ndarray]]:
        """This epoch's batches from the saved offset on; `self.offset`
        counts the batches handed out."""
        self._batches = self._make_batches(self.epoch)
        while self.offset < len(self._batches):
            idxs = self._batches[self.offset]
            self.offset += 1
            yield self.dataset.collater([self.dataset[int(i)] for i in idxs])

    def finish_epoch(self) -> None:
        self.epoch += 1
        self.offset = 0
        self._batches = None

    def state_dict(self) -> Dict[str, Any]:
        return {"epoch": self.epoch, "offset": self.offset, "seed": self.seed}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.epoch, self.offset = state.get("epoch", 1), state.get("offset", 0)
        self._batches = None


def iterate_valid(dataset, max_tokens: Optional[int] = None,
                  max_positions: MaxPositions = None) -> Iterator[Dict[str, np.ndarray]]:
    """A validation pass, unshuffled; an over-long sample raises, as
    fairseq's valid iterator does without --skip-invalid-size-inputs-valid-test."""
    return EpochBatchIterator(dataset, max_tokens, shuffle=False,
                              max_positions=max_positions).next_epoch_itr()
