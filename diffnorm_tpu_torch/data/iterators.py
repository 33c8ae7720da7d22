"""Epoch batch iteration with a resumable position (the port's copy of
diffnorm_tpu/data/iterators.py): batches by size and sentence count (in
multiples of `required_batch_size_multiple`), shuffled per epoch from
(seed, epoch) after the first `curriculum` epochs, resumed from a saved
offset, grouped into update_freq micro-batches.

Batches load on a background thread (`num_prefetch` ahead), or on
`num_workers` threads in order (fairseq's --num-workers). Worker threads
do host work alone, the dataset reads and the numpy collation; every torch
call, the upload to the card included, stays on the calling thread
(`read_ahead`). Results come back in order, so batch lists and resume
offsets equal the sequential path's for every worker count; a dataset that
draws from one shared generator (SpecAugment, crops) sees another draw
order under workers > 1, as with torch DataLoader workers.
"""

from __future__ import annotations

import logging
import queue
import threading
from collections import deque
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Union

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


class CountingIterator:
    """An iterator that counts the items it handed out (`n`, from `start`)."""

    def __init__(self, iterable, start: int = 0, total: Optional[int] = None):
        self._it = iter(iterable)
        self.n, self.total = start, total

    def __iter__(self):
        return self

    def __next__(self):
        item = next(self._it)
        self.n += 1
        return item

    def has_next(self) -> bool:
        return self.total is None or self.n < self.total

    def close(self) -> None:
        close = getattr(self._it, "close", None)
        if close is not None:
            close()


class _Raised:
    """An exception of the loading thread, handed to the consumer."""

    def __init__(self, error: BaseException):
        self.error = error


class _Prefetcher:
    """Items of `make_iter()` loaded on a background thread, up to `depth`
    ahead. A loading error is raised to the consumer; `close` stops the
    thread."""

    def __init__(self, make_iter: Callable[[], Iterator], depth: int = 4):
        self.q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._done, self._finished = object(), False
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, args=(make_iter,), daemon=True)
        self._thread.start()

    def _run(self, make_iter) -> None:
        end = self._done
        try:
            for item in make_iter():
                if self._stop.is_set():
                    return
                self.q.put(item)
        except BaseException as e:  # noqa: BLE001 - handed to the consumer
            end = _Raised(e)
        finally:
            if self._stop.is_set():
                try:
                    self.q.put_nowait(end)
                except queue.Full:
                    pass
            else:
                self.q.put(end)

    def __iter__(self):
        return self

    def __next__(self):
        # the iterator protocol: an exhausted iterator keeps raising
        # StopIteration; the end marker comes once, and a second get()
        # would block forever (JAX iterators.py:84-88)
        if self._finished:
            raise StopIteration
        item = self.q.get()
        if item is self._done or isinstance(item, _Raised):
            self._finished = True
            if isinstance(item, _Raised):
                raise item.error
            raise StopIteration
        return item

    def close(self) -> None:
        """Stop the loading thread (items it loaded are dropped)."""
        self._stop.set()
        self._finished = True
        while self._thread.is_alive():
            try:
                self.q.get(timeout=0.05)
            except queue.Empty:
                pass


def pool_map_ordered(fn, items, workers: int, depth: int):
    """fn(item) for each item, in order, with up to `depth` calls in flight
    on `workers` threads (fairseq's --num-workers DataLoader). The calls do
    host work alone."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=workers) as ex:
        futs, it = deque(), iter(items)
        try:
            for _ in range(max(depth, 1)):
                futs.append(ex.submit(fn, next(it)))
        except StopIteration:
            it = None
        try:
            while futs:
                out = futs.popleft().result()
                if it is not None:
                    try:
                        futs.append(ex.submit(fn, next(it)))
                    except StopIteration:
                        it = None
                yield out
        finally:
            for fut in futs:
                fut.cancel()


def read_ahead(iterable, prep: Callable[[Any], Any], depth: int = 2):
    """prep(item) for each item, in order, `depth` prepared items ahead of
    the consumer (the upload of the next batches while the card runs the
    current one). `prep` runs on the calling thread. next() is never
    called again after the first StopIteration (JAX iterators.py:135-137)."""
    buf, it, done = deque(), iter(iterable), False
    while not done and len(buf) < max(depth, 1):
        try:
            buf.append(prep(next(it)))
        except StopIteration:
            done = True
    while buf:
        out = buf.popleft()
        if not done:
            try:
                buf.append(prep(next(it)))
            except StopIteration:
                done = True
        yield out


class EpochBatchIterator:
    """dataset: __len__, __getitem__, collater, ordered_indices, num_tokens.
    `max_positions` drops the samples too long for it (with a warning where
    `ignore_invalid_inputs`, else raises), as fairseq's filter_by_size: a
    (max_source, max_target) pair is compared per component with a
    dataset's `size(i)` pair, where it has one (a None component is no
    limit); a dataset without `size` holds num_tokens to the pair's
    smallest set component, and to a number as it is.

    `num_workers` > 1 loads batches on that many threads, in order, and
    `num_prefetch` > 0 otherwise on one thread that many ahead. A caller
    that reads ahead of its training steps calls `mark_trained` per update,
    and `state_dict` then records the batches trained, not those handed
    out."""

    def __init__(self, dataset, max_tokens: Optional[int] = None, seed: int = 1,
                 shuffle: bool = True, max_positions: MaxPositions = None,
                 ignore_invalid_inputs: bool = False, max_sentences: Optional[int] = None,
                 required_batch_size_multiple: int = 1, num_workers: int = 0,
                 num_prefetch: int = 4, curriculum: int = 0):
        self.dataset, self.max_tokens, self.seed, self.shuffle = dataset, max_tokens, seed, shuffle
        self.max_sentences, self.mult = max_sentences, required_batch_size_multiple
        self.max_positions, self.ignore_invalid_inputs = max_positions, ignore_invalid_inputs
        self.num_workers, self.num_prefetch, self.curriculum = num_workers, num_prefetch, curriculum
        self.epoch, self._offset = 1, 0
        self._batches: Optional[List[np.ndarray]] = None
        self._active: Optional[CountingIterator] = None
        self._trained: Optional[int] = None

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
        batches = batch_by_size(indices, sizes, self.max_tokens, self.max_sentences, self.mult)
        # --curriculum N: the batches in order for the first N epochs
        if self.shuffle and epoch > self.curriculum:
            order = np.random.default_rng((self.seed, epoch)).permutation(len(batches))
            batches = [batches[i] for i in order]
        return batches

    def __len__(self) -> int:
        if self._batches is None:
            self._batches = self._make_batches(self.epoch)
        return len(self._batches)

    def _load(self, batch_idx: int) -> Dict[str, np.ndarray]:
        return self.dataset.collater([self.dataset[int(i)] for i in self._batches[batch_idx]])

    def next_epoch_itr(self) -> CountingIterator:
        """This epoch's batches from the saved offset on; its `n` counts the
        batches handed out."""
        self._close_active()
        self._batches = self._make_batches(self.epoch)
        start, order = self._offset, range(self._offset, len(self._batches))
        if self.num_workers > 1:
            it = pool_map_ordered(self._load, order, self.num_workers,
                                  depth=self.num_prefetch + self.num_workers)
        elif self.num_prefetch > 0:
            it = _Prefetcher(lambda: map(self._load, order), depth=self.num_prefetch)
        else:
            it = map(self._load, order)
        self._active = CountingIterator(it, start=start, total=len(self._batches))
        self._trained = None
        return self._active

    def mark_trained(self, n_batches: int) -> None:
        """Count `n_batches` more batches trained this epoch (a reader ahead
        of its steps has pulled more than it trained)."""
        if self._trained is None:
            self._trained = self._offset
        self._trained += n_batches

    def end_of_epoch(self) -> bool:
        return self._active is not None and not self._active.has_next()

    def _close_active(self) -> None:
        if self._active is not None:
            self._active.close()

    def finish_epoch(self) -> None:
        self._close_active()
        self.epoch += 1
        self._offset = 0
        self._batches = None
        # a save after finish_epoch records offset 0 of the next epoch
        self._active = None
        self._trained = None

    def state_dict(self) -> Dict[str, Any]:
        if self._trained is not None:
            offset = self._trained
        elif self._active is not None:
            offset = self._active.n
        else:
            offset = self._offset
        return {"epoch": self.epoch, "offset": offset, "seed": self.seed}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.epoch, self._offset = state.get("epoch", 1), state.get("offset", 0)
        self._trained = None
        self._batches = None


class SyntheticEpochIterator:
    """EpochBatchIterator's interface over a dummy task's batches (a dataset
    without a collater, JAX cli/train.py:140-147): every epoch yields them as
    they are, and there is no position inside an epoch to keep."""

    def __init__(self, dataset):
        self.dataset, self.epoch = dataset, 1

    def next_epoch_itr(self) -> Iterator[Dict[str, np.ndarray]]:
        return iter(self.dataset)

    def mark_trained(self, n_batches: int) -> None:
        pass

    def finish_epoch(self) -> None:
        self.epoch += 1

    def state_dict(self) -> Dict[str, Any]:
        return {"epoch": self.epoch}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.epoch = state.get("epoch", 1)


def iterate_valid(dataset, max_tokens: Optional[int] = None,
                  max_positions: MaxPositions = None) -> Iterator[Dict[str, np.ndarray]]:
    """A validation pass, unshuffled, on the calling thread; an over-long
    sample raises, as fairseq's valid iterator does without
    --skip-invalid-size-inputs-valid-test. A dummy task's batches come as
    they are."""
    if not hasattr(dataset, "collater"):
        return iter(dataset)
    return EpochBatchIterator(dataset, max_tokens, shuffle=False, max_positions=max_positions,
                              num_prefetch=0).next_epoch_itr()
