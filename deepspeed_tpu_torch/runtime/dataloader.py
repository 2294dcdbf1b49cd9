"""Data loading.

Counterpart of ``deepspeed_tpu/runtime/dataloader.py`` (numpy only): one
host-side loader assembles the global batch ``[batch_size, ...]`` with
deterministic shuffling, and the engine's ``shard_batch`` reshapes it to
``[gas, micro, ...]`` and moves it to the device.

Works with: numpy-array datasets (dict of arrays or (x, y) tuples),
map-style datasets (len/__getitem__), and python iterables yielding
dict batches.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np


class RepeatingLoader:
    """Wrap an iterable so that it restarts on StopIteration (an endless
    stream)."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            return next(self.data_iter)


class DeepSpeedDataLoader:
    """Global-batch loader with deterministic shuffling + curriculum hook.

    ``batch_size`` is the GLOBAL train batch (micro * gas * dp_world); every
    `__next__` returns one optimizer step's data shaped
    [batch_size, ...] (the engine reshapes to [gas, micro*dp, ...]).
    """

    def __init__(self,
                 dataset: Any,
                 batch_size: int,
                 shuffle: bool = True,
                 seed: int = 0,
                 drop_last: bool = True,
                 collate_fn: Optional[Callable] = None,
                 data_sampler: Optional[Iterator] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.collate_fn = collate_fn
        self.data_sampler = data_sampler
        self.epoch = 0
        if hasattr(dataset, "__len__"):
            n = len(dataset)
            self.len = n // batch_size if drop_last else -(-n // batch_size)
        else:
            self.len = None

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self):
        if self.len is None:
            raise TypeError("loader over an iterable dataset has no len()")
        return self.len

    def _index_stream(self):
        n = len(self.dataset)
        if self.data_sampler is not None:
            it = iter(self.data_sampler)
            if it is self.data_sampler:  # one-shot generator
                if getattr(self, "_sampler_consumed", False):
                    raise ValueError(
                        "data_sampler is a one-shot iterator already "
                        "consumed by a previous epoch; pass a re-iterable "
                        "(e.g. a sampler object with __iter__)")
                self._sampler_consumed = True
            yield from it
            return
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        yield from order

    def __iter__(self):
        if not hasattr(self.dataset, "__getitem__"):
            yield from self.dataset  # iterable of ready-made batches
            return
        idxs = []
        for i in self._index_stream():
            idxs.append(i)
            if len(idxs) == self.batch_size:
                yield self._collate(idxs)
                idxs = []
        if idxs and not self.drop_last:
            yield self._collate(idxs)
        self.epoch += 1

    def _collate(self, idxs):
        items = [self.dataset[int(i)] for i in idxs]
        if self.collate_fn is not None:
            return self.collate_fn(items)
        first = items[0]
        if isinstance(first, dict):
            return {k: np.stack([it[k] for it in items]) for k in first}
        if isinstance(first, (tuple, list)):
            cols = list(zip(*items))
            return tuple(np.stack(c) for c in cols)
        return np.stack(items)


def synthetic_lm_batches(vocab_size: int, seq_len: int, global_batch: int,
                         seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Endless synthetic token stream (benchmarking / tests)."""
    rs = np.random.RandomState(seed)
    while True:
        yield {"input_ids": rs.randint(
            0, vocab_size, (global_batch, seq_len), dtype=np.int32)}
