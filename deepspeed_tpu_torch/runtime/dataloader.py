"""Data loading.

Counterpart of ``deepspeed_tpu/runtime/dataloader.py`` (numpy only): a
host-side loader walks the global index stream with deterministic
shuffling, and the engine's ``shard_batch`` reshapes a batch to ``[gas,
micro, ...]`` and moves it to the device.  With data parallelism each
rank draws its slice of the same global index stream (``rank_slice``):
of each micro batch's ``dp * micro`` rows, the ``micro`` rows at offset
``rank * micro``, the rows device ``rank`` holds on the JAX engine's
``data`` mesh (its batch sharding over dim 1 of ``[gas, micro * dp]``).

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


def rank_slice(batch: Any, gas: int, dp: int, rank: int) -> Any:
    """This rank's rows of a global batch ``[gas * dp * micro, ...]`` (a
    dict, tuple or list of arrays or tensors, or one array) as its
    local batch ``[gas * micro, ...]``."""
    if isinstance(batch, dict):
        return {k: rank_slice(v, gas, dp, rank) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(rank_slice(v, gas, dp, rank) for v in batch)
    if dp == 1:
        return batch
    n = batch.shape[0]
    if n % (gas * dp):
        raise ValueError(f"global batch of {n} rows is not gas ({gas}) x "
                         f"dp ({dp}) x micro")
    rest = tuple(batch.shape[1:])
    local = batch.reshape((gas, dp, n // (gas * dp)) + rest)[:, rank]
    return local.reshape((n // dp,) + rest)


class DeepSpeedDataLoader:
    """Global-batch loader with deterministic shuffling + curriculum hook.

    ``batch_size`` is the GLOBAL train batch (micro * gas * dp_world);
    every ``__next__`` returns one optimizer step's data of this rank:
    ``[batch_size, ...]`` at one rank, its ``rank_slice`` of the step's
    indices (``[batch_size / dp, ...]``) with data parallelism.
    """

    def __init__(self,
                 dataset: Any,
                 batch_size: int,
                 shuffle: bool = True,
                 seed: int = 0,
                 drop_last: bool = True,
                 collate_fn: Optional[Callable] = None,
                 data_sampler: Optional[Iterator] = None,
                 data_parallel_rank: int = 0,
                 data_parallel_world_size: int = 1,
                 gradient_accumulation_steps: int = 1):
        if batch_size % (data_parallel_world_size
                         * gradient_accumulation_steps):
            raise ValueError(
                f"batch_size {batch_size} is not a multiple of dp "
                f"{data_parallel_world_size} x gas "
                f"{gradient_accumulation_steps}")
        if data_parallel_world_size > 1 and not drop_last:
            raise ValueError("a partial last batch cannot be cut into "
                             "equal rank slices: data parallelism needs "
                             "drop_last=True")
        self.dataset = dataset
        self.dp_rank = data_parallel_rank
        self.dp_world = data_parallel_world_size
        self.gas = gradient_accumulation_steps
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
        if self.dp_world > 1:
            idxs = rank_slice(np.asarray(idxs), self.gas, self.dp_world,
                              self.dp_rank)
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
