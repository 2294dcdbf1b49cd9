"""Sparsity patterns for block-sparse attention.

The port's own copy of ``deepspeed_tpu/ops/sparse_attention/
sparsity_config.py`` (numpy only; importing the JAX package's module
would run that package's ``__init__``).  Dense, Fixed, Variable, BigBird,
BSLongformer and LocalSlidingWindow, with the same defaults, errors and
draws: BigBird's random blocks come from ``np.random.RandomState(seed)``,
so both packages build the same layout bit for bit.  Each config makes a
``[num_blocks, num_blocks]`` boolean layout over sequence blocks; the
block-sparse kernels compute only its True blocks.
"""
from __future__ import annotations

import numpy as np


class SparsityConfig:
    """Base: dense layout (reference DenseSparsityConfig)."""

    def __init__(self, num_heads: int = 1, block: int = 64):
        self.num_heads = num_heads
        self.block = block

    def num_blocks(self, seq_len: int) -> int:
        if seq_len % self.block:
            raise ValueError(
                f"seq_len {seq_len} not divisible by block {self.block}")
        return seq_len // self.block

    def make_layout(self, seq_len: int) -> np.ndarray:
        n = self.num_blocks(seq_len)
        return np.ones((n, n), bool)

    def _causal(self, layout: np.ndarray) -> np.ndarray:
        n = layout.shape[0]
        return layout & (np.arange(n)[:, None] >= np.arange(n)[None, :])


DenseSparsityConfig = SparsityConfig


class FixedSparsityConfig(SparsityConfig):
    """Reference FixedSparsityConfig (:63): local blocks of
    ``num_local_blocks`` plus attention to the last block(s) of each prior
    local window (the "global" summary columns)."""

    def __init__(self, num_heads: int = 1, block: int = 64,
                 num_local_blocks: int = 4, num_global_blocks: int = 1,
                 attention: str = "unidirectional"):
        super().__init__(num_heads, block)
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        n = self.num_blocks(seq_len)
        L, G = self.num_local_blocks, self.num_global_blocks
        layout = np.zeros((n, n), bool)
        for i in range(n):
            w0 = (i // L) * L
            layout[i, w0:min(w0 + L, n)] = True      # local window
            for wstart in range(0, w0, L):           # window summaries
                layout[i, max(wstart + L - G, 0):wstart + L] = True
        if self.attention == "unidirectional":
            layout = self._causal(layout)
        return layout


class LocalSlidingWindowSparsityConfig(SparsityConfig):
    """Reference LocalSlidingWindowSparsityConfig: plain sliding window."""

    def __init__(self, num_heads: int = 1, block: int = 64,
                 num_sliding_window_blocks: int = 3,
                 attention: str = "unidirectional"):
        super().__init__(num_heads, block)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        n = self.num_blocks(seq_len)
        w = self.num_sliding_window_blocks
        i = np.arange(n)[:, None]
        j = np.arange(n)[None, :]
        layout = np.abs(i - j) <= w // 2
        if self.attention == "unidirectional":
            layout = self._causal(layout)
        return layout


class BigBirdSparsityConfig(SparsityConfig):
    """Reference BigBirdSparsityConfig: random + sliding window + global."""

    def __init__(self, num_heads: int = 1, block: int = 64,
                 num_random_blocks: int = 1,
                 num_sliding_window_blocks: int = 3,
                 num_global_blocks: int = 1,
                 attention: str = "bidirectional", seed: int = 0):
        super().__init__(num_heads, block)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.seed = seed

    def make_layout(self, seq_len: int) -> np.ndarray:
        n = self.num_blocks(seq_len)
        i = np.arange(n)[:, None]
        j = np.arange(n)[None, :]
        layout = np.abs(i - j) <= self.num_sliding_window_blocks // 2
        g = min(self.num_global_blocks, n)
        layout[:, :g] = True
        layout[:g, :] = True
        rs = np.random.RandomState(self.seed)
        for row in range(n):
            picks = rs.choice(n, size=min(self.num_random_blocks, n),
                              replace=False)
            layout[row, picks] = True
        if self.attention == "unidirectional":
            layout = self._causal(layout)
        return layout


class BSLongformerSparsityConfig(SparsityConfig):
    """Reference BSLongformerSparsityConfig: sliding window + symmetric
    global attention on leading blocks."""

    def __init__(self, num_heads: int = 1, block: int = 64,
                 num_sliding_window_blocks: int = 3,
                 global_block_indices=(0,),
                 attention: str = "bidirectional"):
        super().__init__(num_heads, block)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = tuple(global_block_indices)
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        n = self.num_blocks(seq_len)
        i = np.arange(n)[:, None]
        j = np.arange(n)[None, :]
        layout = np.abs(i - j) <= self.num_sliding_window_blocks // 2
        for g in self.global_block_indices:
            if g < n:
                layout[:, g] = True
                layout[g, :] = True
        if self.attention == "unidirectional":
            layout = self._causal(layout)
        return layout


class VariableSparsityConfig(SparsityConfig):
    """Reference VariableSparsityConfig: custom local window sizes +
    global blocks."""

    def __init__(self, num_heads: int = 1, block: int = 64,
                 local_window_blocks=(4,), global_block_indices=(0,),
                 attention: str = "unidirectional"):
        super().__init__(num_heads, block)
        self.local_window_blocks = list(local_window_blocks)
        self.global_block_indices = tuple(global_block_indices)
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        n = self.num_blocks(seq_len)
        layout = np.zeros((n, n), bool)
        start = 0
        windows = list(self.local_window_blocks)
        while start < n:
            w = windows.pop(0) if windows else self.local_window_blocks[-1]
            end = min(start + w, n)
            layout[start:end, start:end] = True
            start = end
        for g in self.global_block_indices:
            if g < n:
                layout[:, g] = True
                layout[g, :] = True
        if self.attention == "unidirectional":
            layout = self._causal(layout)
        return layout
