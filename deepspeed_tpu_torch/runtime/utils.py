"""Runtime utilities.

Counterpart of ``deepspeed_tpu/runtime/utils.py``: the partitioning math
(``partition_uniform``, ``prefix_sum_inc``, ``partition_balanced``, the
reference's ``runtime/utils.py:573`` and ``:639``, for pipeline stage
balancing), ``tree_param_count``, ``call_to_str`` and the memory report
``see_memory_usage`` (``torch.cuda``'s allocator statistics in place of
the TPU's ``memory_stats``).  The JAX module's ``host_transfer`` is its
lint gate's sync point and has no counterpart here.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from ..utils.logging import logger


def partition_uniform(num_items: int, num_parts: int) -> List[int]:
    """Boundaries [p0..pN] splitting num_items as evenly as possible.
    Reference ``runtime/utils.py:573``."""
    parts = [0] * (num_parts + 1)
    base, extra = divmod(num_items, num_parts)
    for p in range(num_parts):
        parts[p + 1] = parts[p] + base + (1 if p < extra else 0)
    return parts


def prefix_sum_inc(weights: Sequence[float]) -> List[float]:
    out = list(weights)
    for i in range(1, len(out)):
        out[i] += out[i - 1]
    return out


def partition_balanced(weights: Sequence[float], num_parts: int) -> List[int]:
    """Boundaries minimizing the heaviest part (binary search over the
    bottleneck, same contract as reference ``runtime/utils.py:639``
    ``partition_balanced``)."""
    n = len(weights)
    if num_parts >= n:
        return partition_uniform(n, num_parts)
    prefix = [0.0] + prefix_sum_inc(weights)

    def parts_needed(cap: float) -> int:
        count, start = 0, 0
        for _ in range(num_parts + 1):
            # furthest end with sum(start..end) <= cap
            end = start
            while end < n and prefix[end + 1] - prefix[start] <= cap:
                end += 1
            if end == start:  # single item exceeds cap
                return num_parts + 1
            count += 1
            start = end
            if start == n:
                return count
        return num_parts + 1

    lo = max(weights)
    hi = prefix[-1]
    for _ in range(64):
        mid = (lo + hi) / 2
        if parts_needed(mid) <= num_parts:
            hi = mid
        else:
            lo = mid
        if hi - lo <= 1e-6 * max(1.0, hi):
            break
    cap = hi * (1 + 1e-9)
    bounds = [0]
    start = 0
    for p in range(num_parts):
        remaining_parts = num_parts - p - 1
        end = start
        while end < n and prefix[end + 1] - prefix[start] <= cap and \
                (n - end) > remaining_parts:
            end += 1
        end = max(end, start + 1)
        bounds.append(end)
        start = end
    bounds[-1] = n
    return bounds


def see_memory_usage(message: str, force: bool = False) -> None:
    """Reference ``runtime/utils.py:819``: the card's allocated and peak
    bytes (0 without a card) and the host's peak resident set."""
    del force
    used = peak = 0.0
    if torch.cuda.is_available():
        used = torch.cuda.memory_allocated() / 2**30
        peak = torch.cuda.max_memory_allocated() / 2**30
    import resource
    host_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    logger.info(f"{message} | device used {used:.2f}GB peak {peak:.2f}GB | "
                f"host rss {host_gb:.2f}GB")


def tree_param_count(tree) -> int:
    """Elements in every tensor leaf of nested dicts."""
    if isinstance(tree, dict):
        return sum(tree_param_count(v) for v in tree.values())
    return int(tree.numel())


def call_to_str(base: str, *args, **kwargs) -> str:
    """Reference ``runtime/utils.py`` call_to_str (used by pipe schedule repr)."""
    name = f"{base}("
    if args:
        name += ", ".join(repr(a) for a in args)
        if kwargs:
            name += ", "
    if kwargs:
        name += ", ".join(f"{k}={v!r}" for k, v in kwargs.items())
    return name + ")"
