"""Gradient reduction over the data-parallel axes.

Counterpart of the data-parallel part of
``deepspeed_tpu/parallel/collectives.py``: ``REDUCE_PSUM`` and
``reduce_over_data``.  A gradient leaf leaves the step's backward either
all-reduced over the data-parallel axis product, or reduce-scattered
along the dim the ZeRO policy shards, landing in its stage-2 layout.
The tensor-parallel helpers of that module (``copy_to``, ``reduce_from``,
``psum_tp_partials``, ``qkv_shard_columns``) come with the port's tensor
parallelism.
"""
from __future__ import annotations

from typing import Sequence

import torch

from .. import comm

# gradient-reduce plan codes (``zero/sharding.grad_reduce_plan``'s
# leaves): -1 = all-reduce, d >= 0 = reduce-scatter along dim d
REDUCE_PSUM = -1


def reduce_over_data(g: torch.Tensor, plan: int,
                     data_axes: Sequence[str]) -> torch.Tensor:
    """Sum one gradient leaf over the data-parallel axis product:
    ``REDUCE_PSUM`` → all-reduce (in place, returned); ``d >= 0`` → this
    rank's shard of the sum along dim ``d`` (the reference's
    reduce-scatter path, ``stage_1_and_2.py:942``)."""
    axes = tuple(data_axes)
    if not axes:
        return g
    if plan >= 0:
        return comm.reduce_scatter(g, comm.ReduceOp.SUM, axes,
                                   scatter_dimension=plan)
    return comm.all_reduce(g, comm.ReduceOp.SUM, axes)
