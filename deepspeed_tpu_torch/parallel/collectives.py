"""Gradient reduction over the data-parallel axes, and Megatron's
tensor-parallel pair.

Counterpart of ``deepspeed_tpu/parallel/collectives.py``.  A gradient
leaf leaves the step's backward either all-reduced over the
data-parallel axis product, or reduce-scattered along the dim the ZeRO
policy shards, landing in its stage-2 layout (``REDUCE_PSUM``,
``reduce_over_data``).

The tensor-parallel training seam is the conjugate pair of Megatron's
operators, as ``torch.autograd.Function``\\ s over the model axis's
process group:

  - :func:`copy_to` — Megatron's ``f``: identity forward, all-reduce
    backward.  Placed where a replicated tensor enters shard-local
    compute (the attention and MLP branch inputs, the vocab projection's
    input): the backward sums the per-shard partial cotangents.
  - :func:`reduce_from` — Megatron's ``g``: all-reduce forward, identity
    backward.  Placed where per-shard partial outputs rejoin the
    replicated stream (row-parallel outputs, the vocab-sharded
    embedding, the vocab-parallel softmax statistics); the backward
    hands each shard the whole cotangent, not the summed transpose a raw
    all-reduce would give.

Under that convention model-sharded leaves get exact shard-local
gradients, leaves on the replicated stream (norms, positional tables)
get whole gradients on every shard, and the replicated leaves consumed
inside a reduced term (``TP_PARTIAL_SUFFIXES``: the fused qkv, gathered
per shard by :func:`qkv_shard_columns`, and the row-parallel biases
pre-divided by the shard count) get partial ones that
:func:`psum_tp_partials` sums at the step's exit.

An MoE layer over the batch axes routes the whole micro batch, as the
JAX engine does: :func:`gather_rows` all-gathers the gate's logits over
the batch axes (its backward a reduce-scatter) and :func:`own_rows`
names this rank's rows in them; :func:`all_to_all` moves the routed
rows to the ranks that hold their experts and back (its backward the
reverse exchange).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import comm

# gradient-reduce plan codes (``zero/sharding.grad_reduce_plan``'s
# leaves): -1 = all-reduce, d >= 0 = reduce-scatter along dim d
REDUCE_PSUM = -1


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return comm.all_reduce(g.clone(), comm.ReduceOp.SUM, ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return comm.all_reduce(x.clone(), comm.ReduceOp.SUM, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        n, i = comm.axis_size(axis), comm.axis_index(axis)
        return x.chunk(n, -1)[i].contiguous()

    @staticmethod
    def backward(ctx, g):
        return comm.all_gather(g, ctx.axis, axis=-1), None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, groups):
        ctx.axis, ctx.groups = axis, groups
        g = x.reshape((groups, -1) + tuple(x.shape[1:]))
        out = comm.all_gather(g, axis, axis=1)
        return out.reshape((-1,) + tuple(x.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        n = comm.axis_size(ctx.axis)
        g = g.reshape((ctx.groups, n, -1) + tuple(g.shape[1:])).flatten(1, 2)
        out = comm.reduce_scatter(g.contiguous(), comm.ReduceOp.SUM,
                                  ctx.axis, scatter_dimension=1)
        return out.reshape((-1,) + tuple(g.shape[2:])), None, None


def gather_rows(x: torch.Tensor, axis, groups: int = 1) -> torch.Tensor:
    """Every member's rows of ``x`` (dim 0) over ``axis``, in the global
    batch's order: ``x``'s rows are ``groups`` runs (micro batches) and
    the result holds run 0 of every member in member order, then run 1,
    and so on (the JAX layout ``[gas, micro * dp]``).  Backward: a
    reduce-scatter, each member's rows summed over the members."""
    if comm.axis_size(axis) == 1:
        return x
    return _GatherRows.apply(x, axis, groups)


def own_rows(y: torch.Tensor, axis, groups: int = 1) -> torch.Tensor:
    """This member's rows of a :func:`gather_rows` result (a view)."""
    n = comm.axis_size(axis)
    if n == 1:
        return y
    g = y.reshape((groups, n, -1) + tuple(y.shape[1:]))
    return g[:, comm.axis_index(axis)].reshape((-1,) + tuple(y.shape[1:]))


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, send, recv):
        ctx.axis, ctx.send, ctx.recv = axis, send, recv
        return comm.all_to_all_single(x, axis, input_split_sizes=send,
                                      output_split_sizes=recv)

    @staticmethod
    def backward(ctx, g):
        return (comm.all_to_all_single(g.contiguous(), ctx.axis,
                                       input_split_sizes=ctx.recv,
                                       output_split_sizes=ctx.send),
                None, None, None)


def all_to_all(x: torch.Tensor, axis, send, recv) -> torch.Tensor:
    """Rows of ``x`` (dim 0) to the members of ``axis``: ``send[j]`` rows
    to member j in order, ``recv[j]`` rows from member j concatenated in
    member order.  Backward: the reverse exchange of the cotangent.  The
    identity on an axis of size 1."""
    if comm.axis_size(axis) == 1:
        return x
    return _AllToAll.apply(x, axis, list(send), list(recv))


def copy_to(x: torch.Tensor, axis) -> torch.Tensor:
    """Megatron ``f``: identity forward, all-reduce over ``axis``
    backward."""
    return _CopyTo.apply(x, axis)


def reduce_from(x: torch.Tensor, axis) -> torch.Tensor:
    """Megatron ``g``: all-reduce over ``axis`` forward, identity
    backward."""
    return _ReduceFrom.apply(x, axis)


def scatter_to(x: torch.Tensor, axis) -> torch.Tensor:
    """Megatron's scatter to the model-parallel region: this member's
    chunk of ``x``'s last dim forward (member order is index order), the
    members' gradients all-gathered along it backward, so a leaf that
    every member holds whole gets the whole gradient on each."""
    return _ScatterTo.apply(x, axis)


# Transformer-block leaves whose gradients are PARTIAL per model shard
# under the copy_to/reduce_from convention, keyed on the trailing
# (module, weight) path pair as the model's _SUFFIX_RULES
TP_PARTIAL_SUFFIXES = frozenset({
    ("qkv", "kernel"), ("qkv", "bias"),
    ("out", "bias"), ("fc_out", "bias"),
})


def psum_tp_partials(tree, axis, path=()):
    """The exit all-reduce over the model axis of the partial-gradient
    leaves (in place); every other leaf as it is."""
    if isinstance(tree, dict):
        return {k: psum_tp_partials(v, axis, path + (k,))
                for k, v in tree.items()}
    if path[-2:] in TP_PARTIAL_SUFFIXES:
        return comm.all_reduce(tree, comm.ReduceOp.SUM, axis)
    return tree


def qkv_shard_columns(num_heads: int, num_kv_heads: int, head_dim: int,
                      model_shards: int) -> np.ndarray:
    """``[model_shards, qkv_dim // model_shards]`` column indices: row s
    is shard s's fused-qkv layout ``[q_s | k_s | v_s]`` drawn from the
    global ``[q(nh*hd) | k(nkv*hd) | v(nkv*hd)]`` packing (a contiguous
    split of the fused axis would hand shard 0 only q heads)."""
    nhl = num_heads // model_shards
    nkvl = num_kv_heads // model_shards
    rows = []
    for s in range(model_shards):
        rows.append(np.concatenate([
            np.arange(s * nhl * head_dim, (s + 1) * nhl * head_dim),
            num_heads * head_dim
            + np.arange(s * nkvl * head_dim, (s + 1) * nkvl * head_dim),
            (num_heads + num_kv_heads) * head_dim
            + np.arange(s * nkvl * head_dim, (s + 1) * nkvl * head_dim)]))
    return np.stack(rows).astype(np.int32)


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
