"""ZeRO's partitioned leaves: shards, gathers, and stage 3's gather.

The JAX package has no counterpart of this module: there ZeRO is a
declaration (``deepspeed_tpu/runtime/zero/sharding.py``) and XLA emits
the collectives from the spec trees.  The port writes those collectives
itself, leaf by leaf, with the same partition, so rank r's shard of a
leaf is the JAX array's shard on device r of a ``data`` mesh: the leaf
cut into ``dp`` equal contiguous chunks along the plan's dim, chunk r.

``torch.distributed``'s tensor collectives work on dim 0 of flat
buffers, so a shard along another dim is made contiguous (``chunk`` then
a copy; ``comm.all_gather`` / ``comm.reduce_scatter`` stage such dims as
contiguous chunks too): a shard is never a strided view handed to a
collective.

Stage 3 gathers one layer at a time: :class:`GatherCast` takes a
float32 master shard, casts it to the compute dtype and all-gathers the
whole leaf in the forward; its backward reduce-scatters the leaf's
gradient (in float32, summed over the data-parallel ranks) back into the
shard.  The engine applies it to each layer's view of ``params
["blocks"]`` through the model's ``block_transform`` hook, inside the
remat unit, so under ``remat`` the gather reruns in the backward (the
JAX stage 3's scan gather, the reference's fetch and release); the
leaves outside ``blocks`` are gathered once a micro batch, where the
loss reads them.

Under tensor parallelism (stages 0-2) the rank's tree is its model
slice (``models/convert.py::tp_slice``) and the policy's specs carry the
``model`` axis, so a leaf's data shard is its chunk of that slice along
the data dim: rank (d, m) holds device (d, m)'s shard of the JAX
layout.  ``tp_dims`` (each leaf's model dim, or None) makes the global
norm count a model-sharded leaf's squares over the model ranks and a
replicated one once, and the overflow flag reduce over both axes.

Under pipeline parallelism the policy's specs carry ``pipe`` on the
stage dim of the stage-stacked ``blocks`` leaves: a rank's tree is its
stage's slice, and each of its leaves is sharded over that stage's data
group as above.  The global norm sums a pipe-local leaf's squares over
the stages and counts a leaf replicated over ``pipe`` once; the
overflow flag is reduced over the stages too.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence

import torch

from ... import comm
from ...parallel.collectives import REDUCE_PSUM, reduce_over_data
from ...parallel.topology import DATA_AXES, MODEL_AXIS, PIPE_AXIS
from ..optimizers import tree_leaves, tree_map
from .sharding import ZeroShardingPolicy, grad_reduce_plan, sharded_dim


def shard_leaf(t: torch.Tensor, dim: Optional[int], n: int,
               index: int) -> torch.Tensor:
    """Chunk ``index`` of ``n`` along ``dim`` as a tensor of its own
    (contiguous); ``t`` itself when ``dim`` is None or ``n`` is 1."""
    if dim is None or n == 1:
        return t
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} is not divisible "
                         f"by {n}")
    return t.chunk(n, dim)[index].clone(memory_format=torch.contiguous_format)


def gather_leaf(shard: torch.Tensor, dim: Optional[int],
                axes: Sequence[str] = DATA_AXES) -> torch.Tensor:
    """The whole leaf from every rank's shard along ``dim``."""
    if dim is None:
        return shard
    return comm.all_gather(shard, axes, axis=dim)


class GatherCast(torch.autograd.Function):
    """Forward: a float32 shard → the whole leaf in ``dtype`` (cast, then
    all-gathered along ``dim``).  Backward: the leaf's gradient → float32
    → reduce-scattered over the data-parallel ranks (their sum) along
    ``dim``: the shard's gradient, already reduced."""

    @staticmethod
    def forward(ctx, shard, dim, dtype, axes):
        ctx.dim, ctx.axes = dim, axes
        return comm.all_gather(shard.to(dtype), axes, axis=dim)

    @staticmethod
    def backward(ctx, grad):
        return (comm.reduce_scatter(grad.to(torch.float32),
                                    comm.ReduceOp.SUM, ctx.axes,
                                    scatter_dimension=ctx.dim),
                None, None, None)


class ZeroPartition:
    """This rank's part of a ZeRO stage over the data-parallel axes of
    ``mesh``: the plans of ``policy`` (each leaf's sharded dim for the
    masters and moments, the grads and the live params), and the
    collectives of the step written from them."""

    def __init__(self, policy: ZeroShardingPolicy, mesh,
                 axes: Sequence[str] = DATA_AXES, tp_dims=None):
        self.policy = policy
        self.tp_dims = tp_dims
        self.mp = mesh.axis_size(MODEL_AXIS)
        self.pp = mesh.axis_size(PIPE_AXIS)
        #: each leaf's stage dim (the ``pipe`` entry of its spec), or None
        self.pipe_dims = tree_map(lambda sp: sharded_dim(sp, (PIPE_AXIS,)),
                                  policy.param_specs)
        self.stage = policy.stage
        self.axes = tuple(axes)
        self.dp = mesh.axis_size(self.axes)
        self.index = mesh.axis_index(self.axes)
        self.master_dims = policy.master_param_dims()
        self.grad_dims = policy.grad_dims()
        self.param_dims = policy.model_param_dims()
        # each grad leaf: REDUCE_PSUM, or the dim to reduce-scatter along
        self.grad_plan, _ = grad_reduce_plan(
            policy.param_specs, policy.grad_specs(),
            [a for a in self.axes if mesh.shape[a] > 1])

    # -- shards ----------------------------------------------------------
    def shard(self, tree, dims):
        """This rank's shards of a whole tree along ``dims``."""
        return tree_map(lambda t, d: shard_leaf(t, d, self.dp, self.index),
                        tree, dims)

    def gather(self, tree, dims):
        """The whole tree from every rank's shards along ``dims``."""
        return tree_map(lambda t, d: gather_leaf(t, d, self.axes), tree,
                        dims)

    def sharded(self, dims) -> bool:
        return any(d is not None for d in tree_leaves(dims))

    # -- the live params ---------------------------------------------------
    def live_params(self, masters, dtype: torch.dtype):
        """Stages 1-2: the whole params in the compute dtype, each
        rank's master shard cast and all-gathered (stage 0 and 3 keep
        no live copy: stage 0 casts its whole masters, stage 3 gathers
        one layer at a time)."""
        def one(m, d):
            c = m.to(dtype) if m.is_floating_point() else m
            return gather_leaf(c, d, self.axes)
        return tree_map(one, masters, self.master_dims)

    def stage3_params(self, masters, dtype: torch.dtype):
        """Stage 3's tree for the loss from float32 master shards that
        require grad: each leaf outside ``blocks`` gathered (sharded) or
        cast (resident); ``blocks`` left as shards for
        :meth:`block_transform` to gather a layer at a time."""
        def leaf(m, d):
            if d is None:
                return m.to(dtype) if m.is_floating_point() else m
            return GatherCast.apply(m, d, dtype, self.axes)
        out = {}
        for k, v in masters.items():
            if k == "blocks" and self.sharded(self.param_dims[k]):
                out[k] = v
            else:
                out[k] = tree_map(leaf, v, self.param_dims[k])
        return out

    def block_transform(self, dtype: torch.dtype):
        """One layer's (or superblock's) view of ``blocks`` → the whole
        layer in ``dtype``: a sharded leaf along its dim less the layer
        dim, gathered; a resident leaf cast."""
        dims = self.param_dims["blocks"]

        def leaf(m, d):
            if d is None:
                return m.to(dtype) if m.is_floating_point() else m
            return GatherCast.apply(m, d - 1, dtype, self.axes)

        def transform(bp):
            return tree_map(leaf, bp, dims)
        return transform

    @contextlib.contextmanager
    def hooks(self, model, dtype: torch.dtype):
        """Stage 3: the model's ``block_transform`` gathers each layer
        for the duration of a forward and its backward (the remat
        recomputation reads the hook in the backward), then is
        restored."""
        if self.stage < 3 or not self.sharded(self.param_dims["blocks"]):
            yield
            return
        old = model.block_transform
        model.block_transform = self.block_transform(dtype)
        try:
            yield
        finally:
            model.block_transform = old

    # -- gradients -----------------------------------------------------------
    def reduce_micro(self, grads):
        """One micro batch's float32 grads at stage 2: each sharded leaf
        reduce-scattered into its shard (summed over the ranks) and its
        whole gradient dropped; resident leaves as they are (all-reduced
        once a step in :meth:`finish`).  Stage 3's sharded grads come
        out of :class:`GatherCast` reduced already."""
        if self.stage != 2:
            return grads

        def one(g, plan):
            return g if plan == REDUCE_PSUM else \
                reduce_over_data(g, plan, self.axes)
        return tree_map(one, grads, self.grad_plan)

    def finish(self, gsum):
        """The summed grads of a step → the grads of each rank's master
        shards, summed over the ranks: stages 0-1 all-reduce every leaf
        (stage 1 then keeps its shard), stages 2-3 all-reduce the
        resident leaves."""
        def one(g, plan, md):
            if plan == REDUCE_PSUM:
                g = reduce_over_data(g, REDUCE_PSUM, self.axes)
                return shard_leaf(g, md, self.dp, self.index)
            return g
        return tree_map(one, gsum, self.grad_plan, self.master_dims)

    def global_norm(self, grads) -> torch.Tensor:
        """sqrt of the sum of squares of the whole gradient: a leaf's
        squares summed over the ranks of each axis it is sharded along
        (data, model, pipe), a leaf replicated on all of them counted
        once (it is equal on every rank)."""
        groups: Dict[tuple, list] = {}
        tdims = (self.tp_dims if self.tp_dims is not None
                 else tree_map(lambda _: None, self.master_dims))

        def one(g, d, m, p):
            # paired by path, not by leaf order: a state loaded from a
            # checkpoint may hold its keys in another order than the
            # tree the plans were made from
            sq = torch.sum(torch.square(g.to(torch.float32)))
            groups.setdefault((d is not None, m is not None, p is not None),
                              []).append(sq)
        tree_map(one, grads, self.master_dims, tdims, self.pipe_dims)
        total = sum(groups.pop((False, False, False), []))
        for (over_data, over_model, over_pipe), sqs in sorted(groups.items()):
            part = sum(sqs)
            if over_data:
                part = comm.all_reduce(part, comm.ReduceOp.SUM, self.axes)
            if over_model:
                part = comm.all_reduce(part, comm.ReduceOp.SUM, MODEL_AXIS)
            if over_pipe:
                part = comm.all_reduce(part, comm.ReduceOp.SUM, PIPE_AXIS)
            total = part + total
        return torch.sqrt(total)

    def reduce_flag(self, flag: torch.Tensor) -> torch.Tensor:
        """A per-rank boolean (an fp16 overflow) → true on every rank if
        true on any (over the data ranks, then the model ranks, then the
        stages)."""
        f = comm.all_reduce(flag.to(torch.int32), comm.ReduceOp.MAX,
                            self.axes)
        if self.mp > 1:
            f = comm.all_reduce(f, comm.ReduceOp.MAX, MODEL_AXIS)
        if self.pp > 1:
            f = comm.all_reduce(f, comm.ReduceOp.MAX, PIPE_AXIS)
        return f.bool()

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of a per-rank scalar over the ranks."""
        return comm.all_reduce(x.clone(), comm.ReduceOp.SUM, self.axes) / \
            self.dp

    # -- bytes -----------------------------------------------------------------
    def planned_bytes(self, shapes, compute_itemsize: int,
                      moments: int = 2) -> Dict[str, int]:
        """What the plans say this rank holds: float32 masters and
        ``moments`` optimizer trees along the masters' dims, the step's
        float32 gradient sum along the grads' dims, and the live
        compute-dtype params (whole at stages 1-2; stages 0 and 3 keep
        none)."""
        def count(dims):
            n = 0
            for s, d in zip(tree_leaves(shapes), tree_leaves(dims)):
                numel = 1
                for x in s:
                    numel *= x
                n += numel // self.dp if d is not None else numel
            return n
        masters = count(self.master_dims)
        whole = count(tree_map(lambda _: None, self.master_dims))
        return {"params": 4 * masters, "opt": 4 * moments * masters,
                "grads": 4 * count(self.grad_dims),
                "live": compute_itemsize * whole
                if self.stage in (1, 2) else 0}


def tree_bytes(tree) -> int:
    """Bytes of every tensor leaf of nested dicts."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def shape_tree(tree):
    return tree_map(lambda t: tuple(t.shape), tree)
