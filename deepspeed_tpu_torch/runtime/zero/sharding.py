"""ZeRO's sharding policy, as plans.

Counterpart of ``deepspeed_tpu/runtime/zero/sharding.py``.  The JAX
package turns the model's tensor-parallel specs into spec trees over the
``data`` mesh axis and lets XLA emit the collectives.  The port keeps
the same policy and the same spec trees (a spec here is a tuple with one
entry per dim: None, an axis name, or a tuple of names, as a
``PartitionSpec``), and reads from them, for each leaf, the dim that is
sharded over the data-parallel product, or None where the leaf stays
replicated; ``runtime/zero/partitioned.py`` and the engine write the
collectives from those plans:

  stage 0 — grads all-reduced over data (classic DP)
  stage 1 — float32 masters and optimizer moments sharded over data;
            grads all-reduced, each rank updates its shard, the new
            compute-dtype params all-gathered
  stage 2 — + grads reduce-scattered into shards
  stage 3 — + live params sharded, gathered one layer at a time

The rule (``shard_over_axis``): shard the largest dim that is not
claimed by another mesh axis and that the data-parallel size divides;
the layer dim 0 of ``params["blocks"]`` leaves is excluded (a layer is
the unit gathered at stage 3), and so is any leaf under
``min_partition_size`` elements (at stage 3 also under
``param_persistence_threshold``: small params stay resident).  A leaf
with no such dim stays replicated.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple, Union

import numpy as np

from ...parallel.collectives import REDUCE_PSUM
from ...parallel.topology import DATA_AXES, DATA_AXIS

Spec = Tuple[Any, ...]


def _spec_entries(spec: Optional[Sequence], ndim: int) -> list:
    entries = list(spec) if spec is not None else []
    entries += [None] * (ndim - len(entries))
    return entries


def _names(e) -> Tuple[str, ...]:
    if e is None:
        return ()
    return tuple(e) if isinstance(e, (tuple, list)) else (e,)


def _used_axes(entries) -> set:
    used = set()
    for e in entries:
        used.update(_names(e))
    return used


def _shape(x) -> Tuple[int, ...]:
    return tuple(getattr(x, "shape", x))


def _map(fn, tree, *rest, path=()):
    """``fn(path, leaf, *others)`` over nested dicts; leaves are anything
    that is not a dict."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest), path=path + (k,))
                for k, v in tree.items()}
    return fn(path, tree, *rest)


def shard_over_axis(spec: Optional[Sequence], shape: Tuple[int, ...], mesh,
                    axis: Union[str, Sequence[str]] = DATA_AXIS,
                    exclude_dims: Sequence[int] = (),
                    min_size: int = 0) -> Spec:
    """Add ``axis`` (one mesh axis name, or a sequence sharded jointly —
    the data-parallel product ``(dcn_data, data)``) to the largest free
    dim of ``shape`` divisible by the combined axis size; unchanged if
    every requested axis is already used or of size 1, or no dim
    qualifies (→ replicated, the small-param persistence case).
    ``mesh`` is anything with a ``shape`` mapping of axis sizes."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    entries = _spec_entries(spec, len(shape))
    axes = tuple(a for a in axes
                 if mesh.shape.get(a, 1) > 1 and a not in _used_axes(entries))
    axis_size = int(np.prod([mesh.shape[a] for a in axes])) if axes else 1
    if axis_size <= 1:
        return tuple(entries)
    if int(np.prod(shape)) < min_size:
        return tuple(entries)
    best, best_size = None, 0
    for d, (e, s) in enumerate(zip(entries, shape)):
        if d in exclude_dims:
            continue
        existing = 1
        for n in _names(e):
            existing *= mesh.shape.get(n, 1)
        if s % (existing * axis_size) != 0:
            continue
        if s >= best_size:
            best, best_size = d, s
    if best is None:
        return tuple(entries)
    e = entries[best]
    if e is None:
        entries[best] = axes if len(axes) > 1 else axes[0]
    else:
        entries[best] = _names(e) + axes
    return tuple(entries)


def sharded_dim(spec: Optional[Sequence],
                axes: Sequence[str] = DATA_AXES) -> Optional[int]:
    """The dim of ``spec`` that carries any of ``axes``, else None."""
    for d, e in enumerate(spec or ()):
        if set(_names(e)) & set(axes):
            return d
    return None


def grad_reduce_plan(region_specs, grad_specs, data_axes: Sequence[str]):
    """Per-leaf plan for reducing gradients over the data-parallel axis
    product.  ``region_specs``: the params' specs without the data axes;
    ``grad_specs``: the policy's grad specs; ``data_axes``: the
    data-parallel axes above 1, in mesh order.  Returns ``(plan_tree,
    out_spec_tree)``: a plan leaf is ``REDUCE_PSUM`` (all-reduce) or the
    dim ``d`` to reduce-scatter along (the dim the policy shards, so the
    gradient lands in its stage-2 layout); an out spec is the region
    spec with the data axes at that dim."""
    dset = set(data_axes)

    def one(_path, rsp, gsp):
        ndim = max(len(gsp or ()), len(rsp or ()))
        gentries = _spec_entries(gsp, ndim)
        out = _spec_entries(rsp, ndim)
        for d, e in enumerate(gentries):
            if dset & set(_names(e)):
                joint = (tuple(data_axes) if len(data_axes) > 1
                         else data_axes[0])
                out[d] = joint if out[d] is None else \
                    _names(out[d]) + tuple(data_axes)
                return d, tuple(out)
        return REDUCE_PSUM, tuple(out)

    pairs = _map(one, region_specs, grad_specs)
    plan = _map(lambda _p, pr: pr[0], pairs)
    out_specs = _map(lambda _p, pr: pr[1], pairs)
    return plan, out_specs


class ZeroShardingPolicy:
    """All spec trees of a ZeRO stage, and the dims read from them.

    ``param_shapes``: the params tree's shapes (shapes, tensors or
    anything with ``.shape``); ``param_specs``: the params' model-axis
    specs (None: no other axis, every dim free); ``scan_axis_paths``: the
    subtrees whose dim 0 is the layer axis (excluded from sharding, so
    stage 3 gathers one layer at a time)."""

    def __init__(self, stage: int, mesh, param_shapes: Any,
                 param_specs: Any = None,
                 scan_axis_paths: Sequence[str] = ("blocks",),
                 min_partition_size: int = 0,
                 param_persistence_threshold: int = 0):
        if not 0 <= stage <= 3:
            raise ValueError(f"ZeRO stage must be 0..3, got {stage}")
        self.stage = stage
        self.mesh = mesh
        self.param_shapes = _map(lambda _p, s: _shape(s), param_shapes)
        self.param_specs = (param_specs if param_specs is not None else
                            _map(lambda _p, s: (None,) * len(s),
                                 self.param_shapes))
        self.scan_axis_paths = tuple(scan_axis_paths)
        # stage 3: params below param_persistence_threshold elements stay
        # resident (replicated) in every stage-3 spec tree, the
        # reference's persisted-param set
        if stage >= 3:
            min_partition_size = max(min_partition_size,
                                     param_persistence_threshold)
        self.min_partition_size = min_partition_size
        self.param_persistence_threshold = param_persistence_threshold

    def _sharded_tree(self):
        def f(path, spec, shape):
            excl = (0,) if (path and path[0] in self.scan_axis_paths) \
                else ()
            return shard_over_axis(spec, shape, self.mesh, DATA_AXES,
                                   exclude_dims=excl,
                                   min_size=self.min_partition_size)
        return _map(f, self.param_specs, self.param_shapes)

    # -- spec trees --------------------------------------------------------
    def model_param_specs(self):
        """Specs of the live (compute-dtype) params."""
        return self._sharded_tree() if self.stage >= 3 else self.param_specs

    def master_param_specs(self):
        """float32 masters live with the optimizer state."""
        return self._sharded_tree() if self.stage >= 1 else self.param_specs

    def grad_specs(self):
        return self._sharded_tree() if self.stage >= 2 else self.param_specs

    # -- the sharded dim of every leaf ---------------------------------------
    def model_param_dims(self):
        return _map(lambda _p, s: sharded_dim(s), self.model_param_specs())

    def master_param_dims(self):
        return _map(lambda _p, s: sharded_dim(s), self.master_param_specs())

    def grad_dims(self):
        return _map(lambda _p, s: sharded_dim(s), self.grad_specs())

    def moment_dims(self):
        """The moments' dims: the masters' (the optimizer's trees of the
        params' shape are sharded exactly as the masters)."""
        return self.master_param_dims()
