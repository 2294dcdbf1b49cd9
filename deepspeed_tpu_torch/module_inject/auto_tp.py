"""Auto tensor-parallelism for models without partition specs.

Counterpart of ``deepspeed_tpu/module_inject/auto_tp.py``: from the
params tree's shapes alone, a spec tree that shards each weight's
largest dim divisible by the ``model`` axis size; biases, scalars and
small leaves stay replicated.  A spec is a tuple with one entry per dim
(None or ``"model"``), as a ``PartitionSpec``.

The JAX package hands such specs to GSPMD, which places the collectives
itself.  The port's engines run tensor parallelism eagerly through a
model's per-shard view (``TransformerLM.tp_serving_view`` /
``tp_train_view``) and its Megatron layout (``partition_specs``), which
names where each all-reduce goes; these specs describe a layout and
place no collective.
"""
from __future__ import annotations

import numpy as np

from ..parallel.topology import MODEL_AXIS


def auto_tp_specs(param_shapes, mesh, min_size: int = 1024):
    """Shapes tree (nested dicts of shapes or anything with ``.shape``)
    → spec tree over ``model``; ``mesh`` is anything with a ``shape``
    mapping of axis sizes.  Leaves with fewer than 2 dims, under
    ``min_size`` elements, or with no dim the axis size divides stay
    replicated."""
    tp = mesh.shape.get(MODEL_AXIS, 1)

    def spec(leaf):
        shape = tuple(getattr(leaf, "shape", leaf))
        entries = [None] * len(shape)
        if tp > 1 and len(shape) >= 2 and int(np.prod(shape)) >= min_size:
            divisible = [d for d, s in enumerate(shape) if s % tp == 0]
            if divisible:
                best = max(divisible, key=lambda d: shape[d])
                entries[best] = MODEL_AXIS
        return tuple(entries)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return spec(tree)
    return walk(param_shapes)
