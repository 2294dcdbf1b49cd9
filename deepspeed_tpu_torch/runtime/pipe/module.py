"""Pipeline module expression.

Counterpart of ``deepspeed_tpu/runtime/pipe/module.py`` (the
reference's ``LayerSpec``, ``TiedLayerSpec`` and ``PipelineModule``,
``runtime/pipe/module.py:24``, ``:56``, ``:86``): a model as a flat
list of layers, cut into stages by ``partition_layers`` ("uniform",
"parameters" or "type:<regex>"; ``runtime/utils.py`` balances).  The
pipeline engine trains the model families' ``TransformerLM`` through
``engine.PipelinedLM`` (a stage-stacked params tree); this module is the
partition's bookkeeping.  A layer's parameter count comes from building
it on the ``meta`` device, which allocates nothing.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from ..utils import (partition_balanced, partition_uniform,
                     tree_param_count)


class LayerSpec:
    """A deferred layer: ``init(generator)`` builds its params tree,
    ``apply(params, x)`` runs it (the reference defers building the
    module so only the owning stage holds its weights)."""

    def __init__(self, init_fn: Callable, apply_fn: Callable,
                 typename: str = "Layer"):
        self.init_fn = init_fn
        self.apply_fn = apply_fn
        self.typename = typename

    def build(self, generator):
        return self.init_fn(generator)

    def param_count(self) -> int:
        """Elements of the layer's params, built on the ``meta``
        device."""
        with torch.device("meta"):
            return tree_param_count(self.init_fn(None))


class TiedLayerSpec(LayerSpec):
    """A layer whose params are shared across stages by ``key`` (the
    reference's ``pipe/module.py:56``: tied input and output
    embeddings)."""

    def __init__(self, key: str, init_fn, apply_fn, typename="TiedLayer",
                 forward_fn: Optional[Callable] = None):
        super().__init__(init_fn, apply_fn, typename)
        self.key = key
        self.forward_fn = forward_fn or apply_fn


def partition_layers(layer_specs: Sequence[LayerSpec], num_stages: int,
                     method: str = "parameters") -> List[int]:
    """Stage boundaries over the layer list (the reference's
    ``pipe/module.py:365``)."""
    n = len(layer_specs)
    method = method.lower()
    if method == "uniform":
        return partition_uniform(n, num_stages)
    if method == "parameters":
        weights = [max(1, s.param_count()) for s in layer_specs]
        return partition_balanced(weights, num_stages)
    if method.startswith("type:"):
        pat = re.compile(method[5:], re.IGNORECASE)
        weights = [1 if pat.search(s.typename) else 0 for s in layer_specs]
        return partition_balanced([max(w, 0) + 1e-9 for w in weights],
                                  num_stages)
    raise ValueError(f"Unknown partition method {method}")


class PipelineModule:
    """A model as a flat layer list for the pipeline (the reference's
    ``pipe/module.py:86``); ``boundaries`` is the partition."""

    def __init__(self, layers: Sequence[LayerSpec], num_stages: int,
                 partition_method: str = "parameters",
                 loss_fn: Optional[Callable] = None):
        self.layer_specs = list(layers)
        self.num_stages = num_stages
        self.partition_method = partition_method
        self.loss_fn = loss_fn
        self.boundaries = partition_layers(self.layer_specs, num_stages,
                                           partition_method)
        self.tied_keys = sorted({s.key for s in self.layer_specs
                                 if isinstance(s, TiedLayerSpec)})

    def stage_layers(self, stage_id: int) -> List[LayerSpec]:
        lo, hi = self.boundaries[stage_id], self.boundaries[stage_id + 1]
        return self.layer_specs[lo:hi]

    def init(self, generator) -> Dict[str, Any]:
        """``{"tied": {key: params}, "stages": [each stage's layer
        params]}``, every layer built from ``generator`` in order; a tied
        layer is built once and referenced as ``{"__tied__": key}``."""
        tied: Dict[str, Any] = {}
        stages = []
        for sid in range(self.num_stages):
            layer_params = []
            for spec in self.stage_layers(sid):
                if isinstance(spec, TiedLayerSpec):
                    if spec.key not in tied:
                        tied[spec.key] = spec.build(generator)
                    layer_params.append({"__tied__": spec.key})
                else:
                    layer_params.append(spec.build(generator))
            stages.append(layer_params)
        return {"tied": tied, "stages": stages}
