"""Mixture-of-Experts: top-k gating, dispatch, PR-MoE, expert parallelism.

Counterpart of ``deepspeed_tpu/moe/``: expert weights are a stacked
``[E, ...]`` tree, cut over the ``expert`` mesh axis on E (and inside
each expert over ``model``) where a mesh has those axes; every rank
routes the whole batch (``layer.py``'s ``Placement``).
"""
from .layer import MoEConfig, MoELayer, mlp_expert
from .sharded_moe import GateOutput, capacity, gate, top1_gating, top2_gating

__all__ = ["MoEConfig", "MoELayer", "mlp_expert", "GateOutput", "capacity",
           "gate", "top1_gating", "top2_gating"]
