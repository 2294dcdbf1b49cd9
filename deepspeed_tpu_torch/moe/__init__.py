"""Mixture-of-Experts on one device: top-k gating, dispatch, PR-MoE.

Counterpart of ``deepspeed_tpu/moe/``: expert weights are a stacked
``[E, ...]`` tree, and every expert runs on the one card (the
expert-parallel mesh is ROADMAP.md queue A item 7).
"""
from .layer import MoEConfig, MoELayer, mlp_expert
from .sharded_moe import GateOutput, capacity, gate, top1_gating, top2_gating

__all__ = ["MoEConfig", "MoELayer", "mlp_expert", "GateOutput", "capacity",
           "gate", "top1_gating", "top2_gating"]
