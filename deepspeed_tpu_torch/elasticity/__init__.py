"""Elasticity of the port: the serving fleet's replica liveness monitor.
The JAX package's elastic training agent, rendezvous and elastic config
come with ROADMAP.md queue A item 9."""
from .serving_fleet import ReplicaLivenessMonitor

__all__ = ["ReplicaLivenessMonitor"]
