"""Resilient serving fleet: health-checked replicas behind a router
with token-exact failover (copy of ``deepspeed_tpu/inference/serving/
fleet/`` for the PyTorch port).

Many :class:`~..engine.ServingEngine` replicas, one front door.  The
:class:`FleetRouter` places each request on the replica whose
radix/host-tier digests already cover the longest prompt prefix (traded
against queue depth), and survives replica death as a non-event: every
in-flight request of a dead replica is resubmitted to a healthy one
with its original sampling key — the replayed stream is the same —
and a per-request :class:`~..frontend.streaming.StreamDeduper` forwards
only tokens past the delivered high-water mark, so clients observe
exactly-once token delivery with no visible restart.
"""
from .autoscaler import FleetAutoscaler
from .replica import ReplicaHandle, ReplicaState
from .router import FleetRequest, FleetRouter, placement_score

__all__ = ["FleetAutoscaler", "ReplicaHandle", "ReplicaState",
           "FleetRequest", "FleetRouter", "placement_score"]
