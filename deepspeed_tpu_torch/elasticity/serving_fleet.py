"""Agent-side liveness for the serving fleet — the in-process serving
analogue of the elastic agent's hung-worker sweep (copy of
``deepspeed_tpu/elasticity/serving_fleet.py`` for the PyTorch port).

The elastic agent watches per-generation heartbeat files to tell a DEAD
training worker (poll() returns) from a HUNG one (process alive, no
progress).  A threaded serving replica has exactly the same blind spot:
its thread object stays alive while the engine is wedged in a device
sync.  The contract is shared: every ``ServingEngine.step()`` stamps a
beat at the iteration boundary (``resilience/heartbeat.py``), and this
monitor sweeps the per-replica files with the same ``Watchdog`` the
agent uses — a replica whose beat is stale past the timeout is declared
dead, which feeds the fleet's token-exact failover path instead of the
agent's re-rendezvous.
"""
from __future__ import annotations

import os
from typing import List, Sequence

from ..runtime.resilience import Watchdog


class ReplicaLivenessMonitor:
    """Staleness sweep over a fleet's per-replica heartbeat files.

    ``path_for`` names the file a replica's engine must beat (the
    ``ReplicaHandle`` installs it on the engine's ``heartbeat``);
    ``stale_replicas`` returns the ids whose beat is older than the
    watchdog timeout.  Replicas that never wrote a file at all count as
    stale — a replica that never checked in is indistinguishable from
    one that hung before its first iteration."""

    def __init__(self, heartbeat_dir: str, timeout_s: float):
        self.heartbeat_dir = heartbeat_dir
        os.makedirs(heartbeat_dir, exist_ok=True)
        self._watchdog = Watchdog(timeout_s)

    @property
    def timeout_s(self) -> float:
        return self._watchdog.timeout_s

    def path_for(self, replica_id: str) -> str:
        return os.path.join(self.heartbeat_dir, f"{replica_id}.heartbeat")

    def stale_replicas(self, replica_ids: Sequence[str]) -> List[str]:
        paths = [self.path_for(r) for r in replica_ids]
        return [replica_ids[i] for i in self._watchdog.stale(paths)]
