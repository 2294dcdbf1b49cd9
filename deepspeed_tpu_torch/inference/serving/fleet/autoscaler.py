"""SLO-driven fleet autoscaler: the control loop that closes the
burn-rate loop (copy of ``deepspeed_tpu/inference/serving/fleet/
autoscaler.py`` for the PyTorch port).

The sensors already exist — the :class:`SloMonitor` fires per-tenant
TTFT/ITL burn-rate alerts *before* the objective is breached (that is
what a burn-rate threshold is), and every replica exposes its queue
depth.  The actuators already exist — the router's ``join()``/
``drain()`` lifecycle.  This module is ONLY the policy in
between, and it is deliberately boring: per-class decisions with
hysteresis (separate scale-up and scale-down triggers), cooldowns (one
bounded action per class per window, however loud the alert storm), a
chip budget (scale-up is denied, not deferred, when the fleet is at
its hardware ceiling), and the never-drain-last invariant (scale-down
refuses to remove the last healthy replica of a class — a control
loop must not be able to turn a slow fleet into a dead one).

Alert kinds map to classes: TTFT pain is prefill-side (time to first
token is dominated by prefill queueing), ITL pain is decode-side.  A
uniform (classless) fleet maps both to its single "mixed" class.

The actuator itself is a fault-injection site
(``serving.fleet.scale``): transient faults skip
the action WITHOUT charging the cooldown (the decision retries next
tick), fatal faults abandon it, count it, and DO charge the cooldown —
a broken actuator degrades to a statically-sized fleet, it never
wedges the serving path or spins the spawner.

Pure policy, synchronous, injectable clock: every decision is unit-
testable on a synthetic timeline with a stub router, no device, no
threads, no sleeps.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from ....observability import get_registry
from ....observability.fleet_metrics import FleetMetricsAggregator
from ....observability.slo import KIND_TTFT, SloAlert
from ....runtime.resilience.errors import (FatalIOError,
                                           TransientIOError)
from ....runtime.resilience.fault_injection import get_fault_injector
from ....utils.logging import logger
from .replica import ReplicaHandle, ReplicaState

__all__ = ["FleetAutoscaler"]


class FleetAutoscaler:
    """Per-class join/drain policy over a :class:`FleetRouter`.

    ``spawn_fn(role) -> ReplicaHandle`` builds a cold replica of the
    given class (the caller wires the engine, the shared host tier and
    the heartbeat); the autoscaler joins it through the router so it
    inherits the normal lifecycle.  Scale-down picks the least-loaded
    healthy replica of the class and begins a NON-pumping drain — the
    fleet's own pump keeps stepping it, and the autoscaler retires it
    on a later tick once idle, so scale-down never blocks the control
    loop and never terminalizes a running request.
    """

    def __init__(self, router, spawn_fn: Callable[[str], ReplicaHandle],
                 slo_monitor=None,
                 clock: Callable[[], float] = time.monotonic,
                 chip_budget: int = 8, chips_per_replica: int = 1,
                 min_per_class: int = 1,
                 scale_up_cooldown_s: float = 5.0,
                 scale_down_cooldown_s: float = 30.0,
                 queue_high: float = 8.0, queue_low: float = 1.0,
                 quiet_s: float = 10.0,
                 aggregator: Optional[FleetMetricsAggregator] = None):
        if chip_budget < 1 or chips_per_replica < 1:
            raise ValueError("chip_budget and chips_per_replica must "
                             "be >= 1")
        if min_per_class < 1:
            raise ValueError("min_per_class must be >= 1 — the "
                             "autoscaler must never empty a class")
        if queue_low > queue_high:
            raise ValueError(f"queue_low ({queue_low}) must be <= "
                             f"queue_high ({queue_high})")
        self.router = router
        self.spawn_fn = spawn_fn
        self.clock = clock
        #: ONE metrics surface for policy and dashboards: the sensor
        #: path reads per-class queue depth and SLO burn rate from the
        #: fleet aggregator (refreshed each tick) instead of poking
        #: replica handles ad hoc — a real FleetRouter shares its own
        #: aggregator, stub routers get a private one
        self.aggregator = (aggregator if aggregator is not None
                           else getattr(router, "aggregator", None)
                           or FleetMetricsAggregator())
        self.chip_budget = chip_budget
        self.chips_per_replica = chips_per_replica
        self.min_per_class = min_per_class
        self.scale_up_cooldown_s = scale_up_cooldown_s
        self.scale_down_cooldown_s = scale_down_cooldown_s
        self.queue_high = queue_high
        self.queue_low = queue_low
        self.quiet_s = quiet_s
        #: scale decisions, in order: dicts with t/action/role/replica/
        #: reason — the bench correlates these with breach timestamps
        self.events: List[Dict] = []
        self.counts = {"scale_ups": 0, "scale_downs": 0,
                       "budget_denials": 0, "actuator_failures": 0}
        self._alerts: List[SloAlert] = []
        self._alert_lock = threading.Lock()
        self._last_up: Dict[str, float] = {}
        self._last_down: Dict[str, float] = {}
        #: last tick the class was NOT quiet (queue > low watermark or
        #: an alert firing) — scale-down waits quiet_s past this
        self._last_busy: Dict[str, float] = {}
        self._spawned = 0
        if slo_monitor is not None:
            slo_monitor.subscribe(self._on_alert)
        reg = get_registry()
        self._m_ups = reg.counter(
            "dstpu_fleet_scale_ups_total",
            "replicas joined by the SLO-driven autoscaler")
        self._m_downs = reg.counter(
            "dstpu_fleet_scale_downs_total",
            "replicas drained by the SLO-driven autoscaler")
        self._m_denials = reg.counter(
            "dstpu_fleet_scale_budget_denials_total",
            "scale-ups denied at the chip budget ceiling")
        self._m_actuator_failures = reg.counter(
            "dstpu_fleet_scale_actuator_failures_total",
            "scale actions abandoned on a fatal actuator fault")

    # -- sensor intake -----------------------------------------------------
    def _on_alert(self, alert: SloAlert) -> None:
        """SloMonitor subscription callback (may fire from any thread
        observing latencies): buffer, act on the next tick."""
        if alert.state == "firing":
            with self._alert_lock:
                self._alerts.append(alert)

    @staticmethod
    def _kind_class(kind: str, classes: List[str]) -> str:
        """TTFT pain -> prefill class, ITL pain -> decode class; fall
        back to whatever single class a uniform fleet has."""
        want = "prefill" if kind == KIND_TTFT else "decode"
        if want in classes:
            return want
        return classes[0] if classes else want

    # -- fleet introspection -----------------------------------------------
    def _classes(self) -> List[str]:
        roles = {getattr(r, "role", "mixed")
                 for r in self.router.replicas if r.alive}
        return sorted(roles)

    def _healthy(self, role: str) -> List[ReplicaHandle]:
        return [r for r in self.router.replicas
                if r.state is ReplicaState.HEALTHY
                and getattr(r, "role", "mixed") == role]

    def _chips_used(self) -> int:
        return self.chips_per_replica * sum(
            1 for r in self.router.replicas if r.alive)

    # -- the control loop --------------------------------------------------
    def tick(self, now: Optional[float] = None) -> List[Dict]:
        """One policy evaluation: consume buffered alerts, read
        per-class queue depths, emit at most one bounded action per
        class (hysteresis: an alert storm collapses into one scale-up
        per cooldown window).  Also retires any previously-drained
        replica that has gone idle.  Returns the scale events this tick
        appended."""
        now = self.clock() if now is None else now
        with self._alert_lock:
            alerts, self._alerts = self._alerts, []
        self._retire_idle_drains()
        # refresh the fleet metrics surface, then read policy inputs
        # from IT — the same numbers the dashboards see
        self.aggregator.observe_router(self.router)
        classes = self._classes()
        firing = {self._kind_class(a.kind, classes) for a in alerts}
        before = len(self.events)
        for role in classes:
            depth = self.aggregator.class_queue_depth(
                role, healthy_only=True)
            n = self.aggregator.class_replicas(role, healthy_only=True)
            per_replica = depth / max(1, n)
            busy = role in firing or per_replica > self.queue_low
            if busy:
                self._last_busy[role] = now
            if role in firing or per_replica > self.queue_high:
                reason = ("burn-rate alert" if role in firing
                          else f"queue depth {per_replica:.1f}/replica "
                               f"> {self.queue_high}")
                self._scale_up(role, reason, now)
            elif (not busy
                  and now - self._last_busy.get(role, now) >= self.quiet_s):
                self._scale_down(role, now)
        return self.events[before:]

    def _scale_up(self, role: str, reason: str, now: float) -> bool:
        if now - self._last_up.get(role, -float("inf")) \
                < self.scale_up_cooldown_s:
            return False                 # one action per window
        if self._chips_used() + self.chips_per_replica > self.chip_budget:
            self.counts["budget_denials"] += 1
            self._m_denials.inc()
            return False
        if not self._actuate("up", role, now):
            return False
        handle = self.spawn_fn(role)
        self.router.join(handle)
        self._spawned += 1
        self._last_up[role] = now
        self.counts["scale_ups"] += 1
        self._m_ups.inc()
        self.events.append({"t": now, "action": "up", "role": role,
                            "replica": handle.replica_id,
                            "reason": reason})
        logger.info(f"autoscaler: +1 {role} replica "
                    f"({handle.replica_id}): {reason}")
        return True

    def _scale_down(self, role: str, now: float) -> bool:
        if now - self._last_down.get(role, -float("inf")) \
                < self.scale_down_cooldown_s:
            return False
        healthy = self._healthy(role)
        if len(healthy) <= self.min_per_class:
            return False                 # never drain the last replica
        if not self._actuate("down", role, now):
            return False
        victim = min(healthy, key=lambda r: r.queue_depth)
        self.router.drain(victim, pump=False)
        self._last_down[role] = now
        self.counts["scale_downs"] += 1
        self._m_downs.inc()
        self.events.append({"t": now, "action": "down", "role": role,
                            "replica": victim.replica_id,
                            "reason": f"quiet >= {self.quiet_s}s"})
        logger.info(f"autoscaler: draining {role} replica "
                    f"{victim.replica_id} (quiet)")
        return True

    def _actuate(self, action: str, role: str, now: float) -> bool:
        """The ``serving.fleet.scale`` fault site guards every actuator
        call.  Transient: skip WITHOUT charging the cooldown — the same
        decision retries next tick.  Fatal: abandon the action, count
        it, and charge the cooldown so a permanently broken actuator
        does not retry at tick rate — the fleet degrades to its current
        size, serving correctness untouched."""
        try:
            get_fault_injector().check("serving.fleet.scale")
            return True
        except TransientIOError:
            return False
        except FatalIOError as e:
            self.counts["actuator_failures"] += 1
            self._m_actuator_failures.inc()
            if action == "up":
                self._last_up[role] = now
            else:
                self._last_down[role] = now
            logger.warning(f"autoscaler: scale-{action} of {role} "
                           f"abandoned on fatal actuator fault: {e}")
            return False

    def _retire_idle_drains(self) -> None:
        """Finish scale-downs: a replica this policy put in DRAINING
        retires once the fleet pump has drained it dry."""
        for r in self.router.replicas:
            if r.state is ReplicaState.DRAINING and not r.has_work():
                r.retire()
                self.router._m_drains.inc()
                self.router.fleet_counts["drains"] += 1
                self.router._reap_publisher(r)
