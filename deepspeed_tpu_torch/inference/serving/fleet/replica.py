"""One fleet replica: a ``ServingEngine`` plus health, thread, and
submission plumbing (copy of ``deepspeed_tpu/inference/serving/fleet/
replica.py`` for the PyTorch port).

A replica is HEALTHY while its engine reaches iteration boundaries (the
engine stamps a liveness beat there — ``resilience/heartbeat.py``), and
DEAD the moment a step raises :class:`ServingError` or the injected
``serving.fleet.replica_step`` site fires a fatal.  Death is absorbing:
the handle never raises out of :meth:`step`; it seals the engine's
flight-recorder bundle, flips state, and leaves the router to replay
the in-flight work elsewhere.  DRAINING stops NEW fleet routes while
the engine finishes everything already admitted or queued — the
engine's request lifecycle does the finishing, the handle only watches for idle — and
RETIRED is the clean end state drain reaches.

Two stepping modes share all of that logic:

* **cooperative** (default): the router pumps :meth:`step` from its own
  thread — fully deterministic, what the tests and the chaos matrix
  drive;
* **threaded**: :meth:`start` spawns a daemon serving thread; callers
  hand work over through a thread-safe inbox drained at iteration
  boundaries, and health additionally falls to the heartbeat watchdog
  (a wedged device sync keeps the thread alive but not the beat).
"""
from __future__ import annotations

import dataclasses
import enum
import threading
from typing import Callable, List, Optional, Sequence

from ....observability import get_flight_recorder, get_registry
from ....observability.metrics import tenant_metric_name
from ....runtime.resilience.errors import (FatalIOError, ServingError,
                                           TransientIOError)
from ....runtime.resilience.fault_injection import get_fault_injector
from ....runtime.resilience.heartbeat import Heartbeat, is_stale
from ..scheduler import Request


class ReplicaState(enum.Enum):
    STARTING = "starting"    # built, not yet routable (pre-join)
    HEALTHY = "healthy"      # routable, stepping
    DRAINING = "draining"    # no new routes; finishing admitted work
    RETIRED = "retired"      # drained clean; engine idle forever
    DEAD = "dead"            # ServingError / injected fatal / stale beat


#: legal lifecycle edges of every ``.state = ReplicaState.X``
#: assignment.  A replica
#: that jumps STARTING → DRAINING never drains its queue; a RETIRED
#: one resurrected by a stray write double-serves failed-over streams.
_TRANSITIONS = {
    ReplicaState.STARTING: (ReplicaState.HEALTHY, ReplicaState.DEAD),
    ReplicaState.HEALTHY: (ReplicaState.DRAINING, ReplicaState.DEAD),
    ReplicaState.DRAINING: (ReplicaState.RETIRED, ReplicaState.DEAD),
    ReplicaState.RETIRED: (),
    ReplicaState.DEAD: (),
}


@dataclasses.dataclass
class SubmitSpec:
    """One router→replica submission, carried through the inbox so a
    threaded replica only touches its engine on the serving thread.
    ``key_override`` replays a failover victim with its ORIGINAL
    sampling key — what makes the resumed stream the same whatever base
    key this replica was built with."""
    prompt: List[int]
    max_new_tokens: int
    eos_token_id: Optional[int] = None
    deadline_s: Optional[float] = None
    temperature: Optional[float] = None
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    seed: Optional[int] = None
    tenant: str = "default"
    on_token: Optional[Callable] = None
    key_override: Optional[int] = None
    #: fleet-wide trace context (observability/fleet_trace.py): minted
    #: once by the router and carried into EVERY leg's engine submit, so
    #: prefill, decode and failover-replay timelines share one trace id
    trace_id: Optional[str] = None
    #: fn(engine Request) — the router's bookkeeping tap, called right
    #: after the engine accepts (NOT called for a submit-time shed:
    #: the shed's tokenless terminal event already reached on_token)
    on_submitted: Optional[Callable] = None
    #: disaggregated prefill leg: compute + publish the prompt's KV,
    #: emit no tokens, finish OK at prefill completion
    prefill_only: bool = False


class ReplicaHandle:
    """One ``ServingEngine`` behind the fleet router."""

    def __init__(self, replica_id: str, serving_engine,
                 heartbeat_path: Optional[str] = None,
                 heartbeat_interval_s: float = 1.0,
                 heartbeat_timeout_s: float = 0.0,
                 role: str = "mixed"):
        self.replica_id = replica_id
        self.srv = serving_engine
        #: replica class for disaggregated placement: "prefill" runs
        #: handoff prefill legs only; "decode"/"mixed" serve streams
        self.role = role
        self.state = ReplicaState.STARTING
        self.death_reason: Optional[str] = None
        self.heartbeat_path = heartbeat_path
        self.heartbeat_timeout_s = heartbeat_timeout_s
        if heartbeat_path is not None:
            # replace the engine's env-driven beat with the fleet's
            # per-replica file; step() keeps stamping it unchanged
            self.srv.heartbeat = Heartbeat(
                path=heartbeat_path, interval_s=heartbeat_interval_s)
        self._inbox: List[SubmitSpec] = []
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._fr = get_flight_recorder()
        reg = get_registry()
        self._m_healthy = reg.gauge(
            tenant_metric_name("dstpu_fleet_replica", replica_id,
                               "healthy"),
            "1 while this fleet replica is routable (HEALTHY)")
        self._m_queue = reg.gauge(
            tenant_metric_name("dstpu_fleet_replica", replica_id,
                               "queue_depth"),
            "requests waiting on this fleet replica")
        # per-replica latency histograms: the GROUND TRUTH the fleet
        # aggregator's bucket-wise merge is checked against.  The engine
        # mirrors every TTFT/ITL observation it makes into these.
        self._m_ttft = reg.histogram(
            tenant_metric_name("dstpu_fleet_replica", replica_id,
                               "ttft_seconds"),
            "time to first token on this fleet replica")
        self._m_itl = reg.histogram(
            tenant_metric_name("dstpu_fleet_replica", replica_id,
                               "itl_seconds"),
            "inter-token latency on this fleet replica")
        mirrors = getattr(self.srv, "mirror_hists", None)
        if mirrors is not None:
            mirrors.setdefault("ttft", []).append(self._m_ttft)
            mirrors.setdefault("itl", []).append(self._m_itl)
        self._publish_gauges()

    # -- introspection -----------------------------------------------------
    @property
    def routable(self) -> bool:
        """New requests may be placed here."""
        return self.state is ReplicaState.HEALTHY

    @property
    def threaded(self) -> bool:
        """True while the daemon serving thread owns the engine — the
        router's pump must then only sweep health, never step."""
        return self._thread is not None and self._thread.is_alive()

    @property
    def alive(self) -> bool:
        return self.state in (ReplicaState.STARTING, ReplicaState.HEALTHY,
                              ReplicaState.DRAINING)

    @property
    def queue_depth(self) -> int:
        with self._lock:
            inbox = len(self._inbox)
        return self.srv.scheduler.queue_depth + inbox

    def prefix_coverage(self, token_ids: Sequence[int],
                        split: bool = False):
        """Leading prompt tokens this replica's pool (device radix index
        or shared host tier) already covers — the affinity key.  Pure
        read, never mutates allocator state.  ``split=True`` returns
        ``(device_tokens, host_tokens)`` so the router can discount
        host-resident coverage by the promote cost."""
        return self.srv.allocator.probe_prefix_coverage(token_ids,
                                                        split=split)

    def has_work(self) -> bool:
        with self._lock:
            inbox = bool(self._inbox)
        return inbox or self.srv.scheduler.has_work

    def in_flight(self) -> List[Request]:
        """Engine requests not yet terminal (WAITING + RUNNING)."""
        sched = self.srv.scheduler
        return list(sched.waiting) + list(sched.running.values())

    # -- lifecycle ---------------------------------------------------------
    def join(self) -> None:
        """STARTING → HEALTHY: the replica becomes routable."""
        if self.state is ReplicaState.STARTING:
            self.state = ReplicaState.HEALTHY
        self._publish_gauges()

    def begin_drain(self) -> None:
        """HEALTHY → DRAINING: stop admission of new fleet routes; the
        engine keeps stepping until everything already accepted reaches
        a terminal status through the normal lifecycle."""
        if self.state is ReplicaState.HEALTHY:
            self.state = ReplicaState.DRAINING
        self._publish_gauges()

    def retire(self) -> None:
        """DRAINING → RETIRED once idle; asserts the drain left the
        pool clean (no sequence-held blocks — the same leak check
        ``run()`` makes)."""
        if self.state is not ReplicaState.DRAINING:
            raise ServingError(
                f"replica {self.replica_id} cannot retire from "
                f"{self.state.value} — drain first")
        if self.has_work():
            raise ServingError(
                f"replica {self.replica_id} still has work — keep "
                f"pumping until the drain completes")
        self.srv.allocator.assert_consistent()
        self.state = ReplicaState.RETIRED
        self._publish_gauges()

    def mark_dead(self, reason: str) -> None:
        """Absorbing death transition: seal the flight-recorder bundle
        (the black box an operator replays) and stop stepping.  The
        router observes the state flip and replays the in-flight work
        on a healthy sibling."""
        if self.state is ReplicaState.DEAD:
            return
        self.state = ReplicaState.DEAD
        self.death_reason = reason
        if self._fr.enabled:
            in_flight = self.in_flight()
            self._fr.note_fleet_event({
                "fleet_event": "replica_dead",
                "replica": self.replica_id, "reason": reason})
            self._fr.dump("replica_dead", reason, extra={
                "replica": self.replica_id,
                "in_flight": [r.req_id for r in in_flight],
                # per-request trace context: the bundle names the SAME
                # trace ids the router's failover replay resubmits, so a
                # post-mortem links straight into the merged fleet trace
                "trace_ids": {r.req_id: r.trace_id for r in in_flight}})
        self._publish_gauges()
        self._stop.set()

    def beat_stale(self) -> bool:
        """Threaded-mode health: True when the per-replica heartbeat
        file is older than the timeout (0 disables the check — the
        cooperative pump sees death synchronously instead)."""
        if not self.heartbeat_timeout_s or self.heartbeat_path is None:
            return False
        return is_stale(self.heartbeat_path, self.heartbeat_timeout_s)

    # -- work --------------------------------------------------------------
    def submit(self, spec: SubmitSpec) -> Optional[Request]:
        """Hand one request to this replica.  Cooperative mode submits
        inline and returns the engine request; threaded mode enqueues
        for the serving thread (returns None — feedback flows through
        ``spec.on_token`` / ``spec.on_submitted``)."""
        if not self.alive:
            raise ServingError(
                f"replica {self.replica_id} is {self.state.value}")
        if self._thread is not None and self._thread.is_alive():
            with self._lock:
                self._inbox.append(spec)
            return None
        return self._do_submit(spec)

    def _do_submit(self, spec: SubmitSpec) -> Request:
        req = self.srv.submit(
            spec.prompt, max_new_tokens=spec.max_new_tokens,
            eos_token_id=spec.eos_token_id, deadline_s=spec.deadline_s,
            temperature=spec.temperature, top_k=spec.top_k,
            top_p=spec.top_p, seed=spec.seed, on_token=spec.on_token,
            tenant=spec.tenant, prefill_only=spec.prefill_only,
            trace_id=spec.trace_id)
        if req.status is not None:
            # shed at submit: the tokenless terminal event already
            # reached on_token inside submit() — nothing to record
            return req
        if spec.key_override is not None:
            # failover replay: restore the ORIGINAL sampling key before
            # the first dispatch can sample with this replica's own
            # resolution — prng_key is read per emitted token, so an
            # overwrite at submit time is exact
            req.prng_key = int(spec.key_override)
        if spec.on_submitted is not None:
            spec.on_submitted(req)
        return req

    def _drain_inbox(self) -> int:
        with self._lock:
            specs, self._inbox = self._inbox, []
        for spec in specs:
            self._do_submit(spec)
        return len(specs)

    def step(self) -> bool:
        """One guarded engine iteration.  Never raises on replica
        failure: a fatal at the ``serving.fleet.replica_step`` site or
        a :class:`ServingError` from the engine marks this replica DEAD
        (flight recorder sealed) and returns False; a transient at the
        site skips the iteration (the same work retries next pump).
        Returns True while the replica has work and is alive."""
        if not self.alive:
            return False
        try:
            get_fault_injector().check("serving.fleet.replica_step")
        except TransientIOError:
            return self.has_work()
        except FatalIOError as e:
            self.mark_dead(f"injected fatal at serving.fleet."
                           f"replica_step: {e}")
            return False
        try:
            self._drain_inbox()
            has_work = self.srv.step()
        except ServingError as e:
            # the engine already sealed its own serving_error bundle;
            # this dump binds the replica identity + survivors list
            self.mark_dead(f"ServingError: {e}")
            return False
        self._publish_gauges()
        return has_work

    # -- threaded mode -----------------------------------------------------
    def start(self) -> None:
        """Spawn the daemon serving thread (threaded mode).  The loop
        pumps :meth:`step` while alive, idling briefly when there is no
        work so a quiet replica stays cheap but keeps beating."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()

        def _loop():
            while not self._stop.is_set() and self.alive:
                if not self.step() and not self.has_work():
                    # idle: keep the heartbeat fresh so idleness never
                    # reads as death, then yield
                    self.srv.heartbeat.maybe_beat()
                    self._stop.wait(0.005)

        self._thread = threading.Thread(
            target=_loop, daemon=True,
            name=f"fleet-replica-{self.replica_id}")
        self._thread.start()

    def stop(self, timeout_s: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout_s)
            self._thread = None

    # -- metrics -----------------------------------------------------------
    def _publish_gauges(self) -> None:
        self._m_healthy.set(1 if self.routable else 0)
        self._m_queue.set(self.srv.scheduler.queue_depth)

    def metrics_snapshot(self) -> dict:
        """This replica's registry-snapshot fragment for the
        ``FleetMetricsAggregator`` — canonical series names (so the
        merged fleet view keeps them) with THIS replica's values: the
        aggregator sums/labels scalars and bucket-merges the latency
        histograms."""
        from ....observability.fleet_metrics import hist_snapshot
        srv = self.srv
        snap = {
            "dstpu_serving_queue_depth": {
                "kind": "gauge",
                "value": float(self.queue_depth)},
            "dstpu_fleet_replica_up": {
                "kind": "gauge", "value": 1.0 if self.routable else 0.0},
            "dstpu_serving_in_flight": {
                "kind": "gauge", "value": float(len(self.in_flight()))},
            "dstpu_serving_ttft_seconds": hist_snapshot(self._m_ttft),
            "dstpu_serving_itl_seconds": hist_snapshot(self._m_itl),
        }
        for key, v in getattr(srv, "lifecycle_counts", {}).items():
            snap[f"dstpu_serving_lifecycle_{key}_total"] = {
                "kind": "counter", "value": float(v)}
        for key, v in getattr(srv, "fabric_counts", {}).items():
            snap[f"dstpu_serving_fabric_{key}_total"] = {
                "kind": "counter", "value": float(v)}
        return snap
