"""Fleet router: prefix-affinity placement, token-exact failover, and
live drain/join over a set of :class:`ReplicaHandle`s (copy of
``deepspeed_tpu/inference/serving/fleet/router.py`` for the PyTorch
port; :meth:`FleetRouter.from_engine` takes the port's ``seed`` where
the JAX router takes ``rng``).

Placement is a score over routable replicas — ``affinity_weight`` warm
prefix tokens (the allocator's chain digests, probed read-only against
each replica's device radix index and the shared host tier) traded
against queue depth — so shared-prefix traffic converges onto the
replicas that already hold its KV while cold traffic spreads by load.

Failure model: a replica that dies (ServingError, injected fatal,
stale heartbeat) takes NO tokens with it.  Every in-flight request is
resubmitted to a healthy replica with its ORIGINAL sampling key — the
deterministic sampler replays the stream — and the
per-request :class:`StreamDeduper` forwards only tokens past the
delivered high-water mark: clients observe exactly-once delivery with
no visible restart.  SHED responses are not terminal at the fleet
level either: the router honors the replica's drain-rate
``retry_after_s`` hint through a jittered ``RetryPolicy`` schedule
before re-placing.

Injection sites: ``serving.fleet.route`` fires in
placement (transient → degrade to queue-depth-only for that decision;
fatal → the one request FAILs, the router's 500);
``serving.fleet.replica_step`` fires in :meth:`ReplicaHandle.step`
(transient → skip the iteration; fatal → the replica is DEAD and the
failover path runs).

Disaggregated serving: with prefill-class replicas present, each
request runs a
two-leg plan — a ``prefill_only`` leg on the prefill class computes the
prompt's KV and publishes the chain into the shared host tier (the KV
fabric), then a decode leg claims-and-promotes it on the decode class
and streams tokens with the SAME pinned sampling key, so the handoff
is token-exact by construction.  Every fabric failure (publish fault,
corrupt/evicted entry, prefill replica death) degrades the decode leg
to an ordinary cold prefill: never a wrong token, never a stall.

On a serving mesh the router runs on every rank over the same
submissions, and its replicas' engines step together.  What it decides
from a clock (a pending request's backoff expiry, a replica's stale
heartbeat, whether work remains) is rank 0's: each
:meth:`FleetRouter.pump` starts with one broadcast of those decisions
over the router's own process groups (``lockstep.py``), so every rank
places, fails over and re-places alike.  Pumped replicas hold the same
queue depths and prefix coverage on every rank; replicas on their own
threads do not, so with them each placement (leg and replica) is rank
0's too, and a placement a replica's callback asks for waits in the
pending list for the next pump, which names it by its fleet request id.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

from ....observability import (FleetMetricsAggregator, FleetTraceAssembler,
                               FleetTraceContext, get_flight_recorder,
                               get_registry, get_request_tracer,
                               trace_span)
from ....runtime.resilience.errors import (FatalIOError, ServingError,
                                           TransientIOError)
from ....runtime.resilience.fault_injection import get_fault_injector
from ....runtime.resilience.retry import RetryPolicy
from ..frontend.streaming import StreamDeduper, TokenEvent
from ..lockstep import Lockstep
from ..scheduler import Request, RequestStatus
from .replica import INBOX_WAIT_S, ReplicaHandle, ReplicaState, SubmitSpec


def placement_score(covered_tokens: int, queue_depth: int,
                    affinity_weight: float = 1.0,
                    queue_cost_tokens: float = 32.0,
                    host_covered_tokens: int = 0,
                    promote_discount: float = 0.5) -> float:
    """Pure placement score: warm prefix tokens minus queueing cost.

    A replica whose caches already cover ``covered_tokens`` of the
    prompt saves exactly that much prefill; each request already
    waiting costs roughly ``queue_cost_tokens`` of extra latency-
    equivalent work.  The router places on the argmax, so affinity wins
    only when the warm prefix outweighs the queue imbalance it would
    create.

    ``host_covered_tokens`` are prefix tokens resident in the host
    tier / KV fabric rather than the device radix index: they still
    save the recompute but pay a claim + promote landing, so they are
    credited at ``promote_discount`` of a device-resident token —
    placement prefers a replica that can promote over one that must
    recompute, and a replica with the KV already on-device over both."""
    return (affinity_weight
            * (covered_tokens + promote_discount * host_covered_tokens)
            - queue_cost_tokens * queue_depth)


@dataclasses.dataclass(eq=False)
class FleetRequest:
    """One client request as the FLEET sees it: the resolved submission
    spec (what a replay needs to be bit-identical) plus the delivery
    high-water mark.  ``status`` is the fleet-level terminal — None
    while in flight anywhere, stamped exactly once; the underlying
    engine request of a dead replica stays non-terminal and is simply
    abandoned."""
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
    req_id: str = ""
    submit_time: float = dataclasses.field(
        default_factory=time.perf_counter)
    #: sampling key of the stream — resolved at FIRST placement and
    #: pinned for every replay (token j is always drawn with
    #: ``(prng_key, j)``, whatever replica runs it)
    prng_key: Optional[int] = None
    status: Optional[RequestStatus] = None
    error: Optional[str] = None
    finish_time: Optional[float] = None
    #: replica currently running this request (None while pending)
    replica: Optional[ReplicaHandle] = None
    engine_req: Optional[Request] = None
    deduper: StreamDeduper = dataclasses.field(
        default_factory=StreamDeduper)
    failovers: int = 0
    shed_retries: int = 0
    #: monotonic clock time before which a shed/unplaceable request is
    #: NOT re-placed (the honored retry_after_s backoff)
    retry_at: float = 0.0
    _closed: bool = False
    #: disaggregated two-leg plan state: "auto" (plan at placement),
    #: "prefill" (leg 1 in flight on the prefill class), "decode"
    #: (handoff done, stream on the decode class), "direct" (single-leg
    #: cold path — no prefill class, short prompt, warm decode replica,
    #: or a degraded handoff)
    leg: str = "auto"
    #: leg 1 completed and its chain is published — sticky: a decode-leg
    #: failover must not re-run prefill
    prefill_done: bool = False
    #: replica id that ran the prefill leg (flight-recorder context)
    prefill_replica_id: Optional[str] = None
    #: fleet-wide trace id (observability/fleet_trace.py): minted once
    #: at router submit and carried into EVERY leg's engine submission,
    #: so all legs stamp their timelines under the same id
    trace_id: Optional[str] = None

    @property
    def output(self) -> List[int]:
        """Tokens delivered to the client, exactly once, in order."""
        return self.deduper.delivered

    @property
    def done(self) -> bool:
        return self.status is not None


_ROUTER_SEQ = itertools.count()


class FleetRouter:
    """Front door of the replica fleet."""

    def __init__(self, replicas: Sequence[ReplicaHandle],
                 affinity_weight: float = 1.0,
                 queue_cost_tokens: float = 32.0,
                 max_failovers: int = 3,
                 retry_policy: Optional[RetryPolicy] = None,
                 clock: Callable[[], float] = time.monotonic,
                 promote_discount: float = 0.5):
        self.replicas: List[ReplicaHandle] = []
        self.affinity_weight = affinity_weight
        self.queue_cost_tokens = queue_cost_tokens
        self.promote_discount = promote_discount
        self.max_failovers = max_failovers
        self.retry_policy = retry_policy or RetryPolicy()
        self.clock = clock
        self.requests: List[FleetRequest] = []
        #: requests waiting for a (re-)placement — shed backoff, or no
        #: routable replica at the moment
        self._pending: List[FleetRequest] = []
        self._failover_done: set = set()
        self._lock = threading.RLock()
        #: signalled when a request joins ``_pending``
        self._pending_cv = threading.Condition(self._lock)
        self._req_counter = 0
        self._fr = get_flight_recorder()
        self._trace_ctx = FleetTraceContext(
            origin=f"{next(_ROUTER_SEQ):x}")
        #: fleet-level metrics view (observability/fleet_metrics.py):
        #: refreshed on demand (autoscaler tick, exports) — never on the
        #: pump hot path
        self.aggregator = FleetMetricsAggregator()
        #: shared host tier (None when host_cache is off) — a joining
        #: replica built against this instance starts warm
        self.shared_host_cache = None
        reg = get_registry()
        self._m_failovers = reg.counter(
            "dstpu_fleet_failovers_total",
            "in-flight requests replayed off a dead replica")
        self._m_replayed = reg.counter(
            "dstpu_fleet_replayed_tokens_total",
            "replayed tokens dropped at the dedup high-water mark")
        self._m_dead = reg.counter(
            "dstpu_fleet_dead_replicas_total",
            "replicas declared dead (ServingError / fatal / stale beat)")
        self._m_drains = reg.counter(
            "dstpu_fleet_drains_total", "replicas drained and retired")
        self._m_joins = reg.counter(
            "dstpu_fleet_joins_total", "replicas joined live")
        self._m_shed = reg.counter(
            "dstpu_fleet_shed_retries_total",
            "shed responses absorbed by the router's backoff")
        self._m_routable = reg.gauge(
            "dstpu_fleet_routable_replicas",
            "replicas currently accepting new routes")
        self._m_handoffs = reg.counter(
            "dstpu_fleet_handoffs_total",
            "prefill->decode handoffs completed through the KV fabric")
        self._m_prefill_degraded = reg.counter(
            "dstpu_fleet_prefill_degraded_total",
            "prefill legs degraded to decode-side cold recompute")
        self._m_orphans_reaped = reg.counter(
            "dstpu_fleet_fabric_orphans_reaped_total",
            "published-never-claimed fabric entries swept after a "
            "publisher died or drained")
        #: plain-int mirrors for the bench / callers without the registry
        self.fleet_counts = {"failovers": 0, "replayed_tokens": 0,
                             "dead_replicas": 0, "shed_retries": 0,
                             "drains": 0, "joins": 0, "handoffs": 0,
                             "prefill_degraded": 0, "orphans_reaped": 0}
        for r in replicas:
            if r.state is ReplicaState.STARTING:
                r.join()
            self.replicas.append(r)
            if self.shared_host_cache is None:
                self.shared_host_cache = r.srv.host_cache
        #: rank 0's clock decisions for every rank when the replicas'
        #: engines serve a mesh (inactive otherwise)
        mesh = None
        if self.replicas:
            lock = getattr(self.replicas[0].srv, "lockstep", None)
            if lock is not None and lock.active:
                mesh = self.replicas[0].srv.engine.mesh
        self.lockstep = Lockstep(mesh)
        self._publish_gauges()

    # -- construction ------------------------------------------------------
    @classmethod
    def from_engine(cls, engine, seed=None, draft_model=None,
                    draft_params=None, replicas: Optional[int] = None,
                    heartbeat_dir: Optional[str] = None,
                    prefill_replicas: Optional[int] = None
                    ) -> "FleetRouter":
        """Build ``serving.fleet.replicas`` independent ``ServingEngine``
        replicas over one inference engine (shared weights, per-replica
        pools and scheduler) and route over them.  All replicas share
        one host tier when ``serving.host_cache`` is on, and share the
        same base key (``seed``), so a seedless submit replays exactly
        wherever it lands.  With
        ``heartbeat_dir`` and ``serving.fleet.heartbeat_timeout_s`` set,
        threaded replicas also get the ``ReplicaLivenessMonitor``
        staleness check (``elasticity/serving_fleet.py``).

        ``prefill_replicas`` (default ``serving.fleet.prefill_replicas``,
        0 = uniform fleet) splits the fleet into classes: the first K
        replicas become prefill workers (``p0..``, publish-only against
        the shared host tier, which the split REQUIRES) and the rest
        decode replicas (``d0..``); requests then run the two-leg
        handoff plan."""
        from ....elasticity import ReplicaLivenessMonitor
        from ..engine import ServingEngine
        cfg = engine.config.serving.fleet
        n = replicas if replicas is not None else cfg.replicas
        k = (prefill_replicas if prefill_replicas is not None
             else cfg.prefill_replicas)
        if k < 0 or (k and k >= n):
            raise ValueError(
                f"prefill_replicas must be 0 (uniform) or leave at "
                f"least one decode replica: got {k} of {n}")
        if k and not engine.config.serving.host_cache.enabled:
            raise ValueError(
                "a disaggregated fleet (prefill_replicas > 0) requires "
                "serving.host_cache.enabled — the shared host tier IS "
                "the KV fabric between the classes")
        monitor = None
        if heartbeat_dir is not None and cfg.heartbeat_timeout_s:
            monitor = ReplicaLivenessMonitor(
                heartbeat_dir, cfg.heartbeat_timeout_s)
        handles, shared = [], None
        for i in range(n):
            if k:
                role = "prefill" if i < k else "decode"
                rid = f"p{i}" if i < k else f"d{i - k}"
            else:
                role, rid = "mixed", f"r{i}"
            srv = ServingEngine(engine, seed=seed,
                                draft_model=draft_model,
                                draft_params=draft_params,
                                shared_host_cache=shared,
                                role=role)
            srv.publisher_id = rid
            if shared is None:
                shared = srv.host_cache
            handles.append(ReplicaHandle(
                rid, srv,
                heartbeat_path=(monitor.path_for(rid)
                                if monitor else None),
                heartbeat_interval_s=cfg.heartbeat_interval_s,
                heartbeat_timeout_s=(cfg.heartbeat_timeout_s
                                     if monitor else 0.0),
                role=role))
        return cls(handles,
                   affinity_weight=cfg.affinity_weight,
                   max_failovers=cfg.max_failovers,
                   retry_policy=RetryPolicy(
                       base_delay_s=cfg.retry_base_delay_s,
                       max_delay_s=cfg.retry_max_delay_s),
                   promote_discount=cfg.promote_discount)

    # -- introspection -----------------------------------------------------
    @property
    def routable_replicas(self) -> List[ReplicaHandle]:
        return [r for r in self.replicas if r.routable]

    @property
    def has_work(self) -> bool:
        return any(f.status is None for f in self.requests)

    @property
    def _threaded_mesh(self) -> bool:
        """Replicas on their own threads over a serving mesh: what they
        hold moves under their threads, so placements are rank 0's."""
        return self.lockstep.active and any(r.threaded
                                            for r in self.replicas)

    def await_idle(self, r: ReplicaHandle) -> None:
        """On a serving mesh rank 0 found ``r`` idle: this rank's serving
        thread may still be finishing that iteration's bookkeeping."""
        deadline = time.monotonic() + INBOX_WAIT_S
        while (self.lockstep.active and r.has_work()
               and time.monotonic() < deadline):
            time.sleep(0.001)

    def replica(self, replica_id: str) -> ReplicaHandle:
        for r in self.replicas:
            if r.replica_id == replica_id:
                return r
        raise KeyError(replica_id)

    # -- submission --------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32,
               eos_token_id: Optional[int] = None,
               deadline_s: Optional[float] = None,
               temperature: Optional[float] = None,
               top_k: Optional[int] = None,
               top_p: Optional[float] = None,
               seed: Optional[int] = None,
               on_token: Optional[Callable] = None,
               tenant: str = "default") -> FleetRequest:
        """Place one request on the fleet.  Same contract as
        ``ServingEngine.submit`` with one upgrade: a SHED from the
        chosen replica is absorbed (backoff + re-place), not terminal —
        the fleet's 503 only happens when the retry budget exhausts
        with every replica still saturated."""
        with self._lock:
            freq = FleetRequest(
                prompt=list(int(t) for t in prompt),
                max_new_tokens=max_new_tokens,
                eos_token_id=eos_token_id, deadline_s=deadline_s,
                temperature=temperature, top_k=top_k, top_p=top_p,
                seed=seed, tenant=tenant, on_token=on_token,
                req_id=f"fleet-{self._req_counter}")
            self._req_counter += 1
            if get_request_tracer().enabled:
                # distributed trace context: one fleet-scoped id for
                # every leg this request will run, minted before the
                # first placement so even a shed-at-submit is traced
                freq.trace_id = self._trace_ctx.mint()
            self.requests.append(freq)
            self._try_place(freq)
            return freq

    def _try_place(self, freq: FleetRequest) -> None:
        """Pick a replica and hand the request over; an unplaceable or
        shed request lands in the pending queue with its backoff."""
        freq.leg = self._plan_leg(freq)
        target = self._pick(freq)
        if freq.status is not None:
            return                       # fatal route fault terminal
        if self._threaded_mesh:
            leg, rid = self.lockstep.decide(lambda: (
                freq.leg, None if target is None else target.replica_id))
            freq.leg = leg
            target = None if rid is None else self.replica(rid)
        if target is None:
            if not any(r.alive for r in self.replicas):
                self._terminalize(
                    freq, RequestStatus.FAILED,
                    "no live replicas — the whole fleet is dead or "
                    "retired")
                return
            self._schedule_retry(freq, None)
            return
        self._submit_to(target, freq)

    @staticmethod
    def _role(r: ReplicaHandle) -> str:
        return getattr(r, "role", "mixed")

    def _coverage(self, r: ReplicaHandle,
                  prompt: List[int]) -> Tuple[int, int]:
        """(device, host) coverage; older handles without split support
        report everything as device-resident."""
        try:
            return r.prefix_coverage(prompt, split=True)
        except TypeError:
            return r.prefix_coverage(prompt), 0

    def _plan_leg(self, freq: FleetRequest) -> str:
        """Decide which leg places next.  "decode" and "direct" are
        sticky (the handoff happened / was degraded); otherwise a
        prefill leg runs only when a prefill-class replica is routable,
        the prompt has publishable full blocks, and no decode-side
        replica already covers all of them (a covered prompt promotes
        or hits — re-prefilling it would just republish what the fabric
        already holds)."""
        if freq.prefill_done or freq.leg == "decode":
            return "decode"
        if freq.leg == "direct":
            return "direct"
        pre = [r for r in self.routable_replicas
               if self._role(r) == "prefill"]
        if not pre:
            return "direct"
        try:
            bs = pre[0].srv.block_size
        except AttributeError:
            return "direct"
        full_tokens = max(0, (len(freq.prompt) - 1) // bs) * bs
        if full_tokens <= 0:
            return "direct"              # nothing publishable
        for r in self.routable_replicas:
            if self._role(r) == "prefill":
                continue
            dev, host = self._coverage(r, freq.prompt)
            if dev + host >= full_tokens:
                return "direct"          # warm decode path
        return "prefill"

    def _pick(self, freq: FleetRequest) -> Optional[ReplicaHandle]:
        """Score routable replicas: prefix affinity (chain-digest
        coverage, read-only probe; host/fabric residency discounted by
        the promote cost) traded against queue depth.  The candidate
        set is class-aware: a prefill leg only lands on the prefill
        class; a decode/direct leg prefers the decode class but may
        fall back to ANY routable replica when the class is empty — a
        degraded fleet keeps serving.  The ``serving.fleet.route`` site
        fires per placement decision — transient degrades THIS decision
        to queue-depth-only, fatal FAILs the request."""
        try:
            get_fault_injector().check("serving.fleet.route")
            use_affinity = True
        except TransientIOError:
            use_affinity = False
        except FatalIOError as e:
            self._terminalize(freq, RequestStatus.FAILED,
                              f"fatal fault at serving.fleet.route: {e}")
            return None
        cands = self.routable_replicas
        if freq.leg == "prefill":
            cands = [r for r in cands if self._role(r) == "prefill"]
            if not cands:
                # the class vanished between plan and pick: degrade to
                # the single-leg cold path instead of stalling
                freq.leg = "direct"
                cands = self.routable_replicas
        if freq.leg in ("decode", "direct"):
            stream = [r for r in cands if self._role(r) != "prefill"]
            if stream:
                cands = stream
        if not cands:
            return None
        best, best_score = None, None
        for r in cands:
            dev = host = 0
            if use_affinity and self.affinity_weight:
                dev, host = self._coverage(r, freq.prompt)
            score = placement_score(dev, r.queue_depth,
                                    self.affinity_weight,
                                    self.queue_cost_tokens,
                                    host_covered_tokens=host,
                                    promote_discount=self.promote_discount)
            if best_score is None or score > best_score:
                best, best_score = r, score
        with trace_span("fleet/route", request=freq.req_id,
                        replica=best.replica_id, leg=freq.leg,
                        affinity=int(use_affinity),
                        queue_depth=best.queue_depth):
            return best

    def _submit_to(self, target: ReplicaHandle,
                   freq: FleetRequest) -> None:
        freq.replica = target
        if freq.leg == "prefill":
            # leg 1: compute + publish only.  The client stream stays
            # untouched (no tokens flow); the internal callback turns
            # the tokenless OK terminal into the decode-leg placement.
            spec = SubmitSpec(
                prompt=freq.prompt, max_new_tokens=1,
                eos_token_id=freq.eos_token_id,
                deadline_s=freq.deadline_s,
                temperature=freq.temperature, top_k=freq.top_k,
                top_p=freq.top_p, seed=freq.seed, tenant=freq.tenant,
                on_token=self._make_prefill_cb(freq),
                key_override=freq.prng_key,
                on_submitted=lambda req, f=freq: self._record_submit(
                    f, req),
                prefill_only=True,
                trace_id=freq.trace_id)
        else:
            spec = SubmitSpec(
                prompt=freq.prompt, max_new_tokens=freq.max_new_tokens,
                eos_token_id=freq.eos_token_id,
                deadline_s=freq.deadline_s,
                temperature=freq.temperature, top_k=freq.top_k,
                top_p=freq.top_p, seed=freq.seed, tenant=freq.tenant,
                on_token=self._make_stream_cb(freq),
                key_override=freq.prng_key,
                on_submitted=lambda req, f=freq: self._record_submit(
                    f, req),
                trace_id=freq.trace_id)
        target.submit(spec)

    def _record_submit(self, freq: FleetRequest, req: Request) -> None:
        freq.engine_req = req
        if freq.prng_key is None:
            # pin the key resolved by the FIRST placement: every replay
            # overrides with exactly this key, so the stream is
            # identical whatever base key later replicas carry
            freq.prng_key = int(req.prng_key)

    # -- stream plumbing ---------------------------------------------------
    def _make_stream_cb(self, freq: FleetRequest) -> Callable:
        def _cb(ev: TokenEvent) -> None:
            self._on_stream_event(freq, ev)
        return _cb

    def _make_prefill_cb(self, freq: FleetRequest) -> Callable:
        def _cb(ev: TokenEvent) -> None:
            self._on_prefill_event(freq, ev)
        return _cb

    def _on_prefill_event(self, freq: FleetRequest,
                          ev: TokenEvent) -> None:
        """Leg-1 feedback.  A prefill leg emits no tokens — only a
        tokenless terminal: OK hands off to the decode class (same
        pinned key, so the stream is exactly what a single replica
        would have produced); SHED re-enters the normal backoff; any
        other terminal (deadline, quarantine, fatal fault) degrades to
        a decode-side cold recompute — the fabric can only ever cost a
        recompute, never a wrong token or a stall."""
        with self._lock:
            if freq.status is not None or freq.prefill_done:
                return
            if not ev.final:
                return
            if ev.status is RequestStatus.OK:
                freq.prefill_done = True
                freq.leg = "decode"
                freq.prefill_replica_id = getattr(
                    freq.replica, "replica_id", None)
                freq.replica = None
                freq.engine_req = None
                self._m_handoffs.inc()
                self.fleet_counts["handoffs"] += 1
                if self._fr.enabled:
                    self._fr.note_fleet_event({
                        "fleet_event": "handoff", "req_id": freq.req_id,
                        "trace_id": freq.trace_id,
                        "prefill_replica": freq.prefill_replica_id})
                self._place_or_defer(freq)
            elif ev.status is RequestStatus.SHED:
                self._absorb_shed(freq, ev.request)
            else:
                freq.leg = "direct"
                freq.replica = None
                freq.engine_req = None
                self._m_prefill_degraded.inc()
                self.fleet_counts["prefill_degraded"] += 1
                self._place_or_defer(freq)

    def _place_or_defer(self, freq: FleetRequest) -> None:
        """A placement a replica's callback asks for: now, or with
        replicas on their own threads over a serving mesh, at the next
        pump (whose placements are rank 0's)."""
        if not self._threaded_mesh:
            self._try_place(freq)
            return
        freq.retry_at = float("-inf")
        freq.replica = None
        freq.engine_req = None
        self._enqueue(freq)

    def _enqueue(self, freq: FleetRequest) -> None:
        with self._pending_cv:
            if freq not in self._pending:
                self._pending.append(freq)
            self._pending_cv.notify_all()

    def _on_stream_event(self, freq: FleetRequest,
                         ev: TokenEvent) -> None:
        with self._lock:
            if freq.status is not None:
                return                   # late event after fleet terminal
            if ev.token is None:
                # tokenless terminal from the engine
                if ev.status is RequestStatus.SHED:
                    self._absorb_shed(freq, ev.request)
                else:
                    self._terminalize(freq, ev.status,
                                      getattr(ev.request, "error", None))
                return
            out = freq.deduper.admit(ev)
            if out is None:
                # replayed duplicate below the high-water mark
                self._m_replayed.inc()
                self.fleet_counts["replayed_tokens"] += 1
                return
            self._forward(freq, ev._replace(request=freq))
            if ev.final:
                self._terminalize(freq, RequestStatus.OK)

    def _forward(self, freq: FleetRequest, ev: TokenEvent) -> None:
        if ev.final:
            freq._closed = True
        if freq.on_token is None:
            return
        try:
            freq.on_token(ev)
        except Exception:  # noqa: BLE001 — client callback must never
            # poison the dedup/failover plumbing; engine-side streams
            # get the same isolation
            from ....utils.logging import logger
            logger.exception(
                f"fleet: on_token callback failed for {freq.req_id}; "
                f"stream delivery continues")

    def _absorb_shed(self, freq: FleetRequest, engine_req) -> None:
        """A replica shed this request (bounded backpressure).  Not
        terminal at the fleet level: honor the drain-rate
        ``retry_after_s`` hint through the jittered policy schedule and
        re-place — until the retry budget says the whole fleet is
        saturated."""
        freq.replica = None
        freq.engine_req = None
        self._m_shed.inc()
        self.fleet_counts["shed_retries"] += 1
        if freq.shed_retries >= self.retry_policy.max_attempts:
            get_registry().counter(
                "dstpu_io_retry_giveups_total").inc()
            self._terminalize(
                freq, RequestStatus.SHED,
                f"shed {freq.shed_retries + 1} times with every "
                f"routable replica saturated (retry budget "
                f"{self.retry_policy.max_attempts})")
            return
        self._schedule_retry(
            freq, getattr(engine_req, "retry_after_s", None))
        freq.shed_retries += 1

    def _schedule_retry(self, freq: FleetRequest,
                        retry_after_s: Optional[float]) -> None:
        delay = self.retry_policy.delay(freq.shed_retries)
        if retry_after_s:
            # the hint is a floor: never hammer an overloaded replica
            # sooner than its own drain estimate, jitter included
            delay = max(delay, retry_after_s)
        freq.retry_at = self.clock() + delay
        freq.replica = None
        freq.engine_req = None
        self._enqueue(freq)

    # -- the pump ----------------------------------------------------------
    def pump(self) -> bool:
        """One cooperative fleet round: step every live replica, sweep
        health, run failover for newly dead replicas, and re-place
        pending requests whose backoff expired.  Returns True while any
        fleet request is in flight.  On a serving mesh the stale beats,
        the expired backoffs and whether a request is in flight are rank
        0's, taken as the round starts."""
        decision = self.lockstep.decide(self._propose)
        stale, due = None, None
        if decision is not None:
            stale = set(decision["stale"])
            due = self._pending_named(decision["due"])
        for r in list(self.replicas):
            if (r.state in (ReplicaState.HEALTHY, ReplicaState.DRAINING)
                    and not r.threaded):
                # threaded replicas step themselves; the pump only
                # sweeps their health
                r.step()
            if r.alive and (r.beat_stale() if stale is None
                            else r.replica_id in stale):
                r.mark_dead(
                    f"heartbeat stale past "
                    f"{r.heartbeat_timeout_s:.1f}s")
            if (r.state is ReplicaState.DEAD
                    and r.replica_id not in self._failover_done):
                self._failover(r)
        self._service_pending(due)
        self._publish_gauges()
        return self.has_work if decision is None else decision["more"]

    def _propose(self) -> dict:
        """Rank 0's clock decisions of a round: the live replicas whose
        heartbeat is stale, the pending requests (by fleet request id)
        whose backoff has expired, and whether any request is in
        flight."""
        with self._lock:
            now = self.clock()
            return {"stale": [r.replica_id for r in self.replicas
                              if r.alive and r.beat_stale()],
                    "due": [f.req_id for f in self._pending
                            if f.status is None and f.retry_at <= now],
                    "more": self.has_work}

    def _pending_named(self, req_ids: List[str]) -> List[FleetRequest]:
        """The pending requests rank 0 named, waiting for a replica
        thread's callback on this rank to queue one it has not yet."""
        deadline = time.monotonic() + INBOX_WAIT_S
        with self._pending_cv:
            while True:
                mine = {f.req_id: f for f in self._pending}
                if all(i in mine for i in req_ids):
                    return [mine[i] for i in req_ids]
                left = deadline - time.monotonic()
                if left <= 0:
                    raise ServingError(
                        f"fleet: rank 0 re-placed {req_ids}, this rank "
                        f"has pending {sorted(mine)} after "
                        f"{INBOX_WAIT_S:.0f} s")
                self._pending_cv.wait(left)

    def _service_pending(self, due: Optional[List[FleetRequest]] = None
                         ) -> None:
        """Re-place the pending requests whose backoff expired (``due``:
        the mesh's agreed ones; None reads this process's clock)."""
        with self._lock:
            if due is None:
                now = self.clock()
                due = [f for f in self._pending
                       if f.status is None and f.retry_at <= now]
            due = [f for f in due if f.status is None]
            self._pending = [f for f in self._pending
                             if f.status is None and f not in due]
            for f in due:
                self._try_place(f)

    def _failover(self, dead: ReplicaHandle) -> None:
        """Replay every in-flight request of a dead replica on a
        healthy sibling with its original key — the robustness core.
        The fleet-level dedup makes the replayed stream invisible below
        the delivered high-water mark."""
        self._failover_done.add(dead.replica_id)
        self._m_dead.inc()
        with self._lock:
            self.fleet_counts["dead_replicas"] += 1
            # a dead prefill worker's unclaimed fabric entries are
            # orphans: mid-publish chains are prefix-contiguous (never
            # half-written), so sweeping them costs at most a recompute
            # on the decode legs that still wanted them
            self._reap_publisher(dead)
            victims = [f for f in self.requests
                       if f.status is None and f.replica is dead]
            if self._fr.enabled:
                ev = {
                    "t": time.perf_counter(), "fleet_event": "failover",
                    "replica": dead.replica_id,
                    "reason": dead.death_reason,
                    "victims": [f.req_id for f in victims],
                    "trace_ids": {f.req_id: f.trace_id for f in victims},
                    "delivered": {f.req_id: f.deduper.high_water
                                  for f in victims}}
                self._fr.record(ev)
                self._fr.note_fleet_event(ev)
            rt = get_request_tracer()
            for f in victims:
                with trace_span(
                        "fleet/failover", request=f.req_id,
                        from_replica=dead.replica_id,
                        delivered=f.deduper.high_water,
                        attempt=f.failovers + 1):
                    f.replica = None
                    f.engine_req = None
                    if f.failovers >= self.max_failovers:
                        get_registry().counter(
                            "dstpu_io_retry_giveups_total").inc()
                        self._terminalize(
                            f, RequestStatus.FAILED,
                            f"replica {dead.replica_id} died "
                            f"({dead.death_reason}) and the failover "
                            f"budget ({self.max_failovers}) is spent")
                        continue
                    f.failovers += 1
                    self._m_failovers.inc()
                    self.fleet_counts["failovers"] += 1
                    get_registry().counter(
                        "dstpu_io_retries_total").inc()
                    self._try_place(f)
                    if rt.enabled and f.engine_req is not None:
                        # anchor the failover-replay leg in the fleet
                        # trace: the instant lands on the NEW timeline
                        # (same trace_id, fresh leg)
                        rt.mark(f.engine_req, "failover_resubmit",
                                from_replica=dead.replica_id,
                                delivered=f.deduper.high_water,
                                attempt=f.failovers)

    def run(self, max_pumps: Optional[int] = None
            ) -> List[FleetRequest]:
        """Pump until every fleet request is terminal; returns them
        all (check ``status``).  ``None`` computes a generous bound
        from the queued work across replicas times the failover
        allowance — hitting it is a loud :class:`ServingError`, never a
        silent spin."""
        if max_pumps is None:
            per_replica = sum(
                r.srv._default_max_steps() for r in self.replicas
                if r.alive)
            max_pumps = ((per_replica + 64 * (len(self.requests) + 1))
                         * (self.max_failovers + 1)
                         * self.retry_policy.max_attempts + 256)
        pumps = 0
        while self.pump():
            pumps += 1
            if pumps >= max_pumps:
                raise ServingError(
                    f"fleet did not drain within {max_pumps} pumps "
                    f"({sum(f.status is None for f in self.requests)} "
                    f"requests still in flight)")
            if self._pending and not any(
                    r.has_work() for r in self.replicas if r.alive):
                # nothing to step — only backoff timers left; sleep to
                # the earliest one instead of spinning the pump
                now = self.clock()
                wait = min((f.retry_at for f in self._pending
                            if f.status is None), default=now) - now
                if wait > 0:
                    time.sleep(min(wait, 0.05))
        return list(self.requests)

    # -- drain / join ------------------------------------------------------
    def drain(self, replica, pump: bool = True) -> ReplicaHandle:
        """Gracefully retire a replica: stop routing NEW requests to
        it, let everything already admitted or queued finish through
        the normal lifecycle (not a single running request is
        terminalized by the drain itself), then retire.  With ``pump``
        the call drives the fleet until the drain completes; pass False
        to keep pumping yourself."""
        r = replica if isinstance(replica, ReplicaHandle) \
            else self.replica(replica)
        with trace_span("fleet/drain", replica=r.replica_id,
                        in_flight=len(r.in_flight())):
            r.begin_drain()
        if self._fr.enabled:
            self._fr.note_fleet_event({
                "fleet_event": "drain", "replica": r.replica_id})
        self._publish_gauges()
        if pump:
            def busy() -> bool:
                return r.alive and r.has_work()
            # on a serving mesh rank 0's: replica threads move has_work
            while (self.lockstep.decide(busy) if self.lockstep.active
                   else busy()):
                self.pump()
            self.await_idle(r)
            if r.state is ReplicaState.DRAINING:
                r.retire()
                self._m_drains.inc()
                with self._lock:
                    self.fleet_counts["drains"] += 1
                # a retired publisher leaves no fabric debris behind:
                # whatever it published and nobody claimed is reaped now
                self._reap_publisher(r)
        self._publish_gauges()
        return r

    def _reap_publisher(self, r: ReplicaHandle) -> int:
        """Sweep the fabric entries ``r`` published that nobody ever
        claimed (no-op for non-prefill replicas and fabric-less
        fleets)."""
        if (self._role(r) != "prefill"
                or self.shared_host_cache is None):
            return 0
        pid = getattr(r.srv, "publisher_id", r.replica_id)
        n = self.shared_host_cache.reap_orphans(pid)
        if n:
            self._m_orphans_reaped.inc(n)
            with self._lock:   # RLock: safe from the _failover holder
                self.fleet_counts["orphans_reaped"] += n
        return n

    def reap_orphans(self) -> int:
        """Sweep EVERY published-never-claimed fabric entry — the
        end-of-run (or operator-driven) guarantee that a drained fleet
        leaves zero orphaned fabric entries behind."""
        if self.shared_host_cache is None:
            return 0
        n = self.shared_host_cache.reap_orphans()
        if n:
            self._m_orphans_reaped.inc(n)
            with self._lock:
                self.fleet_counts["orphans_reaped"] += n
        return n

    def join(self, handle: ReplicaHandle) -> ReplicaHandle:
        """Live join: a cold replica becomes routable.  Build its
        engine with ``shared_host_cache=router.shared_host_cache`` and
        it inherits every warm prefix the fleet has spilled — the host
        store is content-addressed and device-agnostic, so the digests
        are the transport key."""
        with trace_span("fleet/join", replica=handle.replica_id):
            handle.join()
            with self._lock:
                self.replicas.append(handle)
                self.fleet_counts["joins"] += 1
            if self.shared_host_cache is None:
                self.shared_host_cache = handle.srv.host_cache
            self._m_joins.inc()
        if self._fr.enabled:
            self._fr.note_fleet_event({
                "fleet_event": "join", "replica": handle.replica_id})
        self._publish_gauges()
        return handle

    # -- terminal stamping -------------------------------------------------
    def _terminalize(self, freq: FleetRequest, status: RequestStatus,
                     error: Optional[str] = None) -> FleetRequest:
        """The ONE place a fleet request reaches a terminal status —
        the fleet-level mirror of the scheduler's discipline.  Closes
        the client stream with a tokenless terminal event when no final
        event was forwarded."""
        if freq.status is not None:
            return freq
        freq.status = status
        freq.error = error
        freq.finish_time = time.perf_counter()
        if not freq._closed:
            self._forward(freq, TokenEvent(
                request=freq, token=None,
                index=freq.deduper.high_water, status=status,
                final=True, tenant=freq.tenant,
                time_s=time.perf_counter(), prev_time_s=None))
        return freq

    # -- metrics -----------------------------------------------------------
    def _publish_gauges(self) -> None:
        self._m_routable.set(len(self.routable_replicas))

    def export_fleet_metrics(self, prometheus_path: Optional[str] = None,
                             json_path: Optional[str] = None
                             ) -> List[str]:
        """Refresh the aggregator from every replica handle and write
        the fleet-level exports (labeled Prometheus textfile and/or JSON
        snapshot with bucket-merged histograms)."""
        self.aggregator.observe_router(self)
        paths: List[str] = []
        if prometheus_path:
            paths.append(self.aggregator.export_prometheus(
                prometheus_path))
        if json_path:
            paths.append(self.aggregator.export_json(json_path))
        return paths

    # -- fleet trace -------------------------------------------------------
    def export_fleet_trace(self, path: Optional[str] = None,
                           extra_sources: Sequence[str] = ()) -> str:
        """Flush the process tracer and write the MERGED fleet trace:
        every leg of every fleet request under its single trace id, with
        flow arrows chaining prefill → fabric publish → claim/promote →
        decode → failover replay (observability/fleet_trace.py).
        ``extra_sources`` merges additional per-process trace files
        (multi-process fleets) onto disjoint pid ranges."""
        from ....observability import get_tracer
        tracer = get_tracer()
        src = tracer.flush()
        asm = FleetTraceAssembler()
        asm.add_file(src, label=f"rank{tracer.rank}")
        for extra in extra_sources:
            asm.add_file(extra)
        if path is None:
            path = os.path.join(tracer.output_dir, "fleet_trace.json")
        return asm.write(path)
