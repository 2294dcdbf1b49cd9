"""Continuous-batching scheduler (iteration-level, Orca-style).

Host-side policy for the serving engine: which request enters a decode
slot, who gets preempted when the KV pool runs dry, when a request is
done.  Orca (Yu et al., OSDI '22) made the case that the scheduling
quantum for LLM serving must be ONE decode iteration — requests join
and leave the running batch between iterations instead of waiting for
the whole batch to finish.  Here that batch is a fixed set of
``num_slots`` decode slots (so the compiled mixed step never retraces);
a slot's liveness is carried by its per-slot length (0 = inactive), not
by the program shape.

Chunked prefill (Sarathi-Serve, Agrawal et al.): admission allocates a
request's blocks and takes its prefix-cache hits, but its prompt is
COMPUTED in ``prefill_chunk_tokens``-sized chunks that ride the same
iterations as the live decode slots — a long prompt no longer
head-of-line-blocks decode for a whole iteration.  A request is
"prefilling" while ``cached_tokens < prefill_target`` and joins decode
the iteration after its last chunk lands.

State machine per request::

    WAITING --admit--> RUNNING --finish(eos | max_new)--> FINISHED
       ^                  |                                (status OK)
       +---- preempt -----+   (KV pressure; re-enters at queue FRONT,
                               recompute-style — but prefix-cache hits
                               mean re-admission recomputes only the
                               uncached tail)

plus the terminal lifecycle edges added by the robustness layer
(docs/serving.md "Failure handling & overload") — each carries a
:class:`RequestStatus` and lands the request in ``finished``:

  * submit with a full queue        -> SHED       (never queued)
  * ``cancel()`` (WAITING/RUNNING)  -> CANCELLED  (blocks freed at the
                                       iteration boundary, commit-cached
                                       first like preemption)
  * deadline sweep                  -> TIMED_OUT  (WAITING and RUNNING)
  * non-finite logits (quarantine), -> FAILED     (quarantine DISCARDS
    thrash pin-or-fail, fatal                      the blocks: suspect
    injected faults                                KV never parks in the
                                                   prefix cache)

Preemption-thrash guard: a request preempted ``max_preemptions`` times
is PINNED — never chosen as a victim again, so it runs to completion
while everyone else yields.  If the pool cannot grow and every running
request is pinned, the growing request FAILS with a clear sizing error
instead of livelocking ``ensure_decode_capacity()`` (two oversized
requests can otherwise evict each other forever).

Policies (deliberately simple and deterministic, pinned by tests):

  * admission: FCFS with head-of-line blocking — the head request
    admits iff a slot is free AND the pool covers its prefix + 1
    token.  No skip-ahead, so admission order == submission order and
    token streams are reproducible.
  * prefill chunking: oldest-admitted prefilling slot first, up to the
    per-iteration token budget.
  * preemption: when a running sequence crosses a block boundary and
    the pool is dry, the LIFO victim (latest admitted — least work
    wasted) is evicted, preferring a victim whose full blocks are all
    cache-RESIDENT (its prefix stays hittable, so eviction costs only
    the tail recompute); its blocks are freed (registered ones park in
    the allocator's cached LRU) and it re-queues at the front.

Pure Python + the allocator — no device code; the engine owns device
state.  Copy of ``deepspeed_tpu/inference/serving/scheduler.py`` for the
PyTorch port with the request tracer's and flight recorder's hooks, the
fault-injection sites (``serving.admission``, and ``serving.allocate`` /
``serving.append_block`` raised by the allocator), the front end's
policy hooks (weighted-fair admission, prefill order, shed victim), the
speculative lane's :meth:`try_grow`, the tiered host cache's PROMOTING
phase (:meth:`promoting`) and the disaggregated fleet's prefill-only
leg (:meth:`finish_prefill`).
"""
from __future__ import annotations

import enum
import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Tuple

from ...observability.flight_recorder import get_flight_recorder
from ...observability.request_trace import get_request_tracer
from ...runtime.resilience.errors import FatalIOError, TransientIOError
from ...runtime.resilience.fault_injection import get_fault_injector
from .block_allocator import BlockPoolError, PagedBlockAllocator

# process-global recorders (observability/) — every call site below
# guards on ``.enabled``, so the disabled default stays one attribute
# check per lifecycle event with no allocation or clock read
_REQ_TRACE = get_request_tracer()
_FLIGHT = get_flight_recorder()


class RequestState(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    FINISHED = "finished"


class RequestStatus(enum.Enum):
    """Terminal outcome of a request — ``None`` while in flight, set
    exactly once when the request reaches FINISHED."""
    OK = "ok"                  # ran to eos / max_new_tokens
    CANCELLED = "cancelled"    # caller cancel(), applied at a boundary
    TIMED_OUT = "timed_out"    # deadline_s exceeded (WAITING or RUNNING)
    FAILED = "failed"          # quarantine / thrash pin-or-fail / fatal fault
    SHED = "shed"              # rejected at submit: queue at max_queue_depth


_req_counter = itertools.count()


@dataclass
class Request:
    """One generation request and its full lifecycle record."""
    prompt: List[int]
    max_new_tokens: int
    eos_token_id: Optional[int] = None
    req_id: str = field(
        default_factory=lambda: f"req-{next(_req_counter)}")
    state: RequestState = RequestState.WAITING
    output: List[int] = field(default_factory=list)
    #: tokens whose KV currently sits in the pool (prefix-cache hits +
    #: computed chunks + decoded tokens, minus the newest sampled token,
    #: which writes on the next decode)
    cached_tokens: int = 0
    #: prefix length frozen at (re-)admission: the slot is prefilling
    #: while cached_tokens < prefill_target
    prefill_target: int = 0
    #: cumulative prefix-cache hit tokens across (re-)admissions — the
    #: prefill work this request never had to pay
    cache_hit_tokens: int = 0
    preemptions: int = 0
    #: TTL in seconds from submit; swept every step() while WAITING or
    #: RUNNING (terminal status TIMED_OUT).  None = no deadline.
    deadline_s: Optional[float] = None
    #: terminal outcome — None while in flight (docs/serving.md)
    status: Optional[RequestStatus] = None
    #: human-readable reason for a non-OK terminal status
    error: Optional[str] = None
    submit_time: float = field(default_factory=time.perf_counter)
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    #: owning tenant (frontend multi-tenancy; "default" = untenanted —
    #: every legacy submit path lands there)
    tenant: str = "default"
    #: per-request sampling params, RESOLVED at submit (engine defaults
    #: already applied): temperature 0 = greedy, top_k 0 = off,
    #: top_p >= 1 = off.  They ride the compiled step as data, so any
    #: mix of configs shares the one program.
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    #: sampling key; output token j is ALWAYS drawn with
    #: ``(prng_key, j)`` (inference/sampling.py) — batch-, order- and
    #: preemption-independent, which is what makes streams reproducible
    prng_key: int = 0
    #: streaming callback — receives a ``TokenEvent`` per emitted token
    #: at iteration boundaries; an exception disables THIS stream (the
    #: request keeps generating), never the batch
    on_token: Optional[Callable] = None
    #: wall time of the most recently streamed token (per-tenant
    #: inter-token latency accounting)
    last_token_time: Optional[float] = None
    #: request-scoped trace id (observability/request_trace.py) —
    #: assigned at submit when request tracing is enabled, doubles as
    #: the TTFT/ITL histogram exemplar; None while tracing is off
    trace_id: Optional[str] = None
    #: SHED back-pressure hint: seconds the caller should wait before
    #: resubmitting, derived from the queue's current drain rate (the
    #: serving 503's Retry-After header).  None on every other terminal
    #: status, and on sheds before the engine has a rate estimate.
    retry_after_s: Optional[float] = None
    #: disaggregated-fleet prefill leg: compute (and publish) the
    #: prompt's KV, emit NO tokens, and finish OK the moment prefill
    #: completes — the decode leg streams on another replica
    prefill_only: bool = False

    @property
    def prefix(self) -> List[int]:
        """What prefill must cover on (re-)admission: the prompt plus
        everything already generated (cache hits then skip whatever is
        still block-resident)."""
        return list(self.prompt) + list(self.output)

    @property
    def prefilling(self) -> bool:
        return self.state is RequestState.RUNNING and \
            self.cached_tokens < self.prefill_target

    @property
    def done(self) -> bool:
        if len(self.output) >= self.max_new_tokens:
            return True
        return (self.eos_token_id is not None and bool(self.output)
                and self.output[-1] == self.eos_token_id)


def estimate_retry_after_s(seconds_per_finish: Optional[float],
                           floor_s: float = 0.05,
                           cap_s: float = 30.0) -> float:
    """Pure retry-after estimator behind the SHED hint: a bounded queue
    opens one position per admission, and admissions follow finishes —
    so at the current drain rate (``seconds_per_finish``, an EMA of
    wall seconds per FINISHED request) a shed caller should come back
    after about one drain interval.  Floored so a hint never says
    "now", capped so a stalled queue's estimate stays a backoff rather
    than a farewell; with no rate yet (nothing has finished), returns
    the floor.  Contention between simultaneously-shed callers is the
    router's problem: it jitters this hint through the retry_call
    backoff schedule (docs/serving.md "Fleet serving & failover")."""
    if seconds_per_finish is None or seconds_per_finish <= 0:
        return floor_s
    return float(min(cap_s, max(floor_s, seconds_per_finish)))


class ContinuousBatchingScheduler:
    def __init__(self, num_slots: int, allocator: PagedBlockAllocator,
                 max_blocks_per_seq: int, max_queue_depth: int = 0,
                 max_preemptions: int = 0):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.num_slots = num_slots
        self.alloc = allocator
        self.max_blocks_per_seq = max_blocks_per_seq
        #: submit() sheds beyond this many waiting requests (0 = unbounded)
        self.max_queue_depth = max_queue_depth
        #: preemption cap per request: at the cap the request is pinned
        #: (never a victim again); 0 = no cap
        self.max_preemptions = max_preemptions
        self.waiting: Deque[Request] = deque()
        self.running: Dict[int, Request] = {}      # slot -> request
        self._admit_order: List[int] = []          # slots, oldest first
        self.finished: List[Request] = []
        self.preemption_count = 0
        #: non-OK terminal transitions since the engine last drained —
        #: ALL terminal paths (shed, cancel, timeout, fail) append here,
        #: so the engine's lifecycle counters see every event exactly once
        self.terminal_events: List[Request] = []
        #: req_ids whose table growth hit a transient fault THIS
        #: iteration: they sit out the decode (their write position has
        #: no block — dispatching would scatter into the null block) and
        #: retry growth next step.  Cleared by ensure_decode_capacity.
        self._growth_held: set = set()
        # -- frontend policy hooks (all None = the legacy deterministic
        # FCFS / oldest-first / shed-the-incoming behavior; the
        # multi-tenant frontend installs weighted-fair implementations,
        # docs/serving.md "Multi-tenant SLOs") ------------------------
        #: fn(waiting: Deque[Request]) -> None — reorder the waiting
        #: queue IN PLACE before an admission pass
        self.admission_policy: Optional[Callable] = None
        #: fn(prefilling: List[(slot, Request)]) -> same, reordered —
        #: which prefilling slot's chunk rides the next iteration
        self.prefill_policy: Optional[Callable] = None
        #: fn(incoming: Request, waiting: List[Request]) ->
        #: Optional[Request] — under a full queue, pick a WAITING victim
        #: to shed in the incoming request's place (None / the incoming
        #: request itself = shed the incoming, the legacy behavior)
        self.shed_policy: Optional[Callable] = None
        #: fn() -> Optional[float] — installed by the engine: the
        #: drain-rate-derived wait a SHED terminal should advertise via
        #: ``Request.retry_after_s`` (docs/serving.md "Fleet serving &
        #: failover"); None = no hint stamped
        self.retry_after_hint: Optional[Callable] = None

    # -- introspection -----------------------------------------------------
    @property
    def queue_depth(self) -> int:
        return len(self.waiting)

    @property
    def active_slots(self) -> int:
        return len(self.running)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def max_tokens_per_seq(self) -> int:
        return self.max_blocks_per_seq * self.alloc.block_size

    def decoding_slots(self) -> List[Tuple[int, Request]]:
        """Slots that take a decode token this iteration (admitted AND
        past their prefill, not held by a transient growth fault), in
        slot order for deterministic batches."""
        return [(s, r) for s, r in sorted(self.running.items())
                if not r.prefilling and r.req_id not in self._growth_held]

    # -- lifecycle ---------------------------------------------------------
    def submit(self, req: Request) -> Request:
        """Queue a request. Validates it can EVER fit (prompt + new
        tokens within one slot's table and the pool) so admission never
        deadlocks on an impossible head-of-line request.  With
        ``max_queue_depth`` set, a full queue SHEDS the request instead
        of queueing it (bounded backpressure): the request comes back
        terminal with ``status == RequestStatus.SHED`` and is never
        admitted — the caller's 503, not an exception."""
        total = len(req.prompt) + req.max_new_tokens
        need = self.alloc.blocks_for_tokens(total)
        if not req.prompt:
            raise ValueError("empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if need > self.max_blocks_per_seq or \
                need > self.alloc.usable_blocks:
            raise ValueError(
                f"request needs {need} KV blocks "
                f"({len(req.prompt)} prompt + {req.max_new_tokens} new "
                f"tokens, block {self.alloc.block_size}) but a sequence "
                f"may hold at most "
                f"{min(self.max_blocks_per_seq, self.alloc.usable_blocks)}"
                f" — raise serving.num_kv_blocks / max_out_tokens")
        if _REQ_TRACE.enabled:
            _REQ_TRACE.on_submit(req)
        if self.max_queue_depth and \
                len(self.waiting) >= self.max_queue_depth:
            victim = None
            if self.shed_policy is not None:
                victim = self.shed_policy(req, list(self.waiting))
            if victim is not None and victim is not req:
                # fairness shed: a queue-hogging tenant's WAITING
                # request yields its place to the incoming one (same
                # bounded total, different victim)
                self.cancel(victim, RequestStatus.SHED,
                            f"shed by fairness policy to admit "
                            f"{req.req_id} (queue at "
                            f"serving.max_queue_depth "
                            f"{self.max_queue_depth})")
                self.waiting.append(req)
                return req
            self._terminalize(
                req, RequestStatus.SHED,
                f"queue full: {len(self.waiting)} waiting >= "
                f"serving.max_queue_depth ({self.max_queue_depth})")
            return req
        self.waiting.append(req)
        return req

    # -- terminal transitions ----------------------------------------------
    def _terminalize(self, req: Request, status: RequestStatus,
                     error: Optional[str] = None) -> Request:
        """The ONE place a request reaches FINISHED: stamps status/
        error/finish_time and records the event for the engine's
        lifecycle counters (non-OK only — OK is counted by the token
        path)."""
        req.state = RequestState.FINISHED
        req.status = req.status or status
        req.error = error
        if (status is RequestStatus.SHED and req.retry_after_s is None
                and self.retry_after_hint is not None):
            # both shed paths (bounded backpressure and the fairness
            # victim) funnel here, so every SHED carries the hint
            req.retry_after_s = self.retry_after_hint()
        req.finish_time = time.perf_counter()
        self.finished.append(req)
        if status is not RequestStatus.OK:
            self.terminal_events.append(req)
        if _REQ_TRACE.enabled:
            _REQ_TRACE.on_terminal(req)
        if _FLIGHT.enabled:
            _FLIGHT.note_terminal({
                "req_id": req.req_id, "trace_id": req.trace_id,
                "tenant": req.tenant,
                "status": req.status.name if req.status else None,
                "error": req.error, "tokens": len(req.output),
                "preemptions": req.preemptions,
                "finish_time": req.finish_time})
        return req

    def terminate_slot(self, slot: int, status: RequestStatus,
                       error: Optional[str] = None,
                       discard: bool = False) -> Request:
        """Terminally remove a RUNNING request at an iteration boundary.
        Like preemption, computed blocks are commit-cached BEFORE the
        free so a healthy request's prefix stays warm for siblings —
        EXCEPT under ``discard`` (quarantine), where the KV content is
        suspect and every block is unregistered instead."""
        req = self.running.pop(slot)
        self._admit_order.remove(slot)
        if not discard:
            self.alloc.commit_cached(req.req_id, req.prefix,
                                     req.cached_tokens)
        self.alloc.free(req.req_id, discard=discard)
        return self._terminalize(req, status, error)

    def cancel(self, req: Request,
               status: RequestStatus = RequestStatus.CANCELLED,
               error: Optional[str] = None) -> bool:
        """Cancel a WAITING or RUNNING request; returns False when the
        request is already terminal (idempotent).  RUNNING requests free
        their KV safely — commit-cached first, exactly like preemption —
        which is why the engine only calls this between dispatches."""
        if req.state is RequestState.FINISHED:
            return False
        if req.state is RequestState.WAITING:
            try:
                self.waiting.remove(req)
            except ValueError:
                return False               # not queued (already handled)
            self._terminalize(req, status, error)
            return True
        for slot, r in self.running.items():
            if r is req:
                self.terminate_slot(slot, status, error)
                return True
        return False

    def live(self) -> List[Request]:
        """Every WAITING then RUNNING request, in queue then admission
        order: the same list on every rank of a serving mesh, whose
        indices name requests in the mesh's decisions
        (``lockstep.py``)."""
        return list(self.waiting) + list(self.running.values())

    def expired(self, now: Optional[float] = None
                ) -> List[Tuple[int, str]]:
        """``(index in live(), reason)`` of every live request whose TTL
        has passed at ``now`` (default: this process's clock)."""
        now = time.perf_counter() if now is None else now
        return [(i, f"deadline {r.deadline_s:.3g}s exceeded "
                    f"({now - r.submit_time:.3g}s since submit, "
                    f"state was {r.state.value})")
                for i, r in enumerate(self.live())
                if r.deadline_s is not None
                and now - r.submit_time > r.deadline_s]

    def sweep_deadlines(self, now: Optional[float] = None,
                        expired: Optional[List[Tuple[Request, str]]] = None
                        ) -> List[Request]:
        """Expire every WAITING and RUNNING request whose TTL has
        passed (terminal status TIMED_OUT), or, on a serving mesh, the
        ``(request, reason)`` pairs of rank 0's :meth:`expired` (the same
        on every rank).  Called once per step(), so expiry lands at an
        iteration boundary — a RUNNING request's blocks are freed
        exactly like a cancellation."""
        if expired is None:
            live = self.live()
            expired = [(live[i], why) for i, why in self.expired(now)]
        for r, why in expired:
            self.cancel(r, RequestStatus.TIMED_OUT, why)
        return [r for r, _ in expired]

    def schedule_admissions(self) -> List[Tuple[int, Request]]:
        """FCFS admission into free slots while the pool covers each
        head request's prefix + 1 decode token.  Allocation takes the
        request's prefix-cache hits, so a resubmitted or shared-prefix
        request starts with ``cached_tokens`` already covering its hit
        blocks and prefills only the tail.  Returns
        ``[(slot, request), ...]``.

        With an ``admission_policy`` installed the waiting queue is
        reordered (stably) before the pass — head-of-line semantics
        within the chosen order are kept, so a policy decides WHO is at
        the head, not whether admission blocks."""
        if self.admission_policy is not None and len(self.waiting) > 1:
            self.admission_policy(self.waiting)
        admitted: List[Tuple[int, Request]] = []
        while self.waiting and len(self.running) < self.num_slots:
            req = self.waiting[0]
            # feasibility counts only blocks allocation would take from
            # free capacity: hits on LIVE shared blocks are free, so
            # concurrent shared-prefix requests admit together instead
            # of serializing behind a full-prefix capacity demand.  The
            # probe's hash walk is skipped while the full demand fits
            # outright, so an unpressured (or uncached-and-blocked)
            # head costs no per-iteration rehash of its prefix.
            try:
                get_fault_injector().check("serving.admission")
            except TransientIOError:
                break              # whole admission pass retries next step
            except FatalIOError as e:
                self.waiting.popleft()
                self._terminalize(req, RequestStatus.FAILED,
                                  f"fatal fault at admission: {e}")
                continue
            need = self.alloc.blocks_for_tokens(len(req.prefix) + 1)
            if not self.alloc.can_allocate(need):
                need = self.alloc.probe_fresh_need(len(req.prefix) + 1,
                                                   req.prefix)
            if not self.alloc.can_allocate(need):
                break                      # head-of-line blocks: FCFS order
            slot = min(set(range(self.num_slots)) - set(self.running))
            try:
                _, cached = self.alloc.allocate(
                    req.req_id, len(req.prefix) + 1, token_ids=req.prefix)
            except TransientIOError:
                break              # req stays at the head; retry next step
            except FatalIOError as e:
                self.waiting.popleft()
                self._terminalize(req, RequestStatus.FAILED,
                                  f"fatal fault allocating KV blocks: {e}")
                continue
            self.waiting.popleft()
            req.state = RequestState.RUNNING
            req.prefill_target = len(req.prefix)
            req.cached_tokens = cached     # hit blocks skip prefill
            req.cache_hit_tokens += cached
            self.running[slot] = req
            self._admit_order.append(slot)
            admitted.append((slot, req))
            if _REQ_TRACE.enabled:
                _REQ_TRACE.on_admit(req, slot, cached)
        return admitted

    def next_prefill_chunk(self, budget: int
                           ) -> Optional[Tuple[int, Request, int, int]]:
        """The next prompt chunk to compute under the per-iteration
        token ``budget``: oldest-admitted prefilling slot (or the
        ``prefill_policy``'s choice), at most ``budget`` tokens of its
        remaining prefix.  Returns
        ``(slot, request, start_row, n_tokens)`` or None.

        A PROMOTING request — host-tier cache hits still streaming into
        its block table — is held out: prefill attention gathers the
        whole prefix, so computing the tail before the promoted blocks
        land would read garbage rows.  It takes its chunk the step its
        last payload lands, skipping straight to the uncached tail."""
        if budget < 1:
            return None
        prefilling = [(s, self.running[s]) for s in self._admit_order
                      if self.running.get(s) is not None
                      and self.running[s].prefilling
                      and not self.promoting(self.running[s])]
        if self.prefill_policy is not None and len(prefilling) > 1:
            prefilling = self.prefill_policy(prefilling)
        for slot, req in prefilling:
            n = min(budget, req.prefill_target - req.cached_tokens)
            return slot, req, req.cached_tokens, n
        return None

    def ensure_decode_capacity(self) -> List[Request]:
        """Before a decode iteration: every DECODING sequence must own a
        block for its next write position (prefilling slots were fully
        covered at admission).  Grows tables; on pool exhaustion
        preempts until the rest fit — LIFO order, but preferring a
        victim whose blocks stay cache-resident (eviction then costs
        only its uncached tail on re-admission).  Returns the preempted
        requests.

        Robustness edges: a transient injected/driver fault growing the
        table HOLDS the sequence out of this iteration's decode (its
        write position has no block) and retries next step — no
        recompute, and a pinned request's preemption cap cannot be
        breached by a fault; a fatal fault fails it.  When no
        preemption victim exists because every running request is
        pinned at the preemption cap, the growing request FAILS with a
        sizing error — the thrash guard's pin-or-fail arm — instead of
        spinning forever."""
        preempted: List[Request] = []
        self._growth_held.clear()
        for slot in list(self._admit_order):           # oldest first
            req = self.running.get(slot)
            if req is None or req.prefilling:
                continue
            while req.state is RequestState.RUNNING:
                need = self.alloc.blocks_for_tokens(req.cached_tokens + 1)
                have = len(self.alloc.block_table(req.req_id))
                if have >= need:
                    break
                try:
                    self.alloc.append_block(req.req_id)
                except TransientIOError:
                    self._growth_held.add(req.req_id)  # sit out, retry
                    break
                except FatalIOError as e:
                    self.terminate_slot(slot, RequestStatus.FAILED,
                                        f"fatal fault growing KV table: {e}")
                except BlockPoolError:
                    victim_slot = self._pick_victim()
                    if victim_slot is None:
                        self.terminate_slot(
                            slot, RequestStatus.FAILED,
                            f"KV pool cannot grow {req.req_id!r} "
                            f"({have} blocks held, {need} needed) and "
                            f"every running request is preemption-pinned "
                            f"(cap {self.max_preemptions}) — the pool is "
                            f"too small for the pinned working set; raise "
                            f"serving.num_kv_blocks or lower "
                            f"serving.max_batch_slots")
                        break
                    victim = self.running[victim_slot]
                    self._preempt(victim_slot, victim)
                    preempted.append(victim)
        return preempted

    def try_grow(self, slot: int, extra_tokens: int) -> bool:
        """Best-effort table growth for the SPECULATIVE lane: ensure
        ``slot`` owns blocks for ``cached_tokens + extra_tokens``
        positions.  Unlike :meth:`ensure_decode_capacity` this NEVER
        preempts — speculation is an optimization, so on any pressure
        (pool dry, per-seq cap, transient fault, growth hold) it
        returns False and the slot simply decodes plain this iteration.
        A fatal fault still fails the request (the one non-optional
        edge)."""
        req = self.running.get(slot)
        if req is None or req.state is not RequestState.RUNNING or \
                req.req_id in self._growth_held:
            return False
        need = self.alloc.blocks_for_tokens(req.cached_tokens
                                            + extra_tokens)
        if need > self.max_blocks_per_seq:
            return False
        while len(self.alloc.block_table(req.req_id)) < need:
            try:
                self.alloc.append_block(req.req_id)
            except TransientIOError:
                return False
            except FatalIOError as e:
                self.terminate_slot(slot, RequestStatus.FAILED,
                                    f"fatal fault growing KV table for "
                                    f"speculation: {e}")
                return False
            except BlockPoolError:
                return False
        return True

    def pinned(self, req: Request) -> bool:
        """Thrash guard: at the preemption cap a request becomes
        non-preemptible and runs to completion while others yield."""
        return self.max_preemptions > 0 and \
            req.preemptions >= self.max_preemptions

    def promoting(self, req: Request) -> bool:
        """PROMOTING phase predicate: the request holds blocks whose
        host-tier payloads have not landed in the pool yet.  Promotion
        happens only on admission hits and hits never cover the full
        prefix (the last token's logits must be computed), so a
        promoting request is always still ``prefilling`` — the decode
        path needs no extra gate, only :meth:`next_prefill_chunk`."""
        return self.alloc.seq_has_pending(req.req_id)

    def _pick_victim(self) -> Optional[int]:
        """LIFO preemption, cache-residency-aware: walk latest-admitted
        first and take the first victim whose full blocks are all
        registered in the prefix cache (freeing them parks the prefix
        in the cached LRU, so the victim's re-admission recomputes only
        its tail).  Falls back to the plain latest-admitted slot.  With
        the prefix cache disabled nothing is ever registered, so the
        walk would reduce to "prefer whoever holds zero full blocks" —
        inverting LIFO against older short-prompt requests; skip it.
        Requests pinned at the preemption cap are never victims; with
        every slot pinned there is no victim (None) and the caller
        fails the grower instead of livelocking."""
        eligible = [s for s in self._admit_order
                    if not self.pinned(self.running[s])]
        if not eligible:
            return None
        if self.alloc.enable_prefix_cache:
            for slot in reversed(eligible):
                req = self.running[slot]
                if self.alloc.is_cache_resident(req.req_id,
                                                req.cached_tokens):
                    return slot
        return eligible[-1]

    def _preempt(self, slot: int, req: Request) -> None:
        # register what was computed before letting the blocks go: the
        # re-admission (and any shared-prefix sibling) hits them
        self.alloc.commit_cached(req.req_id, req.prefix, req.cached_tokens)
        self.alloc.free(req.req_id)
        del self.running[slot]
        self._admit_order.remove(slot)
        req.state = RequestState.WAITING
        req.cached_tokens = 0
        req.prefill_target = 0
        req.preemptions += 1
        self.preemption_count += 1
        if _REQ_TRACE.enabled:
            _REQ_TRACE.on_preempt(req)
        # front of the queue, so the original admission order is preserved
        self.waiting.appendleft(req)

    def finish(self, slot: int) -> Request:
        req = self.running.pop(slot)
        self._admit_order.remove(slot)
        # a finished request's blocks park in the cached LRU — the next
        # request over the same system prompt / few-shot template hits
        # them instead of re-prefilling
        self.alloc.commit_cached(req.req_id, req.prefix, req.cached_tokens)
        self.alloc.free(req.req_id)
        return self._terminalize(req, RequestStatus.OK)

    def finish_prefill(self, slot: int) -> Request:
        """OK-finish a ``prefill_only`` request the moment its prefill
        target lands.  The engine has already published the chain to
        the KV fabric, so the blocks are freed WITH unregistration
        (``discard=True``): the digests must live only fabric-side —
        parking them in this replica's cached LRU too would violate the
        cross-tier disjointness the promote path depends on."""
        req = self.running.pop(slot)
        self._admit_order.remove(slot)
        self.alloc.free(req.req_id, discard=True)
        return self._terminalize(req, RequestStatus.OK)
