"""Request-scoped tracing: a per-request timeline from submit to terminal.

The span tracer (``tracer.py``) answers "where did this *iteration* go";
this module answers "why was THIS request slow". Every serving request is
assigned a trace id at ``submit()`` and the lifecycle sites that already
exist — admit, prefill chunk, decode batches, spec accept/reject,
preemption, quarantine, ``_terminalize`` — stamp segments into a bounded
per-request timeline. At flush the timelines are exported as extra
Chrome-trace tracks (one Perfetto thread per request, grouped under a
"serving requests" process per rank) merged into the same
``trace_rank<r>.json`` the span tracer writes, so the step spans and the
request waterfalls line up on one clock.

Overhead contract (the same one the span tracer pins):
  - disabled (default): every call site is ONE attribute check
    (``if rt.enabled:``) — no allocation, no clock read, no device sync;
  - enabled: list/dict mutation plus at most one ``perf_counter_ns``
    read per stamp; dispatch segments reuse the timestamps the engine
    already took for its latency histograms, so the hot path gains no
    extra clock reads;
  - export rides the existing flush boundary (``SpanTracer.flush``)
    via the tracer's event-source hook — never a new host sync.

Trace ids double as histogram exemplars: the engine/front-end pass
``req.trace_id`` into ``Histogram.observe(..., exemplar=...)`` so a bad
TTFT/ITL p99 bucket links back to concrete request timelines.

Copy of ``deepspeed_tpu/observability/request_trace.py`` for the
PyTorch port (it imports no JAX).  ``on_promote`` is kept for the
tiered host cache, which is not in the port yet (ROADMAP.md queue A
item 4, second part).
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional

#: request tracks render as their own Perfetto process group, offset from
#: the per-rank span process so the waterfall sorts below the step spans
REQUEST_TRACK_PID_OFFSET = 1000


class _Timeline:
    """One request's recorded lifetime. Mutated in place; bounded."""
    __slots__ = ("trace_id", "req_id", "tenant", "tid", "events", "phase",
                 "phase_t0_ns", "done", "dropped_segments")

    def __init__(self, trace_id: str, req_id: str, tenant: str, tid: int):
        self.trace_id = trace_id
        self.req_id = req_id
        self.tenant = tenant
        self.tid = tid
        # (ph, name, ts_ns, dur_ns, args) — ph "X" duration / "i" instant
        self.events: List[tuple] = []
        self.phase: Optional[str] = None
        self.phase_t0_ns = 0
        self.done = False
        self.dropped_segments = 0


class RequestTraceRecorder:
    """Process-global per-request timeline recorder.

    Bounded two ways: at most ``capacity`` request timelines are retained
    (oldest *completed* evicted first) and each timeline holds at most
    ``max_segments`` stamped events (later dispatch segments are counted
    as dropped; phase transitions and the terminal stamp always land).
    """

    def __init__(self, capacity: int = 512, max_segments: int = 256):
        self.enabled = False
        self._capacity = int(capacity)
        self._max_segments = int(max_segments)
        self._traces: "OrderedDict[str, _Timeline]" = OrderedDict()
        self._lock = threading.Lock()
        self._seq = itertools.count()
        self._tid_seq = itertools.count(1)
        self._dropped = 0
        self.rank = 0

    # -- configuration -----------------------------------------------------
    def configure(self, enabled: bool, capacity: Optional[int] = None,
                  max_segments: Optional[int] = None,
                  rank: Optional[int] = None) -> None:
        with self._lock:
            if capacity is not None and int(capacity) > 0:
                self._capacity = int(capacity)
            if max_segments is not None and int(max_segments) > 0:
                self._max_segments = int(max_segments)
            if rank is not None:
                self.rank = int(rank)
            self.enabled = bool(enabled)

    # -- introspection -----------------------------------------------------
    @property
    def recorded(self) -> int:
        return len(self._traces)

    @property
    def dropped(self) -> int:
        """Timelines evicted by the retention cap."""
        return self._dropped

    def get(self, trace_id: Optional[str]) -> Optional[_Timeline]:
        return self._traces.get(trace_id) if trace_id else None

    def lookup(self, req: Any) -> Optional[_Timeline]:
        """Timeline for a live request. Prefers the per-leg storage key
        (``req._trace_key``) over ``req.trace_id`` — under fleet trace
        propagation several legs (prefill, decode, failover replay)
        share ONE trace_id but each owns its own timeline."""
        key = getattr(req, "_trace_key", None) or \
            getattr(req, "trace_id", None)
        return self._traces.get(key) if key else None

    def reset(self) -> None:
        with self._lock:
            self._traces.clear()
            self._dropped = 0

    # -- internal ----------------------------------------------------------
    def _evict_locked(self) -> None:
        while len(self._traces) > self._capacity:
            victim = None
            for tl in self._traces.values():      # oldest completed first
                if tl.done:
                    victim = tl.trace_id
                    break
            if victim is None:                    # all live: drop oldest
                victim = next(iter(self._traces))
            del self._traces[victim]
            self._dropped += 1

    def _append(self, tl: _Timeline, ph: str, name: str, ts_ns: int,
                dur_ns: int, args: Optional[Dict[str, Any]],
                force: bool = False) -> None:
        if len(tl.events) >= self._max_segments and not force:
            tl.dropped_segments += 1
            return
        tl.events.append((ph, name, ts_ns, dur_ns, args))

    def _close_phase(self, tl: _Timeline, now_ns: int) -> None:
        if tl.phase is not None:
            self._append(tl, "X", tl.phase, tl.phase_t0_ns,
                         max(0, now_ns - tl.phase_t0_ns), None, force=True)
            tl.phase = None

    def _open_phase(self, tl: _Timeline, name: str, now_ns: int) -> None:
        tl.phase = name
        tl.phase_t0_ns = now_ns

    # -- lifecycle stamps (call sites guard on ``.enabled``) ---------------
    def on_submit(self, req: Any) -> str:
        """Assign ``req.trace_id`` and open the ``queued`` phase.

        A trace id already present on the request is HONOURED, not
        replaced — that is the distributed-trace contract: the fleet
        router mints one id per fleet request and every leg (prefill
        worker, decode replica, failover replay) stamps its segments
        under it. Each leg still gets its own timeline: on a storage-key
        collision the new leg is filed under ``trace_id#<seq>`` and the
        request remembers its key in ``req._trace_key``."""
        now = time.perf_counter_ns()
        preset = getattr(req, "trace_id", None)
        trace_id = preset or f"r{self.rank:x}-{next(self._seq):06x}"
        with self._lock:
            key = trace_id
            if key in self._traces:
                key = f"{trace_id}#{next(self._seq):x}"
            tl = _Timeline(trace_id, req.req_id, req.tenant,
                           next(self._tid_seq))
            self._open_phase(tl, "queued", now)
            self._traces[key] = tl
            self._evict_locked()
        req.trace_id = trace_id
        try:
            req._trace_key = key
        except Exception:       # slotted/frozen request objects opt out
            pass
        return trace_id

    def on_admit(self, req: Any, slot: int, cache_hit_tokens: int) -> None:
        tl = self.lookup(req)
        if tl is None:
            return
        now = time.perf_counter_ns()
        with self._lock:
            self._close_phase(tl, now)
            self._append(tl, "i", "admit", now, 0,
                         {"slot": slot, "cache_hit_tokens": cache_hit_tokens,
                          "trace_id": tl.trace_id})
            # a full prefix-cache hit skips straight to decode
            self._open_phase(tl, "prefill" if req.prefilling else "decode",
                             now)

    def on_preempt(self, req: Any) -> None:
        tl = self.lookup(req)
        if tl is None:
            return
        now = time.perf_counter_ns()
        with self._lock:
            self._close_phase(tl, now)
            self._append(tl, "i", "preempt", now, 0,
                         {"preemptions": req.preemptions}, force=True)
            self._open_phase(tl, "queued", now)

    def on_prefill_chunk(self, req: Any, t0_s: float, dur_s: float,
                         start: int, tokens: int, done: bool) -> None:
        tl = self.lookup(req)
        if tl is None:
            return
        t0_ns = int(t0_s * 1e9)
        with self._lock:
            self._append(tl, "X", "prefill_chunk", t0_ns, int(dur_s * 1e9),
                         {"start": start, "tokens": tokens})
            if done and tl.phase == "prefill":
                now = t0_ns + int(dur_s * 1e9)
                self._close_phase(tl, now)
                self._open_phase(tl, "decode", now)

    def on_decode(self, reqs: List[Any], t0_s: float, dur_s: float,
                  batch: int) -> None:
        t0_ns = int(t0_s * 1e9)
        dur_ns = int(dur_s * 1e9)
        with self._lock:
            for req in reqs:
                tl = self.lookup(req)
                if tl is not None:
                    self._append(tl, "X", "decode", t0_ns, dur_ns,
                                 {"batch": batch})

    def on_promote(self, reqs: List[Any], t0_s: float, dur_s: float,
                   blocks: int) -> None:
        """Host-tier promotion window: KV blocks restored from host
        DRAM/NVMe into the device pool while the request is held in the
        PROMOTING phase (docs/serving.md "Tiered prefix cache")."""
        t0_ns = int(t0_s * 1e9)
        dur_ns = int(dur_s * 1e9)
        with self._lock:
            for req in reqs:
                tl = self.lookup(req)
                if tl is not None:
                    self._append(tl, "X", "promote", t0_ns, dur_ns,
                                 {"blocks": blocks})

    def on_spec(self, reqs: List[Any], t0_s: float, dur_s: float,
                proposed: int, accepted: int) -> None:
        t0_ns = int(t0_s * 1e9)
        dur_ns = int(dur_s * 1e9)
        with self._lock:
            for req in reqs:
                tl = self.lookup(req)
                if tl is not None:
                    self._append(tl, "X", "spec_decode", t0_ns, dur_ns,
                                 {"proposed": proposed, "accepted": accepted})

    def on_segment(self, req: Any, name: str, t0_s: float, dur_s: float,
                   **args: Any) -> None:
        """Explicit duration segment stamped from timestamps the caller
        already took (fabric publish window, failover replay window) —
        these are fleet-trace flow anchors, so they always land even in
        a segment-capped timeline."""
        tl = self.lookup(req)
        if tl is None:
            return
        with self._lock:
            self._append(tl, "X", name, int(t0_s * 1e9), int(dur_s * 1e9),
                         args or None, force=True)

    def mark(self, req: Any, name: str, **args: Any) -> None:
        """Instantaneous event (quarantine, growth-hold, ...)."""
        tl = self.lookup(req)
        if tl is None:
            return
        with self._lock:
            self._append(tl, "i", name, time.perf_counter_ns(), 0,
                         args or None)

    def on_terminal(self, req: Any) -> None:
        tl = self.lookup(req)
        if tl is None:
            return
        now = time.perf_counter_ns()
        with self._lock:
            self._close_phase(tl, now)
            args = {"status": getattr(req.status, "name", str(req.status)),
                    "tokens": len(req.output),
                    "preemptions": req.preemptions,
                    "trace_id": tl.trace_id}
            if req.error:
                args["error"] = str(req.error)[:200]
            if tl.dropped_segments:
                args["dropped_segments"] = tl.dropped_segments
            self._append(tl, "i", "terminal", now, 0, args, force=True)
            tl.done = True

    # -- export (tracer event source; runs at the flush boundary) ----------
    def chrome_events(self, epoch_ns: int, rank: int) -> List[Dict[str, Any]]:
        """Chrome-trace events for every retained timeline: one thread
        track per request under a 'serving requests' process group."""
        pid = REQUEST_TRACK_PID_OFFSET + rank
        with self._lock:
            timelines = list(self._traces.values())
        if not timelines:
            return []
        out: List[Dict[str, Any]] = [
            {"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
             "args": {"name": f"serving requests rank {rank}"}},
            {"ph": "M", "pid": pid, "tid": 0, "name": "process_sort_index",
             "args": {"sort_index": pid}},
        ]
        for tl in timelines:
            out.append({"ph": "M", "pid": pid, "tid": tl.tid,
                        "name": "thread_name",
                        "args": {"name": f"{tl.req_id} [{tl.tenant}]"}})
            out.append({"ph": "M", "pid": pid, "tid": tl.tid,
                        "name": "thread_sort_index",
                        "args": {"sort_index": tl.tid}})
            events = list(tl.events)
            if tl.phase is not None:     # still-open phase: emit to "now"
                now = time.perf_counter_ns()
                events.append(("X", tl.phase, tl.phase_t0_ns,
                               max(0, now - tl.phase_t0_ns),
                               {"open": True}))
            for ph, name, ts_ns, dur_ns, args in events:
                ev: Dict[str, Any] = {
                    "ph": ph, "pid": pid, "tid": tl.tid, "name": name,
                    "cat": "request", "ts": (ts_ns - epoch_ns) / 1000.0}
                if ph == "X":
                    ev["dur"] = dur_ns / 1000.0
                else:
                    ev["s"] = "t"
                ev["args"] = dict(args) if args else {}
                ev["args"].setdefault("trace_id", tl.trace_id)
                out.append(ev)
        return out


_recorder = RequestTraceRecorder()


def get_request_tracer() -> RequestTraceRecorder:
    return _recorder
