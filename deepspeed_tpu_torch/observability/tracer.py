"""Span tracer: Chrome trace-event JSON over a preallocated ring buffer.

The host-side complement of the device profiler: kernels show up in
``torch.profiler``'s trace, but the subsystems this framework adds around the device —
swap workers, host optimizer sweeps, checkpoint commits, retry loops,
rendezvous — are invisible to it. ``trace_span("zero/nvme_write", ...)``
context managers record wall-clock spans into a fixed-capacity ring
(oldest spans overwritten, nothing ever grows on the hot path) and
``flush()`` serializes them as Chrome trace-event JSON — one file per
process, with process/rank metadata and one track per thread — loadable
directly in Perfetto (https://ui.perfetto.dev) or chrome://tracing.

Overhead contract (docs/observability.md):
  - disabled: ``span()`` is one attribute check returning a shared
    no-op singleton — no allocation, no clock read;
  - enabled: two ``perf_counter_ns`` reads and one in-place ring-record
    mutation per span; no I/O, no device interaction;
  - flush: the ONLY place a device sync may happen, and only when the
    caller passes ``sync=`` (a tensor whose value is read to the host).

Copy of ``deepspeed_tpu/observability/tracer.py`` for the PyTorch port:
the flush's optional ``sync`` joins a torch tensor instead of a JAX
array; nothing is added (no NVTX range, no ``record_function``).
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional


class _Rec:
    """One preallocated ring slot, mutated in place at span exit."""
    __slots__ = ("name", "cat", "ts_ns", "dur_ns", "tid", "args")

    def __init__(self):
        self.name = ""
        self.cat = ""
        self.ts_ns = 0
        self.dur_ns = 0
        self.tid = 0
        self.args: Optional[Dict[str, Any]] = None


class _NullSpan:
    """Shared do-nothing span — the entire disabled code path."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


NULL_SPAN = _NullSpan()


class _LiveSpan:
    __slots__ = ("_tracer", "_name", "_cat", "_args", "_t0")

    def __init__(self, tracer: "SpanTracer", name: str, cat: str,
                 args: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args
        self._t0 = 0

    def set(self, **attrs):
        """Attach attributes discovered mid-span."""
        if self._args is None:
            self._args = attrs
        else:
            self._args.update(attrs)
        return self

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self._tracer._commit(self._name, self._cat, self._t0,
                             time.perf_counter_ns(), self._args)
        return False


class SpanTracer:
    """Fixed-capacity span recorder with Chrome trace-event export.

    One per process (module singleton via ``observability.get_tracer()``);
    thread-safe — worker threads (swap ring, infinity optimizer pool,
    offload sweep) record onto their own Perfetto tracks keyed by thread
    id, named from ``threading.current_thread().name``.
    """

    def __init__(self, capacity: int = 65536):
        self.enabled = False
        self._capacity = int(capacity)
        self._ring: List[_Rec] = []          # preallocated on first enable
        self._n = 0                          # total spans ever committed
        self._lock = threading.Lock()
        self._thread_names: Dict[int, str] = {}
        self._epoch_ns = time.perf_counter_ns()
        self.rank = 0
        self.output_dir = "traces"
        self._m_dropped = None     # lazily-bound overflow counter
        # extra flush-time event providers (the request-trace recorder
        # merges its per-request waterfall tracks here) — keyed so
        # re-configuration doesn't stack duplicates. Each provider is
        # called as fn(epoch_ns, rank) -> [chrome events].
        self._event_sources: Dict[str, Any] = {}

    # -- configuration -----------------------------------------------------
    def configure(self, enabled: bool, capacity: Optional[int] = None,
                  output_dir: Optional[str] = None,
                  rank: Optional[int] = None) -> None:
        with self._lock:
            if capacity is not None and int(capacity) > 0:
                if int(capacity) != self._capacity or not self._ring:
                    self._capacity = int(capacity)
                    self._ring = []
                    self._n = 0
            if output_dir is not None:
                self.output_dir = output_dir
            if rank is not None:
                self.rank = int(rank)
            if enabled and not self._ring:
                # THE preallocation: every span the process will ever
                # record lands in one of these slots
                self._ring = [_Rec() for _ in range(self._capacity)]
                self._epoch_ns = time.perf_counter_ns()
            self.enabled = bool(enabled)

    # -- recording ---------------------------------------------------------
    def span(self, name: str, cat: str = "", **args):
        """Context manager timing one host-side span. Disabled → the
        shared no-op singleton (no allocation)."""
        if not self.enabled:
            return NULL_SPAN
        return _LiveSpan(self, name, cat, args or None)

    def _commit(self, name: str, cat: str, t0_ns: int, t1_ns: int,
                args: Optional[Dict[str, Any]]) -> None:
        tid = threading.get_ident()
        with self._lock:
            if not self._ring:      # disabled mid-span; drop silently
                return
            if tid not in self._thread_names:
                self._thread_names[tid] = threading.current_thread().name
            rec = self._ring[self._n % self._capacity]
            rec.name = name
            rec.cat = cat
            rec.ts_ns = t0_ns
            rec.dur_ns = t1_ns - t0_ns
            rec.tid = tid
            rec.args = args
            self._n += 1
            overflowed = self._n > self._capacity
        if overflowed:
            # ring wraparound just overwrote the oldest span — truncation
            # must be loud (a trace missing its head is easy to misread
            # as "nothing happened early")
            if self._m_dropped is None:
                from . import get_registry
                reg = get_registry()
                self._m_dropped = reg.counter(
                    "dstpu_trace_dropped_spans_total",
                    "spans overwritten by trace ring wraparound")
            self._m_dropped.inc()

    # -- introspection -----------------------------------------------------
    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def recorded(self) -> int:
        """Spans currently held (≤ capacity)."""
        return min(self._n, self._capacity)

    @property
    def dropped(self) -> int:
        """Spans overwritten by ring wraparound."""
        return max(0, self._n - self._capacity)

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    # -- event sources -----------------------------------------------------
    def set_event_source(self, key: str, fn: Any) -> None:
        """Register (or replace) a flush-time event provider; pass
        ``None`` to remove it."""
        with self._lock:
            if fn is None:
                self._event_sources.pop(key, None)
            else:
                self._event_sources[key] = fn

    @property
    def epoch_ns(self) -> int:
        return self._epoch_ns

    # -- export ------------------------------------------------------------
    def _events(self) -> List[Dict[str, Any]]:
        """Trace events, oldest first, under the lock (consistent cut even
        while workers keep recording)."""
        with self._lock:
            n = min(self._n, self._capacity)
            start = self._n - n
            out = []
            for i in range(start, self._n):
                rec = self._ring[i % self._capacity]
                ev = {"ph": "X", "pid": self.rank, "tid": rec.tid,
                      "name": rec.name,
                      "ts": (rec.ts_ns - self._epoch_ns) / 1000.0,
                      "dur": rec.dur_ns / 1000.0}
                if rec.cat:
                    ev["cat"] = rec.cat
                if rec.args:
                    ev["args"] = dict(rec.args)
                out.append(ev)
            threads = dict(self._thread_names)
        meta: List[Dict[str, Any]] = [
            {"ph": "M", "pid": self.rank, "tid": 0, "name": "process_name",
             "args": {"name": f"deepspeed_tpu_torch rank {self.rank} "
                              f"(pid {os.getpid()})"}},
            {"ph": "M", "pid": self.rank, "tid": 0,
             "name": "process_sort_index", "args": {"sort_index": self.rank}},
        ]
        for tid, tname in sorted(threads.items()):
            meta.append({"ph": "M", "pid": self.rank, "tid": tid,
                         "name": "thread_name", "args": {"name": tname}})
        with self._lock:
            sources = list(self._event_sources.values())
        extra: List[Dict[str, Any]] = []
        for fn in sources:
            try:
                extra.extend(fn(self._epoch_ns, self.rank))
            except Exception:    # a broken source must not kill the flush
                pass
        return meta + out + extra

    def flush(self, path: Optional[str] = None, sync: Any = None) -> str:
        """Serialize the ring to Chrome trace-event JSON.

        ``sync`` — optional device tensor to join before the cut (the
        ONE deliberate flush-boundary device sync: its value is read to
        the host). Returns the written path. The
        ring is NOT cleared: re-flushing overwrites the file with the
        newest window of spans.
        """
        if sync is not None:
            sync.detach().cpu()
        if path is None:
            os.makedirs(self.output_dir, exist_ok=True)
            path = os.path.join(self.output_dir,
                                f"trace_rank{self.rank}.json")
        doc = {
            "traceEvents": self._events(),
            "displayTimeUnit": "ms",
            "otherData": {"producer": "deepspeed_tpu_torch.observability",
                          "rank": self.rank, "pid": os.getpid(),
                          "dropped": self.dropped,
                          "dropped_spans": self.dropped},
        }
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path
