"""Host/device overlap profiler: where does an iteration's wall time go?

ROADMAP item 4 (async multi-step scheduling) needs an instrument before
it needs a scheduler: you cannot pipeline a bubble you cannot measure.
This module splits every engine iteration's wall time into

  - **host-plan** — scheduler/allocator/promote planning and bookkeeping
    between dispatches (wall minus everything below);
  - **dispatch-enqueue** — from the start of a dispatch until its
    launches return (the host enqueueing asynchronous device work);
  - **device-wait** — from there to the host-side materialization the
    engine already performs (the ``.tolist()`` of the sampled ids),
    i.e. the host blocked on the device.

and derives ``overlap_frac = 1 - device_wait / wall`` — the fraction of
the iteration the host spent doing useful work rather than blocked on
the device. Today's synchronous engines sit near their floor; the async
scheduler's acceptance test is this number going UP.

Contract (same as every observability hook in this repo):
  - the timestamps reuse instants the engines already capture for their
    latency histograms — **no new device syncs** in any path;
  - disabled (default), every engine call site is ONE attribute check
    (``if ovl.enabled:``) — no allocation, no clock read;
  - enabled, the serving iteration adds two ``perf_counter`` reads
    (iteration bracket) and one per dispatch (enqueue/wait split);
  - export rides the existing flush boundary: gauges + histograms into
    the metrics registry, a per-iteration track into the Chrome trace
    via the tracer's event-source hook.

Copy of ``deepspeed_tpu/observability/overlap.py`` for the PyTorch port.
In the port's eager serving engine a dispatch's *enqueue* is the time
from its start until the eager launches of the mixed step (and the
draft's feeds) return, and its *device wait* is the one ``.tolist()``
that already ends every dispatch; the training step's wait is the
``engine/step_sync`` join.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

#: overlap iteration tracks render as their own Perfetto process group
OVERLAP_TRACK_PID_OFFSET = 2000

#: buckets for the dimensionless overlap fraction
FRAC_BUCKETS = (0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8,
                0.9, 0.95, 1.0)


class _Rec:
    __slots__ = ("kind", "t0_ns", "total_ns", "plan_ns", "enq_ns",
                 "wait_ns", "frac", "dispatches")

    def __init__(self):
        self.kind = ""
        self.t0_ns = 0
        self.total_ns = 0
        self.plan_ns = 0
        self.enq_ns = 0
        self.wait_ns = 0
        self.frac = 0.0
        self.dispatches = 0


class OverlapProfiler:
    """Per-iteration host/device overlap accounting (module singleton).

    Serving protocol (``ServingEngine._step_impl``)::

        if ovl.enabled: ovl.begin()
        ...                                # per dispatch:
        if ovl.enabled: ovl.note_dispatch(enqueue_s, wait_s)
        ...
        if ovl.enabled: ovl.end("serving")

    Training records one-shot (``ovl.observe("train", ...)``) from the
    timestamps the step path already takes.
    """

    def __init__(self, capacity: int = 2048):
        self.enabled = False
        self._capacity = int(capacity)
        self._ring: List[_Rec] = []
        self._n = 0
        self._lock = threading.Lock()
        self.rank = 0
        self._metrics: Dict[str, tuple] = {}
        # open-iteration accumulators (engine step loop is single-threaded)
        self._it_t0_ns = 0
        self._it_enq_s = 0.0
        self._it_wait_s = 0.0
        self._it_dispatches = 0

    # -- configuration -----------------------------------------------------
    def configure(self, enabled: bool, capacity: Optional[int] = None,
                  rank: Optional[int] = None) -> None:
        with self._lock:
            if capacity is not None and int(capacity) > 0:
                if int(capacity) != self._capacity or not self._ring:
                    self._capacity = int(capacity)
                    self._ring = []
                    self._n = 0
            if rank is not None:
                self.rank = int(rank)
            if enabled and not self._ring:
                self._ring = [_Rec() for _ in range(self._capacity)]
            self.enabled = bool(enabled)

    def _metrics_for(self, kind: str) -> tuple:
        m = self._metrics.get(kind)
        if m is not None:
            return m
        from . import get_registry
        reg = get_registry()
        # literal registration per engine kind — dstpu-lint's DRIFT001
        # resolver reads these names, keeping code and the docs metric
        # table verifiably in sync
        if kind == "serving":
            m = (reg.gauge("dstpu_serving_host_plan_ms",
                           "host planning time in the last serving "
                           "iteration"),
                 reg.gauge("dstpu_serving_device_wait_ms",
                           "host blocked on device in the last serving "
                           "iteration"),
                 reg.gauge("dstpu_serving_overlap_frac",
                           "1 - device_wait/wall for the last serving "
                           "iteration"),
                 reg.histogram("dstpu_serving_host_plan_seconds",
                               "serving per-iteration host planning time"),
                 reg.histogram("dstpu_serving_device_wait_seconds",
                               "serving per-iteration device wait"),
                 reg.histogram("dstpu_serving_overlap_frac_dist",
                               "serving per-iteration overlap fraction",
                               buckets=FRAC_BUCKETS))
        else:
            m = (reg.gauge("dstpu_train_host_plan_ms",
                           "host planning time in the last training step"),
                 reg.gauge("dstpu_train_device_wait_ms",
                           "host blocked on device in the last training "
                           "step"),
                 reg.gauge("dstpu_train_overlap_frac",
                           "1 - device_wait/wall for the last training "
                           "step"),
                 reg.histogram("dstpu_train_host_plan_seconds",
                               "training per-step host planning time"),
                 reg.histogram("dstpu_train_device_wait_seconds",
                               "training per-step device wait"),
                 reg.histogram("dstpu_train_overlap_frac_dist",
                               "training per-step overlap fraction",
                               buckets=FRAC_BUCKETS))
        self._metrics[kind] = m
        return m

    # -- serving iteration protocol ----------------------------------------
    def begin(self) -> None:
        self._it_t0_ns = time.perf_counter_ns()
        self._it_enq_s = 0.0
        self._it_wait_s = 0.0
        self._it_dispatches = 0

    def note_dispatch(self, enqueue_s: float, wait_s: float) -> None:
        self._it_enq_s += max(0.0, enqueue_s)
        self._it_wait_s += max(0.0, wait_s)
        self._it_dispatches += 1

    def end(self, kind: str = "serving") -> None:
        t0 = self._it_t0_ns
        if not t0:
            return
        self._it_t0_ns = 0
        total_s = (time.perf_counter_ns() - t0) / 1e9
        self.observe(kind, total_s=total_s, enqueue_s=self._it_enq_s,
                     wait_s=self._it_wait_s, t0_ns=t0,
                     dispatches=self._it_dispatches)

    # -- one-shot (training) ----------------------------------------------
    def observe(self, kind: str, total_s: float, enqueue_s: float,
                wait_s: float, t0_ns: Optional[int] = None,
                dispatches: int = 1) -> None:
        total_s = max(0.0, total_s)
        enqueue_s = max(0.0, min(enqueue_s, total_s))
        wait_s = max(0.0, min(wait_s, total_s - enqueue_s))
        plan_s = max(0.0, total_s - enqueue_s - wait_s)
        frac = 1.0 - (wait_s / total_s) if total_s > 0 else 1.0
        g_plan, g_wait, g_frac, h_plan, h_wait, h_frac = \
            self._metrics_for(kind)
        g_plan.set(plan_s * 1e3)
        g_wait.set(wait_s * 1e3)
        g_frac.set(frac)
        h_plan.observe(plan_s)
        h_wait.observe(wait_s)
        h_frac.observe(frac)
        with self._lock:
            if not self._ring:
                return
            rec = self._ring[self._n % self._capacity]
            rec.kind = kind
            rec.t0_ns = t0_ns if t0_ns is not None else \
                time.perf_counter_ns()
            rec.total_ns = int(total_s * 1e9)
            rec.plan_ns = int(plan_s * 1e9)
            rec.enq_ns = int(enqueue_s * 1e9)
            rec.wait_ns = int(wait_s * 1e9)
            rec.frac = frac
            rec.dispatches = dispatches
            self._n += 1

    # -- one-shot (pipeline bubble probe) ----------------------------------
    def record_bubble(self, frac: float) -> None:
        """Measured pipeline-bubble fraction (the pipeline engine's
        ``measure_bubble_fraction`` probe, `runtime/pipe/engine.py`).
        A gauge, not a histogram: the probe is an explicit profiling
        call, and the interesting value is the latest fit."""
        g = self._metrics.get("bubble")
        if g is None:
            from . import get_registry
            g = get_registry().gauge(
                "dstpu_train_bubble_frac",
                "measured pipeline bubble fraction (two-point slope fit "
                "over the compiled schedule)")
            self._metrics["bubble"] = g
        g.set(max(0.0, min(1.0, float(frac))))

    # -- introspection -----------------------------------------------------
    @property
    def recorded(self) -> int:
        return min(self._n, self._capacity)

    def last(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            if not self._n or not self._ring:
                return None
            rec = self._ring[(self._n - 1) % self._capacity]
            return {"kind": rec.kind, "total_s": rec.total_ns / 1e9,
                    "host_plan_s": rec.plan_ns / 1e9,
                    "enqueue_s": rec.enq_ns / 1e9,
                    "device_wait_s": rec.wait_ns / 1e9,
                    "overlap_frac": rec.frac,
                    "dispatches": rec.dispatches}

    def reset(self) -> None:
        """Drop the records, and the metric handles: the registry they
        were bound to may have been reset since, and the next record
        binds to the current one."""
        with self._lock:
            self._n = 0
            self._metrics.clear()

    # -- export (tracer event source) --------------------------------------
    def chrome_events(self, epoch_ns: int, rank: int
                      ) -> List[Dict[str, Any]]:
        """Per-iteration overlap track: one X slice per iteration plus a
        'C' counter series Perfetto renders as a graph."""
        pid = OVERLAP_TRACK_PID_OFFSET + rank
        with self._lock:
            n = min(self._n, self._capacity)
            start = self._n - n
            recs = [self._ring[i % self._capacity]
                    for i in range(start, self._n)]
        if not recs:
            return []
        kinds = sorted({r.kind for r in recs})
        tids = {k: i + 1 for i, k in enumerate(kinds)}
        out: List[Dict[str, Any]] = [
            {"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
             "args": {"name": f"overlap profiler rank {rank}"}},
            {"ph": "M", "pid": pid, "tid": 0, "name": "process_sort_index",
             "args": {"sort_index": pid}},
        ]
        for k, t in tids.items():
            out.append({"ph": "M", "pid": pid, "tid": t,
                        "name": "thread_name",
                        "args": {"name": f"{k} iterations"}})
        for rec in recs:
            ts = (rec.t0_ns - epoch_ns) / 1000.0
            out.append({"ph": "X", "pid": pid, "tid": tids[rec.kind],
                        "name": f"{rec.kind}_iteration", "cat": "overlap",
                        "ts": ts, "dur": rec.total_ns / 1000.0,
                        "args": {"host_plan_ms": rec.plan_ns / 1e6,
                                 "enqueue_ms": rec.enq_ns / 1e6,
                                 "device_wait_ms": rec.wait_ns / 1e6,
                                 "overlap_frac": round(rec.frac, 4),
                                 "dispatches": rec.dispatches}})
            out.append({"ph": "C", "pid": pid, "tid": tids[rec.kind],
                        "name": f"{rec.kind}_overlap", "ts": ts,
                        "args": {"host_plan_ms": rec.plan_ns / 1e6,
                                 "device_wait_ms": rec.wait_ns / 1e6}})
        return out


_profiler = OverlapProfiler()


def get_overlap_profiler() -> OverlapProfiler:
    return _profiler
