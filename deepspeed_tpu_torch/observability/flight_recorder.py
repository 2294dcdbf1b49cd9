"""Black-box flight recorder: bounded engine-state ring + post-mortem dump.

When a serving engine dies with a ``ServingError`` (watchdog trip, fatal
fault, failure to drain) or the training engine skips a burst of steps,
the histogram means and the last log line are not enough to reconstruct
*how it got there*. The flight recorder keeps a fixed-size ring of
per-iteration engine snapshots — queue depth, pool occupancy,
preemption/pinned counts, lifecycle/spec counters — plus the last N
terminal events, all plain host-side ints gathered at the existing
iteration boundary. On failure it dumps a **post-mortem bundle**:

    <output_dir>/postmortem-r<rank>-<seq>/
        reason.json       what tripped, free-form detail, engine diagnose
        snapshots.json    the ring, oldest first
        terminals.json    last N terminal request events
        metrics.prom      Prometheus textfile at the moment of death
        trace.json        Chrome trace (spans + request waterfalls),
                          when tracing is enabled
        fleet_events.json fleet lifecycle ring (handoffs, failovers,
                          drains/joins, replica deaths + the trace ids
                          of in-flight requests), when a fleet recorded
        manifest.json     content checksums (runtime/resilience integrity)

Every file is written with the atomic-write machinery from
``runtime/resilience/integrity.py`` and the bundle is sealed with
``write_manifest`` so tooling can verify it was not torn by the dying
process. Dumping must never make a bad day worse: ``dump()`` swallows
its own errors and rate-limits repeated triggers.

Overhead contract: disabled (default) every site is one attribute
check; enabled, ``record()`` is one in-place ring write of an
already-built dict — no I/O, no device interaction until a failure
actually dumps.

Copy of ``deepspeed_tpu/observability/flight_recorder.py`` for the
PyTorch port; bundles are written through the port's
``runtime/resilience/integrity.py``.
"""
from __future__ import annotations

import os
import shutil
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional


class FlightRecorder:
    """Process-global snapshot ring with atomic post-mortem bundles."""

    def __init__(self, capacity: int = 256):
        self.enabled = False
        self._capacity = int(capacity)
        self._ring: List[Optional[Dict[str, Any]]] = []
        self._n = 0                          # total snapshots ever recorded
        self._terminals: deque = deque(maxlen=64)
        #: fleet lifecycle events (handoff / failover / drain / join /
        #: replica_dead) — sealed into every bundle as fleet_events.json
        self._fleet_events: deque = deque(maxlen=64)
        self._lock = threading.Lock()
        self.output_dir = "flight_recorder"
        self.skip_burst_steps = 8
        self.max_bundles = 4
        self.min_dump_interval_s = 1.0
        self.rank = 0
        self._dump_seq = 0
        self._last_dump_t: Optional[float] = None
        self.last_bundle: Optional[str] = None

    # -- configuration -----------------------------------------------------
    def configure(self, enabled: bool, capacity: Optional[int] = None,
                  output_dir: Optional[str] = None,
                  max_terminal_events: Optional[int] = None,
                  skip_burst_steps: Optional[int] = None,
                  max_bundles: Optional[int] = None,
                  rank: Optional[int] = None) -> None:
        with self._lock:
            if capacity is not None and int(capacity) > 0:
                if int(capacity) != self._capacity or not self._ring:
                    self._capacity = int(capacity)
                    self._ring = []
                    self._n = 0
            if output_dir is not None:
                self.output_dir = output_dir
            if max_terminal_events is not None and int(max_terminal_events) > 0:
                self._terminals = deque(self._terminals,
                                        maxlen=int(max_terminal_events))
            if skip_burst_steps is not None:
                self.skip_burst_steps = int(skip_burst_steps)
            if max_bundles is not None and int(max_bundles) > 0:
                self.max_bundles = int(max_bundles)
            if rank is not None:
                self.rank = int(rank)
            if enabled and not self._ring:
                # preallocated like the span ring: record() never grows it
                self._ring = [None] * self._capacity
            self.enabled = bool(enabled)

    # -- recording (call sites guard on ``.enabled``) ----------------------
    def record(self, snap: Dict[str, Any]) -> None:
        with self._lock:
            if not self._ring:
                return
            self._ring[self._n % self._capacity] = snap
            self._n += 1

    def note_terminal(self, info: Dict[str, Any]) -> None:
        with self._lock:
            self._terminals.append(info)

    def note_fleet_event(self, info: Dict[str, Any]) -> None:
        """Record one fleet lifecycle event (router/replica sites guard
        on ``.enabled``); stamped with a timestamp if the caller did not
        provide one."""
        if "t" not in info:
            info = dict(info, t=time.perf_counter())
        with self._lock:
            self._fleet_events.append(info)

    # -- introspection -----------------------------------------------------
    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def recorded(self) -> int:
        return min(self._n, self._capacity)

    @property
    def dropped(self) -> int:
        return max(0, self._n - self._capacity)

    def snapshots(self) -> List[Dict[str, Any]]:
        """Retained snapshots, oldest first."""
        with self._lock:
            n = min(self._n, self._capacity)
            start = self._n - n
            return [self._ring[i % self._capacity]
                    for i in range(start, self._n)]

    def terminals(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._terminals)

    def fleet_events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._fleet_events)

    def reset(self) -> None:
        with self._lock:
            self._ring = [None] * self._capacity if self._ring else []
            self._n = 0
            self._terminals.clear()
            self._fleet_events.clear()

    # -- post-mortem -------------------------------------------------------
    def dump(self, reason: str, detail: str = "",
             extra: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """Write a post-mortem bundle; returns its path, or None when
        disabled, rate-limited, or the dump itself failed (a recorder
        failure must never mask the original error)."""
        if not self.enabled:
            return None
        now = time.monotonic()
        with self._lock:
            if (self._last_dump_t is not None
                    and now - self._last_dump_t < self.min_dump_interval_s):
                return None
            self._last_dump_t = now
            self._dump_seq += 1
            seq = self._dump_seq
        try:
            return self._write_bundle(seq, reason, detail, extra)
        except Exception:
            return None

    def _write_bundle(self, seq: int, reason: str, detail: str,
                      extra: Optional[Dict[str, Any]]) -> str:
        from ..runtime.resilience.integrity import (atomic_write_json,
                                                    atomic_write_text,
                                                    write_manifest)
        bundle = os.path.join(self.output_dir,
                              f"postmortem-r{self.rank}-{seq:04d}")
        if os.path.exists(bundle):           # restarted process, stale seq
            bundle = f"{bundle}-{os.getpid()}"
        os.makedirs(bundle, exist_ok=True)
        atomic_write_json(os.path.join(bundle, "reason.json"), {
            "reason": reason, "detail": detail, "extra": extra or {},
            "rank": self.rank, "pid": os.getpid(),
            "unix_time": time.time(),
        }, indent=2)
        atomic_write_json(os.path.join(bundle, "snapshots.json"), {
            "count": self.recorded, "dropped": self.dropped,
            "snapshots": self.snapshots(),
        }, indent=2)
        atomic_write_json(os.path.join(bundle, "terminals.json"),
                          self.terminals(), indent=2)
        fleet_events = self.fleet_events()
        if fleet_events:
            # fleet context (when this process hosts a fleet): the event
            # ring plus the trace ids a post-mortem can chase into the
            # merged fleet trace
            atomic_write_json(os.path.join(bundle, "fleet_events.json"),
                              fleet_events, indent=2)
        from . import get_registry, get_tracer
        reg = get_registry()
        reg.collect()
        atomic_write_text(os.path.join(bundle, "metrics.prom"),
                          reg.to_prometheus())
        tracer = get_tracer()
        if tracer.enabled:
            # request-track event sources ride the same flush
            tracer.flush(path=os.path.join(bundle, "trace.json"))
        write_manifest(bundle)
        self._prune_bundles()
        self.last_bundle = bundle
        return bundle

    def _prune_bundles(self) -> None:
        try:
            mine = sorted(
                d for d in os.listdir(self.output_dir)
                if d.startswith(f"postmortem-r{self.rank}-"))
        except OSError:
            return
        for stale in mine[:-self.max_bundles]:
            shutil.rmtree(os.path.join(self.output_dir, stale),
                          ignore_errors=True)


_flight = FlightRecorder()


def get_flight_recorder() -> FlightRecorder:
    return _flight
