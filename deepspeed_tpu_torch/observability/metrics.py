"""Metrics registry: counters / gauges / histograms with JSON and
Prometheus-textfile exporters.

The scalar half of the telemetry layer (spans live in ``tracer.py``).
Sites across the stack feed signals that previously died in local state:
resilience retry/give-up counts, skipped optimizer steps, step-time
distribution, serving latencies, device memory watermark. Export formats:

  - Prometheus textfile (node_exporter textfile-collector convention:
    write ``<dir>/dstpu_rank<r>.prom`` atomically, let the collector
    scrape it) — fleet dashboards;
  - JSON snapshot — ad-hoc tooling and tests;
  - ``to_events(step)`` — the existing ``MonitorMaster`` fan-out, so
    TensorBoard/CSV/W&B see every scalar for free.

Everything here is stdlib-only and never touches the device: collectors
that read device-adjacent state (memory_stats, comms logs) are plain
host calls registered by their owners via ``set_collector``.

Copy of ``deepspeed_tpu/observability/metrics.py`` for the PyTorch port
(it imports no JAX).
"""
from __future__ import annotations

import bisect
import json
import math
import os
import threading
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

#: default histogram boundaries — seconds, spanning 100 µs .. 60 s (step
#: times, I/O latencies); override per-histogram for other units
DEFAULT_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                   0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                   30.0, 60.0)


def interpolate_quantile(bounds: Sequence[float],
                         counts: Sequence[int], q: float) -> float:
    """The one histogram-quantile estimator (`histogram_quantile()`
    semantics): linear interpolation inside the bucket that crosses the
    target rank, with the +inf tail clamped to the highest finite bound.

    ``bounds`` are the finite upper bounds (sorted); ``counts`` are the
    **per-bucket** (non-cumulative) counts with the +inf tail appended,
    so ``len(counts) == len(bounds) + 1``.  Shared by ``Histogram``,
    the textfile ``_p50/_p95/_p99`` companion lines, and the fleet
    aggregator's bucket-wise merge — one estimator means a merged
    histogram and its sources can disagree by at most interpolation
    inside a single bucket, never by estimator drift.
    """
    if not (0.0 <= q <= 1.0):
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    total = sum(counts)
    if total == 0:
        return 0.0
    target = q * total
    acc = 0
    for i, c in enumerate(counts):
        if acc + c >= target and c > 0:
            if i >= len(bounds):                    # +inf bucket
                return float(bounds[-1])
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i]
            return lo + (hi - lo) * (target - acc) / c
        acc += c
    return float(bounds[-1])


def decumulate(buckets: Sequence[Sequence[Any]]
               ) -> Tuple[Tuple[float, ...], List[int]]:
    """Split a ``to_json()``-shaped cumulative bucket list
    (``[[le | "+Inf", cumulative], ...]``) back into finite bounds and
    per-bucket counts (with +inf tail) — the inverse of
    ``Histogram.cumulative()``, used when merging registry *snapshots*
    rather than live ``Histogram`` objects."""
    bounds: List[float] = []
    counts: List[int] = []
    prev = 0
    for le, cum in buckets:
        if not (le == "+Inf" or le == math.inf):
            bounds.append(float(le))
        counts.append(int(cum) - prev)
        prev = int(cum)
    return tuple(bounds), counts


def sanitize_name(name: str) -> str:
    """Map an arbitrary span/op name onto the Prometheus charset.

    ASCII-strict: ``str.isalnum()`` is true for plenty of characters
    Prometheus rejects (``é``, ``Ⅻ``, CJK), so anything outside
    ``[a-zA-Z0-9_]`` becomes ``_``.
    """
    out = []
    for ch in name:
        out.append(ch if (ch.isascii() and ch.isalnum()) or ch == "_"
                   else "_")
    s = "".join(out)
    if s and s[0].isdigit():
        s = "_" + s
    return s


def tenant_metric_name(prefix: str, tenant: str, *parts: str) -> str:
    """Build a dynamic per-tenant series name that is always a valid
    Prometheus identifier AND collision-free.

    Escaping alone is not enough: two hostile tenant ids (``"a b"`` and
    ``"a.b"``) would both sanitize to ``a_b`` and silently merge their
    series — so whenever sanitization had to change the name (or it was
    empty), a short stable checksum of the *original* id is appended.
    """
    s = sanitize_name(tenant)
    if s != tenant or not s:
        s = f"{s}_{zlib.crc32(tenant.encode('utf-8', 'surrogatepass')) & 0xffff:04x}"
    return "_".join((prefix, s) + parts)


class Counter:
    """Monotonically increasing count."""
    kind = "counter"
    __slots__ = ("name", "help", "_lock", "_value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Last-written value."""
    kind = "gauge"
    __slots__ = ("name", "help", "_lock", "_value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics).

    Observations may carry an **exemplar** — a trace id linking the
    bucket back to the concrete request that landed in it (OpenMetrics
    exemplar semantics: the newest exemplar per bucket wins). Exemplar
    storage is lazily allocated on the first exemplar-carrying
    observation, so histograms without request tracing pay nothing.
    """
    kind = "histogram"
    __slots__ = ("name", "help", "buckets", "_lock", "_counts", "_sum",
                 "_count", "_exemplars")

    def __init__(self, name: str, help: str = "",
                 buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(buckets or DEFAULT_BUCKETS))
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)   # +inf tail
        self._sum = 0.0
        self._count = 0
        self._exemplars: Optional[List[Optional[Tuple[str, float]]]] = None

    def observe(self, v: float, exemplar: Optional[str] = None) -> None:
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if exemplar is not None:
                if self._exemplars is None:
                    self._exemplars = [None] * len(self._counts)
                self._exemplars[i] = (exemplar, v)

    def exemplars(self) -> Dict[int, Tuple[str, float]]:
        """{bucket_index: (trace_id, value)} for buckets holding one."""
        with self._lock:
            if self._exemplars is None:
                return {}
            return {i: ex for i, ex in enumerate(self._exemplars)
                    if ex is not None}

    def quantile(self, q: float) -> float:
        """Estimate the q-quantile by linear interpolation inside the
        bucket bounds (the `histogram_quantile()` estimator): the +inf
        bucket clamps to the highest finite bound, matching Prometheus."""
        with self._lock:
            counts = list(self._counts)
        return interpolate_quantile(self.buckets, counts, q)

    def merge(self, *others: "Histogram") -> "Histogram":
        """Bucket-wise merge: a NEW histogram whose per-bucket counts
        are the element-wise sums of ``self`` and ``others``.

        This is the fleet-aggregation primitive: merging the replicas'
        bucket counts and interpolating once is exact up to bucket
        resolution, whereas averaging per-replica quantiles is simply
        wrong (a p99 is not a mean).  All inputs must share identical
        bucket bounds — silently resampling mismatched layouts would
        hide exactly the kind of drift the lint exists to catch."""
        for o in others:
            if o.buckets != self.buckets:
                raise ValueError(
                    f"cannot merge histogram {o.name!r}: bucket bounds "
                    f"differ from {self.name!r} ({o.buckets} vs "
                    f"{self.buckets})")
        out = Histogram(self.name, help=self.help, buckets=self.buckets)
        for h in (self,) + others:
            with h._lock:
                counts = list(h._counts)
                s, c = h._sum, h._count
            for i, n in enumerate(counts):
                out._counts[i] += n
            out._sum += s
            out._count += c
            ex = h.exemplars()
            if ex:
                if out._exemplars is None:
                    out._exemplars = [None] * len(out._counts)
                for i, pair in ex.items():
                    out._exemplars[i] = pair
        return out

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def value(self) -> float:
        """Mean observation (the scalar fed to MonitorMaster)."""
        return self._sum / self._count if self._count else 0.0

    def cumulative(self) -> List[Tuple[float, int]]:
        """[(le, cumulative_count), ...] ending with (+inf, count)."""
        with self._lock:
            counts = list(self._counts)
        out, acc = [], 0
        for le, c in zip(self.buckets, counts):
            acc += c
            out.append((le, acc))
        out.append((math.inf, acc + counts[-1]))
        return out


class MetricsRegistry:
    """Name-keyed get-or-create registry.

    ``enabled`` gates only the per-step feeds in the engine and the
    exporters; rare-event sites (retry loops, rendezvous) increment
    unconditionally — the cost is nanoseconds and the history is there
    the moment an operator turns export on.
    """

    def __init__(self):
        self.enabled = False
        self._lock = threading.Lock()
        self._metrics: Dict[str, Any] = {}
        self._collectors: Dict[str, Callable[[], None]] = {}

    # -- creation ----------------------------------------------------------
    def _get_or_create(self, cls, name: str, help: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help=help, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def get(self, name: str):
        return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()
            self._collectors.clear()

    # -- collectors --------------------------------------------------------
    def set_collector(self, name: str, fn: Callable[[], None]) -> None:
        """Register (or replace) a pre-export hook that refreshes derived
        gauges — keyed by name so re-built engines don't stack stale
        closures."""
        with self._lock:
            self._collectors[name] = fn

    def collect(self) -> None:
        with self._lock:
            fns = list(self._collectors.values())
        for fn in fns:
            try:
                fn()
            except Exception:   # a broken collector must not kill export
                pass

    # -- export ------------------------------------------------------------
    def to_events(self, step: int, prefix: str = "Metrics/"
                  ) -> List[Tuple[str, float, int]]:
        """MonitorMaster-shaped [(name, value, step), ...]."""
        with self._lock:
            metrics = sorted(self._metrics.items())
        return [(prefix + name, float(m.value), step)
                for name, m in metrics]

    def to_json(self) -> Dict[str, Any]:
        with self._lock:
            metrics = sorted(self._metrics.items())
        out: Dict[str, Any] = {}
        for name, m in metrics:
            if m.kind == "histogram":
                out[name] = {"kind": m.kind, "sum": m.sum,
                             "count": m.count, "mean": m.value,
                             "p50": m.quantile(0.50),
                             "p95": m.quantile(0.95),
                             "p99": m.quantile(0.99),
                             "buckets": [[le if le != math.inf else "+Inf",
                                          c] for le, c in m.cumulative()]}
                ex = m.exemplars()
                if ex:
                    bounds = m.buckets
                    out[name]["exemplars"] = {
                        ("+Inf" if i >= len(bounds)
                         else repr(float(bounds[i]))): {
                            "trace_id": tid, "value": v}
                        for i, (tid, v) in sorted(ex.items())}
            else:
                out[name] = {"kind": m.kind, "value": m.value}
        return out

    def export_json(self, path: str) -> str:
        self.collect()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.to_json(), f, indent=2)
        os.replace(tmp, path)
        return path

    def to_prometheus(self) -> str:
        with self._lock:
            metrics = sorted(self._metrics.items())
        lines: List[str] = []
        for name, m in metrics:
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            if m.kind == "histogram":
                ex = m.exemplars()
                for i, (le, c) in enumerate(m.cumulative()):
                    le_s = "+Inf" if le == math.inf else repr(float(le))
                    line = f'{name}_bucket{{le="{le_s}"}} {c}'
                    if i in ex:
                        # OpenMetrics exemplar: link the bucket to the
                        # request trace that landed in it most recently
                        tid, v = ex[i]
                        line += f' # {{trace_id="{tid}"}} {v!r}'
                    lines.append(line)
                lines.append(f"{name}_sum {m.sum!r}")
                lines.append(f"{name}_count {m.count}")
                # estimated quantiles (interpolated inside the bucket
                # bounds) as companion gauges — dashboards get p50/p95/
                # p99 without a histogram_quantile() recording rule
                for q, tag in ((0.50, "p50"), (0.95, "p95"), (0.99, "p99")):
                    lines.append(f"{name}_{tag} {m.quantile(q)!r}")
            else:
                lines.append(f"{name} {m.value!r}")
        return "\n".join(lines) + "\n"

    def export_prometheus(self, path: str) -> str:
        """Atomic write — the node_exporter textfile collector must never
        read a torn file."""
        self.collect()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(self.to_prometheus())
        os.replace(tmp, path)
        return path
