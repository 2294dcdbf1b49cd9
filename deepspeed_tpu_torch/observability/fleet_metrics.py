"""Fleet metrics aggregation: one merged view over per-replica registries.

Copy of ``deepspeed_tpu/observability/fleet_metrics.py`` for the PyTorch
port.  Without it an autoscaler would steer by poking each replica
handle for its queue depth, and dashboards would see whichever replica
wrote a shared gauge last.  This module gives the fleet ONE metrics
surface:

  - replicas contribute **snapshots** in the ``MetricsRegistry.to_json``
    shape (``add_snapshot``), or the aggregator refreshes itself from a
    live router (``observe_router``, which asks each ``ReplicaHandle``
    for ``metrics_snapshot()``);
  - **counters** are summed across replicas;
  - **gauges** keep a per-replica labeled series AND per-class ("role")
    rollups, plus the fleet sum;
  - **histograms** are merged **bucket-wise** — per-bucket counts are
    summed and the fleet p50/p95/p99 interpolated from the MERGED
    buckets (``interpolate_quantile``), never by averaging per-replica
    quantiles (a p99 is not a mean; averaging quantiles is statistically
    meaningless the moment replicas see different load);
  - exports mirror the per-process registry: an atomic Prometheus
    textfile (``{replica=...}`` / ``{fleet_class=...}`` labels) and a
    JSON snapshot.

The autoscaler reads ``class_queue_depth`` / ``class_replicas`` /
``burn_rate`` from here instead of touching replicas ad hoc, so policy
and dashboards see the same numbers. Stdlib-only; export-time code.
"""
from __future__ import annotations

import json
import math
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

from .metrics import decumulate, interpolate_quantile

#: gauge consulted for per-class queue depth rollups
QUEUE_DEPTH_GAUGE = "dstpu_serving_queue_depth"

#: gauge marking a replica routable (1) — the ``healthy_only`` filters
#: below skip replicas whose snapshot carries it at 0
UP_GAUGE = "dstpu_fleet_replica_up"

_SLO_BURN_PREFIX = "dstpu_slo_tenant_"


def _replica_up(r: Any) -> bool:
    """Routable-ness of a duck-typed replica handle: a real
    ``ReplicaHandle`` exposes ``state`` (HEALTHY = routable), policy-test
    stubs may expose only ``healthy``; absent both, assume up."""
    state = getattr(r, "state", None)
    if state is not None:
        return str(getattr(state, "value", state)) == "healthy"
    return bool(getattr(r, "healthy", True))


def _is_hist(entry: Dict[str, Any]) -> bool:
    return entry.get("kind") == "histogram"


def hist_snapshot(h: Any) -> Dict[str, Any]:
    """One live ``Histogram`` as a ``to_json()``-shaped entry — what a
    replica contributes to the aggregator for bucket-wise merging."""
    return {"kind": "histogram", "sum": h.sum, "count": h.count,
            "buckets": [[le if le != math.inf else "+Inf", c]
                        for le, c in h.cumulative()]}


class FleetMetricsAggregator:
    """Merge per-replica registry snapshots into a fleet-level view."""

    def __init__(self, fleet_id: str = "fleet"):
        self.fleet_id = fleet_id
        self._lock = threading.Lock()
        self._snapshots: Dict[str, Dict[str, Any]] = {}
        self._roles: Dict[str, str] = {}

    # -- intake ------------------------------------------------------------
    def add_snapshot(self, replica_id: str, snapshot: Dict[str, Any],
                     role: str = "mixed") -> None:
        """Register/replace one replica's ``to_json()``-shaped snapshot."""
        with self._lock:
            self._snapshots[str(replica_id)] = dict(snapshot)
            self._roles[str(replica_id)] = str(role)

    def observe_router(self, router: Any) -> int:
        """Refresh snapshots from a live fleet router's replica handles.

        Defensive by design: policy tests drive the autoscaler with stub
        routers, so any handle lacking ``metrics_snapshot`` contributes
        a minimal gauge-only snapshot built from the attributes every
        stub already has (``queue_depth``, ``state``/``healthy``).
        Replaces the previous observation wholesale — a replica the
        router no longer lists vanishes from the fleet view instead of
        contributing a stale snapshot forever. Returns the number of
        replicas observed.
        """
        fresh: Dict[str, Dict[str, Any]] = {}
        fresh_roles: Dict[str, str] = {}
        seen = 0
        for r in list(getattr(router, "replicas", []) or []):
            rid = str(getattr(r, "replica_id", f"replica{seen}"))
            role = str(getattr(r, "role", "mixed"))
            snap_fn = getattr(r, "metrics_snapshot", None)
            if callable(snap_fn):
                try:
                    snap = snap_fn()
                except Exception:
                    continue
            else:
                snap = {
                    QUEUE_DEPTH_GAUGE: {
                        "kind": "gauge",
                        "value": float(getattr(r, "queue_depth", 0) or 0)},
                    UP_GAUGE: {
                        "kind": "gauge",
                        "value": 1.0 if _replica_up(r) else 0.0},
                }
            fresh[rid] = dict(snap)
            fresh_roles[rid] = role
            seen += 1
        with self._lock:
            self._snapshots = fresh
            self._roles = fresh_roles
        return seen

    def clear(self) -> None:
        with self._lock:
            self._snapshots.clear()
            self._roles.clear()

    @property
    def replica_ids(self) -> List[str]:
        with self._lock:
            return sorted(self._snapshots)

    # -- merge core --------------------------------------------------------
    def _cut(self) -> Tuple[Dict[str, Dict[str, Any]], Dict[str, str]]:
        with self._lock:
            return ({rid: snap for rid, snap in self._snapshots.items()},
                    dict(self._roles))

    @staticmethod
    def _merge_hist(name: str, entries: List[Dict[str, Any]]
                    ) -> Dict[str, Any]:
        """Bucket-wise merge of ``to_json()`` histogram entries."""
        bounds: Optional[Tuple[float, ...]] = None
        counts: List[int] = []
        total_sum, total_count = 0.0, 0
        for entry in entries:
            b, c = decumulate(entry.get("buckets", []))
            if bounds is None:
                bounds, counts = b, list(c)
            elif b != bounds:
                raise ValueError(
                    f"cannot merge histogram {name!r}: replica bucket "
                    f"bounds differ ({b} vs {bounds})")
            else:
                for i, n in enumerate(c):
                    counts[i] += n
            total_sum += float(entry.get("sum", 0.0))
            total_count += int(entry.get("count", 0))
        bounds = bounds or ()
        out: Dict[str, Any] = {
            "kind": "histogram", "sum": total_sum, "count": total_count,
            "mean": total_sum / total_count if total_count else 0.0}
        if bounds:
            out["p50"] = interpolate_quantile(bounds, counts, 0.50)
            out["p95"] = interpolate_quantile(bounds, counts, 0.95)
            out["p99"] = interpolate_quantile(bounds, counts, 0.99)
            cum, acc = [], 0
            for le, c in zip(bounds, counts[:-1]):
                acc += c
                cum.append([le, acc])
            cum.append(["+Inf", acc + counts[-1]])
            out["buckets"] = cum
        else:
            out["p50"] = out["p95"] = out["p99"] = 0.0
            out["buckets"] = []
        return out

    def merged(self) -> Dict[str, Any]:
        """The fleet snapshot: same shape as ``MetricsRegistry.to_json``
        plus per-replica / per-class breakdowns on scalar entries."""
        snaps, roles = self._cut()
        names: Dict[str, str] = {}
        for snap in snaps.values():
            for name, entry in snap.items():
                names.setdefault(name, entry.get("kind", "gauge"))
        out: Dict[str, Any] = {}
        for name in sorted(names):
            kind = names[name]
            entries = [(rid, snap[name]) for rid, snap in sorted(
                snaps.items()) if name in snap]
            if kind == "histogram":
                out[name] = self._merge_hist(
                    name, [e for _rid, e in entries if _is_hist(e)])
                continue
            per_replica = {rid: float(e.get("value", 0.0))
                           for rid, e in entries}
            per_class: Dict[str, float] = {}
            for rid, v in per_replica.items():
                role = roles.get(rid, "mixed")
                per_class[role] = per_class.get(role, 0.0) + v
            out[name] = {"kind": kind,
                         "value": sum(per_replica.values()),
                         "replicas": per_replica,
                         "classes": per_class}
        return out

    # -- autoscaler feeds --------------------------------------------------
    @staticmethod
    def _snap_up(snap: Dict[str, Any]) -> bool:
        entry = snap.get(UP_GAUGE)
        if entry is None:
            return True
        return float(entry.get("value", 1.0)) > 0.0

    def class_queue_depth(self, role: Optional[str] = None,
                          healthy_only: bool = False) -> float:
        """Total queued requests for one replica class (or the fleet);
        ``healthy_only`` counts routable replicas only — the
        autoscaler's view, matching its healthy-replica policy."""
        snaps, roles = self._cut()
        total = 0.0
        for rid, snap in snaps.items():
            if role is not None and roles.get(rid, "mixed") != role:
                continue
            if healthy_only and not self._snap_up(snap):
                continue
            entry = snap.get(QUEUE_DEPTH_GAUGE)
            if entry is not None:
                total += float(entry.get("value", 0.0))
        return total

    def class_replicas(self, role: Optional[str] = None,
                       healthy_only: bool = False) -> int:
        """Replicas currently contributing snapshots for a class."""
        snaps, roles = self._cut()
        return sum(
            1 for rid in snaps
            if (role is None or roles.get(rid, "mixed") == role)
            and (not healthy_only or self._snap_up(snaps[rid])))

    def burn_rate(self, kind: str = "ttft", which: str = "fast") -> float:
        """Worst per-tenant SLO burn rate across the fleet for ``kind``
        (max over tenants and replicas of the ``…_burn_fast`` /
        ``…_burn_slow`` gauges the SLO monitor exports)."""
        suffix = f"_{kind}_burn_{which}"
        snaps, _roles = self._cut()
        worst = 0.0
        for snap in snaps.values():
            for name, entry in snap.items():
                if name.startswith(_SLO_BURN_PREFIX) and \
                        name.endswith(suffix):
                    worst = max(worst, float(entry.get("value", 0.0)))
        return worst

    # -- export ------------------------------------------------------------
    def to_json(self) -> Dict[str, Any]:
        return {"fleet_id": self.fleet_id,
                "replicas": {rid: self._roles.get(rid, "mixed")
                             for rid in self.replica_ids},
                "metrics": self.merged()}

    def to_prometheus(self) -> str:
        """Fleet textfile: labeled per-replica and per-class series plus
        the fleet rollup; histogram lines come from the MERGED buckets."""
        merged = self.merged()
        lines: List[str] = []
        for name, entry in merged.items():
            kind = entry.get("kind", "gauge")
            lines.append(f"# TYPE {name} {kind}")
            if kind == "histogram":
                for le, cum in entry.get("buckets", []):
                    le_s = "+Inf" if le in ("+Inf", math.inf) \
                        else repr(float(le))
                    lines.append(f'{name}_bucket{{le="{le_s}"}} {cum}')
                lines.append(f"{name}_sum {entry['sum']!r}")
                lines.append(f"{name}_count {entry['count']}")
                for tag in ("p50", "p95", "p99"):
                    lines.append(f"{name}_{tag} {entry[tag]!r}")
                continue
            for rid, v in sorted(entry.get("replicas", {}).items()):
                lines.append(f'{name}{{replica="{rid}"}} {v!r}')
            for role, v in sorted(entry.get("classes", {}).items()):
                lines.append(f'{name}{{fleet_class="{role}"}} {v!r}')
            lines.append(f"{name} {entry['value']!r}")
        return "\n".join(lines) + "\n"

    def export_json(self, path: str) -> str:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.to_json(), f, indent=2)
        os.replace(tmp, path)
        return path

    def export_prometheus(self, path: str) -> str:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(self.to_prometheus())
        os.replace(tmp, path)
        return path
