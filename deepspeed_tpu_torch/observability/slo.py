"""Per-tenant SLO burn-rate alerting over the serving latency streams.

Classic SRE multi-window burn-rate alerting (Beyer et al., *The Site
Reliability Workbook* ch. 5) applied to the per-tenant TTFT and
inter-token SLOs that ``TenantSpec`` already declares: an observation is
*bad* when its latency exceeds the tenant's target, the **burn rate** is
the bad fraction divided by the error budget (``1 - objective``), and an
alert needs BOTH a fast window (seconds — catches the breach while
requests are still in flight, long before enough terminals accumulate
for a p99 histogram to show it) and a slow window (minutes — immunity to
single-request blips) burning above threshold.

Alert state machine per ``(tenant, kind)`` with hysteresis::

    inactive -> pending   both windows burn >= threshold
    pending  -> firing    condition held for ``pending_s`` (0 = same eval)
    pending  -> inactive  condition dropped before firing (silent)
    firing   -> resolved  fast burn fell below threshold*resolve_fraction
    resolved -> inactive  (resolved is the notification edge)

Transitions to ``firing``/``resolved`` increment ``dstpu_slo_*``
counters/gauges and fan out to ``on_alert`` subscribers; the serving
front-end additionally biases its admission/shed policies while an
alert is firing (docs/serving.md, docs/observability.md).

Stdlib-only, never touches the device; the front-end feeds it from the
same iteration-boundary token events that feed the histograms, so
enabling it adds no host syncs to the hot path.

Copy of ``deepspeed_tpu/observability/slo.py`` for the PyTorch port (it
imports no JAX).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

#: alert kinds — one latency stream per TenantSpec SLO field
KIND_TTFT = "ttft"
KIND_ITL = "itl"


@dataclass
class SloAlert:
    """One alert transition, handed to ``on_alert`` subscribers."""
    tenant: str
    kind: str                 # "ttft" | "itl"
    state: str                # "pending" | "firing" | "resolved"
    burn_fast: float
    burn_slow: float
    target_s: float
    at: float                 # monitor clock at the transition


@dataclass
class _KeyState:
    events: Deque[Tuple[float, bool]] = field(default_factory=deque)
    state: str = "inactive"
    since: float = 0.0
    target_s: float = 0.0
    burn_fast: float = 0.0
    burn_slow: float = 0.0


class SloMonitor:
    """Multi-window burn-rate evaluator + alert state machine.

    ``objective`` is the fraction of observations that must meet the
    tenant's target (0.9 → a 10% error budget); ``burn_threshold`` is
    how many times faster than budget the error rate must run, in both
    windows, before an alert fires. ``time_fn`` is injectable so the
    window math is unit-testable with synthetic clocks.
    """

    def __init__(self, objective: float = 0.9,
                 fast_window_s: float = 30.0,
                 slow_window_s: float = 300.0,
                 burn_threshold: float = 2.0,
                 pending_s: float = 0.0,
                 resolve_fraction: float = 0.5,
                 min_samples: int = 5,
                 eval_interval_s: float = 0.0,
                 on_alert: Optional[Callable[[SloAlert], None]] = None,
                 registry: Any = None,
                 time_fn: Callable[[], float] = time.perf_counter):
        if not (0.0 < objective < 1.0):
            raise ValueError(f"objective must be in (0, 1), got {objective}")
        if fast_window_s <= 0 or slow_window_s < fast_window_s:
            raise ValueError("need 0 < fast_window_s <= slow_window_s")
        self.objective = float(objective)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.burn_threshold = float(burn_threshold)
        self.pending_s = float(pending_s)
        self.resolve_fraction = float(resolve_fraction)
        self.min_samples = int(min_samples)
        self.eval_interval_s = float(eval_interval_s)
        self.time_fn = time_fn
        self._keys: Dict[Tuple[str, str], _KeyState] = {}
        self._lock = threading.Lock()
        self._callbacks: List[Callable[[SloAlert], None]] = []
        if on_alert is not None:
            self._callbacks.append(on_alert)
        self._last_eval = -float("inf")
        if registry is None:
            from . import get_registry
            registry = get_registry()
        self._registry = registry
        self._m_alerts = registry.counter(
            "dstpu_slo_alerts_total",
            help="SLO burn-rate alerts that reached firing")
        self._m_resolved = registry.counter(
            "dstpu_slo_alerts_resolved_total",
            help="SLO burn-rate alerts that resolved after firing")
        self._m_firing = registry.gauge(
            "dstpu_slo_alerts_firing",
            help="SLO burn-rate alerts currently firing")
        self._m_evals = registry.counter(
            "dstpu_slo_evaluations_total",
            help="burn-rate evaluation passes")

    # -- subscriptions -----------------------------------------------------
    def subscribe(self, fn: Callable[[SloAlert], None]) -> None:
        self._callbacks.append(fn)

    # -- feeds -------------------------------------------------------------
    def observe(self, tenant: str, kind: str, latency_s: float,
                target_s: float, now: Optional[float] = None) -> None:
        """Record one latency observation against ``target_s``.

        ``target_s <= 0`` means the tenant declared no SLO for this kind
        — the observation is ignored entirely.
        """
        if target_s <= 0.0:
            return
        if now is None:
            now = self.time_fn()
        key = (tenant, kind)
        with self._lock:
            ks = self._keys.get(key)
            if ks is None:
                ks = self._keys[key] = _KeyState()
            ks.target_s = float(target_s)
            ks.events.append((now, latency_s > target_s))
        if now - self._last_eval >= self.eval_interval_s:
            self.evaluate(now)

    # -- evaluation --------------------------------------------------------
    def _window_burn(self, ks: _KeyState, now: float) -> Tuple[float, float,
                                                               int]:
        """(burn_fast, burn_slow, n_fast) over the pruned event deque."""
        horizon = now - self.slow_window_s
        ev = ks.events
        while ev and ev[0][0] < horizon:
            ev.popleft()
        fast_t0 = now - self.fast_window_s
        n_slow = len(ev)
        bad_slow = n_fast = bad_fast = 0
        for t, bad in ev:
            if bad:
                bad_slow += 1
            if t >= fast_t0:
                n_fast += 1
                if bad:
                    bad_fast += 1
        budget = 1.0 - self.objective
        burn_fast = (bad_fast / n_fast / budget) if n_fast else 0.0
        burn_slow = (bad_slow / n_slow / budget) if n_slow else 0.0
        return burn_fast, burn_slow, n_fast

    def evaluate(self, now: Optional[float] = None) -> List[SloAlert]:
        """Run the state machine; returns the transitions it emitted."""
        if now is None:
            now = self.time_fn()
        self._last_eval = now
        self._m_evals.inc()
        transitions: List[SloAlert] = []
        with self._lock:
            keys = list(self._keys.items())
        for (tenant, kind), ks in keys:
            with self._lock:
                burn_fast, burn_slow, n_fast = self._window_burn(ks, now)
                ks.burn_fast, ks.burn_slow = burn_fast, burn_slow
                cond = (n_fast >= self.min_samples
                        and burn_fast >= self.burn_threshold
                        and burn_slow >= self.burn_threshold)
                alert = None
                if ks.state == "inactive" and cond:
                    ks.state, ks.since = "pending", now
                if ks.state == "pending":
                    if not cond:
                        ks.state = "inactive"
                    elif now - ks.since >= self.pending_s:
                        ks.state = "firing"
                        alert = "firing"
                elif ks.state == "firing":
                    if burn_fast <= (self.burn_threshold
                                     * self.resolve_fraction):
                        ks.state = "inactive"
                        alert = "resolved"
                self._tenant_gauges(tenant, kind)[0].set(burn_fast)
                self._tenant_gauges(tenant, kind)[1].set(burn_slow)
            if alert is not None:
                transitions.append(SloAlert(
                    tenant=tenant, kind=kind, state=alert,
                    burn_fast=burn_fast, burn_slow=burn_slow,
                    target_s=ks.target_s, at=now))
        for tr in transitions:
            if tr.state == "firing":
                self._m_alerts.inc()
                self._tenant_counter(tr.tenant, tr.kind).inc()
            elif tr.state == "resolved":
                self._m_resolved.inc()
            for fn in list(self._callbacks):
                try:
                    fn(tr)
                except Exception:   # observers must never kill serving
                    pass
        self._m_firing.set(sum(
            1 for ks in self._keys.values() if ks.state == "firing"))
        return transitions

    # -- queries -----------------------------------------------------------
    def firing(self, tenant: str, kind: str) -> bool:
        ks = self._keys.get((tenant, kind))
        return ks is not None and ks.state == "firing"

    def series(self) -> List[Tuple[str, str]]:
        """Every (tenant, kind) observed so far, sorted."""
        with self._lock:
            return sorted(self._keys)

    def firing_any(self, tenant: str) -> bool:
        return (self.firing(tenant, KIND_TTFT)
                or self.firing(tenant, KIND_ITL))

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Host-side state dump (flight-recorder / bench friendly)."""
        out: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            for (tenant, kind), ks in self._keys.items():
                out[f"{tenant}/{kind}"] = {
                    "state": ks.state, "burn_fast": round(ks.burn_fast, 4),
                    "burn_slow": round(ks.burn_slow, 4),
                    "target_s": ks.target_s, "samples": len(ks.events)}
        return out

    # -- per-tenant series -------------------------------------------------
    def _series(self, tenant: str, kind: str) -> str:
        from .metrics import tenant_metric_name
        return tenant_metric_name("dstpu_slo_tenant", tenant, kind)

    def _tenant_gauges(self, tenant: str, kind: str):
        base = self._series(tenant, kind)
        return (self._registry.gauge(f"{base}_burn_fast"),
                self._registry.gauge(f"{base}_burn_slow"))

    def _tenant_counter(self, tenant: str, kind: str):
        return self._registry.counter(f"{self._series(tenant, kind)}"
                                      f"_alerts_total")


#: defaults applied by ``observability.configure`` (SloConfig block);
#: ``SloMonitor.from_defaults()`` returns None while disabled so callers
#: holding the result pay one ``is None`` check and nothing else
_defaults: Dict[str, Any] = {"enabled": False}


def set_defaults(**kw: Any) -> None:
    _defaults.clear()
    _defaults.update(kw)


def from_defaults(**overrides: Any) -> Optional[SloMonitor]:
    """Build an ``SloMonitor`` from the configured ``observability.slo``
    block, or None when the block is disabled."""
    if not _defaults.get("enabled"):
        return None
    kw = {k: v for k, v in _defaults.items() if k != "enabled"}
    kw.update(overrides)
    return SloMonitor(**kw)
