"""Tenant registry: who shares the serving engine, and on what terms.

Each tenant carries a fairness ``weight`` (its share of served tokens
under contention), a strict ``priority`` tier (higher admits first
regardless of counters — the latency tier above the fair pool), TTFT /
inter-token SLO targets (the frontend boosts a tenant whose oldest
waiting request is about to blow its TTFT target, and the per-tenant
histograms make attainment measurable), and a ``max_queue_share`` that
bounds how much of the bounded waiting queue one tenant may hog before
the shed policy picks ITS requests as overload victims.

Fairness is the virtual-token-counter scheme of "Fairness in Serving
Large Language Models" (Sheng et al., OSDI '24): every served token
charges its tenant ``1 / weight`` virtual tokens; admission prefers the
smallest counter; a tenant going idle->active lifts its counter to the
minimum of the active tenants, so idle time banks NO credit and a
returning tenant cannot starve the ones that kept the engine busy.

Copy of ``deepspeed_tpu/inference/serving/frontend/tenancy.py`` for
the PyTorch port (it imports no JAX).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Optional


@dataclass(frozen=True)
class TenantSpec:
    """Per-tenant serving terms (immutable — re-register to change)."""
    name: str
    #: weighted-fair share: under contention tenant i receives
    #: weight_i / sum(weights) of the served tokens (the VTC bound)
    weight: float = 1.0
    #: strict tier: higher-priority tenants admit before lower,
    #: regardless of virtual counters (use sparingly — priority
    #: bypasses fairness by design)
    priority: int = 0
    #: TTFT SLO target in seconds (0 = none): a tenant whose oldest
    #: waiting request has burned >70% of this budget is boosted to the
    #: front of its priority tier
    ttft_slo_s: float = 0.0
    #: inter-token SLO target in seconds (0 = none) — recorded next to
    #: the per-tenant histogram; advisory (decode pace is batch-wide)
    itl_slo_s: float = 0.0
    #: max fraction of the bounded waiting queue this tenant may hold
    #: before the shed policy victimizes it (0 = its fair weight share)
    max_queue_share: float = 0.0

    def __post_init__(self) -> None:
        if not isinstance(self.name, str) or not self.name:
            raise ValueError(
                f"tenant name must be a non-empty string, got "
                f"{self.name!r}")
        if self.weight <= 0:
            raise ValueError(
                f"tenant {self.name!r}: weight must be > 0, got "
                f"{self.weight}")
        if not 0 <= self.max_queue_share <= 1:
            raise ValueError(
                f"tenant {self.name!r}: max_queue_share must be in "
                f"[0, 1], got {self.max_queue_share}")
        if self.ttft_slo_s < 0 or self.itl_slo_s < 0:
            raise ValueError(
                f"tenant {self.name!r}: SLO targets must be >= 0")


class TenantRegistry:
    """Tenant specs + their live virtual-token counters.

    Unknown tenants resolve to the ``default`` spec (weight 1, no
    priority, no SLOs) so the frontend never rejects traffic for
    lacking a registration — fairness just treats it as one more
    unit-weight tenant.
    """

    def __init__(self, tenants: Iterable[TenantSpec] = ()) -> None:
        self._specs: Dict[str, TenantSpec] = {}
        #: virtual token counters (Sheng et al.): tokens / weight
        self.vtc: Dict[str, float] = {}
        self.register(TenantSpec("default"))
        for spec in tenants:
            self.register(spec)

    def register(self, spec: TenantSpec) -> TenantSpec:
        self._specs[spec.name] = spec
        self.vtc.setdefault(spec.name, 0.0)
        return spec

    def get(self, name: str) -> TenantSpec:
        spec = self._specs.get(name)
        if spec is None:
            spec = TenantSpec(name)
            self.register(spec)
        return spec

    def names(self):
        return list(self._specs)

    # -- virtual token counters ------------------------------------------
    def charge(self, name: str, tokens: float) -> None:
        """Serve-time charge: ``tokens / weight`` virtual tokens."""
        self.vtc[name] = self.vtc.get(name, 0.0) \
            + tokens / self.get(name).weight

    def lift(self, name: str, active: Iterable[str]) -> None:
        """Idle->active counter lift: entering tenant starts at the
        minimum counter of the currently active tenants (no banked
        credit from idle time)."""
        floor = min((self.vtc.get(t, 0.0) for t in active if t != name),
                    default=None)
        if floor is not None:
            self.vtc[name] = max(self.vtc.get(name, 0.0), floor)

    def fair_share(self, name: str, among: Optional[Iterable[str]] = None
                   ) -> float:
        """This tenant's weight fraction among ``among`` (default: all
        registered tenants)."""
        names = list(among) if among is not None else self.names()
        total = sum(self.get(t).weight for t in names) or 1.0
        return self.get(name).weight / total
