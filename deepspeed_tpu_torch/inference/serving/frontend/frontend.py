"""SLO-grade multi-tenant front-end over the serving engine.

:class:`ServingFrontend` wires a :class:`TenantRegistry` into the
scheduler's policy hooks and the engine's token stream (docs/serving.md
"Sampling, streaming & multi-tenant SLOs"):

  * **admission** — waiting requests order by (priority tier desc,
    TTFT-at-risk, virtual token counter asc, submit time): the
    weighted-fair VTC queue of Sheng et al. (OSDI '24), with a strict
    priority bypass and a boost for requests about to blow their
    tenant's TTFT target;
  * **prefill budget** — among prefilling slots, the tenant with the
    smallest counter gets the next chunk of the per-iteration budget,
    so a burst of long prompts from one tenant cannot monopolize TTFT
    for everyone else;
  * **shed** — under a full bounded queue, the overload victim is the
    newest waiting request of the tenant FURTHEST over its queue share,
    not blindly the incoming request;
  * **accounting** — every served token charges its tenant
    ``tokens / weight`` virtual tokens (the first token also carries
    the prompt's prefill cost), and per-tenant
    ``dstpu_serving_tenant_*`` counters/histograms make fairness and
    SLO attainment observable per tenant.

The frontend is optional composition: without one installed the
scheduler keeps its deterministic FCFS behavior byte-for-byte.

On a serving mesh the two inputs that read a clock, a request's
TTFT-at-risk age and the SLO monitor's firing alerts (fed by each
rank's own latencies), are rank 0's: the frontend proposes them at
every iteration boundary through the engine's ``lockstep_hooks`` and
reads the agreed ones, so every rank orders and sheds alike.

Copy of ``deepspeed_tpu/inference/serving/frontend/frontend.py`` for
the PyTorch port, over the port's serving engine and observability
package.
"""
from __future__ import annotations

import time
from typing import Deque, Dict, List, Optional, Tuple

from ....observability import get_registry
from ....observability.metrics import tenant_metric_name
from ....observability.slo import KIND_ITL, KIND_TTFT, SloMonitor
from ....observability.slo import from_defaults as _slo_from_defaults
from ..scheduler import Request, RequestStatus
from .tenancy import TenantRegistry, TenantSpec

#: a tenant whose oldest waiting request has burned more than this
#: fraction of its TTFT SLO budget is boosted within its priority tier
TTFT_RISK_FRACTION = 0.7


class ServingFrontend:
    """Install multi-tenant fairness + SLO accounting on a
    :class:`~..engine.ServingEngine`.

    >>> fe = ServingFrontend(srv)
    >>> fe.register(TenantSpec("batch", weight=1.0))
    >>> fe.register(TenantSpec("interactive", weight=4.0,
    ...                        ttft_slo_s=0.5))
    >>> req = fe.submit(prompt, tenant="interactive",
    ...                 on_token=collector)
    """

    #: rank 0's late requests (by id) and firing (tenant, kind) pairs of
    #: the current iteration on a serving mesh; None at 1 x 1, where
    #: this process's clock decides
    _agreed: Optional[Dict[str, object]] = None

    def __init__(self, srv,
                 registry: Optional[TenantRegistry] = None,
                 slo: object = "auto") -> None:
        self.srv = srv
        self.tenants = registry if registry is not None \
            else TenantRegistry()
        self._metrics: Dict[str, Dict[str, object]] = {}
        #: per-tenant SLO burn-rate monitor (observability/slo.py):
        #: "auto" builds from the observability config's ``slo`` block
        #: (None when the block is off), or pass an SloMonitor / None
        self.slo: Optional[SloMonitor] = \
            _slo_from_defaults() if slo == "auto" else slo
        srv.scheduler.admission_policy = self._order_admissions
        srv.scheduler.prefill_policy = self._order_prefills
        srv.scheduler.shed_policy = self._pick_shed_victim
        srv.token_hooks.append(self._on_token)
        srv.lifecycle_hooks.append(self._on_terminal)
        hooks = getattr(srv, "lockstep_hooks", None)
        if hooks is not None and srv.lockstep.active:
            hooks["frontend"] = (self._propose, self._apply)

    # -- tenant management -------------------------------------------------
    def register(self, spec: TenantSpec) -> TenantSpec:
        return self.tenants.register(spec)

    def submit(self, prompt, tenant: str = "default", **kw) -> Request:
        """Submit on behalf of ``tenant`` (defaults applied as in
        :meth:`ServingEngine.submit`).  An idle->active tenant's
        counter is lifted to the active minimum FIRST, so idle time
        banks no fairness credit (Sheng et al.)."""
        active = self._active_tenants()
        if tenant not in active:
            self.tenants.lift(tenant, active)
        return self.srv.submit(prompt, tenant=tenant, **kw)

    def _active_tenants(self) -> List[str]:
        # sorted, not list: the active-tenant order feeds the fair-share
        # scheduler's tie-breaks, and set order varies per process
        sched = self.srv.scheduler
        return sorted({r.tenant for r in sched.waiting}
                      | {r.tenant for r in sched.running.values()})

    # -- the serving mesh's agreed inputs --------------------------------
    def _late(self, req: Request, now: float) -> bool:
        """The request has burned ``TTFT_RISK_FRACTION`` of its tenant's
        TTFT target waiting."""
        spec = self.tenants.get(req.tenant)
        return (spec.ttft_slo_s > 0 and now - req.submit_time
                > TTFT_RISK_FRACTION * spec.ttft_slo_s)

    def _propose(self, now: float) -> Dict[str, list]:
        """Rank 0: the live requests (by index) that are late at ``now``
        and every firing (tenant, kind) alert."""
        slo = self.slo
        return {"late": [i for i, r in enumerate(self.srv.scheduler.live())
                         if self._late(r, now)],
                "firing": [] if slo is None else sorted(
                    [t, k] for t, k in slo.series()
                    if slo.firing(t, k))}

    def _apply(self, decision: Dict[str, list], live: list) -> None:
        self._agreed = {
            "late": {id(live[i]): live[i] for i in decision["late"]},
            "firing": {(t, k) for t, k in decision["firing"]}}

    def _is_late(self, req: Request, now: float) -> bool:
        if self._agreed is None:
            return self._late(req, now)
        return self._agreed["late"].get(id(req)) is req

    def _firing(self, tenant: str, kind: str) -> bool:
        if self.slo is None:
            return False
        if self._agreed is None:
            return self.slo.firing(tenant, kind)
        return (tenant, kind) in self._agreed["firing"]

    def _firing_any(self, tenant: str) -> bool:
        return (self._firing(tenant, KIND_TTFT)
                or self._firing(tenant, KIND_ITL))

    # -- scheduler policies ------------------------------------------------
    def _order_admissions(self, waiting: Deque[Request]) -> None:
        now = time.perf_counter()

        def key(req: Request):
            spec = self.tenants.get(req.tenant)
            # a firing TTFT burn-rate alert marks the WHOLE tenant
            # at-risk: its error budget is already burning faster than
            # sustainable, so every queued request boosts within the
            # tier, not just the ones individually near the deadline
            at_risk = int(self._is_late(req, now)
                          or self._firing(req.tenant, KIND_TTFT))
            return (-spec.priority, -at_risk,
                    self.tenants.vtc.get(req.tenant, 0.0),
                    req.submit_time)

        ordered = sorted(waiting, key=key)      # stable: FCFS per tenant
        waiting.clear()
        waiting.extend(ordered)

    def _order_prefills(self, prefilling: List[Tuple[int, Request]]
                        ) -> List[Tuple[int, Request]]:
        def key(item: Tuple[int, Request]):
            _slot, req = item
            spec = self.tenants.get(req.tenant)
            return (-spec.priority,
                    self.tenants.vtc.get(req.tenant, 0.0),
                    req.submit_time)

        return sorted(prefilling, key=key)

    def _pick_shed_victim(self, incoming: Request,
                          waiting: List[Request]) -> Optional[Request]:
        """Overload victim: the NEWEST waiting request of the tenant
        furthest over its queue-share cap (``max_queue_share``, or its
        fair weight share).  Returns None — shed the incoming — when no
        tenant is over cap, when the worst offender IS the incoming
        tenant, or when the offender outranks the incoming tenant's
        priority tier."""
        if not waiting:
            return None
        counts: Dict[str, int] = {}
        for r in waiting:
            counts[r.tenant] = counts.get(r.tenant, 0) + 1
        present = list(counts) + ([incoming.tenant]
                                  if incoming.tenant not in counts
                                  else [])
        total = len(waiting)
        slo = self.slo
        over_cap: List[Tuple[float, str]] = []
        for t, n in counts.items():
            spec = self.tenants.get(t)
            cap = spec.max_queue_share or \
                self.tenants.fair_share(t, among=present)
            over = n / total - cap
            if over > 0.0:
                over_cap.append((over, t))
        # a tenant with a firing SLO alert is already losing — don't
        # pile shedding on top of it when another over-cap tenant can
        # absorb the overload instead (all-firing falls through)
        if slo is not None and over_cap:
            calm = [(o, t) for o, t in over_cap
                    if not self._firing_any(t)]
            if calm:
                over_cap = calm
        worst, worst_over = None, 0.0
        for over, t in over_cap:
            if over > worst_over:
                worst, worst_over = t, over
        if worst is None or worst == incoming.tenant:
            return None
        if self.tenants.get(worst).priority \
                > self.tenants.get(incoming.tenant).priority:
            return None
        for r in reversed(waiting):
            if r.tenant == worst:
                return r
        return None

    # -- accounting hooks --------------------------------------------------
    def _tenant_metrics(self, name: str) -> Dict[str, object]:
        tm = self._metrics.get(name)
        if tm is None:
            # tenant names are caller-supplied: tenant_metric_name
            # sanitizes AND disambiguates (crc suffix) so two hostile
            # names can't collide into one series or smuggle newlines
            # into the Prometheus textfile
            reg = get_registry()
            base = tenant_metric_name("dstpu_serving_tenant", name)
            tm = {
                "tokens": reg.counter(f"{base}_tokens_total"),
                "ttft": reg.histogram(f"{base}_ttft_seconds"),
                "itl": reg.histogram(f"{base}_inter_token_seconds"),
                "shed": reg.counter(f"{base}_shed_total"),
                "timed_out": reg.counter(f"{base}_timed_out_total"),
                "vtc": reg.gauge(f"{base}_vtc"),
            }
            self._metrics[name] = tm
        return tm

    def _on_token(self, ev) -> None:
        if ev.token is None:
            return
        tm = self._tenant_metrics(ev.tenant)
        # the first token carries the prompt's prefill cost: fairness
        # must see prefill compute, or long-prompt tenants ride free
        cost = len(ev.request.prompt) + 1 if ev.index == 0 else 1
        self.tenants.charge(ev.tenant, cost)
        tm["vtc"].set(self.tenants.vtc[ev.tenant])
        tm["tokens"].inc()
        exemplar = getattr(ev.request, "trace_id", None)
        spec = self.tenants.get(ev.tenant)
        slo = self.slo
        if ev.index == 0:
            ttft = ev.time_s - ev.request.submit_time
            tm["ttft"].observe(ttft, exemplar=exemplar)
            if slo is not None:
                slo.observe(ev.tenant, KIND_TTFT, ttft,
                            spec.ttft_slo_s)
        elif ev.prev_time_s is not None:
            itl = ev.time_s - ev.prev_time_s
            tm["itl"].observe(itl, exemplar=exemplar)
            if slo is not None:
                slo.observe(ev.tenant, KIND_ITL, itl, spec.itl_slo_s)

    def _on_terminal(self, req: Request) -> None:
        tm = self._tenant_metrics(req.tenant)
        if req.status is RequestStatus.SHED:
            tm["shed"].inc()
        elif req.status is RequestStatus.TIMED_OUT:
            tm["timed_out"].inc()
