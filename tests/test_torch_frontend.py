"""The port's multi-tenant serving front end and token streaming: the
cases of the JAX package's ``tests/unit/test_frontend.py`` on the port,
and parity with the JAX front end on one scripted workload.

The engine is the JAX suite's (GPT-2 shaped, 2 layers, d_model 32, 4
heads, vocab 64, 4 slots, 64 blocks of 8, chunk 16) in float32, with
random weights from a seeded ``torch.Generator`` times ``SPREAD`` (so
that greedy streams move between tokens).  Greedy streams equal
``generate()``, seeded sampled streams equal seeded ``generate()``,
streams end with their terminal event and a raising callback turns off
only its own stream; the weighted-fair admission, the starvation bound,
the shed policy and the SLO hooks behave as in JAX.  The JAX front end
(its paged kernels through the package's plain references) and the
port's, driven by one submit/step script with a bounded queue, shed the
same requests and admit in the same order.  No ``decode_builds`` is
pinned: the port compiles nothing.
"""
import re
import time
from collections import deque
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dt
from deepspeed_tpu.inference.serving import ServingFrontend as JaxFrontend
from deepspeed_tpu.inference.serving import TenantSpec as JaxTenantSpec
from deepspeed_tpu.models import transformer as jax_tf
from deepspeed_tpu.ops.transformer import paged_decode_attention as jax_pa
from deepspeed_tpu_torch.inference.serving import (Request, RequestStatus,
                                                   ServingFrontend,
                                                   StreamCollector,
                                                   TenantRegistry,
                                                   TenantSpec)
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.convert import params_to_jax
from deepspeed_tpu_torch.observability.metrics import MetricsRegistry
from deepspeed_tpu_torch.observability.slo import (KIND_ITL, KIND_TTFT,
                                                   SloMonitor)

TINY = dict(num_layers=2, d_model=32, num_heads=4, vocab_size=64,
            max_seq_len=128)
SPREAD = 12.0
SERVING = {"enabled": True, "kv_block_size": 8, "num_kv_blocks": 64,
           "max_batch_slots": 4, "prefill_chunk_tokens": 16}
BASE = {"dtype": "float32", "max_out_tokens": 128, "temperature": 0.0}
PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [11, 12, 13, 14, 15, 16, 17]]


def spread(tree):
    if isinstance(tree, dict):
        return {k: spread(v) for k, v in tree.items()}
    return tree * SPREAD if tree.dim() >= 2 and tree.shape[-1] > 1 else tree


@pytest.fixture(scope="module")
def params():
    g = torch.Generator()
    g.manual_seed(11)
    pm = tt.TransformerLM(tt.gpt2_config("125m", dtype=torch.float32, **TINY))
    return spread(pm.init(g, "cpu", torch.float32))


def build_engine(params, serving=None):
    pm = tt.TransformerLM(tt.gpt2_config("125m", dtype=torch.float32, **TINY))
    return dt.init_inference(pm, {**BASE, "serving": {**SERVING,
                                                      **(serving or {})}},
                             params=params, device="cpu")


@pytest.fixture(scope="module")
def shared(params):
    """One engine + front end shared by the single-engine tests."""
    eng = build_engine(params)
    srv = eng.serving_engine()
    fe = ServingFrontend(srv)
    return eng, srv, fe


# ---------------------------------------------------------------------------
# sampling + streaming
# ---------------------------------------------------------------------------
def test_greedy_stream_matches_generate(shared):
    eng, srv, _fe = shared
    cols = [StreamCollector() for _ in PROMPTS]
    reqs = [srv.submit(p, max_new_tokens=8, on_token=c)
            for p, c in zip(PROMPTS, cols)]
    srv.run()
    for p, r, c in zip(PROMPTS, reqs, cols):
        gen = eng.generate([p], max_new_tokens=8, temperature=0.0)[0]
        assert r.status is RequestStatus.OK
        assert r.output == gen.tolist()
        assert c.tokens == r.output and c.finished
        assert c.events[-1].status is RequestStatus.OK
        assert [e.index for e in c.events] == list(range(8))
    assert len({tuple(r.output) for r in reqs}) > 1


def test_mixed_seeded_sampling_matches_generate(shared):
    """Greedy, temperature + top-k and nucleus requests in one batch:
    each stream equals its seeded ``generate()`` twin."""
    eng, srv, _fe = shared
    samp = [dict(temperature=0.0, top_k=0, top_p=1.0),
            dict(temperature=0.9, top_k=16, top_p=1.0),
            dict(temperature=0.7, top_k=0, top_p=0.9)]
    reqs = [srv.submit(p, max_new_tokens=8, seed=100 + i, **samp[i])
            for i, p in enumerate(PROMPTS)]
    srv.run()
    for i, (p, r) in enumerate(zip(PROMPTS, reqs)):
        gen = eng.generate([p], max_new_tokens=8, seed=100 + i, **samp[i])
        assert r.output == gen[0].tolist(), (i, r.output)


def test_terminal_events_and_callback_isolation(shared):
    eng, srv, _fe = shared
    dead_col = StreamCollector()
    dead = srv.submit(PROMPTS[0], max_new_tokens=8, deadline_s=1.0,
                      on_token=dead_col)
    dead.submit_time -= 50.0

    class Boom:
        def __init__(self):
            self.seen = []

        def __call__(self, ev):
            if len(self.seen) == 2:
                raise RuntimeError("consumer bug")
            self.seen.append(ev.token)

    boom = Boom()
    noisy = srv.submit(PROMPTS[1], max_new_tokens=8, on_token=boom)
    srv.run()
    assert dead.status is RequestStatus.TIMED_OUT
    assert dead_col.tokens == [] and dead_col.finished
    assert dead_col.events[-1].token is None
    assert dead_col.events[-1].status is RequestStatus.TIMED_OUT
    assert noisy.status is RequestStatus.OK and len(noisy.output) == 8
    assert boom.seen == noisy.output[:2], "stream died at the raise"
    assert noisy.on_token is None, "broken callback must be disabled"
    gen = eng.generate([PROMPTS[1]], max_new_tokens=8, temperature=0.0)
    assert noisy.output == gen[0].tolist()


# ---------------------------------------------------------------------------
# weighted-fair multi-tenancy
# ---------------------------------------------------------------------------
def test_vtc_unit_math():
    reg = TenantRegistry([TenantSpec("a", weight=1.0),
                          TenantSpec("b", weight=4.0)])
    reg.charge("a", 10)
    reg.charge("b", 10)
    assert reg.vtc["a"] == pytest.approx(10.0)
    assert reg.vtc["b"] == pytest.approx(2.5)
    reg.lift("c", ["a", "b", "c"])
    assert reg.vtc["c"] == pytest.approx(2.5)
    assert reg.fair_share("b", ["a", "b"]) == pytest.approx(0.8)
    with pytest.raises(ValueError):
        TenantSpec("bad", weight=0.0)
    with pytest.raises(ValueError):
        TenantSpec("bad", max_queue_share=1.5)


def _policy_frontend(tenants, slo=None):
    fe = ServingFrontend.__new__(ServingFrontend)
    fe.tenants = TenantRegistry(tenants)
    fe.slo = slo
    fe._metrics = {}
    return fe


def test_admission_order_priority_risk_vtc():
    fe = _policy_frontend([
        TenantSpec("hog", weight=1.0), TenantSpec("fair", weight=1.0),
        TenantSpec("slo", weight=1.0, ttft_slo_s=10.0),
        TenantSpec("vip", weight=1.0, priority=5)])
    fe.tenants.vtc.update({"hog": 100.0, "fair": 1.0, "slo": 50.0})
    now = time.perf_counter()

    def mk(tenant, age=0.0):
        r = Request(prompt=[1], max_new_tokens=1, tenant=tenant)
        r.submit_time = now - age
        return r

    hog, fair = mk("hog"), mk("fair")
    at_risk, calm, vip = mk("slo", age=9.0), mk("slo", age=1.0), mk("vip")
    q = deque([hog, calm, fair, at_risk, vip])
    fe._order_admissions(q)
    assert list(q) == [vip, at_risk, fair, calm, hog]


def test_fair_queue_starvation_bound(shared):
    """A hog floods the queue, then a premium tenant (4x weight)
    submits: every premium request beats the hog's tail to its first
    token."""
    eng, srv, fe = shared
    fe.register(TenantSpec("hog", weight=1.0))
    fe.register(TenantSpec("premium", weight=4.0))
    order = []
    hook = lambda ev: order.append(ev.request) \
        if ev.index == 0 and ev.token is not None else None
    srv.token_hooks.append(hook)
    try:
        hogs = [fe.submit([3 + i, 4, 5], tenant="hog", max_new_tokens=6)
                for i in range(6)]
        srv.step()
        prem = [fe.submit([40 + i, 2], tenant="premium",
                          max_new_tokens=6) for i in range(2)]
        srv.run()
    finally:
        srv.token_hooks.remove(hook)
    assert all(r.status is RequestStatus.OK for r in hogs + prem)
    first_tok = {id(r): i for i, r in enumerate(order)}
    worst_hog = max(first_tok[id(r)] for r in hogs)
    for r in prem:
        assert first_tok[id(r)] < worst_hog


def test_shed_policy_victimizes_queue_hog(shared):
    eng, srv, fe = shared
    fe.register(TenantSpec("hog", weight=1.0))
    fe.register(TenantSpec("premium", weight=4.0))
    running = [fe.submit([9, 9, 9 + i], tenant="hog", max_new_tokens=4)
               for i in range(4)]
    srv.step()
    srv.scheduler.max_queue_depth = 2
    try:
        waiting = [fe.submit([9, 9, 20 + i], tenant="hog",
                             max_new_tokens=4) for i in range(2)]
        assert all(r.status is None for r in waiting)
        prem = fe.submit([50, 51], tenant="premium", max_new_tokens=4)
        assert prem.status is None
        assert waiting[-1].status is RequestStatus.SHED
        assert waiting[-1].retry_after_s is not None
        assert waiting[0].status is None
    finally:
        srv.scheduler.max_queue_depth = 0
    srv.run()
    assert prem.status is RequestStatus.OK
    assert all(r.status is RequestStatus.OK for r in running + waiting[:1])


# ---------------------------------------------------------------------------
# SLO burn-rate alerts
# ---------------------------------------------------------------------------
def _firing_monitor(tenant, kind=KIND_TTFT):
    clock = [100.0]
    mon = SloMonitor(objective=0.5, fast_window_s=10.0,
                     slow_window_s=100.0, burn_threshold=1.0,
                     min_samples=1, registry=MetricsRegistry(),
                     time_fn=lambda: clock[0])
    for _ in range(4):
        mon.observe(tenant, kind, 2.0, 0.5)
    assert mon.firing(tenant, kind)
    return mon


def test_firing_slo_alert_boosts_whole_tenant():
    fe = _policy_frontend([TenantSpec("calm"), TenantSpec("burning")],
                          slo=_firing_monitor("burning"))
    now = time.perf_counter()

    def mk(tenant, age):
        r = Request(prompt=[1], max_new_tokens=1, tenant=tenant)
        r.submit_time = now - age
        return r

    calm, burning = mk("calm", 5.0), mk("burning", 0.1)
    q = deque([calm, burning])
    fe._order_admissions(q)
    assert list(q) == [burning, calm]
    fe.slo = None
    q = deque([calm, burning])
    fe._order_admissions(q)
    assert list(q) == [calm, burning]


def test_shed_policy_spares_firing_tenant():
    tenants = [TenantSpec("loud", max_queue_share=0.3),
               TenantSpec("burning", max_queue_share=0.2),
               TenantSpec("fresh")]

    def waiting():
        return [Request(prompt=[1], max_new_tokens=1, tenant=t)
                for t, n in (("loud", 2), ("burning", 3)) for _ in range(n)]

    incoming = Request(prompt=[1], max_new_tokens=1, tenant="fresh")
    victim = _policy_frontend(tenants)._pick_shed_victim(incoming, waiting())
    assert victim is not None and victim.tenant == "burning"
    fe = _policy_frontend(tenants, slo=_firing_monitor("burning"))
    w = waiting()
    victim = fe._pick_shed_victim(incoming, w)
    assert victim is w[1] and victim.tenant == "loud"
    mon = _firing_monitor("burning")
    for _ in range(4):
        mon.observe("loud", KIND_TTFT, 2.0, 0.5)
    assert mon.firing_any("loud")
    victim = _policy_frontend(tenants, slo=mon)._pick_shed_victim(
        incoming, waiting())
    assert victim is not None and victim.tenant == "burning"


def test_hostile_tenant_name_metrics(monkeypatch):
    reg = MetricsRegistry()
    reg.enabled = True
    monkeypatch.setattr(
        "deepspeed_tpu_torch.inference.serving.frontend.frontend."
        "get_registry", lambda: reg)
    fe = _policy_frontend([])
    tm = fe._tenant_metrics('evil{label="x"}\n# HELP bogus fake')
    tm["tokens"].inc()
    for m in tm.values():
        assert re.fullmatch(r"[a-zA-Z_][a-zA-Z0-9_]*", m.name), m.name
    assert fe._tenant_metrics("a b")["tokens"].name != \
        fe._tenant_metrics("a.b")["tokens"].name
    text = reg.to_prometheus()
    assert 'label="x"' not in text and "HELP bogus" not in text
    for line in text.splitlines():
        assert line.startswith(("#", "dstpu_")), line


def test_on_token_feeds_slo_and_exemplars(monkeypatch):
    reg = MetricsRegistry()
    reg.enabled = True
    monkeypatch.setattr(
        "deepspeed_tpu_torch.inference.serving.frontend.frontend."
        "get_registry", lambda: reg)
    mon = SloMonitor(objective=0.9, fast_window_s=10.0,
                     slow_window_s=100.0, min_samples=1,
                     registry=MetricsRegistry())
    fe = _policy_frontend(
        [TenantSpec("t", ttft_slo_s=0.5, itl_slo_s=0.1)], slo=mon)
    req = SimpleNamespace(prompt=[1, 2], submit_time=10.0,
                          trace_id="r0-000001")
    fe._on_token(SimpleNamespace(token=7, index=0, tenant="t", request=req,
                                 time_s=11.0, prev_time_s=None))
    fe._on_token(SimpleNamespace(token=8, index=1, tenant="t", request=req,
                                 time_s=11.3, prev_time_s=11.0))
    snap = mon.snapshot()
    assert snap[f"t/{KIND_TTFT}"]["samples"] == 1
    assert snap[f"t/{KIND_ITL}"]["samples"] == 1
    tm = fe._tenant_metrics("t")
    assert [x[0] for x in tm["ttft"].exemplars().values()] == ["r0-000001"]
    assert 'trace_id="r0-000001"' in reg.to_prometheus()


def test_slo_alerts_fire_and_resolve_on_the_server(params):
    """A tenant whose TTFT target its own burst cannot meet: the
    front end's monitor fires for it and resolves once the load is
    gone (synthetic clock: 1 s per step)."""
    srv = build_engine(params).serving_engine()
    clock = [0.0]
    mon = SloMonitor(objective=0.9, fast_window_s=4.0, slow_window_s=16.0,
                     burn_threshold=1.0, min_samples=2,
                     registry=MetricsRegistry(), time_fn=lambda: clock[0])
    alerts = []
    mon.subscribe(alerts.append)
    fe = ServingFrontend(srv, slo=mon)
    fe.register(TenantSpec("batch", ttft_slo_s=1e-9))
    fe.register(TenantSpec("calm", ttft_slo_s=1e3))
    for i in range(6):
        fe.submit([5 + i, 6, 7], tenant="batch", max_new_tokens=3)
    fe.submit([1, 2], tenant="calm", max_new_tokens=3)
    while srv.step():
        clock[0] += 1.0
        mon.evaluate()
    clock[0] += 40.0
    mon.evaluate()
    got = [(a.tenant, a.state) for a in alerts]
    assert ("batch", "firing") in got and ("batch", "resolved") in got
    assert all(t == "batch" for t, _ in got)


# ---------------------------------------------------------------------------
# parity with the JAX front end
# ---------------------------------------------------------------------------
def _script(fe, step, tenants):
    """Three tenants through a 2-deep bounded queue: each request's
    status and the order in which requests got their first token."""
    for name, w, share in (("interactive", 4.0, 0.0), ("standard", 1.0, 0.0),
                           ("batch", 1.0, 0.5)):
        fe.register(tenants(name, weight=w, max_queue_share=share))
    labels, firsts, reqs = {}, [], []
    fe.srv.token_hooks.append(
        lambda ev: firsts.append(labels[id(ev.request)])
        if ev.index == 0 and ev.token is not None else None)
    rs = np.random.RandomState(7)

    def sub(label, tenant, n):
        req = fe.submit(rs.randint(0, 64, n).tolist(), tenant=tenant,
                        max_new_tokens=4)
        labels[id(req)] = label
        reqs.append((label, req))
    for r in range(12):
        if r % 3 == 0:
            sub(f"i{r}", "interactive", 5)
        if r in (1, 6):
            for i in range(4):
                sub(f"b{r}.{i}", "batch", 20)
        if r % 4 == 2:
            sub(f"s{r}", "standard", 11)
        step()
    while step():
        pass
    return ([(label, r.status.value) for label, r in reqs], firsts,
            [r.output for _, r in reqs])


def test_frontend_decisions_match_jax(params, monkeypatch):
    monkeypatch.setattr(
        jax_pa, "paged_decode_attention",
        lambda q, pk, pv, lens, tables, sm_scale=None, k_scale=None,
        v_scale=None, kv_bits=0, **_: jax_pa.paged_attention_reference(
            q, pk, pv, lens, tables, k_scale, v_scale, kv_bits))
    monkeypatch.setattr(
        jax_pa, "paged_prefill_attention",
        lambda q, pk, pv, base, n, table, sm_scale=None, k_scale=None,
        v_scale=None, kv_bits=0, **_: jax_pa.paged_prefill_reference(
            q, pk, pv, base, n, table, k_scale, v_scale, kv_bits))
    serving = {"max_queue_depth": 2, "max_batch_slots": 2}
    psrv = build_engine(params, serving).serving_engine()
    ours = _script(ServingFrontend(psrv, slo=None), psrv.step, TenantSpec)
    jm = jax_tf.TransformerLM(jax_tf.gpt2_config("125m", dtype=jnp.float32,
                                                 **TINY))
    jeng = ds.init_inference(jm, config={
        **BASE, "replace_with_kernel_inject": False,
        "serving": {**SERVING, **serving}}, params=params_to_jax(params))
    jsrv = jeng.serving_engine()
    theirs = _script(JaxFrontend(jsrv, slo=None), jsrv.step, JaxTenantSpec)
    assert ours == theirs
    statuses = [s for _, s in ours[0]]
    assert "shed" in statuses and "ok" in statuses
