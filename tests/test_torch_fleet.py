"""The port's replica fleet: the cases of the JAX package's
``tests/unit/test_fleet.py`` on the port, on the CPU in float32.

Fast units: the placement score (equal to the JAX function's), the
stream deduper's exactly-once filter (and its high-water mark across a
second failover), the SHED retry-after estimate and stamp, the fleet
config's refusals (the JAX messages word for word), the replica liveness
monitor, and the router over duck-typed stub replicas (affinity against
queue depth, the ``serving.fleet.route`` site, pending placement, shed
absorption).

Engine-backed: ``FleetRouter.from_engine`` over the port's tiny GPT-2
(2 layers, d_model 32, vocab 64, weights from a seeded generator times
``SPREAD`` so greedy streams move), every greedy stream equal to the
JAX ``generate()`` on the same weights and every seeded sampled stream
to the port's seeded ``generate()``, delivered exactly once: across two
replicas, through a failover (the dead replica's flight-recorder bundle
naming the replayed trace ids), a double failover, a drain, a warm live
join through the shared host tier, engine-side sheds, threaded replicas,
and the fleet chaos plans (a transient ``serving.fleet.route`` plan and
a fatal ``serving.fleet.replica_step`` plan, installed per case).  No
``decode_builds`` is pinned: the port compiles nothing.
"""
import json
import os
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dt
from deepspeed_tpu.inference.config import FleetConfig as JaxFleetConfig
from deepspeed_tpu.inference.serving import \
    placement_score as jax_placement_score
from deepspeed_tpu.models import transformer as jax_tf
from deepspeed_tpu_torch.elasticity import ReplicaLivenessMonitor
from deepspeed_tpu_torch.inference.config import (DeepSpeedInferenceConfig,
                                                  FleetConfig)
from deepspeed_tpu_torch.inference.serving import (FleetRouter, ReplicaHandle,
                                                   ReplicaState,
                                                   RequestStatus,
                                                   StreamCollector,
                                                   StreamDeduper,
                                                   placement_score)
from deepspeed_tpu_torch.inference.serving.engine import ServingEngine
from deepspeed_tpu_torch.inference.serving.frontend.streaming import (
    StreamReplayError, TokenEvent)
from deepspeed_tpu_torch.inference.serving.scheduler import \
    estimate_retry_after_s
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.convert import params_to_jax
from deepspeed_tpu_torch.observability import (get_flight_recorder,
                                               get_request_tracer)
from deepspeed_tpu_torch.runtime.resilience import (FaultInjector,
                                                    RetryPolicy,
                                                    install_fault_injector)
from deepspeed_tpu_torch.runtime.resilience.heartbeat import beat


@pytest.fixture
def injector():
    fi = install_fault_injector(FaultInjector())
    yield fi
    install_fault_injector(FaultInjector())


def ev(token, index, final=False, status=None, request=None):
    return TokenEvent(request=request, token=token, index=index,
                      status=status, final=final, tenant="default",
                      time_s=0.0, prev_time_s=None)


# ---------------------------------------------------------------------------
# units: score, dedup, retry-after, config, liveness
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cov,depth,host,kw", [
    (64, 1, 0, {}), (16, 2, 0, {}), (0, 3, 0, {}),
    (64, 1, 0, dict(affinity_weight=0.0)),
    (64, 1, 0, dict(queue_cost_tokens=100.0)),
    (0, 1, 128, {}), (32, 0, 64, dict(promote_discount=0.1))])
def test_placement_score_equals_jax(cov, depth, host, kw):
    assert placement_score(cov, depth, host_covered_tokens=host, **kw) == \
        jax_placement_score(cov, depth, host_covered_tokens=host, **kw)


def test_placement_score_trades_affinity_against_queue():
    assert placement_score(64, 1) > placement_score(0, 0)
    assert placement_score(16, 2) < placement_score(0, 0)
    assert placement_score(0, 3) == -96.0
    assert placement_score(64, 1, affinity_weight=0.0) == -32.0
    assert placement_score(64, 1, queue_cost_tokens=100.0) == -36.0


def test_stream_deduper_exactly_once():
    d = StreamDeduper()
    assert d.admit(ev(5, 0)) is not None
    assert d.admit(ev(7, 1)) is not None
    assert d.delivered == [5, 7] and d.high_water == 2
    assert d.admit(ev(5, 0)) is None
    assert d.admit(ev(7, 1)) is None
    assert d.duplicates == 2 and d.delivered == [5, 7]
    assert d.admit(ev(9, 2)) is not None
    assert d.delivered == [5, 7, 9]
    term = ev(None, 3, final=True, status=RequestStatus.SHED)
    assert d.admit(term) is term


def test_stream_deduper_divergence_and_gap_are_loud():
    d = StreamDeduper()
    d.admit(ev(5, 0))
    with pytest.raises(StreamReplayError, match="diverged"):
        d.admit(ev(6, 0))
    with pytest.raises(StreamReplayError, match="gap"):
        d.admit(ev(8, 2))


def test_stream_deduper_survives_double_failover_replay():
    """After a first failover's replay and new progress, a second replay
    dedupes against the union high-water mark."""
    d = StreamDeduper()
    for i, tok in enumerate([5, 7]):
        assert d.admit(ev(tok, i)) is not None
    for i, tok in enumerate([5, 7]):
        assert d.admit(ev(tok, i)) is None
    assert d.admit(ev(9, 2)) is not None
    assert d.admit(ev(11, 3)) is not None
    for i, tok in enumerate([5, 7, 9, 11]):
        assert d.admit(ev(tok, i)) is None
    assert d.admit(ev(13, 4)) is not None
    assert d.delivered == [5, 7, 9, 11, 13]
    assert d.high_water == 5 and d.duplicates == 6


def test_estimate_retry_after_bounds():
    assert estimate_retry_after_s(None) == 0.05
    assert estimate_retry_after_s(0.0) == 0.05
    assert estimate_retry_after_s(0.001) == 0.05
    assert estimate_retry_after_s(0.4) == 0.4
    assert estimate_retry_after_s(1e6) == 30.0


@pytest.mark.parametrize("block", [
    {"replicas": 0}, {"heartbeat_interval_s": 0.0},
    {"heartbeat_interval_s": 1.0, "heartbeat_timeout_s": 1.5},
    {"affinity_weight": -1.0}, {"max_failovers": -1},
    {"retry_base_delay_s": 1.0, "retry_max_delay_s": 0.5},
    {"replicas": 2, "prefill_replicas": 2}, {"prefill_replicas": -1},
    {"promote_discount": 1.5}, {"chip_budget": 0},
    {"scale_up_cooldown_s": 0.0}, {"queue_low": 4.0, "queue_high": 2.0},
    {"quiet_s": -1.0}])
def test_fleet_config_refusals_equal_jax(block):
    """Every ``serving.fleet`` block the JAX config rejects, the port's
    rejects with the same message."""
    with pytest.raises(ValueError) as theirs:
        JaxFleetConfig(**block)
    with pytest.raises(ValueError) as ours:
        DeepSpeedInferenceConfig.from_dict(
            {"serving": {"enabled": True, "fleet": block}})
    assert str(ours.value) in str(theirs.value)


def test_fleet_config_defaults_equal_jax():
    ours, theirs = FleetConfig(), JaxFleetConfig()
    for name in FleetConfig.__dataclass_fields__:
        assert getattr(ours, name) == getattr(theirs, name), name


def test_replica_liveness_monitor(tmp_path):
    mon = ReplicaLivenessMonitor(str(tmp_path / "beats"), timeout_s=30.0)
    p = mon.path_for("r0")
    assert p.endswith("r0.heartbeat")
    assert mon.stale_replicas(["r0"]) == ["r0"]
    beat(p)
    assert mon.stale_replicas(["r0"]) == []


def test_scheduler_stamps_retry_after_on_shed():
    from deepspeed_tpu_torch.inference.serving.block_allocator import \
        PagedBlockAllocator
    from deepspeed_tpu_torch.inference.serving.scheduler import (
        ContinuousBatchingScheduler, Request)
    sched = ContinuousBatchingScheduler(
        num_slots=2, allocator=PagedBlockAllocator(16, 4),
        max_blocks_per_seq=8, max_queue_depth=1)
    sched.retry_after_hint = lambda: 0.25
    sched.submit(Request(prompt=[1, 2], max_new_tokens=2))
    shed = sched.submit(Request(prompt=[3, 4], max_new_tokens=2))
    assert shed.status is RequestStatus.SHED
    assert shed.retry_after_s == 0.25


# ---------------------------------------------------------------------------
# units: the router over stub replicas
# ---------------------------------------------------------------------------
class _StubReplica:
    """Duck-typed ReplicaHandle: scripted coverage and queue depth, and a
    shed budget so the router's absorb-and-retry path runs without an
    engine."""

    def __init__(self, rid, cov=0, depth=0, shed_next=0, retry_after=None):
        self.replica_id = rid
        self.state = ReplicaState.HEALTHY
        self.cov, self.depth = cov, depth
        self.shed_next, self.retry_after = shed_next, retry_after
        self.srv = types.SimpleNamespace(host_cache=None)
        self.specs = []

    @property
    def routable(self):
        return self.state is ReplicaState.HEALTHY

    @property
    def alive(self):
        return self.state in (ReplicaState.STARTING, ReplicaState.HEALTHY,
                              ReplicaState.DRAINING)

    @property
    def threaded(self):
        return False

    @property
    def queue_depth(self):
        return self.depth

    def prefix_coverage(self, toks):
        return self.cov

    def join(self):
        self.state = ReplicaState.HEALTHY

    def has_work(self):
        return False

    def beat_stale(self):
        return False

    def step(self):
        return False

    def in_flight(self):
        return []

    def submit(self, spec):
        self.specs.append(spec)
        if self.shed_next:
            self.shed_next -= 1
            fake = types.SimpleNamespace(retry_after_s=self.retry_after,
                                         error="shed")
            spec.on_token(ev(None, 0, final=True,
                             status=RequestStatus.SHED, request=fake))
            return fake
        req = types.SimpleNamespace(prng_key=79, retry_after_s=None,
                                    error=None)
        if spec.on_submitted is not None:
            spec.on_submitted(req)
        return req


def test_router_places_by_affinity_then_queue():
    warm = _StubReplica("warm", cov=100, depth=1)
    cold = _StubReplica("cold", cov=0, depth=0)
    fleet = FleetRouter([warm, cold])
    freq = fleet.submit([1, 2, 3, 4])
    assert freq.replica is warm
    warm.cov, warm.depth = 16, 2
    assert fleet.submit([1, 2, 3, 4]).replica is cold
    # the first placement pins the sampling key for every later replay
    assert freq.prng_key == 79


def test_router_transient_route_fault_degrades_to_queue_depth(injector):
    injector.add_plan("serving.fleet.route", "fail", at=1)
    warm = _StubReplica("warm", cov=1000, depth=1)
    cold = _StubReplica("cold", cov=0, depth=0)
    fleet = FleetRouter([warm, cold])
    assert fleet.submit([1, 2, 3]).replica is cold
    assert fleet.submit([1, 2, 3]).replica is warm


def test_router_fatal_route_fault_fails_the_one_request(injector):
    injector.add_plan("serving.fleet.route", "fatal", at=1)
    fleet = FleetRouter([_StubReplica("r0")])
    sink = StreamCollector()
    freq = fleet.submit([1, 2], on_token=sink)
    assert freq.status is RequestStatus.FAILED
    assert "serving.fleet.route" in freq.error
    assert sink.finished and sink.tokens == []
    assert fleet.submit([1, 2]).replica is not None


def test_router_unroutable_fleet_pends_then_places():
    t = [100.0]
    r = _StubReplica("r0")
    r.state = ReplicaState.DRAINING
    fleet = FleetRouter([r], clock=lambda: t[0],
                        retry_policy=RetryPolicy(base_delay_s=0.5,
                                                 max_delay_s=0.5,
                                                 jitter=0.0))
    freq = fleet.submit([1, 2])
    assert freq.status is None and freq.replica is None
    fleet.pump()
    assert not r.specs
    r.state = ReplicaState.HEALTHY
    t[0] += 1.0
    fleet.pump()
    assert freq.replica is r


def test_router_dead_fleet_fails_fast():
    r = _StubReplica("r0")
    r.state = ReplicaState.DEAD
    freq = FleetRouter([r]).submit([1, 2])
    assert freq.status is RequestStatus.FAILED
    assert "no live replicas" in freq.error


def test_router_absorbs_shed_with_retry_after_floor():
    t = [0.0]
    r = _StubReplica("r0", shed_next=1, retry_after=0.5)
    fleet = FleetRouter([r], clock=lambda: t[0],
                        retry_policy=RetryPolicy(max_attempts=3,
                                                 base_delay_s=0.01,
                                                 max_delay_s=0.02,
                                                 jitter=0.0))
    freq = fleet.submit([1, 2, 3])
    assert freq.status is None
    assert fleet.fleet_counts["shed_retries"] == 1
    assert freq.retry_at == pytest.approx(0.5)
    t[0] = 0.4
    fleet.pump()
    assert len(r.specs) == 1
    t[0] = 0.6
    fleet.pump()
    assert len(r.specs) == 2 and freq.replica is r
    assert freq.prng_key == 79


def test_router_shed_budget_exhausts_to_terminal_shed():
    r = _StubReplica("r0", shed_next=99)
    t = [0.0]
    fleet = FleetRouter([r], clock=lambda: t[0],
                        retry_policy=RetryPolicy(max_attempts=2,
                                                 base_delay_s=0.01,
                                                 max_delay_s=0.01,
                                                 jitter=0.0))
    sink = StreamCollector()
    freq = fleet.submit([1, 2], on_token=sink)
    for _ in range(10):
        if freq.status is not None:
            break
        t[0] += 1.0
        fleet.pump()
    assert freq.status is RequestStatus.SHED
    assert "retry budget" in freq.error
    assert sink.finished and sink.events[-1].status is RequestStatus.SHED
    assert fleet.fleet_counts["shed_retries"] == 3


# ---------------------------------------------------------------------------
# engine-backed: the fleet over the port's tiny GPT-2
# ---------------------------------------------------------------------------
TINY = dict(num_layers=2, d_model=32, num_heads=4, vocab_size=64,
            max_seq_len=64)
SPREAD = 4.0
BASE = {"dtype": "float32", "max_out_tokens": 48, "temperature": 0.0}


def spread(tree):
    if isinstance(tree, dict):
        return {k: spread(v) for k, v in tree.items()}
    return tree * SPREAD if tree.dim() >= 2 and tree.shape[-1] > 1 else tree


@pytest.fixture(scope="module")
def weights():
    """(port params, the JAX engine over the same weights: the greedy
    streams' reference ``generate()``)."""
    g = torch.Generator()
    g.manual_seed(21)
    pm = tt.TransformerLM(tt.gpt2_config("125m", dtype=torch.float32, **TINY))
    params = spread(pm.init(g, "cpu", torch.float32))
    jm = jax_tf.TransformerLM(jax_tf.gpt2_config("125m", dtype=jnp.float32,
                                                 **TINY))
    jeng = ds.init_inference(jm, config={
        **BASE, "replace_with_kernel_inject": False},
        params=params_to_jax(params))
    return params, jeng


def fleet_engine(params, replicas=2, slots=3, num_kv_blocks=32,
                 max_queue_depth=16, host_cache=True, **fleet_kw):
    serving = {"enabled": True, "kv_block_size": 4,
               "num_kv_blocks": num_kv_blocks, "max_batch_slots": slots,
               "prefill_chunk_tokens": 8, "max_preemptions": 4,
               "max_queue_depth": max_queue_depth,
               "fleet": {"enabled": True, "replicas": replicas,
                         **fleet_kw}}
    if host_cache:
        # wire_bits 0 keeps spill and promote lossless
        serving["host_cache"] = {"enabled": True,
                                 "dram_budget_bytes": 1 << 20,
                                 "wire_bits": 0}
    pm = tt.TransformerLM(tt.gpt2_config("125m", dtype=torch.float32, **TINY))
    return dt.init_inference(pm, {**BASE, "serving": serving},
                             params=params, device="cpu")


def reference(eng, jeng, prompt, n, samp):
    """Greedy: the JAX ``generate()``; sampled: the port's seeded one."""
    if samp.get("temperature", 0.0) == 0.0:
        return np.asarray(jeng.generate(np.asarray(prompt, np.int32)[None],
                                        max_new_tokens=n,
                                        temperature=0.0))[0].tolist()
    return eng.generate([prompt], max_new_tokens=n, **samp)[0].tolist()


WAVE = [([1, 2, 3], dict(temperature=0.0)),
        ([4, 5], dict(temperature=0.0)),
        ([6, 7, 8, 9], dict(temperature=0.0)),
        ([10, 11], dict(temperature=0.8, seed=7)),
        ([12, 13, 14], dict(temperature=0.6, top_k=12, seed=9)),
        ([15, 16], dict(temperature=0.9, top_p=0.9, seed=11))]


def submit_wave(fleet, wave, n=8):
    sinks, reqs = [], []
    for prompt, samp in wave:
        sink = StreamCollector()
        sinks.append(sink)
        reqs.append(fleet.submit(prompt, max_new_tokens=n, on_token=sink,
                                 **samp))
    return reqs, sinks


def assert_wave_exact(eng, jeng, fleet, wave, reqs, sinks, n=8):
    """Every OK stream equals its reference and reached the client
    exactly once, in order; every live replica's pool is clean."""
    assert all(f.done for f in reqs), "in flight after the drain"
    for (prompt, samp), freq, sink in zip(wave, reqs, sinks):
        if freq.status is not RequestStatus.OK:
            continue
        ref = reference(eng, jeng, prompt, n, samp)
        assert freq.output == ref, f"{freq.req_id}: {freq.output} != {ref}"
        assert sink.tokens == freq.output
        toks = [e for e in sink.events if e.token is not None]
        assert [e.index for e in toks] == list(range(len(freq.output)))
        assert sink.finished
    for r in fleet.replicas:
        if r.state is not ReplicaState.DEAD:
            r.srv.allocator.assert_consistent()
            assert r.srv.allocator.num_used == 0


def test_from_engine_builds_replicas_and_refuses_bad_roles(weights):
    params, _ = weights
    eng = fleet_engine(params, replicas=3)
    fleet = FleetRouter.from_engine(eng, seed=0)
    assert [(r.replica_id, r.role, r.srv.publisher_id)
            for r in fleet.replicas] == [("r0", "mixed", "r0"),
                                         ("r1", "mixed", "r1"),
                                         ("r2", "mixed", "r2")]
    hc = fleet.shared_host_cache
    assert hc is not None and all(r.srv.host_cache is hc
                                  for r in fleet.replicas)
    with pytest.raises(ValueError, match="serving role"):
        ServingEngine(eng, role="bogus")
    bare = fleet_engine(params, host_cache=False)
    with pytest.raises(ValueError, match="requires serving.host_cache"):
        ServingEngine(bare, role="prefill")
    with pytest.raises(ValueError, match="requires"):
        FleetRouter.from_engine(bare, prefill_replicas=1, replicas=2)


def test_fleet_parity_across_replicas(weights):
    params, jeng = weights
    eng = fleet_engine(params)
    fleet = FleetRouter.from_engine(eng, seed=0)
    reqs, sinks = submit_wave(fleet, WAVE)
    fleet.run()
    assert all(f.status is RequestStatus.OK for f in reqs)
    assert_wave_exact(eng, jeng, fleet, WAVE, reqs, sinks)
    assert len({f.replica.replica_id for f in reqs}) == 2
    assert fleet.fleet_counts["failovers"] == 0
    assert len({tuple(f.output) for f in reqs}) > 1


def test_fleet_failover_token_exact(weights, injector, tmp_path):
    """A fatal at ``serving.fleet.replica_step`` kills r0 mid-wave: every
    request fails over and streams exactly, once; r0's flight-recorder
    bundle names exactly the trace ids the router resubmitted."""
    from deepspeed_tpu_torch.runtime.resilience.integrity import \
        verify_manifest
    params, jeng = weights
    injector.add_plan("serving.fleet.replica_step", "fatal", at=5)
    fr = get_flight_recorder()
    fr.configure(enabled=True, capacity=64, output_dir=str(tmp_path / "fr"))
    fr.min_dump_interval_s = 0.0
    rt = get_request_tracer()
    rt.configure(enabled=True, capacity=64)
    try:
        eng = fleet_engine(params)
        fleet = FleetRouter.from_engine(eng, seed=0)
        reqs, sinks = submit_wave(fleet, WAVE[:3])
        fleet.pump()
        fleet.pump()
        late, late_sinks = submit_wave(fleet, WAVE[3:])
        reqs, sinks = reqs + late, sinks + late_sinks
        fleet.run()
        r0 = fleet.replica("r0")
        assert r0.state is ReplicaState.DEAD
        assert "serving.fleet.replica_step" in r0.death_reason
        assert fleet.fleet_counts["dead_replicas"] == 1
        assert fleet.fleet_counts["failovers"] >= 1
        assert fleet.fleet_counts["replayed_tokens"] >= 1
        assert all(f.status is RequestStatus.OK for f in reqs)
        assert_wave_exact(eng, jeng, fleet, WAVE, reqs, sinks)
        for f in reqs:
            if f.failovers:
                assert f.replica.replica_id != "r0"
                assert f.engine_req.prng_key == f.prng_key
        bundle = fr.last_bundle
        assert bundle is not None and os.path.isdir(bundle)
        ok, problems = verify_manifest(bundle)
        assert ok, problems
        with open(os.path.join(bundle, "reason.json")) as fh:
            reason = json.load(fh)
        assert reason["reason"] == "replica_dead"
        assert reason["extra"]["replica"] == "r0"
        sealed = reason["extra"]["trace_ids"]
        assert sealed and all(t.startswith("fleet-")
                              for t in sealed.values())
        assert set(sealed.values()) == \
            {f.trace_id for f in reqs if f.failovers}
        assert any(s.get("fleet_event") == "failover"
                   for s in fr.snapshots() if s)
    finally:
        fr.configure(enabled=False)
        rt.configure(enabled=False)
        rt.reset()


def _kill_on_next_step(fleet, injector, target):
    """Arm a fatal so ``target`` dies on ITS next iteration: the site's
    calls advance once per live replica per pump, in list order."""
    stepping = [r for r in fleet.replicas
                if r.state in (ReplicaState.HEALTHY, ReplicaState.DRAINING)]
    calls = injector.calls.get("serving.fleet.replica_step", 0)
    injector.add_plan("serving.fleet.replica_step", "fatal",
                      at=calls + stepping.index(target) + 1)


def test_fleet_double_failover_token_exact(weights, injector):
    params, jeng = weights
    eng = fleet_engine(params, replicas=3)
    fleet = FleetRouter.from_engine(eng, seed=0)
    reqs, sinks = submit_wave(fleet, WAVE)
    fleet.pump()
    fleet.pump()
    target = next(f for f in reqs if f.status is None)
    first = target.replica
    _kill_on_next_step(fleet, injector, first)
    fleet.pump()
    assert first.state is ReplicaState.DEAD
    assert target.failovers == 1 and target.replica is not first
    fleet.pump()
    assert target.status is None, "kill window closed too fast"
    second = target.replica
    _kill_on_next_step(fleet, injector, second)
    fleet.pump()
    assert second.state is ReplicaState.DEAD and target.failovers == 2
    fleet.run()
    assert fleet.fleet_counts["dead_replicas"] == 2
    assert all(f.status is RequestStatus.OK for f in reqs)
    assert_wave_exact(eng, jeng, fleet, WAVE, reqs, sinks)
    assert target.engine_req.prng_key == target.prng_key


def test_fleet_drain_completes_running_work(weights):
    params, jeng = weights
    eng = fleet_engine(params)
    fleet = FleetRouter.from_engine(eng, seed=0)
    reqs, sinks = submit_wave(fleet, WAVE)
    fleet.pump()
    target = next(f.replica for f in reqs if f.status is None)
    victims = [f for f in reqs if f.replica is target]
    assert victims
    fleet.drain(target)
    assert target.state is ReplicaState.RETIRED and not target.routable
    assert fleet.fleet_counts["drains"] == 1
    for f in victims:
        assert f.status is RequestStatus.OK
        assert f.failovers == 0 and f.replica is target
    fleet.run()
    assert all(f.status is RequestStatus.OK for f in reqs)
    assert_wave_exact(eng, jeng, fleet, WAVE, reqs, sinks)


def test_fleet_join_inherits_warm_prefixes(weights):
    """A cold replica built against the shared host tier is routable at
    once and covers prefixes the fleet spilled: warmth travels as
    content-addressed digests."""
    params, jeng = weights
    eng = fleet_engine(params, replicas=1, num_kv_blocks=12, slots=2)
    fleet = FleetRouter.from_engine(eng, seed=0)
    warm = [1, 2, 3, 4, 5, 6, 7, 8, 9]
    fleet.submit(warm, max_new_tokens=8)
    fleet.run()
    for p in ([20, 21, 22, 23, 24], [30, 31, 32, 33, 34],
              [40, 41, 42, 43, 44], [50, 51, 52, 53, 54]):
        fleet.submit(p, max_new_tokens=8)
    fleet.run()
    srv2 = ServingEngine(eng, seed=0,
                         shared_host_cache=fleet.shared_host_cache)
    h = ReplicaHandle("rj", srv2)
    assert not h.routable
    fleet.join(h)
    assert h.routable and h in fleet.routable_replicas
    assert fleet.fleet_counts["joins"] == 1
    assert h.prefix_coverage(warm) >= 4
    sink = StreamCollector()
    freq = fleet.submit(warm, max_new_tokens=8, on_token=sink)
    fleet.run()
    ref = reference(eng, jeng, warm, 8, {})
    assert freq.status is RequestStatus.OK and freq.output == ref
    assert sink.tokens == ref


def test_fleet_absorbs_engine_shed_and_recovers(weights):
    params, jeng = weights
    eng = fleet_engine(params, slots=2, max_queue_depth=2,
                       retry_base_delay_s=0.01, retry_max_delay_s=0.05)
    fleet = FleetRouter.from_engine(eng, seed=0)
    fleet.retry_policy = RetryPolicy(max_attempts=10, base_delay_s=0.01,
                                     max_delay_s=0.05, jitter=0.0)
    prompts = [[i + 1, i + 2, i + 3] for i in range(0, 30, 3)]
    sinks, reqs = [], []
    for p in prompts:
        sink = StreamCollector()
        sinks.append(sink)
        reqs.append(fleet.submit(p, max_new_tokens=8, on_token=sink))
    assert fleet.fleet_counts["shed_retries"] >= 1
    assert all(f.status is None for f in reqs)
    fleet.run()
    assert all(f.status is RequestStatus.OK for f in reqs)
    for p, f, sink in zip(prompts, reqs, sinks):
        ref = reference(eng, jeng, p, 8, {})
        assert f.output == ref and sink.tokens == ref


@pytest.mark.parametrize("faults", [
    "", "serving.fleet.route=fail:2:2",
    "serving.fleet.replica_step=fatal:6:1"],
    ids=["no-faults", "route-transient", "replica-step-fatal"])
def test_fleet_chaos_plans(weights, faults):
    """The fleet chaos matrix: a staggered greedy wave over two replicas,
    then a live drain; whatever the plan, every stream is exact and
    exactly once, and the drain terminalizes nothing."""
    params, jeng = weights
    fi = install_fault_injector(FaultInjector.from_env(
        {"DSTPU_FAULTS": faults}))
    try:
        eng = fleet_engine(params)
        fleet = FleetRouter.from_engine(eng, seed=0)
        wave = [([i + 1, i + 2, i + 3], dict(temperature=0.0))
                for i in range(0, 18, 3)]
        reqs, sinks = submit_wave(fleet, wave[:4])
        fleet.pump()
        fleet.pump()
        late, late_sinks = submit_wave(fleet, wave[4:])
        reqs, sinks = reqs + late, sinks + late_sinks
        fleet.run()
        assert all(f.status is RequestStatus.OK for f in reqs)
        assert_wave_exact(eng, jeng, fleet, wave, reqs, sinks)
        dead = [r for r in fleet.replicas if r.state is ReplicaState.DEAD]
        assert fleet.fleet_counts["dead_replicas"] == len(dead)
        if "replica_step" in faults:
            assert len(dead) == 1 and fleet.fleet_counts["failovers"] >= 1
        if "route" in faults:
            assert fi.fire_count("serving.fleet.route") == 2
        victim = fleet.routable_replicas[-1]
        extra, extra_sinks = submit_wave(fleet, wave[:2])
        fleet.pump()
        fleet.drain(victim)
        assert victim.state is ReplicaState.RETIRED
        fleet.run()
        assert all(f.status is RequestStatus.OK for f in extra)
        assert_wave_exact(eng, jeng, fleet, wave[:2], extra, extra_sinks)
    finally:
        install_fault_injector(FaultInjector())


def test_threaded_replicas_stream_exactly_once(weights, tmp_path):
    """``ReplicaHandle.start()``: each replica steps on its own thread,
    the router's pump only sweeps health and places; streams stay exact
    and exactly once, and the per-replica heartbeat files are stamped."""
    params, jeng = weights
    eng = fleet_engine(params, heartbeat_interval_s=0.05,
                       heartbeat_timeout_s=30.0)
    fleet = FleetRouter.from_engine(eng, seed=0,
                                    heartbeat_dir=str(tmp_path / "hb"))
    for r in fleet.replicas:
        r.start()
    try:
        reqs, sinks = submit_wave(fleet, WAVE)
        deadline = time.monotonic() + 120
        while fleet.has_work and time.monotonic() < deadline:
            fleet.pump()
            time.sleep(0.002)
    finally:
        for r in fleet.replicas:
            r.stop()
    assert all(f.status is RequestStatus.OK for f in reqs)
    assert_wave_exact(eng, jeng, fleet, WAVE, reqs, sinks)
    for r in fleet.replicas:
        assert os.path.exists(r.heartbeat_path)
