"""The port's disaggregated fleet (KV fabric, two-leg handoff,
autoscaler) and the fleet's observability: the cases of the JAX
package's ``tests/unit/test_disagg_fleet.py`` and
``tests/unit/test_fleet_obs.py`` on the port, on the CPU in float32.

Fast units: the fabric over ``HostTierCache`` (crc-verified claim,
publish faults mutating nothing, fatal claims quarantining, orphan
sweeps scoped by publisher, published entries exempt from the
device/host cross-check) held to the JAX tier op for op; placement
crediting fabric coverage at the promote discount; the autoscaler's
policy on a synthetic clock against a stub fleet; the fleet trace
assembler and validator, and the fleet metrics aggregator.

Engine-backed, over the port's tiny GPT-2 (greedy streams equal to the
JAX ``generate()`` on the same weights, seeded sampled ones to the
port's ``generate()``, every stream delivered exactly once): the
prefill -> fabric -> decode handoff, publish faults and a fatal claim
degrading to decode-side recompute, a prefill worker's drain and death
leaving no orphaned fabric entry, the disaggregated chaos plans
(transient ``serving.fabric.publish``, fatal ``serving.fabric.claim``,
fatal ``serving.fleet.scale``, installed per case), and one merged fleet
trace through a handoff and a failover.
"""
import json
import math
import os
import random
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
from deepspeed_tpu.inference.serving import HostTierCache as JaxHostTierCache
from deepspeed_tpu.models import transformer as jax_tf
from deepspeed_tpu.runtime.resilience import \
    FaultInjector as JaxFaultInjector
from deepspeed_tpu.runtime.resilience import \
    install_fault_injector as jax_install
import deepspeed_tpu_torch as dt
import deepspeed_tpu_torch.observability as obs
from deepspeed_tpu_torch.inference.serving import (FleetAutoscaler,
                                                   FleetRouter,
                                                   HostTierCache,
                                                   ReplicaHandle,
                                                   ReplicaState,
                                                   RequestStatus,
                                                   StreamCollector,
                                                   placement_score)
from deepspeed_tpu_torch.inference.serving.engine import ServingEngine
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.convert import params_to_jax
from deepspeed_tpu_torch.observability import (FleetMetricsAggregator,
                                               FleetTraceAssembler,
                                               FleetTraceContext, Histogram,
                                               get_overlap_profiler,
                                               get_request_tracer,
                                               interpolate_quantile,
                                               validate_fleet_trace)
from deepspeed_tpu_torch.observability.fleet_metrics import hist_snapshot
from deepspeed_tpu_torch.observability.fleet_trace import FLOW_CAT
from deepspeed_tpu_torch.observability.metrics import decumulate
from deepspeed_tpu_torch.observability.slo import (KIND_ITL, KIND_TTFT,
                                                   SloAlert, SloMonitor)
from deepspeed_tpu_torch.runtime.config import ObservabilityConfig
from deepspeed_tpu_torch.runtime.config_utils import from_dict
from deepspeed_tpu_torch.runtime.resilience import (FaultInjector,
                                                    install_fault_injector)
from deepspeed_tpu_torch.runtime.resilience.errors import TransientIOError


@pytest.fixture
def injector():
    fi = install_fault_injector(FaultInjector())
    yield fi
    install_fault_injector(FaultInjector())


@pytest.fixture
def obs_reset():
    """The telemetry is process-global: the test leaves it off, and the
    registry and recorders empty."""
    yield
    obs.configure(None)
    obs.get_registry().reset()
    obs.get_tracer().reset()
    get_request_tracer().reset()
    get_overlap_profiler().reset()


# ---------------------------------------------------------------------------
# the KV fabric over HostTierCache
# ---------------------------------------------------------------------------
def _cache(dram_slots=4, entry=64):
    return HostTierCache(entry_nbytes=entry, dram_slots=dram_slots)


def _payload(seed, entry=64):
    return (np.arange(entry, dtype=np.uint8) + seed) % 251


def fabric_state(hc):
    return (sorted(hc.digests()), hc.published_entries(),
            hc.published_entries("p0"), hc.published_total,
            hc.orphans_reaped_total, hc.corrupt_dropped_total,
            hc.claim_faults_total, hc.evictions_total, dict(hc.hits_total))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fabric_op_sequence_equals_jax(seed):
    """Publishes by two publishers, plain spills, claims (some under a
    transient or fatal ``serving.fabric.claim`` fault, some over a
    corrupted entry), discards and scoped or fleet-wide orphan sweeps:
    the same residency, counters and claimed bytes as the JAX fabric."""
    rng = np.random.default_rng(seed)
    ours, theirs = _cache(3), JaxHostTierCache(64, dram_slots=3)
    port_fi, jax_fi = FaultInjector(), JaxFaultInjector()
    install_fault_injector(port_fi)
    jax_install(jax_fi)
    try:
        for step in range(50):
            op = int(rng.integers(0, 7))
            d = bytes([int(rng.integers(0, 6))]) * 16
            if op == 0:
                pub = f"p{int(rng.integers(0, 2))}"
                ours.publish(d, _payload(step), publisher=pub)
                theirs.publish(d, _payload(step), publisher=pub)
            elif op == 1:
                ours.put(d, _payload(step))
                theirs.put(d, _payload(step))
            elif op in (2, 3):
                if op == 3:
                    kind = ("fail", "fatal")[int(rng.integers(0, 2))]
                    n = port_fi.calls.get("serving.fabric.claim", 0) + 1
                    port_fi.add_plan("serving.fabric.claim", kind, at=n)
                    jax_fi.add_plan("serving.fabric.claim", kind, at=n)
                a, b = ours.claim(d), theirs.claim(d)
                assert (a is None) == (b is None), step
                if a is not None:
                    np.testing.assert_array_equal(a, b)
            elif op == 4 and (d in ours._published):
                # corrupt the stored bytes behind the crc's back
                for hc in (ours, theirs):
                    tier = hc._tiers[0]
                    tier.store.write_slot(tier.lru[d], _payload(99))
            elif op == 5:
                assert ours.discard(d) == theirs.discard(d)
            elif op == 6:
                who = (None, "p0", "p1")[int(rng.integers(0, 3))]
                assert ours.reap_orphans(who) == theirs.reap_orphans(who)
            assert fabric_state(ours) == fabric_state(theirs), step
            ours.assert_consistent()
    finally:
        install_fault_injector(FaultInjector())
        jax_install(JaxFaultInjector())


def test_fabric_publish_claim_roundtrip():
    hc = _cache()
    pay = _payload(1)
    hc.publish(b"d1", pay, publisher="p0")
    assert hc.published_total == 1 and hc.published_entries() == 1
    assert hc.published_entries("p0") == 1 and hc.published_entries("px") == 0
    got = hc.claim(b"d1")
    assert got is not None and np.array_equal(got, pay)
    assert hc.published_entries() == 0 and not hc.contains(b"d1")
    assert hc.corrupt_dropped_total == 0
    hc.assert_consistent()


def test_fabric_claim_drops_corrupt_payload():
    hc = _cache()
    hc.publish(b"d1", _payload(1), publisher="p0")
    tier = hc._tiers[0]
    tier.store.write_slot(tier.lru[b"d1"], _payload(99))
    assert hc.claim(b"d1") is None
    assert hc.corrupt_dropped_total == 1
    assert not hc.contains(b"d1") and hc.published_entries() == 0
    hc.assert_consistent()


def test_fabric_publish_fault_mutates_nothing(injector):
    injector.add_plan("serving.fabric.publish", "fail", at=1)
    hc = _cache()
    with pytest.raises(TransientIOError):
        hc.publish(b"d1", _payload(1), publisher="p0")
    assert hc.published_total == 0 and hc.published_entries() == 0
    assert not hc.contains(b"d1")
    hc.assert_consistent()
    hc.publish(b"d1", _payload(1), publisher="p0")
    assert hc.published_entries() == 1


def test_fabric_claim_fault_semantics(injector):
    hc = _cache()
    hc.publish(b"d1", _payload(1), publisher="p0")
    injector.add_plan("serving.fabric.claim", "fail", at=1)
    assert hc.claim(b"d1") is None
    assert hc.claim_faults_total == 1 and hc.contains(b"d1")
    injector.add_plan("serving.fabric.claim", "fatal", at=2)
    assert hc.claim(b"d1") is None
    assert hc.claim_faults_total == 2 and not hc.contains(b"d1")
    assert hc.published_entries() == 0
    hc.assert_consistent()


def test_fabric_reap_orphans_is_publisher_scoped():
    hc = _cache()
    hc.publish(b"a", _payload(1), publisher="p0")
    hc.publish(b"b", _payload(2), publisher="p0")
    hc.publish(b"c", _payload(3), publisher="p1")
    assert hc.reap_orphans("p0") == 2 and hc.orphans_reaped_total == 2
    assert hc.published_entries() == 1 and hc.contains(b"c")
    assert hc.reap_orphans() == 1 and hc.published_entries() == 0
    hc.assert_consistent()


def test_fabric_eviction_untracks_published_digest():
    hc = _cache(dram_slots=2)
    for i, d in enumerate((b"a", b"b", b"c")):
        hc.publish(d, _payload(i), publisher="p0")
    assert hc.evictions_total == 1
    assert hc.published_entries() == 2 and not hc.contains(b"a")
    hc.assert_consistent()


def test_fabric_published_exempt_from_device_cross_check():
    hc = _cache()
    hc.publish(b"pub", _payload(1), publisher="p0")
    hc.put(b"spill", _payload(2))
    hc.assert_consistent(device_digests={b"pub"})
    with pytest.raises(AssertionError, match="device radix"):
        hc.assert_consistent(device_digests={b"spill"})
    hc._published[b"ghost"] = (None, 0)
    with pytest.raises(AssertionError, match="not.*resident"):
        hc.assert_consistent()


# ---------------------------------------------------------------------------
# placement credits fabric coverage at the promote discount
# ---------------------------------------------------------------------------
def test_placement_score_discounts_fabric_coverage():
    assert placement_score(0, 0, host_covered_tokens=64) == 32.0
    assert placement_score(64, 0) \
        > placement_score(0, 0, host_covered_tokens=64) \
        > placement_score(0, 0)
    assert placement_score(0, 0, host_covered_tokens=64,
                           promote_discount=0.0) == 0.0
    assert placement_score(0, 1, host_covered_tokens=128) \
        > placement_score(0, 0)


class _SplitStub:
    """Duck-typed replica with split (device, host) coverage."""

    def __init__(self, rid, dev=0, host=0, depth=0, role="mixed"):
        self.replica_id, self.role = rid, role
        self.state = ReplicaState.HEALTHY
        self.dev, self.host, self.depth = dev, host, depth
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

    def prefix_coverage(self, toks, split=False):
        return (self.dev, self.host) if split else self.dev + self.host

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
        req = types.SimpleNamespace(prng_key=79, retry_after_s=None,
                                    error=None)
        if spec.on_submitted is not None:
            spec.on_submitted(req)
        return req


class _LegacyStub(_SplitStub):
    """A handle whose coverage probe takes no ``split``: the router
    counts everything as device-resident."""

    def prefix_coverage(self, toks):
        return self.dev


def test_router_credits_fabric_coverage_discounted():
    warm = _SplitStub("warm", dev=0, host=100, depth=1)
    cold = _SplitStub("cold")
    assert FleetRouter([warm, cold]).submit([1, 2, 3, 4]).replica is warm
    fleet2 = FleetRouter([_SplitStub("warm", host=100, depth=1),
                          _SplitStub("cold")], promote_discount=0.1)
    assert fleet2.submit([1, 2, 3, 4]).replica.replica_id == "cold"


def test_router_handles_presplit_coverage_handles():
    warm = _LegacyStub("warm", dev=100, depth=1)
    assert FleetRouter([warm, _LegacyStub("cold")]).submit(
        [1, 2, 3, 4]).replica is warm


def test_router_plans_two_legs_only_with_a_prefill_class():
    pre = _SplitStub("p0", role="prefill")
    pre.srv = types.SimpleNamespace(host_cache=None, block_size=4)
    dec = _SplitStub("d0", role="decode")
    fleet = FleetRouter([pre, dec])
    freq = fleet.submit(list(range(9)))
    assert freq.leg == "prefill" and freq.replica is pre
    assert pre.specs[-1].prefill_only
    # a prompt without one full block has nothing to publish
    assert fleet.submit([1, 2, 3]).leg == "direct"
    # a decode replica already covering the full blocks: direct
    dec.dev = 8
    assert fleet.submit(list(range(9))).leg == "direct"


# ---------------------------------------------------------------------------
# the autoscaler on a synthetic clock
# ---------------------------------------------------------------------------
class _ScaleReplica:
    def __init__(self, rid, role="mixed", depth=0):
        self.replica_id, self.role = rid, role
        self.state = ReplicaState.HEALTHY
        self.depth = depth

    @property
    def alive(self):
        return self.state in (ReplicaState.STARTING, ReplicaState.HEALTHY,
                              ReplicaState.DRAINING)

    @property
    def queue_depth(self):
        return self.depth

    def has_work(self):
        return self.depth > 0

    def join(self):
        self.state = ReplicaState.HEALTHY

    def begin_drain(self):
        if self.state is ReplicaState.HEALTHY:
            self.state = ReplicaState.DRAINING

    def retire(self):
        self.state = ReplicaState.RETIRED


class _StubFleet:
    """The router surface the autoscaler touches."""

    def __init__(self, replicas):
        self.replicas = list(replicas)
        self.fleet_counts = {"drains": 0}
        self._m_drains = types.SimpleNamespace(inc=lambda: None)
        self.reaped = []

    def join(self, handle):
        handle.join()
        self.replicas.append(handle)
        return handle

    def drain(self, replica, pump=True):
        assert pump is False, "autoscaler drains must not block the loop"
        replica.begin_drain()
        return replica

    def _reap_publisher(self, r):
        self.reaped.append(r.replica_id)
        return 0


def _spawner(spawned):
    def spawn(role):
        h = _ScaleReplica(f"as-{role}-{len(spawned)}", role)
        h.state = ReplicaState.STARTING
        spawned.append(h)
        return h
    return spawn


def _firing(kind, at=0.0):
    return SloAlert(tenant="t0", kind=kind, state="firing", burn_fast=4.0,
                    burn_slow=4.0, target_s=1.0, at=at)


def test_autoscaler_burn_ramp_scales_up_before_breach():
    t = [0.0]
    mon = SloMonitor(objective=0.9, fast_window_s=10.0, slow_window_s=10.0,
                     burn_threshold=2.0, min_samples=3,
                     time_fn=lambda: t[0])
    fleet = _StubFleet([_ScaleReplica("p0", "prefill"),
                        _ScaleReplica("d0", "decode")])
    spawned = []
    auto = FleetAutoscaler(fleet, _spawner(spawned), slo_monitor=mon,
                           clock=lambda: t[0], chip_budget=8,
                           scale_up_cooldown_s=5.0)
    for _ in range(5):
        t[0] += 0.5
        mon.observe("t0", KIND_TTFT, 0.1, 1.0)
    assert auto.tick() == []
    for _ in range(6):
        t[0] += 0.5
        mon.observe("t0", KIND_TTFT, 5.0, 1.0)
    events = auto.tick()
    assert [e["action"] for e in events] == ["up"]
    assert events[0]["role"] == "prefill" and "alert" in events[0]["reason"]
    assert spawned[0] in fleet.replicas
    assert spawned[0].state is ReplicaState.HEALTHY
    t[0] += 20.0
    for _ in range(6):
        t[0] += 0.5
        mon.observe("t0", KIND_ITL, 5.0, 1.0)
    assert [(e["action"], e["role"]) for e in auto.tick()] == \
        [("up", "decode"), ("down", "prefill")]
    assert auto.counts["scale_ups"] == 2


def test_autoscaler_quiet_tail_scales_down_behind_cooldown():
    t = [0.0]
    reps = [_ScaleReplica(f"d{i}", "decode") for i in range(3)]
    fleet = _StubFleet(reps)
    auto = FleetAutoscaler(fleet, _spawner([]), clock=lambda: t[0],
                           quiet_s=10.0, scale_down_cooldown_s=30.0,
                           queue_high=8.0, queue_low=1.0)
    reps[0].depth = 5
    auto.tick()
    reps[0].depth = 0
    t[0] = 5.0
    assert auto.tick() == []
    t[0] = 12.0
    assert [e["action"] for e in auto.tick()] == ["down"]
    victim = next(r for r in reps if r.state is ReplicaState.DRAINING)
    t[0] = 13.0
    assert auto.tick() == []
    assert victim.state is ReplicaState.RETIRED
    assert fleet.fleet_counts["drains"] == 1
    assert victim.replica_id in fleet.reaped
    t[0] = 45.0
    assert [e["action"] for e in auto.tick()] == ["down"]
    assert auto.counts["scale_downs"] == 2


def test_autoscaler_chip_budget_denies_scale_up():
    fleet = _StubFleet([_ScaleReplica("p0", "prefill"),
                        _ScaleReplica("d0", "decode")])
    spawned = []
    auto = FleetAutoscaler(fleet, _spawner(spawned), clock=lambda: 0.0,
                           chip_budget=2, chips_per_replica=1)
    auto._on_alert(_firing(KIND_TTFT))
    assert auto.tick() == []
    assert auto.counts["budget_denials"] == 1 and not spawned


def test_autoscaler_never_drains_last_replica_of_a_class():
    t = [0.0]
    lone = _ScaleReplica("d0", "decode")
    auto = FleetAutoscaler(_StubFleet([lone]), _spawner([]),
                           clock=lambda: t[0], quiet_s=1.0,
                           scale_down_cooldown_s=1.0)
    lone.depth = 3
    auto.tick()
    lone.depth = 0
    for step in range(1, 20):
        t[0] = float(step * 10)
        assert auto.tick() == []
    assert auto.counts["scale_downs"] == 0
    assert lone.state is ReplicaState.HEALTHY


def test_autoscaler_alert_storm_one_action_per_window():
    t = [0.0]
    fleet = _StubFleet([_ScaleReplica("p0", "prefill"),
                        _ScaleReplica("d0", "decode")])
    spawned = []
    auto = FleetAutoscaler(fleet, _spawner(spawned), clock=lambda: t[0],
                           chip_budget=16, scale_up_cooldown_s=5.0)
    for _ in range(10):
        auto._on_alert(_firing(KIND_TTFT))
    assert len(auto.tick()) == 1
    for tick_t in (1.0, 2.0, 4.0):
        t[0] = tick_t
        auto._on_alert(_firing(KIND_TTFT))
        assert auto.tick() == []
    t[0] = 6.0
    auto._on_alert(_firing(KIND_TTFT))
    assert len(auto.tick()) == 1
    assert auto.counts["scale_ups"] == 2 and len(spawned) == 2


def test_autoscaler_actuator_fault_semantics(injector):
    t = [0.0]
    fleet = _StubFleet([_ScaleReplica("p0", "prefill"),
                        _ScaleReplica("d0", "decode")])
    spawned = []
    auto = FleetAutoscaler(fleet, _spawner(spawned), clock=lambda: t[0],
                           chip_budget=16, scale_up_cooldown_s=5.0)
    injector.add_plan("serving.fleet.scale", "fail", at=1)
    auto._on_alert(_firing(KIND_TTFT))
    assert auto.tick() == [] and not spawned
    t[0] = 1.0
    auto._on_alert(_firing(KIND_TTFT))
    assert len(auto.tick()) == 1 and len(spawned) == 1
    injector.add_plan("serving.fleet.scale", "fatal", at=3)
    t[0] = 10.0
    auto._on_alert(_firing(KIND_TTFT))
    assert auto.tick() == []
    assert auto.counts["actuator_failures"] == 1
    t[0] = 12.0
    auto._on_alert(_firing(KIND_TTFT))
    assert auto.tick() == []
    t[0] = 16.0
    auto._on_alert(_firing(KIND_TTFT))
    assert len(auto.tick()) == 1
    assert auto.counts["scale_ups"] == 2 and len(spawned) == 2


class _ObsStubReplica:
    def __init__(self, rid, role="mixed", depth=0):
        self.replica_id, self.role = rid, role
        self.queue_depth = depth
        self.state = ReplicaState.HEALTHY
        self.alive = True

    def has_work(self):
        return False


def test_autoscaler_reads_sensor_inputs_from_aggregator():
    router = types.SimpleNamespace(
        replicas=[_ObsStubReplica("m0", depth=1),
                  _ObsStubReplica("m1", depth=0)])
    auto = FleetAutoscaler(router, spawn_fn=lambda role: None,
                           clock=lambda: 0.0)
    assert isinstance(auto.aggregator, FleetMetricsAggregator)
    auto.tick(now=0.0)
    assert auto.aggregator.class_replicas("mixed", healthy_only=True) == 2
    assert auto.aggregator.class_queue_depth("mixed",
                                             healthy_only=True) == 1.0
    shared = FleetMetricsAggregator()
    router2 = types.SimpleNamespace(replicas=[], aggregator=shared)
    assert FleetAutoscaler(router2, spawn_fn=lambda role: None
                           ).aggregator is shared


# ---------------------------------------------------------------------------
# fleet trace assembler / validator, fleet metrics aggregator
# ---------------------------------------------------------------------------
def _leg(pid, tid, trace_id, t0, segs):
    out, t = [], t0
    for name, dur in segs:
        out.append({"ph": "X", "cat": "request", "pid": pid, "tid": tid,
                    "name": name, "ts": t, "dur": dur,
                    "args": {"trace_id": trace_id}})
        t += dur + 5.0
    return out


def _three_leg_events(trace_id):
    return (_leg(1000, 1, trace_id, 0.0,
                 [("queued", 10.0), ("prefill", 50.0),
                  ("fabric_publish", 5.0)])
            + _leg(1000, 2, trace_id, 100.0,
                   [("promote", 8.0), ("decode", 40.0)])
            + _leg(1000, 3, trace_id, 200.0, [("decode", 30.0)]))


def test_assembler_draws_flow_chain_across_legs():
    tid = FleetTraceContext("7").mint()
    assert tid == "fleet-7-000000"
    doc = FleetTraceAssembler().add_events(
        _three_leg_events(tid), label="rank0").assemble()
    report = validate_fleet_trace(doc)
    assert report[tid]["legs"] == 3
    flows = [e for e in doc["traceEvents"] if e.get("cat") == FLOW_CAT]
    assert len(flows) == report[tid]["flow_events"] >= 4
    assert flows[0]["ph"] == "s"
    assert flows[-1]["ph"] == "f" and flows[-1]["bp"] == "e"
    assert {e["ph"] for e in flows[1:-1]} == {"t"}
    assert len({e["id"] for e in flows}) == 1
    anchor_ts = {e["ts"] for e in flows}
    pub = next(e for e in doc["traceEvents"]
               if e.get("name") == "fabric_publish")
    pro = next(e for e in doc["traceEvents"] if e.get("name") == "promote")
    assert pub["ts"] in anchor_ts and pro["ts"] in anchor_ts


def test_assembler_single_leg_and_pid_remap():
    doc = FleetTraceAssembler().add_events(
        _leg(1000, 1, "r0-000001", 0.0,
             [("queued", 5.0), ("decode", 20.0)])).assemble()
    assert not [e for e in doc["traceEvents"] if e.get("cat") == FLOW_CAT]
    assert validate_fleet_trace(doc)["r0-000001"] == {"legs": 1,
                                                      "flow_events": 0}
    tid = "fleet-0-00000a"
    a = _leg(1000, 1, tid, 0.0, [("prefill", 50.0), ("fabric_publish", 5.0)])
    b = _leg(1000, 1, tid, 100.0, [("promote", 8.0), ("decode", 40.0)])
    doc = (FleetTraceAssembler().add_events(a, label="p0")
           .add_events(b, label="d0").assemble())
    assert {e["pid"] for e in doc["traceEvents"]
            if e.get("ph") == "X"} == {1000, 1_001_000}
    assert validate_fleet_trace(doc)[tid]["legs"] == 2
    assert doc["otherData"]["sources"] == ["p0", "d0"]


@pytest.mark.parametrize("fault", ["orphan", "endpoint", "no-chain"])
def test_validator_rejects_broken_traces(fault):
    tid = "fleet-0-00000b"
    if fault == "no-chain":
        with pytest.raises(ValueError, match="continuity"):
            validate_fleet_trace(_three_leg_events(tid))
        return
    doc = FleetTraceAssembler().add_events(_three_leg_events(tid)).assemble()
    if fault == "orphan":
        doc["traceEvents"].extend(_leg(1000, 9, tid, 400.0,
                                       [("decode", 9.0)]))
        match = "orphan"
    else:
        flow = next(e for e in doc["traceEvents"]
                    if e.get("cat") == FLOW_CAT)
        flow["ts"] = 1e9
        match = "does not resolve"
    with pytest.raises(ValueError, match=match):
        validate_fleet_trace(doc)


def test_aggregator_sums_counters_and_labels_gauges():
    agg = FleetMetricsAggregator()
    for ridx, role in enumerate(("prefill", "decode", "decode")):
        agg.add_snapshot(f"r{ridx}", {
            "dstpu_requests_total": {"kind": "counter",
                                     "value": 100.0 + ridx},
            "dstpu_serving_queue_depth": {"kind": "gauge",
                                          "value": float(ridx)},
        }, role=role)
    merged = agg.merged()
    assert merged["dstpu_requests_total"]["value"] == 303.0
    gauge = merged["dstpu_serving_queue_depth"]
    assert gauge["replicas"] == {"r0": 0.0, "r1": 1.0, "r2": 2.0}
    assert gauge["classes"] == {"prefill": 0.0, "decode": 3.0}
    prom = agg.to_prometheus()
    assert 'dstpu_serving_queue_depth{replica="r1"} 1.0' in prom
    assert 'dstpu_serving_queue_depth{fleet_class="decode"} 3.0' in prom


def test_aggregator_bucket_merge_matches_ground_truth():
    rng = random.Random(7)
    agg = FleetMetricsAggregator()
    whole = Histogram("dstpu_serving_ttft_seconds")
    for ridx in range(3):
        h = Histogram("dstpu_serving_ttft_seconds")
        for v in [rng.lognormvariate(-4.0 + ridx, 0.8) for _ in range(500)]:
            h.observe(v)
            whole.observe(v)
        agg.add_snapshot(f"r{ridx}",
                         {"dstpu_serving_ttft_seconds": hist_snapshot(h)},
                         role="decode")
    ent = agg.merged()["dstpu_serving_ttft_seconds"]
    assert ent["count"] == whole.count == 1500
    for tag, q in (("p50", 0.50), ("p95", 0.95), ("p99", 0.99)):
        assert ent[tag] == pytest.approx(whole.quantile(q))
    naive = sum(
        interpolate_quantile(*decumulate(
            agg._snapshots[f"r{i}"]["dstpu_serving_ttft_seconds"]
            ["buckets"]), 0.99) for i in range(3)) / 3
    assert naive != pytest.approx(ent["p99"], rel=0.05)
    assert math.isfinite(ent["p99"])


def test_aggregator_healthy_only_fresh_swap_and_burn():
    r1 = types.SimpleNamespace(replica_id="r1", role="decode",
                               queue_depth=4, healthy=True)
    r2 = types.SimpleNamespace(replica_id="r2", role="decode",
                               queue_depth=9, healthy=False)
    router = types.SimpleNamespace(replicas=[r1, r2])
    agg = FleetMetricsAggregator()
    assert agg.observe_router(router) == 2
    assert agg.class_queue_depth("decode") == 13.0
    assert agg.class_queue_depth("decode", healthy_only=True) == 4.0
    r3 = types.SimpleNamespace(replica_id="r3", role="prefill",
                               queue_depth=2, state=ReplicaState.HEALTHY)
    router.replicas = [r1, r3]
    assert agg.observe_router(router) == 2
    assert agg.replica_ids == ["r1", "r3"]
    assert agg.class_queue_depth(healthy_only=True) == 6.0
    burn = FleetMetricsAggregator()
    burn.add_snapshot("r0", {"dstpu_slo_tenant_a_ttft_burn_fast":
                             {"kind": "gauge", "value": 1.5}})
    burn.add_snapshot("r1", {"dstpu_slo_tenant_b_ttft_burn_fast":
                             {"kind": "gauge", "value": 3.25}})
    assert burn.burn_rate("ttft", "fast") == 3.25
    assert burn.burn_rate("itl", "fast") == 0.0


# ---------------------------------------------------------------------------
# engine-backed: the disaggregated fleet over the port's tiny GPT-2
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
    g = torch.Generator()
    g.manual_seed(23)
    pm = tt.TransformerLM(tt.gpt2_config("125m", dtype=torch.float32, **TINY))
    params = spread(pm.init(g, "cpu", torch.float32))
    jm = jax_tf.TransformerLM(jax_tf.gpt2_config("125m", dtype=jnp.float32,
                                                 **TINY))
    jeng = ds.init_inference(jm, config={
        **BASE, "replace_with_kernel_inject": False},
        params=params_to_jax(params))
    return params, jeng


def disagg_engine(params, replicas=3, prefill_replicas=1, slots=3,
                  num_kv_blocks=32, max_queue_depth=16):
    serving = {"enabled": True, "kv_block_size": 4,
               "num_kv_blocks": num_kv_blocks, "max_batch_slots": slots,
               "prefill_chunk_tokens": 8, "max_preemptions": 4,
               "max_queue_depth": max_queue_depth,
               "fleet": {"enabled": True, "replicas": replicas,
                         "prefill_replicas": prefill_replicas},
               # wire_bits 0 keeps the fabric lossless
               "host_cache": {"enabled": True, "dram_budget_bytes": 1 << 20,
                              "wire_bits": 0}}
    pm = tt.TransformerLM(tt.gpt2_config("125m", dtype=torch.float32, **TINY))
    return dt.init_inference(pm, {**BASE, "serving": serving},
                             params=params, device="cpu")


def reference(eng, jeng, prompt, n, samp):
    samp = dict(samp)
    if samp.get("temperature", 0.0) == 0.0:
        return np.asarray(jeng.generate(np.asarray(prompt, np.int32)[None],
                                        max_new_tokens=n,
                                        temperature=0.0))[0].tolist()
    return eng.generate([prompt], max_new_tokens=n, **samp)[0].tolist()


DISAGG_WAVE = [([1, 2, 3, 4, 5, 6, 7, 8, 9], dict(temperature=0.0)),
               ([10, 11, 12, 13, 14], dict(temperature=0.0)),
               ([15, 16, 17, 18, 19, 20, 21], dict(temperature=0.0)),
               ([22, 23, 24, 25, 26], dict(temperature=0.8, seed=7)),
               ([27, 28, 29, 30, 31, 32], dict(temperature=0.6, top_k=12,
                                               seed=9))]


def submit_wave(fleet, wave, n=8):
    sinks, reqs = [], []
    for prompt, samp in wave:
        sink = StreamCollector()
        sinks.append(sink)
        reqs.append(fleet.submit(prompt, max_new_tokens=n, on_token=sink,
                                 **samp))
    return reqs, sinks


def assert_wave_exact(eng, jeng, fleet, wave, reqs, sinks, n=8):
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
    device = set()
    for r in fleet.replicas:
        if r.state is ReplicaState.DEAD:
            continue
        r.srv.allocator.assert_consistent()
        assert r.srv.allocator.num_used == 0
        device |= set(r.srv.allocator._hash_to_block)
    if fleet.shared_host_cache is not None:
        fleet.shared_host_cache.assert_consistent(device_digests=device)


def test_disagg_handoff_token_exact(weights):
    params, jeng = weights
    eng = disagg_engine(params)
    fleet = FleetRouter.from_engine(eng, seed=0)
    assert [(r.replica_id, r.role) for r in fleet.replicas] == \
        [("p0", "prefill"), ("d0", "decode"), ("d1", "decode")]
    assert not fleet.replica("p0").srv.allocator.allow_claims
    reqs, sinks = submit_wave(fleet, DISAGG_WAVE)
    fleet.run()
    assert all(f.status is RequestStatus.OK for f in reqs)
    assert fleet.fleet_counts["handoffs"] == len(DISAGG_WAVE)
    assert all(f.leg == "decode" for f in reqs)
    assert {f.replica.role for f in reqs} == {"decode"}
    assert_wave_exact(eng, jeng, fleet, DISAGG_WAVE, reqs, sinks)
    p0 = fleet.replica("p0")
    assert p0.srv.fabric_counts["prefill_only_completed"] == len(DISAGG_WAVE)
    assert p0.srv.fabric_counts["published_blocks"] >= len(DISAGG_WAVE)
    assert p0.srv.fabric_counts["publish_failures"] == 0
    hc = fleet.shared_host_cache
    promoted = sum(r.srv.host_counts["promoted_blocks"]
                   for r in fleet.replicas)
    assert sum(hc.hits_total.values()) == promoted >= 1
    fleet.reap_orphans()
    assert hc.published_entries() == 0
    hc.assert_consistent()
    sink = StreamCollector()
    freq = fleet.submit(DISAGG_WAVE[0][0], max_new_tokens=8, on_token=sink)
    fleet.run()
    assert freq.leg in ("direct", "decode")
    assert freq.status is RequestStatus.OK
    assert freq.output == reference(eng, jeng, DISAGG_WAVE[0][0], 8, {})


def test_disagg_publish_faults_degrade_to_recompute(weights, injector):
    params, jeng = weights
    injector.add_plan("serving.fabric.publish", "fail", at=1, count=-1)
    eng = disagg_engine(params)
    fleet = FleetRouter.from_engine(eng, seed=0)
    wave = DISAGG_WAVE[:3]
    reqs, sinks = submit_wave(fleet, wave)
    fleet.run()
    assert all(f.status is RequestStatus.OK for f in reqs)
    assert_wave_exact(eng, jeng, fleet, wave, reqs, sinks)
    p0 = fleet.replica("p0")
    assert p0.srv.fabric_counts["publish_failures"] >= len(wave)
    assert p0.srv.fabric_counts["published_blocks"] == 0
    hc = fleet.shared_host_cache
    assert hc.published_total == 0 and hc.published_entries() == 0
    assert fleet.fleet_counts["handoffs"] == len(wave)


def test_disagg_claim_fatal_quarantines_and_recomputes(weights, injector):
    params, jeng = weights
    injector.add_plan("serving.fabric.claim", "fatal", at=1, count=1)
    eng = disagg_engine(params)
    fleet = FleetRouter.from_engine(eng, seed=0)
    wave = DISAGG_WAVE[:3]
    reqs, sinks = submit_wave(fleet, wave)
    fleet.run()
    assert all(f.status is RequestStatus.OK for f in reqs)
    assert_wave_exact(eng, jeng, fleet, wave, reqs, sinks)
    assert fleet.shared_host_cache.claim_faults_total == 1
    fleet.reap_orphans()
    assert fleet.shared_host_cache.published_entries() == 0


def test_disagg_drain_and_death_leave_no_orphans(weights):
    """A prefill worker leaving while its publishes sit unclaimed leaves
    no orphaned fabric entry: they are reaped, and the decode legs that
    wanted them recompute, still exact."""
    params, jeng = weights
    eng = disagg_engine(params, slots=2, max_queue_depth=8)
    fleet = FleetRouter.from_engine(eng, seed=0)
    hc = fleet.shared_host_cache
    p0 = fleet.replica("p0")
    busy, _ = submit_wave(
        fleet, [([40 + i, 41 + i, 42 + i], dict(temperature=0.0))
                for i in range(4)], n=12)
    target_wave = DISAGG_WAVE[:2]
    reqs, sinks = submit_wave(fleet, target_wave)
    for _ in range(64):
        if hc.published_entries(p0.srv.publisher_id) > 0:
            break
        fleet.pump()
    assert hc.published_entries(p0.srv.publisher_id) > 0
    fleet.drain(p0)
    assert p0.state is ReplicaState.RETIRED
    assert hc.published_entries(p0.srv.publisher_id) == 0
    assert fleet.fleet_counts["orphans_reaped"] >= 1
    fleet.run()
    assert all(f.status is RequestStatus.OK for f in busy + reqs)
    for (prompt, samp), f, sink in zip(target_wave, reqs, sinks):
        ref = reference(eng, jeng, prompt, 8, samp)
        assert f.output == ref and sink.tokens == ref
    device = set()
    for r in fleet.replicas:
        r.srv.allocator.assert_consistent()
        assert r.srv.allocator.num_used == 0
        device |= set(r.srv.allocator._hash_to_block)
    assert hc.published_entries() == 0
    hc.assert_consistent(device_digests=device)


def test_disagg_prefill_death_degrades_to_direct(weights, injector):
    params, jeng = weights
    eng = disagg_engine(params)
    fleet = FleetRouter.from_engine(eng, seed=0)
    injector.add_plan("serving.fleet.replica_step", "fatal", at=1)
    reqs, sinks = submit_wave(fleet, DISAGG_WAVE)
    fleet.run()
    assert fleet.replica("p0").state is ReplicaState.DEAD
    assert fleet.fleet_counts["dead_replicas"] == 1
    assert all(f.status is RequestStatus.OK for f in reqs)
    assert all(f.leg in ("direct", "decode") for f in reqs)
    assert_wave_exact(eng, jeng, fleet, DISAGG_WAVE, reqs, sinks)
    fleet.reap_orphans()
    assert fleet.shared_host_cache.published_entries() == 0


@pytest.mark.parametrize("faults", [
    "serving.fabric.publish=fail:1:2", "serving.fabric.claim=fatal:1:1",
    "serving.fleet.scale=fatal:1:1"],
    ids=["publish-transient", "claim-fatal", "scale-fatal"])
def test_disagg_chaos_plans(weights, faults):
    """The disaggregated chaos matrix: a wave with a live autoscaler in
    the loop; whatever the plan, every stream is exact, the fabric closes
    to zero orphans, and a broken scale actuator degrades to a
    statically sized fleet."""
    params, jeng = weights
    install_fault_injector(FaultInjector.from_env({"DSTPU_FAULTS": faults}))
    try:
        eng = disagg_engine(params)
        fleet = FleetRouter.from_engine(eng, seed=0)
        t = [0.0]

        def spawn(role):
            srv = ServingEngine(eng, seed=1,
                                shared_host_cache=fleet.shared_host_cache,
                                role=role)
            srv.publisher_id = f"as-{role}"
            return ReplicaHandle(f"as-{role}", srv, role=role)
        auto = FleetAutoscaler(fleet, spawn, clock=lambda: t[0],
                               chip_budget=4, scale_up_cooldown_s=1.0)
        reqs, sinks = submit_wave(fleet, DISAGG_WAVE[:3])
        fleet.pump()
        auto._on_alert(SloAlert(tenant="t0", kind=KIND_ITL, state="firing",
                                burn_fast=4.0, burn_slow=4.0, target_s=0.1,
                                at=t[0]))
        auto.tick()
        late, late_sinks = submit_wave(fleet, DISAGG_WAVE[3:])
        reqs, sinks = reqs + late, sinks + late_sinks
        fleet.run()
        assert all(f.status is RequestStatus.OK for f in reqs)
        assert_wave_exact(eng, jeng, fleet, DISAGG_WAVE, reqs, sinks)
        assert auto.counts["scale_ups"] + \
            auto.counts["actuator_failures"] == 1
        if "scale" in faults:
            assert auto.counts["actuator_failures"] == 1
        else:
            assert fleet.replica("as-decode").routable
        fleet.reap_orphans()
        assert fleet.shared_host_cache.published_entries() == 0
        fleet.shared_host_cache.assert_consistent()
    finally:
        install_fault_injector(FaultInjector())


def test_disagg_fleet_merged_trace_with_failover(weights, tmp_path,
                                                 obs_reset):
    """A two-class fleet serves a wave through the handoff, one decode
    replica is killed mid-decode, and the whole story — prefill leg,
    fabric publish, claim and promote, decode leg, failover replay —
    lands in ONE merged trace under a single fleet trace id with a
    validated flow chain; the merged fleet TTFT equals a bucket-wise
    merge of the per-replica histograms."""
    params, jeng = weights
    obs.configure(from_dict(ObservabilityConfig, {
        "tracing": {"enabled": True, "output_dir": str(tmp_path / "tr")},
        "request_tracing": {"enabled": True},
        "metrics": {"enabled": True},
        "overlap": {"enabled": True}}, "observability"), rank=0)
    eng = disagg_engine(params)
    fleet = FleetRouter.from_engine(eng, seed=0)
    wave = [DISAGG_WAVE[0], DISAGG_WAVE[1], DISAGG_WAVE[3]]
    reqs, sinks = submit_wave(fleet, wave)
    victim = None
    for _ in range(256):
        fleet.pump()
        victim = next((f for f in reqs if f.status is None
                       and f.leg == "decode" and f.replica is not None
                       and f.replica.role == "decode"
                       and f.deduper.high_water > 0), None)
        if victim is not None:
            break
    assert victim is not None, "no request reached mid-decode"
    dead = victim.replica
    dead.mark_dead("chaos: injected decode-replica death")
    fleet.run()
    assert dead.state is ReplicaState.DEAD
    assert all(f.status is RequestStatus.OK for f in reqs)
    assert victim.failovers >= 1 and victim.replica is not dead
    assert_wave_exact(eng, jeng, fleet, wave, reqs, sinks)
    path = fleet.export_fleet_trace(str(tmp_path / "fleet_trace.json"))
    with open(path) as f:
        doc = json.load(f)
    report = validate_fleet_trace(doc)
    for f in reqs:
        assert f.trace_id.startswith("fleet-") and f.trace_id in report
    assert report[victim.trace_id]["legs"] >= 3
    vev = [e for e in doc["traceEvents"]
           if (e.get("args") or {}).get("trace_id") == victim.trace_id]
    assert "fabric_publish" in {e["name"] for e in vev if e.get("ph") == "X"}
    assert {e["name"] for e in vev if e.get("ph") == "i"} >= \
        {"failover_resubmit", "terminal"}
    prom_path = str(tmp_path / "fleet.prom")
    fleet.export_fleet_metrics(prometheus_path=prom_path,
                               json_path=str(tmp_path / "fleet.json"))
    ttft = fleet.aggregator.merged()["dstpu_serving_ttft_seconds"]
    mirrors = [r._m_ttft for r in fleet.replicas]
    truth = mirrors[0].merge(*mirrors[1:])
    assert ttft["count"] == truth.count >= len(reqs)
    for tag, q in (("p50", 0.50), ("p95", 0.95), ("p99", 0.99)):
        assert ttft[tag] == pytest.approx(truth.quantile(q)), tag
    prom = open(prom_path).read()
    assert 'dstpu_fleet_replica_up{replica="' in prom
    assert 'fleet_class="decode"' in prom
    assert os.path.exists(str(tmp_path / "fleet.json"))
    assert get_overlap_profiler().recorded > 0
