"""The port's observability package, heartbeat and engine hooks against
the JAX package's.

The copied modules (``observability/{metrics,tracer,request_trace,
overlap,slo,flight_recorder}.py``, ``runtime/resilience/heartbeat.py``)
are fed one scripted sequence beside the JAX modules: counters, gauges
and histograms with exemplars, spans, a request's lifecycle, overlap
iterations, SLO samples on a synthetic clock, flight-recorder snapshots.
Prometheus text and JSON snapshots must be equal, Chrome-trace events
equal but for timestamps and durations, SLO alert transitions equal.
Then the engines: ``configure(None)`` turns everything off
(``trace_span`` returns ``NULL_SPAN``); a tiny GPT-2 trains with tracing
and metrics on (``engine/*`` spans, ``dstpu_train_steps_total``,
checkpoint counters); the server with every part on writes its spans,
request tracks, ``dstpu_serving_*`` series and heartbeat, dumps a
flight-recorder bundle on ``ServingError``, and serves the same streams
as with everything off.
"""
import json
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dt
import deepspeed_tpu.observability as jobs
import deepspeed_tpu.observability.flight_recorder as jfr
import deepspeed_tpu.observability.metrics as jmetrics
import deepspeed_tpu.observability.overlap as jovl
import deepspeed_tpu.observability.request_trace as jrt
import deepspeed_tpu.observability.slo as jslo
import deepspeed_tpu.observability.tracer as jtracer
import deepspeed_tpu.runtime.resilience.heartbeat as jhb
import deepspeed_tpu_torch.observability as pobs
import deepspeed_tpu_torch.observability.flight_recorder as pfr
import deepspeed_tpu_torch.observability.metrics as pmetrics
import deepspeed_tpu_torch.observability.overlap as povl
import deepspeed_tpu_torch.observability.request_trace as prt
import deepspeed_tpu_torch.observability.slo as pslo
import deepspeed_tpu_torch.observability.tracer as ptracer
import deepspeed_tpu_torch.runtime.resilience.heartbeat as phb
from deepspeed_tpu.runtime.config import \
    ObservabilityConfig as JaxObservabilityConfig
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.runtime.config import (DeepSpeedConfig,
                                                ObservabilityConfig)
from deepspeed_tpu_torch.runtime.config_utils import from_dict
from deepspeed_tpu_torch.runtime.resilience import (FaultInjector,
                                                    ServingError,
                                                    TransientIOError,
                                                    install_fault_injector,
                                                    retry_call)


@pytest.fixture(autouse=True)
def telemetry_off():
    """The telemetry is process-global: every test starts and ends with
    all of it off and the global registry, tracer and recorders empty."""
    def reset():
        for mod in (pobs, jobs):
            mod.configure(None)
            mod.get_registry().reset()
            mod.get_tracer().reset()
            mod.get_request_tracer().reset()
            mod.get_flight_recorder().reset()
            mod.get_overlap_profiler().reset()
    reset()
    install_fault_injector(FaultInjector())
    yield
    reset()
    install_fault_injector(FaultInjector())


# ---------------------------------------------------------------------------
# the copied modules on one script
# ---------------------------------------------------------------------------
def metric_script(mod):
    reg = mod.MetricsRegistry()
    reg.enabled = True
    c = reg.counter("dstpu_serving_tokens_total", "tokens")
    c.inc()
    c.inc(41)
    reg.gauge("dstpu_serving_queue_depth", "queue").set(3)
    reg.gauge("dstpu_serving_queue_depth").inc(2)
    h = reg.histogram("dstpu_serving_ttft_seconds", "ttft")
    for i, v in enumerate((0.0003, 0.004, 0.02, 0.3, 2.0, 75.0)):
        h.observe(v, exemplar=f"r0-{i:06x}" if i % 2 else None)
    frac = reg.histogram("dstpu_overlap_frac_dist", "frac",
                         buckets=(0.1, 0.5, 0.9, 1.0))
    for v in (0.05, 0.5, 0.95):
        frac.observe(v)
    name = mod.tenant_metric_name("dstpu_serving_tenant",
                                  'evil{x="1"}\nname', "ttft")
    reg.counter(name).inc(7)
    quantiles = [mod.interpolate_quantile((1.0, 2.0, 4.0), [1, 2, 3, 1], q)
                 for q in (0.0, 0.25, 0.5, 0.99, 1.0)]
    cum = [(b, n) for b, n in h.cumulative()]
    return (reg.to_prometheus(), json.dumps(reg.to_json(), sort_keys=True),
            quantiles, mod.decumulate(cum), mod.sanitize_name("a.b/c-d"),
            h.quantile(0.5), h.exemplars())


def test_metrics_exports_equal_jax():
    assert metric_script(pmetrics) == metric_script(jmetrics)


def _strip_times(events):
    """Chrome events without what differs run to run: timestamps,
    durations, thread ids, and the process name (package, pid)."""
    out = []
    for ev in events:
        ev = {k: v for k, v in ev.items() if k not in ("ts", "dur", "tid")}
        if ev.get("name") == "process_name" and ev["pid"] < 1000:
            ev = {k: v for k, v in ev.items() if k != "args"}
        if ev.get("name") == "thread_name" and ev["pid"] < 1000:
            continue
        out.append(ev)
    return out


def trace_script(tracer_mod, rt_mod, ovl_mod, metrics_mod):
    tracer = tracer_mod.SpanTracer(capacity=4)
    tracer.configure(enabled=True, capacity=4, rank=0)
    rt = rt_mod.RequestTraceRecorder()
    rt.configure(enabled=True, capacity=8, max_segments=4, rank=0)
    ovl = ovl_mod.OverlapProfiler()
    ovl.configure(enabled=True, capacity=4, rank=0)
    # the profiler registers its series on the package's global registry
    tracer.set_event_source("request_trace", rt.chrome_events)
    tracer.set_event_source("overlap", ovl.chrome_events)
    for i in range(6):                       # wraps the 4-span ring
        with tracer.span("serving/decode", batch=i) as s:
            s.set(tokens=2 * i)
    with tracer.span("serving/prefill_chunk", cat="serving", slot=1):
        pass
    req = SimpleNamespace(req_id="req-1", tenant="interactive",
                          prefilling=True, preemptions=0, output=[],
                          status=None, error=None)
    rt.on_submit(req)
    rt.on_admit(req, 2, 8)
    rt.on_prefill_chunk(req, 1.0, 0.5, 8, 16, done=True)
    rt.on_decode([req], 2.0, 0.1, 3)
    rt.on_spec([req], 2.5, 0.1, 3, 2)
    rt.mark(req, "quarantine", where="decode")
    rt.on_promote([req], 3.0, 0.1, 1)
    rt.on_preempt(req)
    req.output, req.status = [5, 6], SimpleNamespace(name="OK")
    rt.on_terminal(req)
    for i in range(3):
        ovl.observe("serving", total_s=0.01 * (i + 1), enqueue_s=0.002 * i,
                    wait_s=0.004, dispatches=i + 1)
    ovl.observe("train", total_s=0.2, enqueue_s=0.05, wait_s=0.1)
    return (_strip_times(tracer._events()), tracer.recorded, tracer.dropped,
            req.trace_id)


def test_tracer_request_trace_and_overlap_events_equal_jax():
    ours = trace_script(ptracer, prt, povl, pmetrics)
    theirs = trace_script(jtracer, jrt, jovl, jmetrics)
    assert ours == theirs
    names = [e.get("name") for e in ours[0]]
    assert "serving/decode" in names and "admit" in names
    assert "terminal" in names  # forced past the 4-segment cap
    assert "serving_iteration" in names and "train_iteration" in names


def test_overlap_serving_protocol():
    """begin, one ``note_dispatch`` per dispatch, end: one iteration
    record whose enqueue and wait are the dispatches' sums, clamped to
    the iteration's wall time."""
    ovl = povl.OverlapProfiler()
    ovl.configure(enabled=True, capacity=4)
    ovl.begin()
    ovl.note_dispatch(0.0, 0.0)
    ovl.note_dispatch(0.0, 0.0)
    time.sleep(0.002)
    ovl.end("serving")
    last = ovl.last()
    assert last["kind"] == "serving" and last["dispatches"] == 2
    assert last["overlap_frac"] == 1.0 and last["total_s"] >= 0.002


def slo_script(mod, metrics_mod):
    clock = [100.0]
    got = []
    mon = mod.SloMonitor(objective=0.8, fast_window_s=5.0,
                         slow_window_s=20.0, burn_threshold=1.5,
                         min_samples=3, registry=metrics_mod.MetricsRegistry(),
                         time_fn=lambda: clock[0],
                         on_alert=lambda a: got.append(a))
    script = [("batch", mod.KIND_TTFT, 0.9, 0.3)] * 5 + \
        [("interactive", mod.KIND_ITL, 0.01, 0.05)] * 4 + \
        [("batch", mod.KIND_TTFT, 0.1, 0.3)] * 12
    for tenant, kind, lat, target in script:
        clock[0] += 0.5
        mon.observe(tenant, kind, lat, target)
        mon.evaluate()
    clock[0] += 30.0
    mon.evaluate()
    return ([(a.tenant, a.kind, a.state, round(a.burn_fast, 6),
              round(a.burn_slow, 6), a.target_s, a.at) for a in got],
            mon.snapshot(), mon._registry.to_prometheus())


def test_slo_alert_transitions_equal_jax():
    ours = slo_script(pslo, pmetrics)
    assert ours == slo_script(jslo, jmetrics)
    states = [a[2] for a in ours[0]]
    assert "firing" in states and "resolved" in states


def flight_script(mod, tmp):
    fr = mod.FlightRecorder()
    fr.configure(enabled=True, capacity=3, output_dir=str(tmp),
                 max_terminal_events=2, skip_burst_steps=2, max_bundles=2)
    for i in range(5):
        fr.record({"i": i, "queue_depth": i % 2})
        fr.note_terminal({"req_id": f"req-{i}", "status": "OK"})
    bundle = fr.dump("serving_error", "scripted", extra={"why": "test"})
    files = sorted(os.listdir(bundle))
    snaps = json.load(open(os.path.join(bundle, "snapshots.json")))
    terms = json.load(open(os.path.join(bundle, "terminals.json")))
    reason = json.load(open(os.path.join(bundle, "reason.json")))
    return (files, snaps, terms, {k: reason[k] for k in
                                  ("reason", "detail", "extra", "rank")},
            fr.recorded, fr.dropped)


def test_flight_recorder_bundle_equals_jax(tmp_path):
    ours = flight_script(pfr, tmp_path / "port")
    assert ours == flight_script(jfr, tmp_path / "jax")
    assert "manifest.json" in ours[0]


def test_heartbeat_and_watchdog_equal_jax(tmp_path, monkeypatch):
    assert phb.ENV_HEARTBEAT_FILE == jhb.ENV_HEARTBEAT_FILE == \
        "DSTPU_HEARTBEAT_FILE"
    f = tmp_path / "hb"
    monkeypatch.setenv(phb.ENV_HEARTBEAT_FILE, str(f))
    hb = phb.Heartbeat(interval_s=3600.0)
    assert hb.enabled and hb.path == str(f)
    hb.maybe_beat()
    first = os.path.getmtime(f)
    os.utime(f, (first - 50, first - 50))
    hb.maybe_beat()                          # rate-limited: no beat
    assert os.path.getmtime(f) == first - 50
    for mod in (phb, jhb):
        assert mod.is_stale(str(f), 10.0) and not mod.is_stale(str(f), 60.0)
        assert mod.Watchdog(10.0).stale([str(f), str(tmp_path / "x")]) \
            == [0, 1]
    hb.beat_now()
    assert not phb.is_stale(str(f), 10.0)
    monkeypatch.delenv(phb.ENV_HEARTBEAT_FILE)
    assert not phb.Heartbeat().enabled
    assert phb.run_with_timeout(lambda: None, 5.0)
    assert not phb.run_with_timeout(lambda: time.sleep(2.0), 0.05)


def test_first_heartbeat_lands_on_a_freshly_booted_host(tmp_path,
                                                       monkeypatch):
    """``time.monotonic`` counts from boot: on a host up for less than the
    interval the first ``maybe_beat`` still writes (the beater starts at
    -inf), and the next one inside the interval does not."""
    f = tmp_path / "hb"
    clock = [5.0]
    monkeypatch.setattr(phb.time, "monotonic", lambda: clock[0])
    hb = phb.Heartbeat(path=str(f), interval_s=3600.0)
    hb.maybe_beat()
    assert f.exists()
    first = os.path.getmtime(f)
    os.utime(f, (first - 50, first - 50))
    clock[0] = 3000.0
    hb.maybe_beat()
    assert os.path.getmtime(f) == first - 50
    clock[0] = 3606.0
    hb.maybe_beat()
    assert os.path.getmtime(f) > first - 50


def test_retry_counters():
    """``retry_call`` feeds ``dstpu_io_retries_total`` and
    ``dstpu_io_retry_giveups_total`` as in the JAX package."""
    from deepspeed_tpu_torch.runtime.resilience import RetryPolicy
    reg = pobs.get_registry()
    tries = []

    def flaky():
        tries.append(1)
        if len(tries) < 3:
            raise TransientIOError("flaky")
        return "ok"
    pol = RetryPolicy(max_attempts=3, base_delay_s=0.0, max_delay_s=0.0)
    assert retry_call(flaky, policy=pol, sleep=lambda s: None) == "ok"
    with pytest.raises(TransientIOError):
        retry_call(lambda: (_ for _ in ()).throw(TransientIOError("x")),
                   policy=pol, sleep=lambda s: None)
    assert reg.counter("dstpu_io_retries_total").value == 5
    assert reg.counter("dstpu_io_retry_giveups_total").value == 1


# ---------------------------------------------------------------------------
# configure() and the config block
# ---------------------------------------------------------------------------
FULL = {"tracing": {"enabled": True, "buffer_size": 512},
        "metrics": {"enabled": True, "export_interval_steps": 2},
        "request_tracing": {"enabled": True, "capacity": 16},
        "slo": {"enabled": True, "objective": 0.95, "min_samples": 2},
        "flight": {"enabled": True, "capacity": 8},
        "overlap": {"enabled": True, "capacity": 16}}


@pytest.mark.parametrize("bad", [
    {"tracing": {"buffer_size": 0}},
    {"metrics": {"export_interval_steps": -1}},
    {"request_tracing": {"enabled": True}},
    {"slo": {"objective": 1.0}},
    {"slo": {"fast_window_s": 10.0, "slow_window_s": 5.0}},
    {"flight": {"skip_burst_steps": 0}},
    {"overlap": {"capacity": 0}},
    {"tracing": {"colour": 1}},
])
def test_config_rejects_what_jax_rejects(bad):
    with pytest.raises(ValueError):
        JaxObservabilityConfig(**bad)
    with pytest.raises(ValueError):
        from_dict(ObservabilityConfig, bad, "observability")


def test_config_defaults_match_jax():
    ours = from_dict(ObservabilityConfig, FULL, "observability")
    theirs = JaxObservabilityConfig(**FULL)
    for block in ("tracing", "metrics", "request_tracing", "slo", "flight",
                  "overlap"):
        assert vars(getattr(ours, block)) == \
            getattr(theirs, block).model_dump(), block
    assert ours.enabled and not ObservabilityConfig().enabled


def test_configure_none_turns_everything_off(tmp_path):
    cfg = from_dict(ObservabilityConfig, {
        **FULL, "tracing": {"enabled": True, "output_dir": str(tmp_path)}},
        "observability")
    tracer, reg = pobs.configure(cfg)
    parts = (tracer, pobs.get_request_tracer(), pobs.get_flight_recorder(),
             pobs.get_overlap_profiler())
    assert reg.enabled and all(p.enabled for p in parts)
    assert pobs.trace_span("x") is not pobs.NULL_SPAN
    assert pobs.slo_from_defaults() is not None
    assert "dstpu_train_steps_total" in reg.names()
    pobs.configure(None)
    assert not reg.enabled and not any(p.enabled for p in parts)
    assert pobs.trace_span("engine/train_step", step=1) is pobs.NULL_SPAN
    assert pobs.slo_from_defaults() is None


# ---------------------------------------------------------------------------
# the training engine and checkpoints
# ---------------------------------------------------------------------------
TINY = dict(num_layers=2, d_model=32, num_heads=4, vocab_size=64,
            max_seq_len=32)


def _trace_names(path):
    return {e["name"] for e in json.load(open(path))["traceEvents"]}


def test_training_spans_counters_and_checkpoints(tmp_path, monkeypatch):
    hb = tmp_path / "train.hb"
    monkeypatch.setenv("DSTPU_HEARTBEAT_FILE", str(hb))
    model = tt.TransformerLM(tt.gpt2_config("125m", dtype=torch.float32,
                                            **TINY))
    eng, *_ = dt.initialize(model=model, device="cpu", config={
        "train_batch_size": 4, "gradient_accumulation_steps": 2,
        "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
        "observability": {
            "tracing": {"enabled": True, "output_dir": str(tmp_path)},
            "metrics": {"enabled": True,
                        "prometheus_dir": str(tmp_path),
                        "export_interval_steps": 2},
            "overlap": {"enabled": True}}})
    rng = np.random.default_rng(0)
    for _ in range(3):
        ids = rng.integers(0, 64, (4, 16))
        eng.train_step({"input_ids": ids, "labels": ids})
    reg = pobs.get_registry()
    assert reg.counter("dstpu_train_steps_total").value == 3
    assert reg.histogram("dstpu_step_time_seconds").count == 3
    assert reg.histogram("dstpu_train_overlap_frac_dist").count == 3
    assert os.path.exists(tmp_path / "dstpu_rank0.prom")   # step 2 export
    assert hb.exists()
    eng.save_checkpoint(str(tmp_path / "ckpt"))
    eng.load_checkpoint(str(tmp_path / "ckpt"))
    assert reg.counter("dstpu_checkpoint_saves_total").value == 1
    assert reg.counter("dstpu_checkpoint_loads_total").value == 1
    paths = eng.flush_observability()
    names = _trace_names(paths[0])
    for span in ("engine/train_step", "engine/forward", "engine/backward",
                 "engine/optimizer_step", "engine/step_sync",
                 "checkpoint/save_state", "checkpoint/publish",
                 "checkpoint/verify", "checkpoint/load_state",
                 "train_iteration"):
        assert span in names, span
    prom = open(paths[1]).read()
    assert "dstpu_train_steps_total 3" in prom


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------
SERVING = {"enabled": True, "kv_block_size": 8, "num_kv_blocks": 48,
           "max_batch_slots": 3, "prefill_chunk_tokens": 16, "spec_k": 2}

#: every dstpu_serving_* series this slice ports (not the host cache's,
#: the fabric's or the mesh's)
SERVING_SERIES = (
    "queue_depth", "active_slots", "kv_blocks_in_use", "cached_kv_blocks",
    "kv_pool_bytes", "kv_bits", "ttft_seconds", "inter_token_seconds",
    "tokens_total", "preemptions_total", "prefix_cache_hit_tokens_total",
    "prefill_tokens_total", "prefix_cache_evictions_total",
    "cancelled_total", "timed_out_total", "shed_total", "failed_total",
    "quarantined_total", "spec_proposed_tokens_total",
    "spec_accepted_tokens_total", "spec_k", "host_plan_seconds",
    "device_wait_seconds", "overlap_frac_dist", "host_spills_total",
    "host_dram_hits_total", "host_nvme_hits_total", "host_demotions_total",
    "host_evictions_total", "host_hit_tokens_total",
    "promoted_blocks_total", "promote_failures_total",
    "spill_failures_total", "fabric_published_total",
    "fabric_publish_failures_total", "host_dram_bytes", "host_nvme_bytes",
    "promote_queue_depth")


def _server(obs, tmp_path):
    g = torch.Generator()
    g.manual_seed(5)
    pm = tt.TransformerLM(tt.gpt2_config("125m", dtype=torch.float32,
                                         **{**TINY, "max_seq_len": 64}))
    params = pm.init(g, "cpu", torch.float32)
    params = {k: (v if k != "embed" else {"embedding": v["embedding"] * 30})
              for k, v in params.items()}
    cfg = {"dtype": "float32", "max_out_tokens": 64, "temperature": 0.0,
           "serving": SERVING}
    if obs:
        cfg["observability"] = {
            "tracing": {"enabled": True, "output_dir": str(tmp_path)},
            "request_tracing": {"enabled": True},
            "metrics": {"enabled": True, "prometheus_dir": str(tmp_path)},
            "overlap": {"enabled": True},
            "flight": {"enabled": True,
                       "output_dir": str(tmp_path / "flight")}}
    eng = dt.init_inference(pm, cfg, params=params, device="cpu")
    dm = tt.TransformerLM(tt.gpt2_config(
        "125m", dtype=torch.float32, num_layers=1, d_model=16, num_heads=2,
        vocab_size=64, max_seq_len=64))
    return eng.serving_engine(draft_model=dm)


def _drain(srv):
    rs = np.random.RandomState(4)
    reqs = [srv.submit(rs.randint(0, 64, (n,)).tolist(), max_new_tokens=8,
                       tenant="t" + str(n % 2)) for n in (5, 19, 11, 30)]
    srv.run()
    return [r.output for r in reqs]


def test_serving_observability_end_to_end(tmp_path, monkeypatch):
    hb = tmp_path / "serve.hb"
    monkeypatch.setenv("DSTPU_HEARTBEAT_FILE", str(hb))
    srv = _server(True, tmp_path)
    with_obs = _drain(srv)
    assert hb.exists()
    paths = pobs.flush_all()
    events = json.load(open(paths[0]))["traceEvents"]
    names = {e["name"] for e in events}
    for span in ("serving/decode", "serving/spec_decode",
                 "serving/prefill_chunk", "serving/kv_quantize",
                 "serving/draft_pool", "serving_iteration"):
        assert span in names, span
    tracks = {e["args"]["name"] for e in events
              if e.get("name") == "thread_name" and e["pid"] >= 1000
              and e["pid"] < 2000}
    assert len(tracks) == 4 and all("[t" in t for t in tracks)
    assert {"queued", "prefill", "decode", "spec_decode", "terminal"} <= names
    prom = open(paths[1]).read()
    for series in SERVING_SERIES:
        assert f"dstpu_serving_{series}" in prom, series
    # the serving mesh's gauges read its shape: 1 x 1 here
    assert "dstpu_mesh_data_size 1" in prom
    assert "dstpu_mesh_model_size 1" in prom
    reg = pobs.get_registry()
    assert reg.counter("dstpu_serving_tokens_total").value == 32
    assert reg.histogram("dstpu_serving_ttft_seconds").count == 4
    frames = pobs.get_flight_recorder().snapshots()
    assert frames and frames[-1]["queue_depth"] == 0
    # the same streams with everything off
    pobs.configure(None)
    assert _drain(_server(False, tmp_path)) == with_obs
    # a fatal dispatch fault: ServingError and a post-mortem bundle
    pobs.configure(from_dict(ObservabilityConfig, {"flight": {
        "enabled": True, "output_dir": str(tmp_path / "flight")}},
        "observability"))
    srv = _server(False, tmp_path)
    install_fault_injector(FaultInjector()).add_plan(
        "serving.dispatch", "fatal", at=2)
    with pytest.raises(ServingError):
        _drain(srv)
    bundle = pobs.get_flight_recorder().last_bundle
    assert bundle and "fatal fault" in json.load(
        open(os.path.join(bundle, "reason.json")))["detail"]


def test_inference_config_observability_block():
    """The inference config takes the training config's block (None by
    default, then the engine leaves the telemetry alone)."""
    from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
    cfg = DeepSpeedInferenceConfig.from_dict({"observability": FULL})
    assert isinstance(cfg.observability, ObservabilityConfig)
    assert DeepSpeedInferenceConfig.from_dict({}).observability is None
    with pytest.raises(ValueError, match="request_tracing"):
        DeepSpeedInferenceConfig.from_dict(
            {"observability": {"request_tracing": {"enabled": True}}})
    assert DeepSpeedConfig({"train_batch_size": 4}).observability == \
        ObservabilityConfig()
