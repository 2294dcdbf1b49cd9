"""Unified telemetry of the port: span tracer + metrics registry.

Counterpart of ``deepspeed_tpu/observability/__init__.py``: one
process-global :class:`~.tracer.SpanTracer` and one
:class:`~.metrics.MetricsRegistry`, configured from an ``observability``
block (``runtime/config.py`` ``ObservabilityConfig``, in both the
training and the inference config) by whichever engine comes up first.
Instrumentation sites use the module helpers::

    from ..observability import trace_span, get_registry

    with trace_span("checkpoint/save_state", tag=tag):
        ...
    get_registry().counter("dstpu_io_retries_total").inc()

Span naming: ``subsystem/event`` (``engine``, ``checkpoint``,
``serving``); metric naming: Prometheus style,
``dstpu_<noun>_<unit>[_total]``.  With the block absent or disabled,
``trace_span`` is a single attribute check returning a shared no-op and
nothing here touches the device.

The fleet's metrics aggregator and trace assembler (``fleet_metrics``,
``fleet_trace``) are exported from here, as in the JAX package.
"""
from __future__ import annotations

import atexit
import os
from typing import Any, List, Tuple

from .fleet_metrics import FleetMetricsAggregator  # noqa: F401
from .fleet_trace import (FleetTraceAssembler,  # noqa: F401
                          FleetTraceContext, validate_fleet_trace)
from .flight_recorder import FlightRecorder, get_flight_recorder  # noqa: F401
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,  # noqa: F401
                      interpolate_quantile, sanitize_name,
                      tenant_metric_name)
from .overlap import OverlapProfiler, get_overlap_profiler  # noqa: F401
from .request_trace import (RequestTraceRecorder,  # noqa: F401
                            get_request_tracer)
from .slo import SloAlert, SloMonitor  # noqa: F401
from .slo import from_defaults as slo_from_defaults  # noqa: F401
from .tracer import NULL_SPAN, SpanTracer  # noqa: F401

_tracer = SpanTracer()
_registry = MetricsRegistry()
_export = {"prometheus_dir": None, "json_path": None,
           "interval_steps": 0}
_atexit_armed = False


def get_tracer() -> SpanTracer:
    return _tracer


def get_registry() -> MetricsRegistry:
    return _registry


def trace_span(name: str, cat: str = "", **args):
    """Span context manager; the disabled path is one attribute check."""
    t = _tracer
    if not t.enabled:
        return NULL_SPAN
    return t.span(name, cat, **args)


#: metrics pre-registered at configure time so the very first Prometheus
#: textfile already carries every core series (a counter that appears
#: only after its first increment breaks rate() on restart).  The JAX
#: list's program-build, rendezvous, swap-queue and backward-roofline
#: series have no counterpart in the port yet.
_CORE_METRICS = (
    ("counter", "dstpu_train_steps_total",
     "optimizer steps taken (engine train_step)"),
    ("counter", "dstpu_train_skipped_steps_total",
     "steps skipped on overflow / non-finite grad norm (resilience)"),
    ("counter", "dstpu_io_retries_total",
     "transient I/O failures retried (runtime/resilience retry_call)"),
    ("counter", "dstpu_io_retry_giveups_total",
     "I/O operations that exhausted the retry budget"),
    ("counter", "dstpu_checkpoint_saves_total", "checkpoint save calls"),
    ("counter", "dstpu_checkpoint_loads_total", "checkpoint load calls"),
    ("histogram", "dstpu_step_time_seconds",
     "synchronized train-step wall time"),
    ("gauge", "dstpu_device_peak_memory_bytes",
     "device memory high-water mark (torch.cuda.max_memory_allocated)"),
)


def _register_core_metrics() -> None:
    for kind, name, help in _CORE_METRICS:
        getattr(_registry, kind)(name, help=help)


def configure(obs_config: Any = None, rank: int = 0
              ) -> Tuple[SpanTracer, MetricsRegistry]:
    """Apply an ``ObservabilityConfig`` (or None → all off) to the
    process-global tracer/registry. Idempotent; the newest engine wins —
    telemetry is per-process, not per-engine."""
    global _atexit_armed
    from . import slo as _slo_mod
    _rt = get_request_tracer()
    _fr = get_flight_recorder()
    _ovl = get_overlap_profiler()
    if obs_config is None:
        _tracer.configure(enabled=False)
        _registry.enabled = False
        _rt.configure(enabled=False)
        _fr.configure(enabled=False)
        _ovl.configure(enabled=False)
        _slo_mod.set_defaults(enabled=False)
        return _tracer, _registry
    tr = obs_config.tracing
    mt = obs_config.metrics
    _tracer.configure(enabled=tr.enabled, capacity=tr.buffer_size,
                      output_dir=tr.output_dir, rank=rank)
    _registry.enabled = bool(mt.enabled)
    _export["prometheus_dir"] = mt.prometheus_dir
    _export["json_path"] = mt.json_path
    _export["interval_steps"] = int(mt.export_interval_steps or 0)
    if mt.enabled:
        _register_core_metrics()
    # request-scoped tracing rides the span tracer's flush as an extra
    # per-request track source (the config requires tracing.enabled)
    rt_cfg = getattr(obs_config, "request_tracing", None)
    rt_enabled = bool(rt_cfg is not None and rt_cfg.enabled)
    _rt.configure(enabled=rt_enabled,
                  capacity=rt_cfg.capacity if rt_cfg else None,
                  max_segments=rt_cfg.max_segments if rt_cfg else None,
                  rank=rank)
    _tracer.set_event_source(
        "request_trace", _rt.chrome_events if rt_enabled else None)
    # SLO burn-rate alerting defaults (the serving front end builds its
    # monitor from these via slo.from_defaults())
    slo_cfg = getattr(obs_config, "slo", None)
    if slo_cfg is not None and slo_cfg.enabled:
        _slo_mod.set_defaults(
            enabled=True, objective=slo_cfg.objective,
            fast_window_s=slo_cfg.fast_window_s,
            slow_window_s=slo_cfg.slow_window_s,
            burn_threshold=slo_cfg.burn_threshold,
            resolve_fraction=slo_cfg.resolve_fraction,
            min_samples=slo_cfg.min_samples)
    else:
        _slo_mod.set_defaults(enabled=False)
    # host/device overlap profiler: its iteration track rides the flush
    ov_cfg = getattr(obs_config, "overlap", None)
    ov_enabled = bool(ov_cfg is not None and ov_cfg.enabled)
    _ovl.configure(enabled=ov_enabled,
                   capacity=ov_cfg.capacity if ov_cfg else None,
                   rank=rank)
    _tracer.set_event_source(
        "overlap", _ovl.chrome_events if ov_enabled else None)
    # flight recorder: bounded snapshot ring + post-mortem bundles
    fl_cfg = getattr(obs_config, "flight", None)
    fl_enabled = bool(fl_cfg is not None and fl_cfg.enabled)
    _fr.configure(enabled=fl_enabled,
                  capacity=fl_cfg.capacity if fl_cfg else None,
                  output_dir=fl_cfg.output_dir if fl_cfg else None,
                  max_terminal_events=(fl_cfg.max_terminal_events
                                       if fl_cfg else None),
                  skip_burst_steps=(fl_cfg.skip_burst_steps
                                    if fl_cfg else None),
                  max_bundles=fl_cfg.max_bundles if fl_cfg else None,
                  rank=rank)
    if (tr.enabled or mt.enabled) and not _atexit_armed:
        atexit.register(flush_all)
        _atexit_armed = True
    return _tracer, _registry


def export_metrics() -> List[str]:
    """Write the configured metric exports (Prometheus textfile + JSON)."""
    if not _registry.enabled:
        return []
    paths: List[str] = []
    if _export["prometheus_dir"]:
        paths.append(_registry.export_prometheus(os.path.join(
            _export["prometheus_dir"], f"dstpu_rank{_tracer.rank}.prom")))
    if _export["json_path"]:
        paths.append(_registry.export_json(_export["json_path"]))
    return paths


def export_interval_steps() -> int:
    return _export["interval_steps"]


def flush_all(sync: Any = None) -> List[str]:
    """Flush trace + metric exports. ``sync`` — optional device tensor to
    join first (the explicit flush-boundary sync)."""
    paths: List[str] = []
    if _tracer.enabled:
        paths.append(_tracer.flush(sync=sync))
    paths.extend(export_metrics())
    return paths
