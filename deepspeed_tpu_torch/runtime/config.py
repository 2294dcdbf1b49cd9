"""Master training configuration of the port.

Counterpart of ``deepspeed_tpu/runtime/config.py``: the same DeepSpeed
JSON keys, defaults and validation messages, on ``dataclasses`` built by
``runtime/config_utils.py``.  The batch triple follows the same rule:

    train_batch_size == micro_batch_per_device * gradient_accumulation_steps
                        * data_parallel_world_size

given any two, the third is inferred; all three given must agree.

Blocks it parses but does not run are refused by
:meth:`DeepSpeedConfig.refuse_out_of_slice` (the engine calls it) with
``NotImplementedError`` naming the ``ROADMAP.md`` queue A part that
brings them: the ``sequence`` mesh axis, sequence parallelism, the
1-bit optimizers, offload at a data-parallel size above 1 (the
``expert`` axis counts in it), and the monitor blocks; ZeRO-Infinity
(``offload_param``) over a model or pipe axis raises the JAX engine's
own refusal.  Data parallelism with ZeRO stages 0-3, expert parallelism
(the ``expert`` axis: an MoE model's expert stacks cut over it, a dense
model's batch sharded over it as over one more data axis), tensor
parallelism (the ``model`` axis, or ``tensor_parallel.tp_size``, which
sets it) and pipeline parallelism (the ``pipe`` axis,
``runtime/pipe/``) run at every stage and compose.  The offload blocks run (``runtime/zero/offload.py``,
``runtime/zero/infinity.py``), at ZeRO stage 1-3 and a data-parallel
size of 1: ZeRO-Offload also over a model or pipe axis (each rank's
host optimizer steps its own slice).  The ``observability`` block
(span tracer, metrics, flight recorder, overlap profiler) runs.
``fp16`` trains (dynamic or static loss scaling, ``runtime/fp16``).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from . import constants as C
from .config_utils import dict_raise_error_on_duplicate_keys, from_dict


# -- precision ---------------------------------------------------------------------
@dataclass
class FP16Config:
    enabled: bool = False
    auto_cast: bool = False
    loss_scale: float = C.FP16_LOSS_SCALE_DEFAULT  # 0 => dynamic
    initial_scale_power: int = C.FP16_INITIAL_SCALE_POWER_DEFAULT
    loss_scale_window: int = C.FP16_LOSS_SCALE_WINDOW_DEFAULT
    hysteresis: int = C.FP16_HYSTERESIS_DEFAULT
    min_loss_scale: float = C.FP16_MIN_LOSS_SCALE_DEFAULT

    @property
    def dynamic(self) -> bool:
        return self.enabled and self.loss_scale == 0


@dataclass
class BF16Config:
    """bf16 compute over f32 master params (``master_weights``)."""
    enabled: bool = False
    master_weights: bool = True


# -- ZeRO --------------------------------------------------------------------------------
_OFFLOAD_DEVICES = ("none", "cpu", "nvme")


@dataclass
class OffloadParamConfig:
    """``zero_optimization.offload_param`` (the JAX package's
    ``DeepSpeedZeroOffloadParamConfig``)."""
    device: str = "none"
    nvme_path: Optional[str] = None
    buffer_count: int = 5
    buffer_size: int = int(1e8)
    max_in_cpu: int = int(1e9)
    pin_memory: bool = False


@dataclass
class OffloadOptimizerConfig:
    """``zero_optimization.offload_optimizer`` (the JAX package's
    ``DeepSpeedZeroOffloadOptimizerConfig``); ``worker_count``: host
    optimizer-sweep threads, 0 = one per host core up to 8."""
    device: str = "none"
    nvme_path: Optional[str] = None
    buffer_count: int = 4
    pin_memory: bool = False
    pipeline_read: bool = False
    pipeline_write: bool = False
    fast_init: bool = False
    worker_count: int = 0


@dataclass
class ZeroConfig:
    """``zero_optimization`` block.  Stage 0 runs on one device, and
    stages 1-3 with an offload block (one device: the same program); the
    offload sub-blocks are kept as dicts (:meth:`offload` parses one)."""
    stage: int = 0
    contiguous_gradients: bool = True
    reduce_scatter: bool = True
    reduce_bucket_size: int = int(5e8)
    allgather_partitions: bool = True
    allgather_bucket_size: int = int(5e8)
    overlap_comm: Optional[bool] = None
    load_from_fp32_weights: bool = True
    elastic_checkpoint: bool = False
    offload_param: Optional[Dict[str, Any]] = None
    offload_optimizer: Optional[Dict[str, Any]] = None
    sub_group_size: int = int(1e9)
    cpu_offload: Optional[bool] = None
    cpu_offload_params: Optional[bool] = None
    prefetch_bucket_size: int = int(5e7)
    param_persistence_threshold: int = int(1e5)
    model_persistence_threshold: int = int(1e14)
    max_live_parameters: int = int(1e9)
    max_reuse_distance: int = int(1e9)
    gather_16bit_weights_on_model_save: bool = False
    ignore_unused_parameters: bool = True
    legacy_stage1: bool = False
    round_robin_gradients: bool = False
    zero_hpz_partition_size: int = 1
    stage3_scan_layers: int = 0
    infinity_host_init: bool = False
    offload_wire_bits: int = 0
    offload_param_bits: int = 0

    def __post_init__(self):
        if not 0 <= self.stage <= 3:
            raise ValueError(
                f"zero_optimization.stage must be 0..3, got {self.stage}")
        if self.offload_param_bits not in (0, 4, 8):
            raise ValueError(
                f"zero_optimization.offload_param_bits must be 0, 4 or 8; "
                f"got {self.offload_param_bits}")
        if self.offload_wire_bits not in (0, 1, 4, 8):
            raise ValueError(
                f"zero_optimization.offload_wire_bits must be 0, 1, 4 or "
                f"8; got {self.offload_wire_bits}")
        for name in ("offload_param", "offload_optimizer"):
            block = getattr(self, name)
            if block is None:
                continue
            if not isinstance(block, dict):
                raise ValueError(f"zero_optimization.{name}: expected a "
                                 f"JSON object")
            dev = block.get("device", "none")
            if dev not in _OFFLOAD_DEVICES:
                raise ValueError(f"zero_optimization.{name}.device must be "
                                 f"one of {list(_OFFLOAD_DEVICES)}, got "
                                 f"{dev!r}")

    def offload_device(self, name: str) -> str:
        """The device an offload sub-block names ("none" when absent);
        the deprecated ``cpu_offload``/``cpu_offload_params`` aliases
        count as "cpu"."""
        block = getattr(self, name)
        alias = (self.cpu_offload if name == "offload_optimizer"
                 else self.cpu_offload_params)
        if block is None:
            return "cpu" if alias else "none"
        return block.get("device", "none")

    def offload(self, name: str):
        """The parsed ``offload_param`` / ``offload_optimizer`` block
        (its device from :meth:`offload_device`, so the deprecated
        aliases count)."""
        cls = (OffloadParamConfig if name == "offload_param"
               else OffloadOptimizerConfig)
        block = dict(getattr(self, name) or {})
        block["device"] = self.offload_device(name)
        return from_dict(cls, block, f"zero_optimization.{name}")


# -- optimizer / scheduler --------------------------------------------------------
@dataclass
class OptimizerConfig:
    type: str = "AdamW"
    params: Dict[str, Any] = field(default_factory=dict)
    legacy_fusion: bool = False


@dataclass
class SchedulerConfig:
    type: str = "WarmupLR"
    params: Dict[str, Any] = field(default_factory=dict)


# -- checkpointing ----------------------------------------------------------------------
@dataclass
class AioConfig:
    """``aio`` block: the NVMe tier's IO handle (the JAX package's
    ``AioConfig``)."""
    block_size: int = 1048576
    queue_depth: int = 8
    thread_count: int = 1
    single_submit: bool = False
    overlap_events: bool = True


@dataclass
class CheckpointConfig:
    """``checkpoint`` block (the JAX package's ``CheckpointConfig``):
    ``tag_validation`` (Ignore | Warn | Fail) when a load finds no
    ``latest``, and ``async_save`` (a writer thread commits the state;
    ``meta.json`` and ``latest`` wait for it).  The other keys parse for
    schema parity."""
    tag_validation: str = "Warn"
    load_universal: bool = False
    use_node_local_storage: bool = False
    parallel_write_pipeline: bool = False
    async_save: bool = False

    def __post_init__(self):
        if self.tag_validation.lower() not in ("ignore", "warn", "fail"):
            raise ValueError(
                f"checkpoint.tag_validation must be Ignore, Warn or Fail, "
                f"got {self.tag_validation!r}")


# -- topology ---------------------------------------------------------------------------
@dataclass
class MeshConfig:
    """Named-axis device mesh; -1 absorbs the remaining devices (``data``
    defaults to -1).  On one device every axis resolves to 1."""
    data: int = -1
    model: int = 1
    pipe: int = 1
    expert: int = 1
    sequence: int = 1
    dcn_data: int = 1

    def sizes(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model, "pipe": self.pipe,
                "expert": self.expert, "sequence": self.sequence,
                "dcn_data": self.dcn_data}


@dataclass
class PipelineConfig:
    stages: Any = C.PIPE_STAGES_DEFAULT
    partition: str = "parameters"
    seed_layers: bool = False
    activation_checkpoint_interval: int = 0
    pipe_partitioned: bool = True
    grad_partitioned: bool = True
    micro_batches: Optional[int] = None
    schedule: str = C.PIPE_SCHEDULE_DEFAULT

    def __post_init__(self):
        s = self.stages
        if isinstance(s, str) and s != "auto":
            if not s.isdigit():
                raise ValueError(
                    f"pipeline.stages must be 'auto' or a positive int, "
                    f"got {s!r}")
            self.stages = int(s)
        if isinstance(self.stages, int) and self.stages < 1:
            raise ValueError(
                f"pipeline.stages must be >= 1, got {self.stages}")
        if self.schedule not in C.PIPE_SCHEDULES:
            raise ValueError(
                f"pipeline.schedule must be one of {C.PIPE_SCHEDULES}, "
                f"got {self.schedule!r}")


@dataclass
class SequenceParallelConfig:
    enabled: bool = False
    mode: str = "ring"
    axis: str = "sequence"


@dataclass
class TensorParallelConfig:
    enabled: bool = False
    tp_size: int = 1
    autotp_size: int = 0

    def degree(self) -> int:
        """The model-axis size this block asks for (1 when disabled).
        The port lays either size out by the model's Megatron
        ``partition_specs``; the JAX engine takes its layout from the
        mesh alone."""
        return max(self.tp_size, self.autotp_size) if self.enabled else 1


# -- monitors -----------------------------------------------------------------------
@dataclass
class TensorBoardConfig:
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedTPUJobName"


@dataclass
class WandbConfig:
    enabled: bool = False
    group: Optional[str] = None
    team: Optional[str] = None
    project: str = "deepspeed_tpu"


@dataclass
class CSVConfig:
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedTPUJobName"


@dataclass
class MonitorConfig:
    tensorboard: TensorBoardConfig = field(default_factory=TensorBoardConfig)
    wandb: WandbConfig = field(default_factory=WandbConfig)
    csv_monitor: CSVConfig = field(default_factory=CSVConfig)

    @property
    def enabled(self) -> bool:
        return (self.tensorboard.enabled or self.wandb.enabled
                or self.csv_monitor.enabled)


# -- resilience ---------------------------------------------------------------------
@dataclass
class ResilienceConfig:
    """``resilience`` block.  The training step reads
    ``skip_nonfinite_grad_steps``; the checkpoint, retry, liveness and
    fault-injection keys parse for schema parity."""
    checkpoint_integrity: bool = C.RESILIENCE_CHECKPOINT_INTEGRITY_DEFAULT
    verify_on_save: bool = C.RESILIENCE_VERIFY_ON_SAVE_DEFAULT
    fallback_to_last_good: bool = C.RESILIENCE_FALLBACK_DEFAULT
    io_retry_attempts: int = C.RESILIENCE_IO_RETRY_ATTEMPTS_DEFAULT
    io_retry_base_delay_s: float = C.RESILIENCE_IO_RETRY_BASE_DELAY_DEFAULT
    io_retry_max_delay_s: float = C.RESILIENCE_IO_RETRY_MAX_DELAY_DEFAULT
    io_retry_jitter: float = C.RESILIENCE_IO_RETRY_JITTER_DEFAULT
    skip_nonfinite_grad_steps: bool = C.RESILIENCE_SKIP_NONFINITE_DEFAULT
    heartbeat_interval_s: float = C.RESILIENCE_HEARTBEAT_INTERVAL_DEFAULT
    watchdog_timeout_s: float = C.RESILIENCE_WATCHDOG_TIMEOUT_DEFAULT
    fault_injection: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if self.io_retry_attempts < 1:
            raise ValueError(
                f"resilience.io_retry_attempts must be >= 1, got "
                f"{self.io_retry_attempts}")
        if self.io_retry_base_delay_s < 0 or \
                self.io_retry_max_delay_s < self.io_retry_base_delay_s:
            raise ValueError(
                "resilience: need 0 <= io_retry_base_delay_s <= "
                f"io_retry_max_delay_s, got {self.io_retry_base_delay_s}/"
                f"{self.io_retry_max_delay_s}")
        if not 0.0 <= self.io_retry_jitter <= 1.0:
            raise ValueError(
                f"resilience.io_retry_jitter must be in [0, 1], got "
                f"{self.io_retry_jitter}")
        if self.watchdog_timeout_s < 0 or self.heartbeat_interval_s <= 0:
            raise ValueError(
                "resilience: watchdog_timeout_s must be >= 0 (0 disables) "
                "and heartbeat_interval_s > 0")
        if self.watchdog_timeout_s and \
                self.watchdog_timeout_s < 2 * self.heartbeat_interval_s:
            raise ValueError(
                f"resilience.watchdog_timeout_s "
                f"({self.watchdog_timeout_s}) must be at least twice "
                f"heartbeat_interval_s ({self.heartbeat_interval_s}) or a "
                f"healthy worker one beat behind gets killed")


# -- observability ------------------------------------------------------------------
@dataclass
class TracingConfig:
    """``observability.tracing`` — host-side span tracer
    (``observability/tracer.py``): spans record into a preallocated ring
    and export as Chrome trace-event JSON (Perfetto-loadable)."""
    enabled: bool = C.OBSERVABILITY_TRACING_ENABLED_DEFAULT
    # ring capacity in spans; oldest spans are overwritten on wraparound
    buffer_size: int = C.OBSERVABILITY_TRACE_BUFFER_DEFAULT
    # directory for per-process trace_rank<r>.json files
    output_dir: str = C.OBSERVABILITY_TRACE_DIR_DEFAULT

    def __post_init__(self):
        if self.buffer_size < 1:
            raise ValueError(
                f"observability.tracing.buffer_size must be >= 1, got "
                f"{self.buffer_size}")


@dataclass
class ObsMetricsConfig:
    """``observability.metrics`` — counter/gauge/histogram registry with
    Prometheus-textfile and JSON exporters (``observability/metrics.py``)."""
    enabled: bool = C.OBSERVABILITY_METRICS_ENABLED_DEFAULT
    # node_exporter textfile-collector directory (dstpu_rank<r>.prom)
    prometheus_dir: Optional[str] = C.OBSERVABILITY_PROMETHEUS_DIR_DEFAULT
    # JSON snapshot path
    json_path: Optional[str] = C.OBSERVABILITY_JSON_PATH_DEFAULT
    # export every N steps (0 = only at flush/close/atexit)
    export_interval_steps: int = C.OBSERVABILITY_EXPORT_INTERVAL_DEFAULT

    def __post_init__(self):
        if self.export_interval_steps < 0:
            raise ValueError(
                f"observability.metrics.export_interval_steps must be "
                f">= 0, got {self.export_interval_steps}")


@dataclass
class RequestTracingConfig:
    """``observability.request_tracing`` — per-request serving timelines
    (``observability/request_trace.py``), exported as a Perfetto track per
    request inside the span tracer's ``trace_rank<r>.json``.  Requires
    ``tracing.enabled``."""
    enabled: bool = C.OBSERVABILITY_REQUEST_TRACE_ENABLED_DEFAULT
    # retained request timelines; oldest completed evicted first
    capacity: int = C.OBSERVABILITY_REQUEST_TRACE_CAPACITY_DEFAULT
    # stamped segments per request before drops are counted
    max_segments: int = C.OBSERVABILITY_REQUEST_TRACE_SEGMENTS_DEFAULT

    def __post_init__(self):
        if self.capacity < 1 or self.max_segments < 1:
            raise ValueError(
                "observability.request_tracing: capacity and max_segments "
                f"must be >= 1, got {self.capacity}/{self.max_segments}")


@dataclass
class SloConfig:
    """``observability.slo`` — per-tenant multi-window burn-rate alerting
    over the TTFT / inter-token SLOs declared in ``TenantSpec``
    (``observability/slo.py``)."""
    enabled: bool = C.OBSERVABILITY_SLO_ENABLED_DEFAULT
    objective: float = C.OBSERVABILITY_SLO_OBJECTIVE_DEFAULT
    fast_window_s: float = C.OBSERVABILITY_SLO_FAST_WINDOW_DEFAULT
    slow_window_s: float = C.OBSERVABILITY_SLO_SLOW_WINDOW_DEFAULT
    burn_threshold: float = C.OBSERVABILITY_SLO_BURN_THRESHOLD_DEFAULT
    # firing -> resolved once fast burn < threshold * resolve_fraction
    resolve_fraction: float = C.OBSERVABILITY_SLO_RESOLVE_FRACTION_DEFAULT
    # fast-window observations required before an alert may fire
    min_samples: int = C.OBSERVABILITY_SLO_MIN_SAMPLES_DEFAULT

    def __post_init__(self):
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"observability.slo.objective must be in (0, 1), got "
                f"{self.objective}")
        if self.fast_window_s <= 0 or \
                self.slow_window_s < self.fast_window_s:
            raise ValueError(
                "observability.slo: need 0 < fast_window_s <= "
                f"slow_window_s, got {self.fast_window_s}/"
                f"{self.slow_window_s}")
        if self.burn_threshold <= 0 or self.min_samples < 1:
            raise ValueError(
                "observability.slo: burn_threshold must be > 0 and "
                f"min_samples >= 1, got {self.burn_threshold}/"
                f"{self.min_samples}")
        if not 0.0 <= self.resolve_fraction <= 1.0:
            raise ValueError(
                f"observability.slo.resolve_fraction must be in [0, 1], "
                f"got {self.resolve_fraction}")


@dataclass
class FlightRecorderConfig:
    """``observability.flight`` — black-box flight recorder
    (``observability/flight_recorder.py``): a bounded ring of
    per-iteration engine snapshots dumped as a manifest-sealed
    post-mortem bundle on ``ServingError`` or a skipped-step burst."""
    enabled: bool = C.OBSERVABILITY_FLIGHT_ENABLED_DEFAULT
    capacity: int = C.OBSERVABILITY_FLIGHT_CAPACITY_DEFAULT
    output_dir: str = C.OBSERVABILITY_FLIGHT_DIR_DEFAULT
    max_terminal_events: int = C.OBSERVABILITY_FLIGHT_TERMINALS_DEFAULT
    # consecutive skipped train steps that trip a post-mortem dump
    skip_burst_steps: int = C.OBSERVABILITY_FLIGHT_SKIP_BURST_DEFAULT
    max_bundles: int = C.OBSERVABILITY_FLIGHT_MAX_BUNDLES_DEFAULT

    def __post_init__(self):
        if self.capacity < 1 or self.max_terminal_events < 1 \
                or self.max_bundles < 1:
            raise ValueError(
                "observability.flight: capacity, max_terminal_events and "
                "max_bundles must be >= 1, got "
                f"{self.capacity}/{self.max_terminal_events}/"
                f"{self.max_bundles}")
        if self.skip_burst_steps < 1:
            raise ValueError(
                f"observability.flight.skip_burst_steps must be >= 1, got "
                f"{self.skip_burst_steps}")


@dataclass
class OverlapConfig:
    """``observability.overlap`` — host/device overlap profiler
    (``observability/overlap.py``): splits each serving iteration and
    training step into host planning, enqueue and device wait from
    clock reads the engines already make (no new device syncs)."""
    enabled: bool = C.OBSERVABILITY_OVERLAP_ENABLED_DEFAULT
    # per-iteration records retained for the trace track
    capacity: int = C.OBSERVABILITY_OVERLAP_CAPACITY_DEFAULT

    def __post_init__(self):
        if self.capacity < 1:
            raise ValueError(
                f"observability.overlap.capacity must be >= 1, got "
                f"{self.capacity}")


@dataclass
class ObservabilityConfig:
    """``observability`` block (``observability/``), the same schema in
    the training and the inference config."""
    tracing: TracingConfig = field(default_factory=TracingConfig)
    metrics: ObsMetricsConfig = field(default_factory=ObsMetricsConfig)
    request_tracing: RequestTracingConfig = field(
        default_factory=RequestTracingConfig)
    slo: SloConfig = field(default_factory=SloConfig)
    flight: FlightRecorderConfig = field(
        default_factory=FlightRecorderConfig)
    overlap: OverlapConfig = field(default_factory=OverlapConfig)

    def __post_init__(self):
        if self.request_tracing.enabled and not self.tracing.enabled:
            raise ValueError(
                "observability.request_tracing.enabled requires "
                "observability.tracing.enabled — the per-request "
                "waterfall exports inside the span tracer's Chrome trace")

    @property
    def enabled(self) -> bool:
        return (self.tracing.enabled or self.metrics.enabled
                or self.request_tracing.enabled or self.slo.enabled
                or self.flight.enabled or self.overlap.enabled)


# -- training hot path --------------------------------------------------------------
#: remat policies the JAX model accepts (the port runs them all;
#: "host_offload" keeps each superblock's input in pinned host memory)
TRAINING_REMAT_POLICIES = ("none", "full", "dots_saveable",
                           "dots_no_batch", "nothing_saveable",
                           "host_offload")


@dataclass
class TrainingConfig:
    """``training`` block: per-run overrides of the model's hot-path
    knobs (None = keep the model config's setting), applied by the
    engine when it is built."""
    remat: Optional[str] = C.TRAINING_REMAT_DEFAULT
    fused_loss_head: Optional[bool] = C.TRAINING_FUSED_LOSS_HEAD_DEFAULT
    loss_chunk: Optional[int] = C.TRAINING_LOSS_CHUNK_DEFAULT
    donate_batch: bool = C.TRAINING_DONATE_BATCH_DEFAULT

    def __post_init__(self):
        if self.remat is not None and \
                self.remat not in TRAINING_REMAT_POLICIES:
            raise ValueError(
                f"training.remat must be one of "
                f"{list(TRAINING_REMAT_POLICIES)}, got {self.remat!r}")
        if self.loss_chunk is not None and self.loss_chunk < 0:
            raise ValueError(
                f"training.loss_chunk must be >= 0 (0 = dense), got "
                f"{self.loss_chunk}")

    def model_overrides(self) -> Dict[str, Any]:
        """The non-None model-config overrides this block carries."""
        return {k: getattr(self, k)
                for k in ("remat", "fused_loss_head", "loss_chunk")
                if getattr(self, k) is not None}


def _block(cls, pd: dict, key: str):
    return from_dict(cls, pd.get(key), key)


# -- master config --------------------------------------------------------------------
#: mesh axes whose size above 1 a later part of queue A item 7 brings,
#: with that part
_LATER_AXES = (("sequence", "ring and Ulysses sequence parallelism "
                             "(queue A item 7 part 6)"),)


class DeepSpeedConfig:
    """Parses the master dict (or a JSON path) and exposes the typed
    blocks, as the JAX ``DeepSpeedConfig`` does."""

    def __init__(self, config: Any, world_size: Optional[int] = None):
        if isinstance(config, str):
            with open(config, "r") as f:
                self._param_dict = json.load(
                    f, object_pairs_hook=dict_raise_error_on_duplicate_keys)
        elif isinstance(config, dict):
            self._param_dict = dict(config)
        else:
            raise ValueError(
                f"Expected a dict or a json path, got {type(config)}")
        self._world_size = world_size
        self._initialize_params(self._param_dict)
        self._configure_train_batch_size()
        self._do_sanity_check()

    def _initialize_params(self, pd: dict) -> None:
        g = pd.get
        self.train_batch_size = g(C.TRAIN_BATCH_SIZE,
                                  C.TRAIN_BATCH_SIZE_DEFAULT)
        self.train_micro_batch_size_per_gpu = g(
            C.TRAIN_MICRO_BATCH_SIZE_PER_GPU,
            C.TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT)
        self.gradient_accumulation_steps = g(
            C.GRADIENT_ACCUMULATION_STEPS,
            C.GRADIENT_ACCUMULATION_STEPS_DEFAULT)
        self.steps_per_print = g(C.STEPS_PER_PRINT, C.STEPS_PER_PRINT_DEFAULT)
        self.dump_state = g(C.DUMP_STATE, False)
        self.gradient_clipping = g(C.GRADIENT_CLIPPING,
                                   C.GRADIENT_CLIPPING_DEFAULT)
        # legacy DeepSpeed alias: top-level max_grad_norm == gradient_clipping
        mgn = g(C.MAX_GRAD_NORM)
        if mgn is not None:
            if C.GRADIENT_CLIPPING in pd and pd[C.GRADIENT_CLIPPING] != mgn:
                raise ValueError(
                    f"both {C.GRADIENT_CLIPPING} "
                    f"({pd[C.GRADIENT_CLIPPING]}) and its legacy alias "
                    f"{C.MAX_GRAD_NORM} ({mgn}) are set and disagree")
            self.gradient_clipping = mgn
        amp = g(C.AMP) or {}
        amp_on = (amp.get("enabled", False) if isinstance(amp, dict)
                  else bool(amp))
        if amp_on:
            raise NotImplementedError(
                "amp (apex) is CUDA-specific and not supported on TPU — "
                "use bf16: {enabled: true} (native) or fp16 with dynamic "
                "loss scaling instead")
        self.prescale_gradients = g(C.PRESCALE_GRADIENTS,
                                    C.PRESCALE_GRADIENTS_DEFAULT)
        self.gradient_predivide_factor = g(
            C.GRADIENT_PREDIVIDE_FACTOR, C.GRADIENT_PREDIVIDE_FACTOR_DEFAULT)
        self.sparse_gradients_enabled = g(C.SPARSE_GRADIENTS,
                                          C.SPARSE_GRADIENTS_DEFAULT)
        self.wall_clock_breakdown = g(C.WALL_CLOCK_BREAKDOWN,
                                      C.WALL_CLOCK_BREAKDOWN_DEFAULT)
        self.communication_data_type = g(C.COMMUNICATION_DATA_TYPE)
        self.disable_allgather = g(C.DISABLE_ALLGATHER, False)
        self.memory_breakdown = g(C.MEMORY_BREAKDOWN, False)

        self.fp16 = _block(FP16Config, pd, C.FP16)
        self.bf16 = _block(BF16Config, pd, C.BF16)
        self.zero_config = _block(ZeroConfig, pd, C.ZERO_OPTIMIZATION)
        self.optimizer = (_block(OptimizerConfig, pd, C.OPTIMIZER)
                          if C.OPTIMIZER in pd else None)
        self.scheduler = (_block(SchedulerConfig, pd, C.SCHEDULER)
                          if C.SCHEDULER in pd else None)
        self.mesh = _block(MeshConfig, pd, C.MESH)
        self.pipeline = _block(PipelineConfig, pd, C.PIPELINE)
        self.sequence_parallel = _block(SequenceParallelConfig, pd,
                                        C.SEQUENCE_PARALLEL)
        self.tensor_parallel = _block(TensorParallelConfig, pd,
                                      C.TENSOR_PARALLEL)
        self.monitor = MonitorConfig(
            tensorboard=_block(TensorBoardConfig, pd, C.MONITOR_TENSORBOARD),
            wandb=_block(WandbConfig, pd, C.MONITOR_WANDB),
            csv_monitor=_block(CSVConfig, pd, C.MONITOR_CSV))
        self.resilience = _block(ResilienceConfig, pd, C.RESILIENCE)
        self.training = _block(TrainingConfig, pd, C.TRAINING)
        self.observability = _block(ObservabilityConfig, pd,
                                    C.OBSERVABILITY)
        # blocks whose subsystems are later slices: kept as given
        self.activation_checkpointing_dict = g(C.ACTIVATION_CHECKPOINTING)
        self.flops_profiler_dict = g(C.FLOPS_PROFILER)
        self.checkpoint_config = _block(CheckpointConfig, pd, C.CHECKPOINT)
        self.comms_logger_dict = g(C.COMMS_LOGGER)
        self.aio_dict = g(C.AIO)
        self.aio = _block(AioConfig, pd, C.AIO)
        self.elasticity_dict = g(C.ELASTICITY)
        self.autotuning_dict = g(C.AUTOTUNING)
        self.compression_dict = g(C.COMPRESSION_TRAINING)
        self.data_efficiency_dict = g(C.DATA_EFFICIENCY)
        self.curriculum_learning_legacy = g(C.CURRICULUM_LEARNING_LEGACY)

    @property
    def zero_enabled(self) -> bool:
        return self.zero_config.stage > 0

    @property
    def zero_optimization_stage(self) -> int:
        return self.zero_config.stage

    @property
    def precision_dtype(self) -> str:
        if self.bf16.enabled:
            return "bfloat16"
        if self.fp16.enabled:
            return "float16"
        return "float32"

    # -- batch reconciliation -------------------------------------------------
    def _configure_train_batch_size(self) -> None:
        if not hasattr(self, "_user_batch_triple"):
            self._user_batch_triple = (self.train_batch_size,
                                       self.train_micro_batch_size_per_gpu,
                                       self.gradient_accumulation_steps)
        tb, mb, gas = self._user_batch_triple
        ws = self._world_size

        def _exact_div(num, den, what):
            if num % den != 0:
                raise ValueError(
                    f"train_batch_size ({num}) is not divisible by {what} "
                    f"({den}); the triple train_batch = micro_batch * "
                    f"gradient_accumulation_steps * dp_world must hold exactly")
            return num // den

        if ws is not None:
            if tb is not None and mb is not None and gas is not None:
                if tb != mb * gas * ws:
                    raise ValueError(
                        f"train_batch_size ({tb}) != micro_batch ({mb}) * "
                        f"gradient_accumulation_steps ({gas}) * dp_world ({ws})")
            elif tb is not None and mb is not None:
                gas = _exact_div(tb, mb * ws, "micro_batch * dp_world")
            elif tb is not None and gas is not None:
                mb = _exact_div(tb, gas * ws,
                                "gradient_accumulation_steps * dp_world")
            elif mb is not None and gas is not None:
                tb = mb * gas * ws
            elif tb is not None:
                gas = 1
                mb = _exact_div(tb, ws, "dp_world")
            elif mb is not None:
                gas = 1
                tb = mb * ws
            else:
                raise ValueError(
                    "Need at least train_batch_size or "
                    "train_micro_batch_size_per_gpu in config")
        else:
            if gas is None:
                gas = 1
            if mb is None and tb is not None:
                mb = tb  # resolved once the device count is known
        self.train_batch_size = tb
        self.train_micro_batch_size_per_gpu = mb
        self.gradient_accumulation_steps = gas

    def resolve_batch_sizes(self, dp_world: int) -> None:
        """Re-run the triple reconciliation once the data-parallel world
        size is known (1 on one device)."""
        self._world_size = dp_world
        self._configure_train_batch_size()
        self._do_sanity_check()

    def _do_sanity_check(self) -> None:
        if self.fp16.enabled and self.bf16.enabled:
            raise ValueError("fp16 and bf16 cannot both be enabled")
        for v, name in ((self.train_batch_size, C.TRAIN_BATCH_SIZE),
                        (self.train_micro_batch_size_per_gpu,
                         C.TRAIN_MICRO_BATCH_SIZE_PER_GPU),
                        (self.gradient_accumulation_steps,
                         C.GRADIENT_ACCUMULATION_STEPS)):
            if v is not None and v <= 0:
                raise ValueError(f"{name} must be positive, got {v}")
        z = self.zero_config
        if z.stage < 3 and z.offload_device("offload_param") != "none":
            raise ValueError("offload_param requires ZeRO stage 3")

    # -- this slice ------------------------------------------------------------------
    def refuse_out_of_slice(self, mesh_shape: Optional[Dict[str, int]] = None
                            ) -> None:
        """Raise ``NotImplementedError`` for every block this slice of
        the port parses but cannot run, naming the part of ROADMAP.md's
        queue A that brings it.  ``mesh_shape``: the resolved mesh (its
        axis sizes), once the engine has built it; before that the mesh
        block's fixed sizes are checked.  ZeRO-Infinity over a model,
        pipe or sequence axis raises the JAX engine's own refusal
        (``deepspeed_tpu/runtime/zero/infinity.py``), which it shares."""
        later: List[str] = []
        z = self.zero_config
        infinity = z.offload_device("offload_param") != "none"
        offload = infinity or \
            z.offload_device("offload_optimizer") != "none"
        sizes = mesh_shape or self.mesh.sizes()
        model = max(sizes.get("model", 1), self.tensor_parallel.degree())
        if infinity:
            for axis, n in (("model", model), ("pipe", sizes.get("pipe", 1)),
                            ("sequence", sizes.get("sequence", 1))):
                if n > 1:
                    raise NotImplementedError(
                        f"ZeRO-Infinity composes with data-like sharding "
                        f"only; mesh axis '{axis}' has size {n} — use a "
                        f"data/expert mesh under offload_param, or drop "
                        f"offload for tp/pp/sp")
        for axis, part in _LATER_AXES:
            if sizes.get(axis, 1) not in (1, -1):
                later.append(f"mesh axis {axis}={sizes[axis]}: {part}")
        if self.sequence_parallel.enabled:
            later.append("sequence_parallel: ring and Ulysses sequence "
                         "parallelism (queue A item 7 part 6)")
        if self.optimizer is not None and self.optimizer.type.lower() in (
                "onebitadam", "onebitlamb", "zerooneadam"):
            later.append(f"optimizer {self.optimizer.type}: the 1-bit "
                         f"optimizers (queue A item 7 part 7)")
        if offload:
            dp = 1
            for axis in ("data", "dcn_data", "expert"):
                dp *= max(sizes.get(axis, 1), 1)    # -1: resolved later
            if dp > 1:
                later.append(f"offload at a data-parallel size of {dp}: "
                             f"ZeRO-Infinity's dp-sharded part (queue A "
                             f"item 7 part 8)")
        if self.monitor.enabled:
            later.append("tensorboard / wandb / csv_monitor: monitors "
                         "(queue A item 9's auxiliary subsystems)")
        if later:
            raise NotImplementedError(
                "not in the training slice of the PyTorch port: "
                + "; ".join(later) + " (see ROADMAP.md queue A)")

    def print_config(self) -> str:
        return json.dumps(self._param_dict, indent=2, sort_keys=True,
                          default=str)
