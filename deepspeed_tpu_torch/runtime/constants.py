"""Config keys and defaults of the master JSON config.

Counterpart of ``deepspeed_tpu/runtime/constants.py``: the same key
names and default values, for the blocks the port parses (the training
config of ``runtime/config.py`` and the ``serving`` block of
``inference/config.py``).
"""

# -- batch-size triple ---------------------------------------------------------
TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"

# -- optimizer / scheduler ----------------------------------------------------
OPTIMIZER = "optimizer"
SCHEDULER = "scheduler"
MAX_GRAD_NORM = "max_grad_norm"

# -- precision ---------------------------------------------------------------------
FP16 = "fp16"
BF16 = "bf16"
AMP = "amp"

# -- ZeRO ----------------------------------------------------------------------------
ZERO_OPTIMIZATION = "zero_optimization"

# -- misc engine knobs ------------------------------------------------------------
GRADIENT_CLIPPING = "gradient_clipping"
MEMORY_BREAKDOWN = "memory_breakdown"
PRESCALE_GRADIENTS = "prescale_gradients"
GRADIENT_PREDIVIDE_FACTOR = "gradient_predivide_factor"
STEPS_PER_PRINT = "steps_per_print"
WALL_CLOCK_BREAKDOWN = "wall_clock_breakdown"
DUMP_STATE = "dump_state"
SPARSE_GRADIENTS = "sparse_gradients"
COMMUNICATION_DATA_TYPE = "communication_data_type"
DISABLE_ALLGATHER = "disable_allgather"

# -- subsystem config blocks ------------------------------------------------------
ACTIVATION_CHECKPOINTING = "activation_checkpointing"
AIO = "aio"
FLOPS_PROFILER = "flops_profiler"
MONITOR_TENSORBOARD = "tensorboard"
MONITOR_WANDB = "wandb"
MONITOR_CSV = "csv_monitor"
ELASTICITY = "elasticity"
AUTOTUNING = "autotuning"
COMPRESSION_TRAINING = "compression_training"
DATA_EFFICIENCY = "data_efficiency"
CURRICULUM_LEARNING_LEGACY = "curriculum_learning"
PIPELINE = "pipeline"
SEQUENCE_PARALLEL = "sequence_parallel"
MESH = "mesh"
CHECKPOINT = "checkpoint"
TENSOR_PARALLEL = "tensor_parallel"
RESILIENCE = "resilience"
COMMS_LOGGER = "comms_logger"
OBSERVABILITY = "observability"
TRAINING = "training"

# -- defaults ------------------------------------------------------------------------
TRAIN_BATCH_SIZE_DEFAULT = None
TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT = None
GRADIENT_ACCUMULATION_STEPS_DEFAULT = None
STEPS_PER_PRINT_DEFAULT = 10
GRADIENT_CLIPPING_DEFAULT = 0.0
PRESCALE_GRADIENTS_DEFAULT = False
GRADIENT_PREDIVIDE_FACTOR_DEFAULT = 1.0
WALL_CLOCK_BREAKDOWN_DEFAULT = False
SPARSE_GRADIENTS_DEFAULT = False

# fp16 block (dynamic loss scaling)
FP16_LOSS_SCALE_DEFAULT = 0  # 0 => dynamic
FP16_INITIAL_SCALE_POWER_DEFAULT = 16
FP16_LOSS_SCALE_WINDOW_DEFAULT = 1000
FP16_HYSTERESIS_DEFAULT = 2
FP16_MIN_LOSS_SCALE_DEFAULT = 1.0

# pipeline block
PIPE_STAGES_DEFAULT = "auto"
PIPE_SCHEDULE_DEFAULT = "auto"
PIPE_SCHEDULES = ("auto", "1f1b", "gpipe")

# resilience block
RESILIENCE_CHECKPOINT_INTEGRITY_DEFAULT = True
RESILIENCE_VERIFY_ON_SAVE_DEFAULT = True
RESILIENCE_FALLBACK_DEFAULT = True
RESILIENCE_IO_RETRY_ATTEMPTS_DEFAULT = 3
RESILIENCE_IO_RETRY_BASE_DELAY_DEFAULT = 0.05   # seconds
RESILIENCE_IO_RETRY_MAX_DELAY_DEFAULT = 2.0     # seconds
RESILIENCE_IO_RETRY_JITTER_DEFAULT = 0.25       # fraction of each delay
RESILIENCE_SKIP_NONFINITE_DEFAULT = True
RESILIENCE_HEARTBEAT_INTERVAL_DEFAULT = 1.0     # seconds
RESILIENCE_WATCHDOG_TIMEOUT_DEFAULT = 0.0       # seconds; 0 disables

# observability block (span tracer + metrics registry + serving hooks)
OBSERVABILITY_TRACING_ENABLED_DEFAULT = False
OBSERVABILITY_TRACE_BUFFER_DEFAULT = 65536      # ring capacity, spans
OBSERVABILITY_TRACE_DIR_DEFAULT = "traces"
OBSERVABILITY_METRICS_ENABLED_DEFAULT = False
OBSERVABILITY_EXPORT_INTERVAL_DEFAULT = 0       # steps; 0 = flush-only
OBSERVABILITY_PROMETHEUS_DIR_DEFAULT = None     # textfile-collector dir
OBSERVABILITY_JSON_PATH_DEFAULT = None          # JSON snapshot path
OBSERVABILITY_REQUEST_TRACE_ENABLED_DEFAULT = False
OBSERVABILITY_REQUEST_TRACE_CAPACITY_DEFAULT = 512   # retained timelines
OBSERVABILITY_REQUEST_TRACE_SEGMENTS_DEFAULT = 256   # stamps per request
OBSERVABILITY_SLO_ENABLED_DEFAULT = False
OBSERVABILITY_SLO_OBJECTIVE_DEFAULT = 0.9       # met-target fraction
OBSERVABILITY_SLO_FAST_WINDOW_DEFAULT = 30.0    # seconds
OBSERVABILITY_SLO_SLOW_WINDOW_DEFAULT = 300.0   # seconds
OBSERVABILITY_SLO_BURN_THRESHOLD_DEFAULT = 2.0  # x budget, both windows
OBSERVABILITY_SLO_RESOLVE_FRACTION_DEFAULT = 0.5  # hysteresis on resolve
OBSERVABILITY_SLO_MIN_SAMPLES_DEFAULT = 5       # fast-window floor
OBSERVABILITY_FLIGHT_ENABLED_DEFAULT = False
OBSERVABILITY_FLIGHT_CAPACITY_DEFAULT = 256     # snapshot ring slots
OBSERVABILITY_FLIGHT_DIR_DEFAULT = "flight_recorder"
OBSERVABILITY_FLIGHT_TERMINALS_DEFAULT = 64     # terminal-event ring
OBSERVABILITY_FLIGHT_SKIP_BURST_DEFAULT = 8     # skipped-step trigger
OBSERVABILITY_FLIGHT_MAX_BUNDLES_DEFAULT = 4    # bundles kept per rank
OBSERVABILITY_OVERLAP_ENABLED_DEFAULT = False
OBSERVABILITY_OVERLAP_CAPACITY_DEFAULT = 2048   # iteration ring slots

# training block: per-run overrides of the model's hot-path knobs
# (None = keep the model config's setting)
TRAINING_REMAT_DEFAULT = None
TRAINING_FUSED_LOSS_HEAD_DEFAULT = None
TRAINING_LOSS_CHUNK_DEFAULT = None
TRAINING_DONATE_BATCH_DEFAULT = False

# serving block of the inference config
SERVING_ENABLED_DEFAULT = False
SERVING_KV_BLOCK_SIZE_DEFAULT = 16
SERVING_NUM_KV_BLOCKS_DEFAULT = 512
SERVING_MAX_BATCH_SLOTS_DEFAULT = 8
SERVING_PREFILL_CHUNK_TOKENS_DEFAULT = 256
SERVING_PREFIX_CACHE_DEFAULT = True
SERVING_MAX_QUEUE_DEPTH_DEFAULT = 1024
SERVING_MAX_PREEMPTIONS_DEFAULT = 8
SERVING_NO_PROGRESS_STEPS_DEFAULT = 64
SERVING_SPEC_K_DEFAULT = 3
SERVING_DEFAULT_DEADLINE_S_DEFAULT = 0.0
SERVING_KV_CACHE_BITS_DEFAULT = 0
SERVING_MESH_DATA_DEFAULT = 1
SERVING_MESH_MODEL_DEFAULT = 1
# tiered host prefix cache: refcount-0 blocks the pool LRU evicts spill
# (encoded at
# ``wire_bits``; a quantized pool spills its own int8/int4 bytes
# verbatim) into a host DRAM store, overflowing to an NVMe-backed store
# when budgeted, keyed by the same chained content digest as the radix
# index; a prefix hit on a spilled chain promotes blocks back during
# the admission/prefill window instead of recomputing them.
SERVING_HOST_CACHE_ENABLED_DEFAULT = False
SERVING_HOST_CACHE_DRAM_BUDGET_BYTES_DEFAULT = 0   # 0 = DRAM tier off
SERVING_HOST_CACHE_NVME_BUDGET_BYTES_DEFAULT = 0   # 0 = NVMe tier off
SERVING_HOST_CACHE_NVME_PATH_DEFAULT = None        # dir for the .swp file
# block promotions (host -> pool scatters) serviced per engine step —
# bounds the per-iteration promote stall the decode lanes ride behind
SERVING_HOST_CACHE_PROMOTE_PARALLELISM_DEFAULT = 4
# wire/at-rest bits for spilling an UNQUANTIZED pool (8 = int8 with f32
# per-row scales, 4 = packed int4, 0 = raw dtype bytes); ignored when
# serving.kv_cache_bits already quantizes the pool (spill is then the
# pool's own bytes, a lossless round-trip)
SERVING_HOST_CACHE_WIRE_BITS_DEFAULT = 8
# Resilient serving fleet (``serving.fleet`` — inference/serving/fleet/):
# many ServingEngine replicas behind a router that places by queue depth and cached-prefix
# affinity, declares replicas dead on missed heartbeats / ServingError,
# and replays every in-flight request on a healthy replica with its
# original fold_in key — the stream is bit-identical and a high-water
# deduplicator makes delivery exactly-once.
SERVING_FLEET_ENABLED_DEFAULT = False
SERVING_FLEET_REPLICAS_DEFAULT = 2          # engines behind the router
# heartbeat stamped at every serving iteration boundary; a replica whose
# beat file goes stale past the timeout is declared DEAD (threaded
# replicas only — cooperative stepping surfaces death synchronously)
SERVING_FLEET_HEARTBEAT_INTERVAL_S_DEFAULT = 1.0
SERVING_FLEET_HEARTBEAT_TIMEOUT_S_DEFAULT = 0.0    # 0 disables staleness
# placement score = affinity_weight * covered-prefix tokens - queue cost
# per waiting request; higher weight chases warm prefixes harder at the
# price of queue imbalance
SERVING_FLEET_AFFINITY_WEIGHT_DEFAULT = 1.0
# failover attempts per request before the fleet gives up and FAILs it
# (each resubmission replays the original key — token-exact)
SERVING_FLEET_MAX_FAILOVERS_DEFAULT = 3
# jittered backoff for honoring SHED retry_after_s hints when every
# routable replica is saturated (retry_call-shaped schedule)
SERVING_FLEET_RETRY_BASE_DELAY_S_DEFAULT = 0.05
SERVING_FLEET_RETRY_MAX_DELAY_S_DEFAULT = 2.0
# disaggregated serving: the first K replicas become prefill workers that
# publish finished chains into the shared host tier (the KV fabric) and
# the rest decode replicas that claim-and-promote them; 0 keeps the
# uniform fleet.  Requires serving.host_cache.enabled when > 0.
SERVING_FLEET_PREFILL_REPLICAS_DEFAULT = 0
# affinity credit for a host/fabric-resident prefix token relative to a
# device-resident one: it saves the recompute but pays claim + promote
SERVING_FLEET_PROMOTE_DISCOUNT_DEFAULT = 0.5
# autoscaler policy (fleet/autoscaler.py): burn-rate alerts + per-class
# queue depth -> join/drain, bounded by cooldowns and the chip budget
SERVING_FLEET_CHIP_BUDGET_DEFAULT = 8       # alive replicas x chips each
SERVING_FLEET_SCALE_UP_COOLDOWN_S_DEFAULT = 5.0
SERVING_FLEET_SCALE_DOWN_COOLDOWN_S_DEFAULT = 30.0
SERVING_FLEET_QUEUE_HIGH_DEFAULT = 8.0      # per-replica depth -> scale up
SERVING_FLEET_QUEUE_LOW_DEFAULT = 1.0       # below this the class is quiet
SERVING_FLEET_QUIET_S_DEFAULT = 10.0        # quiet this long -> scale down
