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
