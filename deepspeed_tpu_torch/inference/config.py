"""Inference config for the PyTorch port.

The same JSON schema as ``deepspeed_tpu/inference/config.py`` (keys,
defaults from ``runtime/constants.py`` and validation messages), built on
plain ``dataclasses`` by ``runtime/config_utils.py``: unknown keys are
rejected, a ``None`` value means "use the default", and a value of the
wrong type raises ``ValueError``.

``tensor_parallel`` and ``serving.mesh`` (tensor parallelism and the
(data, model) serving mesh, one process per rank) run; ``moe.ep_size``
beyond one device parses here and is refused with
``NotImplementedError`` by the engine.  ``serving.host_cache`` (the tiered
host prefix cache) and ``serving.fleet`` (the replica fleet) run.
``observability`` is the training config's block
(``runtime/config.py`` ``ObservabilityConfig``); given, the engine
configures the process-global telemetry with it.
``quant`` (int8 weights), ``serving.kv_cache_bits`` (int8 or packed-int4
KV pools) and ``checkpoint`` / ``checkpoint_tag`` (the params of a
training checkpoint of the port) run.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch

from ..runtime.config import ObservabilityConfig
from ..runtime.config_utils import from_dict
from ..runtime.constants import (
    SERVING_DEFAULT_DEADLINE_S_DEFAULT, SERVING_ENABLED_DEFAULT,
    SERVING_FLEET_AFFINITY_WEIGHT_DEFAULT, SERVING_FLEET_CHIP_BUDGET_DEFAULT,
    SERVING_FLEET_ENABLED_DEFAULT, SERVING_FLEET_HEARTBEAT_INTERVAL_S_DEFAULT,
    SERVING_FLEET_HEARTBEAT_TIMEOUT_S_DEFAULT,
    SERVING_FLEET_MAX_FAILOVERS_DEFAULT,
    SERVING_FLEET_PREFILL_REPLICAS_DEFAULT,
    SERVING_FLEET_PROMOTE_DISCOUNT_DEFAULT, SERVING_FLEET_QUEUE_HIGH_DEFAULT,
    SERVING_FLEET_QUEUE_LOW_DEFAULT, SERVING_FLEET_QUIET_S_DEFAULT,
    SERVING_FLEET_REPLICAS_DEFAULT, SERVING_FLEET_RETRY_BASE_DELAY_S_DEFAULT,
    SERVING_FLEET_RETRY_MAX_DELAY_S_DEFAULT,
    SERVING_FLEET_SCALE_DOWN_COOLDOWN_S_DEFAULT,
    SERVING_FLEET_SCALE_UP_COOLDOWN_S_DEFAULT,
    SERVING_HOST_CACHE_DRAM_BUDGET_BYTES_DEFAULT,
    SERVING_HOST_CACHE_ENABLED_DEFAULT,
    SERVING_HOST_CACHE_NVME_BUDGET_BYTES_DEFAULT,
    SERVING_HOST_CACHE_NVME_PATH_DEFAULT,
    SERVING_HOST_CACHE_PROMOTE_PARALLELISM_DEFAULT,
    SERVING_HOST_CACHE_WIRE_BITS_DEFAULT,
    SERVING_KV_BLOCK_SIZE_DEFAULT, SERVING_KV_CACHE_BITS_DEFAULT,
    SERVING_MAX_BATCH_SLOTS_DEFAULT, SERVING_MAX_PREEMPTIONS_DEFAULT,
    SERVING_MAX_QUEUE_DEPTH_DEFAULT, SERVING_MESH_DATA_DEFAULT,
    SERVING_MESH_MODEL_DEFAULT, SERVING_NO_PROGRESS_STEPS_DEFAULT,
    SERVING_NUM_KV_BLOCKS_DEFAULT, SERVING_PREFILL_CHUNK_TOKENS_DEFAULT,
    SERVING_PREFIX_CACHE_DEFAULT, SERVING_SPEC_K_DEFAULT)

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32, "bf16": torch.bfloat16,
          "fp16": torch.float16, "fp32": torch.float32}


@dataclass
class ServingMeshConfig:
    """``serving.mesh`` — the (data, model) serving submesh."""
    data: int = SERVING_MESH_DATA_DEFAULT
    model: int = SERVING_MESH_MODEL_DEFAULT

    def __post_init__(self):
        if self.data < 1:
            raise ValueError(
                f"serving.mesh.data must be >= 1, got {self.data}")
        if self.model < 1:
            raise ValueError(
                f"serving.mesh.model must be >= 1, got {self.model}")


@dataclass
class HostCacheConfig:
    """``serving.host_cache`` — the tiered host prefix cache: refcount-0
    blocks the pool LRU evicts are demoted through the wire codec into a
    host DRAM slot store (``dram_budget_bytes``), overflowing to an
    NVMe-backed store (``nvme_budget_bytes`` at ``nvme_path``); a prefix
    hit on a spilled chain promotes the blocks back, at most
    ``promote_parallelism`` a step."""
    enabled: bool = SERVING_HOST_CACHE_ENABLED_DEFAULT
    dram_budget_bytes: int = SERVING_HOST_CACHE_DRAM_BUDGET_BYTES_DEFAULT
    nvme_budget_bytes: int = SERVING_HOST_CACHE_NVME_BUDGET_BYTES_DEFAULT
    nvme_path: Optional[str] = SERVING_HOST_CACHE_NVME_PATH_DEFAULT
    promote_parallelism: int = SERVING_HOST_CACHE_PROMOTE_PARALLELISM_DEFAULT
    wire_bits: int = SERVING_HOST_CACHE_WIRE_BITS_DEFAULT

    def __post_init__(self):
        if self.dram_budget_bytes < 0 or self.nvme_budget_bytes < 0:
            raise ValueError(
                "serving.host_cache budgets must be >= 0 (0 = tier off)")
        if self.enabled and not (self.dram_budget_bytes
                                 or self.nvme_budget_bytes):
            raise ValueError(
                "serving.host_cache.enabled needs dram_budget_bytes "
                "and/or nvme_budget_bytes > 0")
        if self.nvme_budget_bytes and not self.nvme_path:
            raise ValueError(
                "serving.host_cache.nvme_budget_bytes > 0 requires "
                "nvme_path (directory for the backing file)")
        if self.promote_parallelism < 1:
            raise ValueError(
                f"serving.host_cache.promote_parallelism must be >= 1, "
                f"got {self.promote_parallelism}")
        if self.wire_bits not in (0, 4, 8):
            raise ValueError(
                f"serving.host_cache.wire_bits must be one of 0 (raw "
                f"dtype bytes), 8 (int8) or 4 (packed int4), got "
                f"{self.wire_bits}")


@dataclass
class FleetConfig:
    """``serving.fleet`` — the replica fleet (``inference/serving/
    fleet/``): ``replicas`` serving engines behind a ``FleetRouter``
    (prefix-affinity placement traded against queue depth, token-exact
    failover, drain and join); the first ``prefill_replicas`` of them
    prefill-only publishers over the host tier's KV fabric; the
    autoscaler's knobs.  The serving engine's heartbeat beats every
    ``heartbeat_interval_s``."""
    enabled: bool = SERVING_FLEET_ENABLED_DEFAULT
    replicas: int = SERVING_FLEET_REPLICAS_DEFAULT
    heartbeat_interval_s: float = SERVING_FLEET_HEARTBEAT_INTERVAL_S_DEFAULT
    heartbeat_timeout_s: float = SERVING_FLEET_HEARTBEAT_TIMEOUT_S_DEFAULT
    affinity_weight: float = SERVING_FLEET_AFFINITY_WEIGHT_DEFAULT
    max_failovers: int = SERVING_FLEET_MAX_FAILOVERS_DEFAULT
    retry_base_delay_s: float = SERVING_FLEET_RETRY_BASE_DELAY_S_DEFAULT
    retry_max_delay_s: float = SERVING_FLEET_RETRY_MAX_DELAY_S_DEFAULT
    prefill_replicas: int = SERVING_FLEET_PREFILL_REPLICAS_DEFAULT
    promote_discount: float = SERVING_FLEET_PROMOTE_DISCOUNT_DEFAULT
    chip_budget: int = SERVING_FLEET_CHIP_BUDGET_DEFAULT
    scale_up_cooldown_s: float = SERVING_FLEET_SCALE_UP_COOLDOWN_S_DEFAULT
    scale_down_cooldown_s: float = \
        SERVING_FLEET_SCALE_DOWN_COOLDOWN_S_DEFAULT
    queue_high: float = SERVING_FLEET_QUEUE_HIGH_DEFAULT
    queue_low: float = SERVING_FLEET_QUEUE_LOW_DEFAULT
    quiet_s: float = SERVING_FLEET_QUIET_S_DEFAULT

    def __post_init__(self):
        if self.replicas < 1:
            raise ValueError(
                f"serving.fleet.replicas must be >= 1, got "
                f"{self.replicas}")
        if self.heartbeat_interval_s <= 0:
            raise ValueError(
                f"serving.fleet.heartbeat_interval_s must be > 0, got "
                f"{self.heartbeat_interval_s}")
        if (self.heartbeat_timeout_s
                and self.heartbeat_timeout_s
                < 2 * self.heartbeat_interval_s):
            # a timeout tighter than two beats declares healthy replicas
            # dead
            raise ValueError(
                f"serving.fleet.heartbeat_timeout_s must be 0 or >= 2x "
                f"heartbeat_interval_s, got {self.heartbeat_timeout_s}")
        if self.affinity_weight < 0:
            raise ValueError(
                f"serving.fleet.affinity_weight must be >= 0, got "
                f"{self.affinity_weight}")
        if self.max_failovers < 0:
            raise ValueError(
                f"serving.fleet.max_failovers must be >= 0, got "
                f"{self.max_failovers}")
        if self.retry_base_delay_s <= 0 \
                or self.retry_max_delay_s < self.retry_base_delay_s:
            raise ValueError(
                "serving.fleet retry delays must satisfy "
                "0 < retry_base_delay_s <= retry_max_delay_s")
        if not 0 <= self.prefill_replicas < self.replicas:
            # a fleet of pure publishers can never stream a token
            raise ValueError(
                f"serving.fleet.prefill_replicas must be in "
                f"[0, replicas), got {self.prefill_replicas} of "
                f"{self.replicas}")
        if not 0.0 <= self.promote_discount <= 1.0:
            raise ValueError(
                f"serving.fleet.promote_discount must be in [0, 1], "
                f"got {self.promote_discount}")
        if self.chip_budget < 1:
            raise ValueError(
                f"serving.fleet.chip_budget must be >= 1, got "
                f"{self.chip_budget}")
        if self.scale_up_cooldown_s <= 0 or self.scale_down_cooldown_s <= 0:
            raise ValueError(
                "serving.fleet scale cooldowns must be > 0 — a zero "
                "cooldown lets an alert storm scale at tick rate")
        if self.queue_low > self.queue_high:
            raise ValueError(
                f"serving.fleet.queue_low ({self.queue_low}) must be <= "
                f"queue_high ({self.queue_high})")
        if self.quiet_s < 0:
            raise ValueError(
                f"serving.fleet.quiet_s must be >= 0, got {self.quiet_s}")


@dataclass
class ServingConfig:
    """``serving`` block — continuous-batching inference (paged KV pool
    of ``num_kv_blocks`` blocks of ``kv_block_size`` tokens, block 0
    reserved; ``max_batch_slots`` decode slots; chunked prefill of
    ``prefill_chunk_tokens`` per iteration)."""
    enabled: bool = SERVING_ENABLED_DEFAULT
    kv_block_size: int = SERVING_KV_BLOCK_SIZE_DEFAULT
    num_kv_blocks: int = SERVING_NUM_KV_BLOCKS_DEFAULT
    max_batch_slots: int = SERVING_MAX_BATCH_SLOTS_DEFAULT
    prefill_chunk_tokens: int = SERVING_PREFILL_CHUNK_TOKENS_DEFAULT
    prefix_cache: bool = SERVING_PREFIX_CACHE_DEFAULT
    kv_cache_bits: int = SERVING_KV_CACHE_BITS_DEFAULT
    max_queue_depth: int = SERVING_MAX_QUEUE_DEPTH_DEFAULT
    max_preemptions: int = SERVING_MAX_PREEMPTIONS_DEFAULT
    no_progress_steps: int = SERVING_NO_PROGRESS_STEPS_DEFAULT
    default_deadline_s: float = SERVING_DEFAULT_DEADLINE_S_DEFAULT
    spec_k: int = SERVING_SPEC_K_DEFAULT
    mesh: ServingMeshConfig = field(default_factory=ServingMeshConfig)
    host_cache: HostCacheConfig = field(default_factory=HostCacheConfig)
    fleet: FleetConfig = field(default_factory=FleetConfig)

    def __post_init__(self):
        if self.kv_block_size < 1:
            raise ValueError(
                f"serving.kv_block_size must be >= 1, got "
                f"{self.kv_block_size}")
        if self.num_kv_blocks < 2:
            raise ValueError(
                f"serving.num_kv_blocks must be >= 2 (block 0 is the "
                f"reserved null block), got {self.num_kv_blocks}")
        if self.max_batch_slots < 1:
            raise ValueError(
                f"serving.max_batch_slots must be >= 1, got "
                f"{self.max_batch_slots}")
        if self.prefill_chunk_tokens < 1:
            raise ValueError(
                f"serving.prefill_chunk_tokens must be >= 1, got "
                f"{self.prefill_chunk_tokens}")
        if self.kv_cache_bits not in (0, 4, 8):
            raise ValueError(
                f"serving.kv_cache_bits must be one of 0 (engine "
                f"dtype), 8 (int8) or 4 (packed int4), got "
                f"{self.kv_cache_bits}")
        if self.max_queue_depth < 0:
            raise ValueError(
                f"serving.max_queue_depth must be >= 0 (0 = unbounded), "
                f"got {self.max_queue_depth}")
        if self.max_preemptions < 0:
            raise ValueError(
                f"serving.max_preemptions must be >= 0 (0 = no cap), "
                f"got {self.max_preemptions}")
        if self.no_progress_steps < 0:
            raise ValueError(
                f"serving.no_progress_steps must be >= 0 (0 = disabled), "
                f"got {self.no_progress_steps}")
        if self.spec_k < 1:
            raise ValueError(
                f"serving.spec_k must be >= 1 (only read when a draft "
                f"model is armed), got {self.spec_k}")
        if self.default_deadline_s < 0:
            raise ValueError(
                f"serving.default_deadline_s must be >= 0 (0 = none), "
                f"got {self.default_deadline_s}")
        if self.max_batch_slots % self.mesh.data:
            raise ValueError(
                f"serving.mesh.data ({self.mesh.data}) must divide "
                f"serving.max_batch_slots ({self.max_batch_slots}) — "
                f"decode slots partition evenly over the data axis")


@dataclass
class TensorParallelConfig:
    enabled: bool = True
    tp_size: int = 1


@dataclass
class MoEInferenceConfig:
    enabled: bool = False
    ep_size: int = 1


@dataclass
class QuantConfig:
    enabled: bool = False
    bits: int = 8
    quantize_embeddings: bool = False


@dataclass
class DeepSpeedInferenceConfig:
    dtype: str = "bfloat16"
    tensor_parallel: TensorParallelConfig = field(
        default_factory=TensorParallelConfig)
    moe: MoEInferenceConfig = field(default_factory=MoEInferenceConfig)
    quant: QuantConfig = field(default_factory=QuantConfig)
    serving: ServingConfig = field(default_factory=ServingConfig)
    max_out_tokens: int = 1024
    max_batch_size: int = 16
    prompt_bucket: int = 64
    replace_with_kernel_inject: bool = True
    profile_sync_timeout_s: float = 60.0
    checkpoint: Optional[str] = None
    checkpoint_tag: Optional[str] = None
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    # the training config's block; None leaves the process-global
    # telemetry as another engine configured it
    observability: Optional[ObservabilityConfig] = None

    def __post_init__(self):
        if self.dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got "
                             f"{self.dtype!r}")

    @classmethod
    def from_dict(cls, data: Optional[Dict[str, Any]]
                  ) -> "DeepSpeedInferenceConfig":
        return from_dict(cls, data, "")

    def compute_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]
