"""Inference config for the PyTorch port.

The same JSON schema as ``deepspeed_tpu/inference/config.py`` (keys,
defaults from ``runtime/constants.py`` and validation messages), built on
plain ``dataclasses`` by ``runtime/config_utils.py``: unknown keys are
rejected, a ``None`` value means "use the default", and a value of the
wrong type raises ``ValueError``.

Blocks the slices of the port so far do not run (``tensor_parallel``
beyond one device, ``moe.ep_size`` beyond one device, ``serving.mesh``
beyond 1x1, ``serving.host_cache``, ``serving.fleet``) parse here and are
refused with ``NotImplementedError`` by the engines that would run them.
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
    """``serving.host_cache`` — parsed for schema parity; the tiered host
    cache is the next slice (ROADMAP.md queue A item 4, second part), so
    ``enabled`` is refused at serving engine build."""
    enabled: bool = False
    dram_budget_bytes: int = 0
    nvme_budget_bytes: int = 0
    nvme_path: Optional[str] = None
    promote_parallelism: int = 4
    wire_bits: int = 8


@dataclass
class FleetConfig:
    """``serving.fleet`` — parsed for schema parity; the replica fleet
    is the next slice (ROADMAP.md queue A item 4, second part), so
    ``enabled`` is refused at serving engine build.  The serving
    engine's heartbeat beats every ``heartbeat_interval_s``."""
    enabled: bool = False
    replicas: int = 2
    heartbeat_interval_s: float = 1.0
    heartbeat_timeout_s: float = 0.0
    affinity_weight: float = 1.0
    max_failovers: int = 3
    retry_base_delay_s: float = 0.05
    retry_max_delay_s: float = 2.0
    prefill_replicas: int = 0
    promote_discount: float = 0.5
    chip_budget: int = 8
    scale_up_cooldown_s: float = 5.0
    scale_down_cooldown_s: float = 30.0
    queue_high: float = 8.0
    queue_low: float = 1.0
    quiet_s: float = 10.0


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
