"""Inference config for the PyTorch port.

The same JSON schema as ``deepspeed_tpu/inference/config.py`` (keys,
defaults from ``runtime/constants.py`` and validation messages), built on
plain ``dataclasses`` instead of pydantic.  As in the JAX ``ConfigModel``:
unknown keys are rejected, a ``None`` value means "use the default", and
a value of the wrong type raises ``ValueError``.

Blocks the first slice of the port does not run (``quant``,
``tensor_parallel`` beyond one device, ``moe``, ``observability``,
``checkpoint``, ``serving.mesh`` beyond 1x1, ``serving.host_cache``,
``serving.fleet``, quantized KV) parse here and are refused with
``NotImplementedError`` by the engines that would run them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Union, get_type_hints

import torch

# serving defaults (deepspeed_tpu/runtime/constants.py)
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

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32, "bf16": torch.bfloat16,
          "fp16": torch.float16, "fp32": torch.float32}


_TRUE = {"1", "on", "t", "true", "y", "yes"}
_FALSE = {"0", "off", "f", "false", "n", "no"}


def _coerce(value: Any, hint: Any) -> Any:
    """pydantic's lax scalar rules for the field types the schema uses:
    integral floats and numeric strings for ints, numbers and numeric
    strings for floats, 0/1 and yes/no-style strings for bools.  Raises
    ValueError (or TypeError) on anything else."""
    if hint is str:
        if not isinstance(value, str):
            raise TypeError("expected a string")
        return value
    if hint is bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, int) and value in (0, 1):
            return bool(value)
        if isinstance(value, str) and value.lower() in _TRUE | _FALSE:
            return value.lower() in _TRUE
        raise ValueError("expected a boolean")
    if isinstance(value, bool) or not isinstance(value, (int, float, str)):
        raise TypeError(f"expected {hint.__name__}")
    if hint is float:
        return float(value)
    if isinstance(value, float) and not value.is_integer():
        raise ValueError("expected an integer, got a fractional number")
    return int(float(value)) if isinstance(value, float) else int(value)


def _check_type(path: str, value: Any, hint: Any) -> Any:
    origin = getattr(hint, "__origin__", None)
    if origin is Union:                        # Optional[X]
        args = [a for a in hint.__args__ if a is not type(None)]
        return _check_type(path, value, args[0])
    try:
        return _coerce(value, hint)
    except (TypeError, ValueError) as e:
        raise ValueError(f"{path}: {e}, got {type(value).__name__} "
                         f"{value!r}") from None


def _from_dict(cls, data: Optional[Dict[str, Any]], path: str):
    """Build config dataclass ``cls`` from a JSON block."""
    if data is None:
        return cls()
    if isinstance(data, cls):
        return data
    if not isinstance(data, dict):
        raise ValueError(f"{path or 'config'}: expected a JSON object, "
                         f"got {type(data).__name__}")
    hints = get_type_hints(cls)
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(data) - names)
    if unknown:
        raise ValueError(f"{path or 'config'}: unknown key(s) {unknown} "
                         f"(extra keys are forbidden)")
    kw = {}
    for name, value in data.items():
        if value is None:                      # None = keep the default
            continue
        hint = hints[name]
        sub = f"{path}.{name}" if path else name
        if dataclasses.is_dataclass(hint):
            kw[name] = _from_dict(hint, value, sub)
        elif hint is Any or hint == Optional[Dict[str, Any]]:
            kw[name] = value
        else:
            kw[name] = _check_type(sub, value, hint)
    return cls(**kw)


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
    cache is not in this slice, so ``enabled`` is refused at serving
    engine build."""
    enabled: bool = False
    dram_budget_bytes: int = 0
    nvme_budget_bytes: int = 0
    nvme_path: Optional[str] = None
    promote_parallelism: int = 4
    wire_bits: int = 8


@dataclass
class FleetConfig:
    """``serving.fleet`` — parsed for schema parity; the replica fleet
    is not in this slice, so ``enabled`` is refused at serving engine
    build."""
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
    observability: Optional[Dict[str, Any]] = None

    def __post_init__(self):
        if self.dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got "
                             f"{self.dtype!r}")

    @classmethod
    def from_dict(cls, data: Optional[Dict[str, Any]]
                  ) -> "DeepSpeedInferenceConfig":
        return _from_dict(cls, data, "")

    def compute_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]
