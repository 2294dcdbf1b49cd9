"""Fault-tolerance layer of the port: failure taxonomy, retriable I/O,
checkpoint integrity and fault injection.

Copies of the jax-free modules of ``deepspeed_tpu/runtime/resilience/``
(``errors``, ``fault_injection``, ``integrity``, ``retry``).  Wired into
``runtime/checkpoint_engine`` (atomic commit, crc32 manifest, last-good
fallback, retried publish) and the training step's non-finite skip; the
heartbeat and watchdog come with the serving engine's rest (ROADMAP.md
queue A item 4).
"""
from .errors import (CheckpointCorruptionError, FatalIOError,
                     ServingError, TRANSIENT_ERRNOS, TransientIOError,
                     is_transient)
from .fault_injection import (ENV_FAULTS, FaultInjector, FaultPlan,
                              get_fault_injector, install_fault_injector)
from .integrity import (MANIFEST_NAME, atomic_write_bytes,
                        atomic_write_json, atomic_write_text,
                        file_checksum, find_newest_verified_tag, fsync_dir,
                        has_manifest, list_tags, verify_manifest,
                        write_manifest)
from .retry import (DEFAULT_IO_POLICY, RetryPolicy, policy_from_config,
                    retry_call)

__all__ = [
    "CheckpointCorruptionError", "FatalIOError", "ServingError",
    "TRANSIENT_ERRNOS", "TransientIOError", "is_transient",
    "ENV_FAULTS", "FaultInjector", "FaultPlan", "get_fault_injector",
    "install_fault_injector",
    "MANIFEST_NAME", "atomic_write_bytes", "atomic_write_json",
    "atomic_write_text", "file_checksum", "find_newest_verified_tag",
    "fsync_dir", "has_manifest", "list_tags", "verify_manifest",
    "write_manifest",
    "DEFAULT_IO_POLICY", "RetryPolicy", "policy_from_config", "retry_call",
]
