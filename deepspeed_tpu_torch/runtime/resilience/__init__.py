"""Fault-tolerance layer of the port: failure taxonomy, retriable I/O,
checkpoint integrity, fault injection and worker liveness.

Copies of the jax-free modules of ``deepspeed_tpu/runtime/resilience/``
(``errors``, ``fault_injection``, ``heartbeat``, ``integrity``,
``retry``).  Wired into ``runtime/checkpoint_engine`` (atomic commit,
crc32 manifest, last-good fallback, retried publish), the training
step's non-finite skip and heartbeat, and the serving engine (the
``serving.*`` fault sites and the heartbeat at every iteration
boundary).
"""
from .errors import (CheckpointCorruptionError, FatalIOError,
                     ServingError, TRANSIENT_ERRNOS, TransientIOError,
                     is_transient)
from .fault_injection import (ENV_FAULTS, FaultInjector, FaultPlan,
                              get_fault_injector, install_fault_injector)
from .heartbeat import (ENV_HEARTBEAT_FILE, Heartbeat, Watchdog, beat,
                        heartbeat_age, is_stale, run_with_timeout)
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
    "ENV_HEARTBEAT_FILE", "Heartbeat", "Watchdog", "beat", "heartbeat_age",
    "is_stale", "run_with_timeout",
    "MANIFEST_NAME", "atomic_write_bytes", "atomic_write_json",
    "atomic_write_text", "file_checksum", "find_newest_verified_tag",
    "fsync_dir", "has_manifest", "list_tags", "verify_manifest",
    "write_manifest",
    "DEFAULT_IO_POLICY", "RetryPolicy", "policy_from_config", "retry_call",
]
