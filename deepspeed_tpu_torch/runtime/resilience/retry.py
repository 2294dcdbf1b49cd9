"""Retriable I/O: exponential backoff + jitter over the shared taxonomy.

One policy object, one call path, used by the checkpoint commit. The
reference DeepSpeed has no equivalent — a single EIO on a checkpoint
write kills the run; Nebula-style committed checkpoints motivate the
same discipline for the TPU-native engine (SURVEY:
nebula_checkpoint_engine commit semantics).

Usage::

    retry_call(commit, policy=policy_from_config(resilience),
               what="checkpoint publish")

Only exceptions passing ``is_transient`` (TransientIOError / transient
OSError errnos) are retried; ``FatalIOError`` and everything else
propagate on the first throw. Exhausting the budget re-raises the LAST
transient error so the caller sees the real failure, with the attempt
count in the log.

Copy of ``deepspeed_tpu/runtime/resilience/retry.py`` for the PyTorch
port, without the ``retriable`` decorator (no caller yet); the retries
and give-ups feed the port's metrics registry as in JAX.
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Optional, TypeVar

from ...utils.logging import logger
from .errors import is_transient

T = TypeVar("T")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff schedule: attempt k (0-based retry index)
    sleeps ``min(base * multiplier**k, max_delay)``, scaled by a uniform
    jitter in ``[1 - jitter, 1 + jitter]`` so a fleet of workers hitting
    the same flaky store does not retry in lockstep."""
    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.25

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.base_delay_s < 0 or self.max_delay_s < self.base_delay_s:
            raise ValueError(
                f"need 0 <= base_delay_s <= max_delay_s, got "
                f"{self.base_delay_s}/{self.max_delay_s}")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {self.jitter}")

    def delay(self, retry_index: int) -> float:
        d = min(self.base_delay_s * (self.multiplier ** retry_index),
                self.max_delay_s)
        if self.jitter and d > 0:
            d *= 1.0 + self.jitter * (2.0 * random.random() - 1.0)
        return d


#: Default for I/O sites not configured through the ``resilience`` block.
DEFAULT_IO_POLICY = RetryPolicy()


def policy_from_config(resilience_cfg) -> RetryPolicy:
    """Build the shared I/O policy from a ``ResilienceConfig``
    (runtime/config.py ``resilience`` block)."""
    if resilience_cfg is None:
        return DEFAULT_IO_POLICY
    return RetryPolicy(
        max_attempts=resilience_cfg.io_retry_attempts,
        base_delay_s=resilience_cfg.io_retry_base_delay_s,
        max_delay_s=resilience_cfg.io_retry_max_delay_s,
        jitter=resilience_cfg.io_retry_jitter)


def retry_call(fn: Callable[[], T], *,
               policy: Optional[RetryPolicy] = None,
               what: str = "operation",
               sleep: Callable[[float], None] = time.sleep) -> T:
    """Run ``fn`` with the policy's transient-retry budget.

    ``sleep`` is injectable for tests (no real waiting in unit suites).
    """
    from ...observability import get_registry
    policy = policy or DEFAULT_IO_POLICY
    last: Optional[BaseException] = None
    for attempt in range(policy.max_attempts):
        try:
            return fn()
        except BaseException as e:  # noqa: BLE001 — classify then decide
            if not is_transient(e):
                raise
            last = e
            # rare-event metric, fed unconditionally: the retry history
            # must exist the moment an operator turns export on
            get_registry().counter("dstpu_io_retries_total").inc()
            if attempt + 1 >= policy.max_attempts:
                break
            d = policy.delay(attempt)
            logger.warning(
                f"transient I/O failure in {what} "
                f"(attempt {attempt + 1}/{policy.max_attempts}): {e} — "
                f"retrying in {d * 1e3:.0f} ms")
            sleep(d)
    get_registry().counter("dstpu_io_retry_giveups_total").inc()
    logger.error(f"{what} failed after {policy.max_attempts} attempts: "
                 f"{last}")
    assert last is not None
    raise last

