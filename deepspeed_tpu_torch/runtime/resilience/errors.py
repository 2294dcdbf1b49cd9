"""Failure taxonomy for the resilience layer.

The reference stack surfaces storage failures as whatever the backend
throws (aio retcodes, torch.save IOError, Nebula commit errors); callers
cannot tell a retriable blip from a lost device. Here every I/O failure is
classified into exactly one of two types before it crosses a subsystem
boundary:

  ``TransientIOError`` — the operation may succeed if repeated (EIO on a
      flaky NVMe queue, EAGAIN/EINTR, a timed-out host-store write). The
      retry layer (`retry.py`) eats these up to the policy budget.
  ``FatalIOError``     — repeating cannot help (corrupt data, layout
      mismatch, permission denied, disk gone). Never retried; propagate
      loudly.

``classify_errno`` is the single source of which OS errnos count as
transient, shared by the retry predicate and the fault injector.
"""
from __future__ import annotations

import errno


class TransientIOError(OSError):
    """An I/O failure that is expected to succeed on retry."""


class FatalIOError(OSError):
    """An I/O failure that retrying cannot fix — propagate, never loop."""


class CheckpointCorruptionError(FatalIOError):
    """A checkpoint tag failed integrity verification (bad checksum,
    truncated artifact, missing manifest entry) and no verified fallback
    tag exists."""


class ServingError(RuntimeError):
    """The serving stack (inference/serving/) cannot make progress or
    detected an invariant violation: no-progress watchdog trips,
    preemption-thrash pin-or-fail, fatal dispatch faults, and the block
    pool's own :class:`BlockPoolError` all branch here — a serving bug
    or an undersized deployment surfaces loudly, never as a silent
    spin or a corrupted KV cache.  Deliberately NOT an ``OSError``:
    nothing in this family is retriable I/O (``is_transient`` is never
    True for it) — the remedies are scheduling decisions (shed, fail
    the request, raise to the operator), not the retry layer."""


#: OS errnos worth retrying: device/queue blips and interrupted syscalls.
#: Deliberately excludes ENOSPC/EROFS/EACCES/ENOENT — repeating those
#: just repeats the failure.
TRANSIENT_ERRNOS = frozenset({
    errno.EIO, errno.EAGAIN, errno.EINTR, errno.EBUSY, errno.ETIMEDOUT,
})


def is_transient(exc: BaseException) -> bool:
    """True if ``exc`` is worth retrying under the shared taxonomy."""
    if isinstance(exc, FatalIOError):
        return False
    if isinstance(exc, TransientIOError):
        return True
    if isinstance(exc, OSError):
        return exc.errno in TRANSIENT_ERRNOS
    return False
