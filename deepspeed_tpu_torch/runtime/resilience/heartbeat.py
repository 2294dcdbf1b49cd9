"""Worker liveness: heartbeat files + a watchdog, and a thread-based
timeout guard for device syncs.

The elastic agent's monitor loop (elasticity/elastic_agent.py) can see a
DEAD worker (poll() returns a code) but not a HUNG one — a worker wedged
in a collective or a device sync keeps its process alive forever, and the
reference's torch-elastic monitor has the same blind spot. The contract
here: each worker touches a per-rank heartbeat file on a cadence; the
agent treats a running worker whose heartbeat is older than the watchdog
timeout as hung and kills it, which feeds the normal re-rendezvous path.

``run_with_timeout`` is the in-process cousin: bound a possibly-wedged
blocking call (e.g. a device synchronize on a sick card) and turn it
into a logged error instead of a hang.

Copy of ``deepspeed_tpu/runtime/resilience/heartbeat.py`` for the
PyTorch port (it imports no JAX); the serving engine beats at every
iteration boundary and the training engine at every step.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Callable, List, Optional, Sequence

#: env var the elastic agent sets for each worker: path of the heartbeat
#: file that worker must touch (`beat`) on its training cadence.
ENV_HEARTBEAT_FILE = "DSTPU_HEARTBEAT_FILE"


def beat(path: str) -> None:
    """Touch the heartbeat file (create if missing, bump mtime)."""
    with open(path, "a"):
        pass
    os.utime(path, None)


def heartbeat_age(path: str, now: Optional[float] = None) -> float:
    """Seconds since the last beat; +inf if the file does not exist
    (a worker that never checked in is indistinguishable from hung)."""
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        return float("inf")
    return (now if now is not None else time.time()) - mtime


def is_stale(path: str, timeout_s: float,
             now: Optional[float] = None) -> bool:
    return heartbeat_age(path, now=now) > timeout_s


class Heartbeat:
    """Worker-side rate-limited beater: call ``maybe_beat()`` every
    iteration; it touches the file at most once per interval. Reads the
    target path from ``DSTPU_HEARTBEAT_FILE`` when not given one —
    workers launched outside an elastic agent become no-ops."""

    def __init__(self, path: Optional[str] = None,
                 interval_s: float = 1.0):
        self.path = path or os.environ.get(ENV_HEARTBEAT_FILE)
        self.interval_s = interval_s
        self._last = 0.0

    @property
    def enabled(self) -> bool:
        return self.path is not None

    def maybe_beat(self) -> None:
        if self.path is None:
            return
        now = time.monotonic()
        if now - self._last >= self.interval_s:
            self._last = now
            beat(self.path)

    def beat_now(self) -> None:
        """Unconditional beat (bracketing a long operation like a
        checkpoint write, where the next regular beat may be far away)."""
        if self.path is None:
            return
        self._last = time.monotonic()
        beat(self.path)


class Watchdog:
    """Agent-side staleness check over a set of heartbeat files."""

    def __init__(self, timeout_s: float):
        if timeout_s <= 0:
            raise ValueError(f"watchdog timeout must be > 0, got {timeout_s}")
        self.timeout_s = timeout_s

    def stale(self, paths: Sequence[str]) -> List[int]:
        now = time.time()
        return [i for i, p in enumerate(paths)
                if is_stale(p, self.timeout_s, now=now)]


def run_with_timeout(fn: Callable[[], None], timeout_s: float,
                     ) -> bool:
    """Run a blocking call on a daemon thread; True iff it finished
    within ``timeout_s``. Exceptions from ``fn`` re-raise in the caller;
    on timeout the thread is abandoned (daemon — a truly wedged device
    sync cannot be cancelled, only contained) and False returned."""
    err: list = []
    done = threading.Event()

    def _run():
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 — relayed to caller
            err.append(e)
        finally:
            done.set()

    t = threading.Thread(target=_run, daemon=True,
                         name="resilience-timeout-guard")
    t.start()
    if not done.wait(timeout_s):
        return False
    if err:
        raise err[0]
    return True
