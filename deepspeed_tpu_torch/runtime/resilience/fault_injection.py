"""Deterministic fault injection for the resilience layer.

Copy of ``deepspeed_tpu/runtime/resilience/fault_injection.py`` for the
PyTorch port (it imports no JAX), cut to what the port instruments: the
checkpoint sites and the ``fail`` / ``fatal`` / ``truncate`` kinds.  The
sites and kinds of the subsystems still to port come back with them.

The integrity/retry machinery is only trustworthy if its failure paths
run in CI. ``FaultInjector`` lets tests (and brave operators) make the
Nth call at a named site fail deterministically — no monkeypatching the
I/O stack, no flaky timing. Sites are plain strings checked by the
instrumented code paths:

    checkpoint.artifact    each artifact file as a tag commit fingerprints it
    checkpoint.publish     the meta/manifest/'latest' publish of a tag

Fault kinds:

    fail      raise TransientIOError (the retry layer should absorb it)
    fatal     raise FatalIOError (must NOT be retried)
    truncate  truncate the site's file to ``arg`` bytes (torn write)

Activation is env-driven (``DSTPU_FAULTS``) or programmatic (tests call
``add_plan``). Env grammar, ';'-separated::

    DSTPU_FAULTS="site=kind:at[:count[:arg]];site2=kind:at"
    # e.g. fail the 2nd and 3rd publishes of a tag:
    DSTPU_FAULTS="checkpoint.publish=fail:2:2"

``at`` is the 1-based call index at which the fault first fires; ``count``
is how many consecutive calls fire (-1 = forever). With no plans the
check is one dict lookup — safe to leave in production paths.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

from ...utils.logging import logger
from .errors import FatalIOError, TransientIOError

ENV_FAULTS = "DSTPU_FAULTS"

_KINDS = ("fail", "fatal", "truncate")


@dataclasses.dataclass
class FaultPlan:
    kind: str
    at: int = 1          # 1-based call index of the first firing
    count: int = 1       # consecutive firings; -1 = every call from ``at``
    arg: float = 0.0     # truncate size (bytes)

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; one of {_KINDS}")
        if self.at < 1:
            raise ValueError(f"fault 'at' is a 1-based index, got {self.at}")

    def active(self, n: int) -> bool:
        if n < self.at:
            return False
        return self.count < 0 or n < self.at + self.count


class FaultInjector:
    """Per-site call counters + plans. Thread-compatible for the async
    checkpoint writer that hits it (counter bumps are GIL-atomic dict ops
    and exact ordering across racing sites is not part of the contract)."""

    def __init__(self, plans: Optional[Dict[str, FaultPlan]] = None):
        self.plans: Dict[str, FaultPlan] = dict(plans or {})
        self.calls: Dict[str, int] = {}
        self.fired: Dict[str, int] = {}

    # -- construction ------------------------------------------------------
    @classmethod
    def from_env(cls, env: Optional[Dict[str, str]] = None
                 ) -> "FaultInjector":
        spec = (env if env is not None else os.environ).get(ENV_FAULTS, "")
        fi = cls()
        for entry in filter(None, (s.strip() for s in spec.split(";"))):
            try:
                site, rest = entry.split("=", 1)
                parts = rest.split(":")
                fi.add_plan(site.strip(), parts[0],
                            at=int(parts[1]) if len(parts) > 1 else 1,
                            count=int(parts[2]) if len(parts) > 2 else 1,
                            arg=float(parts[3]) if len(parts) > 3 else 0.0)
            except (ValueError, IndexError) as e:
                raise ValueError(
                    f"bad {ENV_FAULTS} entry {entry!r} "
                    f"(grammar: site=kind:at[:count[:arg]]): {e}") from e
        return fi

    def add_plan(self, site: str, kind: str, at: int = 1, count: int = 1,
                 arg: float = 0.0) -> None:
        self.plans[site] = FaultPlan(kind, at=at, count=count, arg=arg)

    def reset(self) -> None:
        self.plans.clear()
        self.calls.clear()
        self.fired.clear()

    # -- the hook ----------------------------------------------------------
    def check(self, site: str, path: Optional[str] = None) -> None:
        """Instrumented sites call this once per operation. Raises or
        truncates per the active plan, else no-ops."""
        plan = self.plans.get(site)
        if plan is None:
            return
        n = self.calls.get(site, 0) + 1
        self.calls[site] = n
        if not plan.active(n):
            return
        self.fired[site] = self.fired.get(site, 0) + 1
        logger.warning(f"FaultInjector: firing {plan.kind!r} at {site} "
                       f"(call {n})")
        if plan.kind == "fail":
            raise TransientIOError(
                f"injected transient fault at {site} (call {n})")
        if plan.kind == "fatal":
            raise FatalIOError(
                f"injected fatal fault at {site} (call {n})")
        if plan.kind == "truncate":
            if path is None:
                raise ValueError(
                    f"truncate fault at {site} needs a file path")
            self.truncate_file(path, int(plan.arg))

    @staticmethod
    def truncate_file(path: str, nbytes: int = 0) -> None:
        """Simulate a torn write: keep the first ``nbytes`` bytes."""
        with open(path, "r+b") as f:
            f.truncate(max(0, int(nbytes)))

    def fire_count(self, site: str) -> int:
        return self.fired.get(site, 0)


_INJECTOR: Optional[FaultInjector] = None


def get_fault_injector() -> FaultInjector:
    """Process-global injector, built from ``DSTPU_FAULTS`` on first use."""
    global _INJECTOR
    if _INJECTOR is None:
        _INJECTOR = FaultInjector.from_env()
    return _INJECTOR


def install_fault_injector(fi: Optional[FaultInjector]) -> FaultInjector:
    """Replace the global injector (tests); None reinstalls from env."""
    global _INJECTOR
    _INJECTOR = fi if fi is not None else FaultInjector.from_env()
    return _INJECTOR
