"""Token streaming: the event type and a small collection helper.

The serving engine delivers tokens to callers AT ITERATION BOUNDARIES
(the continuous-batching loop is single-threaded; callbacks run on the
serving thread between dispatches, never concurrently with one).  Each
emitted token — and each non-OK terminal transition — becomes one
:class:`TokenEvent`; a request's stream therefore always ends with an
event whose ``final`` is True, carrying the terminal
:class:`~..scheduler.RequestStatus`.

Exceptions raised by a callback disable THAT stream (logged once); the
request keeps generating and every other stream is untouched — a slow
or broken consumer must never stall the batch.

Copy of ``deepspeed_tpu/inference/serving/frontend/streaming.py`` for
the PyTorch port (it imports no JAX).
"""
from __future__ import annotations

from typing import Any, List, NamedTuple, Optional


class TokenEvent(NamedTuple):
    """One streamed token (or terminal marker) of one request.

    ``token`` is None for a tokenless terminal event (shed / cancelled
    / timed-out / failed before any token).  ``index`` is the token's
    OUTPUT index (0 = first generated token).  ``status`` is the
    request's lifecycle status AT FLUSH TIME — None while in flight,
    the terminal :class:`RequestStatus` on the stream's last event
    (``final`` True).  ``time_s``/``prev_time_s`` are perf-counter
    stamps of this and the previous token (inter-token latency =
    ``time_s - prev_time_s``)."""
    request: Any
    token: Optional[int]
    index: int
    status: Any
    final: bool
    tenant: str
    time_s: float
    prev_time_s: Optional[float]


class StreamReplayError(RuntimeError):
    """A replayed stream diverged from what was already delivered —
    the fold-in key schedule's bit-identical replay contract was
    violated (wrong key on resubmit, or a non-deterministic sampler)."""


class StreamDeduper:
    """Fleet-level exactly-once filter over a (possibly replayed)
    token stream (docs/serving.md "Fleet serving & failover").

    Token-exact failover resubmits a dead replica's request from token
    0 — the fold-in key schedule makes the replayed stream bit-identical
    — so the client-facing stream must forward only tokens past the
    high-water mark already delivered.  ``admit`` returns the event to
    forward, or None for a replayed duplicate (counted in
    ``duplicates``); a duplicate whose token differs from what was
    delivered at that index raises :class:`StreamReplayError` — better
    a loud failover bug than a silently forked stream.  Tokenless
    terminal events pass through untouched (they carry no index to
    deduplicate)."""

    def __init__(self) -> None:
        self.delivered: List[int] = []
        self.duplicates = 0

    @property
    def high_water(self) -> int:
        """Number of tokens already forwarded to the client."""
        return len(self.delivered)

    def admit(self, ev: TokenEvent) -> Optional[TokenEvent]:
        if ev.token is None:
            return ev
        if ev.index < len(self.delivered):
            self.duplicates += 1
            if self.delivered[ev.index] != ev.token:
                raise StreamReplayError(
                    f"replayed stream diverged at index {ev.index}: "
                    f"delivered {self.delivered[ev.index]}, replay "
                    f"emitted {ev.token}")
            return None
        if ev.index > len(self.delivered):
            raise StreamReplayError(
                f"stream gap: expected index {len(self.delivered)}, "
                f"got {ev.index}")
        self.delivered.append(ev.token)
        return ev


class StreamCollector:
    """Minimal ``on_token`` sink: records tokens and events in arrival
    order (tests and the replay bench read ``tokens`` / ``events``
    after the drain)."""

    def __init__(self) -> None:
        self.tokens: List[int] = []
        self.events: List[TokenEvent] = []

    def __call__(self, ev: TokenEvent) -> None:
        self.events.append(ev)
        if ev.token is not None:
            self.tokens.append(ev.token)

    @property
    def finished(self) -> bool:
        return bool(self.events) and self.events[-1].final
