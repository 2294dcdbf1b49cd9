"""Dynamic loss scaling for fp16 training.

Counterpart of ``deepspeed_tpu/runtime/fp16/loss_scaler.py``, with the
same state machine: the scale doubles (``scale_factor``) after
``scale_window`` consecutive overflow-free steps and falls by the factor
on an overflow once ``hysteresis`` overflows have been tolerated, never
below ``min_scale``.  The state lives in device tensors and every
transition is a ``torch.where`` select, so a training step that updates
it still waits for nothing on the host: the overflow check is one
``isfinite`` reduction over the gradients, kept on the device.
"""
from __future__ import annotations

from typing import Iterable, NamedTuple

import torch


class LossScaleState(NamedTuple):
    scale: torch.Tensor        # f32 scalar
    good_steps: torch.Tensor   # i32 consecutive overflow-free steps
    hysteresis: torch.Tensor   # i32 overflows still tolerated before a fall


class DynamicLossScaler:
    #: False for a static scale: overflow is never detected and no step is
    #: skipped (the reference ``LossScaler``), so non-finite gradients
    #: reach the parameters as they would there
    detect_overflow: bool = True

    def __init__(self, initial_scale_power: int = 16,
                 scale_window: int = 1000, min_scale: float = 1.0,
                 hysteresis: int = 2, scale_factor: float = 2.0):
        self.initial_scale = 2.0 ** initial_scale_power
        self.scale_window = scale_window
        self.min_scale = min_scale
        self.hysteresis = hysteresis
        self.scale_factor = scale_factor

    def init(self, device=None) -> LossScaleState:
        return LossScaleState(
            scale=torch.tensor(self.initial_scale, dtype=torch.float32,
                               device=device),
            good_steps=torch.zeros((), dtype=torch.int32, device=device),
            hysteresis=torch.tensor(self.hysteresis, dtype=torch.int32,
                                    device=device))

    @staticmethod
    def has_overflow(grads: Iterable[torch.Tensor]) -> torch.Tensor:
        """True (a bool device scalar) when any gradient element is inf
        or NaN."""
        finite = None
        for g in grads:
            f = torch.isfinite(g).all()
            finite = f if finite is None else finite & f
        if finite is None:
            return torch.zeros((), dtype=torch.bool)
        return ~finite

    def update(self, state: LossScaleState,
               overflow: torch.Tensor) -> LossScaleState:
        """The next state after a step with (bool device scalar)
        ``overflow``."""
        hys = torch.where(overflow, torch.clamp(state.hysteresis - 1, min=0),
                          state.hysteresis)
        shrink = overflow & (state.hysteresis <= 1)
        new_scale = torch.where(
            shrink, torch.clamp(state.scale / self.scale_factor,
                                min=self.min_scale), state.scale)
        good = torch.where(overflow, torch.zeros_like(state.good_steps),
                           state.good_steps + 1)
        grow = ~overflow & (good >= self.scale_window)
        new_scale = torch.where(grow, new_scale * self.scale_factor,
                                new_scale)
        good = torch.where(grow, torch.zeros_like(good), good)
        hys = torch.where(grow | shrink,
                          torch.full_like(hys, self.hysteresis), hys)
        return LossScaleState(scale=new_scale, good_steps=good,
                              hysteresis=hys)


def static_loss_scaler(scale: float) -> DynamicLossScaler:
    """A fixed scale (the reference ``LossScaler``): the scale never
    moves and overflow is never detected, so no update is skipped."""
    s = DynamicLossScaler(initial_scale_power=0, scale_window=1 << 30,
                          min_scale=scale, hysteresis=1, scale_factor=1.0)
    s.initial_scale = scale
    s.detect_overflow = False
    return s
