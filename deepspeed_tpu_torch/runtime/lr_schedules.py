"""LR schedules: pure functions ``step -> lr``.

Counterpart of ``deepspeed_tpu/runtime/lr_schedules.py`` with the same
vocabulary (LRRangeTest, OneCycle, WarmupLR, WarmupDecayLR,
WarmupCosineLR, Constant) and the same float32 arithmetic.  ``step`` is
an integer tensor (the engine's ``state["step"]`` on the device) and the
result is a float32 tensor on the same device, so the training step
reads its learning rate without a host sync.
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import torch

LRSchedule = Callable[[torch.Tensor], torch.Tensor]


def _f32(step: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant_lr(lr: float) -> LRSchedule:
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)


def warmup_lr(warmup_min_lr: float = 0.0, warmup_max_lr: float = 0.001,
              warmup_num_steps: int = 1000,
              warmup_type: str = "log") -> LRSchedule:
    """Warm up then hold."""
    wmin, wmax = float(warmup_min_lr), float(warmup_max_lr)
    wsteps = max(1, int(warmup_num_steps))

    def sched(step):
        s = torch.clamp(_f32(step), max=float(wsteps))
        if warmup_type == "log":
            frac = torch.log1p(s) / math.log(wsteps + 1)
        else:
            frac = s / wsteps
        return wmin + (wmax - wmin) * torch.clamp(frac, 0.0, 1.0)

    return sched


def warmup_decay_lr(total_num_steps: int, warmup_min_lr: float = 0.0,
                    warmup_max_lr: float = 0.001,
                    warmup_num_steps: int = 1000,
                    warmup_type: str = "log") -> LRSchedule:
    """Warm up, then decay linearly to 0 at ``total_num_steps``."""
    warm = warmup_lr(warmup_min_lr, warmup_max_lr, warmup_num_steps,
                     warmup_type)
    total = float(total_num_steps)
    wsteps = float(max(1, warmup_num_steps))

    def sched(step):
        s = _f32(step)
        decay = torch.clamp((total - s) / max(total - wsteps, 1.0), 0.0, 1.0)
        return torch.where(s < wsteps, warm(step), warmup_max_lr * decay)

    return sched


def warmup_cosine_lr(total_num_steps: int, warmup_min_ratio: float = 0.0,
                     warmup_num_steps: int = 1000, cos_min_ratio: float = 0.0,
                     warmup_max_lr: float = 0.001) -> LRSchedule:
    total = float(total_num_steps)
    wsteps = float(max(1, warmup_num_steps))

    def sched(step):
        s = _f32(step)
        warm_frac = warmup_min_ratio + (1 - warmup_min_ratio) * torch.clamp(
            s / wsteps, 0.0, 1.0)
        prog = torch.clamp((s - wsteps) / max(total - wsteps, 1.0), 0.0, 1.0)
        cos = cos_min_ratio + (1 - cos_min_ratio) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return warmup_max_lr * torch.where(s < wsteps, warm_frac, cos)

    return sched


def one_cycle(cycle_min_lr: float, cycle_max_lr: float,
              cycle_first_step_size: int = 2000,
              cycle_second_step_size: int = None,
              decay_step_size: int = 0,
              decay_lr_rate: float = 0.0) -> LRSchedule:
    """Triangular cycle, then an optional decay phase."""
    up = float(cycle_first_step_size)
    down = float(cycle_second_step_size
                 if cycle_second_step_size is not None else up)

    def sched(step):
        s = _f32(step)
        in_up = s < up
        in_down = (s >= up) & (s < up + down)
        frac_up = torch.clamp(s / up, 0.0, 1.0)
        frac_down = torch.clamp((s - up) / down, 0.0, 1.0)
        lr_cycle = torch.where(
            in_up, cycle_min_lr + (cycle_max_lr - cycle_min_lr) * frac_up,
            cycle_max_lr - (cycle_max_lr - cycle_min_lr) * frac_down)
        if decay_step_size > 0:
            decay_steps = torch.clamp(s - (up + down), min=0.0) \
                / decay_step_size
            lr_decayed = cycle_min_lr / (1.0 + decay_steps * decay_lr_rate)
            return torch.where(in_up | in_down, lr_cycle, lr_decayed)
        return torch.where(in_up | in_down, lr_cycle,
                           torch.full_like(lr_cycle, cycle_min_lr))

    return sched


def lr_range_test(lr_range_test_min_lr: float = 1e-3,
                  lr_range_test_step_size: int = 2000,
                  lr_range_test_step_rate: float = 1.0,
                  lr_range_test_staircase: bool = False) -> LRSchedule:
    """Linearly (or staircase) increasing LR probe."""
    def sched(step):
        s = _f32(step) / lr_range_test_step_size
        if lr_range_test_staircase:
            s = torch.floor(s)
        return lr_range_test_min_lr * (1.0 + s * lr_range_test_step_rate)

    return sched


REGISTRY: Dict[str, Callable[..., LRSchedule]] = {
    "WarmupLR": warmup_lr,
    "WarmupDecayLR": warmup_decay_lr,
    "WarmupCosineLR": warmup_cosine_lr,
    "OneCycle": one_cycle,
    "LRRangeTest": lr_range_test,
    "Constant": lambda lr=1e-3: constant_lr(lr),
}


def get_lr_schedule(type_name: str, params: dict) -> LRSchedule:
    if type_name not in REGISTRY:
        raise ValueError(
            f"Unknown scheduler {type_name}; have {sorted(REGISTRY)}")
    return REGISTRY[type_name](**params)
