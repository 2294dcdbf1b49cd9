"""Host-side tensor interop shared by the port's checkpoint loaders
(counterpart of ``deepspeed_tpu/utils/interop.py``): a state dict's
values may be torch tensors of any dtype and device, or numpy arrays."""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def to_numpy(t: Any, dtype=np.float32) -> np.ndarray:
    """torch tensor / array-like → host numpy.  ``dtype=None`` keeps the
    source dtype (integer buffers such as position ids); the default f32
    cast also takes torch bf16, which numpy cannot hold."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if dtype is not None:
            t = t.float()
        t = t.numpy()
    return np.asarray(t) if dtype is None else np.asarray(t, dtype=dtype)


def to_f32(t: Any) -> torch.Tensor:
    """torch tensor / array-like → a float32 CPU tensor of its own (a
    loader's output shares no memory with the state dict)."""
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float32, copy=True)
    return torch.from_numpy(to_numpy(t).copy())
