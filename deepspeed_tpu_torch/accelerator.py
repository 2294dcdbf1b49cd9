"""Device resolution for the PyTorch port.

Counterpart of ``deepspeed_tpu/accelerator/tpu_accelerator.py``.  The
port runs on a CUDA card; the CPU is used only when a caller asks for it
with ``device="cpu"`` (the tests do, to run the kernels' plain
versions).  There is no silent fallback: asking for the card on a host
without one raises.
"""
from __future__ import annotations

import subprocess
from typing import Dict, Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the card.  Raises when a CUDA device is requested
    (explicitly or by default) and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch versions of the kernels on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    return dev


def device_report(device: Optional[Union[str, torch.device]] = None
                  ) -> Dict[str, object]:
    """Name, compute capability, SM count and power limit of a card —
    the facts every measurement is written down beside."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("device_report needs a CUDA device")
    props = torch.cuda.get_device_properties(dev)
    return {"name": torch.cuda.get_device_name(dev),
            "capability": f"{props.major}.{props.minor}",
            "sms": props.multi_processor_count,
            "memory_bytes": props.total_memory,
            "nvidia_smi": nvidia_smi_line(dev.index or 0)}


def nvidia_smi_line(index: int = 0) -> str:
    """``name, power.limit`` exactly as ``nvidia-smi`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}",
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()
