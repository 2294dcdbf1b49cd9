"""Dense-cache decode attention: kernel B5 and its plain version.

Counterpart of ``deepspeed_tpu/ops/transformer/decode_attention.py``
(`_kernel_heads` via `decode_attention`).  One new query token per batch
row attends over the contiguous ``[B, S, H, D]`` KV cache up to one
valid length.  The kernel is ``csrc/decode_attention.cu``; the plain
PyTorch version beside it is what the CPU runs and what the card's
kernel is checked against.

Layout contract (the JAX package's): q ``[B, H, D]``, k/v
``[B, S, H, D]``, ``length`` the valid cache prefix (index of the new
token + 1); returns ``[B, H, D]``.  Rows at or past ``length`` are never
read, so any content there (NaN included) cannot reach the result, and
``length == 0`` gives zero rows.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from .. import build

_NAME = "decode_attention"
_SYM = "dstt_decode_attention"

#: heads per block and key rows per block iteration in the kernel
_HEADS_PER_BLOCK = 4
#: a split never holds fewer positions than this
_MIN_SPLIT_ROWS = 64


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           length: int) -> None:
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"decode_attention: q must be [B, H, D] and k/v "
                         f"[B, S, H, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    if k.shape != v.shape:
        raise ValueError(f"decode_attention: k {tuple(k.shape)} != v "
                         f"{tuple(v.shape)}")
    b, h, d = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d):
        raise ValueError(f"decode_attention: cache {tuple(k.shape)} does "
                         f"not match q {tuple(q.shape)} as [B, S, H, D]")
    if not 0 <= int(length) <= k.shape[1]:
        raise ValueError(f"decode_attention: length {length} outside "
                         f"[0, {k.shape[1]}]")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"decode_attention: q/k/v dtypes differ "
                        f"({q.dtype}, {k.dtype}, {v.dtype})")
    if not (q.device == k.device == v.device):
        raise ValueError("decode_attention: q/k/v on different devices")


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, length: int,
                           sm_scale: Optional[float] = None
                           ) -> torch.Tensor:
    """Plain PyTorch version: softmax over the valid prefix in f32."""
    _check(q, k, v, length)
    length = int(length)
    if length == 0:
        return torch.zeros_like(q)
    scale = sm_scale or 1.0 / math.sqrt(q.shape[-1])
    kf = k[:, :length].float()
    vf = v[:, :length].float()
    s = torch.einsum("bhd,bshd->bhs", q.float(), kf) * scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhs,bshd->bhd", p, vf).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_plan(batch: int, heads: int, length: int, sms: int
               ) -> Tuple[int, int]:
    """(number of position splits, positions per split): enough blocks
    for about two per SM, no split shorter than ``_MIN_SPLIT_ROWS``."""
    blocks = batch * -(-heads // _HEADS_PER_BLOCK)
    nsplit = max(1, min(-(-2 * sms // blocks),
                        -(-length // _MIN_SPLIT_ROWS)))
    split_len = max(1, -(-length // nsplit))
    return -(-max(length, 1) // split_len), split_len


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = build.load_library(_NAME)
    fn = getattr(lib, _SYM)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, I, ctypes.c_float,
                   I, P]
    fn.restype = I
    return lib, fn


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: int, sm_scale: Optional[float] = None
                     ) -> torch.Tensor:
    """Kernel B5 on CUDA tensors; the plain version on CPU tensors."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, length, sm_scale)
    _check(q, k, v, length)
    code = build.dtype_code(q, "decode_attention")
    build.check_layout(_NAME, (("q", q), ("k", k), ("v", v)), q.shape[-1],
                       q.element_size())
    b, h, d = q.shape
    s = k.shape[1]
    length = int(length)
    scale = sm_scale or 1.0 / math.sqrt(d)
    nsplit, split_len = split_plan(b, h, length,
                                   _sm_count(q.device.index or 0))
    out = torch.empty_like(q)
    part_ml = part_acc = None
    if nsplit > 1:
        part_ml = torch.empty((b * h * nsplit * 2,), dtype=torch.float32,
                              device=q.device)
        part_acc = torch.empty((b * h * nsplit * d,), dtype=torch.float32,
                               device=q.device)
    lib, fn = _kernel()
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if part_ml is None else part_ml.data_ptr(),
            None if part_acc is None else part_acc.data_ptr(),
            b, s, h, d, length, nsplit, split_len, scale, code,
            build.current_stream(q.device))
    build.check_launch(lib, _SYM, rc)
    build.launch_counts[_NAME] += 1
    return out
