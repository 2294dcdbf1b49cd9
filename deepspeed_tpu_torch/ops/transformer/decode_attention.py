"""Dense-cache decode attention: kernel B5 and its plain version.

Counterpart of ``deepspeed_tpu/ops/transformer/decode_attention.py``
(`_kernel_heads` via `decode_attention`).  One new query token per batch
row attends over the contiguous KV cache up to one valid length.  The
kernel is ``csrc/decode_attention.cu``; the plain PyTorch version beside
it is what the CPU runs and what the card's kernel is checked against.

Layout contract: q ``[B, H, D]``, k/v ``[B, S, Hkv, D]`` with ``H % Hkv
== 0``, ``length`` the valid cache prefix (index of the new token + 1);
returns ``[B, H, D]``.  Query head h reads kv head ``h // (H / Hkv)``
(the map of B1, B6 and B7), so a grouped-query cache is read at kv-head
width and never expanded; ``Hkv == H`` is the JAX kernel's contract (the
JAX model expands a grouped cache with ``expand_kv`` first, which gives
the same result).  Rows at or past ``length`` are never read, so any
content there (NaN included) cannot reach the result, and ``length ==
0`` gives zero rows.

The bf16 and f16 kernel runs one block per (batch row, kv head, split) and
merges a row's splits inside one thread-block cluster
(:func:`cluster_plan`), at every head dim that is a multiple of 8 up to
256 and any group (a group of more than 4096 output features is split
across blocks, each reading the kv head's rows); the f32 kernel keeps one warp per head and a
second merge launch over a scratch (:func:`split_plan`).  The paged
decode kernel B6 splits each slot's table the same way
(:func:`paged_split_plan`).
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

#: heads per block of the f32 kernel
_HEADS_PER_BLOCK = 4
#: a split never holds fewer positions than this
_MIN_SPLIT_ROWS = 64
#: the bf16 kernel's cluster holds at most this many splits (the portable
#: cluster size) and a block at most this many output features (g * D; a
#: larger kv group is split across blocks, ``build.group_parts``)
_MAX_SPLITS = 8
_MAX_GROUP_DIM = 4096


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           length: int) -> None:
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"decode_attention: q must be [B, H, D] and k/v "
                         f"[B, S, Hkv, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    if k.shape != v.shape:
        raise ValueError(f"decode_attention: k {tuple(k.shape)} != v "
                         f"{tuple(v.shape)}")
    b, h, d = q.shape
    hkv = k.shape[2]
    if (k.shape[0], k.shape[3]) != (b, d) or hkv < 1 or h % hkv:
        raise ValueError(f"decode_attention: cache {tuple(k.shape)} does "
                         f"not match q {tuple(q.shape)} as [B, S, Hkv, D] "
                         f"with H a multiple of Hkv")
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
    g = q.shape[1] // k.shape[2]
    kf = k[:, :length].float().repeat_interleave(g, dim=2)
    vf = v[:, :length].float().repeat_interleave(g, dim=2)
    s = torch.einsum("bhd,bshd->bhs", q.float(), kf) * scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhs,bshd->bhd", p, vf).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_plan(batch: int, heads: int, length: int, sms: int
               ) -> Tuple[int, int]:
    """The f32 kernel's (number of position splits, positions per
    split): enough blocks for about two per SM, no split shorter than
    ``_MIN_SPLIT_ROWS``."""
    blocks = batch * -(-heads // _HEADS_PER_BLOCK)
    nsplit = max(1, min(-(-2 * sms // blocks),
                        -(-length // _MIN_SPLIT_ROWS)))
    split_len = max(1, -(-length // nsplit))
    return -(-max(length, 1) // split_len), split_len


def cluster_plan(batch: int, kv_heads: int, length: int, sms: int
                 ) -> Tuple[int, int]:
    """The bf16 kernel's (splits of one (row, kv head), positions per
    split): positions are split only until the B * Hkv * nsplit blocks
    reach one an SM, into at most ``_MAX_SPLITS`` (one cluster) splits of
    at least ``_MIN_SPLIT_ROWS`` rows, each a whole number of them."""
    blocks = batch * kv_heads
    nsplit = max(1, min(-(-sms // blocks), _MAX_SPLITS,
                        -(-length // _MIN_SPLIT_ROWS)))
    split_len = -(-max(length, 1) // nsplit)
    split_len = -(-split_len // _MIN_SPLIT_ROWS) * _MIN_SPLIT_ROWS
    return -(-max(length, 1) // split_len), split_len


def paged_split_plan(npages: int, block: int) -> Tuple[int, int]:
    """The bf16 paged decode kernel B6's (ranks of one cluster, rows a
    rank): a slot's table of ``npages`` pages of ``block`` rows cut into
    at most ``_MAX_SPLITS`` splits of whole pages, each at least
    ``_MIN_SPLIT_ROWS`` rows (a shorter table is one split).  The plan
    comes from the table's width because the slots' lengths live on the
    card; rank r walks rows ``[r * split_len, min((r + 1) * split_len,
    length))``, and a rank whose split starts at or past the length adds
    nothing."""
    npages = max(1, npages)
    pages = max(-(-npages // _MAX_SPLITS), -(-_MIN_SPLIT_ROWS // block))
    pages = min(pages, npages)
    return -(-npages // pages), pages * block


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = build.load_library(_NAME)
    fn = getattr(lib, _SYM)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, I, I, I,
                   ctypes.c_float, I, P]
    fn.restype = I
    return lib, fn


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: int, sm_scale: Optional[float] = None
                     ) -> torch.Tensor:
    """Kernel B5 on CUDA tensors; the plain version on CPU tensors."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, length, sm_scale)
    _check(q, k, v, length)
    b, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    build.check_supports(_NAME, d, h // hkv, q.dtype)
    code = build.dtype_code(q, _NAME)
    build.check_layout(_NAME, (("q", q), ("k", k), ("v", v)))
    length = int(length)
    scale = sm_scale or 1.0 / math.sqrt(d)
    sms = _sm_count(q.device.index or 0)
    parts = 1
    if code == 0:
        nsplit, split_len = split_plan(b, h, length, sms)
    else:
        parts = build.group_parts(h // hkv, d, _MAX_GROUP_DIM)
        nsplit, split_len = cluster_plan(b, hkv * parts, length, sms)
    out = torch.empty_like(q)
    part_ml = part_acc = None
    if code == 0 and nsplit > 1:
        part_ml = torch.empty((b * h * nsplit * 2,), dtype=torch.float32,
                              device=q.device)
        part_acc = torch.empty((b * h * nsplit * d,), dtype=torch.float32,
                               device=q.device)
    lib, fn = _kernel()
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if part_ml is None else part_ml.data_ptr(),
            None if part_acc is None else part_acc.data_ptr(),
            b, s, h, hkv, d, parts, length, nsplit, split_len, scale, code,
            build.current_stream(q.device))
    build.check_launch(lib, _SYM, rc)
    build.launch_counts[build.counter(_NAME, dtype=q.dtype)] += 1
    return out
