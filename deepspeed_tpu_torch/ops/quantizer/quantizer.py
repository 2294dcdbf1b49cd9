"""Grouped and per-row integer quantization.

Counterpart of ``deepspeed_tpu/ops/quantizer/quantizer.py`` for the
serving paths: the int4 nibble packing, grouped weight quantization
(``quantize``/``dequantize``, the int8 weight-only engine) and the
paged-KV row codec (``kv_quantize``/``kv_dequantize``, whose decode the
paged attention kernels B6/B7 fuse into their loads).  The same math as
the JAX package's inside its compiled programs: f32 arithmetic,
``torch.round`` (half to even, as ``jnp.round``), the same clamps (1e-12
for groups, 1e-8 for KV rows), a NaN value quantizing to 0 (XLA's
float-to-int conversion) and int8 outputs.  A scale is ``max * (1 /
qmax)``: under ``jit`` XLA turns the JAX code's division by the constant
``qmax`` into that product (and PyTorch on CUDA does the same with a
division by a scalar), so writing the product gives the JAX programs'
bits on the CPU and on the card alike.  The fake-quant functions of
QAT/MoQ belong to the compression slice (ROADMAP.md queue A item 9).

All grouped functions work on the tensor flattened to ``[num_groups,
elems / num_groups]``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _to_int(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Integral-valued f32 (already clipped) to ``dtype``; NaN becomes 0,
    as XLA converts it (a bare cast of NaN is undefined in C++)."""
    return torch.nan_to_num(x, nan=0.0).to(dtype)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack signed int4 values (range [-8, 7]) two per int8 along the
    LAST axis: element ``2j`` in the low nibble of byte ``j``, element
    ``2j + 1`` in the high nibble.  An odd trailing size is padded with a
    zero nibble (``unpack_int4`` drops it given the original size)."""
    q = q.to(torch.int32)
    if q.shape[-1] % 2:
        q = torch.cat([q, q.new_zeros(q.shape[:-1] + (1,))], dim=-1)
    lo, hi = q[..., 0::2], q[..., 1::2]
    # 0..255 wraps to int8 as JAX's astype does
    return ((lo & 0xF) | ((hi & 0xF) << 4)).to(torch.int8)


def unpack_int4(packed: torch.Tensor, size: int) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: int8 bytes to sign-extended int8
    values with last axis ``size`` (the original, possibly odd,
    length)."""
    x = packed.to(torch.int32)
    lo = ((x & 0xF) ^ 8) - 8          # sign-extend the low nibble
    hi = x >> 4                       # arithmetic shift: the high nibble
    out = torch.stack([lo, hi], dim=-1).reshape(
        packed.shape[:-1] + (2 * packed.shape[-1],))
    return out[..., :size].to(torch.int8)


def quantize(x: torch.Tensor, num_bits: int = 8, num_groups: int = 1,
             symmetric: bool = True, pack: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """x to (int values ``[G, n / G]``, scale ``[G, 1]`` f32, zero point
    ``[G, 1]`` or None).

    Symmetric: q = round(x / scale), scale = max|x| * (1 / qmax).
    Asymmetric: q = round((x - min) / scale), range [0, 2^bits - 1].
    ``pack=True`` (symmetric int4 only) packs the values two nibbles per
    int8 along the group axis (:func:`pack_int4`)."""
    if pack and (num_bits != 4 or not symmetric):
        raise ValueError(
            f"pack=True is the symmetric int4 path, got num_bits="
            f"{num_bits} symmetric={symmetric}")
    flat = x.to(torch.float32).reshape(num_groups, -1)
    if symmetric:
        qmax = 2.0 ** (num_bits - 1) - 1
        scale = flat.abs().amax(dim=1, keepdim=True) * (1.0 / qmax)
        scale = torch.clamp_min(scale, 1e-12)
        q = torch.clamp(torch.round(flat / scale), -qmax - 1, qmax)
        q = _to_int(q, torch.int8 if num_bits <= 8 else torch.int32)
        return (pack_int4(q) if pack else q), scale, None
    qmax = 2.0 ** num_bits - 1
    lo = flat.amin(dim=1, keepdim=True)
    hi = flat.amax(dim=1, keepdim=True)
    scale = torch.clamp_min((hi - lo) * (1.0 / qmax), 1e-12)
    q = torch.clamp(torch.round((flat - lo) / scale), 0, qmax)
    return (_to_int(q, torch.uint8 if num_bits <= 8 else torch.int32),
            scale, lo)


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               zero_point: Optional[torch.Tensor], shape: tuple,
               dtype: torch.dtype = torch.float32,
               packed: bool = False) -> torch.Tensor:
    """Inverse of :func:`quantize`: ``q * scale (+ zero_point)`` in f32,
    reshaped to ``shape`` and cast to ``dtype``."""
    if packed:
        # the group axis's size comes from the target shape
        size = 1
        for s in shape:
            size *= s
        q = unpack_int4(q, size // q.shape[0])
    flat = q * scale               # an int times f32 is one f32 product
    if zero_point is not None:
        flat = flat + zero_point
    return flat.reshape(shape).to(dtype)


def kv_quantize(x: torch.Tensor, num_bits: int = 8
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row quantization in the paged-KV layout: one scale
    per leading index over the last (head_dim) axis, so a cache row is
    encoded once when written and never rescaled.

    ``x [..., D]`` to ``(values int8 [..., D] (8-bit) | [..., D / 2]
    (packed 4-bit), scale f32 [...])``.  The int4 layout is split by
    feature: byte ``j`` holds feature ``j`` in its low nibble and feature
    ``j + D / 2`` in its high nibble (not :func:`pack_int4`'s pairs)."""
    if num_bits not in (4, 8):
        raise ValueError(f"kv cache bits must be 4 or 8, got {num_bits}")
    d = x.shape[-1]
    if num_bits == 4 and d % 2:
        raise ValueError(f"packed int4 KV needs an even head_dim, got {d}")
    qmax = 2.0 ** (num_bits - 1) - 1
    xf = x.to(torch.float32)
    scale = torch.clamp_min(xf.abs().amax(dim=-1) * (1.0 / qmax), 1e-8)
    q = _to_int(torch.clamp(torch.round(xf / scale[..., None]),
                            -qmax - 1, qmax), torch.int32)
    if num_bits == 4:
        lo, hi = q[..., :d // 2], q[..., d // 2:]
        q = (lo & 0xF) | ((hi & 0xF) << 4)
    return q.to(torch.int8), scale


def kv_dequantize(q: torch.Tensor, scale: torch.Tensor, num_bits: int = 8,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`kv_quantize`, and the decode the paged attention
    kernels fuse into their loads: sign-extended ints times the row's
    scale, one f32 product."""
    x = q.to(torch.int32)
    if num_bits == 4:
        lo = ((x & 0xF) ^ 8) - 8
        hi = x >> 4
        x = torch.cat([lo, hi], dim=-1)
    elif num_bits != 8:
        raise ValueError(f"kv cache bits must be 4 or 8, got {num_bits}")
    return (x.to(torch.float32) * scale[..., None]).to(dtype)
