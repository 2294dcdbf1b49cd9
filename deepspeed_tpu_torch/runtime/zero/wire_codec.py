"""The offload wire codec: stochastic-rounding gradient compression on
the device-to-host wire, round-to-nearest parameters on the host-to-device
wire.

Counterpart of ``deepspeed_tpu/runtime/zero/wire_codec.py``, with the same
formats and the same bytes.  The gradient wire quantizes per chunk of
``CHUNK`` elements with a max-abs scale and unbiased stochastic rounding
(E[decode(encode(g))] = g, no persistent error state); a chunk holding
NaN or Inf gets a NaN scale on purpose, so the decode poisons the masters
as the uncompressed path would.

Wire formats (per vector of n elements, one f32 scale per chunk):
  8-bit: int8 values              -> n bytes
  4-bit: two values per byte      -> n/2 bytes (offset-7 nibbles)
  1-bit: sign bits packed 8/byte  -> n/8 bytes

``encode`` and ``decode_params`` run on the tensors' device as plain torch
ops (the JAX package jits them; they are no Pallas kernel).  The uniform
draws of ``encode`` come from an explicit ``torch.Generator``, or are
passed in whole (``uniform``), so that the same draws give the same
payload as the JAX encoder's.  ``encode_params_host`` and ``decode_into``
are host numpy, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

#: quantization group size: one f32 scale per CHUNK elements
CHUNK = 2048

_LEVELS = {8: 127.0, 4: 7.0}


def wire_bytes(n: int, bits: int) -> int:
    """Wire volume of one encoded vector (payload + scales)."""
    n_chunks = (n + CHUNK - 1) // CHUNK
    payload = {8: n, 4: n // 2, 1: n // 8}[bits]
    return payload + 4 * n_chunks


def payload_bytes_per_chunk(bits: int) -> int:
    return {8: CHUNK, 4: CHUNK // 2, 1: CHUNK // 8}[bits]


def _uniform(shape, device, generator: Optional[torch.Generator],
             uniform: Optional[torch.Tensor]) -> torch.Tensor:
    if uniform is None:
        return torch.rand(shape, generator=generator, device=device,
                          dtype=torch.float32)
    if tuple(uniform.shape) != tuple(shape):
        raise ValueError(f"uniform draws {tuple(uniform.shape)} for a "
                         f"vector of chunks {tuple(shape)}")
    return uniform.to(device, torch.float32)


def encode(flat: torch.Tensor, bits: int,
           generator: Optional[torch.Generator] = None,
           uniform: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """bf16/f32 ``[n]`` (n % CHUNK == 0) → (payload uint8, scales f32),
    on ``flat``'s device.  Stochastic rounding: q = floor(g/s + u),
    u ~ U[0, 1) from ``generator`` (or the given ``uniform``, shaped
    ``[n / CHUNK, CHUNK]``), so E[q·s] = g."""
    n = flat.shape[0]
    if n % CHUNK:
        raise ValueError(f"wire codec needs n % {CHUNK} == 0, got {n}")
    chunks = flat.to(torch.float32).reshape(-1, CHUNK)
    amax = chunks.abs().amax(dim=1)
    u = _uniform(chunks.shape, flat.device, generator, uniform)
    if bits == 1:
        # unbiased sign: q in {-s, +s} with P(+s) = (g + s) / (2s), s the
        # chunk's max|g|; an all-zero chunk keeps s = 0 (the sign payload
        # is never zero, so the scale carries the zero)
        one = torch.ones((), dtype=torch.float32, device=flat.device)
        xs = chunks / torch.where(amax > 0, amax, one)[:, None]
        bit = (u < (xs + 1.0) * 0.5).to(torch.uint8)
        weights = (2 ** torch.arange(8, device=flat.device)).to(torch.uint8)
        packed = (bit.reshape(-1, 8) * weights).sum(dim=1).to(torch.uint8)
        return packed, amax
    levels = _LEVELS[bits]
    one = torch.ones((), dtype=torch.float32, device=flat.device)
    # max * (1 / levels): the bits of the JAX package's jitted encode
    # (XLA turns the division by a constant into that product)
    s = torch.where(amax > 0, amax * (1.0 / levels), one)
    s = torch.where(torch.isfinite(amax), s, torch.full_like(s, np.nan))
    xs = chunks / s[:, None]                 # in [-levels, levels]
    q = torch.clamp(torch.floor(xs + u), -levels, levels)
    q = torch.nan_to_num(q).to(torch.int8)   # NaN chunks: the scale poisons
    if bits == 8:
        return q.reshape(-1).view(torch.uint8), s
    q4 = (q + 7).to(torch.uint8).reshape(-1, 2)
    return q4[:, 0] | (q4[:, 1] << 4), s


def _host_f32(flat: np.ndarray) -> np.ndarray:
    """float32 values of a host vector of f32 values or bf16 bits."""
    if flat.dtype == np.uint16:
        return (flat.astype(np.uint32) << 16).view(np.float32)
    return flat.astype(np.float32, copy=False)


def encode_params_host(flat: np.ndarray, bits: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """The host-to-device parameter wire's encode: a host vector ``[n]``
    of f32 values or bf16 bits (uint16), n % CHUNK == 0 → (payload uint8,
    scales f32), deterministic round-to-nearest (parameters are values,
    not averaged quantities).  8-bit: n bytes; 4-bit: n/2 bytes (offset-7
    nibbles, the gradient wire's layout)."""
    n = flat.shape[0]
    if n % CHUNK:
        raise ValueError(f"param wire needs n % {CHUNK} == 0, got {n}")
    levels = _LEVELS[bits]
    x = _host_f32(flat).reshape(-1, CHUNK)
    amax = np.max(np.abs(x), axis=1)
    s = np.where(amax > 0, amax / levels, 1.0).astype(np.float32)
    # NaN/Inf chunks keep a NaN scale: a poisoned master poisons the
    # device copy instead of quantizing divergence into finite noise
    s = np.where(np.isfinite(amax), s, np.nan).astype(np.float32)
    with np.errstate(invalid="ignore"):
        q = np.clip(np.rint(x / s[:, None]), -levels, levels).astype(np.int8)
    if bits == 8:
        return q.reshape(-1).view(np.uint8), s
    q4 = (q.reshape(-1, 2) + 7).astype(np.uint8)
    return (q4[:, 0] | (q4[:, 1] << 4)), s


def decode_params(payload: torch.Tensor, scales: torch.Tensor, bits: int,
                  out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The device side of the parameter wire: (payload uint8, scales f32)
    → flat ``[n]`` in ``out_dtype``."""
    if bits == 8:
        vals = payload.view(torch.int8).to(torch.float32)
    elif bits == 4:
        lo = (payload & 0x0F).to(torch.int32) - 7
        hi = (payload >> 4).to(torch.int32) - 7
        vals = torch.stack([lo, hi], dim=-1).reshape(-1).to(torch.float32)
    else:
        raise ValueError(f"param wire bits={bits}")
    vals = vals.reshape(-1, CHUNK) * scales[:, None]
    return vals.reshape(-1).to(out_dtype)


#: host decode of a long vector runs in this many chunk ranges at once
#: (numpy releases the GIL over each range's passes)
DECODE_THREADS = 4
_decode_pool = None


def _decode_chunks(out: np.ndarray, payload: np.ndarray, scales: np.ndarray,
                   bits: int, accumulate: bool) -> None:
    """Decode whole chunks: ``out`` ``[k, CHUNK]`` float32, ``payload``
    and ``scales`` the same k chunks' (8 or 4 bits).  The float32
    products ``value * scale`` of the JAX package's decode, in two passes
    (widen, multiply into place) instead of its three."""
    s = scales.astype(np.float32, copy=False)
    if bits == 8:
        vals = payload.view(np.int8).reshape(out.shape).astype(np.float32)
        if accumulate:
            vals *= s[:, None]
            out += vals
        else:
            np.multiply(vals, s[:, None], out=out)
        return
    pairs = payload.reshape(out.shape[0], CHUNK // 2)
    o3 = out.reshape(out.shape[0], CHUNK // 2, 2)
    for half, nib in ((0, pairs & 0x0F), (1, pairs >> 4)):
        vals = nib.astype(np.float32) - 7.0
        if accumulate:
            vals *= s[:, None]
            o3[..., half] += vals
        else:
            np.multiply(vals, s[:, None], out=o3[..., half])


def decode_into(out: np.ndarray, payload: np.ndarray, scales: np.ndarray,
                bits: int, accumulate: bool = False) -> None:
    """The host side of the gradient wire: payload/scales (host numpy) →
    f32 ``out [n]``; ``accumulate`` adds into ``out`` instead.  A long
    vector decodes in ``DECODE_THREADS`` chunk ranges at once."""
    n = out.shape[0]
    if bits == 1:
        bit = np.unpackbits(payload, bitorder="little")[:n]
        vals = (bit.astype(np.float32) * 2.0 - 1.0)
        vals = vals.reshape(-1, CHUNK) * scales[:, None].astype(np.float32)
        if accumulate:
            out += vals.reshape(-1)
        else:
            out[:] = vals.reshape(-1)
        return
    if bits not in (8, 4):
        raise ValueError(f"bits={bits}")
    per = payload_bytes_per_chunk(bits)
    nc = n // CHUNK
    o2 = out.reshape(nc, CHUNK)
    step = max(-(-nc // DECODE_THREADS), 256)

    def part(lo: int) -> None:
        hi = min(lo + step, nc)
        _decode_chunks(o2[lo:hi], payload[lo * per:hi * per],
                       scales[lo:hi], bits, accumulate)
    if nc <= step:
        part(0)
        return
    global _decode_pool
    if _decode_pool is None:
        from concurrent.futures import ThreadPoolExecutor
        _decode_pool = ThreadPoolExecutor(DECODE_THREADS,
                                          thread_name_prefix="wire-decode")
    list(_decode_pool.map(part, range(0, nc, step)))
