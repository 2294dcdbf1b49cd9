"""Paged attention for serving: kernels B6 (batched decode) and B7
(chunked prefill), each with its plain version.

Counterpart of ``deepspeed_tpu/ops/transformer/paged_decode_attention.py``
(`_decode_kernel` via `paged_decode_attention`, `_prefill_kernel` via
`paged_prefill_attention`) at ``kv_bits`` 0, 8 and 4.  Kernels:
``csrc/paged_decode_attention.cu`` and ``csrc/paged_prefill_attention.cu``
(kv_bits a template parameter of each; a quantized launch is counted
under ``<kernel>_int8`` or ``<kernel>_int4``, a float16 one with ``_f16``
appended).  At bf16 and f16 queries B6 splits
each slot's table into up to 8 ranks of one thread-block cluster
(``decode_attention.paged_split_plan``), and a kv group of more than 2048
output features into blocks of a few heads (``build.group_parts``); B7
runs on the tensor cores at the head dims that are multiples of 16 up to
128 (the others, multiples of 8 up to 256, and f32 on the CUDA-core
kernel: a route by shape), any group split across blocks where it
outgrows a tile.  The shapes each kernel takes are
``build.kernel_supports``'s.

Layout contract (the JAX package's): pools ``[num_blocks, block, Hkv,
De]``: the activation dtype at ``De = D``, or, with ``kv_bits`` 8 or 4,
int8 at ``De = D`` or packed int4 at ``De = D / 2`` (byte ``j`` holds
feature ``j`` low and ``j + D / 2`` high, ``ops/quantizer``'s
``kv_quantize``) beside ``k_scale``/``v_scale`` ``[num_blocks, block,
Hkv]`` f32; decode q ``[B, H, D]`` with ``lengths [B]`` int32 (valid rows
per slot including the just-written token, 0 = inactive slot) and
``block_tables [B, pages]`` int32; prefill q ``[C, H, D]`` at absolute
rows ``base .. base + C - 1`` with ``block_table [pages]``.  ``H`` must
be a multiple of ``Hkv`` (GQA is read at kv-head width).  Rows at or past
a slot's valid length are never read, nor are their scales (any content
there, NaN included, cannot reach the result), and a slot or chunk with
nothing to attend gives zero rows.  The plain versions dequantize the
gathered rows with ``kv_dequantize`` (the math the kernels fuse) before
f32 attention, as the JAX references do.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from .. import build
from ..quantizer.quantizer import kv_dequantize
from .decode_attention import paged_split_plan

#: output features (g * D) of one bf16 or f16 B6 block; a larger kv group is
#: split across blocks (``build.group_parts``)
_MAX_GROUP_DIM = 2048

_DEC, _DEC_SYM = "paged_decode_attention", "dstt_paged_decode_attention"
_PRE, _PRE_SYM = "paged_prefill_attention", "dstt_paged_prefill_attention"


def _check_quant_args(pool_k, pool_v, k_scale, v_scale, kv_bits: int,
                      d: int, what: str) -> int:
    """The JAX package's checks and messages; returns the pool's last
    dim (``De``)."""
    if kv_bits not in (0, 4, 8):
        raise ValueError(f"kv_bits must be 0, 4 or 8, got {kv_bits}")
    if kv_bits == 0:
        if k_scale is not None or v_scale is not None:
            raise ValueError(f"{what}: scales given but kv_bits=0")
        return pool_k.shape[3]
    if k_scale is None or v_scale is None:
        raise ValueError(f"{what}: kv_bits={kv_bits} needs k_scale and "
                         f"v_scale [num_blocks, block, Hkv] f32")
    if pool_k.dtype != torch.int8 or pool_v.dtype != torch.int8:
        raise ValueError(f"{what}: quantized pool must be int8, got "
                         f"{pool_k.dtype}")
    want = d if kv_bits == 8 else d // 2
    if kv_bits == 4 and d % 2:
        raise ValueError(f"{what}: packed int4 needs even head_dim {d}")
    if pool_k.shape[3] != want:
        raise ValueError(
            f"{what}: pool last dim {pool_k.shape[3]} != {want} for "
            f"kv_bits={kv_bits} at head_dim {d}")
    for name, scale, pool in (("k_scale", k_scale, pool_k),
                              ("v_scale", v_scale, pool_v)):
        if scale.shape != pool.shape[:3]:
            raise ValueError(
                f"{what}: {name} shape {tuple(scale.shape)} != pool "
                f"{tuple(pool.shape[:3])}")
        if scale.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32, got "
                            f"{scale.dtype}")
        if scale.device != pool.device:
            raise ValueError(f"{what}: {name} and pools on different "
                             f"devices")
    return want


def _check_pools(pool_k, pool_v, q, what, k_scale=None, v_scale=None,
                 kv_bits: int = 0) -> None:
    if pool_k.dim() != 4 or pool_k.shape != pool_v.shape:
        raise ValueError(f"pool_k {tuple(pool_k.shape)} != pool_v "
                         f"{tuple(pool_v.shape)} or not [num_blocks, "
                         f"block, Hkv, De]")
    h, d = q.shape[-2], q.shape[-1]
    hkv = pool_k.shape[2]
    if h % hkv:
        raise ValueError(f"query heads {h} not a multiple of kv heads {hkv}")
    de = _check_quant_args(pool_k, pool_v, k_scale, v_scale, kv_bits, d,
                           what)
    if kv_bits == 0:
        if de != d:
            raise ValueError(f"{what}: pool head_dim {de} != q head_dim "
                             f"{d}")
        if not (q.dtype == pool_k.dtype == pool_v.dtype):
            raise TypeError(f"{what}: q/pool dtypes differ ({q.dtype}, "
                            f"{pool_k.dtype}, {pool_v.dtype})")
    if not (q.device == pool_k.device == pool_v.device):
        raise ValueError(f"{what}: q and pools on different devices")


def _gather_rows(pool, scale, kv_bits, index):
    """Pool rows at ``index`` in f32, dequantized when ``kv_bits``."""
    if kv_bits:
        return kv_dequantize(pool[index], scale[index], kv_bits)
    return pool[index].float()


def _quant_layout(what: str, q, pool_k, pool_v, k_scale, v_scale) -> None:
    """What the quantized kernels need of their operands: contiguous
    tensors, 16-byte aligned q and pools, 4-byte aligned scales (the head
    dim is :func:`build.kernel_supports`'s)."""
    for name, t in (("q", q), ("pool_k", pool_k), ("pool_v", pool_v),
                    ("k_scale", k_scale), ("v_scale", v_scale)):
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.data_ptr() % (4 if name.endswith("scale") else 16):
            raise ValueError(f"{what}: {name} not aligned")


def _check_index(t: torch.Tensor, name: str, shape, device) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {list(shape)}, got "
                         f"{list(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, q on {device}")


def _masked_softmax(s, mask):
    """Unnormalised softmax weights of ``s`` over the last axis restricted
    to ``mask`` and their sum clamped at 1e-30: a row with no visible key
    then comes out as zeros, as in the kernels' 1 / max(l, 1e-30)."""
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    return p, l.clamp_min(1e-30)


# -- B6: batched paged decode ----------------------------------------------
def paged_decode_attention_plain(q, pool_k, pool_v, lengths, block_tables,
                                 sm_scale: Optional[float] = None,
                                 k_scale=None, v_scale=None,
                                 kv_bits: int = 0) -> torch.Tensor:
    """Plain version of B6: gather (and dequantize) each slot's pages into
    a contiguous cache and run masked attention in f32 (test-scale: it
    gathers every table entry)."""
    _check_pools(pool_k, pool_v, q, "paged_decode_attention", k_scale,
                 v_scale, kv_bits)
    b, h, d = q.shape
    _, blk, hkv, _ = pool_k.shape
    npages = block_tables.shape[1]
    _check_index(lengths, "lengths", (b,), q.device)
    _check_index(block_tables, "block_tables", (b, npages), q.device)
    g = h // hkv
    t = npages * blk
    tables = block_tables.long()
    k = _gather_rows(pool_k, k_scale, kv_bits, tables).reshape(b, t, hkv, d)
    v = _gather_rows(pool_v, v_scale, kv_bits, tables).reshape(b, t, hkv, d)
    valid = torch.arange(t, device=q.device)[None] < lengths[:, None].long()
    v = torch.where(valid[:, :, None, None], v, torch.zeros_like(v))
    scale = sm_scale or 1.0 / math.sqrt(d)
    qg = q.float().reshape(b, hkv, g, d)
    s = torch.einsum("bkgd,btkd->bkgt", qg, k) * scale
    p, l = _masked_softmax(s, valid[:, None, None, :])
    out = torch.einsum("bkgt,btkd->bkgd", p, v) / l
    return out.reshape(b, h, d).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _decode_kernel(quant: bool):
    lib = build.load_library(_DEC)
    fn = getattr(lib, _DEC_SYM + ("_quant" if quant else ""))
    P, I = ctypes.c_void_p, ctypes.c_int
    ptrs = [P] * (7 if quant else 5)
    tail = [I, I] if quant else [I]          # dtype (, kv_bits)
    fn.argtypes = (ptrs + [P, I, I, I, I, I, I, I, I, I, ctypes.c_float]
                   + tail + [P])
    fn.restype = I
    return lib, fn


def paged_decode_attention(q, pool_k, pool_v, lengths, block_tables,
                           sm_scale: Optional[float] = None,
                           k_scale=None, v_scale=None,
                           kv_bits: int = 0) -> torch.Tensor:
    """Kernel B6 on CUDA tensors; the plain version on CPU tensors.
    The caller guarantees ``lengths[i] <= pages * block`` and that every
    table entry below ``ceil(lengths[i] / block)`` is that slot's own
    block (the allocator pads with the null block 0)."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, pool_k, pool_v, lengths,
                                            block_tables, sm_scale, k_scale,
                                            v_scale, kv_bits)
    _check_pools(pool_k, pool_v, q, "paged_decode_attention", k_scale,
                 v_scale, kv_bits)
    b, h, d = q.shape
    _, blk, hkv, _ = pool_k.shape
    npages = block_tables.shape[1]
    _check_index(lengths, "lengths", (b,), q.device)
    _check_index(block_tables, "block_tables", (b, npages), q.device)
    build.check_supports(_DEC, d, h // hkv, q.dtype, kv_bits)
    code = build.dtype_code(q, _DEC)
    if kv_bits:
        _quant_layout(_DEC, q, pool_k, pool_v, k_scale, v_scale)
    else:
        build.check_layout(_DEC, (("q", q), ("pool_k", pool_k),
                                  ("pool_v", pool_v)))
    if not (lengths.is_contiguous() and block_tables.is_contiguous()):
        raise ValueError(f"{_DEC}: lengths/block_tables must be contiguous")
    parts = build.group_parts(h // hkv, d, _MAX_GROUP_DIM)
    out = torch.empty_like(q)
    lib, fn = _decode_kernel(bool(kv_bits))
    scales = (k_scale.data_ptr(), v_scale.data_ptr()) if kv_bits else ()
    rc = fn(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), *scales,
            lengths.data_ptr(), block_tables.data_ptr(), out.data_ptr(),
            b, h, hkv, d, parts, blk, npages, *paged_split_plan(npages, blk),
            sm_scale or 1.0 / math.sqrt(d), code,
            *((kv_bits,) if kv_bits else ()),
            build.current_stream(q.device))
    build.check_launch(lib, _DEC_SYM, rc)
    build.launch_counts[build.counter(_DEC, kv_bits, q.dtype)] += 1
    return out


# -- B7: causal chunked prefill --------------------------------------------
def paged_prefill_attention_plain(q, pool_k, pool_v, base: int,
                                  chunk_len: int, block_table,
                                  sm_scale: Optional[float] = None,
                                  k_scale=None, v_scale=None,
                                  kv_bits: int = 0) -> torch.Tensor:
    """Plain version of B7: gather (and dequantize) the slot's pages and
    run causally masked attention in f32.  Query rows past ``chunk_len``
    see every row below ``base + chunk_len`` (finite values callers
    ignore), as the kernel computes them."""
    _check_pools(pool_k, pool_v, q, "paged_prefill_attention", k_scale,
                 v_scale, kv_bits)
    c, h, d = q.shape
    _, blk, hkv, _ = pool_k.shape
    npages = block_table.shape[0]
    _check_index(block_table, "block_table", (npages,), q.device)
    g = h // hkv
    t = npages * blk
    total = int(base) + int(chunk_len)
    table = block_table.long()
    k = _gather_rows(pool_k, k_scale, kv_bits, table).reshape(t, hkv, d)
    v = _gather_rows(pool_v, v_scale, kv_bits, table).reshape(t, hkv, d)
    pos = torch.arange(t, device=q.device)
    kvalid = pos < total
    v = torch.where(kvalid[:, None, None], v, torch.zeros_like(v))
    qpos = int(base) + torch.arange(c, device=q.device)
    mask = (pos[None, :] <= qpos[:, None]) & kvalid[None, :]     # [C, T]
    scale = sm_scale or 1.0 / math.sqrt(d)
    qg = q.float().reshape(c, hkv, g, d)
    s = torch.einsum("ckgd,tkd->kgct", qg, k) * scale
    p, l = _masked_softmax(s, mask[None, None])
    out = torch.einsum("kgct,tkd->ckgd", p, v) / l.permute(2, 0, 1, 3)
    return out.reshape(c, h, d).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _prefill_kernel(quant: bool):
    lib = build.load_library(_PRE)
    fn = getattr(lib, _PRE_SYM + ("_quant" if quant else ""))
    P, I = ctypes.c_void_p, ctypes.c_int
    ptrs = [P] * (6 if quant else 4)
    tail = [I, I] if quant else [I]          # dtype (, kv_bits)
    fn.argtypes = (ptrs + [P, I, I, I, I, I, I, I, I, ctypes.c_float]
                   + tail + [P])
    fn.restype = I
    return lib, fn


def paged_prefill_attention(q, pool_k, pool_v, base: int, chunk_len: int,
                            block_table, sm_scale: Optional[float] = None,
                            k_scale=None, v_scale=None,
                            kv_bits: int = 0) -> torch.Tensor:
    """Kernel B7 on CUDA tensors; the plain version on CPU tensors.  The
    chunk's own k/v must already sit in the pool at rows ``base ..``
    (the model scatters them just before the call)."""
    if q.device.type == "cpu":
        return paged_prefill_attention_plain(q, pool_k, pool_v, base,
                                             chunk_len, block_table,
                                             sm_scale, k_scale, v_scale,
                                             kv_bits)
    _check_pools(pool_k, pool_v, q, "paged_prefill_attention", k_scale,
                 v_scale, kv_bits)
    c, h, d = q.shape
    _, blk, hkv, _ = pool_k.shape
    npages = block_table.shape[0]
    _check_index(block_table, "block_table", (npages,), q.device)
    if not (0 <= int(base) and 0 <= int(chunk_len)
            and int(base) + int(chunk_len) <= npages * blk):
        raise ValueError(f"paged_prefill_attention: base {base} + "
                         f"chunk_len {chunk_len} outside the table's "
                         f"{npages * blk} rows")
    build.check_supports(_PRE, d, h // hkv, q.dtype, kv_bits)
    code = build.dtype_code(q, _PRE)
    if kv_bits:
        _quant_layout(_PRE, q, pool_k, pool_v, k_scale, v_scale)
    else:
        build.check_layout(_PRE, (("q", q), ("pool_k", pool_k),
                                  ("pool_v", pool_v)))
    if not block_table.is_contiguous():
        raise ValueError(f"{_PRE}: block_table must be contiguous")
    if c < 1:
        raise ValueError(f"paged_prefill_attention kernel: C {c} < 1")
    out = torch.empty_like(q)
    lib, fn = _prefill_kernel(bool(kv_bits))
    scales = (k_scale.data_ptr(), v_scale.data_ptr()) if kv_bits else ()
    rc = fn(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), *scales,
            block_table.data_ptr(), out.data_ptr(), c, h, hkv, d, blk,
            npages, int(base), int(chunk_len),
            sm_scale or 1.0 / math.sqrt(d), code,
            *((kv_bits,) if kv_bits else ()),
            build.current_stream(q.device))
    build.check_launch(lib, _PRE_SYM, rc)
    build.launch_counts[build.counter(_PRE, kv_bits, q.dtype)] += 1
    return out
