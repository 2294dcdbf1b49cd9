"""Paged attention for serving: kernels B6 (batched decode) and B7
(chunked prefill), each with its plain version.

Counterpart of ``deepspeed_tpu/ops/transformer/paged_decode_attention.py``
(`_decode_kernel` via `paged_decode_attention`, `_prefill_kernel` via
`paged_prefill_attention`) for unquantized pools (``kv_bits`` 0); the
int8/int4 dequant branches are a later slice and raise here.  Kernels:
``csrc/paged_decode_attention.cu`` and ``csrc/paged_prefill_attention.cu``.

Layout contract (the JAX package's): pools ``[num_blocks, block, Hkv,
D]``; decode q ``[B, H, D]`` with ``lengths [B]`` int32 (valid rows per
slot including the just-written token, 0 = inactive slot) and
``block_tables [B, pages]`` int32; prefill q ``[C, H, D]`` at absolute
rows ``base .. base + C - 1`` with ``block_table [pages]``.  ``H`` must
be a multiple of ``Hkv`` (GQA is read at kv-head width).  Rows at or past
a slot's valid length are never read (any content there, NaN included,
cannot reach the result) and a slot or chunk with nothing to attend
gives zero rows.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from .. import build

_DEC, _DEC_SYM = "paged_decode_attention", "dstt_paged_decode_attention"
_PRE, _PRE_SYM = "paged_prefill_attention", "dstt_paged_prefill_attention"


def _check_pools(pool_k, pool_v, q, kv_bits, what):
    if kv_bits != 0:
        if kv_bits not in (4, 8):
            raise ValueError(f"kv_bits must be 0, 4 or 8, got {kv_bits}")
        raise NotImplementedError(
            f"{what}: int{kv_bits} KV pools (fused dequant) are not in the "
            f"first slice of the port")
    if pool_k.dim() != 4 or pool_k.shape != pool_v.shape:
        raise ValueError(f"pool_k {tuple(pool_k.shape)} != pool_v "
                         f"{tuple(pool_v.shape)} or not [num_blocks, "
                         f"block, Hkv, D]")
    h, d = q.shape[-2], q.shape[-1]
    hkv = pool_k.shape[2]
    if pool_k.shape[3] != d:
        raise ValueError(f"{what}: pool head_dim {pool_k.shape[3]} != q "
                         f"head_dim {d}")
    if h % hkv:
        raise ValueError(f"query heads {h} not a multiple of kv heads {hkv}")
    if not (q.dtype == pool_k.dtype == pool_v.dtype):
        raise TypeError(f"{what}: q/pool dtypes differ ({q.dtype}, "
                        f"{pool_k.dtype}, {pool_v.dtype})")
    if not (q.device == pool_k.device == pool_v.device):
        raise ValueError(f"{what}: q and pools on different devices")


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
                                 kv_bits: int = 0) -> torch.Tensor:
    """Plain version of B6: gather each slot's pages into a contiguous
    cache and run masked attention in f32 (test-scale: it gathers every
    table entry)."""
    _check_pools(pool_k, pool_v, q, kv_bits, "paged_decode_attention")
    b, h, d = q.shape
    _, blk, hkv, _ = pool_k.shape
    npages = block_tables.shape[1]
    _check_index(lengths, "lengths", (b,), q.device)
    _check_index(block_tables, "block_tables", (b, npages), q.device)
    g = h // hkv
    t = npages * blk
    tables = block_tables.long()
    k = pool_k[tables].reshape(b, t, hkv, d).float()
    v = pool_v[tables].reshape(b, t, hkv, d).float()
    valid = torch.arange(t, device=q.device)[None] < lengths[:, None].long()
    v = torch.where(valid[:, :, None, None], v, torch.zeros_like(v))
    scale = sm_scale or 1.0 / math.sqrt(d)
    qg = q.float().reshape(b, hkv, g, d)
    s = torch.einsum("bkgd,btkd->bkgt", qg, k) * scale
    p, l = _masked_softmax(s, valid[:, None, None, :])
    out = torch.einsum("bkgt,btkd->bkgd", p, v) / l
    return out.reshape(b, h, d).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _decode_kernel():
    lib = build.load_library(_DEC)
    fn = getattr(lib, _DEC_SYM)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, ctypes.c_float, I, P]
    fn.restype = I
    return lib, fn


def paged_decode_attention(q, pool_k, pool_v, lengths, block_tables,
                           sm_scale: Optional[float] = None,
                           kv_bits: int = 0) -> torch.Tensor:
    """Kernel B6 on CUDA tensors; the plain version on CPU tensors.
    The caller guarantees ``lengths[i] <= pages * block`` and that every
    table entry below ``ceil(lengths[i] / block)`` is that slot's own
    block (the allocator pads with the null block 0)."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, pool_k, pool_v, lengths,
                                            block_tables, sm_scale, kv_bits)
    _check_pools(pool_k, pool_v, q, kv_bits, "paged_decode_attention")
    b, h, d = q.shape
    _, blk, hkv, _ = pool_k.shape
    npages = block_tables.shape[1]
    _check_index(lengths, "lengths", (b,), q.device)
    _check_index(block_tables, "block_tables", (b, npages), q.device)
    code = build.dtype_code(q, "paged_decode_attention")
    build.check_layout(_DEC, (("q", q), ("pool_k", pool_k),
                              ("pool_v", pool_v)), d, q.element_size())
    if not (lengths.is_contiguous() and block_tables.is_contiguous()):
        raise ValueError(f"{_DEC}: lengths/block_tables must be contiguous")
    if h // hkv not in (1, 2, 4, 8):
        raise ValueError(f"paged_decode_attention kernel: query group "
                         f"{h // hkv} not in (1, 2, 4, 8)")
    if d > 256:
        raise ValueError(f"paged_decode_attention kernel: head_dim {d} "
                         f"> 256")
    out = torch.empty_like(q)
    lib, fn = _decode_kernel()
    rc = fn(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
            lengths.data_ptr(), block_tables.data_ptr(), out.data_ptr(),
            b, h, hkv, d, blk, npages, sm_scale or 1.0 / math.sqrt(d), code,
            build.current_stream(q.device))
    build.check_launch(lib, _DEC_SYM, rc)
    build.launch_counts[_DEC] += 1
    return out


# -- B7: causal chunked prefill --------------------------------------------
def paged_prefill_attention_plain(q, pool_k, pool_v, base: int,
                                  chunk_len: int, block_table,
                                  sm_scale: Optional[float] = None,
                                  kv_bits: int = 0) -> torch.Tensor:
    """Plain version of B7: gather the slot's pages and run causally
    masked attention in f32.  Query rows past ``chunk_len`` see every
    row below ``base + chunk_len`` (finite values callers ignore), as the
    kernel computes them."""
    _check_pools(pool_k, pool_v, q, kv_bits, "paged_prefill_attention")
    c, h, d = q.shape
    _, blk, hkv, _ = pool_k.shape
    npages = block_table.shape[0]
    _check_index(block_table, "block_table", (npages,), q.device)
    g = h // hkv
    t = npages * blk
    total = int(base) + int(chunk_len)
    k = pool_k[block_table.long()].reshape(t, hkv, d).float()
    v = pool_v[block_table.long()].reshape(t, hkv, d).float()
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
def _prefill_kernel():
    lib = build.load_library(_PRE)
    fn = getattr(lib, _PRE_SYM)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, P, I, I, I, I, I, I, I, I, ctypes.c_float,
                   I, P]
    fn.restype = I
    return lib, fn


def paged_prefill_attention(q, pool_k, pool_v, base: int, chunk_len: int,
                            block_table, sm_scale: Optional[float] = None,
                            kv_bits: int = 0) -> torch.Tensor:
    """Kernel B7 on CUDA tensors; the plain version on CPU tensors.  The
    chunk's own k/v must already sit in the pool at rows ``base ..``
    (the model scatters them just before the call)."""
    if q.device.type == "cpu":
        return paged_prefill_attention_plain(q, pool_k, pool_v, base,
                                             chunk_len, block_table,
                                             sm_scale, kv_bits)
    _check_pools(pool_k, pool_v, q, kv_bits, "paged_prefill_attention")
    c, h, d = q.shape
    _, blk, hkv, _ = pool_k.shape
    npages = block_table.shape[0]
    _check_index(block_table, "block_table", (npages,), q.device)
    if not (0 <= int(base) and 0 <= int(chunk_len)
            and int(base) + int(chunk_len) <= npages * blk):
        raise ValueError(f"paged_prefill_attention: base {base} + "
                         f"chunk_len {chunk_len} outside the table's "
                         f"{npages * blk} rows")
    code = build.dtype_code(q, "paged_prefill_attention")
    build.check_layout(_PRE, (("q", q), ("pool_k", pool_k),
                              ("pool_v", pool_v)), d, q.element_size())
    if not block_table.is_contiguous():
        raise ValueError(f"{_PRE}: block_table must be contiguous")
    if d % 32 or d > 256 or 16 % (h // hkv) or c < 1:
        raise ValueError(f"paged_prefill_attention kernel: needs head_dim "
                         f"% 32 == 0 and <= 256 (got {d}), query group "
                         f"dividing 16 (got {h // hkv}) and C >= 1")
    out = torch.empty_like(q)
    lib, fn = _prefill_kernel()
    rc = fn(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
            block_table.data_ptr(), out.data_ptr(), c, h, hkv, d, blk,
            npages, int(base), int(chunk_len),
            sm_scale or 1.0 / math.sqrt(d), code,
            build.current_stream(q.device))
    build.check_launch(lib, _PRE_SYM, rc)
    build.launch_counts[_PRE] += 1
    return out
