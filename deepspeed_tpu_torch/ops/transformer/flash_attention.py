"""Flash attention for training: kernels B1 (forward), B2 (fused
backward), B3 (dq pass) and B4 (dk/dv pass) behind one
``torch.autograd.Function``, with their plain versions.

Counterpart of ``deepspeed_tpu/ops/transformer/flash_attention.py``:
``_fwd_kernel`` (via ``_fwd``) is ``csrc/flash_attention_fwd.cu``,
``_bwd_fused_kernel`` (via ``_bwd_fused``) ``csrc/flash_attention_bwd.cu``,
``_bwd_dq_kernel`` ``csrc/flash_attention_bwd_dq.cu`` and
``_bwd_dkv_kernel`` ``csrc/flash_attention_bwd_dkv.cu``.  The JAX
package's dispatch rule (``_bwd`` ``:373``) is kept: with ``block_q =
min(block_q, T)`` and ``block_k = min(block_k, T)``, a sequence that fits
one block with as many kv heads as query heads takes the fused backward
B2; every other case (T past one block, grouped-query attention) runs
B3 then B4.  Only a query length other than the key length raises.

Layout contract (the JAX package's): q ``[B*H, T, D]``, k and v
``[B*KVH, T, D]`` with ``H % KVH == 0`` (query head row b reads kv head
row ``b // g``, ``g = H / KVH``; k/v are never repeated through memory);
the forward also returns the per-row logsumexp ``lse [B*H, T]`` in
float32 (the TPU kernel replicates it over 8 sublanes, a tiling artefact
the port drops).  Probabilities are rounded to v's dtype before the P.V
product; in the backward p is rounded to dO's dtype before dV and ds to
q's dtype before dQ and dK; every sum is float32; dk and dv are summed
over the g query heads of a group.  ``delta = rowsum(dO * O)`` is a
PyTorch reduction outside the kernels, as in the JAX package.  Rows past
T are never read.  On CUDA tensors the wrappers launch the kernels (in
float32, bfloat16 or float16, at every head dim of ``KERNEL_HEAD_DIMS``
that ``build.kernel_supports`` admits; float16 launches count under
``<kernel>_f16``); on CPU tensors they run the plain versions, which
compute the same function in float32 at the same rounding points.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from .. import build

_FWD, _FWD_SYM = "flash_attention_fwd", "dstt_flash_attention_fwd"
_BWD, _BWD_SYM = "flash_attention_bwd", "dstt_flash_attention_bwd"
_DQ, _DQ_SYM = "flash_attention_bwd_dq", "dstt_flash_attention_bwd_dq"
_DKV, _DKV_SYM = "flash_attention_bwd_dkv", "dstt_flash_attention_bwd_dkv"

#: head dims the kernels are built for: the multiples of 16 up to 256
KERNEL_HEAD_DIMS = build.FLASH_HEAD_DIMS


def _scale(d: int, sm_scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(d) if sm_scale is None else float(sm_scale)


def _check(what: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           *others: torch.Tensor) -> None:
    """q ``[B*H, T, D]``, k and v ``[B*KVH, T, D]`` with B*KVH dividing
    B*H; ``others`` (o, dO) take q's shape."""
    if (q.dim() != 3 or k.dim() != 3 or v.shape != k.shape
            or k.shape[1:] != q.shape[1:] or k.shape[0] < 1
            or q.shape[0] % k.shape[0]
            or any(t.shape != q.shape for t in others)):
        raise ValueError(f"{what}: q (and o, dO) must be [B*H, T, D] and k, "
                         f"v [B*KVH, T, D] with B*KVH dividing B*H, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}"
                         + "".join(f", {tuple(t.shape)}" for t in others))
    for t in (k, v) + others:
        if t.dtype != q.dtype:
            raise TypeError(f"{what}: dtypes differ ({q.dtype}, {t.dtype})")
        if t.device != q.device:
            raise ValueError(f"{what}: operands on different devices")


def _visible(tq: int, tk: int, causal: bool, device) -> Optional[torch.Tensor]:
    if not causal:
        return None
    return torch.ones((tq, tk), dtype=torch.bool, device=device).tril()


def _grouped(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q ``[B*KVH*g, T, D]`` viewed as ``[B*KVH, g, T, D]``."""
    return q.reshape(k.shape[0], q.shape[0] // k.shape[0], *q.shape[1:])


def _scores(q4, k, scale, causal, keep):
    """f32 scores ``[B*KVH, g, Tq, Tk]`` of grouped q against k, masked
    to -inf where not visible."""
    s = torch.matmul(q4.float(), k.float().transpose(1, 2)[:, None]) * scale
    if keep is None:
        keep = _visible(q4.shape[2], k.shape[1], causal, q4.device)
    if keep is not None:
        s = s.masked_fill(~keep, float("-inf"))
    return s


def _delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``rowsum(dO * O)`` in float32, ``[B*H, T]``."""
    return (do.float() * o.float()).sum(dim=-1)


# -- plain versions -----------------------------------------------------------
def flash_attention_fwd_plain(q, k, v, causal: bool = True,
                              sm_scale: Optional[float] = None,
                              keep: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of B1: ``(o, lse)`` in float32 at the kernel's
    rounding points.  ``keep`` ([Tq, Tk] bool, True = visible) replaces
    the causal mask when given."""
    _check("flash_attention_fwd_plain", q, k, v)
    s = _scores(_grouped(q, k), k, _scale(q.shape[-1], sm_scale), causal,
                keep)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float()[:, None]) / l
    return o.reshape(q.shape).to(q.dtype), (m + torch.log(l)).reshape(
        q.shape[:2])


def _bwd_terms(q, k, v, o, lse, do, causal, sm_scale, keep):
    """The backward's grouped f32 terms: p and ds ``[B*KVH, g, Tq, Tk]``
    (ds rounded to q's dtype) and dO grouped as ``[B*KVH, g, T, D]``."""
    scale = _scale(q.shape[-1], sm_scale)
    do4 = _grouped(do, k).float()
    delta = _grouped(_delta(o, do), k)
    p = torch.exp(_scores(_grouped(q, k), k, scale, causal, keep)
                  - _grouped(lse, k)[..., None])
    dp = torch.matmul(do4, v.float().transpose(1, 2)[:, None])
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype).float()
    return p, ds, do4


def _group_sum_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum_g a[:, g]^T b[:, g]`` for a ``[B*KVH, g, Tq, Tk]`` and b
    ``[B*KVH, g, Tq, D]``: one product over the (g, Tq) rows, in the
    order B4 walks them."""
    n, g, tq, tk = a.shape
    return torch.matmul(a.transpose(2, 3).transpose(1, 2).reshape(
        n, tk, g * tq), b.reshape(n, g * tq, b.shape[-1]))


def flash_attention_bwd_dq_plain(q, k, v, o, lse, do, causal: bool = True,
                                 sm_scale: Optional[float] = None,
                                 keep: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """Plain version of B3: ``dq`` in float32 at the kernel's rounding
    points (ds rounded to q's dtype before the product)."""
    _check("flash_attention_bwd_dq_plain", q, k, v, o, do)
    _, ds, _ = _bwd_terms(q, k, v, o, lse, do, causal, sm_scale, keep)
    return torch.matmul(ds, k.float()[:, None]).reshape(q.shape).to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, o, lse, do, causal: bool = True,
                                  sm_scale: Optional[float] = None,
                                  keep: Optional[torch.Tensor] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of B4: ``(dk, dv)`` at kv-head width, summed over
    each group's query heads, in float32 at the kernel's rounding points
    (p rounded to dO's dtype before dV, ds to q's dtype before dK)."""
    _check("flash_attention_bwd_dkv_plain", q, k, v, o, do)
    p, ds, do4 = _bwd_terms(q, k, v, o, lse, do, causal, sm_scale, keep)
    dv = _group_sum_product(p.to(do.dtype).float(), do4)
    dk = _group_sum_product(ds, _grouped(q, k).float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal: bool = True,
                              sm_scale: Optional[float] = None,
                              keep: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Plain version of B2: ``(dq, dk, dv)`` from the forward's ``o`` and
    ``lse`` and the output gradient ``do``, in float32 at the kernel's
    rounding points (MHA)."""
    _check("flash_attention_bwd_plain", q, k, v, o, do)
    _check_mha("flash_attention_bwd_plain", q, k)
    p, ds, do4 = _bwd_terms(q, k, v, o, lse, do, causal, sm_scale, keep)
    dv = torch.matmul(p.to(do.dtype).float().transpose(2, 3), do4)
    dq = torch.matmul(ds, k.float()[:, None])
    dk = torch.matmul(ds.transpose(2, 3), _grouped(q, k).float())
    return (dq.reshape(q.shape).to(q.dtype), dk.reshape(k.shape).to(k.dtype),
            dv.reshape(v.shape).to(v.dtype))


# -- kernels -------------------------------------------------------------------
def _check_mha(what: str, q: torch.Tensor, k: torch.Tensor) -> None:
    if q.shape[0] != k.shape[0]:
        raise ValueError(
            f"{what}: the fused backward B2 takes one kv head per query "
            f"head ({q.shape[0]} vs {k.shape[0]} head rows); grouped-query "
            f"attention runs B3 (dq) and B4 (dk/dv)")


def _check_kernel(what: str, tensors) -> None:
    """Layout, the shared gate (:func:`build.kernel_supports`: head dim,
    dtype, f32 shared memory) and the grid limits of kernel ``what``;
    ``tensors`` start with q, k."""
    build.check_layout(what, tensors)
    (_, q), (_, k) = tensors[:2]
    bh, t_len, d = q.shape
    build.check_supports(what, d, bh // k.shape[0], q.dtype)
    if not 1 <= bh <= 65535 or t_len < 1:
        raise ValueError(f"{what} kernel: B*H {bh} outside [1, 65535] or "
                         f"T {t_len} < 1")


def _check_rows(what: str, name: str, t: torch.Tensor, q: torch.Tensor
                ) -> None:
    """A float32 ``[B*H, T]`` row statistic (lse, delta) beside q."""
    bh, t_len = q.shape[:2]
    if (t.dtype != torch.float32 or tuple(t.shape) != (bh, t_len)
            or not t.is_contiguous() or t.device != q.device):
        raise ValueError(f"{what}: {name} must be a contiguous float32 "
                         f"[{bh}, {t_len}] on {q.device}")


@functools.lru_cache(maxsize=None)
def _library(name: str, sym: str, n_ptrs: int, n_ints: int):
    """(library, function) of a kernel taking ``n_ptrs`` pointers, then
    ``n_ints`` ints, sm_scale, causal, dtype and the stream."""
    lib = build.load_library(name)
    fn = getattr(lib, sym)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * n_ptrs + [I] * n_ints + [ctypes.c_float, I, I, P]
    fn.restype = I
    return lib, fn


def _launch(name: str, sym: str, q: torch.Tensor, ptrs, ints, sm_scale,
            causal) -> None:
    lib, fn = _library(name, sym, len(ptrs), len(ints))
    rc = fn(*(t.data_ptr() for t in ptrs), *ints,
            _scale(q.shape[-1], sm_scale), int(causal),
            build.dtype_code(q, name), build.current_stream(q.device))
    build.check_launch(lib, sym, rc)
    build.launch_counts[build.counter(name, dtype=q.dtype)] += 1


def flash_attention_fwd(q, k, v, causal: bool = True,
                        sm_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B1 on CUDA tensors, the plain version on CPU tensors:
    ``(o [B*H, T, D], lse [B*H, T] float32)``."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, sm_scale)
    _check("flash_attention_fwd", q, k, v)
    _check_kernel(_FWD, (("q", q), ("k", k), ("v", v)))
    bh, t_len, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, t_len), dtype=torch.float32, device=q.device)
    _launch(_FWD, _FWD_SYM, q, (q, k, v, o, lse),
            (bh, bh // k.shape[0], t_len, d), sm_scale, causal)
    return o, lse


def _bwd_inputs(what, q, k, v, o, lse, do, delta):
    """Check a backward kernel's operands; ``delta`` computed when None."""
    _check(what, q, k, v, o, do)
    _check_kernel(what, (("q", q), ("k", k), ("v", v), ("o", o),
                         ("do", do)))
    _check_rows(what, "lse", lse, q)
    if delta is None:
        delta = _delta(o, do)
    _check_rows(what, "delta", delta, q)
    return delta


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True,
                        sm_scale: Optional[float] = None,
                        delta: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel B2 on CUDA tensors, the plain version on CPU tensors:
    ``(dq, dk, dv)`` for one kv head per query head.  ``delta =
    rowsum(dO * O)`` is computed here when not given."""
    _check_mha("flash_attention_bwd", q, k)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal,
                                         sm_scale)
    delta = _bwd_inputs(_BWD, q, k, v, o, lse, do, delta)
    bh, t_len, d = q.shape
    dq, dk, dv = (torch.empty_like(q), torch.empty_like(k),
                  torch.empty_like(v))
    _launch(_BWD, _BWD_SYM, q, (q, k, v, do, lse, delta, dq, dk, dv),
            (bh, t_len, d), sm_scale, causal)
    return dq, dk, dv


def flash_attention_bwd_dq(q, k, v, o, lse, do, causal: bool = True,
                           sm_scale: Optional[float] = None,
                           delta: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Kernel B3 on CUDA tensors, the plain version on CPU tensors:
    ``dq [B*H, T, D]``, k/v read at kv-head width."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, o, lse, do, causal,
                                            sm_scale)
    delta = _bwd_inputs(_DQ, q, k, v, o, lse, do, delta)
    bh, t_len, d = q.shape
    dq = torch.empty_like(q)
    _launch(_DQ, _DQ_SYM, q, (q, k, v, do, lse, delta, dq),
            (bh, bh // k.shape[0], t_len, d), sm_scale, causal)
    return dq


def flash_attention_bwd_dkv(q, k, v, o, lse, do, causal: bool = True,
                            sm_scale: Optional[float] = None,
                            delta: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B4 on CUDA tensors, the plain version on CPU tensors:
    ``(dk, dv)`` at kv-head width ``[B*KVH, T, D]``, summed over each
    group's query heads."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_plain(q, k, v, o, lse, do, causal,
                                             sm_scale)
    delta = _bwd_inputs(_DKV, q, k, v, o, lse, do, delta)
    bkv, t_len, d = k.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch(_DKV, _DKV_SYM, q, (q, k, v, do, lse, delta, dk, dv),
            (bkv, q.shape[0] // bkv, t_len, d), sm_scale, causal)
    return dk, dv


# -- public API ------------------------------------------------------------------
def check_dispatch(q_shape, k_shape, block_q: int = 1024,
                   block_k: int = 1024) -> bool:
    """The JAX dispatch rule (``_bwd`` ``:373``): True when the backward
    is the fused kernel B2 (one kv head per query head and the whole
    sequence in one block), False when it is B3 then B4.  Raises for
    query heads not divisible by kv heads and for Tq != Tk."""
    bh, tq = q_shape[0], q_shape[1]
    bkv, tk = k_shape[0], k_shape[1]
    if bh % bkv:
        raise ValueError(
            f"flash_attention GQA needs query heads divisible by kv heads: "
            f"got leading dims {bh} vs {bkv}")
    if tq != tk:
        raise NotImplementedError(
            f"flash_attention: query length {tq} != key length {tk}")
    nq = -(-tq // min(block_q, tq))
    nk = -(-tk // min(block_k, tk))
    return nq == 1 and nk == 1 and bh == bkv


class _FlashAttention(torch.autograd.Function):
    """B1 forward; B2, or B3 then B4, backward; saves only q, k, v, o and
    lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, fused):
        o, lse = flash_attention_fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale, ctx.fused = causal, sm_scale, fused
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = _delta(o, do)
        if ctx.fused:
            dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.causal,
                                             ctx.sm_scale, delta)
        else:
            dq = flash_attention_bwd_dq(q, k, v, o, lse, do, ctx.causal,
                                        ctx.sm_scale, delta)
            dk, dv = flash_attention_bwd_dkv(q, k, v, o, lse, do, ctx.causal,
                                             ctx.sm_scale, delta)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = True,
                    sm_scale: Optional[float] = None, block_q: int = 1024,
                    block_k: int = 1024) -> torch.Tensor:
    """q ``[B*H, T, D]``, k/v ``[B*KVH, T, D]`` → ``[B*H, T, D]``,
    differentiable; ``block_q``/``block_k`` are the JAX kernels' blocks,
    which pick the backward (see :func:`check_dispatch`)."""
    fused = check_dispatch(q.shape, k.shape, block_q, block_k)
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), bool(causal), sm_scale,
                                 fused)


def flash_attention_bthd(q, k, v, causal: bool = True,
                         sm_scale: Optional[float] = None,
                         block_q: int = 1024,
                         block_k: int = 1024) -> torch.Tensor:
    """Model-layout adapter: q ``[B, T, H, D]``, k/v ``[B, T, KVH, D]`` →
    ``[B, T, H, D]``."""
    b, t, h, d = q.shape

    def pack(x):
        return x.transpose(1, 2).reshape(b * x.shape[2], x.shape[1], d)
    o = flash_attention(pack(q), pack(k), pack(v), causal, sm_scale,
                        block_q, block_k)
    return o.reshape(b, h, t, d).transpose(1, 2)
