"""Flash attention for training: kernels B1 (forward) and B2 (fused
backward) behind one ``torch.autograd.Function``, with their plain
versions.

Counterpart of ``deepspeed_tpu/ops/transformer/flash_attention.py``:
``_fwd_kernel`` (via ``_fwd``) is ``csrc/flash_attention_fwd.cu`` and
``_bwd_fused_kernel`` (via ``_bwd_fused``) is
``csrc/flash_attention_bwd.cu``.  The JAX package's dispatch rule is
kept: with ``block_q = min(block_q, T)`` and ``block_k = min(block_k,
T)``, a sequence that fits one block with as many kv heads as query
heads takes the fused backward.  Every other case (T past one block,
grouped-query attention) runs the two-pass backward, kernels B3 and B4,
which a later slice of the port brings; here it raises
``NotImplementedError``.

Layout contract (the JAX package's): q, k, v ``[B*H, T, D]``; the
forward also returns the per-row logsumexp ``lse [B*H, T]`` in float32
(the TPU kernel replicates it over 8 sublanes, a tiling artefact the
port drops).  Probabilities are rounded to v's dtype before the P.V
product; in the backward p is rounded to dO's dtype before dV and ds to
q's dtype before dQ and dK; every sum is float32.  Rows past T are never
read.  On CUDA tensors the wrappers launch the kernels; on CPU tensors
they run the plain versions, which compute the same function in float32
at the same rounding points.
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

#: head dims the kernels are built for
KERNEL_HEAD_DIMS = (16, 32, 64, 128)


def _scale(d: int, sm_scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(d) if sm_scale is None else float(sm_scale)


def _check(what: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           *others: torch.Tensor) -> None:
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{what}: q, k, v must share one [B*H, T, D] shape "
                         f"(one kv head per query head), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    for t in (k, v) + others:
        if t.dtype != q.dtype:
            raise TypeError(f"{what}: dtypes differ ({q.dtype}, {t.dtype})")
        if t.device != q.device:
            raise ValueError(f"{what}: operands on different devices")


def _visible(tq: int, tk: int, causal: bool, device) -> Optional[torch.Tensor]:
    if not causal:
        return None
    return torch.ones((tq, tk), dtype=torch.bool, device=device).tril()


def _scores(q, k, scale, causal, keep):
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    if keep is None:
        keep = _visible(q.shape[1], k.shape[1], causal, q.device)
    if keep is not None:
        s = s.masked_fill(~keep, float("-inf"))
    return s


# -- plain versions -----------------------------------------------------------
def flash_attention_fwd_plain(q, k, v, causal: bool = True,
                              sm_scale: Optional[float] = None,
                              keep: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of B1: ``(o, lse)`` in float32 at the kernel's
    rounding points.  ``keep`` ([Tq, Tk] bool, True = visible) replaces
    the causal mask when given."""
    _check("flash_attention_fwd_plain", q, k, v)
    s = _scores(q, k, _scale(q.shape[-1], sm_scale), causal, keep)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal: bool = True,
                              sm_scale: Optional[float] = None,
                              keep: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Plain version of B2: ``(dq, dk, dv)`` from the forward's ``o`` and
    ``lse`` and the output gradient ``do``, in float32 at the kernel's
    rounding points."""
    _check("flash_attention_bwd_plain", q, k, v, o, do)
    scale = _scale(q.shape[-1], sm_scale)
    delta = (do.float() * o.float()).sum(dim=-1)
    p = torch.exp(_scores(q, k, scale, causal, keep) - lse[..., None])
    dv = torch.matmul(p.to(do.dtype).float().transpose(1, 2), do.float())
    dp = torch.matmul(do.float(), v.float().transpose(1, 2))
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype).float()
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(1, 2), q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# -- kernels -------------------------------------------------------------------
def _check_kernel(what: str, tensors) -> None:
    for name, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} not 16-byte aligned")
    bh, t_len, d = tensors[0][1].shape
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{what} kernel: head_dim {d} not in "
                         f"{KERNEL_HEAD_DIMS}")
    if not 1 <= bh <= 65535 or t_len < 1:
        raise ValueError(f"{what} kernel: B*H {bh} outside [1, 65535] or "
                         f"T {t_len} < 1")


@functools.lru_cache(maxsize=None)
def _fwd_kernel():
    lib = build.load_library(_FWD)
    fn = getattr(lib, _FWD_SYM)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, P, I, I, I, ctypes.c_float, I, I, P]
    fn.restype = I
    return lib, fn


@functools.lru_cache(maxsize=None)
def _bwd_kernel():
    lib = build.load_library(_BWD)
    fn = getattr(lib, _BWD_SYM)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, P, P, P, P, P, I, I, I, ctypes.c_float, I, I,
                   P]
    fn.restype = I
    return lib, fn


def flash_attention_fwd(q, k, v, causal: bool = True,
                        sm_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B1 on CUDA tensors, the plain version on CPU tensors:
    ``(o [B*H, T, D], lse [B*H, T] float32)``."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, sm_scale)
    _check("flash_attention_fwd", q, k, v)
    code = build.dtype_code(q, "flash_attention_fwd")
    _check_kernel(_FWD, (("q", q), ("k", k), ("v", v)))
    bh, t_len, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, t_len), dtype=torch.float32, device=q.device)
    lib, fn = _fwd_kernel()
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bh, t_len, d, _scale(d, sm_scale), int(causal),
            code, build.current_stream(q.device))
    build.check_launch(lib, _FWD_SYM, rc)
    build.launch_counts[_FWD] += 1
    return o, lse


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True,
                        sm_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel B2 on CUDA tensors, the plain version on CPU tensors:
    ``(dq, dk, dv)``.  ``delta = rowsum(dO * O)`` is a PyTorch reduction
    outside the kernel, as in the JAX package.  Only the cases the JAX
    dispatch rule sends to the fused backward (MHA, T in one 1024 block)
    are taken; the others raise, naming B3/B4."""
    check_dispatch(q.shape, k.shape)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal,
                                         sm_scale)
    _check("flash_attention_bwd", q, k, v, o, do)
    code = build.dtype_code(q, "flash_attention_bwd")
    _check_kernel(_BWD, (("q", q), ("k", k), ("v", v), ("o", o),
                         ("do", do)))
    bh, t_len, d = q.shape
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (bh, t_len)
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"flash_attention_bwd: lse must be a contiguous "
                         f"float32 [{bh}, {t_len}] on {q.device}")
    delta = (do.float() * o.float()).sum(dim=-1)
    dq, dk, dv = (torch.empty_like(q), torch.empty_like(k),
                  torch.empty_like(v))
    lib, fn = _bwd_kernel()
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), bh, t_len, d, _scale(d, sm_scale), int(causal),
            code, build.current_stream(q.device))
    build.check_launch(lib, _BWD_SYM, rc)
    build.launch_counts[_BWD] += 1
    return dq, dk, dv


# -- public API ------------------------------------------------------------------
def check_dispatch(q_shape, k_shape, block_q: int = 1024,
                   block_k: int = 1024) -> None:
    """Raise unless the JAX dispatch rule sends this call to B1 + B2:
    one kv head per query head and the whole sequence in one block."""
    bh, tq = q_shape[0], q_shape[1]
    bkv, tk = k_shape[0], k_shape[1]
    if bh % bkv:
        raise ValueError(
            f"flash_attention GQA needs query heads divisible by kv heads: "
            f"got leading dims {bh} vs {bkv}")
    nq = -(-tq // min(block_q, tq))
    nk = -(-tk // min(block_k, tk))
    if bh != bkv or nq > 1 or nk > 1:
        raise NotImplementedError(
            f"flash_attention with {bh // bkv} query heads per kv head and "
            f"{nq} x {nk} blocks (T {tq}, blocks {block_q} x {block_k}) runs "
            f"the two-pass backward, kernels B3 (dq) and B4 (dk/dv), which a "
            f"later slice of the PyTorch port brings")
    if tq != tk:
        raise NotImplementedError(
            f"flash_attention: query length {tq} != key length {tk}")


class _FlashAttention(torch.autograd.Function):
    """B1 forward, B2 backward; saves only q, k, v, o and lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        o, lse = flash_attention_fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True,
                    sm_scale: Optional[float] = None, block_q: int = 1024,
                    block_k: int = 1024) -> torch.Tensor:
    """q, k, v ``[B*H, T, D]`` → ``[B*H, T, D]``, differentiable."""
    check_dispatch(q.shape, k.shape, block_q, block_k)
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), bool(causal), sm_scale)


def flash_attention_bthd(q, k, v, causal: bool = True,
                         sm_scale: Optional[float] = None,
                         block_q: int = 1024,
                         block_k: int = 1024) -> torch.Tensor:
    """Model-layout adapter: q, k, v ``[B, T, H, D]`` → ``[B, T, H, D]``."""
    b, t, h, d = q.shape

    def pack(x):
        return x.transpose(1, 2).reshape(b * x.shape[2], x.shape[1], d)
    o = flash_attention(pack(q), pack(k), pack(v), causal, sm_scale,
                        block_q, block_k)
    return o.reshape(b, h, t, d).transpose(1, 2)
