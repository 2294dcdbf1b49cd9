"""Functional layers of the port (counterpart of
``deepspeed_tpu/models/layers.py``: every piece the model families of
``module_inject/policies.py`` use, ALiBi included).

Parameters are plain nested dicts of tensors in the JAX package's
layouts: dense kernels are ``[in, out]`` and embeddings ``[vocab, d]``,
so weights cross between the two packages with no transpose.
LayerNorm, RMSNorm, rotary embeddings and softmax run in f32 whatever
the activation dtype; logits come out in f32 from operands in the
activation dtype (:func:`f32_product`).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

Params = Dict[str, torch.Tensor]


def normal_init(shape, stddev: float, generator: torch.Generator,
                device, dtype) -> torch.Tensor:
    """Normal(0, stddev) drawn in f32 from ``generator``, then cast."""
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return w.mul_(stddev).to(dtype)


def scaled_init(shape, stddev: float, num_layers: int,
                generator: torch.Generator, device, dtype) -> torch.Tensor:
    """GPT-2 residual-branch init: stddev / sqrt(2 * num_layers)."""
    return normal_init(shape, stddev / math.sqrt(2.0 * num_layers),
                       generator, device, dtype)


def dense_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """``x @ kernel (+ bias)`` with the kernel cast to x's dtype (bf16 in
    → bf16 out, as ``dense_apply`` in the JAX package)."""
    w = params["kernel"]
    w = w if w.dtype == x.dtype else w.to(x.dtype)
    b = params.get("bias")
    if b is not None and b.dtype != x.dtype:
        b = b.to(x.dtype)
    # F.linear wants [out, in]: the transposed view costs nothing, and the
    # bias rides the same GEMM call
    return torch.nn.functional.linear(x, w.t(), b)


def layernorm_apply(params: Params, x: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm computed in f32, returned in x's dtype."""
    b = params.get("bias")
    y = torch.nn.functional.layer_norm(
        x.float(), (x.shape[-1],), params["scale"].float(),
        None if b is None else b.float(), eps)
    return y.to(x.dtype)


def rmsnorm_apply(params: Params, x: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm computed in f32, returned in x's dtype."""
    x32 = x.float()
    y = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (y * params["scale"].float()).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU (``jax.nn.gelu(approximate=True)``)."""
    return torch.nn.functional.gelu(x, approximate="tanh")


ACT_FNS = {
    "gelu": gelu,
    "gelu_exact": lambda x: torch.nn.functional.gelu(x, approximate="none"),
    "relu": torch.relu,
    "silu": torch.nn.functional.silu,
}


def rotary_freqs(rotary_dim: int, max_seq: int, base: float = 10000.0):
    """``(cos, sin)`` f32 tables ``[max_seq, rotary_dim / 2]`` on the CPU
    (the caller moves them to its device)."""
    inv = 1.0 / (base ** (torch.arange(0, rotary_dim, 2,
                                       dtype=torch.float32) / rotary_dim))
    freqs = torch.outer(torch.arange(max_seq, dtype=torch.float32), inv)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                 positions: Optional[torch.Tensor] = None,
                 interleaved: bool = True) -> torch.Tensor:
    """x ``[B, T, H, D]``: rotate the first ``2 * cos.shape[-1]`` features
    by each row's position (``positions [B|1, T]``; None = 0 .. T-1).
    ``interleaved`` pairs features (2i, 2i + 1) (GPT-J), else (i, i + d/2)
    (rotate-half: NeoX, LLaMA).  The product is taken in f32 (x promotes
    against the f32 tables) and cast back to x's dtype."""
    rotary_dim = cos.shape[-1] * 2
    x_rot, x_pass = x[..., :rotary_dim], x[..., rotary_dim:]
    if positions is None:
        c = cos[None, :x.shape[1], None, :]
        s = sin[None, :x.shape[1], None, :]
    else:
        c = cos[positions][:, :, None, :]
        s = sin[positions][:, :, None, :]
    if interleaved:
        x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
        y = torch.stack([x1 * c - x2 * s, x2 * c + x1 * s],
                        dim=-1).reshape(x_rot.shape)
    else:
        half = rotary_dim // 2
        x1, x2 = x_rot[..., :half], x_rot[..., half:]
        y = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return torch.cat([y.to(x.dtype), x_pass], dim=-1)


def embedding_apply(params: Params, ids: torch.Tensor,
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    emb = params["embedding"]
    out = emb[ids]
    return out if dtype is None else out.to(dtype)


class _MixedProduct(torch.autograd.Function):
    """``x @ w`` (2-D, one low-precision dtype) with an f32 result from
    one cuBLAS GEMM (``torch.mm``'s ``out_dtype``, which has no
    derivative of its own); the backward rounds the incoming gradient to
    the operands' dtype and takes the two products in it, as the
    widened low-precision product's backward did."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        gx = torch.mm(g, w.t()) if ctx.needs_input_grad[0] else None
        gw = torch.mm(x.t(), g) if ctx.needs_input_grad[1] else None
        return gx, gw


def f32_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [..., K] @ w [K, N]`` as float32, the operands in x's dtype
    (w is cast to it): XLA's ``preferred_element_type=float32``.  On the
    card a bf16 product is one cuBLAS GEMM with f32 accumulation and an
    f32 result, so no bf16 rounding of the logits happens; on the CPU,
    and for f32 operands, a plain product widened."""
    w = w if w.dtype == x.dtype else w.to(x.dtype)
    if x.device.type == "cpu" or x.dtype == torch.float32:
        return torch.matmul(x, w).float()
    out = _MixedProduct.apply(x.reshape(-1, x.shape[-1]), w)
    return out.reshape(*x.shape[:-1], w.shape[-1])


def embedding_attend(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Tied projection ``x @ embedding.T`` as f32 logits from operands in
    x's dtype (the JAX package's einsum with
    ``preferred_element_type=float32``)."""
    return f32_product(x, params["embedding"].t())


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  *, mask: Optional[torch.Tensor] = None,
                  scale: Optional[float] = None,
                  kv_positions_offset: int = 0, causal: bool = True,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain attention, q ``[B, Tq, H, D]`` with H = g KVH against k/v
    ``[B, Tk, KVH, D]`` (multi-head attention is g = 1), through a group
    einsum that never materialises expanded k/v: scores and softmax in
    f32, probabilities cast to q's dtype for the value product, query i
    at position ``kv_positions_offset + i``.  ``scale`` multiplies the
    scores (None: ``1 / sqrt(D)``); ``bias`` (f32, broadcastable to
    ``[B, H, Tq, Tk]``: ALiBi) is added to them, regrouped over (kv
    heads, group); ``causal=False`` drops the causal mask (encoders);
    ``mask`` (bool, True = visible) is broadcastable to ``[B, KVH, g, Tq,
    Tk]`` and hides pairs on top of it.  Returns ``[B, Tq, H, D]``."""
    b, tq, nh, hd = q.shape
    nkv = k.shape[2]
    g = nh // nkv
    qg = q.reshape(b, tq, nkv, g, hd)
    logits = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float())
    logits = (logits / math.sqrt(hd) if scale is None
              else logits * scale)
    if bias is not None:
        bias = bias.float().expand(*bias.shape[:-3], nh, *bias.shape[-2:])
        logits = logits + bias.reshape(*bias.shape[:-3], nkv, g,
                                       *bias.shape[-2:])
    tk = k.shape[1]
    if causal:
        q_pos = torch.arange(tq, device=q.device) + kv_positions_offset
        keep = q_pos[:, None] >= torch.arange(tk, device=q.device)[None, :]
        logits = logits.masked_fill(~keep, -1e30)
    if mask is not None:
        logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v.to(q.dtype))
    return out.reshape(b, tq, nh, hd)


def alibi_slopes(num_heads: int) -> torch.Tensor:
    """ALiBi head slopes ``[H]`` f32 (Press et al.; BLOOM's
    ``build_alibi_tensor``): powers of ``2^(-8/n)`` for the largest power
    of two n <= H, the heads past it interleaved from ``2^(-4/n)``."""
    n = 2 ** math.floor(math.log2(num_heads))
    base = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
    slopes = [base ** (i + 1) for i in range(n)]
    if n < num_heads:
        extra = 2.0 ** (-(2.0 ** -(math.log2(2 * n) - 3)))
        slopes += [extra ** (i + 1)
                   for i in range(0, 2 * (num_heads - n), 2)]
    return torch.tensor(slopes, dtype=torch.float32)


def alibi_bias(num_heads: int, tk: int, q_positions: torch.Tensor,
               slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[H, Tq, Tk]`` f32 additive bias ``-slope_h * |q_pos - k_pos|``
    for queries at ``q_positions [Tq]`` over keys 0 .. tk - 1 (a distance
    penalty both ways, so an encoder may use it too); ``slopes`` ``[H]``
    default to ``alibi_slopes(num_heads)`` (a tensor-parallel shard
    passes its slice of the whole model's)."""
    dev = q_positions.device
    slopes = (alibi_slopes(num_heads) if slopes is None else slopes).to(dev)
    rel = -(torch.arange(tk, device=dev)[None, :]
            - q_positions[:, None]).abs()
    return slopes[:, None, None] * rel[None].float()
