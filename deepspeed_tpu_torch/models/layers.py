"""Functional layers of the port (counterpart of
``deepspeed_tpu/models/layers.py``, the subset the GPT-2 family uses).

Parameters are plain nested dicts of tensors in the JAX package's
layouts: dense kernels are ``[in, out]`` and embeddings ``[vocab, d]``,
so weights cross between the two packages with no transpose.
LayerNorm and softmax run in f32 whatever the activation dtype.
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


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU (``jax.nn.gelu(approximate=True)``)."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def embedding_apply(params: Params, ids: torch.Tensor,
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    emb = params["embedding"]
    out = emb[ids]
    return out if dtype is None else out.to(dtype)


def embedding_attend(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Tied projection ``x @ embedding.T``, returned as f32 logits.  The
    product runs in x's dtype (bf16 on the card): the JAX package's
    einsum keeps an f32 result from bf16 operands, here the bf16 result
    is widened."""
    emb = params["embedding"]
    return torch.matmul(x, (emb if emb.dtype == x.dtype
                            else emb.to(x.dtype)).t()).float()


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     *, mask: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None,
                     kv_positions_offset: int = 0) -> torch.Tensor:
    """Plain attention, q ``[B, Tq, H, D]``, k/v ``[B, Tk, H, D]``:
    scores and softmax in f32, probabilities cast to q's dtype for the
    value product; causal with query i at position
    ``kv_positions_offset + i``; ``mask`` (broadcastable to
    ``[B, H, Tq, Tk]``) keeps True entries.  Returns ``[B, Tq, H, D]``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    tq, tk = q.shape[1], k.shape[1]
    q_pos = torch.arange(tq, device=q.device) + kv_positions_offset
    k_pos = torch.arange(tk, device=q.device)
    keep = q_pos[:, None] >= k_pos[None, :]
    if mask is not None:
        keep = keep & mask
    logits = logits.masked_fill(~keep, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.to(q.dtype))
