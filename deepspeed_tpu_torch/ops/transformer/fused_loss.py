"""Fused loss head: masked softmax cross-entropy through a linear head,
as one ``torch.autograd.Function``.

Counterpart of ``deepspeed_tpu/ops/transformer/fused_loss.py``
(``fused_linear_xent``).  No ``[N, V]`` tensor crosses from the forward
to the backward:

* the forward walks row chunks, computes each chunk's logits, its
  logsumexp and target logit, and keeps only the masked NLL sum and the
  mask count;
* the backward recomputes each chunk's logits and forms the analytic
  gradient ``ds = (softmax(logits) - onehot(labels)) * mask * g`` in
  place, which the dx and dw products consume at once.

Saved for the backward: x, w, bias, labels and the mask.  The head is
tied (``w [V, D]``, ``transpose_w=True``) or untied (``w [D, V]`` with an
optional bias ``[V]``).  The logits product casts w to x's dtype and
returns float32 logits from those operands with float32 accumulation
(``models/layers.py::f32_product``, the JAX package's
``preferred_element_type=float32``); the backward products run in
float32 on an upcast w, as in the JAX package.  The products are
``torch`` matrix products: the JAX package leaves them to XLA, outside
any Pallas kernel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...models.layers import f32_product


def _logits(xc, w, b, transpose_w: bool) -> torch.Tensor:
    lg = f32_product(xc, w.t() if transpose_w else w)
    return lg if b is None else lg + b.float()


class _FusedLinearXent(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, bias, labels, maskf, transpose_w, csize):
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for c0 in range(0, x.shape[0], csize):
            lg = _logits(x[c0:c0 + csize], w, bias, transpose_w)
            yc, mc = labels[c0:c0 + csize], maskf[c0:c0 + csize]
            lse = torch.logsumexp(lg, dim=-1)
            tgt = lg.gather(1, yc[:, None])[:, 0]
            total = total + torch.sum((lse - tgt) * mc)
            del lg
        count = maskf.sum()
        ctx.save_for_backward(x, w, bias, labels, maskf)
        ctx.transpose_w, ctx.csize = transpose_w, csize
        ctx.mark_non_differentiable(count)
        return total, count

    @staticmethod
    def backward(ctx, g_total, g_count):
        x, w, bias, labels, maskf = ctx.saved_tensors
        tw, csize = ctx.transpose_w, ctx.csize
        gs = g_total.float()
        w32 = w.float()
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        db = (None if bias is None else
              torch.zeros(bias.shape, dtype=torch.float32,
                          device=bias.device))
        dx = []
        for c0 in range(0, x.shape[0], csize):
            xc = x[c0:c0 + csize]
            yc, mc = labels[c0:c0 + csize], maskf[c0:c0 + csize]
            coef = mc * gs
            ds = torch.softmax(_logits(xc, w, bias, tw), dim=-1)
            ds.mul_(coef[:, None])
            ds[torch.arange(ds.shape[0], device=ds.device), yc] -= coef
            x32 = xc.float()
            if tw:      # logits = x w^T, w [V, D]
                dx.append(torch.matmul(ds, w32))
                dw.addmm_(ds.t(), x32)
            else:       # logits = x w, w [D, V]
                dx.append(torch.matmul(ds, w32.t()))
                dw.addmm_(x32.t(), ds)
            if db is not None:
                db += ds.sum(dim=0)
            del ds
        dxt = torch.cat(dx).to(x.dtype)
        return (dxt, dw.to(w.dtype),
                None if db is None else db.to(bias.dtype),
                None, None, None, None)


def fused_linear_xent(x: torch.Tensor, w: torch.Tensor,
                      labels: torch.Tensor,
                      mask: Optional[torch.Tensor] = None,
                      bias: Optional[torch.Tensor] = None, *,
                      transpose_w: bool = False, chunk: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x ``[N, D]``, w ``[D, V]`` (``[V, D]`` with ``transpose_w``),
    labels ``[N]``, mask ``[N]`` (None = all ones), bias ``[V]`` or None;
    ``chunk`` rows per chunk (0 or a non-divisor of N = one chunk).
    Returns ``(nll_sum, count)`` as float32 scalars, differentiable in x,
    w and bias."""
    n = x.shape[0]
    maskf = (torch.ones((n,), dtype=torch.float32, device=x.device)
             if mask is None else mask.to(torch.float32))
    csize = chunk if (0 < chunk < n and n % chunk == 0) else n
    return _FusedLinearXent.apply(x, w, bias, labels.long(), maskf,
                                  bool(transpose_w), csize)
