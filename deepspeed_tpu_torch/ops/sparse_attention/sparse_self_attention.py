"""Block-sparse self-attention with a cost-based route.

Counterpart of ``deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py``
(the reference's ``SparseSelfAttention``).  Neither route is a kernel of
the JAX package (both are jnp there), so both are plain PyTorch here:
the gathered-block route gathers the layout's True blocks into a dense
``[B*H, nnz, block, block]`` batch, takes a softmax across each query
block's row of blocks (segment max and sum) and scatter-adds the value
products back; the dense route is the flash kernel B1 for full or causal
layouts at T >= 1024 and a masked dense pass otherwise.  The route never
changes the answer, only the algorithm.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .sparsity_config import SparsityConfig

MASK_VALUE = -1e30

#: the JAX package's cost-based routing constants (its module documents
#: the calibration; no time of it carries over to the port):
#:   * full/causal-equivalent layouts always route dense;
#:   * genuinely masked layouts route dense when the layout is not
#:     sparse enough (density >= DENSE_ROUTE_DENSITY) or the attended
#:     work per query row is tiny (density * seq <
#:     DENSE_ROUTE_MIN_TOKENS), but only up to DENSE_ROUTE_MAX_MASKED_SEQ:
#:     the masked dense pass materialises [B, H, T, T] scores.
DENSE_ROUTE_DENSITY = 0.1
DENSE_ROUTE_MIN_TOKENS = 512
DENSE_ROUTE_MAX_MASKED_SEQ = 2048


def _unidirectional(config) -> bool:
    return getattr(config, "attention", "bidirectional") == "unidirectional"


class SparseSelfAttention:
    """Callable attention bound to a SparsityConfig: ``q, k, v [B, T, H,
    D] → [B, T, H, D]`` over the layout's True blocks (see
    :meth:`routes_dense` for the route)."""

    def __init__(self, sparsity_config: SparsityConfig,
                 max_seq_length: int,
                 dense_route_density: float = DENSE_ROUTE_DENSITY,
                 dense_route_min_tokens: float = DENSE_ROUTE_MIN_TOKENS,
                 dense_route_max_masked_seq: int =
                 DENSE_ROUTE_MAX_MASKED_SEQ):
        self.config = sparsity_config
        self.block = sparsity_config.block
        self.dense_route_density = dense_route_density
        self.dense_route_min_tokens = dense_route_min_tokens
        self.dense_route_max_masked_seq = dense_route_max_masked_seq
        self._dense_mask = None           # lazy [T, T] numpy mask
        self.layout = sparsity_config.make_layout(max_seq_length)
        uni = _unidirectional(sparsity_config)
        if uni:
            # prune whole future blocks; the diagonal keeps in-block masking
            self.layout = self.layout & np.tril(
                np.ones_like(self.layout, bool))
        rows, cols = np.nonzero(self.layout)
        self._rows = torch.from_numpy(rows)       # [nnz] query-block ids
        self._cols = torch.from_numpy(cols)       # [nnz] kv-block ids
        self.nnz = len(rows)
        self.num_blocks = self.layout.shape[0]
        self._diag = torch.from_numpy(rows == cols)
        # dense-equivalence kind, from the block layout alone: 'full' = no
        # masking, 'causal' = exactly lower-triangular, 'masked' = other
        lay = np.asarray(self.layout, bool)
        if not uni and lay.all():
            self.mask_kind = "full"
        elif uni and (lay == np.tril(np.ones_like(lay))).all():
            self.mask_kind = "causal"
        else:
            self.mask_kind = "masked"

    def routes_dense(self, seq_len: int) -> bool:
        """True when the dense path is expected to beat the gathered-block
        path for this layout at ``seq_len`` (the JAX package's rule)."""
        if self.mask_kind in ("full", "causal"):
            return True
        density = self.density()
        return (seq_len <= self.dense_route_max_masked_seq
                and (density >= self.dense_route_density
                     or density * seq_len < self.dense_route_min_tokens))

    def _layout_mask(self, t: int) -> np.ndarray:
        """``[T, T]`` bool mask equal to the block layout (+ in-block
        causal for unidirectional), built when the masked dense route
        first runs."""
        if self._dense_mask is None:
            blk = self.block
            mask = np.kron(np.asarray(self.layout, bool),
                           np.ones((blk, blk), bool))
            if _unidirectional(self.config):
                mask &= np.tril(np.ones_like(mask))
            self._dense_mask = mask
        if self._dense_mask.shape[0] != t:
            raise ValueError(f"seq {t} != layout "
                             f"{self.num_blocks}x{self.block}")
        return self._dense_mask

    def _dense_attention(self, q, k, v, sm_scale):
        """The dense route: the same masked softmax attention without the
        block gather (f32 scores, MASK_VALUE fill)."""
        t = q.shape[1]
        kind = self.mask_kind
        default_scale = abs(sm_scale - 1.0 / math.sqrt(q.shape[-1])) < 1e-12
        if kind in ("full", "causal") and default_scale and t >= 1024:
            from ..transformer.flash_attention import flash_attention_bthd
            return flash_attention_bthd(q, k, v, causal=(kind == "causal"))
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
        if kind == "causal":
            tri = torch.ones((t, t), dtype=torch.bool,
                             device=q.device).tril()
            s = s.masked_fill(~tri, MASK_VALUE)
        elif kind == "masked":
            keep = torch.from_numpy(self._layout_mask(t)).to(q.device)
            s = s.masked_fill(~keep, MASK_VALUE)
        p = torch.softmax(s, dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", p, v)

    def __call__(self, q, k, v, sm_scale: Optional[float] = None):
        """q, k, v: [B, T, H, D] → [B, T, H, D]. Layout True blocks only."""
        b, t, h, d = q.shape
        nb, blk = self.num_blocks, self.block
        if t != nb * blk:
            raise ValueError(f"seq {t} != layout {nb}x{blk}")
        if sm_scale is None:
            sm_scale = 1.0 / math.sqrt(d)
        if self.routes_dense(t):
            return self._dense_attention(q, k, v, sm_scale)

        def pack(x):   # [B,T,H,D] -> [BH, nb, blk, D]
            return x.transpose(1, 2).reshape(b * h, nb, blk, d)
        qb, kb, vb = pack(q), pack(k), pack(v)
        dev = q.device
        seg, cols = self._rows.to(dev), self._cols.to(dev)

        # SDD: gather block pairs, one batched product over nnz blocks
        s = torch.einsum("znqd,znkd->znqk", qb[:, seg].float(),
                         kb[:, cols].float()) * sm_scale
        if _unidirectional(self.config):
            tri = torch.ones((blk, blk), dtype=torch.bool, device=dev).tril()
            s = s.masked_fill(self._diag.to(dev)[None, :, None, None]
                              & ~tri[None, None], MASK_VALUE)

        # sparse softmax across each query block's row of blocks: segment
        # max and sum over the blocks that share a query-block id
        bh = b * h
        m_blk = s.amax(dim=3)                              # [BH, nnz, blk]
        idx = seg[None, :, None].expand_as(m_blk)
        m_row = torch.full((bh, nb, blk), float("-inf"), device=dev
                           ).scatter_reduce(1, idx, m_blk, "amax")
        p = torch.exp(s - m_row[:, seg][..., None])
        l_row = torch.zeros((bh, nb, blk), device=dev).index_add(
            1, seg, p.sum(dim=3))
        p = p / torch.clamp(l_row[:, seg], min=1e-20)[..., None]

        # DSD: probs @ v, scatter-add per query block
        ob = torch.einsum("znqk,znkd->znqd", p.to(v.dtype), vb[:, cols])
        out = torch.zeros((bh, nb, blk, d), dtype=ob.dtype,
                          device=dev).index_add(1, seg, ob)
        return out.reshape(b, h, t, d).transpose(1, 2)

    def density(self) -> float:
        return self.nnz / float(self.num_blocks ** 2)
