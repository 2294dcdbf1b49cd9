"""Block-sparse flash attention: kernels B8 (forward), B9 (dq pass) and
B10 (dk/dv pass) behind one ``torch.autograd.Function``, with their plain
versions.

Counterpart of ``deepspeed_tpu/ops/sparse_attention/blocksparse_flash.py``:
``_fwd_kernel`` is ``csrc/blocksparse_flash_fwd.cu``, ``_bwd_dq_kernel``
``csrc/blocksparse_flash_bwd_dq.cu`` and ``_bwd_dkv_kernel``
``csrc/blocksparse_flash_bwd_dkv.cu``.  They are the flash kernels B1, B3
and B4 with another walk: a query tile walks the list of kv tiles its
layout row holds (B8, B9), a kv tile the list of query tiles that read
it (B10), so work and bytes grow with the layout's nonzero blocks and
not with T².

Layout contract (the JAX package's): q, k, v ``[B*H, T, D]`` with one kv
head per query head (a grouped model expands k/v first); ``layout_c`` is
:func:`compress_layout` of a ``[H, T/block, T/block]`` block layout, and
head row b reads layout head ``b % nheads``.  Scores of pairs outside the
layout (or above the diagonal when causal) take the finite
``MASK_VALUE``, not -inf: a row that sees no key in one tile pair and
keys in a later one then carries finite junk that the first real maximum
scales to 0, where -inf would give ``-inf - -inf`` = NaN.  The forward
also returns ``lse [B*H, T]`` in float32 (without the TPU's 8-sublane
copy).  Rounding points: p rounded to v's dtype before P.V; in the
backward p to dO's dtype before dV, ds to k's dtype before dQ and to q's
before dK; every sum float32; ``delta = rowsum(dO * O)`` is a PyTorch
reduction outside the kernels.

The kernels work on 64-row tiles (``flash_tiles.cuh``).  The index lists
are built on the host once per (layout, T) at that granularity and
copied to each device once: a layout block of 64·m rows covers m x m
tile pairs; blocks of 16 and 32 share a tile pair, which is walked when
any of its sub-blocks is set and carries a 16-bit mask of them (bit
``4 i + j`` for query sub-block i and key sub-block j); any other
multiple of 16 (48, 80, 96, ...) is masked the same way in sub-blocks of
16 rows, each of which lies in one layout block.  The kernels run every
block that is a multiple of 16, head dims ``KERNEL_HEAD_DIMS`` and
float32, bfloat16 or float16 (``build.kernel_supports``); anything else raises in
the wrapper.  On CPU tensors
the wrappers run the plain versions, which take any block that divides T
and walk the same lists one tile at a time, so their memory grows with
the nonzero blocks and not with T².
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..transformer import flash_attention as FA
from ..transformer.flash_attention import KERNEL_HEAD_DIMS

MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)

#: rows of the kernels' q and kv tiles (``flash_tiles.cuh`` kTile)
TILE = 64

_FWD, _FWD_SYM = "blocksparse_flash_fwd", "dstt_blocksparse_flash_fwd"
_DQ, _DQ_SYM = "blocksparse_flash_bwd_dq", "dstt_blocksparse_flash_bwd_dq"
_DKV, _DKV_SYM = ("blocksparse_flash_bwd_dkv",
                  "dstt_blocksparse_flash_bwd_dkv")


def compress_layout(layout: np.ndarray) -> Tuple[np.ndarray, np.ndarray,
                                                 np.ndarray, np.ndarray]:
    """[H, nq, nk] 0/1 layout → (idx [H,nq,J], counts [H,nq],
    idxT [H,nk,Jt], countsT [H,nk]) with J/Jt = max row/col nnz; padding
    repeats the last valid index (masked off by the counts)."""
    layout = np.asarray(layout).astype(bool)
    h, nq, nk = layout.shape
    counts = layout.sum(-1).astype(np.int32)
    countsT = layout.sum(1).astype(np.int32)
    if (counts == 0).any():
        raise ValueError("layout has an empty q-block row — every query "
                         "block must attend to at least one kv block "
                         "(causal layouts always include the diagonal)")
    j = int(counts.max())
    jt = max(1, int(countsT.max()))
    idx = np.zeros((h, nq, j), np.int32)
    idxT = np.zeros((h, nk, jt), np.int32)
    for hh in range(h):
        for qi in range(nq):
            nz = np.nonzero(layout[hh, qi])[0]
            idx[hh, qi, :len(nz)] = nz
            idx[hh, qi, len(nz):] = nz[-1] if len(nz) else 0
        for ki in range(nk):
            nz = np.nonzero(layout[hh, :, ki])[0]
            idxT[hh, ki, :len(nz)] = nz
            idxT[hh, ki, len(nz):] = nz[-1] if len(nz) else 0
    return idx, counts, idxT, countsT


def kernel_block(block: int) -> bool:
    """True for the layout blocks the kernels run: the multiples of 16."""
    return block > 0 and block % 16 == 0


def _lists(walk: np.ndarray, bits: Optional[np.ndarray]):
    """(idx [H, n, J], cnt [H, n], bits [H, n, J] or None, order [n]) of
    a ``[H, n, m]`` tile-pair map: each row's nonzero columns in
    increasing order, rows ordered longest walk first."""
    h, n, _ = walk.shape
    cnt = walk.sum(-1).astype(np.int32)
    j = max(1, int(cnt.max()))
    idx = np.zeros((h, n, j), np.int32)
    out_bits = None if bits is None else np.zeros((h, n, j), np.int32)
    for hh in range(h):
        for r in range(n):
            nz = np.nonzero(walk[hh, r])[0]
            idx[hh, r, :len(nz)] = nz
            if out_bits is not None:
                out_bits[hh, r, :len(nz)] = bits[hh, r, nz]
    order = np.argsort(-cnt.max(0), kind="stable").astype(np.int32)
    return idx, cnt, out_bits, order


class TileLayout:
    """The walks of one (layout, T) at 64-row tile granularity.

    ``layout`` ``[G, nq, nk]`` bool (G = 1 when every head shares one
    layout, else one per head), ``q_walk`` = (idx, cnt, bits, order) of
    each query tile's kv tiles and ``kv_walk`` the same of each kv tile's
    query tiles; ``sub_shift`` is log2 of the kernels' sub-block (16, 32
    or 64: the block itself below 64, 64 for its multiples, 16 for any
    other multiple of 16) or None for a block the kernels do not run.  Device copies of
    the lists are made once per device (:meth:`on`)."""

    def __init__(self, layout: np.ndarray, block: int, t_len: int):
        if (layout == layout[:1]).all():
            layout = layout[:1]
        self.layout = np.ascontiguousarray(layout)
        self.block, self.t_len = block, t_len
        g, nq, nk = layout.shape
        n = self.n_tiles = -(-t_len // TILE)
        # cover[t, i]: tile t holds a row of block i
        t0 = np.arange(n)[:, None] * TILE
        b0 = np.arange(nq)[None, :] * block
        cover = ((b0 < t0 + TILE) & (b0 + block > t0)).astype(np.float32)
        walk = (cover[None] @ layout.astype(np.float32)
                @ cover.T[None]) > 0
        bits = None
        self.sub_shift = None
        if kernel_block(block):
            sub = block if block in (16, 32) or block % TILE == 0 else 16
            sub = min(sub, TILE)
            r = TILE // sub
            self.sub_shift = int(math.log2(sub))
            if sub == TILE:
                bits = walk.astype(np.int32)           # bit 0: whole pair
            else:
                # the layout at sub-block granularity (block / sub rows
                # of sub-blocks a layout block)
                m = block // sub
                fine = np.zeros((g, n * r, n * r), np.int32)
                fine[:, :nq * m, :nk * m] = layout.repeat(m, 1).repeat(m, 2)
                fine = fine.reshape(g, n, r, n, r)
                shift = (4 * np.arange(r)[:, None]
                         + np.arange(r)[None, :])       # bit 4 i + j
                bits = np.einsum("gtiuj,ij->gtu", fine,
                                 (1 << shift).astype(np.int32))
        self.q_walk = _lists(walk, bits)
        self.kv_walk = _lists(walk.transpose(0, 2, 1),
                              None if bits is None
                              else bits.transpose(0, 2, 1))
        self._dev: Dict[torch.device, tuple] = {}

    def on(self, device: torch.device):
        """(layout bool tensor, q-walk tensors, kv-walk tensors) on
        ``device``, copied there once."""
        got = self._dev.get(device)
        if got is None:
            def put(lists):
                return tuple(None if a is None else
                             torch.from_numpy(np.ascontiguousarray(a))
                             .to(device) for a in lists)
            got = self._dev[device] = (
                torch.from_numpy(self.layout).to(device),
                put(self.q_walk), put(self.kv_walk))
        return got


_TILE_LAYOUTS: Dict[tuple, TileLayout] = {}


def tile_layout(layout_c, block: int, t_len: int) -> TileLayout:
    """The :class:`TileLayout` of a compressed layout at ``t_len``,
    cached by content (the block layout is rebuilt from idx/counts)."""
    idx, cnt, idx_t, _ = (np.asarray(a) for a in layout_c)
    nk = idx_t.shape[1]
    key = (hashlib.sha1(np.ascontiguousarray(idx).tobytes()
                        + np.ascontiguousarray(cnt).tobytes()).hexdigest(),
           idx.shape, nk, block, t_len)
    tl = _TILE_LAYOUTS.get(key)
    if tl is None:
        h, nq, _ = idx.shape
        if nq * block != t_len or nk * block != t_len:
            raise ValueError(
                f"layout of {nq} x {nk} blocks of {block} does not cover "
                f"T = {t_len}")
        layout = np.zeros((h, nq, nk), bool)
        for hh in range(h):
            for qi in range(nq):
                layout[hh, qi, idx[hh, qi, :cnt[hh, qi]]] = True
        tl = _TILE_LAYOUTS[key] = TileLayout(layout, block, t_len)
    return tl


def _check(what: str, q, k, v, block: int, nheads: int, *others) -> None:
    """q, k, v (and o, dO) ``[B*H, T, D]`` on one device in one dtype,
    B*H a multiple of ``nheads``, T a multiple of ``block``."""
    if (q.dim() != 3 or k.shape != q.shape or v.shape != q.shape
            or any(t.shape != q.shape for t in others)):
        raise ValueError(f"{what}: q, k, v (and o, dO) must share one "
                         f"[B*H, T, D] shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}"
                         + "".join(f", {tuple(t.shape)}" for t in others))
    for t in (k, v) + others:
        if t.dtype != q.dtype:
            raise TypeError(f"{what}: dtypes differ ({q.dtype}, {t.dtype})")
        if t.device != q.device:
            raise ValueError(f"{what}: operands on different devices")
    if nheads < 1 or q.shape[0] % nheads:
        raise ValueError(f"{what}: B*H {q.shape[0]} is not a multiple of "
                         f"nheads {nheads}")
    if q.shape[1] % block:
        raise ValueError(f"seq lengths ({q.shape[1]}, {k.shape[1]}) must "
                         f"divide by the sparsity block ({block})")


def _resolve(what, q, k, v, layout_c, block, nheads, *others) -> TileLayout:
    _check(what, q, k, v, block, nheads, *others)
    heads = np.shape(layout_c[0])[0]
    if heads not in (1, nheads):
        raise ValueError(f"{what}: layout heads {heads} != nheads {nheads}")
    return tile_layout(layout_c, block, q.shape[1])


# -- plain versions -----------------------------------------------------------
def _heads(x: torch.Tensor, g: int) -> torch.Tensor:
    """``[B*H, ...]`` viewed as ``[B*H / g, g, ...]``: head row b is
    ``[b // g, b % g]``, so ``[:, h]`` holds the rows of layout head h."""
    return x.view(x.shape[0] // g, g, *x.shape[1:])


def _pair_keep(lay: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
               block: int, causal: bool) -> torch.Tensor:
    """``[len(rows), len(cols)]`` bool: the layout bit of each (row, col)
    pair, and row >= col when causal."""
    keep = lay[rows // block][:, cols // block]
    if causal:
        keep = keep & (rows[:, None] >= cols[None, :])
    return keep


def _tile_rows(tiles: torch.Tensor, t_len: int) -> torch.Tensor:
    """The sequence rows of a list of 64-row tiles (rows past T
    dropped)."""
    rows = (tiles[:, None] * TILE
            + torch.arange(TILE, device=tiles.device)[None]).flatten()
    return rows[rows < t_len]


def _walks(tl: TileLayout, device, kv_side: bool):
    """Yield (layout head, tile rows, the rows the tile walks to) over
    every tile of every layout head."""
    lay, qw, kw = tl.on(device)
    idx, cnt = (kw if kv_side else qw)[:2]
    cnt_h = (tl.kv_walk if kv_side else tl.q_walk)[1]
    for h in range(lay.shape[0]):
        for t in range(tl.n_tiles):
            own = _tile_rows(torch.tensor([t], device=device), tl.t_len)
            other = _tile_rows(idx[h, t, :int(cnt_h[h, t])].long(),
                               tl.t_len)
            yield h, lay[h], own, other


def blocksparse_attention_fwd_plain(q, k, v, layout_c, block: int,
                                    nheads: int, causal: bool = True,
                                    sm_scale: Optional[float] = None
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of B8: ``(o, lse)`` in float32 at the kernel's
    rounding points, one query tile at a time."""
    tl = _resolve("blocksparse_attention_fwd_plain", q, k, v, layout_c,
                  block, nheads)
    scale = FA._scale(q.shape[-1], sm_scale)
    g = tl.layout.shape[0]
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.zeros(q.shape[:2], dtype=torch.float32, device=q.device)
    q4, k4, v4, o4, l4 = (_heads(x, g) for x in (q, k, v, o, lse))
    for h, lay, rows, cols in _walks(tl, q.device, kv_side=False):
        s = torch.matmul(q4[:, h, rows].float(),
                         k4[:, h, cols].float().transpose(1, 2)) * scale
        s = s.masked_fill(~_pair_keep(lay, rows, cols, block, causal),
                          MASK_VALUE)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        o4[:, h, rows] = torch.matmul(p.to(v.dtype).float(),
                                      v4[:, h, cols].float()) / l
        l4[:, h, rows] = (m + torch.log(l))[..., 0]
    return o.to(q.dtype), lse


def _probs(q4, k4, lse4, h, rows, cols, lay, block, causal, scale):
    """f32 ``p = exp(q k^T * scale - lse)`` of the (rows, cols) pairs of
    layout head h, 0 outside the layout."""
    s = torch.matmul(q4[:, h, rows].float(),
                     k4[:, h, cols].float().transpose(1, 2)) * scale
    s = s.masked_fill(~_pair_keep(lay, rows, cols, block, causal),
                      MASK_VALUE)
    return torch.exp(s - lse4[:, h, rows][..., None])


def _dscores(p, do4, v4, delta4, h, rows, cols, scale, dtype):
    """f32 ``ds = p * (dO v^T - delta) * scale`` rounded to ``dtype``."""
    dp = torch.matmul(do4[:, h, rows].float(),
                      v4[:, h, cols].float().transpose(1, 2))
    return (p * (dp - delta4[:, h, rows][..., None]) * scale).to(
        dtype).float()


def blocksparse_attention_bwd_dq_plain(q, k, v, o, lse, do, layout_c,
                                       block: int, nheads: int,
                                       causal: bool = True,
                                       sm_scale: Optional[float] = None
                                       ) -> torch.Tensor:
    """Plain version of B9: ``dq`` in float32 at the kernel's rounding
    points (ds rounded to k's dtype), one query tile at a time."""
    tl = _resolve("blocksparse_attention_bwd_dq_plain", q, k, v, layout_c,
                  block, nheads, o, do)
    scale = FA._scale(q.shape[-1], sm_scale)
    g = tl.layout.shape[0]
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    q4, k4, v4, do4, dq4 = (_heads(x, g) for x in (q, k, v, do, dq))
    lse4, delta4 = _heads(lse, g), _heads(FA._delta(o, do), g)
    for h, lay, rows, cols in _walks(tl, q.device, kv_side=False):
        p = _probs(q4, k4, lse4, h, rows, cols, lay, block, causal, scale)
        ds = _dscores(p, do4, v4, delta4, h, rows, cols, scale, k.dtype)
        dq4[:, h, rows] = torch.matmul(ds, k4[:, h, cols].float())
    return dq.to(q.dtype)


def blocksparse_attention_bwd_dkv_plain(q, k, v, o, lse, do, layout_c,
                                        block: int, nheads: int,
                                        causal: bool = True,
                                        sm_scale: Optional[float] = None
                                        ) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Plain version of B10: ``(dk, dv)`` in float32 at the kernel's
    rounding points (p rounded to dO's dtype before dV, ds to q's before
    dK), one kv tile at a time."""
    tl = _resolve("blocksparse_attention_bwd_dkv_plain", q, k, v, layout_c,
                  block, nheads, o, do)
    scale = FA._scale(q.shape[-1], sm_scale)
    g = tl.layout.shape[0]
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    q4, k4, v4, do4, dk4, dv4 = (_heads(x, g)
                                 for x in (q, k, v, do, dk, dv))
    lse4, delta4 = _heads(lse, g), _heads(FA._delta(o, do), g)
    for h, lay, cols, rows in _walks(tl, q.device, kv_side=True):
        if not len(rows):
            continue
        p = _probs(q4, k4, lse4, h, rows, cols, lay, block, causal, scale)
        ds = _dscores(p, do4, v4, delta4, h, rows, cols, scale, q.dtype)
        dv4[:, h, cols] = torch.matmul(p.to(do.dtype).float().transpose(1, 2),
                                       do4[:, h, rows].float())
        dk4[:, h, cols] = torch.matmul(ds.transpose(1, 2),
                                       q4[:, h, rows].float())
    return dk.to(k.dtype), dv.to(v.dtype)


# -- kernels -------------------------------------------------------------------
def _kernel_checks(what: str, tl: TileLayout, tensors) -> None:
    if tl.sub_shift is None:
        raise ValueError(f"{what} kernel: layout block {tl.block} is not a "
                         f"multiple of 16")
    FA._check_kernel(what, tensors)


def blocksparse_attention_fwd(q, k, v, layout_c, block: int, nheads: int,
                              causal: bool = True,
                              sm_scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B8 on CUDA tensors, the plain version on CPU tensors:
    ``(o [B*H, T, D], lse [B*H, T] float32)``."""
    if q.device.type == "cpu":
        return blocksparse_attention_fwd_plain(q, k, v, layout_c, block,
                                               nheads, causal, sm_scale)
    tl = _resolve(_FWD, q, k, v, layout_c, block, nheads)
    _kernel_checks(_FWD, tl, (("q", q), ("k", k), ("v", v)))
    bh, t_len, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, t_len), dtype=torch.float32, device=q.device)
    walk = tl.on(q.device)[1]
    FA._launch(_FWD, _FWD_SYM, q, (q, k, v, o, lse) + walk,
               (bh, tl.layout.shape[0], t_len, walk[0].shape[-1], d,
                tl.sub_shift),
               sm_scale, causal)
    return o, lse


def _bwd_inputs(what, q, k, v, o, lse, do, layout_c, block, nheads, delta):
    tl = _resolve(what, q, k, v, layout_c, block, nheads, o, do)
    _kernel_checks(what, tl, (("q", q), ("k", k), ("v", v), ("o", o),
                              ("do", do)))
    FA._check_rows(what, "lse", lse, q)
    if delta is None:
        delta = FA._delta(o, do)
    FA._check_rows(what, "delta", delta, q)
    return tl, delta


def blocksparse_attention_bwd_dq(q, k, v, o, lse, do, layout_c, block: int,
                                 nheads: int, causal: bool = True,
                                 sm_scale: Optional[float] = None,
                                 delta: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """Kernel B9 on CUDA tensors, the plain version on CPU tensors:
    ``dq [B*H, T, D]``.  ``delta = rowsum(dO * O)`` is computed here when
    not given."""
    if q.device.type == "cpu":
        return blocksparse_attention_bwd_dq_plain(
            q, k, v, o, lse, do, layout_c, block, nheads, causal, sm_scale)
    tl, delta = _bwd_inputs(_DQ, q, k, v, o, lse, do, layout_c, block,
                            nheads, delta)
    bh, t_len, d = q.shape
    dq = torch.empty_like(q)
    walk = tl.on(q.device)[1]
    FA._launch(_DQ, _DQ_SYM, q, (q, k, v, do, lse, delta, dq) + walk,
               (bh, tl.layout.shape[0], t_len, walk[0].shape[-1], d,
                tl.sub_shift),
               sm_scale, causal)
    return dq


def blocksparse_attention_bwd_dkv(q, k, v, o, lse, do, layout_c, block: int,
                                  nheads: int, causal: bool = True,
                                  sm_scale: Optional[float] = None,
                                  delta: Optional[torch.Tensor] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B10 on CUDA tensors, the plain version on CPU tensors:
    ``(dk, dv)``, each row written once by the block of its kv tile."""
    if q.device.type == "cpu":
        return blocksparse_attention_bwd_dkv_plain(
            q, k, v, o, lse, do, layout_c, block, nheads, causal, sm_scale)
    tl, delta = _bwd_inputs(_DKV, q, k, v, o, lse, do, layout_c, block,
                            nheads, delta)
    bh, t_len, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    walk = tl.on(q.device)[2]
    FA._launch(_DKV, _DKV_SYM, q, (q, k, v, do, lse, delta, dk, dv) + walk,
               (bh, tl.layout.shape[0], t_len, walk[0].shape[-1], d,
                tl.sub_shift),
               sm_scale, causal)
    return dk, dv


# -- public API ------------------------------------------------------------------
class _BlockSparseAttention(torch.autograd.Function):
    """B8 forward; B9 then B10 backward; saves q, k, v, o and lse."""

    @staticmethod
    def forward(ctx, q, k, v, layout_c, block, nheads, causal, sm_scale):
        o, lse = blocksparse_attention_fwd(q, k, v, layout_c, block, nheads,
                                           causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (layout_c, block, nheads, causal, sm_scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = FA._delta(o, do)
        dq = blocksparse_attention_bwd_dq(q, k, v, o, lse, do, *ctx.args,
                                          delta=delta)
        dk, dv = blocksparse_attention_bwd_dkv(q, k, v, o, lse, do,
                                               *ctx.args, delta=delta)
        return dq, dk, dv, None, None, None, None, None


def blocksparse_attention(q, k, v, layout_c, block: int, nheads: int,
                          causal: bool = True,
                          sm_scale: Optional[float] = None) -> torch.Tensor:
    """q, k, v ``[B*H, T, D]`` → ``[B*H, T, D]``, differentiable;
    ``layout_c`` = :func:`compress_layout` of the ``[H, T/block,
    T/block]`` block layout."""
    return _BlockSparseAttention.apply(q.contiguous(), k.contiguous(),
                                       v.contiguous(), layout_c, block,
                                       nheads, bool(causal), sm_scale)


_LAYOUTS: Dict[tuple, tuple] = {}


def bthd_layout(sparsity_config, heads: int, t_len: int, causal: bool):
    """The compressed ``[heads, T/block, T/block]`` layout of a
    SparsityConfig at ``t_len``, above-diagonal blocks pruned when
    causal; built once per (config content, heads, T, causal)."""
    # content key (config class + params + heads + seq + causal): id()
    # reuse after GC must never serve a stale layout, and a hit must not
    # skip the head-count validation
    key = (type(sparsity_config).__name__,
           tuple(sorted((k_, repr(v_)) for k_, v_ in
                        vars(sparsity_config).items())), heads, t_len, causal)
    if key not in _LAYOUTS:
        layout = np.asarray(sparsity_config.make_layout(t_len))
        if layout.ndim == 2:            # shared across heads
            layout = np.broadcast_to(layout[None], (heads,) + layout.shape)
        elif layout.shape[0] == 1 and heads > 1:
            layout = np.broadcast_to(layout, (heads,) + layout.shape[1:])
        elif layout.shape[0] != heads:
            raise ValueError(f"layout heads {layout.shape[0]} != {heads}")
        layout = layout.astype(bool)
        if causal:
            # prune above-diagonal blocks host-side: the kernels would
            # mask them entirely anyway, and pruning keeps the walks
            # nnz-proportional for bidirectional layouts like BigBird's
            # global rows
            nb = layout.shape[1]
            layout = layout & (np.arange(nb)[:, None] >=
                               np.arange(nb)[None, :])
        _LAYOUTS[key] = compress_layout(layout)
    return _LAYOUTS[key]


def blocksparse_attention_bthd(q, k, v, sparsity_config, causal: bool = True,
                               sm_scale: Optional[float] = None
                               ) -> torch.Tensor:
    """Model-layout adapter: q, k, v ``[B, T, H, D]`` → ``[B, T, H, D]``;
    ``sparsity_config`` a :class:`SparsityConfig` whose layout for (config,
    T) is built on the host once and cached."""
    b, t, h, d = q.shape
    layout_c = bthd_layout(sparsity_config, h, t, causal)

    def pack(x):
        return x.transpose(1, 2).reshape(b * h, t, d)
    o = blocksparse_attention(pack(q), pack(k), pack(v), layout_c,
                              sparsity_config.block, h, causal, sm_scale)
    return o.reshape(b, h, t, d).transpose(1, 2)
