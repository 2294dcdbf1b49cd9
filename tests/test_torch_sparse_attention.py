"""The port's block-sparse attention against the JAX package's.

Layouts of every sparsity family and their compressed index lists must be
equal (exact).  ``blocksparse_attention`` (forward and VJP) and
``blocksparse_attention_bthd`` run the port's plain versions of kernels
B8, B9 and B10 on CPU tensors against the JAX Pallas kernels in interpret
mode, on the same numpy-seeded float32 inputs, within 1e-5 (the same
math; only the order of the sums differs).  ``SparseSelfAttention`` is
plain on both sides: its routing decisions must be equal and both routes'
outputs within 1e-5 of JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import sparse_attention as JS
from deepspeed_tpu.ops.sparse_attention import blocksparse_flash as JB
from deepspeed_tpu_torch.ops import sparse_attention as PS
from deepspeed_tpu_torch.ops.sparse_attention import blocksparse_flash as PB

TOL = dict(atol=1e-5, rtol=1e-5)

#: (class name, constructor arguments) of each family, at the JAX
#: defaults and at settings the JAX tests and benchmarks use
FAMILIES = [
    ("DenseSparsityConfig", dict(block=16)),
    ("FixedSparsityConfig", dict()),
    ("FixedSparsityConfig", dict(block=16, num_local_blocks=2,
                                 num_global_blocks=1,
                                 attention="bidirectional")),
    ("LocalSlidingWindowSparsityConfig", dict(block=16,
                                              num_sliding_window_blocks=2)),
    ("LocalSlidingWindowSparsityConfig", dict(block=512,
                                              num_sliding_window_blocks=3)),
    ("BigBirdSparsityConfig", dict(block=16, num_random_blocks=2, seed=5)),
    ("BigBirdSparsityConfig", dict(block=32, attention="unidirectional")),
    ("BSLongformerSparsityConfig", dict(block=16,
                                        global_block_indices=(0, 3))),
    ("VariableSparsityConfig", dict(block=16, local_window_blocks=(1, 2, 3),
                                    global_block_indices=(2,))),
]


def configs(name, kw, heads=2):
    return (getattr(JS, name)(num_heads=heads, **kw),
            getattr(PS, name)(num_heads=heads, **kw))


@pytest.mark.parametrize("name,kw", FAMILIES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(FAMILIES)])
def test_layouts_and_compressed_lists_equal_jax(name, kw):
    """make_layout at three lengths, and compress_layout of the causal
    and the full layout, equal to JAX's bit for bit; a length that the
    block does not divide raises the same error."""
    jc, pc = configs(name, kw)
    blk = kw.get("block", 64)
    for n in (1, 7, 32):
        want, got = jc.make_layout(n * blk), pc.make_layout(n * blk)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        for lay in (want, want & np.tril(np.ones_like(want))):
            lay = np.broadcast_to(lay, (2,) + lay.shape)
            for a, b in zip(PB.compress_layout(lay), JB.compress_layout(lay)):
                assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError, match="not divisible") as pe:
        pc.make_layout(blk + 1)
    with pytest.raises(ValueError) as je:
        jc.make_layout(blk + 1)
    assert str(pe.value) == str(je.value)


def random_layout(rng, heads, nb, causal, per_head):
    lay = rng.random((heads if per_head else 1, nb, nb)) < 0.35
    lay[:, np.arange(nb), np.arange(nb)] = True
    lay = np.broadcast_to(lay, (heads, nb, nb))
    if causal:
        lay = lay & np.tril(np.ones((nb, nb), bool))
    return lay


@pytest.mark.parametrize("block,t_len,d,causal,per_head", [
    (16, 256, 64, False, True), (32, 256, 16, True, True),
    (64, 256, 16, True, False), (128, 256, 16, False, True),
    (16, 112, 16, True, True)])
def test_blocksparse_attention_and_vjp_match_jax(block, t_len, d, causal,
                                                 per_head):
    """Output and dq, dk, dv of ``blocksparse_attention`` (B8, then B9
    and B10 in the backward) on a random layout, per-head or shared,
    causal or not; blocks of 16 and 32 share the port's 64-row tiles,
    128 spans two of them, and T 112 ends inside a tile."""
    rng = np.random.default_rng(block + t_len + d)
    heads, b = 2, 2
    lay = random_layout(rng, heads, t_len // block, causal, per_head)
    q, k, v, do = (rng.standard_normal((b * heads, t_len, d))
                   .astype(np.float32) for _ in range(4))

    def f(q_, k_, v_):
        return JB.blocksparse_attention(q_, k_, v_, JB.compress_layout(lay),
                                        block, heads, causal, None, True)
    o_j, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    grads_j = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    o_p = PB.blocksparse_attention(tq, tk, tv, PB.compress_layout(lay), block,
                                   heads, causal)
    o_p.backward(torch.from_numpy(do))
    np.testing.assert_allclose(o_p.detach().numpy(), np.asarray(o_j), **TOL)
    for got, want in zip((tq.grad, tk.grad, tv.grad), grads_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name,kw", [f for f in FAMILIES
                                     if f[1].get("block", 64) <= 32])
def test_bthd_matches_jax_for_each_family(name, kw):
    """``blocksparse_attention_bthd`` ([B, T, H, D], the layout built from
    the config and pruned above the diagonal) at T 128."""
    jc, pc = configs(name, kw)
    rng = np.random.default_rng(len(name))
    q, k, v = (rng.standard_normal((2, 128, 2, 16)).astype(np.float32)
               for _ in range(3))
    want = JB.blocksparse_attention_bthd(*(jnp.asarray(x) for x in (q, k, v)),
                                         jc, interpret=True)
    got = PB.blocksparse_attention_bthd(*(torch.from_numpy(x)
                                          for x in (q, k, v)), pc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_empty_row_and_non_dividing_t_raise_as_in_jax():
    lay = np.tril(np.ones((2, 4, 4), bool))
    lay[1, 2] = False
    with pytest.raises(ValueError, match="empty q-block row"):
        PB.compress_layout(lay)
    with pytest.raises(ValueError, match="empty q-block row"):
        JB.compress_layout(lay)
    lc = PB.compress_layout(np.tril(np.ones((2, 4, 4), bool)))
    x = torch.zeros((4, 120, 16))
    with pytest.raises(ValueError, match="must divide by the sparsity "
                                         r"block \(32\)"):
        PB.blocksparse_attention(x, x, x, lc, 32, 2)
    with pytest.raises(ValueError, match="must divide by the sparsity "
                                         r"block \(32\)"):
        JB.blocksparse_attention(jnp.zeros((4, 120, 16)),
                                 jnp.zeros((4, 120, 16)),
                                 jnp.zeros((4, 120, 16)),
                                 JB.compress_layout(np.tril(np.ones(
                                     (2, 4, 4), bool))), 32, 2, True, None,
                                 True)


def test_kernel_wrappers_refuse_what_the_kernels_do_not_run():
    """Blocks that are not a multiple of 16 run only in the plain version:
    the wrappers' kernel checks name the block (the checks a CUDA tensor
    meets before any launch)."""
    tl = PB.tile_layout(PB.compress_layout(np.ones((1, 4, 4), bool)), 8, 32)
    assert tl.sub_shift is None
    with pytest.raises(ValueError, match="block 8"):
        PB._kernel_checks("blocksparse_flash_fwd", tl, ())
    for blk, shift in ((16, 4), (32, 5), (64, 6), (192, 6)):
        assert PB.tile_layout(PB.compress_layout(np.ones((1, 2, 2), bool)),
                              blk, 2 * blk).sub_shift == shift


#: the sub-block mask of a tile pair whose sub-blocks are all set, by
#: sub_shift (``TileList::full`` in csrc/blocksparse_bwd_mma.cuh)
FULL_SUB_BITS = {6: 0x1, 5: 0x33, 4: 0xFFFF}


def pair_needs_mask(bits, sub_shift, qt, kt, t_len, causal):
    """The tensor-core B9/B10's rule (``blocksparse_bwd_mma.cuh``): a walked
    tile pair is masked element by element when it is the causal
    diagonal, holds rows at or past T, or its sub-block mask is not
    full; every element of any other pair is kept."""
    ragged = (qt + 1) * PB.TILE > t_len or (kt + 1) * PB.TILE > t_len
    return ((causal and kt == qt) or ragged
            or bits != FULL_SUB_BITS[sub_shift])


@pytest.mark.parametrize("block,t_len,causal", [
    (16, 256, True), (16, 208, False), (32, 256, True), (32, 224, False),
    (64, 320, True), (128, 384, False), (128, 512, True)])
def test_tile_walks_cover_the_layout(block, t_len, causal):
    """The 64-row tile walks: a layout of 16- or 32-row blocks folds into
    4 x 4 or 2 x 2 sub-block bits per tile pair (bit 4 i + j), a block of
    64 rows or more spans whole pairs (bit 0); the transposed walk lists
    every pair of the forward walk once, with the same query-major bits;
    no visible element lies outside the walk.  On each walked pair the
    kernels' mask rule (``pair_needs_mask``) is false exactly where every
    element is visible in the expanded layout (T ragged against the tile
    included); a causal pair past the diagonal, which the kernels leave
    out, holds no visible element."""
    rng = np.random.default_rng(0)
    nb, tile = t_len // block, PB.TILE
    lay = random_layout(rng, 3, nb, causal, True).copy()
    if block < tile:     # tile pair (1, 0) whole: a pair that needs no mask
        lay[:, tile // block:2 * tile // block, :tile // block] = True
    tl = PB.tile_layout(PB.compress_layout(lay), block, t_len)
    n = tl.n_tiles
    idx, cnt, bits, _ = tl.q_walk
    idx_t, cnt_t, bits_t, _ = tl.kv_walk
    pairs, pairs_t = {}, {}
    for h in range(3):
        for t in range(n):
            for j in range(cnt[h, t]):
                pairs[h, t, idx[h, t, j]] = bits[h, t, j]
            for j in range(cnt_t[h, t]):
                pairs_t[h, idx_t[h, t, j], t] = bits_t[h, t, j]
    assert pairs == pairs_t
    sub = min(block, tile)
    r = tile // sub
    assert tl.sub_shift == int(np.log2(sub))
    fine = np.zeros((3, n * r, n * r), bool)
    if block < tile:
        fine[:, :nb, :nb] = lay
    visible = np.zeros((3, n * tile, n * tile), bool)
    visible[:, :t_len, :t_len] = lay.repeat(block, 1).repeat(block, 2)
    if causal:
        visible &= np.tril(np.ones((n * tile, n * tile), bool))
    masked = []
    for h in range(3):
        for qt in range(n):
            for kt in range(n):
                if block < tile:
                    want = sum(1 << (4 * i + j) for i in range(r)
                               for j in range(r)
                               if fine[h, qt * r + i, kt * r + j])
                else:
                    m = block // tile
                    want = int(lay[h, qt // m, kt // m])
                assert pairs.get((h, qt, kt), 0) == want
                seen = visible[h, qt * tile:(qt + 1) * tile,
                               kt * tile:(kt + 1) * tile]
                if (h, qt, kt) not in pairs or (causal and kt > qt):
                    assert not seen.any()
                    continue
                masked.append(pair_needs_mask(want, tl.sub_shift, qt, kt,
                                              t_len, causal))
                assert masked[-1] == (not seen.all())
    assert not all(masked)       # the rule's "keep all" side is tested


SELF_ATTN = [
    ("DenseSparsityConfig", dict(block=16), 64, {}),
    ("LocalSlidingWindowSparsityConfig",
     dict(block=8, num_sliding_window_blocks=1), 64, {}),
    ("LocalSlidingWindowSparsityConfig",
     dict(block=8, num_sliding_window_blocks=2), 64,
     dict(dense_route_density=1.1, dense_route_min_tokens=0)),
    ("FixedSparsityConfig", dict(block=16, num_local_blocks=2), 128, {}),
    ("BigBirdSparsityConfig", dict(block=16), 128,
     dict(dense_route_density=1.1, dense_route_min_tokens=0)),
    ("LocalSlidingWindowSparsityConfig",
     dict(block=512, num_sliding_window_blocks=3), 8192, None),
]


@pytest.mark.parametrize("name,kw,seq,route", SELF_ATTN)
def test_sparse_self_attention_matches_jax(name, kw, seq, route):
    """``mask_kind``, ``density`` and ``routes_dense`` equal JAX's (the
    8k sliding window stays on the gathered-block route without building
    a [T, T] mask); the output of whichever route the layout takes
    matches JAX's at T = seq."""
    jc, pc = configs(name, kw)
    ja = JS.SparseSelfAttention(jc, seq, **(route or {}))
    pa = PS.SparseSelfAttention(pc, seq, **(route or {}))
    assert pa.mask_kind == ja.mask_kind and pa.density() == ja.density()
    for t in (seq // 2, seq, 4 * seq):
        assert pa.routes_dense(t) == ja.routes_dense(t)
    if route is None:
        assert not pa.routes_dense(seq) and pa._dense_mask is None
        return
    rng = np.random.default_rng(seq)
    q, k, v = (rng.standard_normal((2, seq, 2, 16)).astype(np.float32)
               for _ in range(3))
    want = ja(*(jnp.asarray(x) for x in (q, k, v)))
    got = pa(*(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_sparse_self_attention_routes_agree():
    """The route changes the algorithm, not the answer: one layout forced
    down both routes gives the same output, and the dense route is
    differentiable."""
    cfg = PS.LocalSlidingWindowSparsityConfig(
        num_heads=2, block=8, num_sliding_window_blocks=2,
        attention="unidirectional")
    dense = PS.SparseSelfAttention(cfg, 64)
    sparse = PS.SparseSelfAttention(cfg, 64, dense_route_density=1.1,
                                    dense_route_min_tokens=0)
    assert dense.routes_dense(64) and not sparse.routes_dense(64)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 64, 2, 16), generator=g) for _ in range(3))
    torch.testing.assert_close(dense(q, k, v), sparse(q, k, v), **TOL)
    q.requires_grad_(True)
    (dense(q, k, v) ** 2).sum().backward()
    assert bool(q.grad.isfinite().all())


@pytest.mark.parametrize("block,t_len,d,causal", [
    (48, 144, 80, True), (48, 192, 96, False), (16, 96, 80, True),
    (80, 160, 16, False)])
def test_head_dims_and_blocks_of_the_reference_match_jax(block, t_len, d,
                                                          causal):
    """B8-B10's plain versions at the head dims GPT-3 2.7B (80) and 760M
    (96) run and at layout blocks that are multiples of 16 but neither
    16, 32 nor a multiple of 64 (48, 80: the port's 64-row tile pairs hold
    the layout in 16-row sub-blocks), against the JAX kernels in
    interpret mode: output and dq, dk, dv within 1e-5."""
    rng = np.random.default_rng(block + t_len + d)
    heads, b = 2, 1
    lay = random_layout(rng, heads, t_len // block, causal, True)
    q, k, v, do = (rng.standard_normal((b * heads, t_len, d))
                   .astype(np.float32) for _ in range(4))

    def f(q_, k_, v_):
        return JB.blocksparse_attention(q_, k_, v_, JB.compress_layout(lay),
                                        block, heads, causal, None, True)
    o_j, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    grads_j = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    o_p = PB.blocksparse_attention(tq, tk, tv, PB.compress_layout(lay), block,
                                   heads, causal)
    o_p.backward(torch.from_numpy(do))
    np.testing.assert_allclose(o_p.detach().numpy(), np.asarray(o_j), **TOL)
    for got, want in zip((tq.grad, tk.grad, tv.grad), grads_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    tl = PB.tile_layout(PB.compress_layout(lay), block, t_len)
    assert tl.sub_shift == (4 if block % 64 and block not in (16, 32) else
                            {16: 4, 32: 5}.get(block, 6))


#: float16 against float16: both sides round p and ds to f16 at the same
#: points and sum in f32, so they differ by about one f16 ulp (two as the
#: limit, as ``test_torch_fp16.py`` holds the f16 B1-B4)
F16_TOL = dict(atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("block,t_len,d,causal,per_head", [
    (16, 256, 64, False, True), (32, 256, 16, True, True),
    (64, 192, 80, True, False)])
def test_f16_blocksparse_attention_and_vjp_match_jax(block, t_len, d,
                                                     causal, per_head):
    """The float16 plain versions of B8 (output) and B9/B10 (dq, dk, dv)
    through ``blocksparse_attention`` against the JAX kernels in interpret
    mode on the same float16 inputs; float16 out."""
    rng = np.random.default_rng(300 + block + t_len + d)
    heads, b = 2, 2
    lay = random_layout(rng, heads, t_len // block, causal, per_head)
    q, k, v, do = (rng.standard_normal((b * heads, t_len, d))
                   .astype(np.float16) for _ in range(4))

    def f(q_, k_, v_):
        return JB.blocksparse_attention(q_, k_, v_, JB.compress_layout(lay),
                                        block, heads, causal, None, True)
    o_j, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    grads_j = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    o_p = PB.blocksparse_attention(tq, tk, tv, PB.compress_layout(lay), block,
                                   heads, causal)
    o_p.backward(torch.from_numpy(do))
    assert o_p.dtype == torch.float16 and tq.grad.dtype == torch.float16
    np.testing.assert_allclose(o_p.detach().float().numpy(),
                               np.asarray(o_j, np.float32), **F16_TOL)
    for got, want in zip((tq.grad, tk.grad, tv.grad), grads_j):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **F16_TOL)
