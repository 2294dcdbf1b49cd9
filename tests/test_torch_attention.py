"""The port's attention kernels (B5, B6, B7; B6 and B7 also over int8 and
packed-int4 pools) against the JAX package's Pallas kernels.

On the CPU each port wrapper runs its plain PyTorch version (the tensors
lie on the CPU); the JAX kernels run in interpret mode, as the JAX
package's own serving suite runs them.  Inputs are made with numpy from a
seed and handed to both; float32 throughout, compared at atol = rtol =
1e-5 (both sides accumulate in f32; only the summation order differs),
quantized pools at 3e-5 as the JAX package's own sweep holds its
kernels against its references.
The CUDA kernels themselves are held against these plain versions on
the card by ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.quantizer import kv_quantize as jax_kv_quantize
from deepspeed_tpu.ops.transformer.decode_attention import (
    decode_attention as jax_decode)
from deepspeed_tpu.ops.transformer.paged_decode_attention import (
    paged_decode_attention as jax_paged_decode,
    paged_prefill_attention as jax_paged_prefill)
from deepspeed_tpu_torch.ops.transformer import decode_attention as DA
from deepspeed_tpu_torch.ops.transformer import paged_decode_attention as PA

TOL = dict(atol=1e-5, rtol=1e-5)
QTOL = dict(atol=3e-5, rtol=0)


def _np(x):
    return np.asarray(x)


# -- B5: dense decode ---------------------------------------------------------
#: (S, length, Hkv) under H 4: the JAX kernel's contract (Hkv = H, the
#: original ids) and the port's kv-head width (Hkv 2 and 1)
DECODE_CASES = [(24, 24, 4), (24, 13, 4), (40, 1, 4), (24, 0, 4),
                (24, 24, 2), (24, 13, 2), (40, 1, 1), (24, 0, 2),
                (24, 17, 1)]


@pytest.mark.parametrize("s,length,hkv", DECODE_CASES, ids=[
    f"{s}-{n}" if hkv == 4 else f"{s}-{n}-kv{hkv}"
    for s, n, hkv in DECODE_CASES])
def test_decode_attention_matches_jax(s, length, hkv):
    """Full, ragged and empty valid lengths; rows past the length hold
    NaN, which must not reach either result.  With Hkv < H the port reads
    the cache at kv-head width (query head h reads kv head h // (H /
    Hkv)); JAX's kernel takes one kv head per query head, so it gets the
    cache expanded over the group, as the JAX model's ``expand_kv``
    gives it."""
    rng = np.random.default_rng(s + length + 100 * (hkv != 4) + hkv)
    b, h, d = 2, 4, 16
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    k[:, length:] = np.nan
    v[:, length:] = np.nan
    ke, ve = (np.repeat(x, h // hkv, axis=2) for x in (k, v))
    want = _np(jax_decode(jnp.asarray(q), jnp.asarray(ke), jnp.asarray(ve),
                          length, interpret=True))
    got = DA.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), length).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    if length == 0:
        assert (got == 0).all()


@pytest.mark.parametrize("b,hkv,length,sms,want", [
    (8, 32, 192, 132, (1, 192)),    # GPT-3 6.7B: 256 blocks fill the card
    (8, 4, 192, 132, (3, 64)),      # TinyLlama: 32 blocks, 3 splits of 64
    (8, 4, 130, 132, (3, 64)),      # ragged: the last split holds 2 rows
    (1, 4, 4000, 132, (8, 512)),    # at most one cluster of 8
    (2, 2, 0, 132, (1, 64)),        # length 0: one empty split
])
def test_cluster_plan(b, hkv, length, sms, want):
    """B5's bf16 split plan: split only until the blocks fill the card,
    at most 8 splits (one cluster), each a whole number of 64-row
    chunks that together cover the length."""
    nsplit, split_len = DA.cluster_plan(b, hkv, length, sms)
    assert (nsplit, split_len) == want
    assert (nsplit - 1) * split_len < max(length, 1) <= nsplit * split_len


@pytest.mark.parametrize("npages,blk", [(64, 16), (10, 16), (5, 8), (1, 16),
                                        (3, 64), (200, 4), (9, 128)])
def test_paged_split_plan(npages, blk):
    """B6's bf16 split plan from the table's width: at most 8 ranks (one
    cluster), splits of whole pages that cover the table and none that
    starts past it, and under the kernel's walk (rank r takes rows [r *
    split_len, min((r + 1) * split_len, length))) every row below the
    length in exactly one split, for lengths 0, 1, on a page boundary,
    on a split boundary, one past it and the table's full width."""
    nsplit, split_len = DA.paged_split_plan(npages, blk)
    width = npages * blk
    assert 1 <= nsplit <= 8
    assert split_len % blk == 0
    assert (nsplit - 1) * split_len < width <= nsplit * split_len
    for length in sorted({0, 1, blk, min(split_len, width),
                          min(split_len + 1, width), width - 1, width}):
        owners = np.zeros(length, np.int64)
        for r in range(nsplit):
            owners[r * split_len:min((r + 1) * split_len, length)] += 1
        assert (owners == 1).all(), (length, nsplit, split_len)
    if npages % 8 == 0 and width >= 8 * 64:
        assert nsplit == 8      # a wide table takes the whole cluster


# -- B6: batched paged decode -----------------------------------------------
def make_pool(nb, bs, hkv, d, rng):
    pk = rng.standard_normal((nb, bs, hkv, d)).astype(np.float32)
    pv = rng.standard_normal((nb, bs, hkv, d)).astype(np.float32)
    return pk, pv


def make_tables(lens, bs, npages, nb, rng, pk, pv):
    """Disjoint shuffled tables (block 0 reserved); every row of every
    block that no slot reads below its length is NaN garbage, and one
    NaN block sits in a table just past a slot's length."""
    avail = list(rng.permutation(np.arange(1, nb)))
    bt = np.zeros((len(lens), npages), np.int32)
    read = np.zeros((nb, bs), bool)
    for i, n in enumerate(lens):
        for p in range(-(-n // bs)):
            bt[i, p] = avail.pop()
            read[bt[i, p], :min(bs, n - p * bs)] = True
    if any(-(-n // bs) < npages for n in lens):
        i = next(i for i, n in enumerate(lens) if -(-n // bs) < npages)
        bt[i, -(-lens[i] // bs)] = avail.pop()
    pk[~read] = np.nan
    pv[~read] = np.nan
    return bt


@pytest.mark.parametrize("h,hkv", [(4, 4), (4, 2)])
def test_paged_decode_matches_jax(h, hkv):
    """Ragged lengths, two inactive slots, NaN in every unread pool row
    (unfetched pages, tails of partial pages, a NaN block in a table),
    MHA and GQA (H=4, Hkv=2)."""
    rng = np.random.default_rng(h * 10 + hkv)
    lens = [5, 0, 17, 32, 0, 9]
    bs, nb, npages, d = 8, 24, 5, 16
    pk, pv = make_pool(nb, bs, hkv, d, rng)
    bt = make_tables(lens, bs, npages, nb, rng, pk, pv)
    q = rng.standard_normal((len(lens), h, d)).astype(np.float32)
    ln = np.asarray(lens, np.int32)
    want = _np(jax_paged_decode(jnp.asarray(q), jnp.asarray(pk),
                                jnp.asarray(pv), jnp.asarray(ln),
                                jnp.asarray(bt), interpret=True))
    got = PA.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(pk), torch.from_numpy(pv),
        torch.from_numpy(ln), torch.from_numpy(bt)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    assert (got[1] == 0).all() and (got[4] == 0).all()


@pytest.mark.parametrize("h,hkv", [(4, 4), (8, 2)])
def test_paged_decode_full_width_matches_jax(h, hkv):
    """One slot over its table's full width (every rank of the kernel's
    split plan has rows) beside an inactive slot and a one-row slot."""
    rng = np.random.default_rng(7 * h + hkv)
    lens = [48, 0, 1]
    bs, nb, npages, d = 8, 24, 6, 16
    pk, pv = make_pool(nb, bs, hkv, d, rng)
    bt = make_tables(lens, bs, npages, nb, rng, pk, pv)
    q = rng.standard_normal((len(lens), h, d)).astype(np.float32)
    ln = np.asarray(lens, np.int32)
    want = _np(jax_paged_decode(jnp.asarray(q), jnp.asarray(pk),
                                jnp.asarray(pv), jnp.asarray(ln),
                                jnp.asarray(bt), interpret=True))
    got = PA.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(pk), torch.from_numpy(pv),
        torch.from_numpy(ln), torch.from_numpy(bt)).numpy()
    assert np.isfinite(got).all() and (got[1] == 0).all()
    np.testing.assert_allclose(got, want, **TOL)


# -- B7: chunked prefill -----------------------------------------------------
@pytest.mark.parametrize("base,chunk_len,c,h,hkv", [
    (0, 8, 8, 4, 4),        # first chunk of a prompt
    (13, 8, 8, 4, 4),       # prior context in the pool
    (5, 3, 8, 4, 4),        # chunk_len < C: padded query rows
    (0, 0, 8, 4, 4),        # zero-length chunk: all-zero rows
    (9, 6, 8, 4, 2),        # GQA
    (13, 7, 8, 8, 1),       # GQA 8 at base % block != 0, padded rows
])
def test_paged_prefill_matches_jax(base, chunk_len, c, h, hkv):
    """Every query row (padded rows too) against the JAX kernel; rows at
    or past base + chunk_len hold NaN."""
    rng = np.random.default_rng(base * 7 + chunk_len)
    bs, nb, d = 4, 16, 16
    total = base + chunk_len
    npages = max(1, -(-total // bs)) + 1
    pk, pv = make_pool(nb, bs, hkv, d, rng)
    bt = make_tables([total], bs, npages, nb, rng, pk, pv)[0]
    q = rng.standard_normal((c, h, d)).astype(np.float32)
    want = _np(jax_paged_prefill(jnp.asarray(q), jnp.asarray(pk),
                                 jnp.asarray(pv), base, chunk_len,
                                 jnp.asarray(bt), interpret=True))
    got = PA.paged_prefill_attention(
        torch.from_numpy(q), torch.from_numpy(pk), torch.from_numpy(pv),
        base, chunk_len, torch.from_numpy(bt)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    if total == 0:
        assert (got == 0).all()


# -- B6/B7 over int8 and packed-int4 pools -----------------------------------
def quantized(pk, pv, bits):
    """JAX's ``kv_quantize`` of both pools (NaN rows quantize to zero
    values and NaN scales) as numpy: the same bytes go to both sides."""
    kq, ks = jax_kv_quantize(jnp.asarray(pk), bits)
    vq, vs = jax_kv_quantize(jnp.asarray(pv), bits)
    return tuple(np.array(a) for a in (kq, vq, ks, vs))


@pytest.mark.parametrize("kv_bits", [8, 4])
@pytest.mark.parametrize("h,hkv,d", [(8, 2, 32), (4, 4, 16)])
def test_paged_decode_quantized_matches_jax(kv_bits, h, hkv, d):
    """JAX's sweep shape (lengths 3, 0, 37, 5, 17; 8-row blocks; GQA 8
    over 2 heads, D 32) and MHA: NaN in every unread row, so NaN scales
    past every length and in a NaN block of a table; the inactive slot
    stays zero."""
    rng = np.random.default_rng(kv_bits + h)
    lens = [3, 0, 37, 5, 17]
    bs, nb, npages = 8, 24, 6
    pk, pv = make_pool(nb, bs, hkv, d, rng)
    bt = make_tables(lens, bs, npages, nb, rng, pk, pv)
    kq, vq, ks, vs = quantized(pk, pv, kv_bits)
    assert np.isnan(ks).any()
    q = rng.standard_normal((len(lens), h, d)).astype(np.float32)
    ln = np.asarray(lens, np.int32)
    want = _np(jax_paged_decode(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(ln),
        jnp.asarray(bt), interpret=True, k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs), kv_bits=kv_bits))
    t = torch.from_numpy
    got = PA.paged_decode_attention(
        t(q), t(kq), t(vq), t(ln), t(bt), k_scale=t(ks), v_scale=t(vs),
        kv_bits=kv_bits).numpy()
    assert np.isfinite(got).all() and (got[1] == 0).all()
    np.testing.assert_allclose(got, want, **QTOL)


@pytest.mark.parametrize("kv_bits", [8, 4])
@pytest.mark.parametrize("base,chunk_len,c,h,hkv", [
    (13, 11, 16, 8, 2),     # JAX's sweep case: prior context, GQA
    (0, 8, 8, 4, 4),        # first chunk
    (5, 3, 8, 4, 4),        # padded query rows
    (0, 0, 8, 4, 2),        # zero-length chunk: all-zero rows
    (13, 7, 8, 8, 1),       # GQA 8 at base % block != 0, padded rows
])
def test_paged_prefill_quantized_matches_jax(kv_bits, base, chunk_len, c, h,
                                             hkv):
    rng = np.random.default_rng(kv_bits + base + chunk_len)
    bs, nb, d = 4, 24, 32
    total = base + chunk_len
    npages = max(1, -(-total // bs)) + 1
    pk, pv = make_pool(nb, bs, hkv, d, rng)
    bt = make_tables([total], bs, npages, nb, rng, pk, pv)[0]
    kq, vq, ks, vs = quantized(pk, pv, kv_bits)
    q = rng.standard_normal((c, h, d)).astype(np.float32)
    want = _np(jax_paged_prefill(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), base, chunk_len,
        jnp.asarray(bt), interpret=True, k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs), kv_bits=kv_bits))
    t = torch.from_numpy
    got = PA.paged_prefill_attention(
        t(q), t(kq), t(vq), base, chunk_len, t(bt), k_scale=t(ks),
        v_scale=t(vs), kv_bits=kv_bits).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **QTOL)
    if total == 0:
        assert (got == 0).all()


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_quantized_single_row_is_the_dequantized_row(kv_bits):
    """JAX's ``test_kernel_dequant_matches_kv_dequantize_exactly``: one
    fully attended row comes back as the dequantized v row, in the port
    and in JAX's kernel."""
    from deepspeed_tpu_torch.ops.quantizer import kv_dequantize
    rng = np.random.default_rng(kv_bits)
    pk, pv = make_pool(4, 4, 2, 16, rng)
    kq, vq, ks, vs = quantized(pk, pv, kv_bits)
    q = rng.standard_normal((1, 2, 16)).astype(np.float32)
    bt = np.array([[3]], np.int32)
    t = torch.from_numpy
    got = PA.paged_decode_attention(
        t(q), t(kq), t(vq), torch.ones(1, dtype=torch.int32), t(bt),
        k_scale=t(ks), v_scale=t(vs), kv_bits=kv_bits).numpy()
    want = kv_dequantize(t(vq)[3, 0], t(vs)[3, 0], kv_bits).numpy()
    np.testing.assert_array_equal(got[0], want)
    jgot = _np(jax_paged_decode(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
        jnp.ones(1, jnp.int32), jnp.asarray(bt), interpret=True,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), kv_bits=kv_bits))
    np.testing.assert_allclose(got, jgot, atol=1e-6, rtol=0)


# -- wrapper errors -----------------------------------------------------------
def _paged_args(h=4, hkv=4, d=16):
    rng = np.random.default_rng(0)
    pk, pv = make_pool(8, 4, hkv, d, rng)
    return (torch.from_numpy(rng.standard_normal((2, h, d)).astype(
        np.float32)), torch.from_numpy(pk), torch.from_numpy(pv),
        torch.tensor([3, 0], dtype=torch.int32),
        torch.tensor([[1, 0], [0, 0]], dtype=torch.int32))


@pytest.mark.parametrize("case,exc", [
    ("decode_bad_rank", ValueError),
    ("decode_length_past_cache", ValueError),
    ("decode_dtype_mismatch", TypeError),
    ("decode_heads_not_multiple", ValueError),
    ("paged_heads_not_multiple", ValueError),
    ("paged_pool_shapes_differ", ValueError),
    ("paged_lengths_int64", TypeError),
    ("paged_tables_wrong_rows", ValueError),
    ("paged_int8_pool", ValueError),
    ("paged_scales_at_kv_bits_0", ValueError),
    ("paged_scale_shape", ValueError),
    ("paged_bad_kv_bits", ValueError),
    ("prefill_table_2d", ValueError),
])
def test_wrapper_errors(case, exc):
    q, pk, pv, ln, bt = _paged_args()
    scale = torch.ones(pk.shape[:3])
    k = torch.zeros(2, 6, 4, 16)
    calls = {
        "decode_bad_rank": lambda: DA.decode_attention(q[0], k, k, 1),
        "decode_length_past_cache": lambda: DA.decode_attention(q, k, k, 7),
        "decode_dtype_mismatch": lambda: DA.decode_attention(
            q, k.double(), k.double(), 1),
        # H 4 over a cache of 3 kv heads
        "decode_heads_not_multiple": lambda: DA.decode_attention(
            q, k[:, :, :3], k[:, :, :3], 1),
        "paged_heads_not_multiple": lambda: PA.paged_decode_attention(
            *_paged_args(h=4, hkv=3)),
        "paged_pool_shapes_differ": lambda: PA.paged_decode_attention(
            q, pk, pv[:, :2], ln, bt),
        "paged_lengths_int64": lambda: PA.paged_decode_attention(
            q, pk, pv, ln.long(), bt),
        "paged_tables_wrong_rows": lambda: PA.paged_decode_attention(
            q, pk, pv, ln, bt[:1]),
        # an int8 pool without scales
        "paged_int8_pool": lambda: PA.paged_decode_attention(
            q, pk.to(torch.int8), pv.to(torch.int8), ln, bt, kv_bits=8),
        "paged_scales_at_kv_bits_0": lambda: PA.paged_decode_attention(
            q, pk, pv, ln, bt, k_scale=scale, v_scale=scale),
        "paged_scale_shape": lambda: PA.paged_decode_attention(
            q, pk.to(torch.int8), pv.to(torch.int8), ln, bt,
            k_scale=scale, v_scale=scale[:, :2], kv_bits=8),
        "paged_bad_kv_bits": lambda: PA.paged_decode_attention(
            q, pk, pv, ln, bt, kv_bits=3),
        "prefill_table_2d": lambda: PA.paged_prefill_attention(
            q, pk, pv, 0, 2, bt),
    }
    with pytest.raises(exc):
        calls[case]()


# -- the head dims and kv groups the reference serves ------------------------
@pytest.mark.parametrize("g", [3, 16])
@pytest.mark.parametrize("d", [80, 96])
def test_decode_every_head_dim_and_group_matches_jax(d, g):
    """B5's plain version at GPT-3 2.7B's and 760M's head dims (80, 96)
    with kv groups of 3 and 16 against the JAX kernel in interpret mode
    (the cache expanded over the group on its side, as ``expand_kv``
    gives it); NaN past the length."""
    rng = np.random.default_rng(d + g)
    b, hkv, s, length = 2, 2, 24, 17
    h = g * hkv
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    k[:, length:] = np.nan
    v[:, length:] = np.nan
    ke, ve = (np.repeat(x, g, axis=2) for x in (k, v))
    want = _np(jax_decode(jnp.asarray(q), jnp.asarray(ke), jnp.asarray(ve),
                          length, interpret=True))
    got = DA.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), length).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("kv_bits", [0, 8, 4])
@pytest.mark.parametrize("g", [3, 16])
@pytest.mark.parametrize("d", [80, 96])
def test_paged_every_head_dim_and_group_matches_jax(d, g, kv_bits):
    """B6 and B7's plain versions at head dims 80 and 96 with kv groups of
    3 and 16, unquantized and over int8 / packed-int4 pools, against the
    JAX kernels in interpret mode: ragged lengths with an inactive slot
    (B6) and a chunk at a base that is not a multiple of the block (B7),
    NaN in every unread row.  Tolerance: 1e-5 unquantized, 3e-5 quantized
    (as above)."""
    rng = np.random.default_rng(d + g + kv_bits)
    hkv, bs, nb, npages = 1, 8, 16, 4
    h = g * hkv
    lens = [11, 0, 25]
    pk, pv = make_pool(nb, bs, hkv, d, rng)
    bt = make_tables(lens, bs, npages, nb, rng, pk, pv)
    quant, jquant, tol = {}, {}, TOL
    if kv_bits:
        kq, vq, ks, vs = quantized(pk, pv, kv_bits)
        pk, pv, tol = kq, vq, QTOL
        quant = dict(k_scale=torch.from_numpy(ks),
                     v_scale=torch.from_numpy(vs), kv_bits=kv_bits)
        jquant = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
                      kv_bits=kv_bits)
    q = rng.standard_normal((len(lens), h, d)).astype(np.float32)
    ln = np.asarray(lens, np.int32)
    want = _np(jax_paged_decode(jnp.asarray(q), jnp.asarray(pk),
                                jnp.asarray(pv), jnp.asarray(ln),
                                jnp.asarray(bt), interpret=True, **jquant))
    t = torch.from_numpy
    got = PA.paged_decode_attention(t(q), t(pk), t(pv), t(ln), t(bt),
                                    **quant).numpy()
    assert np.isfinite(got).all() and (got[1] == 0).all()
    np.testing.assert_allclose(got, want, **tol)
    qc = rng.standard_normal((8, h, d)).astype(np.float32)
    base, clen = 13, 7
    table = bt[2]
    want = _np(jax_paged_prefill(jnp.asarray(qc), jnp.asarray(pk),
                                 jnp.asarray(pv), base, clen,
                                 jnp.asarray(table), interpret=True,
                                 **jquant))
    got = PA.paged_prefill_attention(t(qc), t(pk), t(pv), base, clen,
                                     t(table), **quant).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **tol)


# -- float16 ------------------------------------------------------------------
#: float16 against float16: both sides compute in f32 and round the output
#: to f16 once (a quantized pool dequantizes in f32 on both), so they
#: differ by about one f16 ulp; two ulps of a value near 1 as the limit
F16_TOL = dict(atol=2e-3, rtol=2e-3)


def _f16(a):
    return np.asarray(a, np.float16)


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("d", [64, 80])
def test_f16_decode_matches_jax(d, g):
    """B5's plain version in float16 against the JAX kernel in interpret
    mode on the same float16 inputs (the cache expanded over the group on
    its side); NaN past the length; the output is float16."""
    rng = np.random.default_rng(100 + d + g)
    b, hkv, s, length = 2, 2, 24, 17
    h = g * hkv
    q = _f16(rng.standard_normal((b, h, d)))
    k = _f16(rng.standard_normal((b, s, hkv, d)))
    v = _f16(rng.standard_normal((b, s, hkv, d)))
    k[:, length:] = np.nan
    v[:, length:] = np.nan
    ke, ve = (np.repeat(x, g, axis=2) for x in (k, v))
    want = _np(jax_decode(jnp.asarray(q), jnp.asarray(ke), jnp.asarray(ve),
                          length, interpret=True))
    got = DA.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), length)
    assert got.dtype == torch.float16 and want.dtype == np.float16
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                               **F16_TOL)


@pytest.mark.parametrize("kv_bits", [0, 8, 4])
@pytest.mark.parametrize("g,d", [(1, 64), (4, 80)])
def test_f16_paged_matches_jax(kv_bits, g, d):
    """B6's and B7's plain versions with float16 queries (and float16
    pools at kv_bits 0; int8 / packed int4 with f32 scales otherwise)
    against the JAX kernels in interpret mode on the same inputs: ragged
    lengths with an inactive slot, a chunk at a base that is not a
    multiple of the block, NaN in every unread row; float16 out."""
    rng = np.random.default_rng(200 + d + g + kv_bits)
    hkv, bs, nb, npages = 2, 8, 16, 4
    h = g * hkv
    lens = [11, 0, 25]
    pk, pv = make_pool(nb, bs, hkv, d, rng)
    bt = make_tables(lens, bs, npages, nb, rng, pk, pv)
    quant, jquant = {}, {}
    if kv_bits:
        kq, vq, ks, vs = quantized(pk, pv, kv_bits)
        pk, pv = kq, vq
        quant = dict(k_scale=torch.from_numpy(ks),
                     v_scale=torch.from_numpy(vs), kv_bits=kv_bits)
        jquant = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
                      kv_bits=kv_bits)
    else:
        pk, pv = _f16(pk), _f16(pv)
    q = _f16(rng.standard_normal((len(lens), h, d)))
    ln = np.asarray(lens, np.int32)
    want = _np(jax_paged_decode(jnp.asarray(q), jnp.asarray(pk),
                                jnp.asarray(pv), jnp.asarray(ln),
                                jnp.asarray(bt), interpret=True, **jquant))
    t = torch.from_numpy
    got = PA.paged_decode_attention(t(q), t(pk), t(pv), t(ln), t(bt),
                                    **quant)
    assert got.dtype == torch.float16
    got = got.float().numpy()
    assert np.isfinite(got).all() and (got[1] == 0).all()
    np.testing.assert_allclose(got, want.astype(np.float32), **F16_TOL)
    qc = _f16(rng.standard_normal((8, h, d)))
    base, clen = 13, 7
    table = bt[2]
    want = _np(jax_paged_prefill(jnp.asarray(qc), jnp.asarray(pk),
                                 jnp.asarray(pv), base, clen,
                                 jnp.asarray(table), interpret=True,
                                 **jquant))
    got = PA.paged_prefill_attention(t(qc), t(pk), t(pv), base, clen,
                                     t(table), **quant)
    assert got.dtype == torch.float16
    got = got.float().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want.astype(np.float32), **F16_TOL)
