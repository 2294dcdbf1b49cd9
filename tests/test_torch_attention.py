"""The port's attention kernels (B5, B6, B7) against the JAX package's
Pallas kernels.

On the CPU each port wrapper runs its plain PyTorch version (the tensors
lie on the CPU); the JAX kernels run in interpret mode, as the JAX
package's own serving suite runs them.  Inputs are made with numpy from a
seed and handed to both; float32 throughout, compared at atol = rtol =
1e-5 (both sides accumulate in f32; only the summation order differs).
The CUDA kernels themselves are held against these plain versions on
the card by ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.transformer.decode_attention import (
    decode_attention as jax_decode)
from deepspeed_tpu.ops.transformer.paged_decode_attention import (
    paged_decode_attention as jax_paged_decode,
    paged_prefill_attention as jax_paged_prefill)
from deepspeed_tpu_torch.ops.transformer import decode_attention as DA
from deepspeed_tpu_torch.ops.transformer import paged_decode_attention as PA

TOL = dict(atol=1e-5, rtol=1e-5)


def _np(x):
    return np.asarray(x)


# -- B5: dense decode ---------------------------------------------------------
@pytest.mark.parametrize("s,length", [(24, 24), (24, 13), (40, 1), (24, 0)])
def test_decode_attention_matches_jax(s, length):
    """Full, ragged and empty valid lengths; rows past the length hold
    NaN, which must not reach either result."""
    rng = np.random.default_rng(s + length)
    b, h, d = 2, 4, 16
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, h, d)).astype(np.float32)
    v = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k[:, length:] = np.nan
    v[:, length:] = np.nan
    want = _np(jax_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          length, interpret=True))
    got = DA.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), length).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    if length == 0:
        assert (got == 0).all()


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


# -- B7: chunked prefill -----------------------------------------------------
@pytest.mark.parametrize("base,chunk_len,c,h,hkv", [
    (0, 8, 8, 4, 4),        # first chunk of a prompt
    (13, 8, 8, 4, 4),       # prior context in the pool
    (5, 3, 8, 4, 4),        # chunk_len < C: padded query rows
    (0, 0, 8, 4, 4),        # zero-length chunk: all-zero rows
    (9, 6, 8, 4, 2),        # GQA
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
    ("paged_heads_not_multiple", ValueError),
    ("paged_pool_shapes_differ", ValueError),
    ("paged_lengths_int64", TypeError),
    ("paged_tables_wrong_rows", ValueError),
    ("paged_int8_pool", NotImplementedError),
    ("paged_bad_kv_bits", ValueError),
    ("prefill_table_2d", ValueError),
])
def test_wrapper_errors(case, exc):
    q, pk, pv, ln, bt = _paged_args()
    k = torch.zeros(2, 6, 4, 16)
    calls = {
        "decode_bad_rank": lambda: DA.decode_attention(q[0], k, k, 1),
        "decode_length_past_cache": lambda: DA.decode_attention(q, k, k, 7),
        "decode_dtype_mismatch": lambda: DA.decode_attention(
            q, k.double(), k.double(), 1),
        "paged_heads_not_multiple": lambda: PA.paged_decode_attention(
            *_paged_args(h=4, hkv=3)),
        "paged_pool_shapes_differ": lambda: PA.paged_decode_attention(
            q, pk, pv[:, :2], ln, bt),
        "paged_lengths_int64": lambda: PA.paged_decode_attention(
            q, pk, pv, ln.long(), bt),
        "paged_tables_wrong_rows": lambda: PA.paged_decode_attention(
            q, pk, pv, ln, bt[:1]),
        "paged_int8_pool": lambda: PA.paged_decode_attention(
            q, pk, pv, ln, bt, kv_bits=8),
        "paged_bad_kv_bits": lambda: PA.paged_decode_attention(
            q, pk, pv, ln, bt, kv_bits=3),
        "prefill_table_2d": lambda: PA.paged_prefill_attention(
            q, pk, pv, 0, 2, bt),
    }
    with pytest.raises(exc):
        calls[case]()
