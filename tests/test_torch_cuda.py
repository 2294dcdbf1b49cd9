"""The port's CUDA kernels (B1, B2, B5, B6, B7) against their plain
PyTorch versions, on the card.

These tests need an NVIDIA card with ``nvcc`` (the kernels are built from
``deepspeed_tpu_torch/csrc`` at first use and have no CPU mode) and skip
elsewhere.  The file imports no JAX, so it also runs where JAX is not
installed::

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""
import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.transformer import decode_attention as DA
from deepspeed_tpu_torch.ops.transformer import flash_attention as FA
from deepspeed_tpu_torch.ops.transformer import paged_decode_attention as PA


def make_pool(nb, bs, hkv, d, rng):
    pk = rng.standard_normal((nb, bs, hkv, d)).astype(np.float32)
    pv = rng.standard_normal((nb, bs, hkv, d)).astype(np.float32)
    return pk, pv


def make_tables(lens, bs, npages, nb, rng, pk, pv):
    """Disjoint shuffled tables (block 0 reserved); every pool row no
    slot reads below its length is NaN, and one NaN block sits in a
    table just past a slot's length."""
    avail = list(rng.permutation(np.arange(1, nb)))
    bt = np.zeros((len(lens), npages), np.int32)
    read = np.zeros((nb, bs), bool)
    for i, n in enumerate(lens):
        for p in range(-(-n // bs)):
            bt[i, p] = avail.pop()
            read[bt[i, p], :min(bs, n - p * bs)] = True
    i = next(i for i, n in enumerate(lens) if -(-n // bs) < npages)
    bt[i, -(-lens[i] // bs)] = avail.pop()
    pk[~read] = np.nan
    pv[~read] = np.nan
    return bt


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain(dtype):
    """B5, B6 and B7 launched on the card against their plain versions
    on the same inputs (NaN past every valid length), GQA included.
    Tolerance: f32 1e-4; bf16 atol 4e-3, rtol 8e-3 (both sides round
    the f32 result to bf16 once, so they differ by at most one bf16 ulp,
    2^-7 of the value)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    dt = getattr(torch, dtype)
    tol = (dict(atol=1e-4, rtol=1e-4) if dt == torch.float32
           else dict(atol=4e-3, rtol=8e-3))
    rng = np.random.default_rng(1)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)
    q = rng.standard_normal((3, 8, 128)).astype(np.float32)
    k = rng.standard_normal((3, 70, 8, 128)).astype(np.float32)
    k[:, 45:] = np.nan
    got = DA.decode_attention(t(q), t(k), t(k[::-1]), 45)
    want = DA.decode_attention_plain(t(q), t(k), t(k[::-1]), 45)
    torch.testing.assert_close(got, want, **tol)
    for hkv in (8, 2):
        lens = [0, 37, 130]
        pk, pv = make_pool(64, 16, hkv, 128, rng)
        bt = make_tables(lens, 16, 10, 64, rng, pk, pv)
        args = (t(pk), t(pv), torch.tensor(lens, dtype=torch.int32,
                                           device=dev),
                torch.from_numpy(bt).to(dev))
        got = PA.paged_decode_attention(t(q), *args)
        want = PA.paged_decode_attention_plain(t(q), *args)
        torch.testing.assert_close(got, want, **tol)
        qc = t(rng.standard_normal((40, 8, 128)).astype(np.float32))
        table = torch.from_numpy(bt[2]).to(dev)
        for base, clen in ((0, 40), (90, 40), (100, 17)):
            got = PA.paged_prefill_attention(qc, t(pk), t(pv), base, clen,
                                             table)
            want = PA.paged_prefill_attention_plain(qc, t(pk), t(pv), base,
                                                    clen, table)
            torch.testing.assert_close(got, want, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t_len,d", [(128, 64), (100, 64), (1000, 64),
                                     (77, 16), (64, 128)])
def test_cuda_flash_attention_matches_plain(dtype, causal, t_len, d):
    """B1 (o, lse) and B2 (dq, dk, dv) on the card against their plain
    versions on the same inputs: whole tiles, ragged T (100, 1000, 77:
    rows past T never read) and four head dims.  Tolerance: f32 1e-4
    (the kernel's online softmax and tile-by-tile sums round in another
    order than the plain version's single pass); bf16 atol 4e-3, rtol
    8e-3 (both sides round the same f32 values to bf16 at the same
    points, so they differ by about one bf16 ulp, 2^-7 of the value)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    dt = getattr(torch, dtype)
    tol = (dict(atol=1e-4, rtol=1e-4) if dt == torch.float32
           else dict(atol=4e-3, rtol=8e-3))
    rng = np.random.default_rng(t_len + d + causal)

    def t(*shape):
        a = rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(a).to(dev, dt)
    q, k, v, do = (t(6, t_len, d) for _ in range(4))
    o, lse = FA.flash_attention_fwd(q, k, v, causal)
    o_p, lse_p = FA.flash_attention_fwd_plain(q, k, v, causal)
    torch.testing.assert_close(o, o_p, **tol)
    torch.testing.assert_close(lse, lse_p, atol=1e-4, rtol=1e-4)
    got = FA.flash_attention_bwd(q, k, v, o_p, lse_p, do, causal)
    want = FA.flash_attention_bwd_plain(q, k, v, o_p, lse_p, do, causal)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **tol)
    # deterministic: a second launch gives the same bits
    again = FA.flash_attention_bwd(q, k, v, o_p, lse_p, do, causal)
    for g, a in zip(got, again):
        assert torch.equal(g, a)
