"""The port's CUDA kernels (B1 to B10, and the int8/int4 variants of B6
and B7) against their plain PyTorch versions, the KV codec and the f32
logits products, on the card.

These tests need an NVIDIA card with ``nvcc`` (the kernels are built from
``deepspeed_tpu_torch/csrc`` at first use and have no CPU mode) and skip
elsewhere.  The file imports no JAX, so it also runs where JAX is not
installed::

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""
import hashlib
import math

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.models import layers as L
from deepspeed_tpu_torch.ops.sparse_attention import blocksparse_flash as BS
from deepspeed_tpu_torch.ops.transformer import decode_attention as DA
from deepspeed_tpu_torch.ops.transformer import flash_attention as FA
from deepspeed_tpu_torch.ops.transformer import fused_loss
from deepspeed_tpu_torch.ops.quantizer import kv_dequantize, kv_quantize
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


def decode_case(b, h, hkv, s_len, d, dtype, seed):
    """Seeded q ``[B, H, D]`` and a cache k, v ``[B, S, Hkv, D]`` on the
    card."""
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")

    def t(*shape):
        a = rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(a).to(dev, dtype)
    return t(b, h, d), t(b, s_len, hkv, d), t(b, s_len, hkv, d)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 4, 8, 16])
@pytest.mark.parametrize("d", [8, 16, 32, 64, 128, 256])
@pytest.mark.parametrize("b,length", [(3, 300), (3, 131), (1, 300),
                                      (2, 1), (2, 0)])
def test_cuda_decode_attention_at_kv_head_width(g, d, b, length):
    """The bf16 B5 (one block per (row, kv head, split), the group's g
    query heads together, splits merged in one thread-block cluster) on
    a cache at kv-head width (H 16 over 16 / g kv heads), at every head
    dim the kernel takes: D 8 gives one 16-byte vector a row, and g 16
    gives a thread two output vectors at D 128 and four at D 256 (g * D
    4096, the most a block holds).  Held against its
    plain version on the same inputs, with NaN in every row past the
    length (never read); bit-equal on a second launch.  The plan
    (``cluster_plan``) splits these caches into 3 to 5 ranks of a
    cluster; length 0 gives zero rows.  Tolerance: atol
    4e-3, rtol 8e-3 (both sides round the f32 result to bf16 once)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    h, s_len = 16, 300
    q, k, v = decode_case(b, h, h // g, s_len, d, torch.bfloat16,
                          seed=10 * g + d + b + length)
    k[:, length:] = float("nan")
    v[:, length:] = float("nan")
    got = DA.decode_attention(q, k, v, length)
    want = DA.decode_attention_plain(q, k, v, length)
    assert bool(got.isfinite().all())
    bad = off_limit(got, want)
    assert not bad, f"{len(bad)} elements off, first {bad[:8]}"
    assert torch.equal(got, DA.decode_attention(q, k, v, length))
    if length == 0:
        assert not got.any()


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hkv,d,length,nsplit", [
    (8, 32, 32, 128, 192, 1),    # GPT-3 6.7B's decode step
    (8, 32, 4, 64, 192, 3),      # TinyLlama-1.1B's: three splits merged
])
def test_cuda_decode_attention_is_one_launch(b, h, hkv, d, length, nsplit):
    """At the main paths' decode shapes the bf16 B5 is one kernel launch
    a call (a trace of the call holds one CUDA kernel), whether or not
    its positions are split: the splits of a (row, kv head) merge inside
    their cluster, with no second kernel and no scratch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    q, k, v = decode_case(b, h, hkv, length, d, torch.bfloat16, seed=7)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert DA.cluster_plan(b, hkv, length, sms)[0] == nsplit
    DA.decode_attention(q, k, v, length)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        DA.decode_attention(q, k, v, length)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    assert sum(e.count for e in kernels) == 1, [e.key for e in kernels]
    assert "decode_cluster_kernel" in kernels[0].key


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t_len,g,d", [(200, 4, 64), (130, 1, 128),
                                       (77, 2, 16)])
def test_cuda_gqa_flash_attention_matches_plain(dtype, causal, t_len, g, d):
    """B1 with a kv group (k/v at kv-head width), B3 (dq) and B4 (dk/dv
    summed over the group) on the card against their plain versions on
    the same inputs: ragged T (rows past T never read), groups of 1, 2
    and 4.  B3 and B4 give the same bits on a second launch (no atomics).
    Tolerance as above: f32 1e-4; bf16 atol 4e-3, rtol 8e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    dt = getattr(torch, dtype)
    tol = (dict(atol=1e-4, rtol=1e-4) if dt == torch.float32
           else dict(atol=4e-3, rtol=8e-3))
    rng = np.random.default_rng(t_len + g + causal)

    def t(*shape):
        a = rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(a).to(dev, dt)
    q, do = t(3 * g, t_len, d), t(3 * g, t_len, d)
    k, v = t(3, t_len, d), t(3, t_len, d)
    o, lse = FA.flash_attention_fwd(q, k, v, causal)
    o_p, lse_p = FA.flash_attention_fwd_plain(q, k, v, causal)
    torch.testing.assert_close(o, o_p, **tol)
    torch.testing.assert_close(lse, lse_p, atol=1e-4, rtol=1e-4)
    dq = FA.flash_attention_bwd_dq(q, k, v, o_p, lse_p, do, causal)
    dk, dv = FA.flash_attention_bwd_dkv(q, k, v, o_p, lse_p, do, causal)
    torch.testing.assert_close(
        dq, FA.flash_attention_bwd_dq_plain(q, k, v, o_p, lse_p, do, causal),
        **tol)
    for got, want in zip((dk, dv), FA.flash_attention_bwd_dkv_plain(
            q, k, v, o_p, lse_p, do, causal)):
        assert got.shape == k.shape
        torch.testing.assert_close(got, want, **tol)
    assert torch.equal(dq, FA.flash_attention_bwd_dq(q, k, v, o_p, lse_p,
                                                     do, causal))
    for a, b in zip((dk, dv), FA.flash_attention_bwd_dkv(q, k, v, o_p,
                                                         lse_p, do, causal)):
        assert torch.equal(a, b)


def gqa_case(t_len, g, d, dtype, seed, heads=2):
    """Seeded q, k, v, dO for ``heads`` kv heads in groups of ``g`` (k/v
    at kv-head width) on the card, with the plain forward's o and lse."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)

    def t(*shape):
        a = rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(a).to(dev, dtype)
    q, do = t(heads * g, t_len, d), t(heads * g, t_len, d)
    k, v = t(heads, t_len, d), t(heads, t_len, d)
    return q, k, v, do


def _bwd_pair(dq, dkv):
    """B3 and B4 (or their plain versions) as one function of dq, dk, dv."""
    def run(*args):
        return (dq(*args), *dkv(*args))
    return run


#: each bf16 tensor-core kernel (B3/B4 the pair): (kernel, plain version)
TENSOR_CORE = {
    "B1": (FA.flash_attention_fwd, FA.flash_attention_fwd_plain),
    "B2": (FA.flash_attention_bwd, FA.flash_attention_bwd_plain),
    "B3/B4": (_bwd_pair(FA.flash_attention_bwd_dq,
                        FA.flash_attention_bwd_dkv),
              _bwd_pair(FA.flash_attention_bwd_dq_plain,
                        FA.flash_attention_bwd_dkv_plain)),
}


def tensor_core_outputs(kernel, q, k, v, do, causal):
    """The kernel's outputs, its plain version's and the kernel's again on
    a second launch: B1's (o, lse), or B2's or B3/B4's (dq, dk, dv) from
    the plain forward's o and lse."""
    fn, plain = TENSOR_CORE[kernel]
    args = (q, k, v, causal)
    if kernel != "B1":
        args = (q, k, v, *FA.flash_attention_fwd_plain(q, k, v, causal), do,
                causal)
    return fn(*args), plain(*args), fn(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kernel,g", [("B1", 1), ("B1", 2), ("B1", 4),
                                      ("B1", 8), ("B2", 1), ("B3/B4", 1),
                                      ("B3/B4", 2), ("B3/B4", 4),
                                      ("B3/B4", 8)])
@pytest.mark.parametrize("t_len", [40, 64, 150, 1000])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_cuda_flash_on_tensor_cores_matches_plain(d, t_len, kernel, g,
                                                  causal):
    """The bf16 B1 (o, lse), B2 and B3/B4 (dq, dk, dv) run their products
    on the tensor cores (mma.sync m16n8k16 fragments): every head dim
    they take, T below one tile (40), of one whole tile (64), ragged past
    one (150) and of many tiles (1000), kv groups of 1 to 8 (B2 takes
    one kv head per query head), causal and full, against their plain
    versions on the same inputs, and bit-equal on a second launch.
    Tolerance: atol 4e-3, rtol 8e-3 (both sides round p (and ds) to bf16
    at the same points and the outputs once, so they differ by about one
    bf16 ulp, 2^-7 of the value); B1's lse, f32 in both, atol and rtol
    1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    tol = dict(atol=4e-3, rtol=8e-3)
    seed = 1000 * d + 10 * t_len + 2 * g + causal + (7 if kernel == "B2"
                                                     else 0)
    case = gqa_case(t_len, g, d, torch.bfloat16, seed,
                    heads=3 if kernel == "B2" else 2)
    got, want, again = tensor_core_outputs(kernel, *case, causal)
    if kernel == "B1":
        torch.testing.assert_close(got[1], want[1], atol=1e-4, rtol=1e-4)
        got, want = got[:1], want[:1]
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **tol)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def off_limit(got, want, atol=4e-3, rtol=8e-3):
    """Indices of the elements of ``got`` outside the limit of ``want``."""
    got, want = got.float(), want.float()
    return ((got - want).abs() > atol + rtol * want.abs()).nonzero().tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kernel,g,seed", [("B1", 2, 164), ("B2", 1, 264),
                                           ("B3/B4", 2, 64)])
def test_cuda_flash_one_tile_every_element(kernel, g, seed, causal):
    """T = 64, D = 16 (one tile, one mma k-step over the head dim): every
    element of the bf16 B1 output o and of B2's and B3/B4's dq, dk and dv
    sits within the limit of the plain version's (atol 4e-3, rtol 8e-3),
    listed by index where it does not; and the same check catches one
    8 x 8 fragment of the plain result transposed, the fault a wrong
    ldmatrix or lane map leaves."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    case = gqa_case(64, g, 16, torch.bfloat16, seed + causal)
    got, want, _ = tensor_core_outputs(kernel, *case, causal)
    names = ("o",) if kernel == "B1" else ("dq", "dk", "dv")
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape
        bad = off_limit(a, b)
        assert not bad, f"{name}: {len(bad)} elements off, first {bad[:8]}"
        flipped = b.clone()
        flipped[1, 40:48, 8:16] = b[1, 40:48, 8:16].t()
        assert off_limit(flipped, b), f"{name}: a transposed fragment passes"


def digest(x):
    """sha256 of a tensor's bytes (bf16 read as int16, f32 as int32)."""
    raw = x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)
    return hashlib.sha256(raw.cpu().numpy().tobytes()).hexdigest()


#: sha256 of the float32 B5 outputs on ``decode_digests``' inputs (one kv
#: head a query head), as the kernel of commit f00a71f gave them on an
#: H100 80GB HBM3: the f32 B5 keeps its CUDA-core kernel, with the kv
#: head index h / g added
DECODE_DIGESTS = {
    "f32 B5 S70 length45 D128":
        "4f3d4c105d4e92684cd02d55aa55156061b4cd2aba7a475cbd15f7ad49bee384",
    "f32 B5 S700 length650 D64":
        "386e01e911e34f63e67dfc081eb4bf3c8619af215127f3bed93bd674d681dab2",
}


def decode_digests():
    """The float32 B5 on fixed inputs at Hkv = H (the contract the parent
    kernel took): a short cache in one pass and a long one split over
    eleven blocks a head and merged by the second kernel; the sha256 of
    each output."""
    dev = torch.device("cuda")
    out = {}
    for b, h, s_len, d, length in ((3, 8, 70, 128, 45),
                                   (2, 8, 700, 64, 650)):
        rng = np.random.default_rng(s_len + length)

        def t(*shape):
            a = rng.standard_normal(shape).astype(np.float32)
            return torch.from_numpy(a).to(dev)
        q, k, v = t(b, h, d), t(b, s_len, h, d), t(b, s_len, h, d)
        k[:, length:] = float("nan")
        v[:, length:] = float("nan")
        out[f"f32 B5 S{s_len} length{length} D{d}"] = digest(
            DA.decode_attention(q, k, v, length))
    return out


@pytest.mark.cuda
def test_cuda_decode_f32_keeps_its_bits():
    """The float32 B5 keeps its CUDA-core kernel when the bf16 one moves
    to the cluster design: its outputs on fixed inputs have the pinned
    bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    assert decode_digests() == DECODE_DIGESTS


#: sha256 of the float32 and bfloat16 B1 (o, lse), B2 and B3/B4 (dq, dk,
#: dv) outputs on ``flash_digests``' inputs, as the kernels of commit
#: 12df449 gave them on an H100 80GB HBM3 (the f32 ones and the bf16
#: B3/B4 ones also a9cfd4d's): the f32 kernels stay on the CUDA cores and
#: the bf16 ones keep their tensor-core code
FLASH_DIGESTS = {
    "f32 B1 o T200 D64":
        "8da212611f86dcd7a5e3e4011e191a5758a24e5e88bc4e136cb5bf7111891acf",
    "f32 B1 lse T200 D64":
        "05c291eb3e6204a28692df9b5397ab8ace07dc327ebdb0a2872d7ec0422f0c0c",
    "f32 B2 dq T200 D64":
        "65eab8e63e7353ee803abb55f8e186402e7b25c972cf617ff7043849bd4c44cc",
    "f32 B2 dk T200 D64":
        "d6abfe3077b5d928ae46a853c1a945d4db894cd887fa1107630b9ffb184c3deb",
    "f32 B2 dv T200 D64":
        "9b52901513f8470066cf4f3319b76e174305ba95e292ff19e353dd6c84e436e5",
    "f32 B1 g4 o T200 D64":
        "13abe8defa1ef77074db236c11a10f71651cfcc02ab1780e4db186a6c0d14a34",
    "f32 B1 g4 lse T200 D64":
        "b0c0572e8b472d228484ff2cabf44f35161b26178f3e2ef8044eb262bc9d94ab",
    "bf16 B1 o T200 D64":
        "434a76654cfbed613dc03c469e5940e8dea19f7076e03d8f1443a013b6848d8c",
    "bf16 B1 lse T200 D64":
        "b3b1704d55080f4f5ccfb02e23695b953d3398d6ab1dfc0de2418e397e92be4c",
    "bf16 B2 dq T200 D64":
        "9cbdc3c97bc7b5d35e745ca6620c95565e0f911352c5fe1ce27532492eccf4d0",
    "bf16 B2 dk T200 D64":
        "d83b5e06b4244ac121cca285cd2365e15000deba796413f52cb10ee5da2e5722",
    "bf16 B2 dv T200 D64":
        "9d367ca39c8b2b61f2af5c4a24a7228427aa7430d22738369e631fa85f228d96",
    "f32 B3/B4 dq T200 D64":
        "986ae5e5940ecf2acef0bd5ecc75db548bcd4e06c328c6e8bcfe6928598d2bb0",
    "f32 B3/B4 dk T200 D64":
        "08fa5af3298dd85df053784c1caf38c9f4d78cbc86ea8bc43ecb5f579b17c8cd",
    "f32 B3/B4 dv T200 D64":
        "cee3d796eca22628067832e7d1d5cc2413b15e135b69a2a1c2332432fb623f48",
    "bf16 B3/B4 dq T200 D64":
        "255109793000cc7a6cacff0cb77c8f45790867752ff9031e27896c36e0d35f30",
    "bf16 B3/B4 dk T200 D64":
        "2046ffd1c4ec40a340790fff10605ddad715d7b01b3b850329462e4e070d766f",
    "bf16 B3/B4 dv T200 D64":
        "639f23868a5255621e8041a2948c40caf6366d7199a751a803cdc2dbddcd1728",
    "f32 B1 o T100 D128":
        "7a7fe9477ffd7b48ff0d525215fe1d974b71688e2eb77dea081db03030703a90",
    "f32 B1 lse T100 D128":
        "a9fb4d8de69537982dc3c81db1ea27ea28af77feeb75cffc769660f056bcc607",
    "f32 B2 dq T100 D128":
        "2d6855998fa40b6a74d6946e8bd8894112184ad2fce8b4fc28e381d9d143e63e",
    "f32 B2 dk T100 D128":
        "d3916fa09e0dcfdf090e7ff7128d1a7bdcb32410200ab81d80daedb44d0f731b",
    "f32 B2 dv T100 D128":
        "650fa5b6a3111edbdfe21e9c1e595c6c5da5051765e5838d0fb67ebed310d898",
    "f32 B1 g4 o T100 D128":
        "de9c4202f4a01aa21ad467f6d56b70174870f77211781f745c836235bb2a046d",
    "f32 B1 g4 lse T100 D128":
        "99f5f5452dcdf200d9e0a79a888c9c9c5729c4c04b46fceb633a64732c20dd26",
    "bf16 B1 o T100 D128":
        "b1ecfef713398fc759cd1cc6045a38fd04da4645c56791de0fef78932d08301e",
    "bf16 B1 lse T100 D128":
        "dc808c328853a082c7fe38db60ff8fd99a3a95ab159cdb80fbe239494ac7d2ae",
    "bf16 B2 dq T100 D128":
        "cf3d0cb33b927b91ef37dcfacb77c45b66d72552fc653373480ef48fc678a57f",
    "bf16 B2 dk T100 D128":
        "040f14826cf319fa3990e6b28c7fd7eeba1705e74d8e7b8260ce4b8175a2944c",
    "bf16 B2 dv T100 D128":
        "9d531917d75a027c3e2d6c4e75e4d1df24aab7bda6bd0f3dcf0b47c2ada6b0db",
    "f32 B3/B4 dq T100 D128":
        "3a7b87cbc0930aed0e0acc77a01f55bc5385bd135b96e4be9a3c0fb60af75452",
    "f32 B3/B4 dk T100 D128":
        "cd00681aa1bcf1d6cd0385b68dfb71f38e1d847a2a36b24c78ec265c60515a87",
    "f32 B3/B4 dv T100 D128":
        "99ef073e9a3f7e8f82934ac3979903192610063c878daa9ce28c47883f18ff54",
    "bf16 B3/B4 dq T100 D128":
        "a581283202a4c20d2ee2ec73331675417bbff7a67292428b43663dbb7245f722",
    "bf16 B3/B4 dk T100 D128":
        "8fa9677abe0baa757775c4a474a9f5bd5be7f0ab321eefd9c7c02734fb91adea",
    "bf16 B3/B4 dv T100 D128":
        "d61b0aac421723192a67693809fa4e80ce28f52712749f7f0c4ba12a92c47bd6",
}


def flash_digests():
    """B1 and B2 in float32 and in bfloat16 (MHA over 4 heads; the f32 B1
    also GQA 4 over 2 kv heads), B3 and B4 in float32 and in bfloat16 (GQA
    4 over 2 kv heads), on fixed inputs at T 200 causal, D 64 and T 100
    full, D 128: the sha256 of each output."""
    out = {}
    for t_len, d, causal in ((200, 64, True), (100, 128, False)):
        case = f"T{t_len} D{d}"
        q, k, v, do = gqa_case(t_len, 1, d, torch.float32, 8, heads=4)
        o, lse = FA.flash_attention_fwd(q, k, v, causal)
        out[f"f32 B1 o {case}"], out[f"f32 B1 lse {case}"] = (
            digest(o), digest(lse))
        o, lse = FA.flash_attention_fwd_plain(q, k, v, causal)
        for name, x in zip(("dq", "dk", "dv"), FA.flash_attention_bwd(
                q, k, v, o, lse, do, causal)):
            out[f"f32 B2 {name} {case}"] = digest(x)
        q, k, v, _ = gqa_case(t_len, 4, d, torch.float32, 9)
        o, lse = FA.flash_attention_fwd(q, k, v, causal)
        out[f"f32 B1 g4 o {case}"], out[f"f32 B1 g4 lse {case}"] = (
            digest(o), digest(lse))
        q, k, v, do = gqa_case(t_len, 1, d, torch.bfloat16, 11, heads=4)
        o, lse = FA.flash_attention_fwd(q, k, v, causal)
        out[f"bf16 B1 o {case}"], out[f"bf16 B1 lse {case}"] = (
            digest(o), digest(lse))
        o, lse = FA.flash_attention_fwd_plain(q, k, v, causal)
        for name, x in zip(("dq", "dk", "dv"), FA.flash_attention_bwd(
                q, k, v, o, lse, do, causal)):
            out[f"bf16 B2 {name} {case}"] = digest(x)
        for kind, dtype, seed in (("f32", torch.float32, 7),
                                  ("bf16", torch.bfloat16, 10)):
            q, k, v, do = gqa_case(t_len, 4, d, dtype, seed)
            o, lse = FA.flash_attention_fwd_plain(q, k, v, causal)
            outs = (FA.flash_attention_bwd_dq(q, k, v, o, lse, do, causal),
                    *FA.flash_attention_bwd_dkv(q, k, v, o, lse, do, causal))
            for name, x in zip(("dq", "dk", "dv"), outs):
                out[f"{kind} B3/B4 {name} {case}"] = digest(x)
    return out


@pytest.mark.cuda
def test_cuda_flash_kernels_keep_their_bits():
    """The float32 B1, B2, B3 and B4 keep their CUDA-core kernels, and the
    bfloat16 B1, B2, B3 and B4 their tensor-core kernels through the walks'
    move onto a shared walk policy (``flash_bwd_mma.cuh``): their outputs
    on fixed inputs have the pinned bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    assert flash_digests() == FLASH_DIGESTS


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block,t_len,d,causal,per_head", [
    (16, 256, 64, True, True), (16, 208, 16, False, True),
    (32, 192, 32, True, False), (64, 512, 64, True, True),
    (64, 320, 128, False, False), (128, 512, 64, True, True),
    (128, 384, 16, False, True)])
def test_cuda_blocksparse_matches_plain(dtype, block, t_len, d, causal,
                                        per_head):
    """B8 (o, lse), B9 (dq) and B10 (dk, dv) on the card against their
    plain versions on the same inputs, for layout blocks of 16 and 32
    (several blocks share a 64-row tile pair: the sub-block mask), 64
    and 128 (one block spans 2 x 2 tile pairs), T ragged against the
    64-row tile (208, 320), per-head and shared layouts, causal or not.
    B9 and B10 give the same bits on a second launch (no atomics).
    Tolerance as for B1-B4: f32 1e-4; bf16 atol 4e-3, rtol 8e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    dt = getattr(torch, dtype)
    tol = (dict(atol=1e-4, rtol=1e-4) if dt == torch.float32
           else dict(atol=4e-3, rtol=8e-3))
    rng = np.random.default_rng(block + t_len + d + causal)
    heads, nb = 3, t_len // block
    layout = rng.random((heads if per_head else 1, nb, nb)) < 0.3
    layout[:, np.arange(nb), np.arange(nb)] = True
    layout = np.broadcast_to(layout, (heads, nb, nb))
    if causal:
        layout = layout & np.tril(np.ones((nb, nb), bool))
    lc = BS.compress_layout(layout)
    args = (lc, block, heads, causal)

    def t():
        a = rng.standard_normal((2 * heads, t_len, d)).astype(np.float32)
        return torch.from_numpy(a).to(dev, dt)
    q, k, v, do = t(), t(), t(), t()
    o, lse = BS.blocksparse_attention_fwd(q, k, v, *args)
    o_p, lse_p = BS.blocksparse_attention_fwd_plain(q, k, v, *args)
    torch.testing.assert_close(o, o_p, **tol)
    torch.testing.assert_close(lse, lse_p, atol=1e-4, rtol=1e-4)
    dq = BS.blocksparse_attention_bwd_dq(q, k, v, o_p, lse_p, do, *args)
    torch.testing.assert_close(dq, BS.blocksparse_attention_bwd_dq_plain(
        q, k, v, o_p, lse_p, do, *args), **tol)
    dk, dv = BS.blocksparse_attention_bwd_dkv(q, k, v, o_p, lse_p, do,
                                              *args)
    for got, want in zip((dk, dv), BS.blocksparse_attention_bwd_dkv_plain(
            q, k, v, o_p, lse_p, do, *args)):
        torch.testing.assert_close(got, want, **tol)
    assert torch.equal(dq, BS.blocksparse_attention_bwd_dq(
        q, k, v, o_p, lse_p, do, *args))
    for a, b in zip((dk, dv), BS.blocksparse_attention_bwd_dkv(
            q, k, v, o_p, lse_p, do, *args)):
        assert torch.equal(a, b)


def sparse_case(block, t_len, d, causal, per_head, dtype, seed, heads=3,
                empty_kv=False):
    """Seeded q, k, v, dO ``[2 * heads, T, D]`` on the card and the
    kernels' layout arguments of a random block layout (density 0.3, the
    diagonal set, the upper triangle cleared when causal; one per head or
    one shared).  ``empty_kv``: the third kv block column is cleared (its
    rows then hold a block left of it), so no query reads that kv tile."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    nb = t_len // block
    layout = rng.random((heads if per_head else 1, nb, nb)) < 0.3
    layout[:, np.arange(nb), np.arange(nb)] = True
    if empty_kv:
        layout[:, :, 2] = False
        layout[:, 2, 0] = True
    layout = np.broadcast_to(layout, (heads, nb, nb))
    if causal:
        layout = layout & np.tril(np.ones((nb, nb), bool))

    def t():
        a = rng.standard_normal((2 * heads, t_len, d)).astype(np.float32)
        return torch.from_numpy(a).to(dev, dtype)
    q, k, v, do = t(), t(), t(), t()
    return q, k, v, do, layout, (BS.compress_layout(layout), block, heads,
                                 causal)


def sparse_outputs(q, k, v, do, args):
    """(dq, dk, dv) of B9 and B10, of their plain versions and of the
    kernels again on a second launch, from the plain forward's o and
    lse."""
    o, lse = BS.blocksparse_attention_fwd_plain(q, k, v, *args)

    def run(dq, dkv):
        return (dq(q, k, v, o, lse, do, *args),
                *dkv(q, k, v, o, lse, do, *args))
    got = run(BS.blocksparse_attention_bwd_dq,
              BS.blocksparse_attention_bwd_dkv)
    want = run(BS.blocksparse_attention_bwd_dq_plain,
               BS.blocksparse_attention_bwd_dkv_plain)
    again = run(BS.blocksparse_attention_bwd_dq,
                BS.blocksparse_attention_bwd_dkv)
    return got, want, again, (o, lse)


def dense_dkv(q, k, v, do, o, lse, keep):
    """dk and dv of plain attention under an element mask ``keep [H, T,
    T]`` (head row b reads ``keep[b % H]``), at B10's rounding points:
    the oracle of a kernel that tests the wrong sub-block bits."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    h = keep.shape[0]
    keep = keep.repeat(q.shape[0] // h, 1, 1)
    s = q.float() @ k.float().transpose(1, 2) * scale
    p = torch.exp(s - lse[..., None]).masked_fill(~keep, 0.0)
    dp = do.float() @ v.float().transpose(1, 2)
    delta = (do.float() * o.float()).sum(-1)
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype).float()
    dv = p.to(do.dtype).float().transpose(1, 2) @ do.float()
    dk = ds.transpose(1, 2) @ q.float()
    return dk.to(k.dtype), dv.to(v.dtype)


#: the bf16 B9/B10 card cases: (name, block, T, causal, per-head layout)
SPARSE_TC_CASES = [
    ("block16-ragged-full", 16, 208, False, True),
    ("block32-ragged-causal", 32, 224, True, False),
    ("block64-causal", 64, 320, True, True),
    ("block128-full", 128, 384, False, False),
    ("block512-causal", 512, 1024, True, False),
    ("empty-kv-tile", 64, 256, False, True),
    ("asymmetric16", 16, 128, False, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,block,t_len,causal,per_head", SPARSE_TC_CASES,
                         ids=[c[0] for c in SPARSE_TC_CASES])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_cuda_blocksparse_on_tensor_cores_matches_plain(d, name, block,
                                                        t_len, causal,
                                                        per_head):
    """The bf16 B9 (dq) and B10 (dk, dv) run their products on the tensor
    cores (mma.sync over the tile lists): every head dim they take, layout
    blocks of 16 and 32 (sub-block masks inside a 64-row tile pair), 64,
    128 and 512 (a block spans 2 x 2 and 8 x 8 tile pairs; causal, the
    pairs above the diagonal are left out), T ragged against the tile
    (208, 224), per-head and shared layouts, causal and full, against
    their plain versions, and bit-equal on a second launch.  A kv tile no
    query reads gets dk = dv = 0.  The asymmetric 16-row layout also
    proves that the limit catches B10 testing a pair's sub-block bits with
    its kv and query sub-blocks swapped (the transposed lists keep the
    bits query-major).  Tolerance: atol 4e-3, rtol 8e-3 (one bf16 ulp)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    q, k, v, do, layout, args = sparse_case(
        block, t_len, d, causal, per_head, torch.bfloat16,
        seed=100 * d + block + t_len + causal,
        empty_kv=name == "empty-kv-tile")
    got, want, again, (o, lse) = sparse_outputs(q, k, v, do, args)
    for x, a, b in zip(("dq", "dk", "dv"), got, want):
        bad = off_limit(a, b)
        assert not bad, f"{x}: {len(bad)} elements off, first {bad[:8]}"
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    if name == "empty-kv-tile":
        for a in got[1:]:
            assert not a[:, 128:192].any()
    if name == "asymmetric16":
        n = t_len // 64
        fine = torch.from_numpy(layout.copy()).to(q.device)
        keep = fine.repeat_interleave(16, 1).repeat_interleave(16, 2)
        swapped = (fine.view(-1, n, 4, n, 4).transpose(2, 4)
                   .reshape(fine.shape)
                   .repeat_interleave(16, 1).repeat_interleave(16, 2))
        assert not torch.equal(keep, swapped)
        for a, b in zip(dense_dkv(q, k, v, do, o, lse, keep), got[1:]):
            assert not off_limit(a, b)
        assert any(off_limit(a, b) for a, b in zip(
            dense_dkv(q, k, v, do, o, lse, swapped), want[1:]))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_blocksparse_one_tile_every_element(causal):
    """T = 64, D = 16, a per-head layout of 16-row blocks (one tile pair
    of 4 x 4 sub-blocks): every element of the bf16 B9's dq and B10's dk
    and dv sits within the limit of the plain version's, listed by index
    where it does not; and the same check catches one 8 x 8 fragment of
    the plain result transposed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    q, k, v, do, _, args = sparse_case(16, 64, 16, causal, True,
                                       torch.bfloat16, seed=364 + causal,
                                       heads=2)
    got, want, _, _ = sparse_outputs(q, k, v, do, args)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape
        bad = off_limit(a, b)
        assert not bad, f"{name}: {len(bad)} elements off, first {bad[:8]}"
        flipped = b.clone()
        flipped[1, 40:48, 8:16] = b[1, 40:48, 8:16].t()
        assert off_limit(flipped, b), f"{name}: a transposed fragment passes"


#: the bf16 B8 card cases: (name, block, T, causal, per-head layout)
SPARSE_FWD_CASES = [
    ("block16-ragged-full", 16, 208, False, True),
    ("block16-causal", 16, 256, True, True),
    ("block32-ragged-causal", 32, 224, True, False),
    ("block64-causal", 64, 320, True, True),
    ("block128-full", 128, 384, False, False),
    ("block128-causal", 128, 512, True, True),
]


def masked_first_pair_layout(causal):
    """A per-head layout of 16-row blocks over T 128 (two 64-row tiles)
    in which query block 4 (the first rows of query tile 1) sees key block
    4 alone while query block 5 also sees key block 0: tile 1's walk
    starts with the pair (1, 0), where block 4's rows see no key, and
    their first real maximum comes in the next pair."""
    nb = 8
    lay = np.zeros((2, nb, nb), bool)
    lay[:, np.arange(nb), np.arange(nb)] = True
    lay[:, 1, 0] = lay[:, 3, 2] = True
    lay[:, 5, 0] = lay[:, 7, 1] = True
    if causal:
        lay &= np.tril(np.ones((nb, nb), bool))
    return lay


@pytest.mark.cuda
@pytest.mark.parametrize("name,block,t_len,causal,per_head",
                         SPARSE_FWD_CASES,
                         ids=[c[0] for c in SPARSE_FWD_CASES])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_cuda_blocksparse_fwd_on_tensor_cores_matches_plain(d, name, block,
                                                            t_len, causal,
                                                            per_head):
    """The bf16 B8 runs its products on the tensor cores (mma.sync over
    the layout's tile lists): every head dim it takes, layout blocks of
    16 and 32 (sub-block masks inside a 64-row tile pair), 64 and 128 (a
    block spans 2 x 2 tile pairs; causal, the pair above the diagonal is
    walked and wholly masked), T ragged against the tile (208, 224),
    per-head and shared layouts, causal and full: o and lse against the
    plain version on the same inputs, and bit-equal on a second launch.
    Tolerance: o atol 4e-3, rtol 8e-3 (one bf16 ulp); lse, f32 in both,
    atol and rtol 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    q, k, v, _, _, args = sparse_case(block, t_len, d, causal, per_head,
                                      torch.bfloat16,
                                      seed=300 * d + block + t_len + causal)
    o, lse = BS.blocksparse_attention_fwd(q, k, v, *args)
    o_p, lse_p = BS.blocksparse_attention_fwd_plain(q, k, v, *args)
    bad = off_limit(o, o_p)
    assert not bad, f"o: {len(bad)} elements off, first {bad[:8]}"
    torch.testing.assert_close(lse, lse_p, atol=1e-4, rtol=1e-4)
    o2, lse2 = BS.blocksparse_attention_fwd(q, k, v, *args)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 64, 128])
def test_cuda_blocksparse_fwd_masked_first_pair(d, causal):
    """Rows that see no key in the first pair of their walk: B8 gives
    their masked scores MASK_VALUE in the base-2 domain, so the pair's
    maximum is finite (not -inf, which would make -inf - -inf = NaN), and
    the next pair's real maximum scales its junk to 0.  o and lse
    against the plain version (which softmaxes the whole walk at once),
    every element, and bit-equal on a second launch; the rows are seen
    to differ from the fault of a kernel that kept the junk (their o
    from the first pair alone)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    lay = masked_first_pair_layout(causal)
    lc = BS.compress_layout(lay)
    rng = np.random.default_rng(d + causal)

    def t():
        a = rng.standard_normal((4, 128, d)).astype(np.float32)
        return torch.from_numpy(a).to(dev, torch.bfloat16)
    q, k, v = t(), t(), t()
    args = (lc, 16, 2, causal)
    walk = BS.tile_layout(lc, 16, 128).q_walk
    assert list(walk[0][0, 1, :2]) == [0, 1]            # tile 1 walks 0, 1
    assert not walk[2][0, 1, 0] & 0xF                   # block 4: no key
    assert walk[2][0, 1, 0] & 0x10                      # block 5: key 0
    o, lse = BS.blocksparse_attention_fwd(q, k, v, *args)
    o_p, lse_p = BS.blocksparse_attention_fwd_plain(q, k, v, *args)
    assert bool(o.isfinite().all()) and bool(lse.isfinite().all())
    bad = off_limit(o, o_p)
    assert not bad, f"o: {len(bad)} elements off, first {bad[:8]}"
    torch.testing.assert_close(lse, lse_p, atol=1e-4, rtol=1e-4)
    o2, lse2 = BS.blocksparse_attention_fwd(q, k, v, *args)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    junk = v[:, :64].float().mean(dim=1)                # p = 1 on tile 0
    assert off_limit(junk[:, None].expand(-1, 16, -1), o_p[:, 64:80])


#: sha256 of the float32 B8 (o, lse), B9 (dq) and B10 (dk, dv) outputs on
#: ``blocksparse_digests``' inputs, as the kernels of commit 12df449 gave
#: them on an H100 80GB HBM3: the f32 kernels stay on the CUDA cores (the
#: bf16 B8, now on the tensor cores, is held to its plain version and to
#: its own bits on a second launch instead)
BLOCKSPARSE_DIGESTS = {
    "f32 B8 o block16 T208 D64":
        "646fe390c60609a5418fde0db1783ac3d79ac6f124c309db47438f731b77d1da",
    "f32 B8 lse block16 T208 D64":
        "6ab8024f4cd6b1495114ea2daa181903bc2b6ee7d3171bef4e643852f351bdc7",
    "f32 B9/B10 dq block16 T208 D64":
        "d74e28a0988f96e1ff19dbe2afec2c7c622664d15ac8714a46cfb78663c8b5cd",
    "f32 B9/B10 dk block16 T208 D64":
        "75921a30fca49c029324a8cb4814916774c8e03384948cfdb27c2d56aae4680e",
    "f32 B9/B10 dv block16 T208 D64":
        "cd55f6a34a18647ec066f59a573d0f7e68e5af28d9e93d2399e0fdb54119da4c",
    "f32 B8 o block128 T384 D32":
        "114c1d9a35e4cfd08d3e272d004e392f0aac6b4fcec70f76ad9c867ccef7ad1a",
    "f32 B8 lse block128 T384 D32":
        "fd28b04e60cf0891a53bcab2b192c1575ece5be708e9f71ca10c8dbf1ae457fc",
    "f32 B9/B10 dq block128 T384 D32":
        "126f4c18ef57cd21e3fea28d004bd1f4b70c74bcba43e388852848b877fac592",
    "f32 B9/B10 dk block128 T384 D32":
        "019b5e4c743c538e353dec13584ca5afcfd812bfd75370d584cee527705c1727",
    "f32 B9/B10 dv block128 T384 D32":
        "67b3d432339a51549991b0cfd64ad98d7e454768578b776e01d8555f35e7072b",
}


def blocksparse_digests():
    """B8, B9 and B10 in float32 on fixed inputs (a per-head layout of
    16-row blocks, full, T 208, D 64; a shared layout of 128-row blocks,
    causal, T 384, D 32): the sha256 of each output."""
    out = {}
    for block, t_len, d, causal, per_head in ((16, 208, 64, False, True),
                                              (128, 384, 32, True, False)):
        case = f"block{block} T{t_len} D{d}"
        q, k, v, do, _, args = sparse_case(block, t_len, d, causal,
                                           per_head, torch.float32,
                                           seed=block)
        o, lse = BS.blocksparse_attention_fwd(q, k, v, *args)
        out[f"f32 B8 o {case}"], out[f"f32 B8 lse {case}"] = (
            digest(o), digest(lse))
        got = sparse_outputs(q, k, v, do, args)[0]
        for name, x in zip(("dq", "dk", "dv"), got):
            out[f"f32 B9/B10 {name} {case}"] = digest(x)
    return out


@pytest.mark.cuda
def test_cuda_blocksparse_kernels_keep_their_bits():
    """The float32 B8, B9 and B10 keep their CUDA-core kernels: their
    outputs on fixed inputs have the pinned bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    assert blocksparse_digests() == BLOCKSPARSE_DIGESTS


@pytest.mark.cuda
@pytest.mark.parametrize("site", ["embedding_attend", "untied_head",
                                  "fused_loss_logits"])
def test_cuda_logits_are_f32_products_of_bf16_operands(site):
    """The card's logits products take bf16 operands and return f32 with
    f32 accumulation, as XLA's ``preferred_element_type=float32`` does:
    each site equals the f32 product of the same bf16 values to f32
    rounding (rtol 1e-5), where rounding the product to bf16 and
    widening it (the former form) misses that limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the products are cuBLAS's")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    x = torch.randn((96, 256), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn((256, 500), generator=g, device=dev)   # f32 master
    wb = w.to(torch.bfloat16)
    want = torch.matmul(x.float(), wb.float())
    got = {"embedding_attend": lambda: L.embedding_attend(
               {"embedding": w.t().contiguous()}, x),
           "untied_head": lambda: L.f32_product(x, w),
           "fused_loss_logits": lambda: fused_loss._logits(x, w, None,
                                                           False)}[site]()
    assert got.dtype == torch.float32
    tol = dict(rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    torch.testing.assert_close(got, want, **tol)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(torch.matmul(x, wb).float(), want, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("site", ["embedding_attend", "untied_head",
                                  "fused_loss_logits"])
def test_cuda_logits_are_f32_products_of_f16_operands(site):
    """As ``test_cuda_logits_are_f32_products_of_bf16_operands`` with
    float16 activations (fp16 serving and training): f32 results of f16
    operands, equal to the f32 product of the same f16 values to f32
    rounding, where rounding the product to f16 misses that limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the products are cuBLAS's")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    x = torch.randn((96, 256), generator=g, device=dev).to(torch.float16)
    w = torch.randn((256, 500), generator=g, device=dev)   # f32 master
    wh = w.to(torch.float16)
    want = torch.matmul(x.float(), wh.float())
    got = {"embedding_attend": lambda: L.embedding_attend(
               {"embedding": w.t().contiguous()}, x),
           "untied_head": lambda: L.f32_product(x, w),
           "fused_loss_logits": lambda: fused_loss._logits(x, w, None,
                                                           False)}[site]()
    assert got.dtype == torch.float32
    tol = dict(rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    torch.testing.assert_close(got, want, **tol)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(torch.matmul(x, wh).float(), want, **tol)


def quantized_pools(pk, pv, bits, dev):
    """``kv_quantize`` of numpy pools on the CPU, moved to ``dev``: NaN
    rows quantize to zero values and NaN scales, what a recycled block
    holds after a quarantine."""
    kq, ks = kv_quantize(torch.from_numpy(pk), bits)
    vq, vs = kv_quantize(torch.from_numpy(pv), bits)
    return tuple(x.to(dev) for x in (kq, vq, ks, vs))


@pytest.mark.cuda
@pytest.mark.parametrize("kv_bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g,d", [(1, 128), (2, 64), (4, 128), (8, 64)])
def test_cuda_quantized_paged_kernels_match_plain(kv_bits, dtype, g, d):
    """B6 and B7 over int8 and packed-int4 pools on the card against their
    plain versions (which dequantize with ``kv_dequantize``) on the same
    inputs: query groups 1 to 8 over 2 kv heads, head dims 64 and 128,
    ragged lengths and an inactive slot, NaN rows and NaN scales past
    every length and in a NaN block of a table.  Both sides widen each
    row to the same f32 values, so the tolerance is the unquantized
    kernels': f32 1e-4; bf16 atol 4e-3, rtol 8e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    dt = getattr(torch, dtype)
    tol = (dict(atol=1e-4, rtol=1e-4) if dt == torch.float32
           else dict(atol=4e-3, rtol=8e-3))
    rng = np.random.default_rng(kv_bits + 10 * g + d)
    hkv, h = 2, 2 * g
    lens = [0, 37, 130, 5]
    pk, pv = make_pool(64, 16, hkv, d, rng)
    bt = make_tables(lens, 16, 10, 64, rng, pk, pv)
    kq, vq, ks, vs = quantized_pools(pk, pv, kv_bits, dev)
    assert bool(ks.isnan().any())            # NaN scales past the lengths
    quant = dict(k_scale=ks, v_scale=vs, kv_bits=kv_bits)
    q = torch.from_numpy(rng.standard_normal((4, h, d)).astype(
        np.float32)).to(dev, dt)
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    tables = torch.from_numpy(bt).to(dev)
    got = PA.paged_decode_attention(q, kq, vq, ln, tables, **quant)
    want = PA.paged_decode_attention_plain(q, kq, vq, ln, tables, **quant)
    assert bool(got.isfinite().all()) and not bool(got[0].any())
    torch.testing.assert_close(got, want, **tol)
    qc = torch.from_numpy(rng.standard_normal((40, h, d)).astype(
        np.float32)).to(dev, dt)
    table = tables[2].contiguous()
    for base, clen in ((0, 40), (90, 40), (100, 17)):
        got = PA.paged_prefill_attention(qc, kq, vq, base, clen, table,
                                         **quant)
        want = PA.paged_prefill_attention_plain(qc, kq, vq, base, clen,
                                                table, **quant)
        assert bool(got.isfinite().all())
        torch.testing.assert_close(got, want, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kv_quantize_is_bit_equal_to_cpu(kv_bits, dtype):
    """The codec the serving step runs on the card gives the CPU's bits:
    values equal, scales equal (NaN rows included)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(kv_bits)
    x = rng.standard_normal((64, 16, 4, 128)).astype(np.float32) * 3.0
    x[5, 3] = np.nan
    x[9, :, 1] = 0.0
    xc = torch.from_numpy(x).to(getattr(torch, dtype))
    q_c, s_c = kv_quantize(xc, kv_bits)
    q_g, s_g = kv_quantize(xc.cuda(), kv_bits)
    assert torch.equal(q_g.cpu(), q_c)
    torch.testing.assert_close(s_g.cpu(), s_c, atol=0, rtol=0,
                               equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_quantized_single_row_is_the_dequantized_row(kv_bits, dtype):
    """The in-kernel decode is ``kv_dequantize`` exactly: one fully
    attended row comes back as the dequantized v row rounded to the
    query's dtype, through B6 (a slot of length 1) and B7 (a chunk of
    one token at base 0)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(3 + kv_bits)
    pk, pv = make_pool(4, 8, 2, 64, rng)
    kq, vq, ks, vs = quantized_pools(pk, pv, kv_bits, dev)
    quant = dict(k_scale=ks, v_scale=vs, kv_bits=kv_bits)
    table = torch.tensor([[2]], dtype=torch.int32, device=dev)
    q = torch.from_numpy(rng.standard_normal((1, 4, 64)).astype(
        np.float32)).to(dev, dt)
    want = kv_dequantize(vq[2, 0], vs[2, 0], kv_bits)      # [Hkv, D]
    want = want.repeat_interleave(2, dim=0).to(dt)         # [H, D]
    got = PA.paged_decode_attention(
        q, kq, vq, torch.ones(1, dtype=torch.int32, device=dev), table,
        **quant)
    assert torch.equal(got[0], want)
    got = PA.paged_prefill_attention(q, kq, vq, 0, 1, table[0], **quant)
    assert torch.equal(got[0], want)


#: sha256 of the f32 B6 and B7 outputs on ``unquantized_case``'s inputs,
#: as the kernels of the parent commit ae98d66 gave them on an H100 80GB
#: HBM3: the f32 instantiations keep their bits.  (The bf16 B6 and B7
#: were redesigned, split across a cluster and moved onto the tensor
#: cores; they are held to their plain versions and to their own bits on
#: a second launch by ``test_cuda_bf16_paged_kernels_match_plain``.)
UNQUANTIZED_DIGESTS = {
    "B6 float32":
        "87b0ab5a4424d43b41275e257ec639c19c4b80e705f2a94bab1bd06db9fab349",
    "B7 float32":
        "e2306372be539fd20801e3f86ad5be328c2347b54f0dd37900f6c3c6094ccacd",
}


def unquantized_case(dtype):
    """B6 and B7 at kv_bits 0 on fixed inputs (GQA 8 over 2 kv heads, D
    128, ragged lengths with NaN past them): (B6's output, B7's)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    lens = [0, 37, 130, 200]
    pk, pv = make_pool(64, 16, 2, 128, rng)
    bt = make_tables(lens, 16, 14, 64, rng, pk, pv)
    q = rng.standard_normal((4, 8, 128)).astype(np.float32)
    qc = rng.standard_normal((40, 8, 128)).astype(np.float32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)
    tables = torch.from_numpy(bt).to(dev)
    b6 = PA.paged_decode_attention(
        t(q), t(pk), t(pv),
        torch.tensor(lens, dtype=torch.int32, device=dev), tables)
    b7 = PA.paged_prefill_attention(t(qc), t(pk), t(pv), 160, 40,
                                    tables[3].contiguous())
    return b6, b7


def unquantized_digests():
    """The sha256 of the f32 B6 and B7 outputs' bytes on
    ``unquantized_case``'s inputs."""
    out = {}
    b6, b7 = unquantized_case(torch.float32)
    for name, o in (("B6", b6), ("B7", b7)):
        raw = o.view(torch.int32).cpu().numpy().tobytes()
        out[f"{name} float32"] = hashlib.sha256(raw).hexdigest()
    return out


@pytest.mark.cuda
def test_cuda_unquantized_paged_kernels_keep_their_bits():
    """kv_bits is a template parameter of B6 and B7: their f32
    unquantized instantiations give the parent commit's bits on fixed
    inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    assert unquantized_digests() == UNQUANTIZED_DIGESTS


def paged_pools(pk, pv, kv_bits, dev, dtype=torch.bfloat16):
    """``dtype`` pools at kv_bits 0, else ``quantized_pools``: (pool_k,
    pool_v, the scale keywords)."""
    if kv_bits == 0:
        return (torch.from_numpy(pk).to(dev, dtype),
                torch.from_numpy(pv).to(dev, dtype), {})
    kq, vq, ks, vs = quantized_pools(pk, pv, kv_bits, dev)
    return kq, vq, dict(k_scale=ks, v_scale=vs, kv_bits=kv_bits)


#: B6's lengths over a table of 64 pages of 16 rows (``paged_split_plan``:
#: 8 ranks of 128 rows): inactive, one row, a page boundary, a length
#: ending exactly on a split boundary, one past it, a slot spanning all
#: ranks (the table's full width), and ragged others
BF16_PAGED_LENS = [0, 1, 16, 128, 129, 1024, 513, 255]


@pytest.mark.cuda
@pytest.mark.parametrize("kv_bits", [0, 8, 4])
@pytest.mark.parametrize("g,d,hkv", [(1, 128, 4), (8, 64, 2), (4, 32, 2),
                                     (2, 256, 2)])
def test_cuda_bf16_paged_kernels_match_plain(kv_bits, g, d, hkv):
    """The bf16 B6 (splits of a slot merged in one cluster) and B7 (on the
    tensor cores at D 32, 64 and 128; on the CUDA cores at D 256, the route
    by shape) at kv_bits 0, 8 and 4 against their plain versions, and
    bit-equal on a second launch.  B6: lengths ending on a page and on a
    split boundary, a slot over the table's full width (every rank), an
    inactive slot (all zeros); B7: chunks with chunk_len < C at a base
    that is not a multiple of the block, the first chunk, a zero-length
    chunk at base 0 (all zeros).  NaN rows (and NaN scales) past every
    length and in a NaN block of a table never reach an output.
    Tolerance atol 4e-3, rtol 8e-3: both sides round the f32 result to
    bf16 once; the kernels also round p (B7) and the dequantized v (B7)
    to bf16 for the products, far inside that limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    tol = dict(atol=4e-3, rtol=8e-3)
    rng = np.random.default_rng(100 * g + d + kv_bits)
    h, bs, npages, nb = g * hkv, 16, 64, 200
    lens = BF16_PAGED_LENS
    pk, pv = make_pool(nb, bs, hkv, d, rng)
    bt = make_tables(lens, bs, npages, nb, rng, pk, pv)
    kp, vp, quant = paged_pools(pk, pv, kv_bits, dev)
    q = torch.from_numpy(rng.standard_normal((len(lens), h, d)).astype(
        np.float32)).to(dev, torch.bfloat16)
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    tables = torch.from_numpy(bt).to(dev)
    got = PA.paged_decode_attention(q, kp, vp, ln, tables, **quant)
    again = PA.paged_decode_attention(q, kp, vp, ln, tables, **quant)
    want = PA.paged_decode_attention_plain(q, kp, vp, ln, tables, **quant)
    assert bool(got.isfinite().all()) and not bool(got[0].any())
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, **tol)
    qc = torch.from_numpy(rng.standard_normal((128, h, d)).astype(
        np.float32)).to(dev, torch.bfloat16)
    for base, clen in ((77, 100), (0, 128), (509, 3), (900, 124), (0, 0)):
        # a slot of base + clen rows: NaN past them and in the next block
        pk, pv = make_pool(nb, bs, hkv, d, rng)
        bt = make_tables([base + clen], bs, npages + 1, nb, rng, pk, pv)
        kp, vp, quant = paged_pools(pk, pv, kv_bits, dev)
        table = torch.from_numpy(bt[0]).to(dev)
        got = PA.paged_prefill_attention(qc, kp, vp, base, clen, table,
                                         **quant)
        again = PA.paged_prefill_attention(qc, kp, vp, base, clen, table,
                                           **quant)
        want = PA.paged_prefill_attention_plain(qc, kp, vp, base, clen,
                                                table, **quant)
        assert bool(got.isfinite().all()), (base, clen)
        assert torch.equal(got, again), (base, clen)
        torch.testing.assert_close(got, want, **tol)
        if base + clen == 0:
            assert not bool(got.any())


SAMPLING_CASES = [(0.9, 12, 0.95), (1.3, 0, 0.8), (0.7, 5, 1.0),
                  (1.0, 64, 0.3)]


@pytest.mark.cuda
@pytest.mark.parametrize("temp,top_k,top_p", SAMPLING_CASES)
def test_cuda_seeded_sampled_server_stream_matches_generate(temp, top_k,
                                                            top_p):
    """Sampled decoding on the card: output token j of a request draws
    with (seed, j) from a CUDA generator in both paths, so a seeded
    ``temperature > 0`` serving stream (paged kernels B6/B7, beside
    another sampled request) equals a seeded ``generate()`` of the same
    prompt at batch 1 (dense decode, B5).  The model is a tiny GPT-2 (4
    layers, d_model 64, 2 heads of 32, the narrowest head the paged
    kernels take) in float32 with seed-0 weights, where the two paths'
    logits differ by f32 rounding only."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import transformer as tt
    cfg = tt.gpt2_config("125m", dtype=torch.float32, num_layers=4,
                         d_model=64, num_heads=2, vocab_size=64,
                         max_seq_len=64)
    eng = dt.init_inference(tt.TransformerLM(cfg), {
        "dtype": "float32", "max_out_tokens": 64, "temperature": 0.0,
        "serving": {"enabled": True, "kv_block_size": 8,
                    "num_kv_blocks": 48, "max_batch_slots": 8,
                    "prefill_chunk_tokens": 16}})
    rng = np.random.default_rng(int(10 * temp) + top_k)
    prompt = rng.integers(0, 64, 11).tolist()
    srv = eng.serving_engine()
    req = srv.submit(prompt, max_new_tokens=12, temperature=temp,
                     top_k=top_k, top_p=top_p, seed=11)
    other = srv.submit(rng.integers(0, 64, 5).tolist(), max_new_tokens=12,
                       temperature=0.9, seed=12)
    srv.run(max_steps=200)
    want = eng.generate([prompt], max_new_tokens=12, temperature=temp,
                        top_k=top_k, top_p=top_p, seed=11)[0].tolist()
    assert req.output == want
    assert len(other.output) == 12


@pytest.mark.cuda
@pytest.mark.parametrize("temp,top_k,top_p", SAMPLING_CASES)
def test_cuda_sampling_kept_set_equals_cpu(temp, top_k, top_p):
    """With top-k / top-p the kept set on the card equals the CPU's on the
    same logits (16 rows over a vocab of 1000), and the card's seeded
    draws stay inside it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from deepspeed_tpu_torch.inference.sampling import (filter_logits,
                                                        sample_tokens)
    rng = np.random.default_rng(int(100 * top_p) + top_k)
    logits = torch.from_numpy(
        (rng.standard_normal((16, 1000)) * 1.5).astype(np.float32))
    kept = torch.isfinite(filter_logits(logits, temp, top_k, top_p))
    kept_card = torch.isfinite(filter_logits(logits.cuda(), temp, top_k,
                                             top_p)).cpu()
    assert torch.equal(kept_card, kept)
    draws = sample_tokens(logits.cuda(), list(range(16)), [3] * 16,
                          [temp] * 16, [top_k] * 16, [top_p] * 16).cpu()
    assert bool(kept[torch.arange(16), draws].all())


# -- every head dim and kv group the reference runs; float16 B1-B4 --------------
#: the limits of the float16 kernels against their plain versions: about
#: one f16 ulp (2^-10 of a value in [1, 2)): both sides round p and ds to
#: f16 at the same points and the f32 result once
F16_TOL = dict(atol=5e-4, rtol=1e-3)
#: the bf16 limit (one bf16 ulp) and the f32 one, as above
BF16_TOL = dict(atol=4e-3, rtol=8e-3)
F32_TOL = dict(atol=1e-4, rtol=1e-4)
TOLS = {torch.float16: F16_TOL, torch.bfloat16: BF16_TOL,
        torch.float32: F32_TOL}

#: head dims the flash kernels took before every multiple of 16 up to 256:
#: GPT-3 2.7B's 80, 760M's 96, GPT-J's 256 and the other multiples
NEW_FLASH_DIMS = [48, 80, 96, 112, 144, 176, 208, 256]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("kernel,g", [("B1", 2), ("B2", 1), ("B3/B4", 2)])
@pytest.mark.parametrize("d", NEW_FLASH_DIMS + [64])
def test_cuda_flash_every_head_dim_matches_plain(d, kernel, g, dtype):
    """B1 (o, lse), B2 and B3/B4 (dq, dk, dv) at every head dim the
    reference runs (multiples of 16 up to 256; above 128 the dk/dv walk is
    a dV block and a dK block per kv tile), in bfloat16 and float16 on the
    tensor cores and float32 on the CUDA cores where its tiles fit shared
    memory (``build.kernel_supports``), causal at a ragged T of 150 with a
    kv group of 2 (B2: 1), against their plain versions on the same inputs
    and bit-equal on a second launch.  Tolerance: ``TOLS`` by dtype; lse
    (f32 in both) 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from deepspeed_tpu_torch.ops import build
    dt = getattr(torch, dtype)
    names = {"B1": "flash_attention_fwd", "B2": "flash_attention_bwd",
             "B3/B4": "flash_attention_bwd_dkv"}
    if build.kernel_supports(names[kernel], d, g, dt) is not None:
        with pytest.raises(ValueError, match="shared memory"):
            tensor_core_outputs(kernel, *gqa_case(150, g, d, dt, 1), True)
        return
    case = gqa_case(150, g, d, dt, seed=7 * d + g + len(dtype),
                    heads=3 if kernel == "B2" else 2)
    got, want, again = tensor_core_outputs(kernel, *case, True)
    if kernel == "B1":
        torch.testing.assert_close(got[1], want[1], atol=1e-4, rtol=1e-4)
        got, want, again = got[:1], want[:1], again[:1]
    for a, b in zip(got, want):
        bad = off_limit(a, b, **TOLS[dt])
        assert not bad, f"{len(bad)} elements off, first {bad[:8]}"
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,g", [("B1", 1), ("B1", 8), ("B2", 1),
                                      ("B3/B4", 8)])
@pytest.mark.parametrize("t_len", [64, 1000])
def test_cuda_flash_f16_one_ulp_and_planted_fault(kernel, g, t_len):
    """The float16 B1-B4 at D 64 (GPT-2's and TinyLlama's head) with kv
    groups 1 and 8: every element within about one f16 ulp of the plain
    version (``F16_TOL``), and the limit catches one 8 x 8 fragment of the
    plain result transposed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    case = gqa_case(t_len, g, 64, torch.float16, seed=t_len + g)
    got, want, again = tensor_core_outputs(kernel, *case, True)
    outs = list(zip(got, want))[:1] if kernel == "B1" else zip(got, want)
    for a, b in outs:
        assert not off_limit(a, b, **F16_TOL)
        flipped = b.clone()
        flipped[1, 40:48, 8:16] = b[1, 40:48, 8:16].t()
        assert off_limit(flipped, b, **F16_TOL)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


#: the B8-B10 cases of the new head dims and layout blocks: (block, T)
NEW_SPARSE_CASES = [(48, 240), (80, 320), (128, 384), (16, 208)]


@pytest.mark.cuda
@pytest.mark.parametrize("block,t_len", NEW_SPARSE_CASES)
@pytest.mark.parametrize("d", [48, 80, 96, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_blocksparse_every_head_dim_and_block(d, block, t_len, causal):
    """The bf16 B8 (o, lse), B9 (dq) and B10 (dk, dv) at the new head dims
    (B10 split into a dV and a dK block at 256) and at layout blocks that
    are multiples of 16 but neither 16, 32 nor a multiple of 64 (48, 80:
    the tile pairs carry the layout in 16-row sub-blocks), ragged against
    the 64-row tile, per-head layouts, against their plain versions and
    bit-equal on a second launch.  Tolerance: atol 4e-3, rtol 8e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    q, k, v, do, _, args = sparse_case(block, t_len, d, causal, True,
                                       torch.bfloat16,
                                       seed=d + block + t_len + causal)
    o, lse = BS.blocksparse_attention_fwd(q, k, v, *args)
    o_p, lse_p = BS.blocksparse_attention_fwd_plain(q, k, v, *args)
    assert not off_limit(o, o_p)
    torch.testing.assert_close(lse, lse_p, atol=1e-4, rtol=1e-4)
    o2, lse2 = BS.blocksparse_attention_fwd(q, k, v, *args)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    got, want, again, _ = sparse_outputs(q, k, v, do, args)
    for x, a, b in zip(("dq", "dk", "dv"), got, want):
        bad = off_limit(a, b)
        assert not bad, f"{x}: {len(bad)} elements off, first {bad[:8]}"
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 3, 16, 32])
@pytest.mark.parametrize("d", [40, 80, 96, 136, 256])
def test_cuda_decode_every_head_dim_and_group(g, d):
    """The bf16 B5 at head dims that are multiples of 8 but not 16 x a
    power of two (40, 80, 96, 136) and at 256, with kv groups of 3, 16 and
    32 (MQA at 32 heads; g x D past 4096 splits the group across blocks,
    each reading the kv head's rows): NaN past the length, against the
    plain version and bit-equal on a second launch.  Tolerance: atol
    4e-3, rtol 8e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    h, length = g * (2 if g < 16 else 1), 333
    q, k, v = decode_case(3, h, h // g, 400, d, torch.bfloat16,
                          seed=g + d)
    k[:, length:] = float("nan")
    v[:, length:] = float("nan")
    got = DA.decode_attention(q, k, v, length)
    want = DA.decode_attention_plain(q, k, v, length)
    assert bool(got.isfinite().all())
    bad = off_limit(got, want)
    assert not bad, f"{len(bad)} elements off, first {bad[:8]}"
    assert torch.equal(got, DA.decode_attention(q, k, v, length))


@pytest.mark.cuda
@pytest.mark.parametrize("kv_bits", [0, 8, 4])
@pytest.mark.parametrize("g,d,hkv", [(1, 80, 4), (3, 96, 2), (16, 64, 2),
                                     (32, 80, 1), (4, 40, 2), (2, 256, 2),
                                     (8, 72, 2)])
def test_cuda_paged_every_head_dim_and_group(kv_bits, g, d, hkv):
    """The bf16 B6 and B7 at kv_bits 0, 8 and 4 at the head dims and kv
    groups the reference serves: D 80 (GPT-3 2.7B) and 96 (760M), 40 and
    72 (multiples of 8 only: B7 on its CUDA-core kernel), 256, and groups
    of 3, 16 and 32 (B6 splits a group past 2048 output features across
    blocks; B7 puts as many positions of a group in a 64-row tile as fit
    and splits a group past 64 heads), on ``BF16_PAGED_LENS`` and the
    chunks of ``test_cuda_bf16_paged_kernels_match_plain``, NaN past every
    length: against their plain versions and bit-equal on a second
    launch.  Tolerance: atol 4e-3, rtol 8e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(1000 * g + d + kv_bits)
    h, bs, npages, nb = g * hkv, 16, 64, 200
    lens = BF16_PAGED_LENS
    pk, pv = make_pool(nb, bs, hkv, d, rng)
    bt = make_tables(lens, bs, npages, nb, rng, pk, pv)
    kp, vp, quant = paged_pools(pk, pv, kv_bits, dev)
    q = torch.from_numpy(rng.standard_normal((len(lens), h, d)).astype(
        np.float32)).to(dev, torch.bfloat16)
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    tables = torch.from_numpy(bt).to(dev)
    got = PA.paged_decode_attention(q, kp, vp, ln, tables, **quant)
    want = PA.paged_decode_attention_plain(q, kp, vp, ln, tables, **quant)
    assert bool(got.isfinite().all()) and not bool(got[0].any())
    assert not off_limit(got, want)
    assert torch.equal(got, PA.paged_decode_attention(q, kp, vp, ln, tables,
                                                      **quant))
    qc = torch.from_numpy(rng.standard_normal((100, h, d)).astype(
        np.float32)).to(dev, torch.bfloat16)
    for base, clen in ((77, 100), (0, 100), (509, 3)):
        pk, pv = make_pool(nb, bs, hkv, d, rng)
        bt = make_tables([base + clen], bs, npages + 1, nb, rng, pk, pv)
        kp, vp, quant = paged_pools(pk, pv, kv_bits, dev)
        table = torch.from_numpy(bt[0]).to(dev)
        got = PA.paged_prefill_attention(qc, kp, vp, base, clen, table,
                                         **quant)
        want = PA.paged_prefill_attention_plain(qc, kp, vp, base, clen,
                                                table, **quant)
        assert bool(got.isfinite().all()), (base, clen)
        bad = off_limit(got, want)
        assert not bad, (base, clen, len(bad), bad[:8])
        assert torch.equal(got, PA.paged_prefill_attention(
            qc, kp, vp, base, clen, table, **quant)), (base, clen)


@pytest.mark.cuda
def test_cuda_shapes_outside_the_gate_raise():
    """No fallback: on CUDA tensors a shape outside a kernel's gate raises
    with its reason before any launch (a flash head dim that is not a
    multiple of 16, a decode head dim past 256: C1's remainder, in bf16
    and in float16 alike)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    q, k, v, _ = gqa_case(64, 1, 24, torch.bfloat16, seed=1)
    with pytest.raises(ValueError, match="C1"):
        FA.flash_attention_fwd(q, k, v)
    for dt in (torch.bfloat16, torch.float16):
        q, k, v = decode_case(2, 4, 4, 16, 264, dt, seed=1)
        with pytest.raises(ValueError, match="C1"):
            DA.decode_attention(q, k, v, 8)


# -- float16 B5-B10 ----------------------------------------------------------------
def planted(b):
    """``b`` with one 8 x 8 block of its first row transposed: the fault
    every f16 case's limit must catch."""
    flipped = b.clone(memory_format=torch.contiguous_format)
    flat = flipped.view(-1, b.shape[-1])
    blk = flat[:8, :8].clone()
    if blk.shape == (8, 8) and not torch.equal(blk, blk.t()):
        flat[:8, :8] = blk.t()
    else:  # a head dim of 8 or a degenerate block: flip a sign
        flat[0, 0] = -flat[0, 0] - 1
    return flipped


#: the float16 block-sparse backward's limit: two f16 ulps.  ds = p (dP -
#: delta) sm_scale cancels where dP nears delta, and both sides round ds to
#: f16 before the dq and dk products: where their f32 ds (sums in another
#: order) straddle an f16 rounding point, one ds element moves by an f16
#: ulp of ds and carries that step into every element of its dq (or dk)
#: row.  On an H100 one row of dq came out past one ulp in 2 of the 60
#: cases (2 and 8 elements); ``chip_smoke.py`` holds every f16 kernel to
#: this limit (its F16_TOL)
F16_BWD_TOL = dict(atol=1e-3, rtol=2e-3)


def f16_close(got, want, tol=F16_TOL):
    """Within ``tol`` of the plain version (one f16 ulp by default), and
    the limit catches the planted fault."""
    bad = off_limit(got, want, **tol)
    assert not bad, f"{len(bad)} elements off, first {bad[:8]}"
    assert off_limit(planted(want), want, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 3, 4, 8, 16, 32])
@pytest.mark.parametrize("d", [8, 16, 32, 40, 64, 80, 96, 128, 136, 256])
@pytest.mark.parametrize("b,length", [(3, 300), (2, 1), (2, 0)])
def test_cuda_f16_decode_matches_plain(g, d, b, length):
    """The float16 B5 (the bf16 cluster kernel with f16 rows: ET =
    __half) at every head dim and kv group the bf16 cases cover, NaN past
    the length (never read): within one f16 ulp of its plain version, a
    planted fault caught, bit-equal on a second launch, zeros at length
    0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    h = g * (2 if g < 16 else 1)
    q, k, v = decode_case(b, h, h // g, 400, d, torch.float16,
                          seed=g + d + b + length)
    k[:, length:] = float("nan")
    v[:, length:] = float("nan")
    from deepspeed_tpu_torch.ops import build
    build.reset_launch_counts()
    got = DA.decode_attention(q, k, v, length)
    assert build.launch_counts["decode_attention_f16"] == 1
    assert build.launch_counts["decode_attention"] == 0
    want = DA.decode_attention_plain(q, k, v, length)
    assert got.dtype == torch.float16 and bool(got.isfinite().all())
    f16_close(got, want)
    assert torch.equal(got, DA.decode_attention(q, k, v, length))
    if length == 0:
        assert not got.any()


#: the float16 B6/B7 cases: the bf16 cases' (g, D, Hkv), those of
#: ``test_cuda_bf16_paged_kernels_match_plain`` and of
#: ``test_cuda_paged_every_head_dim_and_group``
F16_PAGED_CASES = [(1, 128, 4), (8, 64, 2), (4, 32, 2), (2, 256, 2),
                   (1, 80, 4), (3, 96, 2), (16, 64, 2), (32, 80, 1),
                   (4, 40, 2), (8, 72, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("kv_bits", [0, 8, 4])
@pytest.mark.parametrize("g,d,hkv", F16_PAGED_CASES)
def test_cuda_f16_paged_kernels_match_plain(kv_bits, g, d, hkv):
    """The float16 B6 (cluster ranks) and B7 (``mma_f16`` at D % 16 up to
    128, p as f16 hi + lo and a quantized v as hi + residual; the
    CUDA-core kernel at the other head dims) at kv_bits 0, 8 and 4: B6 on
    ``BF16_PAGED_LENS``, B7 on chunks at a ragged base, the first chunk
    and a zero-length one, NaN past every length: within one f16 ulp of
    their plain versions, a planted fault caught, bit-equal on a second
    launch, counted under ``<kernel>[_int<bits>]_f16``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from deepspeed_tpu_torch.ops import build
    dev, dt = torch.device("cuda"), torch.float16
    rng = np.random.default_rng(2000 * g + d + kv_bits)
    h, bs, npages, nb = g * hkv, 16, 64, 200
    lens = BF16_PAGED_LENS
    pk, pv = make_pool(nb, bs, hkv, d, rng)
    bt = make_tables(lens, bs, npages, nb, rng, pk, pv)
    kp, vp, quant = paged_pools(pk, pv, kv_bits, dev, dt)
    q = torch.from_numpy(rng.standard_normal((len(lens), h, d)).astype(
        np.float32)).to(dev, dt)
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    tables = torch.from_numpy(bt).to(dev)
    build.reset_launch_counts()
    got = PA.paged_decode_attention(q, kp, vp, ln, tables, **quant)
    name = build.counter("paged_decode_attention", kv_bits, dt)
    assert name.endswith("_f16") and build.launch_counts[name] == 1
    want = PA.paged_decode_attention_plain(q, kp, vp, ln, tables, **quant)
    assert bool(got.isfinite().all()) and not bool(got[0].any())
    f16_close(got, want)
    assert torch.equal(got, PA.paged_decode_attention(q, kp, vp, ln, tables,
                                                      **quant))
    qc = torch.from_numpy(rng.standard_normal((128, h, d)).astype(
        np.float32)).to(dev, dt)
    for base, clen in ((77, 100), (0, 128), (509, 3), (0, 0)):
        pk, pv = make_pool(nb, bs, hkv, d, rng)
        bt = make_tables([base + clen], bs, npages + 1, nb, rng, pk, pv)
        kp, vp, quant = paged_pools(pk, pv, kv_bits, dev, dt)
        table = torch.from_numpy(bt[0]).to(dev)
        got = PA.paged_prefill_attention(qc, kp, vp, base, clen, table,
                                         **quant)
        want = PA.paged_prefill_attention_plain(qc, kp, vp, base, clen,
                                                table, **quant)
        assert bool(got.isfinite().all()), (base, clen)
        if clen:
            f16_close(got[:clen], want[:clen])
        else:
            assert not bool(got.any())
        assert torch.equal(got, PA.paged_prefill_attention(
            qc, kp, vp, base, clen, table, **quant)), (base, clen)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_bits", [0, 8, 4])
@pytest.mark.parametrize("d", [64, 72, 128])
def test_cuda_f16_single_row_is_exact(kv_bits, d):
    """A single fully attended row comes back exact in float16 too: the
    (dequantized) v row rounded to f16, through B6 (a slot of length 1)
    and B7 (a chunk of one token at base 0; at D 64 and 128 on the tensor
    cores, where p = 1 splits into 1 and 0 and a quantized v's hi +
    residual rounds back to hi; at D 72 on the CUDA cores)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev, dt = torch.device("cuda"), torch.float16
    rng = np.random.default_rng(5 + kv_bits + d)
    pk, pv = make_pool(4, 8, 2, d, rng)
    kp, vp, quant = paged_pools(pk, pv, kv_bits, dev, dt)
    table = torch.tensor([[2]], dtype=torch.int32, device=dev)
    q = torch.from_numpy(rng.standard_normal((1, 4, d)).astype(
        np.float32)).to(dev, dt)
    if kv_bits:
        want = kv_dequantize(vp[2, 0], quant["v_scale"][2, 0], kv_bits)
    else:
        want = vp[2, 0]
    want = want.repeat_interleave(2, dim=0).to(dt)
    got = PA.paged_decode_attention(
        q, kp, vp, torch.ones(1, dtype=torch.int32, device=dev), table,
        **quant)
    assert torch.equal(got[0], want)
    got = PA.paged_prefill_attention(q, kp, vp, 0, 1, table[0], **quant)
    assert torch.equal(got[0], want)


#: the float16 B8-B10 cases: the bf16 tensor-core cases and the new
#: blocks' (block, T), with the head dims each covers
F16_SPARSE_CASES = (
    [(c[0], c[1], c[2], c[3], c[4], d) for c in SPARSE_TC_CASES
     for d in (16, 32, 64, 128)]
    + [(f"block{b}-T{t}", b, t, causal, True, d)
       for b, t in NEW_SPARSE_CASES for d in (48, 80, 96, 256)
       for causal in (True, False)])


@pytest.mark.cuda
@pytest.mark.parametrize("name,block,t_len,causal,per_head,d",
                         F16_SPARSE_CASES,
                         ids=[f"{c[0]}-{'c' if c[3] else 'f'}-d{c[5]}"
                              for c in F16_SPARSE_CASES])
def test_cuda_f16_blocksparse_matches_plain(name, block, t_len, causal,
                                            per_head, d):
    """The float16 B8 (o; lse in f32), B9 (dq) and B10 (dk, dv) on the
    tensor cores (``mma_f16`` through ``blocksparse_bwd_mma.cuh``) at every
    head dim and layout block the bf16 cases cover: o within one f16 ulp
    of its plain version (lse 1e-4), dq, dk and dv within two
    (``F16_BWD_TOL``), a planted fault caught, bit-equal on a second
    launch, counted under ``<kernel>_f16``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from deepspeed_tpu_torch.ops import build
    q, k, v, do, _, args = sparse_case(
        block, t_len, d, causal, per_head, torch.float16,
        seed=300 * d + block + t_len + causal,
        empty_kv=name == "empty-kv-tile")
    build.reset_launch_counts()
    o, lse = BS.blocksparse_attention_fwd(q, k, v, *args)
    assert build.launch_counts["blocksparse_flash_fwd_f16"] == 1
    assert build.launch_counts["blocksparse_flash_fwd"] == 0
    o_p, lse_p = BS.blocksparse_attention_fwd_plain(q, k, v, *args)
    assert o.dtype == torch.float16
    f16_close(o, o_p)
    torch.testing.assert_close(lse, lse_p, atol=1e-4, rtol=1e-4)
    o2, lse2 = BS.blocksparse_attention_fwd(q, k, v, *args)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    got, want, again, _ = sparse_outputs(q, k, v, do, args)
    assert build.launch_counts["blocksparse_flash_bwd_dq_f16"] == 2
    assert build.launch_counts["blocksparse_flash_bwd_dkv_f16"] == 2
    for a, b in zip(got, want):
        f16_close(a, b, F16_BWD_TOL)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


# -- remat policies on the card ---------------------------------------------------
#: a remat policy against ``remat="none"`` on the card: each gradient
#: leaf within this fraction of the leaf's largest |gradient| (float32: a
#: reordered sum; bfloat16: two roundings of an activation, 2^-7 each),
#: and the loss within it of its value
REMAT_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("policy", ["full", "dots_saveable", "dots_no_batch",
                                    "nothing_saveable"])
def test_cuda_remat_policy_grads_match_none(policy, dtype):
    """A small GPT-2 (2 layers, d_model 256, T 256, flash) on the card:
    the loss and every gradient under each remat policy equal those
    under ``remat="none"`` within ``REMAT_TOL``.  The policies recompute
    B1 in the backward (its launches double) and feed B2 from the
    recomputed o and lse; the selective ones (``torch.utils.checkpoint``'s
    contexts) must recompute what the kernels write through ``ctypes``,
    never hand back a stale buffer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from deepspeed_tpu_torch.models.transformer import (TransformerLM,
                                                        gpt2_config)
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.runtime.optimizers import tree_leaves
    rs = np.random.RandomState(5)
    batch = {"input_ids": torch.from_numpy(
        rs.randint(0, 4096, (4, 256))).long().cuda()}

    def loss_and_grads(remat):
        cfg = gpt2_config("125m", num_layers=2, d_model=256, num_heads=4,
                          vocab_size=4096, max_seq_len=256, remat=remat,
                          attn_impl="flash", loss_chunk=64, dtype=dtype)
        model = TransformerLM(cfg)
        g = torch.Generator(device="cuda")
        g.manual_seed(0)
        params = model.init(g, "cuda", torch.float32)
        leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
        build.reset_launch_counts()
        loss = model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        return loss.detach(), grads, build.launch_counts["flash_attention_fwd"]
    want, want_g, want_b1 = loss_and_grads("none")
    got, got_g, got_b1 = loss_and_grads(policy)
    assert (want_b1, got_b1) == (2, 4)
    tol = REMAT_TOL[dtype]
    assert abs(float(got) - float(want)) <= tol * abs(float(want))
    for a, b in zip(got_g, want_g):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= tol * float(b.abs().max())


# -- checkpoints on the card ------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("async_save", [False, True])
def test_cuda_save_load_is_bit_equal(async_save, tmp_path):
    """A small GPT-2 (2 layers, d_model 256, T 256) trained on the card
    with LAMB, ``remat="dots_no_batch"`` and fp16 loss scaling: after 2
    steps ``save_checkpoint`` (sync or async) and a fresh engine's
    ``load_checkpoint`` give the saved state bit for bit (tensors back on
    the card), and the next step of both engines is bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the engine runs on it")
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models.transformer import (TransformerLM,
                                                        gpt2_config)
    from deepspeed_tpu_torch.runtime.checkpoint_engine import wait_pending
    cfg = gpt2_config("125m", num_layers=2, d_model=256, num_heads=4,
                      max_seq_len=256, remat="dots_no_batch",
                      attn_impl="flash", loss_chunk=64)
    config = {"train_micro_batch_size_per_gpu": 4,
              "optimizer": {"type": "Lamb", "params": {"lr": 2e-3}},
              "fp16": {"enabled": True, "initial_scale_power": 8},
              "checkpoint": {"async_save": async_save},
              "gradient_clipping": 1.0, "steps_per_print": 0}
    rs = np.random.RandomState(3)
    bs = [{"input_ids": rs.randint(0, cfg.vocab_size, (4, 256))}
          for _ in range(3)]

    def engine(seed):
        return dt.initialize(model=TransformerLM(cfg), config=config,
                             seed=seed)[0]
    a = engine(0)
    for b in bs[:2]:
        a.train_step(b)
    a.save_checkpoint(str(tmp_path))
    wait_pending()
    fresh = engine(1)
    fresh.load_checkpoint(str(tmp_path))

    def leaves(state):
        out = []
        for k in sorted(state):
            v = state[k]
            if isinstance(v, dict):
                out += leaves(v)
            elif isinstance(v, torch.Tensor):
                out.append(v)
            else:
                out += list(v)          # the scaler's fields
        return out
    for x, y in zip(leaves(a.state), leaves(fresh.state)):
        assert x.device == y.device and torch.equal(x, y)
    ma, mf = a.train_step(bs[2]), fresh.train_step(bs[2])
    assert float(ma["loss"]) == float(mf["loss"])
    for x, y in zip(leaves(a.state), leaves(fresh.state)):
        assert torch.equal(x, y)


# -- the model families on the card ------------------------------------------------
#: (family, the model's fields) at 2 layers and each family's published
#: head dim: GPT-NeoX 1.3B's 128 (rotary on a quarter), GPT-J's 256, OPT
#: 6.7B's 128, BLOOM's 128 (ALiBi: no kernel), GPT-Neo 1.3B's 128 (per-layer
#: windows, unscaled softmax: pinned to plain attention)
FAMILY_CASES = {
    "neox": dict(num_heads=4, d_model=512, pos_embedding="rotary",
                 rotary_pct=0.25, rotary_interleaved=False,
                 parallel_residual=True, tie_embeddings=False),
    "gptj": dict(num_heads=2, d_model=512, pos_embedding="rotary",
                 rotary_pct=0.25, rotary_interleaved=True,
                 parallel_residual=True, tie_embeddings=False),
    "opt": dict(num_heads=4, d_model=512, activation="relu", d_ff=1024),
    "bloom": dict(num_heads=4, d_model=512, pos_embedding="alibi",
                  embed_layernorm=True),
    "gptneo": dict(num_heads=4, d_model=512,
                   attention_layers=("global", "local"),
                   local_attention_window=8, attn_softmax_scale=1.0),
}


def _family_engines(family, dtype, serving=None):
    """The family's model on the card through ``init_inference`` with
    kernel injection and without, on the same seeded weights."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models.transformer import (TransformerConfig,
                                                        TransformerLM)
    cfg = TransformerConfig(num_layers=2, vocab_size=512, max_seq_len=128,
                            **FAMILY_CASES[family])
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    params = TransformerLM(cfg).init(g, "cuda", torch.float32)
    base = {"dtype": dtype, "max_out_tokens": 128, "temperature": 0.0}
    if serving:
        base["serving"] = serving
    return [dt.init_inference(TransformerLM(cfg), {
        **base, "replace_with_kernel_inject": inject}, params=params)
        for inject in (True, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(FAMILY_CASES))
def test_cuda_family_kernels_match_plain_model(family):
    """Each decoder family at 2 layers and its published head dim on the
    card, float32: ``forward()`` through the injected model (B1, but for
    ALiBi and GPT-Neo's windows, which stay on plain attention as in the
    JAX model) against the same weights on plain attention, logits within
    1e-4; greedy ``generate()`` (B5 decode) token for token.  GPT-J's head
    dim of 256 has no f32 B5 (ROADMAP C1's remainder), so its
    ``generate()`` runs in bf16 against plain attention in bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from deepspeed_tpu_torch.ops import build
    kern, plain = _family_engines(family, "float32")
    want_impl = "xla" if family == "gptneo" else "flash"
    assert kern.module.config.attn_impl == want_impl
    assert plain.module.config.attn_impl == "xla"
    rs = np.random.RandomState(1)
    x = rs.randint(0, 512, (2, 48))
    build.reset_launch_counts()
    got = kern.forward(x)
    torch.cuda.synchronize()
    b1 = build.launch_counts["flash_attention_fwd"]
    assert b1 == (2 if family in ("neox", "gptj", "opt") else 0)
    torch.testing.assert_close(got, plain.forward(x), atol=1e-4, rtol=1e-4)
    prompts = rs.randint(0, 512, (2, 20))
    if family == "gptj":
        kern, plain = _family_engines(family, "bfloat16")
    build.reset_launch_counts()
    toks = kern.generate(prompts, max_new_tokens=8)
    torch.cuda.synchronize()
    b5 = sum(n for name, n in build.launch_counts.items()
             if name.startswith("decode_attention"))
    assert b5 == (2 * 7 if family in ("neox", "gptj", "opt") else 0)
    assert torch.equal(toks, plain.generate(prompts, max_new_tokens=8))


@pytest.mark.cuda
def test_cuda_neox_server_streams_match_generate():
    """GPT-NeoX (2 layers, 4 heads of 128, partial rotate-half rotary,
    parallel residual) served on the card in float32: B6/B7 over the
    pool, every greedy stream equal to ``generate()``'s."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from deepspeed_tpu_torch.ops import build
    eng, _ = _family_engines("neox", "float32", serving={
        "enabled": True, "kv_block_size": 16, "num_kv_blocks": 64,
        "max_batch_slots": 4, "prefill_chunk_tokens": 32})
    srv = eng.serving_engine()
    rs = np.random.RandomState(2)
    prompts = [rs.randint(0, 512, n).tolist() for n in (7, 40, 19, 66, 3)]
    build.reset_launch_counts()
    reqs = [srv.submit(p, max_new_tokens=10) for p in prompts]
    assert len(srv.run(max_steps=500)) == len(prompts)
    assert build.launch_counts["paged_decode_attention"] > 0
    assert build.launch_counts["paged_prefill_attention"] > 0
    for p, r in zip(prompts, reqs):
        assert r.output == eng.generate([p], max_new_tokens=10)[0].tolist()


def _bert_model(attn_impl):
    from deepspeed_tpu_torch.models.transformer import (TransformerConfig,
                                                        TransformerLM)
    return TransformerLM(TransformerConfig(
        num_layers=2, num_heads=4, d_model=256, d_ff=512, vocab_size=512,
        max_seq_len=128, causal=False, norm_position="post",
        final_layernorm=False, embed_layernorm=True, token_type_vocab=2,
        mlm_head=True, activation="gelu_exact", attn_impl=attn_impl,
        dtype=torch.float32))


@pytest.mark.cuda
def test_cuda_bert_forward_on_noncausal_b1_matches_plain():
    """BERT (post-norm encoder, token types, MLM head, 4 heads of 64) on
    the card in float32: ``forward()`` through the non-causal B1 against
    plain attention on the same weights, within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.ops import build
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    params = _bert_model("xla").init(g, "cuda", torch.float32)
    cfg = {"dtype": "float32"}
    kern = dt.init_inference(_bert_model("flash"), cfg, params=params)
    plain = dt.init_inference(_bert_model("flash"), {
        **cfg, "replace_with_kernel_inject": False}, params=params)
    rs = np.random.RandomState(3)
    x, types = rs.randint(0, 512, (2, 100)), rs.randint(0, 2, (2, 100))
    build.reset_launch_counts()
    got = kern.forward(x, token_type_ids=types)
    torch.cuda.synchronize()
    assert build.launch_counts["flash_attention_fwd"] == 2
    torch.testing.assert_close(got, plain.forward(x, token_type_ids=types),
                               atol=1e-4, rtol=1e-4)
    with pytest.raises(NotImplementedError, match="non-causal"):
        kern.generate(x, max_new_tokens=2)


@pytest.mark.cuda
def test_cuda_bert_train_step_on_noncausal_b2_matches_plain():
    """BERT's float32 loss and gradients through the non-causal B1/B2
    against plain attention on the same weights (every leaf within 1e-4
    of its largest gradient), then one engine training step (AdamW,
    clipping) of each from the same seed: loss and grad norm within
    1e-4.  The parameters after the step are not compared: Adam's first
    update is about lr x sign(g), so a gradient element at rounding
    level moves its parameter by up to 2 lr either way."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.runtime.optimizers import tree_leaves
    ids = np.random.RandomState(4).randint(0, 512, (4, 96))
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    params = _bert_model("xla").init(g, "cuda", torch.float32)
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    grads = {}
    for impl in ("flash", "xla"):
        build.reset_launch_counts()
        loss = _bert_model(impl).loss(
            params, {"input_ids": torch.from_numpy(ids).cuda()})
        grads[impl] = (loss.detach(), torch.autograd.grad(loss, leaves))
        torch.cuda.synchronize()
        assert build.launch_counts["flash_attention_bwd"] == (
            2 if impl == "flash" else 0)
    (lf, gf), (lx, gx) = grads["flash"], grads["xla"]
    assert abs(float(lf) - float(lx)) <= 1e-4 * abs(float(lx))
    for a, b in zip(gf, gx):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    config = {"train_micro_batch_size_per_gpu": 4,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
              "gradient_clipping": 1.0, "steps_per_print": 0}
    out = {}
    for impl in ("flash", "xla"):
        eng = dt.initialize(model=_bert_model(impl), config=dict(config),
                            seed=0)[0]
        m = eng.train_step({"input_ids": ids})
        out[impl] = float(m["loss"]), float(m["grad_norm"])
    (lf, nf), (lx, nx) = out["flash"], out["xla"]
    assert abs(lf - lx) <= 1e-4 * abs(lx)
    assert abs(nf - nx) <= 1e-4 * abs(nx)


# -- Mixture-of-Experts and Stable Diffusion --------------------------------
def _moe_model(attn_impl="flash", **kw):
    from deepspeed_tpu_torch.models.transformer import (TransformerLM,
                                                        gpt2_config)
    return TransformerLM(gpt2_config(
        "125m", num_layers=4, num_heads=4, d_model=256, vocab_size=512,
        max_seq_len=128, dtype=torch.float32, attn_impl=attn_impl,
        moe_num_experts=8, moe_capacity_factor=0.5,
        moe_eval_capacity_factor=1.0, moe_min_capacity=2, **kw))


def _to(tree, dev):
    return {k: (_to(v, dev) if isinstance(v, dict) else v.to(dev))
            for k, v in tree.items()}


@pytest.mark.cuda
def test_cuda_moe_model_matches_cpu():
    """A small MoE model (4 layers, 8 experts on every other, f32): on
    the card (B1, B5, B2) against the same weights on the CPU (their
    plain versions): ``forward()`` logits within 1e-4, exp_counts equal,
    greedy ``generate()`` token for token, the train loss and its
    gradients within 1e-4 of their scale (the gate's f32 product: TF32
    stays off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.runtime.optimizers import tree_leaves
    assert not torch.backends.cuda.matmul.allow_tf32
    params = _moe_model().init(torch.Generator().manual_seed(0), "cpu")
    cfg = {"dtype": "float32", "temperature": 0.0, "max_out_tokens": 128,
           "moe": {"enabled": True}}
    card = dt.init_inference(_moe_model(), cfg, params=params)
    cpu = dt.init_inference(_moe_model(), cfg, params=params, device="cpu")
    rs = np.random.RandomState(3)
    x = rs.randint(0, 512, (2, 40))
    build.reset_launch_counts()
    got = card.forward(x)
    torch.cuda.synchronize()
    assert build.launch_counts["flash_attention_fwd"] == 4
    torch.testing.assert_close(got.cpu(), cpu.forward(x), atol=1e-4,
                               rtol=1e-4)
    for (a, ka, _), (b, kb, _) in zip(card.module.moe_stats,
                                      cpu.module.moe_stats):
        assert torch.equal(a.cpu(), b) and int(ka) == int(kb)
    prompts = rs.randint(0, 512, (2, 16))
    build.reset_launch_counts()
    toks = card.generate(prompts, max_new_tokens=8)
    assert build.launch_counts["decode_attention"] == 4 * 7
    assert torch.equal(toks.cpu(), cpu.generate(prompts, max_new_tokens=8))
    ids = torch.from_numpy(rs.randint(0, 512, (2, 64)))
    out = {}
    for dev in ("cuda", "cpu"):
        p = _to(params, dev)
        leaves = [t.requires_grad_(True) for t in tree_leaves(p)]
        loss = _moe_model().loss(p, {"input_ids": ids.to(dev)})
        out[dev] = (float(loss.detach()), [g.cpu() for g in torch.autograd.grad(
            loss, leaves)])
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-4 * abs(out["cpu"][0])
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        assert float((a - b).abs().max()) <= 1e-4 * max(
            float(b.abs().max()), 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("k,kind", [(1, "rts"), (1, "rsample"), (2, "top2")])
def test_cuda_moe_routing_equals_cpu(k, kind):
    """The gate on the card routes exactly as on the CPU from the same
    logits and the same noise (drawn on the CPU, passed in): experts,
    slots, kept tokens, exp_counts; weights within 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from deepspeed_tpu_torch.moe import sharded_moe as moe
    rs = np.random.RandomState(7)
    logits = torch.from_numpy(rs.randn(4096, 64).astype(np.float32))
    logits[:, 3] += 1.5
    noise = moe.draw_noise(torch.Generator().manual_seed(1), 4096, 64, k,
                           "RSample" if kind == "rsample" else None, True)
    out = []
    for dev in ("cpu", "cuda"):
        nz = moe.GateNoise(*(None if t is None else t.to(dev)
                             for t in noise))
        out.append(moe.route(logits.to(dev), k, 1.0, 4,
                             noisy_gate_policy="RSample"
                             if kind == "rsample" else None,
                             use_rts=kind == "rts", noise=nz))
    a, b = out
    for f in ("expert", "slot", "kept", "exp_counts"):
        assert torch.equal(getattr(a, f), getattr(b, f).cpu()), f
    torch.testing.assert_close(a.weight, b.weight.cpu(), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.cuda
def test_cuda_moe_remat_routes_the_same_tokens():
    """RTS and RSample under one seed on the card: ``remat="full"``'s
    recomputed forward routes as ``remat="none"`` (noise drawn outside
    the checkpoint): equal routing and loss, gradients within 1e-5 of
    their scale."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from deepspeed_tpu_torch.runtime.optimizers import tree_leaves
    params = _moe_model().init(torch.Generator().manual_seed(1), "cpu")
    ids = torch.from_numpy(np.random.RandomState(5).randint(0, 512, (2, 64)))
    out = {}
    for remat in ("none", "full"):
        m = _moe_model(remat=remat, moe_noisy_gate_policy="RSample")
        p = _to(params, "cuda")
        leaves = [t.requires_grad_(True) for t in tree_leaves(p)]
        loss = m.loss(p, {"input_ids": ids.cuda(), "moe_rng": 3})
        grads = torch.autograd.grad(loss, leaves)
        out[remat] = (float(loss), grads,
                      [(c.tolist(), int(kk)) for c, kk, _ in m.moe_stats])
    assert out["none"][2] == out["full"][2]
    assert out["none"][0] == out["full"][0]
    for a, b in zip(out["none"][1], out["full"][1]):
        assert float((a - b).abs().max()) <= 1e-5 * max(
            float(b.abs().max()), 1e-6)


@pytest.mark.cuda
def test_cuda_moe_server_refused_and_ep_size_named():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import deepspeed_tpu_torch as dt
    eng = dt.init_inference(_moe_model(), {
        "dtype": "float32", "serving": {"enabled": True}})
    with pytest.raises(NotImplementedError, match="MoE block stacks"):
        eng.serving_engine()
    with pytest.raises(NotImplementedError, match="queue A item 7"):
        dt.init_inference(_moe_model(), {"moe": {"enabled": True,
                                                 "ep_size": 2}})


_TINY_UNET = dict(block_out_channels=(32, 64), layers_per_block=1,
                  cross_attention_dim=24, attention_head_dim=2,
                  down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                  up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
                  norm_num_groups=8, sample_size=16)


@pytest.mark.cuda
def test_cuda_unet_and_vae_match_cpu():
    """A narrow UNet and VAE on the card (cuDNN convolutions on
    channels-last weights prepared once, TF32 off) against the CPU in
    float32: eps and the decoded image within 1e-4 of their scale; the
    bf16 pipeline on the card gives a finite image in [0, 1]."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import diffusion as D
    unet = D.UNet2DCondition(D.UNetConfig(**_TINY_UNET))
    vae = D.AutoencoderKL(D.VAEConfig(block_out_channels=(16, 32),
                                      layers_per_block=1, norm_num_groups=8))
    up = unet.init(torch.Generator().manual_seed(0))
    vp = vae.init(torch.Generator().manual_seed(1))
    rs = np.random.RandomState(2)
    x = torch.from_numpy(rs.randn(2, 16, 16, 4).astype(np.float32))
    ctx = torch.from_numpy(rs.randn(2, 7, 24).astype(np.float32))
    t = torch.tensor([10, 900])
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        dev = torch.device("cuda")
        want = unet.apply(up, x, t, ctx)
        got = unet.apply(D.prepare(up, dev, torch.float32), x.to(dev),
                         t.to(dev), ctx.to(dev)).cpu()
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-4 * scale
        img = vae.decode(vp, x[:1])
        got = vae.decode(D.prepare(vp, dev, torch.float32),
                         x[:1].to(dev)).cpu()
        assert float((got - img).abs().max()) <= 1e-4 * float(
            img.abs().max())
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = flags
    pipe, params = dt.init_diffusion(
        D.UNetConfig(**_TINY_UNET),
        D.VAEConfig(block_out_channels=(16, 32), layers_per_block=1,
                    norm_num_groups=8),
        D.CLIPTextConfig(vocab_size=64, hidden_size=24, intermediate_size=48,
                         num_hidden_layers=2, num_attention_heads=2,
                         max_position_embeddings=8),
        dtype=torch.bfloat16)
    assert pipe.device.type == "cuda"
    assert params["unet"]["conv_in"]["weight"].is_contiguous(
        memory_format=torch.channels_last)
    ids = np.array([[1, 2, 3, 4, 5, 6, 7, 8]])
    img = pipe(params, ids, np.zeros_like(ids), num_steps=3)
    assert tuple(img.shape) == (1, 32, 32, 3)
    assert bool(img.isfinite().all())
    assert 0.0 <= float(img.min()) and float(img.max()) <= 1.0


def _spec_models(dtype):
    """Target (2 layers, 4 heads of 128) and draft (1 layer, 2 heads of
    64) GPT-2 shaped over vocab 512, seeded weights on the card."""
    from deepspeed_tpu_torch.models.transformer import (TransformerLM,
                                                        gpt2_config)
    tm = TransformerLM(gpt2_config("125m", num_layers=2, d_model=512,
                                   num_heads=4, vocab_size=512,
                                   max_seq_len=256, dtype=dtype))
    dm = TransformerLM(gpt2_config("125m", num_layers=1, d_model=128,
                                   num_heads=2, vocab_size=512,
                                   max_seq_len=256, dtype=dtype))
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return tm, tm.init(g, "cuda", dtype), dm, dm.init(g, "cuda", dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_bits", [0, 8, 4])
def test_cuda_spec_lane_matches_plain_versions(dtype, kv_bits):
    """The mixed step with a spec lane (2 verifying slots of 4 rows, a
    plain decode slot, an 11-token chunk) on the card against the same
    step with B6/B7's plain versions patched into the model, on the same
    pools: decode, spec and chunk logits within 1e-4 of max|logit| in
    float32 (bf16: 2e-2, the cast of every activation), and B6 launched
    exactly once a layer for the decode lane plus once a layer per spec
    depth (4), B7 once a layer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from deepspeed_tpu_torch.models import transformer as tt
    from deepspeed_tpu_torch.ops import build
    dt_ = getattr(torch, dtype)
    tm, tp, _, _ = _spec_models(dt_)
    dev = torch.device("cuda")
    rng = np.random.default_rng(kv_bits)
    nslots, npages, S = 4, 8, 4
    tables = torch.tensor([[4, 9, 2, 0, 0, 0, 0, 0], [7, 11, 0, 0, 0, 0, 0, 0],
                           [3, 15, 16, 0, 0, 0, 0, 0],
                           [5, 6, 0, 0, 0, 0, 0, 0]],
                          dtype=torch.int32, device=dev)
    lens = torch.tensor([37, 20, 30, 0], dtype=torch.int32, device=dev)
    base = tm.init_paged_cache(24, 16, kv_bits=kv_bits, device=dev)
    for key, pool in base.items():
        if pool.dtype == torch.int8:
            pool.copy_(torch.from_numpy(rng.integers(
                -127, 128, tuple(pool.shape)).astype(np.int8)))
        elif key.endswith("scale"):
            pool.copy_(torch.from_numpy(rng.uniform(
                0.002, 0.02, tuple(pool.shape)).astype(np.float32)))
        else:
            pool.copy_(torch.from_numpy(rng.standard_normal(
                tuple(pool.shape)).astype(np.float32)))
    ids = lambda *shape: torch.from_numpy(rng.integers(
        0, 512, shape).astype(np.int32)).to(dev)
    dec, spec, chunk = ids(nslots), ids(nslots, S), ids(16)
    dec_active = torch.tensor([0, 1, 0, 0], dtype=torch.int32, device=dev)
    spec_active = torch.tensor([1, 0, 1, 0], dtype=torch.int32, device=dev)

    def run():
        cache = {k: v.clone() for k, v in base.items()}
        return tm._apply_paged_mixed(
            tp, {**cache, "block_tables": tables, "lens": lens}, dec,
            dec_active, chunk, 3, 0, 11, spec_tokens=spec,
            spec_active=spec_active)
    build.reset_launch_counts()
    got = run()
    torch.cuda.synchronize()
    counts = dict(build.launch_counts)
    b6 = build.counter("paged_decode_attention", kv_bits, dt_)
    b7 = build.counter("paged_prefill_attention", kv_bits, dt_)
    assert counts[b6] == 2 * (1 + S) and counts[b7] == 2
    real = (tt.paged_decode_attention, tt.paged_prefill_attention)
    from deepspeed_tpu_torch.ops.transformer import (
        paged_decode_attention as PAm)
    tt.paged_decode_attention = PAm.paged_decode_attention_plain
    tt.paged_prefill_attention = PAm.paged_prefill_attention_plain
    try:
        want = run()
    finally:
        tt.paged_decode_attention, tt.paged_prefill_attention = real
    rel = 1e-4 if dt_ == torch.float32 else 2e-2
    for rows, ref in ((got[0][dec_active > 0], want[0][dec_active > 0]),
                      (got[1][spec_active > 0], want[1][spec_active > 0]),
                      (got[2], want[2])):
        scale = float(ref.float().abs().max())
        assert float((rows.float() - ref.float()).abs().max()) <= rel * scale


@pytest.mark.cuda
@pytest.mark.parametrize("self_draft", [False, True])
def test_cuda_spec_server_streams_and_launches(self_draft):
    """The float32 spec server on the card (spec_k 3; a 1-layer draft, or
    the target as its own draft) against the plain server on the same
    weights: equal greedy streams, every proposal the self-draft rejects
    at a near tie of the target's logits there (within 1e-3 of
    max|logit|: the draft's rows meet other GEMM shapes than the
    target's, so f32 rounding may flip a tie), and B6/B7 launched
    exactly as the dispatch log says:
    target layers x (a decode lane + 4 x a spec lane) B6 and x a chunk
    B7; draft layers x (feed 0 + 3 x a spec lane) B6 and x a chunk B7."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.ops import build
    tm, tp, dm, dp = _spec_models(torch.float32)
    cfg = {"dtype": "float32", "max_out_tokens": 256, "temperature": 0.0,
           "serving": {"enabled": True, "kv_block_size": 16,
                       "num_kv_blocks": 96, "max_batch_slots": 4,
                       "prefill_chunk_tokens": 32, "spec_k": 3}}
    rs = np.random.RandomState(2)
    prompts = [rs.randint(0, 512, n).tolist() for n in (7, 40, 19, 66, 3)]
    plain = dt.init_inference(tm, cfg, params=tp).serving_engine()
    want = [plain.submit(p, max_new_tokens=12) for p in prompts]
    plain.run()
    eng = dt.init_inference(tm, cfg, params=tp)
    srv = (eng.serving_engine(draft_model=eng.module, draft_params=eng.params)
           if self_draft else eng.serving_engine(draft_model=dm,
                                                 draft_params=dp))
    log, rejected = [], []
    dispatch, propose = srv._dispatch, srv._draft_propose

    def proposing(*args):
        out = propose(*args)
        props.append(out)
        return out

    def logged(dec, chunk, spec=()):
        before = [(r, len(r.output)) for _, r in spec]
        props.clear()
        out = dispatch(dec, chunk, spec)
        if out is not None:
            log.append((bool(dec), bool(spec), chunk is not None))
            for (slot, _), (r, n0) in zip(spec, before):
                n = len(r.output) - n0
                if 0 < n < 4 and len(r.output) < r.max_new_tokens:
                    rejected.append((r, n0 + n - 1,
                                     int(props[0][slot, n]),
                                     r.output[n0 + n - 1]))
        return out
    props = []
    srv._dispatch, srv._draft_propose = logged, proposing
    build.reset_launch_counts()
    got = [srv.submit(p, max_new_tokens=12) for p in prompts]
    srv.run()
    torch.cuda.synchronize()
    assert [r.output for r in got] == [r.output for r in want]
    if self_draft:
        assert srv.spec_counts["accepted"] > 0
        for r, pos, d, t in rejected:
            lg = eng.forward([list(r.prompt) + r.output[:pos]])[0, -1]
            gap = float(lg[t] - lg[d]) / float(lg.abs().max())
            assert gap <= 1e-3, (r.req_id, pos, gap)
    lt, ld = 2, (2 if self_draft else 1)
    n_dec = sum(d for d, _, _ in log)
    n_spec = sum(s for _, s, _ in log)
    n_any = sum(d or s for d, s, _ in log)
    n_chunk = sum(c for _, _, c in log)
    assert build.launch_counts["paged_decode_attention"] == \
        lt * (n_dec + 4 * n_spec) + ld * (n_any + 3 * n_spec)
    assert build.launch_counts["paged_prefill_attention"] == \
        (lt + ld) * n_chunk
    assert srv.allocator.num_used == 0


# -- the tiered host cache and the fleet on the card ----------------------------
def _host_engine(dtype, kv_bits=0, host_cache=None, fleet=None,
                 num_kv_blocks=40):
    """The spec tests' 2-layer target (4 heads of 128, vocab 512) as an
    engine on the card: 16-token blocks, 4 slots, chunk 64."""
    import deepspeed_tpu_torch as dt
    tm, tp, _, _ = _spec_models(getattr(torch, dtype))
    serving = {"enabled": True, "kv_block_size": 16,
               "num_kv_blocks": num_kv_blocks, "max_batch_slots": 4,
               "prefill_chunk_tokens": 64, "kv_cache_bits": kv_bits}
    if host_cache is not None:
        serving["host_cache"] = host_cache
    if fleet is not None:
        serving["fleet"] = fleet
    return dt.init_inference(tm, {"dtype": dtype, "max_out_tokens": 256,
                                  "temperature": 0.0, "serving": serving},
                             params=tp)


@pytest.mark.cuda
def test_cuda_block_gather_scatter_round_trip():
    """``_gather_block`` reads one pool block of every layer to the host
    (``pool[:, b]``, strided across layers) and ``_scatter_block`` writes
    it back in place on the current stream: another block receives the
    same bytes, the blocks around it keep theirs (bf16 pool and the int8
    pool with its scale planes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    for kv_bits in (0, 8):
        srv = _host_engine("bfloat16", kv_bits).serving_engine()
        g = torch.Generator(device="cuda")
        g.manual_seed(kv_bits)
        pools = srv._block_pools()
        for pool in pools:
            if pool.dtype == torch.int8:
                pool.copy_(torch.randint(-127, 128, pool.shape, generator=g,
                                         device="cuda", dtype=torch.int8))
            else:
                pool.copy_(torch.rand(pool.shape, generator=g,
                                      device="cuda").to(pool.dtype))
        before = [p.clone() for p in pools]
        parts = srv._gather_block(5)
        assert all(t.device.type == "cpu" for t in parts)
        srv._scatter_block(9, parts)
        torch.cuda.synchronize()
        for pool, old in zip(pools, before):
            assert torch.equal(pool[:, 9], old[:, 5])
            keep = [b for b in range(pool.shape[1]) if b != 9]
            assert torch.equal(pool[:, keep], old[:, keep])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,kv_bits,wire", [
    ("bfloat16", 0, 0), ("bfloat16", 8, 8), ("float32", 0, 0),
    ("bfloat16", 0, 8)])
def test_cuda_host_tier_spill_promote(dtype, kv_bits, wire, tmp_path):
    """Phase 26 of ``chip_smoke.py`` at a small width, DRAM and NVMe: a
    64-token prefix served, evicted by fillers (spilled into the host
    tier) and hit again.  Lossless tiers (wire 0, kv_bits 8) give the HBM
    hit's stream exactly and promoted blocks equal to the bytes gathered
    at their spill; wire 8 on a bf16 pool gives first logits within 5 %
    of max|logit|.  B7 runs the tail alone: 2 layers x 1 chunk."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from deepspeed_tpu_torch.inference.serving.block_allocator import (
        ROOT_HASH, _chain_hash)
    from deepspeed_tpu_torch.ops import build
    rs = np.random.RandomState(26)
    P = rs.randint(0, 512, 64).tolist()
    A, B = P + rs.randint(0, 512, 10).tolist(), P + rs.randint(
        0, 512, 10).tolist()
    digests, h = [], ROOT_HASH
    for i in range(4):
        h = _chain_hash(h, tuple(P[16 * i:16 * (i + 1)]))
        digests.append(h)

    def serve(srv, first=None):
        mixed = srv.model._apply_paged_mixed

        def rec(params, cache, dec, act, chunk_ids, slot, start, n, **kw):
            out = mixed(params, cache, dec, act, chunk_ids, slot, start, n,
                        **kw)
            if n and start + n == len(B) and first is not None:
                first.append(out[1].float().cpu())
            return out
        srv.model._apply_paged_mixed = rec
        try:
            build.reset_launch_counts()
            r = srv.submit(B, max_new_tokens=12)
            srv.run()
            torch.cuda.synchronize()
        finally:
            srv.model._apply_paged_mixed = mixed
        return r, dict(build.launch_counts)
    ref_first = []
    hbm = _host_engine(dtype, kv_bits).serving_engine()
    hbm.submit(A, max_new_tokens=12)
    hbm.run()
    want, _ = serve(hbm, ref_first)
    for tier in ("dram", "nvme"):
        hc = {"enabled": True, "wire_bits": wire}
        if tier == "dram":
            hc["dram_budget_bytes"] = 1 << 26
        else:
            hc.update(nvme_budget_bytes=1 << 26,
                      nvme_path=str(tmp_path / "nvme"))
        srv = _host_engine(dtype, kv_bits, hc, num_kv_blocks=16
                           ).serving_engine()
        srv.submit(A, max_new_tokens=12)
        srv.run()
        saved, real = {}, srv.allocator._spill_fn

        def spilling(block, digest):
            if digest in digests:
                saved[digest] = [t.clone()
                                 for t in srv._gather_block(block)]
            real(block, digest)
        srv.allocator._spill_fn = spilling
        rs2 = np.random.RandomState(1)
        while any(d in srv.allocator._hash_to_block for d in digests):
            for _ in range(2):
                srv.submit(rs2.randint(0, 512, 100).tolist(),
                           max_new_tokens=1)
            srv.run()
        assert all(srv.host_cache.contains(d) for d in digests)
        first = []
        got, counts = serve(srv, first)
        b7 = build.counter("paged_prefill_attention", kv_bits,
                           getattr(torch, dtype))
        assert counts[b7] == 2, counts[b7]
        assert srv.host_counts["promoted_blocks"] == 4
        assert srv.host_cache.hits_total[tier] == 4
        srv.allocator.assert_consistent()
        if wire == 0 or kv_bits:
            assert got.output == want.output
            for d in digests:
                now = srv._gather_block(srv.allocator._hash_to_block[d])
                assert all(torch.equal(a, b) for a, b in zip(now, saved[d]))
        else:
            scale = float(ref_first[0].abs().max())
            assert float((first[0] - ref_first[0]).abs().max()) \
                <= 0.05 * scale
        srv.host_cache.close()


def _fleet_wave():
    rs = np.random.RandomState(27)
    prefix = rs.randint(0, 512, 48).tolist()
    return ([rs.randint(0, 512, n).tolist() for n in (5, 40, 19, 66, 23, 9)]
            + [prefix + rs.randint(0, 512, n).tolist() for n in (3, 17, 30)])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["uniform", "failover", "disagg"])
def test_cuda_fleet_streams_exactly_once(mode):
    """Phase 27 of ``chip_smoke.py`` at a small width in float32: a fleet
    of 2 (or 1 prefill + 1 decode) replicas over one host tier at wire 0,
    every stream delivered exactly once and equal to one server's; in
    ``failover`` r1 dies mid-drain and its requests replay token-exact;
    in ``disagg`` every fabric entry is promoted or dropped as redundant
    and none is orphaned.  B6/B7 launches summed over the replicas are
    exact against the mixed steps' lanes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from deepspeed_tpu_torch.inference.serving import (FleetRouter,
                                                       StreamCollector)
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.runtime.resilience import (
        FaultInjector, install_fault_injector)
    prompts = _fleet_wave()
    single = _host_engine("float32", num_kv_blocks=96).serving_engine()
    want = [single.submit(p, max_new_tokens=12) for p in prompts]
    single.run()
    fleet_kw = {"enabled": True, "replicas": 2}
    if mode == "disagg":
        fleet_kw["prefill_replicas"] = 1
    eng = _host_engine("float32", host_cache={
        "enabled": True, "wire_bits": 0, "dram_budget_bytes": 1 << 28},
        fleet=fleet_kw, num_kv_blocks=96)
    fleet = FleetRouter.from_engine(eng)
    model = eng.module
    mixed = model._apply_paged_mixed
    lanes = [0, 0]

    def counted(params, cache, dec, act, chunk_ids, *rest, **kw):
        lanes[0] += int(dec.shape[0] > 0)
        lanes[1] += int(chunk_ids.shape[0] > 0)
        return mixed(params, cache, dec, act, chunk_ids, *rest, **kw)
    model._apply_paged_mixed = counted
    fi = install_fault_injector(FaultInjector())
    try:
        build.reset_launch_counts()
        cols = [StreamCollector() for _ in prompts]
        reqs = [fleet.submit(p, max_new_tokens=12, on_token=c)
                for p, c in zip(prompts, cols)]
        if mode == "failover":
            r1 = fleet.replica("r1")
            while not any(f.replica is r1 and f.deduper.high_water
                          for f in reqs):
                fleet.pump()
            fi.add_plan("serving.fleet.replica_step", "fatal",
                        at=fi.calls.get("serving.fleet.replica_step", 0) + 2)
        fleet.run()
        torch.cuda.synchronize()
    finally:
        model._apply_paged_mixed = mixed
        install_fault_injector(FaultInjector())
    assert [f.output for f in reqs] == [r.output for r in want]
    for f, c in zip(reqs, cols):
        assert c.tokens == f.output and c.finished
        assert [e.index for e in c.events if e.token is not None] == \
            list(range(12))
    assert build.launch_counts["paged_decode_attention"] == 2 * lanes[0]
    assert build.launch_counts["paged_prefill_attention"] == 2 * lanes[1]
    if mode == "failover":
        assert fleet.fleet_counts["dead_replicas"] == 1
        assert fleet.fleet_counts["replayed_tokens"] > 0
    if mode == "disagg":
        assert fleet.fleet_counts["handoffs"] > 0
        assert fleet.reap_orphans() == 0
        d0 = fleet.replica("d0").srv
        assert d0.host_counts["promoted_blocks"] > 0


# -- the offload tiers (ZeRO-Offload, ZeRO-Infinity, host_offload remat) -----
def _offload_model(**kw):
    from deepspeed_tpu_torch.models.transformer import (TransformerConfig,
                                                        TransformerLM)
    return TransformerLM(TransformerConfig(**{
        "vocab_size": 256, "max_seq_len": 128, "num_layers": 3,
        "num_heads": 2, "d_model": 128, "loss_chunk": 0,
        "attn_impl": "flash", "dtype": torch.bfloat16, **kw}))


def _offload_cfg(zero=None, clip=0.0, lr=1e-3):
    cfg = {"train_micro_batch_size_per_gpu": 4,
           "gradient_accumulation_steps": 1,
           "optimizer": {"type": "AdamW", "params": {"lr": lr}},
           "bf16": {"enabled": True}, "gradient_clipping": clip,
           "steps_per_print": 0}
    if zero:
        cfg["zero_optimization"] = zero
    return cfg


def _tree_clone(tree):
    return {k: _tree_clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


@pytest.mark.cuda
def test_cuda_native_adam_on_card_grads_matches_plain():
    """Gradients made on the card and fetched through the offload wire's
    pinned buffers (the host reads them after the copy's event) step the
    native host Adam within 1e-6 of its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from deepspeed_tpu_torch.ops.adam.cpu_adam import DeepSpeedCPUAdam
    from deepspeed_tpu_torch.runtime.zero.offload import Transfers
    dev = torch.device("cuda")
    tr = Transfers(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn(1 << 20, generator=g, device=dev)
    masters = [torch.randn(1 << 20, generator=g, device=dev).cpu().numpy()]
    native = DeepSpeedCPUAdam(masters, lr=1e-2, weight_decay=0.1)
    plain = DeepSpeedCPUAdam(masters, lr=1e-2, weight_decay=0.1,
                             impl="plain")
    for step in range(3):
        grad = torch.sin(w * (step + 1)) * 3.0          # made on the card
        buf = tr.buffer("grad", 0, grad.numel(), torch.float32)
        tr.after_compute()
        ev = tr.to_host(buf, grad)
        tr.wait(ev)
        np.testing.assert_array_equal(buf.numpy(), grad.cpu().numpy())
        native.step([buf.numpy()], grad_scale=2.0)
        plain.step([buf.numpy()], grad_scale=2.0)
    for a, b in zip(native.state_arrays()["master"],
                    plain.state_arrays()["master"]):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6)


@pytest.mark.cuda
def test_cuda_tiny_infinity_matches_in_hbm():
    """A tiny ZeRO-Infinity engine on the card (3 layers, d_model 128, 2
    heads of 64, T 128) against the in-HBM engine from the same params,
    3 steps: losses within 5e-3, grad norms within 5 % (the JAX tests'
    bounds); B1 twice and B2 once a layer a step, exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.ops import build
    dev = torch.device("cuda")
    params = _offload_model().init_streamed(0, dev, torch.float32)
    zero = {"stage": 3, "offload_param": {"device": "cpu"},
            "offload_optimizer": {"device": "cpu"}}
    inf, _, _, _ = dt.initialize(model=_offload_model(),
                                 config=_offload_cfg(zero),
                                 params=_tree_clone(params))
    base, _, _, _ = dt.initialize(model=_offload_model(),
                                  config=_offload_cfg(), params=params)
    rs = np.random.RandomState(0)
    batch = {"input_ids": rs.randint(0, 256, (4, 128)).astype(np.int32)}
    for _ in range(3):
        build.reset_launch_counts()
        a = inf.train_step(batch)
        counts = dict(build.launch_counts)
        b = base.train_step(batch)
        assert counts["flash_attention_fwd"] == 6
        assert counts["flash_attention_bwd"] == 3
        assert abs(float(a["loss"]) - float(b["loss"])) < 5e-3
        assert abs(float(a["grad_norm"]) - float(b["grad_norm"])) < \
            5e-2 * max(1.0, float(b["grad_norm"]))
    inf._infinity.close()


@pytest.mark.cuda
@pytest.mark.parametrize("planted", [False, True],
                         ids=["waits", "planted-early-reuse"])
def test_cuda_pinned_buffer_reuse_waits_on_its_event(planted, monkeypatch):
    """The pipelined sweep refills a pinned buffer only after its copy's
    event: with every copy held back on the side stream (a spin before
    each), the updated params on the card equal the host masters' bf16
    copies.  With the wait planted out, the host refills and reads the
    ring under copies still in flight, and the result must differ."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    from deepspeed_tpu_torch.runtime.zero import offload as OF
    dev = torch.device("cuda")

    class Eng:
        _config = DeepSpeedConfig({"train_batch_size": 1, "optimizer": {
            "type": "AdamW", "params": {"lr": 1e-2}}})
        device = dev
    g = torch.Generator(device=dev).manual_seed(0)
    leaves = [torch.randn(n, generator=g, device=dev)
              for n in (300_000, 500_000, 200_000)]
    host = OF.ZeroOffloadHostOptimizer(Eng(), leaves)
    params = [p.to(torch.bfloat16) for p in leaves]
    flat = torch.randn(sum(p.numel() for p in leaves), generator=g,
                       device=dev)
    to_host, to_device = OF.Transfers.to_host, OF.Transfers.to_device

    def slow(fn):
        def call(self, dst, src):
            with torch.cuda.stream(self.stream):
                torch.cuda._sleep(2_000_000)     # hold the copy back
            return fn(self, dst, src)
        return call
    monkeypatch.setattr(OF.Transfers, "to_host", slow(to_host))
    monkeypatch.setattr(OF.Transfers, "to_device", slow(to_device))
    if planted:
        monkeypatch.setattr(OF.Transfers, "wait", staticmethod(
            lambda ev: None))
    host.step_pipelined(flat, params, lr=1e-2, grad_scale=1.0,
                        bucket_bytes=400_000)
    torch.cuda.synchronize()
    want = [torch.from_numpy(m).to(torch.bfloat16) for m in host.opt.master]
    ref = OF.DeepSpeedCPUAdam([p.cpu() for p in leaves], lr=1e-2)
    ref.step([t.numpy() for t in torch.split(
        flat.cpu(), [p.numel() for p in leaves])])
    same = all(torch.equal(p.cpu(), w) for p, w in zip(params, want)) and \
        all(np.array_equal(a, b) for a, b in zip(host.opt.master,
                                                 ref.master))
    assert same != planted
    host.close()


@pytest.mark.cuda
def test_cuda_host_offload_remat_matches_full():
    """``remat="host_offload"`` on the card (the block input in pinned
    host memory, copied on the compute stream) gives ``full``'s loss and
    gradients exactly (the same kernels on the same inputs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    ids = torch.from_numpy(np.random.RandomState(2).randint(
        0, 256, (2, 128))).long().to(dev)
    out = {}
    for remat in ("host_offload", "full"):
        m = _offload_model(remat=remat)
        p = m.init(torch.Generator(device=dev).manual_seed(0), dev,
                   torch.float32)
        leaves = [x.requires_grad_(True) for x in _leaves_of(p)]
        loss = m.loss(p, {"input_ids": ids})
        out[remat] = (loss.item(), torch.autograd.grad(loss, leaves))
    assert out["host_offload"][0] == out["full"][0]
    for a, b in zip(out["host_offload"][1], out["full"][1]):
        assert torch.equal(a, b)


def _leaves_of(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves_of(v)
        else:
            yield v


@pytest.mark.cuda
def test_cuda_tier1_offload_matches_in_hbm():
    """ZeRO-Offload on the card (a tiny GPT-2, bf16 params on the card,
    float32 masters and moments on the host) against the in-HBM engine
    from the same params, 3 steps, the JAX tests' bounds; the device
    params are the host masters' bf16 copies after each step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.runtime.optimizers import tree_leaves
    dev = torch.device("cuda")
    params = _offload_model().init(torch.Generator(device=dev).manual_seed(
        0), dev, torch.float32)
    off, _, _, _ = dt.initialize(model=_offload_model(), config=_offload_cfg(
        {"stage": 2, "offload_optimizer": {"device": "cpu"}}, clip=1.0),
        params=_tree_clone(params))
    base, _, _, _ = dt.initialize(model=_offload_model(),
                                  config=_offload_cfg(clip=1.0),
                                  params=params)
    batch = {"input_ids": np.random.RandomState(1).randint(
        0, 256, (4, 128)).astype(np.int32)}
    for _ in range(3):
        a, b = off.train_step(batch), base.train_step(batch)
        assert abs(float(a["loss"]) - float(b["loss"])) < 5e-3
        assert abs(float(a["grad_norm"]) - float(b["grad_norm"])) < \
            5e-2 * max(1.0, float(b["grad_norm"]))
        for leaf, m in zip(tree_leaves(off.state["params"]),
                           off._host_opt.opt.master):
            assert torch.equal(leaf.cpu(),
                               torch.from_numpy(m).to(torch.bfloat16))
    off._host_opt.close()


@pytest.mark.cuda
def test_cuda_slot_store_page_lock():
    """A DRAM slot store registered with CUDA copies a slot to the card
    asynchronously and unregisters at close."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from deepspeed_tpu_torch.runtime.swap_tensor import DramSlotStore
    st = DramSlotStore(3, 1 << 20)
    st.page_lock()
    buf = st.acquire(1)
    buf[:] = np.arange(buf.size) % 251
    src = torch.from_numpy(buf)
    assert src.is_pinned()
    dst = src.to("cuda", non_blocking=True)
    torch.cuda.synchronize()
    assert torch.equal(dst.cpu(), src)
    st.close()
    assert not st._locked


# -- data parallelism and ZeRO (comm/, runtime/zero/partitioned.py) -----------
_ZERO_SMALL = dict(num_layers=2, d_model=128, num_heads=4, vocab_size=512,
                   max_seq_len=256, attn_impl="flash", remat="full",
                   loss_chunk=64)

#: a rank of a world sharing card 0 over gloo, or of world 1 on NCCL
#: (``ZT_BACKEND``): a small GPT-2 at ``ZT_STAGE``, 3 steps on the global
#: batch of 8 (its rank slice; with ``ZT_PIPE`` the world is the pipe
#: axis, 4 micro batches of 2, every rank all rows), the losses and grad
#: norms on a "ZTRESULT" line
_ZERO_RANK = r'''
import json, os, sys
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.models.transformer import TransformerLM, gpt2_config
from deepspeed_tpu_torch.runtime.dataloader import rank_slice
dt.init_distributed(os.environ["ZT_BACKEND"], timeout=120)
world = comm.get_world_size()
pipe = os.environ.get("ZT_PIPE") == "1"
small = json.loads(os.environ["ZT_MODEL"])
config = {"train_micro_batch_size_per_gpu": 8 // world,
          "gradient_accumulation_steps": 1,
          "bf16": {"enabled": True},
          "gradient_clipping": 1.0, "steps_per_print": 0,
          "zero_optimization": {
              "stage": int(os.environ["ZT_STAGE"]),
              "param_persistence_threshold": 0}}
if pipe:
    config.update(train_micro_batch_size_per_gpu=2,
                  gradient_accumulation_steps=4, mesh={"pipe": world})
eng = dt.initialize(model=TransformerLM(gpt2_config("125m", **small)),
                    config=config, device="cuda:0")[0]
batch = {"input_ids": np.random.RandomState(0).randint(
    0, small["vocab_size"], (8, small["max_seq_len"])).astype(np.int32)}
local = (batch if pipe else
         rank_slice(batch, 1, world, comm.get_rank()))
rows = [[float(v) for v in (m["loss"], m["grad_norm"])]
        for m in (eng.train_step(local) for _ in range(3))]
print("ZTRESULT " + json.dumps(rows), flush=True)
comm.destroy_process_group()
'''


def _zero_ranks(world, backend, stage, pipe=False):
    import json
    import os
    from deepspeed_tpu_torch.comm.local_ranks import run_ranks
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    outs = run_ranks(_ZERO_RANK, world, timeout=300, cwd=repo,
                     env={"ZT_BACKEND": backend, "ZT_STAGE": str(stage),
                          "ZT_MODEL": json.dumps(_ZERO_SMALL),
                          "ZT_PIPE": "1" if pipe else "0"})
    return [json.loads([ln for ln in o.splitlines()
                        if ln.startswith("ZTRESULT ")][-1][9:]) for o in outs]


@pytest.mark.cuda
def test_cuda_zero3_two_ranks_sharing_a_card_match_world_one():
    """Two ranks over gloo on card 0 at ZeRO stage 3 (each layer gathered
    from the other rank's shards, through host memory) against one rank
    on NCCL at stage 0 on the same global batch: the same losses and grad
    norms within the same-state step check's limits (bf16; the two
    reduce in other orders), equal on both ranks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    two = _zero_ranks(2, "gloo", 3)
    (one,) = _zero_ranks(1, "nccl", 0)
    assert two[0] == two[1]
    for (l2, g2), (l1, g1) in zip(two[0], one):
        assert abs(l2 - l1) <= 2e-3 * abs(l1)
        assert abs(g2 - g1) <= 2e-2 * abs(g1)


@pytest.mark.cuda
def test_cuda_pipe_two_ranks_sharing_a_card_match_world_one():
    """Two gloo ranks on card 0 at {pipe 2} (1F1B, one stage each, the
    activations and their gradients sent through host memory) against
    one rank on NCCL without a mesh on the same global batch: the same
    losses and grad norms within the same-state step check's limits,
    equal on both ranks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    two = _zero_ranks(2, "gloo", 0, pipe=True)
    (one,) = _zero_ranks(1, "nccl", 0)
    assert two[0] == two[1]
    for (l2, g2), (l1, g1) in zip(two[0], one):
        assert abs(l2 - l1) <= 2e-3 * abs(l1)
        assert abs(g2 - g1) <= 2e-2 * abs(g1)


@pytest.mark.cuda
def test_cuda_nccl_two_ranks_on_one_card_raise():
    """NCCL takes one card a rank: two ranks on a one-card node raise and
    name gloo, never switching backend themselves."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.device_count() != 1:
        pytest.skip("needs a node of exactly one card")
    from deepspeed_tpu_torch.comm.local_ranks import RanksFailed
    with pytest.raises(RanksFailed, match="share a card run on 'gloo'"):
        _zero_ranks(2, "nccl", 0)


_COLLECTIVES_RANK = r'''
import json, os, sys
sys.path.insert(0, os.getcwd())
import torch
import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch import comm
dt.init_distributed(os.environ["ZT_BACKEND"], timeout=60)
rank, world = comm.get_rank(), comm.get_world_size()
dev = torch.device("cuda", 0)
out = {}
for dtype in (torch.float32, torch.bfloat16):
    x = (torch.arange(96, dtype=torch.float32, device=dev).reshape(4, 24)
         + 100 * rank).to(dtype)
    res = {"all_reduce": comm.all_reduce(x.clone()),
           "all_gather": comm.all_gather(x, axis=1),
           "reduce_scatter": comm.reduce_scatter(x.clone(),
                                                 scatter_dimension=1),
           "all_to_all": comm.all_to_all_single(x, "data", 1, 0),
           "broadcast": comm.broadcast(x.clone(), src=world - 1)}
    for k, v in res.items():
        assert v.is_cuda and v.dtype == dtype, (k, v.device, v.dtype)
        out[f"{dtype}/{k}"] = v.float().cpu().tolist()
print("ZTRESULT " + json.dumps(out), flush=True)
comm.destroy_process_group()
'''


@pytest.mark.cuda
@pytest.mark.parametrize("backend,world", [("gloo", 2), ("nccl", 1)])
def test_cuda_collectives_on_card_tensors(backend, world):
    """Every collective of ``comm`` on CUDA tensors: over gloo each goes
    through a pinned host buffer and comes back on the card, in its
    dtype, equal to the sum, concatenation, slice or exchange; on NCCL at
    world 1 each is an identity."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import json
    import os
    from deepspeed_tpu_torch.comm.local_ranks import run_ranks
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    outs = run_ranks(_COLLECTIVES_RANK, world, timeout=180, cwd=repo,
                     env={"ZT_BACKEND": backend})
    res = [json.loads([ln for ln in o.splitlines()
                       if ln.startswith("ZTRESULT ")][-1][9:]) for o in outs]
    xs = [torch.arange(96.).reshape(4, 24) + 100 * r for r in range(world)]
    for dtype in (torch.float32, torch.bfloat16):
        xr = [x.to(dtype).float() for x in xs]
        total = sum(xr)
        for r, out in enumerate(res):
            got = {k.split("/")[1]: torch.tensor(v) for k, v in out.items()
                   if k.startswith(f"{dtype}/")}
            want = {"all_reduce": total.to(dtype).float(),
                    "all_gather": torch.cat(xr, dim=1),
                    "reduce_scatter": total.chunk(world, 1)[r].to(
                        dtype).float(),
                    "all_to_all": torch.cat([x.chunk(world, 1)[r]
                                             for x in xr], dim=0),
                    "broadcast": xr[-1]}
            for k, w in want.items():
                torch.testing.assert_close(got[k], w, rtol=0, atol=0,
                                           msg=f"{backend} {dtype} {k}")


#: a rank of world 2 over gloo on card 0 serving a small f32 GPT-2 at
#: serving.mesh {model 2}, or the same model at one rank without a mesh
#: (``TPS_WORLD1``): the greedy streams of 6 requests on a "TPSRESULT" line
_TP_SERVE_RANK = r'''
import json, os, sys
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.models.transformer import TransformerLM, gpt2_config
one = os.environ.get("TPS_WORLD1") == "1"
if not one:
    dt.init_distributed("gloo", timeout=120)
model = TransformerLM(gpt2_config("125m", num_layers=4, d_model=64,
                                  num_heads=4, vocab_size=128,
                                  max_seq_len=128, dtype=torch.float32))
params = model.init(torch.Generator().manual_seed(0), "cpu", torch.float32)

def scale(tree):
    # larger kernels than the init's, so the greedy streams vary
    return {k: scale(v) if isinstance(v, dict) else
            (v * 30.0 if k == "kernel" else v) for k, v in tree.items()}
serving = {"enabled": True, "kv_block_size": 8, "num_kv_blocks": 64,
           "max_batch_slots": 4, "prefill_chunk_tokens": 16}
if not one:
    serving["mesh"] = {"model": 2}
eng = dt.init_inference(model, {"dtype": "float32", "temperature": 0.0,
                                "serving": serving},
                        params=scale(params), device="cuda:0")
srv = eng.serving_engine()
rs = np.random.RandomState(5)
reqs = [srv.submit(rs.randint(0, 128, n).tolist(), max_new_tokens=12)
        for n in (5, 17, 30, 9, 2, 24)]
srv.run()
print("TPSRESULT " + json.dumps([[r.output for r in reqs],
                                 srv.kv_pool_bytes]), flush=True)
if not one:
    comm.destroy_process_group()
'''


@pytest.mark.cuda
def test_cuda_tp_serving_two_ranks_sharing_a_card_match_world_one():
    """Two ranks over gloo on card 0 at ``serving.mesh`` {model 2} (each
    rank's B6/B7 at half the kv heads, every layer's partial sums
    all-reduced through host memory, the vocab shards all-gathered)
    against one rank without a mesh: the f32 greedy streams equal on
    both ranks and equal to world 1's, each rank's pool half of world
    1's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import json
    import os
    from deepspeed_tpu_torch.comm.local_ranks import run_ranks
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def result(text):
        return json.loads([ln for ln in text.splitlines()
                           if ln.startswith("TPSRESULT ")][-1][10:])
    two = [result(o) for o in run_ranks(_TP_SERVE_RANK, 2, timeout=300,
                                        cwd=repo)]
    (one,) = [result(o) for o in run_ranks(_TP_SERVE_RANK, 1, timeout=300,
                                           cwd=repo,
                                           env={"TPS_WORLD1": "1"})]
    assert two[0] == two[1]
    assert two[0][0] == one[0]
    assert 2 * two[0][1] == one[1]
