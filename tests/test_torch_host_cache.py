"""The port's tiered host KV cache against the JAX package's, on the CPU.

Bottom up, as ``tests/unit/test_host_cache.py`` covers the JAX tier:

  * the capacity maths (``host_block_bytes``, ``tiered_blocks_for_budget``)
    equal to the JAX functions, and to what the codec emits;
  * the wire codec: the port's payload bytes equal the JAX
    ``BlockCodec``'s byte for byte at wire 0, 8 and 4 over float32,
    float16 and bfloat16 pools (bf16 crosses torch as its 16-bit bits,
    ml_dtypes' ``bfloat16`` on the JAX side), and over int8 and packed
    int4 pools; the decoded blocks equal too;
  * ``HostTierCache`` op sequences (put, claim, release, discard, publish,
    reap, DRAM overflowing into NVMe) giving the JAX tier's residency,
    stats and payloads, and the JAX unit cases on the port;
  * allocator sequences with the host tier attached giving the JAX
    allocator's block tables and pending promotions;
  * a port server with the host cache on against a JAX server with it on
    (its paged kernels through the package's plain references, as the
    interpreted kernels take minutes to compile inside the mixed step):
    equal greedy streams, spills and promoted blocks through DRAM and
    through NVMe (``tmp_path``), and under the ``serving.spill`` /
    ``serving.promote`` fault plans (transient faults retried in place, a
    fatal spill degrading to a plain eviction, a fatal promote falling
    back to recompute — the streams stay exact).
"""
import ml_dtypes
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dt
from deepspeed_tpu.inference.config import \
    DeepSpeedInferenceConfig as JaxConfig
from deepspeed_tpu.inference.serving import block_allocator as jax_alloc
from deepspeed_tpu.inference.serving import host_cache as jax_hc
from deepspeed_tpu.models import transformer as jax_tf
from deepspeed_tpu.ops.transformer import paged_decode_attention as jax_pa
from deepspeed_tpu.runtime.resilience import \
    FaultInjector as JaxFaultInjector
from deepspeed_tpu.runtime.resilience import \
    install_fault_injector as jax_install
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.serving import (BlockCodec, BlockPoolError,
                                                   HostTierCache,
                                                   PagedBlockAllocator,
                                                   blocks_for_budget,
                                                   host_block_bytes,
                                                   tiered_blocks_for_budget)
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.convert import params_to_jax
from deepspeed_tpu_torch.runtime.resilience import (FaultInjector,
                                                    install_fault_injector)


@pytest.fixture
def injectors():
    """Fresh fault injectors of both packages, emptied afterwards."""
    port, jax_fi = FaultInjector(), JaxFaultInjector()
    install_fault_injector(port)
    jax_install(jax_fi)
    yield port, jax_fi
    install_fault_injector(FaultInjector())
    jax_install(JaxFaultInjector())


# ---------------------------------------------------------------------------
# capacity maths
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("args", [
    (4, 8, 4, 32, 8, 8, 2), (4, 8, 4, 32, 4, 4, 2), (4, 8, 4, 32, 0, 0, 2),
    (4, 8, 4, 32, 0, 8, 2), (32, 16, 32, 128, 0, 0, 2),
    (32, 16, 32, 128, 0, 8, 2), (32, 16, 32, 128, 8, 8, 2),
    (2, 4, 2, 8, 0, 0, 4)])
def test_host_block_bytes_equal_jax(args):
    assert host_block_bytes(*args) == jax_hc.host_block_bytes(*args)


def test_host_block_bytes_at_gpt3_67b():
    """The entry sizes phase 26 of ``chip_smoke.py`` budgets with: 32
    layers x 16 tokens x 32 kv heads x 128 at 8 bits, and raw bf16."""
    assert host_block_bytes(32, 16, 32, 128, 0, 8) == 4325376
    assert host_block_bytes(32, 16, 32, 128, 0, 0) == 8 << 20


@pytest.mark.parametrize("kv_bits,wire_bits", [(0, 0), (0, 8), (0, 4),
                                               (8, 8), (4, 4)])
def test_planning_matches_codec(kv_bits, wire_bits):
    codec = BlockCodec(4, 8, 4, 32, kv_bits=kv_bits, wire_bits=wire_bits,
                       dtype=torch.float16)
    assert codec.nbytes == host_block_bytes(4, 8, 4, 32, kv_bits, wire_bits)


@pytest.mark.parametrize("budgets", [(10**6, 10**7, 10**8),
                                     (1 << 30, 0, 1 << 33), (4096, 4096, 0)])
def test_tiered_blocks_for_budget_equal_jax(budgets):
    geo = dict(num_layers=2, block_size=4, kv_heads=2, head_dim=8,
               kv_bits=0, wire_bits=8)
    got = tiered_blocks_for_budget(*budgets, **geo)
    assert got == jax_hc.tiered_blocks_for_budget(*budgets, **geo)
    assert got[0] == blocks_for_budget(budgets[0], 4, 2, 8, 0)


def test_model_sharded_budget_is_the_mesh_slice():
    """A model-sharded mesh (since its slice) plans the device tier at
    the per-rank block size, as the JAX helper does."""
    got = tiered_blocks_for_budget(10**6, 10**7, 0, 2, 4, 8, 16,
                                   model_shards=2)
    assert got == jax_hc.tiered_blocks_for_budget(10**6, 10**7, 0, 2, 4, 8,
                                                  16, model_shards=2)
    assert got[0] == blocks_for_budget(10**6, 4, 8, 16, 0, model_shards=2)


# ---------------------------------------------------------------------------
# wire codec: bytes equal the JAX codec's
# ---------------------------------------------------------------------------
NP_DTYPES = {torch.float32: np.float32, torch.float16: np.float16,
             torch.bfloat16: ml_dtypes.bfloat16}


def raw_block(rng, shape, dtype):
    """(JAX-side numpy array, port-side tensor) of the same bits."""
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    t = torch.from_numpy(x).to(dtype)
    if dtype == torch.bfloat16:
        bits = t.view(torch.int16).numpy()
        return bits.view(ml_dtypes.bfloat16), t
    return t.numpy().copy(), t


def port_bits(t):
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().view(np.uint8)


@pytest.mark.parametrize("wire_bits", [0, 8, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16],
                         ids=["f32", "f16", "bf16"])
def test_raw_pool_payload_equals_jax(dtype, wire_bits):
    rng = np.random.default_rng(wire_bits + 10 * len(str(dtype)))
    shape = (3, 8, 4, 32)
    jk, pk = raw_block(rng, shape, dtype)
    jv, pv = raw_block(rng, shape, dtype)
    ours = BlockCodec(3, 8, 4, 32, wire_bits=wire_bits, dtype=dtype)
    theirs = jax_hc.BlockCodec(3, 8, 4, 32, wire_bits=wire_bits,
                               dtype=NP_DTYPES[dtype])
    payload = ours.encode(pk, pv)
    want = theirs.encode(jk, jv)
    assert payload.dtype == np.uint8 and ours.nbytes == theirs.nbytes
    np.testing.assert_array_equal(payload, want)
    k, v, ks, vs = ours.decode(payload)
    jk2, jv2, _, _ = theirs.decode(want)
    assert ks is None and vs is None and k.dtype == dtype
    np.testing.assert_array_equal(port_bits(k),
                                  np.ascontiguousarray(jk2).view(np.uint8))
    np.testing.assert_array_equal(port_bits(v),
                                  np.ascontiguousarray(jv2).view(np.uint8))
    if wire_bits == 0:
        assert torch.equal(k, pk) and torch.equal(v, pv)


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_quantized_pool_payload_equals_jax(kv_bits):
    """A quantized pool spills its own bytes verbatim: both codecs give
    the same payload and the port gets the pool's int8 values and f32
    scales back bit for bit."""
    rng = np.random.default_rng(kv_bits)
    ours = BlockCodec(3, 8, 4, 32, kv_bits=kv_bits)
    theirs = jax_hc.BlockCodec(3, 8, 4, 32, kv_bits=kv_bits)
    k, v = (rng.integers(-128, 128, ours._vshape()).astype(np.int8)
            for _ in range(2))
    ks, vs = (rng.random(ours._sshape()).astype(np.float32) + 1e-3
              for _ in range(2))
    payload = ours.encode(*(torch.from_numpy(a) for a in (k, v, ks, vs)))
    np.testing.assert_array_equal(payload, theirs.encode(k, v, ks, vs))
    for got, want in zip(ours.decode(payload), (k, v, ks, vs)):
        np.testing.assert_array_equal(got.numpy(), want)


def test_codec_validation():
    with pytest.raises(ValueError, match="even head_dim"):
        BlockCodec(2, 8, 4, 33, kv_bits=4)
    with pytest.raises(ValueError, match="wire_bits"):
        BlockCodec(2, 8, 4, 32, wire_bits=3)
    codec = BlockCodec(2, 8, 4, 32, kv_bits=8)
    with pytest.raises(ValueError, match="scale planes"):
        codec.encode(torch.zeros(codec._vshape(), dtype=torch.int8),
                     torch.zeros(codec._vshape(), dtype=torch.int8))
    with pytest.raises(ValueError, match="codec expects"):
        codec.decode(np.zeros(3, np.uint8))


# ---------------------------------------------------------------------------
# HostTierCache
# ---------------------------------------------------------------------------
def _payload(i, nbytes=64):
    return np.full(nbytes, i % 251, np.uint8)


def tier_state(hc):
    return ({t: sorted(hc._tier(t).lru) for t in hc.tier_names},
            dict(spills=hc.spills_total, demotions=hc.demotions_total,
                 evictions=hc.evictions_total,
                 published=hc.published_total,
                 reaped=hc.orphans_reaped_total,
                 corrupt=hc.corrupt_dropped_total, hits=dict(hc.hits_total)),
            hc.published_entries())


@pytest.mark.parametrize("seed,dram,nvme", [(0, 3, 0), (1, 2, 3),
                                            (2, 0, 4), (3, 4, 2)])
def test_tier_op_sequence_equals_jax(seed, dram, nvme, tmp_path):
    """One random sequence of puts, claims, released claims, discards,
    publishes and orphan sweeps on both tiers: the same residency per
    tier, the same stats and the same claimed bytes after every op."""
    rng = np.random.default_rng(seed)
    kw = dict(nvme_slots=nvme)
    ours = HostTierCache(64, dram, nvme_path=str(tmp_path / "p"), **kw)
    theirs = jax_hc.HostTierCache(64, dram, nvme_path=str(tmp_path / "j"),
                                  **kw)
    claimed = {}
    for step in range(60):
        op = rng.integers(0, 6)
        d = bytes([int(rng.integers(0, 8))]) * 16
        if op == 0:
            ours.put(d, _payload(step))
            theirs.put(d, _payload(step))
        elif op == 1:
            a, b = ours.claim(d), theirs.claim(d)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
                claimed[d] = a
        elif op == 2 and claimed:
            d = sorted(claimed)[int(rng.integers(0, len(claimed)))]
            p = claimed.pop(d)
            ours.release_claim(d, p)
            theirs.release_claim(d, p)
        elif op == 3:
            assert ours.discard(d) == theirs.discard(d)
        elif op == 4:
            pub = f"w{int(rng.integers(0, 2))}"
            ours.publish(d, _payload(step), publisher=pub)
            theirs.publish(d, _payload(step), publisher=pub)
        elif op == 5 and step % 7 == 0:
            assert ours.reap_orphans("w0") == theirs.reap_orphans("w0")
        assert tier_state(ours) == tier_state(theirs), step
        ours.assert_consistent(set())
    ours.close()
    theirs.close()


def test_put_claim_roundtrip():
    hc = HostTierCache(64, dram_slots=4)
    hc.put(b"a" * 16, _payload(1))
    assert hc.contains(b"a" * 16) and hc.spills_total == 1
    np.testing.assert_array_equal(hc.claim(b"a" * 16), _payload(1))
    assert not hc.contains(b"a" * 16)
    assert hc.hits_total == {"dram": 1}
    assert hc.claim(b"a" * 16) is None
    hc.assert_consistent(set())


def test_reput_refreshes_lru_not_spill_count():
    hc = HostTierCache(64, dram_slots=2)
    hc.put(b"a" * 16, _payload(1))
    hc.put(b"b" * 16, _payload(2))
    hc.put(b"a" * 16, _payload(1))
    assert hc.spills_total == 2
    hc.put(b"c" * 16, _payload(3))
    assert hc.contains(b"a" * 16) and not hc.contains(b"b" * 16)


def test_dram_overflow_demotes_to_nvme_then_ages_out(tmp_path):
    hc = HostTierCache(64, dram_slots=2, nvme_slots=2,
                       nvme_path=str(tmp_path))
    for i in range(4):
        hc.put(bytes([i]) * 16, _payload(i))
    assert hc.demotions_total == 2 and hc.evictions_total == 0
    assert hc.resident_entries("dram") == 2
    assert hc.resident_entries("nvme") == 2
    hc.put(bytes([4]) * 16, _payload(4))
    assert hc.demotions_total == 3 and hc.evictions_total == 1
    assert not hc.contains(bytes([0]) * 16)
    np.testing.assert_array_equal(hc.claim(bytes([1]) * 16), _payload(1))
    assert hc.hits_total["nvme"] == 1
    hc.assert_consistent(set())
    hc.close()


def test_release_claim_discard_and_device_overlap():
    hc = HostTierCache(64, dram_slots=2)
    hc.put(b"a" * 16, _payload(1))
    p = hc.claim(b"a" * 16)
    hc.release_claim(b"a" * 16, p)
    assert hc.contains(b"a" * 16) and hc.spills_total == 1
    hc.assert_consistent({b"b" * 16})
    with pytest.raises(AssertionError, match="both host-side"):
        hc.assert_consistent({b"a" * 16})
    assert hc.discard(b"a" * 16) and not hc.contains(b"a" * 16)
    assert not hc.discard(b"a" * 16)
    with pytest.raises(ValueError, match="at least one tier"):
        HostTierCache(64, dram_slots=0, nvme_slots=0)


# ---------------------------------------------------------------------------
# the allocator with the host tier attached
# ---------------------------------------------------------------------------
def tiered_pair(num_blocks=8, block_size=4, dram_slots=8):
    """(port allocator, JAX allocator), each over its own package's host
    tier, spilling a payload keyed by the digest."""
    out = []
    for alloc_mod, hc_cls in ((PagedBlockAllocator, HostTierCache),
                              (jax_alloc.PagedBlockAllocator,
                               jax_hc.HostTierCache)):
        a = alloc_mod(num_blocks=num_blocks, block_size=block_size)
        hc = hc_cls(64, dram_slots=dram_slots)
        a.attach_host_tier(hc, lambda b, h, hc=hc: hc.put(h, _payload(h[0])))
        out.append((a, hc))
    return out


def alloc_state(a, hc):
    return (dict(a._tables), a.num_free, a.num_cached, a.num_pending,
            [(j.block, j.digest) for j in a.pending_jobs()],
            a.hit_tokens_total, a.host_hit_tokens_total, sorted(hc.digests()),
            hc.spills_total)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_allocator_sequence_equals_jax(seed):
    """Random admissions over a few shared prefixes, commits, frees and
    landed or failed promotions: the same block tables, free/cached
    counts, pending jobs and host residency as the JAX allocator."""
    rng = np.random.default_rng(seed)
    (pa, phc), (ja, jhc) = tiered_pair(num_blocks=10)
    prefixes = [list(range(i * 20, i * 20 + 13)) for i in range(3)]
    live = []
    for step in range(40):
        op = rng.integers(0, 4)
        if op == 0 and len(live) < 3:
            ids = prefixes[int(rng.integers(0, 3))]
            seq = f"s{step}"
            res = []
            for a in (pa, ja):
                try:
                    res.append(a.allocate(seq, len(ids) + 1, token_ids=ids))
                except BlockPoolError:
                    res.append("full")
                except jax_alloc.BlockPoolError:
                    res.append("full")
            assert res[0] == res[1], step
            if res[0] != "full":
                live.append((seq, ids))
        elif op == 1 and live:
            seq, ids = live.pop(int(rng.integers(0, len(live))))
            for a in (pa, ja):
                if not a.seq_has_pending(seq):
                    a.commit_cached(seq, ids, len(ids))
                a.free(seq)
        elif op == 2 and pa.pending_jobs():
            dp, dj = pa.pending_jobs()[0].digest, ja.pending_jobs()[0].digest
            if rng.integers(0, 3) == 0:
                assert pa.promotion_failed(dp) == ja.promotion_failed(dj)
            else:
                pa.promotion_landed(dp)
                ja.promotion_landed(dj)
        elif op == 3:
            # pressure: a big allocation evicts (spills) the cached LRU
            n = 4 * int(rng.integers(1, 6))
            for a in (pa, ja):
                try:
                    a.allocate("big", n)
                    a.free("big")
                except (BlockPoolError, jax_alloc.BlockPoolError):
                    pass
        assert alloc_state(pa, phc) == alloc_state(ja, jhc), step
        pa.assert_consistent()


def mk_tiered_alloc():
    return tiered_pair()[0]


def test_eviction_spills_then_rehit_promotes():
    a, hc = mk_tiered_alloc()
    ids = list(range(12))
    a.allocate("s1", 13, token_ids=ids)
    a.commit_cached("s1", ids, 12)
    a.free("s1")
    assert a.num_cached == 3
    a.allocate("big", 7 * 4)
    assert hc.spills_total == 3 and a.num_cached == 0
    a.free("big")
    _, cached = a.allocate("s2", 13, token_ids=ids)
    assert cached == 8 and a.host_hit_tokens_total == 8
    assert a.hit_tokens_total == 0
    assert a.num_pending == 2 and a.seq_has_pending("s2")
    assert len(hc.digests()) == 1
    for job in a.pending_jobs():
        np.testing.assert_array_equal(job.payload, _payload(job.digest[0]))
        a.promotion_landed(job.digest)
    assert a.num_pending == 0 and not a.seq_has_pending("s2")
    a.assert_consistent()
    a.free("s2")
    a.assert_consistent()


def _spilled_one_block():
    a, hc = mk_tiered_alloc()
    ids = list(range(5))
    a.allocate("s1", 6, token_ids=ids)
    a.commit_cached("s1", ids, 5)
    a.free("s1")
    a.allocate("big", 7 * 4)
    a.free("big")
    return a, hc, ids


def test_free_cancels_pending_and_restores_host_entry():
    a, hc, ids = _spilled_one_block()
    a.allocate("s2", 6, token_ids=ids)
    assert a.num_pending == 1
    free_before = a.num_free
    a.free("s2")
    assert a.num_pending == 0 and a.num_cached == 0
    assert a.num_free == free_before + 2
    assert len(hc.digests()) == 1
    a.assert_consistent()


def test_promotion_failed_unregisters_and_reports_holders():
    a, hc, ids = _spilled_one_block()
    a.allocate("s2", 6, token_ids=ids)
    [job] = a.pending_jobs()
    assert a.promotion_failed(job.digest) == [("s2", 0)]
    assert a.num_pending == 0 and not hc.contains(job.digest)
    a.assert_consistent()
    a.free("s2")
    a.assert_consistent()


def test_commit_discards_redundant_host_entry():
    a, hc, ids = _spilled_one_block()
    a.allocate("s4", 6, token_ids=ids)
    for job in a.pending_jobs():
        a.promotion_landed(job.digest)
    a.free("s4")
    a.allocate("big", 7 * 4)
    a.free("big")
    a.allocate("s5", 6)
    a.commit_cached("s5", ids, 5)
    assert len(hc.digests()) == 0
    a.assert_consistent()
    a.free("s5")


def test_no_capacity_no_claim():
    a, hc = mk_tiered_alloc()
    ids = list(range(5))
    a.allocate("s1", 6, token_ids=ids)
    a.commit_cached("s1", ids, 5)
    a.free("s1")
    a.allocate("big", 7 * 4)
    with pytest.raises(BlockPoolError):
        a.allocate("s2", 6, token_ids=ids)
    assert a.num_pending == 0 and len(hc.digests()) == 1
    a.assert_consistent()


def test_probe_prefix_coverage_is_read_only():
    a, hc, ids = _spilled_one_block()
    before = alloc_state(a, hc)
    assert a.probe_prefix_coverage(ids + [99], split=True) == (0, 4)
    a.allow_claims = False
    assert a.probe_prefix_coverage(ids + [99]) == 0
    assert alloc_state(a, hc) == before


# ---------------------------------------------------------------------------
# the server, port against JAX
# ---------------------------------------------------------------------------
TINY = dict(num_layers=4, d_model=32, num_heads=4, vocab_size=64,
            max_seq_len=64)
SPREAD = 4.0
BASE = {"dtype": "float32", "max_out_tokens": 64, "temperature": 0.0}
SERVING = {"enabled": True, "kv_block_size": 8, "num_kv_blocks": 12,
           "max_batch_slots": 8, "prefill_chunk_tokens": 16}
HOST_DRAM = {"enabled": True, "dram_budget_bytes": 1 << 20}


def spread(tree):
    if isinstance(tree, dict):
        return {k: spread(v) for k, v in tree.items()}
    return tree * SPREAD if tree.dim() >= 2 and tree.shape[-1] > 1 else tree


@pytest.fixture(scope="module")
def params():
    g = torch.Generator()
    g.manual_seed(5)
    pm = tt.TransformerLM(tt.gpt2_config("125m", dtype=torch.float32, **TINY))
    return spread(pm.init(g, "cpu", torch.float32))


@pytest.fixture
def plain_jax_kernels(monkeypatch):
    """The JAX server's paged kernels through the package's plain
    references (the interpreted kernels take minutes to compile)."""
    monkeypatch.setattr(
        jax_pa, "paged_decode_attention",
        lambda q, pk, pv, lens, tables, sm_scale=None, k_scale=None,
        v_scale=None, kv_bits=0, **_: jax_pa.paged_attention_reference(
            q, pk, pv, lens, tables, k_scale, v_scale, kv_bits))
    monkeypatch.setattr(
        jax_pa, "paged_prefill_attention",
        lambda q, pk, pv, base, n, table, sm_scale=None, k_scale=None,
        v_scale=None, kv_bits=0, **_: jax_pa.paged_prefill_reference(
            q, pk, pv, base, n, table, k_scale, v_scale, kv_bits))


def servers(params, serving):
    """(port server, JAX server) over the same weights and config."""
    cfg = {**BASE, "serving": {**SERVING, **serving}}
    pm = tt.TransformerLM(tt.gpt2_config("125m", dtype=torch.float32, **TINY))
    peng = dt.init_inference(pm, cfg, params=params, device="cpu")
    jm = jax_tf.TransformerLM(jax_tf.gpt2_config("125m", dtype=jnp.float32,
                                                 **TINY))
    jeng = ds.init_inference(jm, config={
        **cfg, "replace_with_kernel_inject": False},
        params=params_to_jax(params))
    return peng, peng.serving_engine(), jeng.serving_engine()


def spill_promote_cycle(srv, seed=0):
    """Serve a prompt, flood the 12-block pool until its cached chain
    spills, serve the prompt again (host hit, promote).  Returns the
    streams of both serves."""
    rs = np.random.RandomState(seed)
    prompt = rs.randint(0, 64, (28,)).tolist()
    r1 = srv.submit(prompt, max_new_tokens=6)
    srv.run()
    for _ in range(6):
        srv.submit(rs.randint(0, 64, (30,)).tolist(), max_new_tokens=4)
    srv.run()
    r2 = srv.submit(prompt, max_new_tokens=6)
    srv.run()
    srv.allocator.assert_consistent()
    return prompt, list(r1.output), list(r2.output)


def host_stats(srv):
    hc = srv.host_cache
    return dict(srv.host_counts, spills=hc.spills_total,
                demotions=hc.demotions_total, hits=dict(hc.hits_total),
                host_hit_tokens=srv.allocator.host_hit_tokens_total)


@pytest.mark.parametrize("case", ["int8-dram", "wire0-dram", "int8-nvme"])
def test_server_spill_promote_equals_jax(params, plain_jax_kernels, case,
                                         tmp_path):
    """The greedy streams before and after a forced spill and promote
    equal the JAX server's and the port's ``generate()``, with the same
    spills, promoted blocks and host hits per tier."""
    if case == "int8-dram":
        serving = {"kv_cache_bits": 8, "host_cache": HOST_DRAM}
    elif case == "wire0-dram":
        serving = {"host_cache": dict(HOST_DRAM, wire_bits=0)}
    else:
        entry = host_block_bytes(4, 8, 4, 8, kv_bits=8)
        serving = {"kv_cache_bits": 8, "host_cache": {
            "enabled": True, "dram_budget_bytes": entry,
            "nvme_budget_bytes": 64 * entry, "nvme_path": str(tmp_path)}}
    peng, psrv, jsrv = servers(params, serving)
    prompt, a1, a2 = spill_promote_cycle(psrv)
    _, b1, b2 = spill_promote_cycle(jsrv)
    want = peng.generate([prompt], max_new_tokens=6)[0].tolist()
    assert a1 == a2 == want == b1 == b2
    assert len(set(want)) > 1
    assert host_stats(psrv) == host_stats(jsrv)
    assert psrv.host_counts["promoted_blocks"] >= 3
    if case == "int8-nvme":
        assert psrv.host_cache.tier_names == ["dram", "nvme"]
        assert psrv.host_cache.demotions_total > 0
        assert psrv.host_cache.hits_total["nvme"] > 0
    psrv.host_cache.close()


@pytest.mark.parametrize("plan", ["transient", "fatal-spill",
                                  "fatal-promote"])
def test_server_fault_plans_equal_jax(params, plain_jax_kernels, injectors,
                                      plan):
    """Transient ``fail`` plans on both sites are retried in place; a
    fatal spill degrades to a plain eviction; a fatal promote drops the
    entry and recomputes.  The streams stay exact and both packages
    count the same failures and promotions."""
    port_fi, jax_fi = injectors
    for fi in injectors:
        if plan == "transient":
            fi.add_plan("serving.spill", "fail", at=1, count=2)
            fi.add_plan("serving.promote", "fail", at=1, count=2)
        elif plan == "fatal-spill":
            fi.add_plan("serving.spill", "fatal", at=1, count=1)
        else:
            fi.add_plan("serving.promote", "fatal", at=1, count=1)
    peng, psrv, jsrv = servers(params, {"kv_cache_bits": 8,
                                        "host_cache": HOST_DRAM})
    prompt, a1, a2 = spill_promote_cycle(psrv)
    _, b1, b2 = spill_promote_cycle(jsrv)
    assert a1 == a2 == b1 == b2 == \
        peng.generate([prompt], max_new_tokens=6)[0].tolist()
    assert host_stats(psrv) == host_stats(jsrv)
    for site in ("serving.spill", "serving.promote"):
        assert port_fi.fire_count(site) == jax_fi.fire_count(site)
    if plan == "transient":
        assert port_fi.fire_count("serving.spill") == 2
        assert psrv.host_counts["spill_failures"] == 0
        assert psrv.host_counts["promote_failures"] == 0
    elif plan == "fatal-spill":
        assert psrv.host_counts["spill_failures"] == 1
    else:
        assert psrv.host_counts["promote_failures"] == 1


def test_server_host_cache_refusals_and_gauges(params):
    pm = tt.TransformerLM(tt.gpt2_config("125m", dtype=torch.float32, **TINY))

    def build(serving):
        return dt.init_inference(
            pm, {**BASE, "serving": {**SERVING, **serving}}, params=params,
            device="cpu").serving_engine()
    with pytest.raises(ValueError, match="prefix_cache"):
        build({"prefix_cache": False, "host_cache": HOST_DRAM})
    with pytest.raises(ValueError, match="zero entries"):
        build({"host_cache": {"enabled": True, "dram_budget_bytes": 16}})
    with pytest.raises(ValueError, match="prefill_only requires"):
        build({}).submit([1, 2, 3], prefill_only=True)
    srv = build({"kv_cache_bits": 8, "host_cache": HOST_DRAM})
    before = srv._m_host_spills.value
    srv.host_cache.put(b"x" * 16, np.zeros(srv.host_cache.entry_nbytes,
                                           np.uint8))
    srv._update_gauges()
    assert srv._m_host_spills.value == before + 1
    assert srv._m_host_dram_bytes.value == srv.host_cache.entry_nbytes
    assert srv._m_promote_depth.value == 0


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("block,match", [
    ({"enabled": True}, "budget"),
    ({"enabled": True, "nvme_budget_bytes": 1 << 20}, "nvme_path"),
    ({"enabled": True, "dram_budget_bytes": 1 << 20, "wire_bits": 3},
     "wire_bits"),
    ({"wire_bits": 3}, "wire_bits"),
    ({"dram_budget_bytes": -1}, "budgets must be >= 0"),
    ({"enabled": True, "dram_budget_bytes": 1 << 20,
      "promote_parallelism": 0}, "promote_parallelism")])
def test_host_cache_config_refusals_equal_jax(block, match):
    cfg = {"serving": {"enabled": True, "host_cache": block}}
    with pytest.raises(ValueError, match=match) as ours:
        DeepSpeedInferenceConfig.from_dict(cfg)
    with pytest.raises(ValueError, match=match) as theirs:
        JaxConfig(**cfg)
    assert str(ours.value) in str(theirs.value)
