"""The port's ``init_inference`` → ``generate()`` and continuous-batching
server against the JAX package, on the same weights.

The model is the serving suite's ``tiny_cfg`` (4 layers, d_model 32,
4 heads, vocab 64) in float32 with weights from the JAX init carried by
``params_from_jax``.  Greedy token streams must be EXACTLY equal: the
port's ``generate()`` (decode through kernel B5's plain version on the
CPU) against the JAX ``generate()`` (its XLA decode path, as the JAX
serving suite pins its baseline), and the port's serving streams
(kernels B6/B7's plain versions, chunked prefill, preemption) against
both.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dt
from deepspeed_tpu.inference.config import \
    DeepSpeedInferenceConfig as JaxConfig
from deepspeed_tpu.inference.sampling import sample_tokens_per_row
from deepspeed_tpu.models import transformer as jax_tf
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.sampling import (filter_logits,
                                                    sample_tokens)
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.convert import params_from_jax

TINY = dict(num_layers=4, d_model=32, num_heads=4, vocab_size=64,
            max_seq_len=64)
BASE = {"dtype": "float32", "max_out_tokens": 64, "temperature": 0.0}
SERVING = {"enabled": True, "kv_block_size": 8, "num_kv_blocks": 48,
           "max_batch_slots": 8, "prefill_chunk_tokens": 16}


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine) on the same JAX-initialised weights."""
    jm = jax_tf.TransformerLM(jax_tf.gpt2_config("125m", dtype=jnp.float32,
                                                 **TINY))
    jp = jax.device_get(jm.init(jax.random.PRNGKey(7)))
    jeng = ds.init_inference(jm, config={
        **BASE, "replace_with_kernel_inject": False}, params=jp)
    pm = tt.TransformerLM(tt.gpt2_config("125m", dtype=torch.float32,
                                         **TINY))
    peng = dt.init_inference(pm, {**BASE, "serving": SERVING},
                             params=params_from_jax(jp, pm), device="cpu")
    return jeng, peng, jp


def jax_gen(jeng, prompt, n):
    return np.asarray(jeng.generate(np.asarray(prompt, np.int32)[None],
                                    max_new_tokens=n, temperature=0.0))[0]


def prompts_of(lens, seed):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 64, (n,)).tolist() for n in lens]


def test_generate_matches_jax_greedy(engines):
    jeng, peng, _ = engines
    batch = np.random.RandomState(0).randint(0, 64, (2, 7)).astype(np.int32)
    want = np.asarray(jeng.generate(batch, max_new_tokens=8,
                                    temperature=0.0))
    got = peng.generate(batch, max_new_tokens=8).numpy()
    np.testing.assert_array_equal(got, want)
    stats = peng.latency_stats()
    assert stats["ttft_p50_ms"] > 0 and stats["p50_ms"] > 0


def test_engine_forward_matches_jax(engines):
    """``InferenceEngine.forward``: full-sequence logits through the
    uncached forward with kernel injection (B1's plain version on the
    CPU) against the JAX engine's forward on the same weights (its XLA
    path), float32, atol = rtol = 1e-5."""
    jeng, peng, _ = engines
    assert peng.module.config.attn_impl == "flash"
    x = np.random.RandomState(3).randint(0, 64, (3, 21)).astype(np.int32)
    want = np.asarray(jeng.forward(x))
    got = peng.forward(x)
    assert tuple(got.shape) == (3, 21, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_serving_streams_match_generate(engines):
    """Eight staggered requests, four of them longer than the 16-token
    prefill chunk: every stream equals the port's and the JAX package's
    ``generate()``; the pool drains leak-free."""
    jeng, peng, _ = engines
    srv = peng.serving_engine()
    prompts = prompts_of((5, 9, 20, 33, 3, 14, 26, 40), 7)
    reqs = [srv.submit(p, max_new_tokens=8) for p in prompts[:3]]
    srv.step()
    reqs += [srv.submit(p, max_new_tokens=8) for p in prompts[3:6]]
    srv.step()
    srv.step()
    reqs += [srv.submit(p, max_new_tokens=8) for p in prompts[6:]]
    finished = srv.run(max_steps=300)
    assert len(finished) == 8
    for p, r in zip(prompts, reqs):
        assert r.status.value == "ok"
        want = jax_gen(jeng, p, 8)
        np.testing.assert_array_equal(r.output, want, err_msg=f"{p}")
        np.testing.assert_array_equal(
            peng.generate([p], max_new_tokens=8)[0].numpy(), want)
    srv.allocator.assert_consistent()
    assert srv.allocator.num_used == 0
    assert srv.counts["prefill_tokens"] >= sum(map(len, prompts)) - 8 * 8


def test_serving_preemption_streams_match(engines):
    """A pool too small for the load forces recompute preemption; the
    streams still equal ``generate()`` on both packages."""
    jeng, _, jp = engines
    pm = tt.TransformerLM(tt.gpt2_config("125m", dtype=torch.float32,
                                         **TINY))
    peng = dt.init_inference(pm, {
        **BASE, "max_out_tokens": 48,
        "serving": {**SERVING, "kv_block_size": 4, "num_kv_blocks": 9,
                    "max_batch_slots": 3}},
        params=params_from_jax(jp, pm), device="cpu")
    srv = peng.serving_engine()
    prompts = prompts_of((6, 7, 5, 9), 1)
    reqs = [srv.submit(p, max_new_tokens=10) for p in prompts]
    srv.run(max_steps=500)
    assert srv.scheduler.preemption_count > 0
    for p, r in zip(prompts, reqs):
        np.testing.assert_array_equal(r.output, jax_gen(jeng, p, 10))
    srv.allocator.assert_consistent()
    assert srv.allocator.num_used == 0


def test_seeded_sampled_stream_matches_generate(engines):
    """Output token j draws with (seed, j) in both paths, so a seeded
    sampled serving stream equals a seeded ``generate()`` of one row."""
    _, peng, _ = engines
    srv = peng.serving_engine()
    prompt = prompts_of((11,), 3)[0]
    req = srv.submit(prompt, max_new_tokens=8, temperature=0.9, top_k=12,
                     top_p=0.95, seed=11)
    other = srv.submit(prompts_of((5,), 4)[0], max_new_tokens=8,
                       temperature=0.9, seed=12)
    srv.run(max_steps=100)
    want = peng.generate([prompt], max_new_tokens=8, temperature=0.9,
                         top_k=12, top_p=0.95, seed=11)[0].tolist()
    assert req.output == want
    assert len(other.output) == 8


@pytest.mark.parametrize("temp,top_k,top_p", [
    (0.7, 5, 1.0), (1.0, 0, 0.6), (1.3, 8, 0.8), (1.0, 64, 0.3)])
def test_sampling_kept_set_equals_jax_support(temp, top_k, top_p):
    """On fixed logits the port's top-k/top-p kept set equals the support
    of 4000 JAX draws (``sample_tokens_per_row``), and the port's draws
    stay inside it."""
    logits = (np.random.default_rng(5).standard_normal(64) * 1.5).astype(
        np.float32)
    n = 4000
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(n))
    draws = sample_tokens_per_row(
        jnp.broadcast_to(jnp.asarray(logits), (n, 64)), keys,
        jnp.full((n,), temp), jnp.full((n,), top_k, jnp.int32),
        jnp.full((n,), top_p))
    support = set(np.asarray(draws).tolist())
    kept = torch.isfinite(filter_logits(torch.from_numpy(logits)[None],
                                        temp, top_k, top_p))[0]
    assert set(torch.nonzero(kept).flatten().tolist()) == support
    ours = sample_tokens(torch.from_numpy(logits)[None].expand(200, 64),
                         list(range(200)), [0] * 200, [temp] * 200,
                         [top_k] * 200, [top_p] * 200)
    assert set(ours.tolist()) <= support


def test_sampling_key_schedule_and_greedy():
    """A row's draw depends on its (key, index) only, not on the batch
    around it; temperature 0 is the argmax (first index on ties)."""
    rng = np.random.default_rng(9)
    logits = torch.from_numpy(rng.standard_normal((3, 64)).astype(
        np.float32))
    alone = sample_tokens(logits[:1], [42], [3], [1.0], [0], [1.0])
    batch = sample_tokens(logits, [42, 1, 2], [3, 0, 0], [1.0, 0.5, 0.0],
                          [0, 4, 0], [1.0, 0.9, 1.0])
    assert int(alone[0]) == int(batch[0])
    assert int(batch[2]) == int(torch.argmax(logits[2]))
    tie = torch.tensor([[0.0, 2.0, 2.0, 1.0]])
    assert int(sample_tokens(tie, [0], [0], [0.0], [0], [1.0])[0]) == 1


# -- config ----------------------------------------------------------------
@pytest.mark.parametrize("bad,match", [
    ({"serving": {"kv_block_size": 0}}, "kv_block_size must be >= 1"),
    ({"serving": {"num_kv_blocks": 1}}, "num_kv_blocks must be >= 2"),
    ({"serving": {"max_batch_slots": 0}}, "max_batch_slots must be >= 1"),
    ({"serving": {"prefill_chunk_tokens": 0}},
     "prefill_chunk_tokens must be >= 1"),
    ({"serving": {"kv_cache_bits": 3}}, "kv_cache_bits must be one of"),
    ({"serving": {"max_queue_depth": -1}}, "max_queue_depth must be >= 0"),
    ({"serving": {"max_preemptions": -1}}, "max_preemptions must be >= 0"),
    ({"serving": {"no_progress_steps": -1}},
     "no_progress_steps must be >= 0"),
    ({"serving": {"spec_k": 0}}, "spec_k must be >= 1"),
    ({"serving": {"default_deadline_s": -1.0}},
     "default_deadline_s must be >= 0"),
    ({"serving": {"mesh": {"data": 0}}}, "mesh.data must be >= 1"),
    ({"serving": {"mesh": {"data": 2}, "max_batch_slots": 3}},
     "must divide"),
    ({"bogus": 1}, "bogus"),
    ({"serving": {"bogus": 1}}, "bogus"),
    ({"serving": {"kv_block_size": 2.5}}, "kv_block_size"),
    ({"max_out_tokens": "many"}, "max_out_tokens"),
    ({"temperature": "hot"}, "temperature"),
    ({"dtype": 3}, "dtype"),
])
def test_config_rejects_what_jax_rejects(bad, match):
    with pytest.raises(ValueError, match=match):
        JaxConfig(**bad)
    with pytest.raises(ValueError, match=match):
        DeepSpeedInferenceConfig.from_dict(bad)


def test_config_defaults_and_coercion_match_jax():
    ours = dataclasses.asdict(DeepSpeedInferenceConfig.from_dict(
        {"top_k": 2.0, "serving": {"enabled": "yes", "kv_block_size": "8"}}))
    theirs = JaxConfig(top_k=2.0, serving={"enabled": "yes",
                                           "kv_block_size": "8"}).model_dump()
    assert ours == theirs


@pytest.mark.parametrize("override", [
    {"quant": {"enabled": True}},
    {"tensor_parallel": {"tp_size": 2}},
    {"moe": {"enabled": True}},
    {"observability": {}},
    {"checkpoint": "ckpt"},
])
def test_out_of_slice_engine_options_raise(override):
    pm = tt.TransformerLM(tt.gpt2_config("125m", dtype=torch.float32,
                                         **TINY))
    with pytest.raises(NotImplementedError, match="slice"):
        dt.init_inference(pm, {**BASE, **override}, device="cpu")


@pytest.mark.parametrize("serving", [
    {"kv_cache_bits": 8},
    {"mesh": {"model": 2}},
    {"host_cache": {"enabled": True, "dram_budget_bytes": 1 << 20}},
    {"fleet": {"enabled": True}},
])
def test_out_of_slice_serving_options_raise(engines, serving):
    _, peng, _ = engines
    pm = peng.module
    eng = dt.init_inference(pm, {**BASE, "serving": {**SERVING, **serving}},
                            params=peng.params, device="cpu")
    with pytest.raises(NotImplementedError, match="slice"):
        eng.serving_engine()


def test_out_of_slice_entry_points_raise(engines):
    """forward() runs B1 for a sequence of one block; past 1024 tokens
    the JAX package runs the two-pass kernels B3/B4, a later slice."""
    _, peng, _ = engines
    long = dt.init_inference(
        tt.TransformerLM(tt.gpt2_config("125m", dtype=torch.float32,
                                        **{**TINY, "max_seq_len": 1100})),
        BASE, device="cpu")
    with pytest.raises(NotImplementedError, match="B3.*B4"):
        long.forward(np.zeros((1, 1030), np.int32))
    with pytest.raises(NotImplementedError, match="speculative"):
        peng.serving_engine(draft_model=object())


def test_init_inference_needs_cuda_unless_cpu_requested():
    """No silent fallback: without ``device="cpu"`` the engine wants the
    card and raises on a host without one."""
    if torch.cuda.is_available():
        pytest.skip("host has a CUDA device; the refusal is for hosts "
                    "without one")
    pm = tt.TransformerLM(tt.gpt2_config("125m", dtype=torch.float32,
                                         **TINY))
    with pytest.raises(RuntimeError, match="CUDA"):
        dt.init_inference(pm, BASE)


@pytest.mark.parametrize("entry", ["init", "init_cache", "init_paged_cache"])
def test_model_entry_points_need_cuda_unless_cpu_requested(entry):
    """The model's allocating entry points default to the card too: with
    no ``device=`` they raise on a host without CUDA, and build on the
    CPU only when asked."""
    if torch.cuda.is_available():
        pytest.skip("host has a CUDA device; the refusal is for hosts "
                    "without one")
    pm = tt.TransformerLM(tt.gpt2_config("125m", dtype=torch.float32,
                                         **TINY))
    call = {"init": lambda **kw: pm.init(torch.Generator(), **kw),
            "init_cache": lambda **kw: pm.init_cache(2, 8, **kw),
            "init_paged_cache": lambda **kw: pm.init_paged_cache(4, 8, **kw)}
    with pytest.raises(RuntimeError, match="CUDA"):
        call[entry]()
    built = call[entry](device="cpu")
    leaf = built["embed"]["embedding"] if entry == "init" else built["k"]
    assert leaf.device.type == "cpu"


def test_engine_dtype_sets_model_activation_dtype(engines):
    """A bf16 model config under a float32 engine runs in float32: the
    engine rewrites the model's activation dtype to its own, so the
    kernels get q in the caches' and pools' dtype (no cast of a pool) and
    the streams equal the float32 engine's."""
    _, peng, jp = engines
    pm = tt.TransformerLM(tt.gpt2_config("125m", **TINY))
    assert pm.config.dtype == torch.bfloat16
    eng = dt.init_inference(pm, {**BASE, "serving": SERVING},
                            params=params_from_jax(jp, pm), device="cpu")
    assert eng.module.config.dtype == torch.float32
    prompts = prompts_of((6, 21), 5)
    for p in prompts:
        np.testing.assert_array_equal(
            eng.generate([p], max_new_tokens=6).numpy(),
            peng.generate([p], max_new_tokens=6).numpy())
    srv = eng.serving_engine()
    assert srv._pool_k.dtype == torch.float32
    reqs = [srv.submit(p, max_new_tokens=6) for p in prompts]
    srv.run(max_steps=100)
    for p, r in zip(prompts, reqs):
        assert r.output == peng.generate([p], max_new_tokens=6)[0].tolist()


def test_chunk_only_dispatch_runs_no_decode_lane(engines):
    """A dispatch with no decoding slot passes a decode lane of width 0:
    the chunk's logits equal those of the same step with every decode row
    inactive (to f32 rounding: the GEMMs see fewer rows), and no decode
    logits come back."""
    _, peng, _ = engines
    pm, params = peng.module, peng.params
    nslots, npages = 4, 6
    prompt = torch.tensor(prompts_of((13,), 2)[0])

    def step(width):
        pools = pm.init_paged_cache(24, 8, device="cpu")
        tables = torch.zeros((nslots, npages), dtype=torch.int32)
        tables[1, :2] = torch.tensor([3, 7])
        cache = {**pools, "block_tables": tables,
                 "lens": torch.zeros((nslots,), dtype=torch.int32)}
        zeros = torch.zeros((width,), dtype=torch.int32)
        return pm._apply_paged_mixed(params, cache, zeros, zeros, prompt,
                                     1, 0, 13)
    dec0, chunk0, cache0 = step(0)
    dec4, chunk4, cache4 = step(nslots)
    assert dec0.shape == (0, 64) and dec4.shape == (nslots, 64)
    torch.testing.assert_close(chunk0, chunk4, rtol=1e-5, atol=1e-5)
    assert cache0["lens"].tolist() == cache4["lens"].tolist() == [0, 13, 0, 0]
    dense, _ = pm.apply(params, prompt[None],
                        cache=pm.init_cache(1, 16, device="cpu"))
    full = dense[0, -1]
    torch.testing.assert_close(chunk0, full, rtol=1e-5, atol=1e-5)
