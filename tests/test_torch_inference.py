"""The port's ``init_inference`` → ``generate()`` and continuous-batching
server against the JAX package, on the same weights.

The model is the serving suite's ``tiny_cfg`` (4 layers, d_model 32,
4 heads, vocab 64) in float32 with weights from the JAX init carried by
``params_from_jax``.  Greedy token streams must be EXACTLY equal: the
port's ``generate()`` (decode through kernel B5's plain version on the
CPU) against the JAX ``generate()`` (its XLA decode path, as the JAX
serving suite pins its baseline), and the port's serving streams
(kernels B6/B7's plain versions, chunked prefill, preemption) against
both.  The tiny LLaMA (GQA 8/2, RMSNorm, SiLU gated MLP, untied head,
no biases, rotate-half rotary) is held to the same exactness, and so are
the server over an int8 KV pool (``serving.kv_cache_bits`` 8: int8
error is far below the toy models' logit gaps, as the JAX suite pins)
and the int8 weight-only engine (``quant.enabled``).
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
from deepspeed_tpu.inference.serving import block_allocator as jax_alloc
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.serving import block_allocator as alloc
from deepspeed_tpu_torch.inference.sampling import (filter_logits,
                                                    sample_tokens)
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.convert import params_from_jax

TINY = dict(num_layers=4, d_model=32, num_heads=4, vocab_size=64,
            max_seq_len=64)
BASE = {"dtype": "float32", "max_out_tokens": 64, "temperature": 0.0}
SERVING = {"enabled": True, "kv_block_size": 8, "num_kv_blocks": 48,
           "max_batch_slots": 8, "prefill_chunk_tokens": 16}
LLAMA = dict(num_layers=4, d_model=64, num_heads=8, num_kv_heads=2,
             d_ff=96, vocab_size=64, max_seq_len=64,
             pos_embedding="rotary", rotary_interleaved=False,
             norm_type="rmsnorm", activation="silu", gated_mlp=True,
             tie_embeddings=False, use_bias=False)


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


@pytest.fixture(scope="module")
def llama_engines():
    """(JAX engine, port engine) of the tiny LLaMA on the same
    JAX-initialised weights."""
    jm = jax_tf.TransformerLM(jax_tf.TransformerConfig(dtype=jnp.float32,
                                                       **LLAMA))
    jp = jax.device_get(jm.init(jax.random.PRNGKey(9)))
    jeng = ds.init_inference(jm, config={
        **BASE, "replace_with_kernel_inject": False}, params=jp)
    pm = tt.TransformerLM(tt.TransformerConfig(dtype=torch.float32,
                                               **LLAMA))
    peng = dt.init_inference(pm, {**BASE, "serving": SERVING},
                             params=params_from_jax(jp, pm), device="cpu")
    return jeng, peng


def test_llama_generate_forward_and_server_match_jax(llama_engines):
    """The tiny LLaMA: ``generate()`` (B5's plain version over the cache
    expanded over each kv group), ``forward()`` (B1's plain version at
    kv-head width) and the server (B6/B7's plain versions reading the
    pool at kv-head width, rotary at each row's position, chunked
    prefill) against the JAX engine: greedy streams exactly equal,
    logits within 1e-5."""
    jeng, peng = llama_engines
    batch = np.random.RandomState(1).randint(0, 64, (2, 7)).astype(np.int32)
    np.testing.assert_array_equal(
        peng.generate(batch, max_new_tokens=8).numpy(),
        np.asarray(jeng.generate(batch, max_new_tokens=8, temperature=0.0)))
    x = np.random.RandomState(4).randint(0, 64, (2, 19)).astype(np.int32)
    np.testing.assert_allclose(peng.forward(x).numpy(),
                               np.asarray(jeng.forward(x)), atol=1e-5,
                               rtol=1e-5)
    srv = peng.serving_engine()
    prompts = prompts_of((5, 9, 20, 33, 3, 14), 8)
    reqs = [srv.submit(p, max_new_tokens=8) for p in prompts[:3]]
    srv.step()
    reqs += [srv.submit(p, max_new_tokens=8) for p in prompts[3:]]
    assert len(srv.run(max_steps=300)) == 6
    for p, r in zip(prompts, reqs):
        assert r.status.value == "ok"
        want = jax_gen(jeng, p, 8)
        np.testing.assert_array_equal(r.output, want, err_msg=f"{p}")
        np.testing.assert_array_equal(
            peng.generate([p], max_new_tokens=8)[0].numpy(), want)
    srv.allocator.assert_consistent()
    assert srv.allocator.num_used == 0


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
    ({"serving": {"enabled": True, "fleet": {"replicas": 0}}},
     "serving.fleet.replicas must be >= 1, got 0"),
    ({"serving": {"enabled": True, "host_cache": {"wire_bits": 3}}},
     "serving.host_cache.wire_bits must be one of 0"),
    ({"serving": {"host_cache": {"enabled": True}}},
     "needs dram_budget_bytes"),
    ({"serving": {"host_cache": {"nvme_budget_bytes": 1}}},
     "requires nvme_path"),
    ({"serving": {"fleet": {"prefill_replicas": 2}}},
     "prefill_replicas must be in"),
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


@pytest.mark.parametrize("serving", [
    {"host_cache": {"enabled": True, "dram_budget_bytes": 1 << 30,
                    "nvme_budget_bytes": 1 << 32, "nvme_path": "/kv",
                    "promote_parallelism": 8, "wire_bits": 4}},
    {"fleet": {"enabled": True, "replicas": 4, "prefill_replicas": 1,
               "heartbeat_interval_s": 0.5, "heartbeat_timeout_s": 2.0,
               "promote_discount": 0.25, "chip_budget": 6}},
])
def test_valid_host_cache_and_fleet_blocks_parse_equal(serving):
    """The valid ``host_cache`` and ``fleet`` blocks parse to the JAX
    config's values."""
    cfg = {"serving": {"enabled": True, **serving}}
    ours = dataclasses.asdict(DeepSpeedInferenceConfig.from_dict(cfg))
    theirs = JaxConfig(**cfg).model_dump()
    assert ours["serving"] == theirs["serving"]


@pytest.mark.parametrize("override", [
    {"tensor_parallel": {"tp_size": 2}},
    {"moe": {"enabled": True, "ep_size": 2}},
    {"observability": {}},
])
def test_out_of_slice_engine_options_raise(override):
    """Tensor and expert parallelism, which run since their slices
    (``tests/test_torch_tp_serving.py``), raise in a world of one rank
    with the JAX engine's message (no rank runs a smaller mesh); the
    ``observability`` block, refused until the serving engine's hooks
    were ported, now builds an engine and configures the process
    telemetry (an empty block: everything off)."""
    pm = tt.TransformerLM(tt.gpt2_config("125m", dtype=torch.float32,
                                         **TINY))
    if "observability" in override:
        from deepspeed_tpu_torch.observability import (get_registry,
                                                       get_tracer)
        eng = dt.init_inference(pm, {**BASE, **override}, device="cpu")
        assert eng.config.observability is not None
        assert not get_tracer().enabled and not get_registry().enabled
        return
    tp, ep = (2, 1) if "tensor_parallel" in override else (1, 2)
    with pytest.raises(ValueError, match=f"tp_size {tp} x ep_size {ep} "
                                         f"does not divide 1 devices"):
        dt.init_inference(pm, {**BASE, **override}, device="cpu")


@pytest.mark.parametrize("serving", [
    {"mesh": {"model": 2}},
    {"host_cache": {"enabled": True, "dram_budget_bytes": 1 << 20}},
    {"fleet": {"enabled": True}},
])
def test_out_of_slice_serving_options_raise(engines, serving):
    """A serving mesh beyond 1x1, which runs since its slice
    (``tests/test_torch_tp_serving.py``), raises in a world of one rank
    with the JAX engine's message, at ``init_inference`` (the engine
    cuts its weights for the mesh); the ``host_cache`` and ``fleet``
    blocks, refused until the tiered host cache and the fleet were
    ported, now build a server (with its host tier) and a fleet."""
    _, peng, _ = engines
    pm = peng.module
    if "mesh" in serving:
        with pytest.raises(ValueError, match=r"serving.mesh \(data=1, "
                                             r"model=2\) needs 2 devices, "
                                             r"have 1"):
            dt.init_inference(pm, {**BASE, "serving": {**SERVING,
                                                       **serving}},
                              params=peng.params, device="cpu")
        return
    eng = dt.init_inference(pm, {**BASE, "serving": {**SERVING, **serving}},
                            params=peng.params, device="cpu")
    srv = eng.serving_engine()
    if "host_cache" in serving:
        assert srv.host_cache is not None
        assert srv.host_cache.tier_names == ["dram"]
        return
    from deepspeed_tpu_torch.inference.serving import FleetRouter
    fleet = FleetRouter.from_engine(eng)
    assert [r.replica_id for r in fleet.replicas] == ["r0", "r1"]
    req = fleet.submit([1, 2, 3], max_new_tokens=4)
    fleet.run()
    assert req.status.value == "ok" and len(req.output) == 4


def test_out_of_slice_entry_points_raise(engines):
    """forward() past one 1024-row block runs (B1 takes any T; the
    two-pass kernels B3/B4 are its backward) and equals the JAX model's
    logits on the same weights; a draft model arms speculative decoding
    only on the first ``serving_engine()`` call, as in the JAX engine."""
    _, peng, _ = engines
    long_tiny = {**TINY, "max_seq_len": 1100}
    jm = jax_tf.TransformerLM(jax_tf.gpt2_config("125m", dtype=jnp.float32,
                                                 **long_tiny))
    jp = jax.device_get(jm.init(jax.random.PRNGKey(2)))
    pm = tt.TransformerLM(tt.gpt2_config("125m", dtype=torch.float32,
                                         **long_tiny))
    long = dt.init_inference(pm, BASE, params=params_from_jax(jp, pm),
                             device="cpu")
    x = np.random.RandomState(6).randint(0, 64, (1, 1030)).astype(np.int32)
    np.testing.assert_allclose(long.forward(x).numpy(),
                               np.asarray(jm.apply(jp, jnp.asarray(x))),
                               atol=1e-5, rtol=1e-5)
    peng.serving_engine()
    with pytest.raises(ValueError, match="already built without this draft"):
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


def test_blocksparse_generate_and_forward_match_jax():
    """The setting of the JAX suite's sparse-decode test (GPT-2 2 layers,
    d_model 64, 2 heads, a sliding window of two 16-row blocks, prompt
    48, 6 new tokens): kernel injection keeps ``blocksparse`` in both
    engines; greedy ``generate()`` (the layout as a mask on the dense
    cache) gives JAX's tokens, each equal to the argmax of ``forward()``
    (B8's plain version) on the sequence so far; ``forward()``'s logits
    match JAX's within 1e-5.  The server refuses the model at build: its
    paged kernels do not apply the layout."""
    from deepspeed_tpu.ops import sparse_attention as jax_sa
    from deepspeed_tpu_torch.ops import sparse_attention as port_sa
    cfg = dict(num_layers=2, d_model=64, num_heads=2, vocab_size=64,
               max_seq_len=128, loss_chunk=0, attn_impl="blocksparse")
    skw = dict(num_heads=2, block=16, num_sliding_window_blocks=2)
    jm = jax_tf.TransformerLM(jax_tf.gpt2_config(
        "125m", dtype=jnp.float32,
        sparsity_config=jax_sa.LocalSlidingWindowSparsityConfig(**skw),
        **cfg))
    jp = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    base = {"dtype": "float32", "max_out_tokens": 128, "prompt_bucket": 0,
            "temperature": 0.0}
    jeng = ds.init_inference(jm, params=jp, config=base)
    pm = tt.TransformerLM(tt.gpt2_config(
        "125m", dtype=torch.float32,
        sparsity_config=port_sa.LocalSlidingWindowSparsityConfig(**skw),
        **cfg))
    peng = dt.init_inference(pm, {**base, "serving": SERVING},
                             params=params_from_jax(jp, pm), device="cpu")
    assert jeng.module.config.attn_impl == "blocksparse"
    assert peng.module.config.attn_impl == "blocksparse"
    x = np.random.RandomState(0).randint(0, 64, (2, 48)).astype(np.int32)
    out = peng.generate(x, max_new_tokens=6).numpy()
    np.testing.assert_array_equal(out, np.asarray(
        jeng.generate(x, max_new_tokens=6, temperature=0.0)))
    cur = x
    for t in range(6):
        logits = peng.forward(cur).numpy()
        if t == 0:
            np.testing.assert_allclose(logits, np.asarray(jeng.forward(cur)),
                                       atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(out[:, t], logits[:, -1].argmax(-1))
        cur = np.concatenate([cur, out[:, t:t + 1].astype(np.int32)], 1)
    with pytest.raises(NotImplementedError, match="block-sparse layout"):
        peng.serving_engine()


# -- quantized KV pools and int8 weights --------------------------------------
#: JAX's kv8 pin: a 24-token prompt (3 full blocks) shared by a warm
#: resubmission, and two more
KV8_LENS, KV8_SEED, KV8_NEW = (24, 7, 13), 17, 6


def _serve(eng, prompts, new):
    """Drain ``prompts`` then resubmit the first (warm: it hits the
    committed blocks): (streams, the resubmission's hit tokens, server)."""
    srv = eng.serving_engine()
    reqs = [srv.submit(p, max_new_tokens=new) for p in prompts]
    srv.run(max_steps=300)
    warm = srv.submit(prompts[0], max_new_tokens=new)
    srv.run(max_steps=300)
    return ([list(map(int, r.output)) for r in reqs + [warm]],
            warm.cache_hit_tokens, srv)


@pytest.fixture(scope="module")
def kv8_oracles():
    """The JAX servers' greedy kv8 streams (GPT-2 and LLaMA), run once."""
    out = {}
    for name, cfg, seed in (
            ("gpt2", jax_tf.gpt2_config("125m", dtype=jnp.float32, **TINY),
             7),
            ("llama", jax_tf.TransformerConfig(dtype=jnp.float32, **LLAMA),
             9)):
        jm = jax_tf.TransformerLM(cfg)
        jp = jax.device_get(jm.init(jax.random.PRNGKey(seed)))
        jeng = ds.init_inference(jm, config={
            **BASE, "replace_with_kernel_inject": False,
            "serving": {**SERVING, "kv_cache_bits": 8}}, params=jp)
        prompts = prompts_of(KV8_LENS, KV8_SEED)
        out[name] = (jp, _serve(jeng, prompts, KV8_NEW)[:2])
    return out


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_kv8_server_streams_match_generate_and_jax(kv8_oracles, family):
    """``serving.kv_cache_bits`` 8 (int8 pools, f32 scales; kernels B6/B7's
    plain versions dequantize the rows): greedy streams EXACTLY equal to
    ``generate()`` on the dense f32 cache and to the JAX server's; the
    warm resubmission reuses the quantized blocks (16 hit tokens: values
    and scales ride the block ids) and still gives the same stream."""
    jp, (jstreams, jhit) = kv8_oracles[family]
    cfg = (tt.gpt2_config("125m", dtype=torch.float32, **TINY)
           if family == "gpt2"
           else tt.TransformerConfig(dtype=torch.float32, **LLAMA))
    pm = tt.TransformerLM(cfg)
    eng = dt.init_inference(pm, {**BASE, "serving": {
        **SERVING, "kv_cache_bits": 8}}, params=params_from_jax(jp, pm),
        device="cpu")
    prompts = prompts_of(KV8_LENS, KV8_SEED)
    streams, hit, srv = _serve(eng, prompts, KV8_NEW)
    assert srv.kv_bits == 8 and srv._pool_k.dtype == torch.int8
    assert srv._pool_ks.dtype == torch.float32
    assert hit == jhit == 16
    assert streams == jstreams
    for p, got in zip(prompts + prompts[:1], streams):
        assert got == eng.generate([p], max_new_tokens=KV8_NEW)[0].tolist()
    srv.allocator.assert_consistent()
    assert srv.allocator.num_used == 0


def test_kv4_server_drains_clean(engines):
    """Packed int4 (JAX's ``test_kv4_serves_and_drains_clean``): streams are
    not pinned exact (4-bit KV on an 8-dim toy head is lossy) but the
    server drains leak-free with full-length in-vocab streams, over a pool
    packed at head_dim / 2."""
    _, peng, _ = engines
    pm = peng.module
    eng = dt.init_inference(pm, {**BASE, "serving": {
        **SERVING, "kv_cache_bits": 4}}, params=peng.params, device="cpu")
    srv = eng.serving_engine()
    assert srv._pool_k.shape[-1] == pm.config.hdim // 2 == 4
    reqs = [srv.submit(p, max_new_tokens=5) for p in prompts_of((9, 6), 19)]
    assert len(srv.run(max_steps=200)) == 2
    for r in reqs:
        assert r.status.value == "ok" and len(r.output) == 5
        assert all(0 <= t < 64 for t in r.output)
    srv.allocator.assert_consistent()
    assert srv.allocator.num_used == 0


@pytest.mark.parametrize("kv_bits", [0, 8, 4])
def test_kv_block_bytes_match_jax_and_the_pool(kv_bits):
    """The capacity helpers equal JAX's and are pinned to the bytes
    ``init_paged_cache`` allocates; a model-sharded mesh's per-rank
    count (since its slice) is JAX's too, and is the bytes of the
    per-shard view's pool."""
    for blk, hkv, hd, item in ((16, 32, 128, 2), (8, 4, 8, 4),
                               (16, 4, 64, 2)):
        assert alloc.kv_block_bytes(blk, hkv, hd, kv_bits, item) == \
            jax_alloc.kv_block_bytes(blk, hkv, hd, kv_bits, item)
        for budget in (1 << 20, 4096 * 2 ** 20):
            assert alloc.blocks_for_budget(budget, blk, hkv, hd, kv_bits,
                                           item) == \
                jax_alloc.blocks_for_budget(budget, blk, hkv, hd, kv_bits,
                                            item)
    pm = tt.TransformerLM(tt.gpt2_config("125m", dtype=torch.float32,
                                         **TINY))
    pools = pm.init_paged_cache(12, 8, kv_bits=kv_bits, device="cpu")
    nbytes = sum(t.numel() * t.element_size() for t in pools.values())
    per_layer = alloc.kv_block_bytes(8, pm.config.kv_heads, pm.config.hdim,
                                     kv_bits, cache_itemsize=4)
    assert nbytes == 12 * pm.config.num_layers * per_layer
    assert alloc.kv_block_bytes(16, 4, 64, kv_bits, model_shards=2) == \
        jax_alloc.kv_block_bytes(16, 4, 64, kv_bits, model_shards=2)
    view = pm.tp_serving_view(2, "model", None)
    pools = view.init_paged_cache(12, 8, kv_bits=kv_bits, device="cpu")
    assert sum(t.numel() * t.element_size() for t in pools.values()) == \
        12 * pm.config.num_layers * alloc.kv_block_bytes(
            8, pm.config.kv_heads, pm.config.hdim, kv_bits,
            cache_itemsize=4, model_shards=2)


@pytest.fixture(scope="module")
def int8_engines(engines):
    """JAX and port engines with ``quant.enabled`` on the same weights."""
    _, peng, jp = engines
    cfg = {**BASE, "quant": {"enabled": True, "bits": 8}}
    jm = jax_tf.TransformerLM(jax_tf.gpt2_config("125m", dtype=jnp.float32,
                                                 **TINY))
    jeng = ds.init_inference(jm, config={
        **cfg, "replace_with_kernel_inject": False}, params=jp)
    pm = tt.TransformerLM(tt.gpt2_config("125m", dtype=torch.float32,
                                         **TINY))
    qeng = dt.init_inference(pm, {**cfg, "serving": SERVING},
                             params=params_from_jax(jp, pm), device="cpu")
    return jeng, qeng


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield path, tree


def test_int8_weights_equal_jax_leaf_by_leaf(int8_engines):
    """``quant.enabled``: the int8 values and f32 group scales equal the
    JAX engine's leaf by leaf, the blocks' 1-D leaves (biases, LayerNorm
    scales, stacked ``[L, d]``) included, embeddings kept in f32."""
    jeng, qeng = int8_engines
    jparams = dict(_flat(jax.device_get(jeng.params)))
    jscales = dict(_flat(jax.device_get(jeng._scales)))
    pparams, pscales = dict(_flat(qeng.params)), dict(_flat(qeng._scales))
    assert set(pparams) == set(jparams) and set(pscales) == set(jscales)
    for path, want in jparams.items():
        got = pparams[path]
        assert str(got.dtype).split(".")[-1] == want.dtype.name, path
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{path}")
        np.testing.assert_array_equal(pscales[path].numpy(), jscales[path],
                                      err_msg=f"{path}")
    assert pparams[("blocks", "ln1", "bias")].dtype == torch.int8
    assert pparams[("embed", "embedding")].dtype == torch.float32


def test_int8_weights_forward_generate_and_server_match_jax(int8_engines):
    """The int8 engine's ``forward()`` logits within 1e-5 of the JAX int8
    engine's; greedy ``generate()`` equal to JAX's; the server (per-layer
    dequant through the model's seam, here over an f32 pool) equal to
    both, as JAX's ``test_int8_weights_serve_through_paged_path``."""
    jeng, qeng = int8_engines
    x = np.random.RandomState(3).randint(0, 64, (2, 11)).astype(np.int32)
    np.testing.assert_allclose(qeng.forward(x).numpy(),
                               np.asarray(jeng.forward(x)), atol=1e-5,
                               rtol=1e-5)
    prompts = prompts_of((6, 10), 2)
    srv = qeng.serving_engine()
    reqs = [srv.submit(p, max_new_tokens=5) for p in prompts]
    srv.run(max_steps=100)
    for p, r in zip(prompts, reqs):
        want = jax_gen(jeng, p, 5)
        np.testing.assert_array_equal(
            qeng.generate([p], max_new_tokens=5)[0].numpy(), want)
        np.testing.assert_array_equal(r.output, want)
    assert srv.allocator.num_used == 0


@pytest.mark.parametrize("quant", [False, True], ids=["f16", "f16-int8w"])
def test_fp16_generate_forward_and_server_match_jax(quant):
    """``init_inference(dtype="float16")`` (C2 closed: B5-B7's plain
    versions in float16 here), with and without int8 weights
    (``quant.enabled``), against the JAX engine in float16 on the same
    weights: greedy ``generate()`` streams and every server stream
    (chunked prefill, B6/B7 over a float16 pool) exactly equal to the JAX
    ``generate()``; ``forward()``'s logits within 2e-3 (float16
    activations rounded at other points)."""
    jm = jax_tf.TransformerLM(jax_tf.gpt2_config("125m", dtype=jnp.float16,
                                                 **TINY))
    jp = jax.device_get(jm.init(jax.random.PRNGKey(7)))
    cfg = {**BASE, "dtype": "float16",
           **({"quant": {"enabled": True}} if quant else {})}
    jeng = ds.init_inference(jm, config={
        **cfg, "replace_with_kernel_inject": False}, params=jp)
    pm = tt.TransformerLM(tt.gpt2_config("125m", dtype=torch.float32,
                                         **TINY))
    peng = dt.init_inference(pm, {**cfg, "serving": SERVING},
                             params=params_from_jax(jp, pm), device="cpu")
    assert peng.module.config.dtype == torch.float16
    batch = np.random.RandomState(1).randint(0, 64, (2, 7)).astype(np.int32)
    np.testing.assert_array_equal(
        peng.generate(batch, max_new_tokens=8).numpy(),
        np.asarray(jeng.generate(batch, max_new_tokens=8, temperature=0.0)))
    x = np.random.RandomState(4).randint(0, 64, (2, 19)).astype(np.int32)
    np.testing.assert_allclose(peng.forward(x).numpy(),
                               np.asarray(jeng.forward(x), np.float32),
                               atol=2e-3, rtol=2e-3)
    srv = peng.serving_engine()
    assert srv._pool_k.dtype == torch.float16
    prompts = prompts_of((5, 9, 20, 33, 3, 14), 8)
    reqs = [srv.submit(p, max_new_tokens=8) for p in prompts[:3]]
    srv.step()
    reqs += [srv.submit(p, max_new_tokens=8) for p in prompts[3:]]
    assert len(srv.run(max_steps=300)) == 6
    for p, r in zip(prompts, reqs):
        assert r.status.value == "ok"
        np.testing.assert_array_equal(r.output, jax_gen(jeng, p, 8),
                                      err_msg=f"{p}")
    srv.allocator.assert_consistent()
