"""The port's GPT-2 and LLaMA models against the JAX package's, on the
same weights.

Weights come from the JAX ``TransformerLM.init`` and cross with
``params_from_jax``; the GPT-2 model is the serving suite's ``tiny_cfg``
(4 layers, d_model 32, 4 heads, vocab 64) and the LLaMA model ``LLAMA``
(4 layers, d_model 64, 8 query heads over 2 kv heads, d_ff 96, vocab 64,
RMSNorm, SiLU gated MLP, untied head, no biases, rotary in both
pairings), in float32.  Logits are compared at atol = rtol = 1e-5 (same
math in f32; only the summation order differs).  The JAX side's Pallas
kernels run in interpret mode on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import transformer as jax_tf
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.convert import (check_params,
                                                params_from_jax,
                                                params_to_jax)

TOL = dict(atol=1e-5, rtol=1e-5)
TINY = dict(num_layers=4, d_model=32, num_heads=4, vocab_size=64,
            max_seq_len=64)
#: the tiny LLaMA: GQA 8/2, RMSNorm, SiLU gated MLP, untied head, no
#: bias, rotate-half rotary (``rotary_interleaved`` varies in the tests)
LLAMA = dict(num_layers=4, d_model=64, num_heads=8, num_kv_heads=2,
             d_ff=96, vocab_size=64, max_seq_len=1100,
             pos_embedding="rotary", rotary_interleaved=False,
             norm_type="rmsnorm", activation="silu", gated_mlp=True,
             tie_embeddings=False, use_bias=False)


def jax_model(attn_impl="xla"):
    return jax_tf.TransformerLM(jax_tf.gpt2_config(
        "125m", dtype=jnp.float32, attn_impl=attn_impl, **TINY))


def port_model(attn_impl="xla"):
    return tt.TransformerLM(tt.gpt2_config(
        "125m", dtype=torch.float32, attn_impl=attn_impl, **TINY))


@pytest.fixture(scope="module")
def weights():
    """JAX init (seed 3) as numpy, and the same tree as port tensors."""
    jp = jax.device_get(jax_model().init(jax.random.PRNGKey(3)))
    return jp, params_from_jax(jp, port_model())


def ids(b, t, seed):
    return np.random.default_rng(seed).integers(0, 64, (b, t)).astype(
        np.int32)


def llama_models(attn_impl="xla", **kw):
    """(JAX model, port model) of the tiny LLaMA in float32."""
    cfg = {**LLAMA, "attn_impl": attn_impl, **kw}
    return (jax_tf.TransformerLM(jax_tf.TransformerConfig(
                dtype=jnp.float32, **cfg)),
            tt.TransformerLM(tt.TransformerConfig(dtype=torch.float32,
                                                  **cfg)))


@pytest.fixture(scope="module")
def llama_weights():
    """JAX init (seed 11) of the tiny LLaMA as numpy, and as port
    tensors."""
    jm, pm = llama_models()
    jp = jax.device_get(jm.init(jax.random.PRNGKey(11)))
    return jp, params_from_jax(jp, pm)


@pytest.mark.parametrize("interleaved", [False, True])
@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_llama_full_sequence_logits_match_jax(llama_weights, attn_impl,
                                              interleaved):
    """Full-sequence logits: plain GQA attention (``xla``) or flash
    attention at kv-head width (B1's plain version; the JAX kernel in
    interpret mode), rotary in both pairings."""
    jp, tp = llama_weights
    jm, pm = llama_models(attn_impl, rotary_interleaved=interleaved)
    x = ids(2, 13, 4)
    want = np.asarray(jm.apply(jp, jnp.asarray(x)))
    got = pm.apply(tp, torch.from_numpy(x).long()).numpy()
    assert got.shape == (2, 13, 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("interleaved", [False, True])
@pytest.mark.parametrize("attn_impl", ["flash", "xla"])
def test_llama_cache_prefill_and_decode_match_jax(llama_weights, attn_impl,
                                                  interleaved):
    """Dense-cache prefill then three t == 1 decode steps: the cache at
    kv-head width, rotary at the cache index; decode through kernel B5
    (its plain version) over the cache at kv-head width with ``flash``
    (JAX expands it over the group first), plain GQA attention with
    ``xla``."""
    jp, tp = llama_weights
    jm, pm = llama_models(attn_impl, rotary_interleaved=interleaved)
    x = ids(2, 9, 5)
    jc = jm.init_cache(2, 16, dtype=jnp.float32)
    pc = pm.init_cache(2, 16, dtype=torch.float32, device="cpu")
    assert tuple(pc["k"].shape) == (4, 2, 16, 2, 8)
    jl, jc = jm.apply(jp, jnp.asarray(x), cache=jc)
    pl_, pc = pm.apply(tp, torch.from_numpy(x).long(), cache=pc)
    np.testing.assert_allclose(pl_.numpy(), np.asarray(jl), **TOL)
    for step in range(3):
        tok = ids(2, 1, 20 + step)
        jl, jc = jm.apply(jp, jnp.asarray(tok), cache=jc)
        pl_, pc = pm.apply(tp, torch.from_numpy(tok).long(), cache=pc)
        np.testing.assert_allclose(pl_.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(pc["k"].numpy()[:, :, :12],
                               np.asarray(jc["k"])[:, :, :12], **TOL)


def test_llama_dense_decode_reads_the_cache_at_kv_head_width(
        llama_weights, monkeypatch):
    """The flash model's t == 1 decode hands kernel B5 the layer's cache
    as it is, [B, S, Hkv, D] with Hkv = kv_heads (no copy expanded over
    the group), and its logits still equal the JAX model's, which
    expands the cache with ``expand_kv`` before its kernel."""
    jp, tp = llama_weights
    jm, pm = llama_models("flash")
    seen = []

    def spy(q, k, v, length, sm_scale=None):
        seen.append((tuple(q.shape), tuple(k.shape), k.data_ptr()))
        return real(q, k, v, length, sm_scale)
    real = tt.decode_attention
    monkeypatch.setattr(tt, "decode_attention", spy)
    x = ids(2, 7, 41)
    jc = jm.init_cache(2, 12, dtype=jnp.float32)
    pc = pm.init_cache(2, 12, dtype=torch.float32, device="cpu")
    jl, jc = jm.apply(jp, jnp.asarray(x), cache=jc)
    _, pc = pm.apply(tp, torch.from_numpy(x).long(), cache=pc)
    assert not seen                      # the prefill does not decode
    for step in range(2):
        tok = ids(2, 1, 50 + step)
        jl, jc = jm.apply(jp, jnp.asarray(tok), cache=jc)
        pl_, pc = pm.apply(tp, torch.from_numpy(tok).long(), cache=pc)
        np.testing.assert_allclose(pl_.numpy(), np.asarray(jl), **TOL)
    cfg = pm.config
    assert len(seen) == 2 * cfg.num_layers
    layer_ptrs = {pc["k"][i].data_ptr() for i in range(cfg.num_layers)}
    for qs, ks, ptr in seen:
        assert qs == (2, cfg.num_heads, cfg.hdim)
        assert ks == (2, 12, cfg.kv_heads, cfg.hdim)
        assert cfg.kv_heads < cfg.num_heads
        assert ptr in layer_ptrs         # the cache itself, not a copy


def test_llama_param_tree_and_sizes_match_jax(llama_weights):
    """The LLaMA tree (no pos_embed, scale-only RMSNorm, fc_gate,
    lm_head, no biases) has JAX's paths and shapes, its size is JAX's
    num_params, and it crosses back unchanged."""
    jp, tp = llama_weights
    jm, pm = llama_models()
    jshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
    pshapes = jax.tree_util.tree_map(tuple, pm.param_shapes(),
                                     is_leaf=lambda x: isinstance(x, tuple))
    assert jshapes == pshapes
    assert "pos_embed" not in tp and set(tp["ln_f"]) == {"scale"}
    assert tuple(tp["lm_head"]["kernel"].shape) == (64, 64)
    assert pm.config.num_params() == jm.config.num_params() == sum(
        int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(jp))
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           params_to_jax(tp), jp)
    fresh = pm.init(torch.Generator().manual_seed(1), "cpu")
    check_params(pm, fresh)


def test_full_sequence_logits_match_jax(weights):
    jp, tp = weights
    x = ids(2, 11, 0)
    want = np.asarray(jax_model().apply(jp, jnp.asarray(x)))
    got = port_model().apply(tp, torch.from_numpy(x).long()).numpy()
    assert got.shape == (2, 11, 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("attn_impl", ["flash", "xla"])
def test_cache_prefill_and_decode_logits_match_jax(weights, attn_impl):
    """Dense-cache prefill (plain attention) then two t == 1 decode steps
    (kernel B5 with ``flash``; plain attention with ``xla``)."""
    jp, tp = weights
    jm, pm = jax_model(attn_impl), port_model(attn_impl)
    x = ids(2, 9, 1)
    jc = jm.init_cache(2, 16, dtype=jnp.float32)
    pc = pm.init_cache(2, 16, dtype=torch.float32, device="cpu")
    jl, jc = jm.apply(jp, jnp.asarray(x), cache=jc)
    pl_, pc = pm.apply(tp, torch.from_numpy(x).long(), cache=pc)
    np.testing.assert_allclose(pl_.numpy(), np.asarray(jl), **TOL)
    for step in range(2):
        tok = ids(2, 1, 10 + step)
        jl, jc = jm.apply(jp, jnp.asarray(tok), cache=jc)
        pl_, pc = pm.apply(tp, torch.from_numpy(tok).long(), cache=pc)
        assert pc["index"] == int(jc["index"]) == 10 + step
        np.testing.assert_allclose(pl_.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(pc["k"].numpy()[:, :, :11],
                               np.asarray(jc["k"])[:, :, :11], **TOL)


def test_param_tree_and_sizes_match_jax(weights):
    jp, tp = weights
    jshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
    pshapes = jax.tree_util.tree_map(tuple, port_model().param_shapes(),
                                     is_leaf=lambda x: isinstance(x, tuple))
    assert jshapes == pshapes
    assert tt.GPT2_SIZES == jax_tf.GPT2_SIZES
    for size in tt.GPT2_SIZES:
        assert (tt.gpt2_config(size).num_params()
                == jax_tf.gpt2_config(size).num_params())
    # and the JAX tree comes back unchanged
    back = params_to_jax(tp)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, jp)


def test_fresh_init_matches_tree_and_is_seeded():
    pm = port_model()
    a = pm.init(torch.Generator().manual_seed(5), "cpu")
    b = pm.init(torch.Generator().manual_seed(5), "cpu")
    check_params(pm, a)
    jax.tree_util.tree_map(lambda x, y: torch.testing.assert_close(x, y),
                           a, b)
    assert float(a["blocks"]["ln1"]["scale"].min()) == 1.0
    std = float(a["embed"]["embedding"].std())
    assert 0.015 < std < 0.025


def test_params_shape_mismatch_is_named(weights):
    jp, _ = weights
    bad = jax.tree_util.tree_map(lambda a: a, jp)
    bad["blocks"]["mlp"]["fc_in"]["kernel"] = np.zeros((4, 32, 100),
                                                       np.float32)
    with pytest.raises(ValueError, match=r"blocks\.mlp\.fc_in\.kernel"):
        params_from_jax(bad, port_model())


#: the overrides that still raise (none since MoE landed); the others
#: are the LLaMA, BLOOM and NeoX families' pieces and MoE
_STILL_OUT = ()


@pytest.mark.parametrize("override", [
    dict(pos_embedding="rotary"), dict(pos_embedding="alibi"),
    dict(norm_type="rmsnorm"), dict(gated_mlp=True),
    dict(num_kv_heads=2), dict(parallel_residual=True),
    dict(moe_num_experts=4), dict(activation="silu"),
])
def test_out_of_slice_families_raise(override):
    """Rotary, RMSNorm, the gated MLP, GQA and SiLU (the LLaMA family's
    pieces), ALiBi (BLOOM's), the parallel residual (NeoX's) and MoE
    (4 experts on every other layer) each alone on the GPT-2 model give
    JAX's logits on JAX's weights."""
    cfg = dataclasses.replace(tt.gpt2_config("125m", **TINY), **override)
    if override in _STILL_OUT:
        with pytest.raises(NotImplementedError, match="later|slice"):
            tt.TransformerLM(cfg)
        return
    jm = jax_tf.TransformerLM(jax_tf.gpt2_config(
        "125m", dtype=jnp.float32, **TINY, **override))
    pm = tt.TransformerLM(dataclasses.replace(cfg, dtype=torch.float32))
    jp = jax.device_get(jm.init(jax.random.PRNGKey(4)))
    x = ids(2, 10, 6)
    np.testing.assert_allclose(
        pm.apply(params_from_jax(jp, pm), torch.from_numpy(x).long()).numpy(),
        np.asarray(jm.apply(jp, jnp.asarray(x))), **TOL)


def test_uncached_flash_forward_raises(llama_weights):
    """Past one 1024-row block the uncached flash forward runs (B1 takes
    any T; its backward is B3/B4): the tiny LLaMA's logits at T 1030
    match the JAX model's flash forward (its Pallas kernel in interpret
    mode, two 1024-row blocks)."""
    jp, tp = llama_weights
    jm, pm = llama_models("flash")
    x = ids(1, 1030, 7)
    want = np.asarray(jm.apply(jp, jnp.asarray(x)))
    got = pm.apply(tp, torch.from_numpy(x).long()).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("t", [11, 64])
def test_uncached_flash_forward_matches_jax(weights, t):
    """Full-sequence logits through flash attention (the port's B1 plain
    version; the JAX Pallas kernel in interpret mode) on the same
    weights."""
    jp, tp = weights
    x = ids(2, t, 2)
    want = np.asarray(jax_model("flash").apply(jp, jnp.asarray(x)))
    got = port_model("flash").apply(tp, torch.from_numpy(x).long()).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_layer_views_are_views_of_the_stack(weights):
    """One unbind per leaf: layer i's leaves share storage with the
    stacked tensors, and their gradient flows back as one stack."""
    _, tp = weights
    stack = tp["blocks"]["mlp"]["fc_in"]["kernel"].clone().requires_grad_()
    layers = tt.layer_views({"mlp": {"fc_in": {"kernel": stack}}})
    assert len(layers) == TINY["num_layers"]
    assert layers[2]["mlp"]["fc_in"]["kernel"].data_ptr() == \
        stack[2].data_ptr()
    sum((i + 1) * l["mlp"]["fc_in"]["kernel"].sum()
        for i, l in enumerate(layers)).backward()
    assert [float(g.mean()) for g in stack.grad] == [1.0, 2.0, 3.0, 4.0]


# -- block-sparse attention ---------------------------------------------------
from deepspeed_tpu.ops import sparse_attention as jax_sa  # noqa: E402
from deepspeed_tpu_torch.ops import sparse_attention as port_sa  # noqa: E402

#: the tiny block-sparse GPT-2: 2 layers, d_model 64, 2 heads, T 256
SPARSE = dict(num_layers=2, d_model=64, num_heads=2, vocab_size=64,
              max_seq_len=256, attn_impl="blocksparse")


def sparse_models(family="FixedSparsityConfig", base=None, **skw):
    """(JAX model, port model) in float32 with one sparsity config built
    in each package from the same arguments."""
    base = base or dict(SPARSE)
    heads = base["num_heads"]
    skw = skw or dict(block=32, num_local_blocks=2, num_global_blocks=1)
    cfg = {**base, "attn_impl": "blocksparse"}
    return (jax_tf.TransformerLM(jax_tf.TransformerConfig(
                dtype=jnp.float32, sparsity_config=getattr(jax_sa, family)(
                    num_heads=heads, **skw), **cfg)),
            tt.TransformerLM(tt.TransformerConfig(
                dtype=torch.float32, sparsity_config=getattr(port_sa, family)(
                    num_heads=heads, **skw), **cfg)))


@pytest.fixture(scope="module")
def sparse_weights():
    jm, pm = sparse_models()
    jp = jax.device_get(jm.init(jax.random.PRNGKey(12)))
    return jp, params_from_jax(jp, pm)


@pytest.mark.parametrize("t", [256, 200])
def test_blocksparse_logits_match_jax(sparse_weights, t):
    """Full-sequence logits of the block-sparse GPT-2 (Fixed layout,
    block 32): at T 256 through B8 (its plain version; the JAX kernel in
    interpret mode), at T 200, which the block does not divide, through
    plain attention masked by the layout on both sides."""
    jp, tp = sparse_weights
    jm, pm = sparse_models()
    x = ids(2, t, 8)
    want = np.asarray(jm.apply(jp, jnp.asarray(x)))
    got = pm.apply(tp, torch.from_numpy(x).long()).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_blocksparse_llama_expands_kv_as_jax():
    """The tiny LLaMA (8 query heads over 2 kv heads) with a sliding
    window of 16-row blocks: k/v expanded over the group, then B8 at
    T 128; the same layout as a mask on the plain GQA path at T 120."""
    base = {**LLAMA, "max_seq_len": 128}
    jm, pm = sparse_models("LocalSlidingWindowSparsityConfig", base,
                           block=16, num_sliding_window_blocks=3)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(13)))
    tp = params_from_jax(jp, pm)
    for t in (128, 120):
        x = ids(1, t, 9)
        np.testing.assert_allclose(
            pm.apply(tp, torch.from_numpy(x).long()).numpy(),
            np.asarray(jm.apply(jp, jnp.asarray(x))), **TOL)


def test_blocksparse_cache_decode_applies_the_layout(sparse_weights):
    """Dense-cache prefill of 100 tokens and three decode steps apply the
    trained layout through the mask, as the JAX model does (with a
    Fixed layout of 32-row blocks, row 100 no longer sees rows 0-31);
    a cache past max_seq_len raises."""
    jp, tp = sparse_weights
    jm, pm = sparse_models()
    x = ids(2, 100, 10)
    jc = jm.init_cache(2, 128, dtype=jnp.float32)
    pc = pm.init_cache(2, 128, dtype=torch.float32, device="cpu")
    jl, jc = jm.apply(jp, jnp.asarray(x), cache=jc)
    pl_, pc = pm.apply(tp, torch.from_numpy(x).long(), cache=pc)
    np.testing.assert_allclose(pl_.numpy(), np.asarray(jl), **TOL)
    for step in range(3):
        tok = ids(2, 1, 30 + step)
        jl, jc = jm.apply(jp, jnp.asarray(tok), cache=jc)
        pl_, pc = pm.apply(tp, torch.from_numpy(tok).long(), cache=pc)
        np.testing.assert_allclose(pl_.numpy(), np.asarray(jl), **TOL)
    big = pm.init_cache(1, 288, dtype=torch.float32, device="cpu")
    with pytest.raises(NotImplementedError, match="exceeds the training"):
        pm.apply(tp, torch.from_numpy(ids(1, 4, 0)).long(), cache=big)


def test_blocksparse_needs_a_sparsity_config():
    """attn_impl="blocksparse" without a sparsity_config raises JAX's
    ValueError at the first forward; ring and ulysses still raise at
    build."""
    pm = tt.TransformerLM(tt.TransformerConfig(dtype=torch.float32,
                                               **SPARSE))
    tp = pm.init(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="sparsity_config"):
        pm.loss(tp, {"input_ids": torch.zeros((1, 64), dtype=torch.long)})
    for impl in ("ring", "ulysses"):
        with pytest.raises(NotImplementedError, match=impl):
            tt.TransformerLM(tt.TransformerConfig(**{**SPARSE,
                                                     "attn_impl": impl}))


# -- quantized paged pools (serving.kv_cache_bits) --------------------------
@pytest.mark.parametrize("kv_bits", [8, 4])
def test_init_paged_cache_quantized_matches_jax(kv_bits):
    """int8 pools at head_dim (8-bit) or packed at head_dim / 2 (4-bit),
    f32 scales ``[L, nb, blk, Hkv]``: the JAX model's shapes and dtypes,
    all zeros; an odd head_dim cannot pack and a width outside 0/4/8
    raises."""
    jc = jax_model().init_paged_cache(6, 8, kv_bits=kv_bits)
    pc = port_model().init_paged_cache(6, 8, kv_bits=kv_bits, device="cpu")
    assert set(pc) == set(jc) == {"k", "v", "k_scale", "v_scale"}
    for key in jc:
        assert tuple(pc[key].shape) == jc[key].shape
        assert str(pc[key].dtype).split(".")[-1] == jc[key].dtype.name
        assert not pc[key].any()
    assert pc["k"].shape[-1] == (8 if kv_bits == 8 else 4)
    odd = tt.TransformerLM(tt.gpt2_config(
        "125m", dtype=torch.float32, **{**TINY, "d_model": 36}))
    with pytest.raises(ValueError, match="even head_dim"):
        odd.init_paged_cache(6, 8, kv_bits=4, device="cpu")
    with pytest.raises(ValueError, match="kv_bits"):
        port_model().init_paged_cache(6, 8, kv_bits=3, device="cpu")


def _ints(pool: np.ndarray, kv_bits: int) -> np.ndarray:
    """A pool's integer values (packed int4 split back into features)."""
    x = pool.astype(np.int32)
    if kv_bits == 4:
        x = np.concatenate([((x & 0xF) ^ 8) - 8, x >> 4], axis=-1)
    return x


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_paged_mixed_steps_quantized_match_jax(weights, kv_bits):
    """Three mixed steps on a quantized pool, each run by the JAX model
    (its Pallas kernels interpreted) and the port on its own cache, each
    chunk padded to 16 tokens: a 13-token chunk; a decode row plus a
    second slot's 10-token chunk; two decode rows plus a third slot's
    7-token chunk.  Logits within 1e-5; the
    written scales within 1e-6 relative; the integer values equal on at
    least 99.9 % of entries and never off by more than 1 (k/v differ at
    f32 rounding, which moves a value sitting on a .5 boundary)."""
    jp, pp = weights
    jm, pm = jax_model(), port_model()
    nb, blk, nslots, npages = 24, 8, 4, 6
    jc = dict(jm.init_paged_cache(nb, blk, kv_bits=kv_bits))
    pc = pm.init_paged_cache(nb, blk, kv_bits=kv_bits, device="cpu")
    tables = np.zeros((nslots, npages), np.int32)
    tables[0, :3], tables[1, :2], tables[2, :2] = [4, 9, 2], [7, 11], [3, 15]
    rng = np.random.default_rng(kv_bits)
    prompts = [rng.integers(0, 64, n).astype(np.int32) for n in (13, 10, 7)]
    lens = np.zeros(nslots, np.int32)
    jax_step = jax.jit(jm._apply_paged_mixed)      # one program, 3 steps
    for decoding, slot in (([], 0), ([0], 1), ([0, 1], 2)):
        dec_active = np.zeros(nslots, np.int32)
        dec_active[decoding] = 1
        dec_tokens = rng.integers(0, 64, nslots).astype(np.int32)
        n = len(prompts[slot])
        chunk = np.zeros(16, np.int32)
        chunk[:n] = prompts[slot]
        args = (dec_tokens, dec_active, chunk, slot, 0, n)
        jd, jcl, jc = jax_step(
            jp, {**jc, "block_tables": jnp.asarray(tables),
                 "lens": jnp.asarray(lens)},
            *(jnp.asarray(a, jnp.int32) for a in args))
        pd, pcl, pcache = pm._apply_paged_mixed(
            pp, {**pc, "block_tables": torch.from_numpy(tables),
                 "lens": torch.from_numpy(lens)},
            *(torch.as_tensor(a, dtype=torch.int32) for a in args))
        np.testing.assert_allclose(pd.numpy(), np.asarray(jd), **TOL)
        np.testing.assert_allclose(pcl.numpy(), np.asarray(jcl), **TOL)
        for key in ("k_scale", "v_scale"):
            np.testing.assert_allclose(pcache[key].numpy(),
                                       np.asarray(jc[key]), rtol=1e-6,
                                       atol=0)
        for key in ("k", "v"):
            diff = _ints(pcache[key].numpy(), kv_bits) - _ints(
                np.asarray(jc[key]), kv_bits)
            assert np.abs(diff).max() <= 1
            assert (diff == 0).mean() >= 0.999
        assert pcache["lens"].tolist() == np.asarray(jc["lens"]).tolist()
        lens = np.array(jc["lens"])
        jc = {k: jc[k] for k in ("k", "v", "k_scale", "v_scale")}
