"""Every model family of the JAX package's ``module_inject/policies.py``
in the port, against the JAX package on the same weights.

Each family runs at 2 layers, d_model 64 (96 for BLOOM at 6 heads), vocab
64, in float32 on the CPU, with weights from the JAX ``init`` carried by
``params_from_jax`` (GPT-J's head bias, which no init makes, is drawn
with numpy from a seed and added to both trees):

- GPT-NeoX: rotate-half rotary on a quarter of each head, parallel
  residual, untied head, ``flash`` (B1/B2's plain versions in the port,
  the JAX kernel in interpret mode);
- GPT-J: interleaved rotary on a quarter of each head, parallel
  residual, untied head with a bias;
- OPT: GPT-2's architecture with ``relu`` and its own ``d_ff``;
- BLOOM: ALiBi at 4 heads and at 6 (the non-power-of-two slopes), the
  embedding layernorm;
- GPT-Neo: a global then a local layer with a window of 4 < T, the
  unscaled softmax (``attn_softmax_scale`` 1.0);
- BERT: the post-norm encoder (``causal=False``), token types, the MLM
  head, ``flash`` (the non-causal B1 and B2);
- DistilBERT: BERT's encoder without token types.

Logits and the loss are held at atol = rtol = 1e-5, the gradient of
every leaf at atol 1e-5 (rtol 1e-4, as the training suite), and for the
decoders ``generate()``'s greedy tokens exactly to the JAX engine's and
the dense-cache decode to the full forward.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dt
from deepspeed_tpu.models import transformer as jax_tf
from deepspeed_tpu_torch.models import layers as L
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.convert import (check_params,
                                                params_from_jax,
                                                params_to_jax)

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
BASE = dict(num_layers=2, d_model=64, num_heads=4, vocab_size=64,
            max_seq_len=64)
ENCODER = dict(causal=False, norm_position="post", final_layernorm=False,
               embed_layernorm=True, mlm_head=True, activation="gelu_exact",
               d_ff=96)
FAMILIES = {
    "neox": dict(pos_embedding="rotary", rotary_pct=0.25,
                 rotary_interleaved=False, parallel_residual=True,
                 tie_embeddings=False, attn_impl="flash"),
    "gptj": dict(pos_embedding="rotary", rotary_pct=0.25,
                 rotary_interleaved=True, parallel_residual=True,
                 tie_embeddings=False, d_ff=128),
    "opt": dict(activation="relu", d_ff=96),
    "bloom": dict(pos_embedding="alibi", embed_layernorm=True),
    "bloom6": dict(pos_embedding="alibi", embed_layernorm=True, num_heads=6,
                   d_model=96),
    "gptneo": dict(attention_layers=("global", "local"),
                   local_attention_window=4, attn_softmax_scale=1.0),
    "bert": dict(ENCODER, token_type_vocab=2, attn_impl="flash"),
    "distilbert": dict(ENCODER),
}
DECODERS = ("neox", "gptj", "opt", "bloom", "bloom6", "gptneo")
INFER = {"dtype": "float32", "max_out_tokens": 64, "temperature": 0.0}


def models(family, **kw):
    """(JAX model, port model) of ``family`` in float32."""
    cfg = {**BASE, **FAMILIES[family], **kw}
    return (jax_tf.TransformerLM(jax_tf.TransformerConfig(
                dtype=jnp.float32, **cfg)),
            tt.TransformerLM(tt.TransformerConfig(dtype=torch.float32,
                                                  **cfg)))


_WEIGHTS = {}


def weights(family):
    """JAX init of ``family`` (numpy) and the same tree as port tensors;
    GPT-J's head gets a seeded bias in both."""
    if family not in _WEIGHTS:
        jm, pm = models(family)
        jp = jax.device_get(jm.init(jax.random.PRNGKey(5)))
        if family == "gptj":
            jp["lm_head"]["bias"] = np.random.default_rng(6).normal(
                0, 0.5, (BASE["vocab_size"],)).astype(np.float32)
        _WEIGHTS[family] = jp, params_from_jax(jp, pm)
    return _WEIGHTS[family]


def ids(b, t, seed, vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(
        np.int32)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_logits_match_jax(family):
    """Full-sequence logits (an encoder's with token types when it has
    them), and the tree's paths and shapes equal JAX's."""
    jp, tp = weights(family)
    jm, pm = models(family)
    x = ids(2, 13, 1)
    kw_j, kw_p = {}, {}
    if pm.config.token_type_vocab:
        tt_ids = ids(2, 13, 2, vocab=2)
        kw_j = {"token_type_ids": jnp.asarray(tt_ids)}
        kw_p = {"token_type_ids": torch.from_numpy(tt_ids).long()}
    want = np.asarray(jm.apply(jp, jnp.asarray(x), **kw_j))
    got = pm.apply(tp, torch.from_numpy(x).long(), **kw_p).numpy()
    assert got.shape == (2, 13, 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           params_to_jax(tp), jp)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_loss_and_grads_match_jax(family):
    """``loss`` (the JAX loss: labels shifted, a loss mask; the fused
    head, or the MLM head's autodiff path) and the gradient of every
    leaf."""
    jp, tp = weights(family)
    jm, pm = models(family)
    rs = np.random.RandomState(3)
    x = rs.randint(0, 64, (2, 16)).astype(np.int32)
    mask = (rs.rand(2, 16) > 0.2).astype(np.float32)
    jl, jg = jax.value_and_grad(jm.loss)(
        jp, {"input_ids": jnp.asarray(x), "loss_mask": jnp.asarray(mask)})
    leaves = jax.tree_util.tree_map(
        lambda t: t.clone().requires_grad_(True), tp)
    pl = pm.loss(leaves, {"input_ids": torch.from_numpy(x).long(),
                          "loss_mask": torch.from_numpy(mask)})
    pl.backward()
    np.testing.assert_allclose(float(pl.detach()), float(jl), **TOL)
    jax.tree_util.tree_map(
        lambda t, g: np.testing.assert_allclose(
            t.grad.numpy(), np.asarray(g), **GRAD_TOL),
        leaves, jax.device_get(jg))


@pytest.mark.parametrize("family", DECODERS)
def test_family_cache_decode_matches_forward_and_jax(family):
    """Dense-cache prefill then three t == 1 decode steps: each step's
    logits equal the full forward's at that position and the JAX
    model's cached step (ALiBi at the query positions, the local window
    over the cache, B5's plain version for NeoX)."""
    jp, tp = weights(family)
    jm, pm = models(family)
    x = ids(2, 9, 4)
    steps = ids(2, 3, 5)
    full = pm.apply(tp, torch.from_numpy(np.concatenate([x, steps], 1))
                    .long()).numpy()
    jc = jm.init_cache(2, 16, dtype=jnp.float32)
    pc = pm.init_cache(2, 16, dtype=torch.float32, device="cpu")
    jl, jc = jm.apply(jp, jnp.asarray(x), cache=jc)
    pl_, pc = pm.apply(tp, torch.from_numpy(x).long(), cache=pc)
    np.testing.assert_allclose(pl_.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(pl_.numpy(), full[:, :9], **TOL)
    for s in range(3):
        tok = steps[:, s:s + 1]
        jl, jc = jm.apply(jp, jnp.asarray(tok), cache=jc)
        pl_, pc = pm.apply(tp, torch.from_numpy(tok).long(), cache=pc)
        np.testing.assert_allclose(pl_.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_allclose(pl_.numpy()[:, 0], full[:, 9 + s], **TOL)


@pytest.mark.parametrize("family", DECODERS)
def test_family_generate_matches_jax(family):
    """``init_inference`` → greedy ``generate()`` equal to the JAX
    engine's token for token, ``forward()`` within 1e-5 (kernel
    injection as each engine decides: NeoX, GPT-J, OPT, BLOOM on flash,
    GPT-Neo pinned to plain attention)."""
    jp, tp = weights(family)
    jm, pm = models(family)
    peng = dt.init_inference(pm, INFER, params=tp, device="cpu")
    want_impl = "xla" if family == "gptneo" else "flash"
    assert peng.module.config.attn_impl == want_impl
    batch = ids(2, 7, 8)
    x = ids(2, 11, 9)
    got = peng.generate(batch, max_new_tokens=8).numpy()
    if family == "gptj":
        # the JAX engine's sharding tree comes from its init, which has no
        # head bias: the JAX model's own greedy decode on the injected
        # (flash) model instead
        jf = jax_tf.TransformerLM(dataclasses.replace(jm.config,
                                                      attn_impl="flash"))
        np.testing.assert_array_equal(got, jax_greedy(jf, jp, batch, 8))
        np.testing.assert_allclose(peng.forward(x).numpy(),
                                   np.asarray(jf.apply(jp, jnp.asarray(x))),
                                   **TOL)
        return
    jeng = ds.init_inference(jm, config=INFER, params=jp)
    assert jeng.module.config.attn_impl == want_impl
    np.testing.assert_array_equal(
        got, np.asarray(jeng.generate(batch, max_new_tokens=8,
                                      temperature=0.0)))
    np.testing.assert_allclose(peng.forward(x).numpy(),
                               np.asarray(jeng.forward(x)), **TOL)


def jax_greedy(jm, jp, batch, n):
    """Greedy tokens of the JAX model's dense-cache decode: the prompt,
    then ``n - 1`` single-token steps."""
    cache = jm.init_cache(batch.shape[0], batch.shape[1] + n,
                          dtype=jnp.float32)
    logits, cache = jm.apply(jp, jnp.asarray(batch), cache=cache)
    toks = [jnp.argmax(logits[:, -1], -1)]
    for _ in range(n - 1):
        logits, cache = jm.apply(jp, toks[-1][:, None], cache=cache)
        toks.append(jnp.argmax(logits[:, -1], -1))
    return np.asarray(jnp.stack(toks, 1))


def test_neox_server_streams_match_generate_and_jax():
    """The GPT-NeoX server (B6/B7's plain versions over the pool, partial
    rotary at each row's position, chunked prefill): greedy streams equal
    to the port's ``generate()`` and the JAX engine's."""
    jp, tp = weights("neox")
    jm, pm = models("neox")
    jeng = ds.init_inference(jm, config=INFER, params=jp)
    peng = dt.init_inference(pm, {**INFER, "serving": {
        "enabled": True, "kv_block_size": 8, "num_kv_blocks": 48,
        "max_batch_slots": 4, "prefill_chunk_tokens": 16}}, params=tp,
        device="cpu")
    srv = peng.serving_engine()
    prompts = [ids(1, n, 20 + n)[0].tolist() for n in (5, 19, 11)]
    reqs = [srv.submit(p, max_new_tokens=6) for p in prompts]
    assert len(srv.run(max_steps=200)) == 3
    for p, r in zip(prompts, reqs):
        want = np.asarray(jeng.generate(np.asarray(p, np.int32)[None],
                                        max_new_tokens=6,
                                        temperature=0.0))[0]
        np.testing.assert_array_equal(r.output, want)
        np.testing.assert_array_equal(
            peng.generate([p], max_new_tokens=6)[0].numpy(), want)


def test_scaled_softmax_server_matches_generate_and_jax():
    """A decoder with ``attn_softmax_scale`` (and no windows) stays on
    plain attention in ``generate()`` and hands the scale to B6/B7 (their
    plain versions) in the server: streams equal to ``generate()`` and to
    the JAX engine's."""
    cfg = dict(BASE, attn_softmax_scale=0.5)
    jm = jax_tf.TransformerLM(jax_tf.TransformerConfig(dtype=jnp.float32,
                                                       **cfg))
    pm = tt.TransformerLM(tt.TransformerConfig(dtype=torch.float32, **cfg))
    jp = jax.device_get(jm.init(jax.random.PRNGKey(8)))
    jeng = ds.init_inference(jm, config=INFER, params=jp)
    peng = dt.init_inference(pm, {**INFER, "serving": {
        "enabled": True, "kv_block_size": 8, "num_kv_blocks": 32,
        "max_batch_slots": 2, "prefill_chunk_tokens": 8}},
        params=params_from_jax(jp, pm), device="cpu")
    assert peng.module.config.attn_impl == "xla"
    srv = peng.serving_engine()
    prompts = [ids(1, n, 30 + n)[0].tolist() for n in (6, 13)]
    reqs = [srv.submit(p, max_new_tokens=5) for p in prompts]
    assert len(srv.run(max_steps=100)) == 2
    for p, r in zip(prompts, reqs):
        want = np.asarray(jeng.generate(np.asarray(p, np.int32)[None],
                                        max_new_tokens=5,
                                        temperature=0.0))[0]
        np.testing.assert_array_equal(r.output, want)
        np.testing.assert_array_equal(
            peng.generate([p], max_new_tokens=5)[0].numpy(), want)


def test_neox_int8_weights_forward_matches_jax():
    """``quant.enabled`` on GPT-NeoX (the untied head kept in float32):
    ``forward()`` within 1e-5 of the JAX int8 engine's."""
    jp, tp = weights("neox")
    jm, pm = models("neox")
    cfg = {**INFER, "quant": {"enabled": True, "bits": 8}}
    jeng = ds.init_inference(jm, config=cfg, params=jp)
    qeng = dt.init_inference(pm, cfg, params=tp, device="cpu")
    assert qeng.params["blocks"]["attn"]["qkv"]["kernel"].dtype == torch.int8
    assert qeng.params["lm_head"]["kernel"].dtype == torch.float32
    x = ids(2, 12, 10)
    np.testing.assert_allclose(qeng.forward(x).numpy(),
                               np.asarray(jeng.forward(x)), **TOL)


@pytest.mark.parametrize("family", ["bert", "distilbert"])
def test_encoder_forward_through_the_engine_matches_jax(family):
    """An encoder's ``forward()`` (the non-causal B1's plain version with
    kernel injection) equals the JAX model's logits, token types
    included; ``generate()`` refuses it with the JAX model's message."""
    jp, tp = weights(family)
    jm, pm = models(family)
    peng = dt.init_inference(pm, INFER, params=tp, device="cpu")
    assert peng.module.config.attn_impl == "flash"
    x = ids(2, 10, 11)
    kw_j, kw_p = {}, {}
    if family == "bert":
        tt_ids = ids(2, 10, 12, vocab=2)
        kw_j = {"token_type_ids": jnp.asarray(tt_ids)}
        kw_p = {"token_type_ids": tt_ids}
    np.testing.assert_allclose(peng.forward(x, **kw_p).numpy(),
                               np.asarray(jm.apply(jp, jnp.asarray(x),
                                                   **kw_j)), **TOL)
    with pytest.raises(NotImplementedError, match="non-causal"):
        peng.generate(x, max_new_tokens=2)
    with pytest.raises(NotImplementedError, match="non-causal"):
        pm.apply(tp, torch.from_numpy(x).long(),
                 cache=pm.init_cache(2, 16, device="cpu"))


@pytest.mark.parametrize("family", ["bert", "neox"])
def test_family_trains_through_the_engine_as_jax(family):
    """Three ``train_step``s of the port's engine (AdamW, clipping, f32)
    against the JAX engine's from the same weights: losses within 1e-5
    (an encoder's MLM head on the autodiff path, NeoX's fused head)."""
    from deepspeed_tpu.parallel.topology import build_mesh
    from deepspeed_tpu.runtime.config import MeshConfig
    jm, pm = models(family)
    config = {"train_micro_batch_size_per_gpu": 2,
              "gradient_accumulation_steps": 1,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
              "gradient_clipping": 1.0, "steps_per_print": 0}
    mesh = build_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    jeng, _, _, _ = ds.initialize(model=jm, config=dict(config), mesh=mesh)
    peng, _, _, _ = dt.initialize(
        model=pm, config=dict(config), device="cpu",
        params=params_from_jax(jax.device_get(jeng.state["params"]), pm))
    batch = {"input_ids": ids(2, 16, 13)}
    for _ in range(3):
        want = float(jeng.train_step(batch)["loss"])
        got = float(peng.train_step(batch)["loss"])
        np.testing.assert_allclose(got, want, **TOL)


# -- the pieces ---------------------------------------------------------------
@pytest.mark.parametrize("heads", [1, 4, 6, 8, 12, 20])
def test_alibi_slopes_and_bias_match_jax(heads):
    """ALiBi slopes (the non-power-of-two extension at 6, 12 and 20
    heads) and the bias at query positions past the keys' start."""
    from deepspeed_tpu.models import layers as jax_layers
    np.testing.assert_allclose(L.alibi_slopes(heads).numpy(),
                               np.asarray(jax_layers.alibi_slopes(heads)),
                               rtol=1e-7)
    qpos = np.arange(5, 12)
    np.testing.assert_allclose(
        L.alibi_bias(heads, 12, torch.from_numpy(qpos)).numpy(),
        np.asarray(jax_layers.alibi_bias(heads, 12, jnp.asarray(qpos))),
        rtol=1e-7)


@pytest.mark.parametrize("causal", [True, False])
def test_gqa_attention_bias_scale_and_mask_match_jax(causal):
    """``gqa_attention`` with an ALiBi bias regrouped over (kv heads,
    group), a softmax scale and a window mask, causal or not."""
    from deepspeed_tpu.models import layers as jax_layers
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 6, 8, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
            for _ in range(2))
    qpos = np.arange(3, 9)
    band = (qpos[:, None] - np.arange(9)[None, :]) < 4
    bias = np.array(jax_layers.alibi_bias(8, 9, jnp.asarray(qpos)))[None]
    want = jax_layers.gqa_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        mask=jnp.asarray(band)[None, None, None], scale=0.7,
        kv_positions_offset=3, causal=causal, bias=jnp.asarray(bias))
    got = L.gqa_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        mask=torch.from_numpy(band)[None, None, None], scale=0.7,
        kv_positions_offset=3, causal=causal, bias=torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_neox_sizes_match_jax():
    """``neox_config`` and ``NEOX_SIZES`` as the JAX package's: 1.3B is 24
    layers of 16 heads of 128, 20B 44 layers of 64 heads of 96 with
    rotary on 24 dims."""
    for size in ("1.3b", "20b"):
        ours, theirs = tt.neox_config(size), jax_tf.neox_config(size)
        for f in dataclasses.fields(tt.TransformerConfig):
            if f.name not in ("dtype", "param_dtype"):
                assert getattr(ours, f.name) == getattr(theirs, f.name), f
        assert ours.num_params() == theirs.num_params()
    big = tt.neox_config("20b")
    assert (big.num_layers, big.d_model, big.num_heads, big.hdim,
            big.rotary_dim) == (44, 6144, 64, 96, 24)
    assert dt.neox_config is tt.neox_config


def test_gptj_head_bias_is_the_one_optional_leaf():
    """``lm_head.bias`` passes ``check_params`` when present (GPT-J) and
    when absent; any other extra leaf is refused."""
    jp, tp = weights("gptj")
    _, pm = models("gptj")
    check_params(pm, tp)
    no_bias = {**tp, "lm_head": {"kernel": tp["lm_head"]["kernel"]}}
    check_params(pm, no_bias)
    with pytest.raises(ValueError, match="unexpected"):
        check_params(pm, {**tp, "lm_head": {**tp["lm_head"],
                                            "extra": tp["lm_head"]["bias"]}})
    with pytest.raises(ValueError, match="shape"):
        check_params(pm, {**tp, "lm_head": {
            **tp["lm_head"], "bias": torch.zeros(3)}})


def test_new_leaves_init_on_the_port():
    """The port's own init makes BERT's ``ln_embed``, ``type_embed`` and
    ``mlm_head`` and no ``ln_f``, in the JAX tree's shapes."""
    jm, pm = models("bert")
    fresh = pm.init(torch.Generator().manual_seed(0), "cpu")
    check_params(pm, fresh)
    assert "ln_f" not in fresh
    assert set(fresh["mlm_head"]) == {"dense", "ln", "bias"}
    jshapes = jax.tree_util.tree_map(
        lambda a: tuple(a.shape),
        jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0))))
    pshapes = jax.tree_util.tree_map(
        lambda t: tuple(t.shape), fresh)
    assert jshapes == pshapes


# -- refusals -------------------------------------------------------------------
@pytest.mark.parametrize("family,reason", [
    ("bloom", "ALiBi"),
    ("bloom6", "ALiBi"),
    ("gptneo", "per-layer local windows"),
    ("bert", "causal"),
    ("distilbert", "causal"),
])
def test_paged_server_refuses_as_jax(family, reason):
    """The server refuses BLOOM, GPT-Neo and the encoders with the JAX
    model's reasons (``_paged_supported``)."""
    jp, tp = weights(family)
    jm, pm = models(family)
    assert reason in jm._paged_supported()
    assert pm._paged_supported() == jm._paged_supported()
    eng = dt.init_inference(pm, {**INFER, "serving": {"enabled": True}},
                            params=tp, device="cpu")
    with pytest.raises(NotImplementedError, match=reason):
        eng.serving_engine()


@pytest.mark.parametrize("override,match", [
    (dict(attention_layers=("global", "local"), attn_impl="flash"),
     "attention_layers needs attn_impl='xla'"),
    (dict(attention_layers=("global", "local"), attn_impl="blocksparse"),
     "attention_layers needs attn_impl='xla'"),
    (dict(attn_softmax_scale=1.0, attn_impl="flash"), "attn_softmax_scale"),
    (dict(attn_softmax_scale=1.0, attn_impl="blocksparse"),
     "attn_softmax_scale"),
])
def test_windows_and_scale_off_plain_attention_refused_as_jax(override,
                                                              match):
    """Per-layer windows or another softmax scale with a kernel route
    (ROADMAP C3): the JAX model's constructor refuses both, and so does
    the port's."""
    cfg = {**BASE, **override}
    with pytest.raises(NotImplementedError, match=match):
        jax_tf.TransformerLM(jax_tf.TransformerConfig(**cfg))
    with pytest.raises(NotImplementedError, match=match):
        tt.TransformerLM(tt.TransformerConfig(**cfg))


def test_alibi_with_blocksparse_refused():
    """The block-sparse kernels take no bias, and the JAX model drops
    ALiBi on that path: the port refuses the pair."""
    with pytest.raises(NotImplementedError, match="ALiBi"):
        tt.TransformerLM(tt.TransformerConfig(
            **BASE, pos_embedding="alibi", attn_impl="blocksparse"))


@pytest.mark.parametrize("override,error", [
    (dict(attention_layers=("global",)), ValueError),
    (dict(attention_layers=("global", "sliding")), ValueError),
    (dict(moe_num_experts=4), NotImplementedError),
])
def test_bad_or_later_configs_raise(override, error):
    """A per-layer pattern of the wrong length or with an unknown entry
    raises as in JAX; MoE is now the only family outside the port, and
    its message names the next slice."""
    with pytest.raises(error) as err:
        tt.TransformerLM(tt.TransformerConfig(**BASE, **override))
    if error is NotImplementedError:
        assert "next slice" in str(err.value)
    assert len(tt._OUT_OF_SLICE) == 2
    assert "MoE" in tt._OUT_OF_SLICE[0][1]


def test_engine_pins_gptneo_to_plain_attention():
    """Kernel injection keeps a model with per-layer windows or another
    softmax scale on ``xla`` (the JAX engine's exclusion), and rewrites
    every other decoder to ``flash``."""
    for override, want in ((dict(attention_layers=("global", "local")),
                            "xla"),
                           (dict(attn_softmax_scale=0.5), "xla"),
                           (dict(pos_embedding="alibi"), "flash")):
        pm = tt.TransformerLM(tt.TransformerConfig(
            **BASE, dtype=torch.float32, **override))
        eng = dt.init_inference(pm, INFER, device="cpu")
        assert eng.module.config.attn_impl == want, override
