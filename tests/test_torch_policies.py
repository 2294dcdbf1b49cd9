"""The port's Hugging Face LLaMA policies (``module_inject/policies.py``)
against the JAX package's.

``hf_llama_config`` reads TinyLlama-1.1B's published ``config.json``
(held in ``policies.TINYLLAMA_1_1B``) on both sides, as a dict on the
port's and a ``SimpleNamespace`` on the JAX package's; ``load_hf_llama``
maps one seeded state dict (numpy from a seed, as torch tensors) on both
sides, and the trees must be equal.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dt
from deepspeed_tpu.models import transformer as jax_tf
from deepspeed_tpu.module_inject import policies as jax_policies
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.convert import check_params, params_to_jax
from deepspeed_tpu_torch.module_inject import policies

#: the fields both TransformerConfigs carry
_SHARED = [f.name for f in dataclasses.fields(tt.TransformerConfig)
           if f.name not in ("dtype", "param_dtype")]


def test_tinyllama_config_matches_jax():
    """The published TinyLlama dict gives the same fields on both sides:
    22 layers, d_model 2048, d_ff 5632, 32 query heads over 4 kv heads of
    64, vocab 32000, 2048 positions, rotate-half rotary at base 10000,
    RMSNorm eps 1e-5, SiLU gated MLP, untied head, no biases."""
    ours = dt.hf_llama_config(policies.TINYLLAMA_1_1B)
    theirs = jax_policies.hf_llama_config(
        types.SimpleNamespace(**policies.TINYLLAMA_1_1B))
    for name in _SHARED:
        assert getattr(ours, name) == getattr(theirs, name), name
    assert (ours.num_layers, ours.d_model, ours.ff_dim, ours.num_heads,
            ours.kv_heads, ours.hdim, ours.vocab_size, ours.max_seq_len) == (
        22, 2048, 5632, 32, 4, 64, 32000, 2048)
    assert ours.num_params() == theirs.num_params() == 1_100_048_384
    # an attribute object reads the same as the dict
    assert dt.hf_llama_config(types.SimpleNamespace(
        **policies.TINYLLAMA_1_1B)) == ours


@pytest.mark.parametrize("extra,match", [
    ({"rope_scaling": {"rope_type": "linear", "factor": 2.0}},
     "rope_scaling"),
    ({"attention_bias": True}, "attention_bias"),
    ({"mlp_bias": True}, "mlp_bias"),
])
def test_unsupported_llama_configs_rejected_as_in_jax(extra, match):
    cfg = {**policies.TINYLLAMA_1_1B, **extra}
    with pytest.raises(NotImplementedError, match=match):
        jax_policies.hf_llama_config(types.SimpleNamespace(**cfg))
    with pytest.raises(NotImplementedError, match=match):
        dt.hf_llama_config(cfg)


def _state_dict(cfg, seed):
    """A seeded HF-layout LLaMA state dict (torch ``Linear`` weights
    ``[out, in]``) at an initialiser's scale: N(0, 0.02) matrices, norm
    scales N(1, 0.1)."""
    rng = np.random.default_rng(seed)
    d, f, v = cfg.d_model, cfg.ff_dim, cfg.vocab_size
    qd, kvd = cfg.num_heads * cfg.hdim, cfg.kv_heads * cfg.hdim

    def w(*shape, mean=0.0, std=0.02):
        return torch.from_numpy((mean + std * rng.standard_normal(
            shape)).astype(np.float32))

    def norm(n):
        return w(n, mean=1.0, std=0.1)
    sd = {"model.embed_tokens.weight": w(v, d), "model.norm.weight": norm(d),
          "lm_head.weight": w(v, d)}
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        sd.update({
            pre + "self_attn.q_proj.weight": w(qd, d),
            pre + "self_attn.k_proj.weight": w(kvd, d),
            pre + "self_attn.v_proj.weight": w(kvd, d),
            pre + "self_attn.o_proj.weight": w(d, qd),
            pre + "mlp.gate_proj.weight": w(f, d),
            pre + "mlp.up_proj.weight": w(f, d),
            pre + "mlp.down_proj.weight": w(d, f),
            pre + "input_layernorm.weight": norm(d),
            pre + "post_attention_layernorm.weight": norm(d),
        })
    return sd


def test_load_hf_llama_trees_match_jax():
    """One seeded state dict through both ``load_hf_llama``s: equal
    trees, in the port model's shapes, and the converted model's logits
    equal the JAX model's on them."""
    hf = {**policies.TINYLLAMA_1_1B, "num_hidden_layers": 2,
          "hidden_size": 64, "intermediate_size": 96,
          "num_attention_heads": 8, "num_key_value_heads": 2,
          "vocab_size": 64, "max_position_embeddings": 32}
    cfg = dt.hf_llama_config(hf, dtype=torch.float32)
    jcfg = jax_policies.hf_llama_config(types.SimpleNamespace(**hf),
                                        dtype=jnp.float32)
    sd = _state_dict(cfg, seed=5)
    ours = policies.load_hf_llama(sd, cfg)
    theirs = jax_policies.load_hf_llama(sd, jcfg)
    pm = tt.TransformerLM(cfg)
    check_params(pm, ours)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           params_to_jax(ours), theirs)
    x = np.random.default_rng(1).integers(0, 64, (2, 12))
    np.testing.assert_allclose(
        pm.apply(ours, torch.from_numpy(x)).numpy(),
        np.asarray(jax_tf.TransformerLM(jcfg).apply(theirs,
                                                    jnp.asarray(x))),
        atol=1e-5, rtol=1e-5)


# -- every family of POLICIES ---------------------------------------------------
def _tiny_hf(model_type):
    """A tiny Hugging Face model of ``model_type`` from its
    ``transformers`` config, random weights from torch seed 0 (no
    download): 2 layers, hidden 64, 4 heads, vocab 64."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    t = transformers
    make = {
        "gpt2": lambda: t.GPT2LMHeadModel(t.GPT2Config(
            n_layer=2, n_embd=64, n_head=4, vocab_size=64, n_positions=32)),
        "gpt_neox": lambda: t.GPTNeoXForCausalLM(t.GPTNeoXConfig(
            num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
            intermediate_size=96, vocab_size=64, max_position_embeddings=32,
            rotary_pct=0.25, hidden_act="gelu_fast")),
        "opt": lambda: t.OPTForCausalLM(t.OPTConfig(
            num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
            ffn_dim=96, vocab_size=64, max_position_embeddings=32,
            word_embed_proj_dim=64)),
        "bloom": lambda: t.BloomForCausalLM(t.BloomConfig(
            n_layer=2, hidden_size=64, n_head=4, vocab_size=64)),
        "bert": lambda: t.BertForMaskedLM(t.BertConfig(
            num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
            intermediate_size=96, vocab_size=64, max_position_embeddings=32,
            type_vocab_size=2)),
        "llama": lambda: t.LlamaForCausalLM(t.LlamaConfig(
            num_hidden_layers=2, hidden_size=64, num_attention_heads=8,
            num_key_value_heads=2, intermediate_size=96, vocab_size=64,
            max_position_embeddings=32)),
        "gptj": lambda: t.GPTJForCausalLM(t.GPTJConfig(
            n_layer=2, n_embd=64, n_head=4, rotary_dim=8, vocab_size=64,
            n_positions=32)),
        "distilbert": lambda: t.DistilBertForMaskedLM(t.DistilBertConfig(
            n_layers=2, dim=64, n_heads=4, hidden_dim=96, vocab_size=64,
            max_position_embeddings=32)),
        "gpt_neo": lambda: t.GPTNeoForCausalLM(t.GPTNeoConfig(
            num_layers=2, hidden_size=64, num_heads=4, vocab_size=64,
            max_position_embeddings=32,
            attention_types=[[["global", "local"], 1]], window_size=4)),
    }[model_type]
    model = make().eval()
    with torch.no_grad():
        # spread the norms and biases the init leaves at 1 and 0, so a
        # swapped leaf shows in the trees
        for name, p in model.named_parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn_like(p))
    return model


@pytest.mark.parametrize("model_type", sorted(jax_policies.POLICIES))
def test_convert_hf_model_matches_jax(model_type):
    """``convert_hf_model`` on a tiny Hugging Face model of every
    ``model_type`` of the registry: the same ``TransformerConfig`` fields
    and the same params tree as the JAX package's (leaf for leaf, in the
    port model's shapes), and the converted model's logits equal the
    JAX model's on it."""
    assert sorted(policies.POLICIES) == sorted(jax_policies.POLICIES)
    hf = _tiny_hf(model_type)
    cfg, ours = dt.convert_hf_model(hf, dtype=torch.float32)
    jcfg, theirs = jax_policies.convert_hf_model(hf, dtype=jnp.float32)
    for name in _SHARED:
        assert getattr(cfg, name) == getattr(jcfg, name), name
    pm = tt.TransformerLM(cfg)
    check_params(pm, ours)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           params_to_jax(ours), theirs)
    x = np.random.default_rng(2).integers(0, 64, (2, 12))
    np.testing.assert_allclose(
        pm.apply(ours, torch.from_numpy(x)).numpy(),
        np.asarray(jax_tf.TransformerLM(jcfg).apply(theirs,
                                                    jnp.asarray(x))),
        atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("model_type", sorted(jax_policies.POLICIES))
def test_hf_config_dict_reads_as_the_object(model_type):
    """A ``config.json`` dict gives the config the ``transformers``
    object gives (GPT-Neo's dict carries ``attention_types``, which the
    port expands as ``GPTNeoConfig`` does)."""
    hf = _tiny_hf(model_type)
    cfg_fn = policies.POLICIES[model_type][0]
    as_dict = hf.config.to_dict()
    as_dict.pop("attention_layers", None)
    assert cfg_fn(as_dict) == cfg_fn(hf.config)


def test_gpt_neox_20b_config_matches_jax():
    """The published GPT-NeoX-20B dict gives the same fields on both
    sides: 44 layers, d_model 6144, d_ff 24576, 64 heads of 96, rotary on
    24 dims at base 10000, vocab 50432, 2048 positions, tanh GeLU,
    parallel residual, untied head; about 20.6 B parameters."""
    ours = dt.hf_neox_config(policies.GPT_NEOX_20B)
    theirs = jax_policies.hf_neox_config(
        types.SimpleNamespace(**policies.GPT_NEOX_20B))
    for name in _SHARED:
        assert getattr(ours, name) == getattr(theirs, name), name
    assert (ours.num_layers, ours.d_model, ours.ff_dim, ours.num_heads,
            ours.hdim, ours.rotary_dim, ours.vocab_size,
            ours.max_seq_len) == (44, 6144, 24576, 64, 96, 24, 50432, 2048)
    assert ours.parallel_residual and not ours.tie_embeddings
    assert ours.activation == "gelu" and not ours.rotary_interleaved
    assert ours.num_params() == theirs.num_params()
    assert 20.5e9 < ours.num_params() < 20.7e9


@pytest.mark.parametrize("extra,fn,error", [
    ({"do_layer_norm_before": False}, "hf_opt_config", ValueError),
    ({"sinusoidal_pos_embds": True}, "hf_distilbert_config",
     NotImplementedError),
])
def test_unsupported_family_configs_rejected_as_in_jax(extra, fn, error):
    """OPT's post-norm 350m variant and DistilBERT's sinusoidal
    positions are refused on both sides."""
    model_type = {"hf_opt_config": "opt",
                  "hf_distilbert_config": "distilbert"}[fn]
    cfg = {**_tiny_hf(model_type).config.to_dict(), **extra}
    with pytest.raises(error):
        getattr(jax_policies, fn)(types.SimpleNamespace(**cfg))
    with pytest.raises(error):
        getattr(policies, fn)(cfg)


def test_convert_hf_model_refuses_an_unknown_type():
    model = types.SimpleNamespace(
        config=types.SimpleNamespace(model_type="t5"),
        state_dict=lambda: {})
    with pytest.raises(ValueError, match="t5"):
        dt.convert_hf_model(model)
