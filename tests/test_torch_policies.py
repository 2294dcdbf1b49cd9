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
