"""The port's GPT-2 model against the JAX package's, on the same weights.

Weights come from the JAX ``TransformerLM.init`` and cross with
``params_from_jax``; the model is the serving suite's ``tiny_cfg``
(4 layers, d_model 32, 4 heads, vocab 64) in float32.  Logits are
compared at atol = rtol = 1e-5 (same math in f32; only the summation
order differs).  The JAX side's Pallas decode kernel runs in interpret
mode on the CPU.
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


@pytest.mark.parametrize("override", [
    dict(pos_embedding="rotary"), dict(pos_embedding="alibi"),
    dict(norm_type="rmsnorm"), dict(gated_mlp=True),
    dict(num_kv_heads=2), dict(parallel_residual=True),
    dict(moe_num_experts=4), dict(activation="silu"),
])
def test_out_of_slice_families_raise(override):
    cfg = dataclasses.replace(tt.gpt2_config("125m", **TINY), **override)
    with pytest.raises(NotImplementedError, match="later|slice"):
        tt.TransformerLM(cfg)


def test_uncached_flash_forward_raises():
    """The uncached forward with kernel injection runs flash attention
    (kernels B1/B2) for a sequence that fits one block; past 1024 tokens
    the JAX package runs the two-pass kernels B3/B4, a later slice."""
    cfg = tt.gpt2_config("125m", dtype=torch.float32, attn_impl="flash",
                         **{**TINY, "max_seq_len": 1100})
    pm = tt.TransformerLM(cfg)
    with pytest.raises(NotImplementedError, match="B3.*B4"):
        pm.apply(pm.init(torch.Generator().manual_seed(0), "cpu"),
                 torch.zeros((1, 1030), dtype=torch.long))


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
