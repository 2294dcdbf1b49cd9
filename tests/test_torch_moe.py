"""The port's Mixture-of-Experts (``deepspeed_tpu_torch/moe``, the MoE
superblock of ``models/transformer.py``, MoE training and serving)
against the JAX package, on the same weights and inputs.

Gate logits and tokens come from numpy seeds; model weights from the JAX
``TransformerLM.init`` cross with ``params_from_jax``.  The models are
GPT-2 with 4 layers, d_model 32, 4 heads, vocab 64 and 4 experts, in
float32.  Routing is exact (the same combine weights' support, dispatch
mask, ``exp_counts``); values agree within 1e-5 (the same f32 math, only
the order of sums differs); greedy tokens are exactly equal.  Random
routing (RTS, RSample, top-2's Gumbel second choice) draws from a
``torch.Generator`` whose numbers differ from JAX's keys, so it is held
to its properties: capacity respected, one generator one routing,
another generator another routing, no generator a deterministic
fallback (RTS) or an error (RSample).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dt
from deepspeed_tpu.models import transformer as jax_tf
from deepspeed_tpu.moe import layer as jax_layer
from deepspeed_tpu.moe import sharded_moe as jax_moe
from deepspeed_tpu.parallel.topology import build_mesh
from deepspeed_tpu.runtime.config import MeshConfig
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.convert import (check_params,
                                                params_from_jax,
                                                params_to_jax)
from deepspeed_tpu_torch.moe import layer as moe_layer
from deepspeed_tpu_torch.moe import sharded_moe as moe
from deepspeed_tpu_torch.runtime.engine import moe_seeds
from deepspeed_tpu_torch.runtime.optimizers import tree_leaves

TOL = dict(atol=1e-5, rtol=1e-5)
TINY = dict(num_layers=4, d_model=32, num_heads=4, vocab_size=64,
            max_seq_len=64, moe_num_experts=4)


def jax_model(**kw):
    return jax_tf.TransformerLM(jax_tf.gpt2_config(
        "125m", dtype=jnp.float32, **{**TINY, **kw}))


def port_model(**kw):
    return tt.TransformerLM(tt.gpt2_config(
        "125m", dtype=torch.float32, **{**TINY, **kw}))


def ids(b, t, seed):
    return np.random.default_rng(seed).integers(0, 64, (b, t)).astype(
        np.int32)


# -- gating ----------------------------------------------------------------
def gate_logits(case, s=24, e=4):
    """``[S, E]`` f32 logits: random ("ample", "tight"), skewed toward
    expert 1 so its queue overflows ("skewed"), or with exact ties
    between experts ("ties")."""
    rs = np.random.RandomState(5)
    x = rs.randn(s, e).astype(np.float32)
    if case == "skewed":
        x[:, 1] += 3.0
    if case == "ties":
        x = np.round(x)
        x[::3, 2] = x[::3, 0]
        x[::4] = 0.0
    return x


GATE_CASES = {"ample": (2.0, 4), "tight": (0.5, 1), "skewed": (1.0, 2),
              "ties": (1.0, 2)}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
@pytest.mark.parametrize("k", [1, 2])
def test_gating_matches_jax(k, case):
    """top-1 and top-2 without noise: combine weights (within 1e-5, the
    same support), dispatch mask, exp_counts (exact) and l_aux equal
    JAX's; the tight and skewed cases drop tokens."""
    cf, min_cap = GATE_CASES[case]
    x = gate_logits(case)
    if k == 1:
        want = jax_moe.top1_gating(jnp.asarray(x), cf, min_cap,
                                   use_rts=False)
        got = moe.top1_gating(torch.from_numpy(x), cf, min_cap,
                              use_rts=False)
    else:
        want = jax_moe.top2_gating(jnp.asarray(x), cf, min_cap)
        got = moe.top2_gating(torch.from_numpy(x), cf, min_cap)
    np.testing.assert_allclose(got.combine_weights.numpy(),
                               np.asarray(want.combine_weights), **TOL)
    np.testing.assert_array_equal(got.dispatch_mask.numpy(),
                                  np.asarray(want.dispatch_mask))
    np.testing.assert_array_equal(got.exp_counts.numpy(),
                                  np.asarray(want.exp_counts))
    assert got.exp_counts.dtype == torch.int32
    np.testing.assert_allclose(float(got.l_aux), float(want.l_aux), **TOL)
    routed = int(np.asarray(want.dispatch_mask).sum())
    if case in ("tight", "skewed"):
        assert routed < k * x.shape[0]


def test_top1_used_token_and_front_door_match_jax():
    """``used_token`` masks tokens out of routing and counts; ``gate``
    dispatches on k; ``capacity`` is the static formula."""
    x = gate_logits("ample")
    used = (np.arange(24) % 3 != 0).astype(np.int32)
    want = jax_moe.top1_gating(jnp.asarray(x), 1.0, 2,
                               used_token=jnp.asarray(used), use_rts=False)
    got = moe.top1_gating(torch.from_numpy(x), 1.0, 2,
                          used_token=torch.from_numpy(used), use_rts=False)
    np.testing.assert_array_equal(got.dispatch_mask.numpy(),
                                  np.asarray(want.dispatch_mask))
    np.testing.assert_array_equal(got.exp_counts.numpy(),
                                  np.asarray(want.exp_counts))
    for k in (1, 2):
        a = jax_moe.gate(jnp.asarray(x), k, 0.75, 3)
        b = moe.gate(torch.from_numpy(x), k, 0.75, 3)
        np.testing.assert_allclose(b.combine_weights.numpy(),
                                   np.asarray(a.combine_weights), **TOL)
    for args in ((24, 4, 1.0, 4), (5, 4, 1.0, 1), (1000, 7, 1.25, 4)):
        assert moe.capacity(*args) == jax_moe.capacity(*args)
    with pytest.raises(ValueError, match="top-1 and top-2"):
        moe.gate(torch.from_numpy(x), 3)


def test_drop_tokens_false_raises_as_jax():
    x = torch.from_numpy(gate_logits("ample"))
    with pytest.raises(ValueError) as err:
        moe.top1_gating(x, drop_tokens=False)
    with pytest.raises(ValueError) as jerr:
        jax_moe.top1_gating(jnp.asarray(x.numpy()), drop_tokens=False)
    assert str(err.value) == str(jerr.value)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("kind", ["rts", "rsample", "top2"])
def test_random_gating_properties(kind):
    """RTS, RSample and top-2's Gumbel second choice: each expert's kept
    tokens fit its capacity in slots 0..n-1; one generator seed gives
    one routing, another seed another; RTS keeps the same number per
    expert as token order (only which tokens changes)."""
    x = torch.from_numpy(gate_logits("skewed", s=64))

    def run(seed):
        g = None if seed is None else _gen(seed)
        if kind == "top2":
            return moe.top2_route(x, 0.5, 1, generator=g)
        return moe.top1_route(
            x, 0.5, 1, use_rts=kind == "rts",
            noisy_gate_policy="RSample" if kind == "rsample" else None,
            generator=g)
    a, b, c = run(1), run(1), run(2)
    for r in (a, c):
        d = r.dense()
        per_slot = d.dispatch_mask.sum(0)
        assert int(per_slot.max()) <= 1
        kept = d.dispatch_mask.sum((0, 2))
        assert bool((kept <= r.capacity).all())
        # survivors are packed into the first slots
        for e in range(4):
            n = int(kept[e])
            assert bool(d.dispatch_mask[:, e, :n].any(0).all())
    for f in ("expert", "slot", "kept"):
        assert torch.equal(getattr(a, f), getattr(b, f))
    assert torch.equal(a.weight, b.weight)
    assert not (torch.equal(a.expert, c.expert)
                and torch.equal(a.kept, c.kept))
    if kind == "rts":
        base = run(None)
        assert torch.equal(a.expert, base.expert)
        assert torch.equal(a.dense().dispatch_mask.sum((0, 2)),
                           base.dense().dispatch_mask.sum((0, 2)))
        assert not torch.equal(a.kept, base.kept)


def test_rsample_without_generator_raises():
    x = torch.from_numpy(gate_logits("ample"))
    with pytest.raises(ValueError, match="needs an rng"):
        moe.top1_gating(x, noisy_gate_policy="RSample")


def test_noise_passed_in_routes_as_drawn():
    """Noise drawn once and passed in routes exactly as the same
    generator does (the model draws it outside remat)."""
    x = torch.from_numpy(gate_logits("skewed", s=40))
    noise = moe.draw_noise(_gen(4), 40, 4, 1, "RSample", True)
    a = moe.top1_route(x, 0.5, 1, noisy_gate_policy="RSample",
                       noise=noise)
    b = moe.top1_route(x, 0.5, 1, noisy_gate_policy="RSample",
                       generator=_gen(4))
    assert torch.equal(a.expert, b.expert) and torch.equal(a.slot, b.slot)


# -- the MoE layer ---------------------------------------------------------
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("residual", [False, True], ids=["moe", "pr-moe"])
@pytest.mark.parametrize("k", [1, 2])
def test_moe_layer_matches_jax(k, residual, train):
    """``MoELayer.apply`` on JAX's params: y within 1e-5, l_aux and
    exp_counts equal, in train mode (capacity factor 0.5: drops) and
    eval mode (eval factor 2.0), with and without PR-MoE."""
    cfg = dict(num_experts=4, k=k, capacity_factor=0.5,
               eval_capacity_factor=2.0, min_capacity=1,
               use_residual=residual, use_rts=False)
    jl = jax_layer.MoELayer(16, jax_layer.MoEConfig(**cfg), d_ff=24,
                            depth_scale=4)
    pl = moe_layer.MoELayer(16, moe_layer.MoEConfig(**cfg), d_ff=24,
                            depth_scale=4)
    jp = jax.device_get(jl.init(jax.random.PRNGKey(2)))
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    x = np.random.RandomState(3).randn(2, 9, 16).astype(np.float32)
    jy, jaux, jcounts = jl.apply(jp, jnp.asarray(x), train=train)
    py, paux, pcounts = pl.apply(tp, torch.from_numpy(x), train=train)
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(paux), float(jaux), **TOL)
    np.testing.assert_array_equal(pcounts.numpy(), np.asarray(jcounts))
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
    got = pl.init(_gen(0), "cpu")
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), got) == shapes
    assert got["gate"]["kernel"].dtype == torch.float32


def test_moe_layer_gradients_match_jax():
    """Gradients of a scalar of (y, l_aux) with respect to the params and
    x, through the combine weights, the dispatch gather and the aux
    loss (top-2 so two weights per token)."""
    cfg = dict(num_experts=4, k=2, capacity_factor=1.0, min_capacity=1,
               use_residual=True, use_rts=False)
    jl = jax_layer.MoELayer(16, jax_layer.MoEConfig(**cfg), d_ff=24)
    pl = moe_layer.MoELayer(16, moe_layer.MoEConfig(**cfg), d_ff=24)
    jp = jax.device_get(jl.init(jax.random.PRNGKey(6)))
    x = np.random.RandomState(8).randn(12, 16).astype(np.float32)
    w = np.random.RandomState(9).randn(12, 16).astype(np.float32)

    def jf(p, x):
        y, aux, _ = jl.apply(p, x)
        return jnp.sum(y * w) + 0.3 * aux
    jg, jgx = jax.grad(jf, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)).requires_grad_(True), jp)
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux, _ = pl.apply(tp, tx)
    (torch.sum(y * torch.from_numpy(w)) + 0.3 * aux).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **TOL)
    jax.tree_util.tree_map(
        lambda t, g: np.testing.assert_allclose(t.grad.numpy(),
                                                np.asarray(g), atol=1e-5,
                                                rtol=1e-4), tp, jg)


# -- the model ----------------------------------------------------------------
MODEL_CASES = [dict(moe_freq=1), dict(moe_freq=2),
               dict(moe_freq=1, parallel_residual=True),
               dict(moe_freq=2, parallel_residual=True),
               dict(moe_freq=2, moe_k=2, moe_use_residual=True)]
MODEL_IDS = ["freq1", "freq2", "freq1-parallel", "freq2-parallel",
             "freq2-top2-prmoe"]


@pytest.mark.parametrize("kw", MODEL_CASES, ids=MODEL_IDS)
def test_model_logits_loss_and_grads_match_jax(kw):
    """``apply`` (eval routing), ``loss`` (train routing: NLL plus the aux
    loss at coefficient 0.01, capacity factor 0.5 so tokens drop) and
    its gradients against the JAX model's on JAX's weights, flash
    attention with remat full."""
    kw = dict(kw, moe_capacity_factor=0.5, moe_min_capacity=1,
              moe_use_rts=False, attn_impl="flash", remat="full",
              loss_chunk=0)
    jm, pm = jax_model(**kw), port_model(**kw)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(1)))
    tp = params_from_jax(jp, pm)
    x = ids(2, 16, 3)
    np.testing.assert_allclose(
        pm.apply(tp, torch.from_numpy(x).long()).numpy(),
        np.asarray(jm.apply(jp, jnp.asarray(x))), **TOL)
    jl, jg = jax.value_and_grad(jm.loss)(jp, {"input_ids": jnp.asarray(x)})
    leaves = jax.tree_util.tree_map(lambda t: t.requires_grad_(True), tp)
    pl = pm.loss(leaves, {"input_ids": torch.from_numpy(x).long()})
    pl.backward()
    np.testing.assert_allclose(float(pl.detach()), float(jl), **TOL)
    _, laux = jm.hidden_states_and_aux(jp, jnp.asarray(x))
    _, paux = pm.hidden_states_and_aux(tp, torch.from_numpy(x).long())
    np.testing.assert_allclose(float(paux.detach()), float(laux), **TOL)
    assert float(laux) > 0
    jax.tree_util.tree_map(
        lambda t, g: np.testing.assert_allclose(
            t.grad.numpy(), np.asarray(g), atol=1e-5, rtol=1e-4),
        leaves, jg)
    assert len(pm.moe_stats) == pm.config.scan_length


@pytest.mark.parametrize("kw", MODEL_CASES[:2], ids=MODEL_IDS[:2])
def test_model_cache_prefill_and_decode_match_jax(kw):
    """Dense-cache prefill then three decode steps (B5's plain version
    with ``flash``): logits within 1e-5 of the JAX model's, whose cache
    is ``[scan, A, B, T, H, D]`` where the port's is in layer order."""
    kw = dict(kw, moe_eval_capacity_factor=0.5, moe_min_capacity=1,
              attn_impl="flash")
    jm, pm = jax_model(**kw), port_model(**kw)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(2)))
    tp = params_from_jax(jp, pm)
    jc = jm.init_cache(2, 16, dtype=jnp.float32)
    pc = pm.init_cache(2, 16, dtype=torch.float32, device="cpu")
    assert tuple(pc["k"].shape) == (4, 2, 16, 4, 8)
    x = ids(2, 9, 5)
    jl, jc = jm.apply(jp, jnp.asarray(x), cache=jc)
    pl, pc = pm.apply(tp, torch.from_numpy(x).long(), cache=pc)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    for step in range(3):
        tok = ids(2, 1, 30 + step)
        jl, jc = jm.apply(jp, jnp.asarray(tok), cache=jc)
        pl, pc = pm.apply(tp, torch.from_numpy(tok).long(), cache=pc)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    jk = np.asarray(jc["k"]).reshape((4,) + tuple(jc["k"].shape[2:]))
    np.testing.assert_allclose(pc["k"].numpy()[:, :, :12], jk[:, :, :12],
                               **TOL)


@pytest.mark.parametrize("kw", [dict(moe_freq=1), dict(moe_freq=2),
                                dict(moe_use_residual=True)],
                         ids=["freq1", "freq2", "pr-moe"])
def test_params_tree_and_counts(kw):
    """The port's init and ``param_shapes`` give the JAX tree's paths and
    shapes; ``num_params`` counts every leaf (experts, gate and PR-MoE
    included), ``num_params(active=True)`` k experts per MoE layer; the
    bridge round-trips and refuses a tree without the MoE leaves."""
    jm, pm = jax_model(**kw), port_model(**kw)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    mine = pm.init(_gen(0), "cpu")
    assert (jax.tree_util.tree_map(lambda t: tuple(t.shape), mine)
            == jax.tree_util.tree_map(lambda a: tuple(a.shape), jp))
    check_params(pm, mine)
    c = pm.config
    total = sum(t.numel() for t in tree_leaves(mine))
    assert c.num_params() == total
    e, fe, d = c.moe_num_experts, c.ff_dim, c.d_model
    expert = 2 * d * fe + fe + d
    assert c.num_params(active=True) == total - c.scan_length * (
        e - c.moe_k) * expert
    back = params_to_jax(params_from_jax(jp, pm))
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, jp)
    bad = {**jp, "blocks": {k: v for k, v in jp["blocks"].items()
                            if k != "moe_blk"}}
    with pytest.raises(ValueError, match="moe_blk"):
        params_from_jax(bad, pm)


def test_attention_layers_with_moe_refused_as_jax():
    kw = dict(attention_layers=("global", "local") * 2)
    with pytest.raises(NotImplementedError, match="MoE superblock"):
        port_model(**kw)
    with pytest.raises(NotImplementedError, match="MoE superblock"):
        jax_model(**kw)
    with pytest.raises(ValueError, match="moe_freq"):
        port_model(moe_freq=3)


# -- training -----------------------------------------------------------------
TRAIN = dict(attn_impl="flash", remat="full", loss_chunk=16,
             moe_capacity_factor=0.5, moe_min_capacity=1)
CONFIG = {"train_micro_batch_size_per_gpu": 2,
          "gradient_accumulation_steps": 2,
          "optimizer": {"type": "AdamW",
                        "params": {"lr": 6e-4, "weight_decay": 0.1}},
          "gradient_clipping": 1.0, "steps_per_print": 0}


def train_batches(n, seed):
    rs = np.random.RandomState(seed)
    return [{"input_ids": rs.randint(0, 64, (4, 32)).astype(np.int32)}
            for _ in range(n)]


def test_three_engine_steps_match_jax():
    """``initialize`` → three ``train_step``s without ``moe_rng`` (token
    order, train capacity): losses (NLL + 0.01 l_aux) and grad norms
    within 1e-5 relative of the JAX engine's on a one-device mesh, and
    the params after them within 1e-5."""
    jm = jax_model(**TRAIN, moe_use_rts=False)
    mesh = build_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    je, _, _, _ = ds.initialize(model=jm, config=json.loads(
        json.dumps(CONFIG)), mesh=mesh)
    init = jax.device_get(je.state)
    pm = port_model(**TRAIN, moe_use_rts=False)
    pe, _, _, _ = dt.initialize(model=pm, config=CONFIG,
                                params=params_from_jax(init["params"], pm),
                                device="cpu")
    for b in train_batches(3, 0):
        a, m = je.train_step(b), pe.train_step(b)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(a[key]),
                                       rtol=1e-5, atol=0)
    want = jax.device_get(je.state["params"])
    got = params_to_jax(pe.state["params"])
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(a, np.asarray(b), **TOL),
        got, want)


def _engine(model, params=None, config=CONFIG):
    eng, _, _, _ = dt.initialize(model=model, config=config, params=params,
                                 device="cpu", seed=0)
    return eng


def test_moe_rng_seeds_routing_per_micro_batch():
    """``batch["moe_rng"]``: a seed gives one routing seed per micro
    batch (they differ), the same seed the same step, another seed
    another; RSample without it raises as the JAX model does."""
    pm = port_model(**TRAIN, moe_use_rts=True)
    seeds = moe_seeds(7, 2)
    assert seeds.shape == (2,) and seeds[0] != seeds[1]
    b = train_batches(1, 3)[0]
    losses = []
    for seed in (5, 5, 6):
        eng = _engine(pm)
        losses.append(float(eng.train_step({**b, "moe_rng": seed})["loss"]))
    assert losses[0] == losses[1] and losses[0] != losses[2]
    rs = port_model(**TRAIN, moe_noisy_gate_policy="RSample")
    eng = _engine(rs)
    with pytest.raises(ValueError, match="needs an rng"):
        eng.train_step(b)
    assert np.isfinite(float(eng.train_step({**b, "moe_rng": 1})["loss"]))


def test_remat_none_and_full_give_equal_grads_under_rts():
    """With RTS and one seed, the recomputed forward of ``remat="full"``
    routes the same tokens as ``remat="none"``: equal routing, loss and
    gradients."""
    out = {}
    for remat in ("none", "full"):
        pm = port_model(**{**TRAIN, "remat": remat}, moe_use_rts=True,
                        moe_noisy_gate_policy="RSample")
        params = pm.init(_gen(0), "cpu")
        leaves = jax.tree_util.tree_map(lambda t: t.requires_grad_(True),
                                        params)
        batch = {"input_ids": torch.from_numpy(ids(2, 32, 9)).long(),
                 "moe_rng": 11}
        loss = pm.loss(leaves, batch)
        loss.backward()
        out[remat] = (float(loss), [t.grad for t in tree_leaves(leaves)],
                      [(c.tolist(), int(k)) for c, k, _ in pm.moe_stats])
    assert out["none"][2] == out["full"][2]
    assert out["none"][0] == out["full"][0]
    for a, b in zip(out["none"][1], out["full"][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6,
                                   rtol=1e-6)


def test_moe_engine_checkpoint_round_trip(tmp_path):
    """An MoE engine saves and loads bit-equal, and the reloaded engine's
    next seeded step equals the original's."""
    pm = port_model(**TRAIN)
    eng = _engine(pm)
    for b in train_batches(2, 4):
        eng.train_step({**b, "moe_rng": 3})
    eng.save_checkpoint(str(tmp_path))
    fresh = _engine(port_model(**TRAIN), config=CONFIG)
    fresh.load_checkpoint(str(tmp_path))
    for a, b in zip(tree_leaves(eng.state), tree_leaves(fresh.state)):
        assert torch.equal(a, b)
    b = train_batches(1, 5)[0]
    assert float(eng.train_step({**b, "moe_rng": 9})["loss"]) == float(
        fresh.train_step({**b, "moe_rng": 9})["loss"])


# -- inference ----------------------------------------------------------------
BASE = {"dtype": "float32", "max_out_tokens": 64, "temperature": 0.0,
        "prompt_bucket": 8}
SERVE = dict(moe_eval_capacity_factor=1.0, moe_min_capacity=1,
             moe_use_rts=False)


@pytest.fixture(scope="module")
def served():
    jm = jax_model(**SERVE)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(7)))
    return jm, jp


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8w"])
def test_generate_and_forward_match_jax(served, quant):
    """``init_inference`` with ``moe.enabled`` (ep_size 1): greedy
    ``generate()`` tokens equal the JAX engine's with the same
    ``prompt_bucket`` (5-token prompts padded to 8: the padding takes
    capacity slots in both), ``forward()`` logits within 1e-5; with
    ``quant.enabled`` the gate ``[M, E]`` and experts ``[E, M, F]`` are
    quantized per layer as JAX's and the streams stay equal."""
    jm, jp = served
    cfg = {**BASE, "moe": {"enabled": True, "ep_size": 1}}
    if quant:
        cfg["quant"] = {"enabled": True, "bits": 8}
    jeng = ds.init_inference(jm, config={
        **cfg, "replace_with_kernel_inject": False}, params=jp)
    pm = port_model(**SERVE)
    peng = dt.init_inference(pm, cfg, params=params_from_jax(jp, pm),
                             device="cpu")
    prompts = ids(2, 5, 12)
    np.testing.assert_array_equal(
        peng.generate(prompts, max_new_tokens=6).numpy(),
        np.asarray(jeng.generate(prompts, max_new_tokens=6,
                                 temperature=0.0)))
    x = ids(2, 11, 13)
    np.testing.assert_allclose(peng.forward(x).numpy(),
                               np.asarray(jeng.forward(x)), **TOL)
    if quant:
        for leaf in (("moe_blk", "moe", "gate", "kernel"),
                     ("moe_blk", "moe", "experts", "fc_in", "kernel")):
            q, s = peng.params["blocks"], peng._scales["blocks"]
            jq, js = jeng.params["blocks"], jeng._scales["blocks"]
            for k in leaf:
                q, s, jq, js = q[k], s[k], jq[k], js[k]
            assert q.dtype == torch.int8
            np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
            np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_engine_refusals():
    """The server refuses an MoE model with the JAX reason; ``ep_size``
    2, which runs since expert parallelism came
    (``tests/test_torch_tp_serving.py``), needs two ranks: in a world of
    one it raises the JAX engine's message."""
    pm = port_model(**SERVE)
    with pytest.raises(ValueError, match="tp_size 1 x ep_size 2 does not "
                                         "divide 1 devices"):
        dt.init_inference(pm, {**BASE, "moe": {"enabled": True,
                                               "ep_size": 2}},
                          device="cpu")
    eng = dt.init_inference(pm, {**BASE, "serving": {"enabled": True}},
                            device="cpu")
    with pytest.raises(Exception, match="MoE block stacks"):
        eng.serving_engine()
    assert pm._paged_supported() == jax_model()._paged_supported()


def test_default_init_casts_the_gate_to_the_engine_dtype():
    """Fresh weights (no params) are cast leaf by leaf to the engine's
    dtype, the float32 gate too, as the JAX engine casts its init."""
    pm = port_model(**SERVE)
    eng = dt.init_inference(pm, {**BASE, "dtype": "bfloat16"},
                            device="cpu")
    gate = eng.params["blocks"]["moe_blk"]["moe"]["gate"]["kernel"]
    assert gate.dtype == torch.bfloat16
    out = eng.generate(ids(1, 4, 2), max_new_tokens=3)
    assert tuple(out.shape) == (1, 3)
    assert dataclasses.is_dataclass(eng.module.config)
