"""The port's training path — ``initialize`` → ``train_step`` — against
the JAX package's engine, on the same weights and batches.

The model is GPT-2 with 2 layers, d_model 64, 4 heads, T 64, vocab 256,
in float32, with ``attn_impl="flash"`` (the port's B1/B2 plain versions
on the CPU; the JAX Pallas kernels in interpret mode), ``remat="full"``,
the fused loss head at chunk 16, AdamW (weight decay 0.1), gradient
clipping 1.0 and gas 2.  The JAX engine runs on a one-device mesh.
Losses and grad norms agree to 1e-5 relative and the final state to
1e-5 (the same float32 arithmetic; only the order of the sums differs,
and 5 AdamW steps move a parameter by at most 5 * lr).  The LLaMA
family (4 layers, d_model 64, 8 query heads over 2 kv heads, d_ff 96,
vocab 64, RMSNorm, SiLU gated MLP, untied head, no biases, rotate-half
rotary) is held to
the same limits; its grouped-query attention sends the backward to the
two-pass kernels B3/B4 (their plain versions on the CPU).
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dt
from deepspeed_tpu.models import transformer as jax_tf
from deepspeed_tpu.parallel.topology import build_mesh
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deepspeed_tpu.runtime.config import MeshConfig
from deepspeed_tpu.runtime.dataloader import \
    DeepSpeedDataLoader as JaxLoader
from deepspeed_tpu.runtime.dataloader import \
    synthetic_lm_batches as jax_synthetic
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.ops.transformer import flash_attention as FA
from deepspeed_tpu_torch.models.convert import (params_from_jax,
                                                params_to_jax,
                                                state_from_jax,
                                                state_to_jax)
from deepspeed_tpu_torch.runtime.optimizers import tree_leaves
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.dataloader import (DeepSpeedDataLoader,
                                                    RepeatingLoader,
                                                    synthetic_lm_batches)

SMALL = dict(num_layers=2, d_model=64, num_heads=4, vocab_size=256,
             max_seq_len=64, attn_impl="flash", remat="full", loss_chunk=16)
CONFIG = {"train_micro_batch_size_per_gpu": 2,
          "gradient_accumulation_steps": 2,
          "optimizer": {"type": "AdamW",
                        "params": {"lr": 6e-4, "weight_decay": 0.1}},
          "gradient_clipping": 1.0, "steps_per_print": 0}
REL = 1e-5
STATE_TOL = dict(atol=1e-5, rtol=1e-5)
LLAMA_SMALL = dict(num_layers=4, d_model=64, num_heads=8, num_kv_heads=2,
                   d_ff=96, vocab_size=64, max_seq_len=64,
                   pos_embedding="rotary", rotary_interleaved=False,
                   norm_type="rmsnorm", activation="silu", gated_mlp=True,
                   tie_embeddings=False, use_bias=False, attn_impl="flash",
                   remat="full", loss_chunk=16)


def port_model(**kw):
    return tt.TransformerLM(tt.gpt2_config("125m", dtype=torch.float32,
                                           **{**SMALL, **kw}))


def jax_engine(config=CONFIG):
    jm = jax_tf.TransformerLM(jax_tf.gpt2_config("125m", dtype=jnp.float32,
                                                 **SMALL))
    mesh = build_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    eng, _, _, _ = ds.initialize(model=jm, config=json.loads(
        json.dumps(config)), mesh=mesh)
    return eng


def port_engine(params, config=CONFIG):
    eng, _, _, _ = dt.initialize(model=port_model(),
                                 config=json.loads(json.dumps(config)),
                                 params=params, device="cpu")
    return eng


def batches(n, seed):
    rs = np.random.RandomState(seed)
    return [{"input_ids": rs.randint(0, 256, (4, 64)).astype(np.int32)}
            for _ in range(n)]


def assert_state_close(jax_state, port_state):
    want = jax.device_get(jax_state)
    got = state_to_jax(port_state)
    for k in ("step", "skipped"):
        assert int(got[k]) == int(want[k]), k
    assert int(got["opt"]["step"]) == int(want["opt"]["step"])
    for a, b in ((got["params"], want["params"]),
                 (got["opt"]["m"], want["opt"]["m"]),
                 (got["opt"]["v"], want["opt"]["v"])):
        jax.tree_util.tree_map(
            lambda x, y: np.testing.assert_allclose(x, np.asarray(y),
                                                    **STATE_TOL), a, b)


@pytest.fixture(scope="module")
def run():
    """A JAX engine and the port's engine from the JAX engine's initial
    params, after 5 train_steps on the same seeded batches, with every
    step's metrics."""
    je = jax_engine()
    init = jax.device_get(je.state)
    pe = port_engine(params_from_jax(init["params"], port_model()))
    steps = []
    for b in batches(5, seed=0):
        jm, pm = je.train_step(b), pe.train_step(b)
        steps.append(({k: float(v) for k, v in jm.items()},
                      {k: float(v) for k, v in pm.items()}))
    return je, pe, init, steps


def test_five_steps_match_jax(run):
    je, pe, _, steps = run
    for jm, pm in steps:
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(pm[key], jm[key], rtol=REL, atol=0)
        assert pm["overflow"] == jm["overflow"] == 0
    # clipping at 1.0 bites: the global norm is above it on some step
    assert max(jm["grad_norm"] for jm, _ in steps) > 1.0
    assert_state_close(je.state, pe.state)
    assert pe.global_steps == 5 and pe.micro_steps == 10


def test_llama_five_steps_match_jax():
    """5 train_steps of the tiny LLaMA (flash attention with GQA, remat
    full, the fused untied loss head at chunk 16, AdamW, clipping at 0.5
    so that it bites, gas 2) against the JAX engine from the same initial
    params: losses, grad norms and the final state within 1e-5; the
    LLaMA train state crosses the bridge both ways unchanged."""
    config = dict(CONFIG, gradient_clipping=0.5)
    jm = jax_tf.TransformerLM(jax_tf.TransformerConfig(dtype=jnp.float32,
                                                       **LLAMA_SMALL))
    mesh = build_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    je, _, _, _ = ds.initialize(model=jm, config=json.loads(
        json.dumps(config)), mesh=mesh)
    init = jax.device_get(je.state)
    pm = tt.TransformerLM(tt.TransformerConfig(dtype=torch.float32,
                                               **LLAMA_SMALL))
    pe, _, _, _ = dt.initialize(model=pm, config=json.loads(
        json.dumps(config)), params=params_from_jax(init["params"], pm),
        device="cpu")
    # B*H 2 x 8 query heads over 2 x 2 kv heads: the two-pass backward
    assert not FA.check_dispatch((16, 64, 8), (4, 64, 8))
    gnorms = []
    for b in batches(5, seed=10):
        b = {"input_ids": b["input_ids"] % LLAMA_SMALL["vocab_size"]}
        jmet, pmet = je.train_step(b), pe.train_step(b)
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(pmet[key]), float(jmet[key]),
                                       rtol=REL, atol=0)
        gnorms.append(float(jmet["grad_norm"]))
    assert max(gnorms) > 0.5          # clipping bites
    assert_state_close(je.state, pe.state)
    js = jax.device_get(je.state)
    back = state_to_jax(state_from_jax(js, pm))
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a),
                                                   np.asarray(b)), back, js)


def test_metrics_stay_on_the_device(run):
    _, _, init, _ = run
    pe = port_engine(params_from_jax(init["params"], port_model()))
    m = pe.train_step(batches(1, seed=9)[0])
    assert all(isinstance(v, torch.Tensor) and v.dim() == 0
               for v in m.values())
    assert set(m) == {"loss", "grad_norm", "lr", "overflow", "loss_scale"}


def test_state_round_trips_through_jax_layout(run):
    je, _, _, _ = run
    js = jax.device_get(je.state)
    back = state_to_jax(state_from_jax(js, port_model()))
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a),
                                                   np.asarray(b)), back, js)


def test_resumed_engines_take_the_same_next_step(run):
    """A mid-run state (the port's, after its steps) carried into a fresh
    JAX engine and, through the JAX layout, into a fresh port engine:
    both take the same next step."""
    _, pe, _, _ = run
    mid = state_to_jax(pe.state)
    assert int(mid["step"]) == 5
    j2 = jax_engine()
    j2.state = jax.tree_util.tree_map(jnp.asarray, mid)
    p2 = port_engine(None)
    p2.state = state_from_jax(mid, port_model())
    b = batches(1, seed=3)[0]
    jm, pm = j2.train_step(b), p2.train_step(b)
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=REL)
    np.testing.assert_allclose(float(pm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=REL)
    assert_state_close(j2.state, p2.state)
    assert int(p2.state["step"]) == int(mid["step"]) + 1


def test_compat_forward_backward_step_equals_train_step(run):
    """gas = 2 micro batches through forward/backward, then step(): the
    same state as one train_step on the concatenated batch."""
    _, _, init, _ = run
    a = port_engine(params_from_jax(init["params"], port_model()))
    b = port_engine(params_from_jax(init["params"], port_model()))
    batch = batches(1, seed=4)[0]
    a.train_step(batch)
    for half in (batch["input_ids"][:2], batch["input_ids"][2:]):
        loss = b.forward({"input_ids": half})
        b.backward(loss)
    assert b.is_gradient_accumulation_boundary()
    b.step()
    assert b.global_steps == 1 and b.micro_steps == 2
    for x, y in zip(jax.tree_util.tree_leaves(state_to_jax(a.state)),
                    jax.tree_util.tree_leaves(state_to_jax(b.state))):
        np.testing.assert_array_equal(x, y)
    assert a.get_global_grad_norm() == b.get_global_grad_norm()


def test_nonfinite_grad_step_is_skipped_as_in_jax(run):
    """A NaN in the loss mask makes every gradient NaN: both engines keep
    params, moments and the step count and count the step as skipped."""
    _, _, init, _ = run
    je = jax_engine()
    pe = port_engine(params_from_jax(init["params"], port_model()))
    b = batches(1, seed=5)[0]
    b["loss_mask"] = np.ones((4, 64), np.float32)
    b["loss_mask"][1, 3] = np.nan
    jm, pm = je.train_step(b), pe.train_step(b)
    assert int(jm["overflow"]) == int(pm["overflow"]) == 1
    assert not np.isfinite(float(pm["grad_norm"]))
    assert pe.skipped_steps == 1 and int(pe.state["step"]) == 0
    assert_state_close(je.state, pe.state)
    np.testing.assert_array_equal(
        state_to_jax(pe.state)["params"]["embed"]["embedding"],
        init["params"]["embed"]["embedding"])
    # the next finite step is taken from the kept state
    b2 = batches(1, seed=6)[0]
    jm, pm = je.train_step(b2), pe.train_step(b2)
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=REL)
    assert int(pe.state["step"]) == 1 and pe.skipped_steps == 1


def test_eval_loss_and_lr_match_jax(run):
    je, pe, _, _ = run
    b = batches(1, seed=7)[0]
    np.testing.assert_allclose(float(pe.eval_loss(b)),
                               float(je.eval_loss(b)), rtol=REL)
    np.testing.assert_allclose(pe.get_lr(), je.get_lr(), rtol=1e-7)
    assert pe.num_parameters() == je.num_parameters()


def test_schedule_from_config_matches_jax():
    cfg = dict(CONFIG, scheduler={"type": "WarmupLR", "params": {
        "warmup_max_lr": 1e-3, "warmup_num_steps": 4}})
    je = jax_engine(cfg)
    init = jax.device_get(je.state)
    pe = port_engine(params_from_jax(init["params"], port_model()), cfg)
    for b in batches(3, seed=8):
        jm, pm = je.train_step(b), pe.train_step(b)
        np.testing.assert_allclose(float(pm["lr"]), float(jm["lr"]),
                                   rtol=1e-7)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=REL)


def test_train_batch_walks_the_loader():
    data = {"input_ids": np.random.RandomState(0).randint(
        0, 256, (12, 64)).astype(np.int32)}
    items = [{"input_ids": data["input_ids"][i]} for i in range(12)]
    pe, _, loader, sched = dt.initialize(model=port_model(), config=CONFIG,
                                         training_data=items, device="cpu")
    assert isinstance(loader, DeepSpeedDataLoader) and len(loader) == 3
    assert float(sched(torch.tensor(0))) == pytest.approx(6e-4)
    for _ in range(4):              # one epoch of 3, then a new epoch
        pe.train_batch(loader)
    assert pe.global_steps == 4


# -- config ------------------------------------------------------------------
@pytest.mark.parametrize("triple", [
    dict(train_batch_size=16),
    dict(train_micro_batch_size_per_gpu=4),
    dict(train_batch_size=16, train_micro_batch_size_per_gpu=4),
    dict(train_batch_size=16, gradient_accumulation_steps=2),
    dict(train_micro_batch_size_per_gpu=4, gradient_accumulation_steps=3),
    dict(train_batch_size=12, train_micro_batch_size_per_gpu=4,
         gradient_accumulation_steps=3),
])
def test_batch_triple_resolves_as_in_jax(triple):
    j, p = JaxConfig(dict(triple)), DeepSpeedConfig(dict(triple))
    for c in (j, p):
        c.resolve_batch_sizes(1)
    for k in ("train_batch_size", "train_micro_batch_size_per_gpu",
              "gradient_accumulation_steps"):
        assert getattr(p, k) == getattr(j, k), k


@pytest.mark.parametrize("cfg,world", [
    (dict(train_batch_size=10, train_micro_batch_size_per_gpu=4), 1),
    (dict(train_batch_size=10, train_micro_batch_size_per_gpu=2,
          gradient_accumulation_steps=3), 1),
    (dict(train_batch_size=10), 4),
    (dict(gradient_accumulation_steps=2), 1),
    (dict(train_batch_size=8, gradient_clipping=1.0, max_grad_norm=2.0),
     None),
    (dict(train_batch_size=8, fp16={"enabled": True},
          bf16={"enabled": True}), None),
    (dict(train_batch_size=0), 1),
    (dict(train_batch_size=8, zero_optimization={"stage": 5}), None),
    (dict(train_batch_size=8, zero_optimization={"offload_param": {
        "device": "cpu"}}), None),
    (dict(train_batch_size=8, training={"remat": "sometimes"}), None),
    (dict(train_batch_size=8, pipeline={"schedule": "zigzag"}), None),
    (dict(train_batch_size=8, resilience={"io_retry_attempts": 0}), None),
])
def test_config_errors_match_jax(cfg, world):
    """The same ValueError; the message matches where both sides write
    it (pydantic phrases its own field errors differently)."""
    def build(cls):
        c = cls(json.loads(json.dumps(cfg)))
        if world is not None:
            c.resolve_batch_sizes(world)
    with pytest.raises(ValueError) as je:
        build(JaxConfig)
    with pytest.raises(ValueError) as pe:
        build(DeepSpeedConfig)
    msg = str(pe.value)
    assert msg in str(je.value) or msg.split(", got")[0] in str(je.value)


def test_config_keys_and_defaults_match_jax():
    full = {"train_batch_size": 8, "gradient_clipping": 1.0,
            "bf16": {"enabled": True},
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
            "scheduler": {"type": "WarmupLR", "params": {}},
            "training": {"remat": "full", "loss_chunk": 256},
            "resilience": {"skip_nonfinite_grad_steps": False}}
    j, p = JaxConfig(dict(full)), DeepSpeedConfig(dict(full))
    for attr in ("train_batch_size", "gradient_clipping", "steps_per_print",
                 "wall_clock_breakdown", "precision_dtype",
                 "zero_optimization_stage"):
        assert getattr(p, attr) == getattr(j, attr), attr
    assert p.optimizer.type == j.optimizer.type
    assert p.optimizer.params == j.optimizer.params
    assert p.training.model_overrides() == j.training.model_overrides()
    assert (p.resilience.skip_nonfinite_grad_steps
            == j.resilience.skip_nonfinite_grad_steps)
    for block in ("fp16", "bf16", "zero_config", "resilience", "training",
                  "pipeline", "mesh"):
        jb, pb = getattr(JaxConfig({}), block), getattr(DeepSpeedConfig({}),
                                                        block)
        want = {k: v for k, v in jb.model_dump().items()
                if not isinstance(v, dict) and v is not None}
        got = {k: getattr(pb, k) for k in want}
        assert got == {k: (v.value if hasattr(v, "value") else v)
                       for k, v in want.items()}, block
    with pytest.raises(ValueError, match="unknown key"):
        DeepSpeedConfig({"train_batch_size": 8,
                         "zero_optimization": {"stagee": 1}})


@pytest.mark.parametrize("block", [
    {"sequence_parallel": {"enabled": True}},
    # ZeRO stages 1-3 over data parallelism and tensor parallelism at
    # stages 0-2 run since their slices (tests/test_torch_zero.py,
    # tests/test_torch_tp_training.py); the later parts of queue A item 7
    # stay refused: expert parallelism, ZeRO stage 3 over a model-sharded
    # mesh (the 3D composition), and offload over a data-parallel mesh
    # (ZeRO-Infinity's dp-sharded part)
    {"mesh": {"expert": 2}},
    {"tensor_parallel": {"enabled": True, "tp_size": 2},
     "zero_optimization": {"stage": 3}},
    {"zero_optimization": {"stage": 2, "offload_optimizer": {
        "device": "cpu"}}, "mesh": {"data": 2}},
    {"mesh": {"model": 2}, "zero_optimization": {"stage": 3}},
    # the pipeline runs since its slice (tests/test_torch_pipe*.py);
    # ZeRO stage 3 under it is the 3D composition's
    {"pipeline": {"stages": 2}, "zero_optimization": {"stage": 3}},
    {"tensorboard": {"enabled": True}},
    {"csv_monitor": {"enabled": True}},
])
def test_out_of_slice_blocks_raise(block):
    with pytest.raises(NotImplementedError, match="queue A"):
        dt.initialize(model=port_model(),
                      config={"train_batch_size": 4, **block},
                      device="cpu")


@pytest.mark.parametrize("override,what", [
    (dict(moe_num_experts=4, attention_layers=("global", "local")), "MoE"),
    pytest.param(dict(remat="host_offload", attn_impl="ulysses"), "ulysses",
                 id="override1-remat"),
])
def test_out_of_slice_model_options_raise(override, what):
    """Per-layer windows through the MoE superblock (which the JAX model
    refuses too; MoE itself trains since its slice, in
    ``tests/test_torch_moe.py``) and Ulysses attention (queue A item 7),
    also under host-offloaded remat, which runs since the offload slice
    (``tests/test_torch_offload.py``), raise; ALiBi, which raised here
    before, is the BLOOM family's (``tests/test_torch_families.py``)."""
    with pytest.raises(NotImplementedError, match=what):
        port_model(**override)


def test_optimizer_outside_the_slice_raises():
    """The 1-bit optimizers are a later part of queue A item 7."""
    with pytest.raises(NotImplementedError, match="1-bit"):
        dt.initialize(model=port_model(), config={
            "train_batch_size": 4, "optimizer": {"type": "OneBitAdam"}},
            device="cpu")


#: the optimizers of queue A item 1's rest, by their config names
CONFIG_OPTIMIZERS = [
    ("Lamb", {"lr": 2e-3, "weight_decay": 0.01}),
    ("SGD", {"lr": 0.05}),
    ("SGD", {"lr": 0.05, "momentum": 0.9, "nesterov": True}),
    # eps 1e-4: see test_torch_checkpoint.OPTIMIZERS (the key bias's
    # gradient is zero but for rounding)
    ("Adagrad", {"lr": 0.02, "eps": 1e-4, "weight_decay": 0.01}),
]


@pytest.mark.parametrize("name,params", CONFIG_OPTIMIZERS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(CONFIG_OPTIMIZERS)])
def test_config_optimizers_three_steps_match_jax(name, params):
    """LAMB, SGD and Adagrad named in the config's optimizer block: three
    train_steps (clipping, gas 2) from the JAX engine's initial params
    give the JAX engine's losses, grad norms and final state within the
    training limits."""
    config = dict(CONFIG, optimizer={"type": name, "params": params})
    je = jax_engine(config)
    init = jax.device_get(je.state)
    pe = port_engine(params_from_jax(init["params"], port_model()), config)
    for b in batches(3, seed=30):
        jm, pm = je.train_step(b), pe.train_step(b)
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(pm[key]), float(jm[key]),
                                       rtol=REL, atol=0)
    want = jax.device_get(je.state)
    got = state_to_jax(pe.state)
    jax.tree_util.tree_map(
        lambda x, y: np.testing.assert_allclose(x, np.asarray(y),
                                                **STATE_TOL), got, want)


#: (optax optimizer, the torch.optim factory computing the same step)
CLIENT_OPTIMIZERS = [
    ("sgd-momentum", lambda: optax.sgd(0.05, momentum=0.9),
     lambda: functools.partial(torch.optim.SGD, lr=0.05, momentum=0.9)),
    ("adam", lambda: optax.adam(1e-3),
     lambda: functools.partial(torch.optim.Adam, lr=1e-3)),
]


@pytest.mark.parametrize("name,make_tx,make_factory", CLIENT_OPTIMIZERS,
                         ids=[c[0] for c in CLIENT_OPTIMIZERS])
def test_client_optimizer_matches_optax_engine(name, make_tx, make_factory):
    """``initialize(optimizer=<torch.optim factory>)`` against the JAX
    engine's ``initialize(optimizer=<optax transformation>)``: three steps
    from the same params give the same losses and grad norms (1e-5) and
    params (1e-5); the reported lr is 0 on both (the rate lives in the
    client optimizer)."""
    config = {k: v for k, v in CONFIG.items() if k != "optimizer"}
    jm = jax_tf.TransformerLM(jax_tf.gpt2_config("125m", dtype=jnp.float32,
                                                 **SMALL))
    mesh = build_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    je, _, _, _ = ds.initialize(model=jm, optimizer=make_tx(),
                                config=json.loads(json.dumps(config)),
                                mesh=mesh)
    init = jax.device_get(je.state)
    pe, popt, _, _ = dt.initialize(
        model=port_model(), optimizer=make_factory(), config=config,
        params=params_from_jax(init["params"], port_model()), device="cpu")
    assert popt.hyperparams["external_lr"]
    for b in batches(3, seed=31):
        jmet, pmet = je.train_step(b), pe.train_step(b)
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(pmet[key]), float(jmet[key]),
                                       rtol=REL, atol=0)
    jax.tree_util.tree_map(
        lambda x, y: np.testing.assert_allclose(x, np.asarray(y),
                                                **STATE_TOL),
        params_to_jax(pe.state["params"]),
        jax.device_get(je.state["params"]))


def test_client_optimizer_refuses_an_engine_schedule():
    """As the JAX engine refuses a config scheduler beside an optax
    optimizer: the client optimizer carries its own rate."""
    with pytest.raises(ValueError, match="own learning rate"):
        dt.initialize(model=port_model(), optimizer=torch.optim.SGD,
                      config={**CONFIG, "scheduler": {
                          "type": "WarmupLR",
                          "params": {"warmup_num_steps": 2}}},
                      device="cpu")
    with pytest.raises(TypeError, match="torch.optim"):
        dt.initialize(model=port_model(), optimizer="sgd", config=CONFIG,
                      device="cpu")


def test_client_optimizer_skipped_step_keeps_its_state():
    """fp16 with an inf planted in the embedding: a skipped step leaves
    the client optimizer's state as it was (empty before its first step,
    then the momentum buffers of the last applied step) and the params
    with it."""
    config = {**{k: v for k, v in CONFIG.items() if k != "optimizer"},
              "fp16": {"enabled": True, "initial_scale_power": 4,
                       "hysteresis": 1}}
    pe, _, _, _ = dt.initialize(
        model=port_model(), config=config, device="cpu",
        optimizer=functools.partial(torch.optim.SGD, lr=0.05, momentum=0.9))
    b = batches(3, seed=32)
    emb = pe.state["params"]["embed"]["embedding"]
    saved = float(emb[0, 0])
    emb[0, 0] = float("inf")
    pe.train_step(b[0])
    assert int(pe.state["skipped"]) == 1 and pe.state["opt"]["torch"] == {}
    pe.state["params"]["embed"]["embedding"][0, 0] = saved
    pe.train_step(b[1])
    assert int(pe.state["opt"]["step"]) == 1
    bufs = [v["momentum_buffer"].clone()
            for v in pe.state["opt"]["torch"].values()]
    pe.state["params"]["embed"]["embedding"][0, 1] = float("inf")
    params = [p.clone() for p in tree_leaves(pe.state["params"])]
    pe.train_step(b[2])
    assert int(pe.state["skipped"]) == 2
    assert int(pe.state["opt"]["step"]) == 1
    for a, v in zip(bufs, pe.state["opt"]["torch"].values()):
        assert torch.equal(a, v["momentum_buffer"])
    for a, p in zip(params, tree_leaves(pe.state["params"])):
        assert torch.equal(a, p)


def test_initialize_needs_cuda_unless_cpu_requested():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: initialize() takes it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dt.initialize(model=port_model(), config=CONFIG)


def test_training_block_overrides_rebuild_the_model():
    pe, _, _, _ = dt.initialize(
        model=port_model(remat="none", loss_chunk=0),
        config={**CONFIG, "training": {"remat": "full", "loss_chunk": 32,
                                       "fused_loss_head": False}},
        device="cpu")
    c = pe.model.config
    assert (c.remat, c.loss_chunk, c.fused_loss_head) == ("full", 32, False)


@pytest.mark.parametrize("head", [
    dict(fused_loss_head=True, loss_chunk=16),
    dict(fused_loss_head=False, loss_chunk=16),
    dict(fused_loss_head=False, loss_chunk=0),
    dict(remat="none", attn_impl="xla", loss_chunk=0),
    dict(remat="dots_saveable"),
    dict(remat="dots_no_batch"),
    dict(remat="nothing_saveable"),
    dict(remat="dots_saveable", attn_impl="xla", fused_loss_head=False),
    dict(remat="dots_no_batch", attn_impl="xla", fused_loss_head=False),
    dict(remat="nothing_saveable", attn_impl="xla", loss_chunk=0),
])
def test_model_loss_and_grads_match_jax(head):
    """The three loss heads (fused, chunked with remat, dense), both
    attention routes and every remat policy (``dots_saveable``,
    ``dots_no_batch``, ``nothing_saveable``: the JAX model under the same
    ``jax.checkpoint`` policy) give JAX's loss and gradients, with a loss
    mask."""
    kw = {**SMALL, **head}
    jm = jax_tf.TransformerLM(jax_tf.gpt2_config("125m", dtype=jnp.float32,
                                                 **kw))
    jp = jax.device_get(jm.init(jax.random.PRNGKey(1)))
    pm = tt.TransformerLM(tt.gpt2_config("125m", dtype=torch.float32, **kw))
    tp = params_from_jax(jp, pm)
    rs = np.random.RandomState(2)
    ids = rs.randint(0, 256, (2, 64)).astype(np.int32)
    mask = (rs.rand(2, 64) > 0.2).astype(np.float32)
    jl, jg = jax.value_and_grad(jm.loss)(
        jp, {"input_ids": jnp.asarray(ids), "loss_mask": jnp.asarray(mask)})
    leaves = jax.tree_util.tree_map(
        lambda t: t.requires_grad_(True), tp)
    pl = pm.loss(leaves, {"input_ids": torch.from_numpy(ids).long(),
                          "loss_mask": torch.from_numpy(mask)})
    pl.backward()
    np.testing.assert_allclose(float(pl.detach()), float(jl), rtol=REL)
    jax.tree_util.tree_map(
        lambda t, g: np.testing.assert_allclose(
            t.grad.numpy(), np.asarray(g), atol=1e-5, rtol=1e-4),
        leaves, jax.device_get(jg))


# -- data loading --------------------------------------------------------------
def test_dataloader_batches_match_jax():
    data = {"x": np.arange(50).reshape(25, 2).astype(np.float32)}
    items = [{"x": data["x"][i]} for i in range(25)]
    for kw in (dict(shuffle=True, seed=3), dict(shuffle=False),
               dict(shuffle=True, drop_last=False)):
        jl = JaxLoader(items, batch_size=4, **kw)
        pl = DeepSpeedDataLoader(items, batch_size=4, **kw)
        assert len(pl) == len(jl)
        for _ in range(2):          # two epochs: the shuffle moves on
            got, want = list(pl), list(jl)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a["x"], b["x"])
    it = RepeatingLoader(DeepSpeedDataLoader(items, batch_size=10))
    assert [next(it)["x"].shape[0] for _ in range(5)] == [10] * 5
    a, b = synthetic_lm_batches(256, 16, 4, 7), jax_synthetic(256, 16, 4, 7)
    for _ in range(3):
        np.testing.assert_array_equal(next(a)["input_ids"],
                                      next(b)["input_ids"])


def test_blocksparse_five_steps_match_jax():
    """5 train_steps of a block-sparse GPT-2 (2 layers, d_model 64, 2
    heads, T 256, a Fixed layout of 32-row blocks, remat full, the fused
    loss head at chunk 64, AdamW, clipping 1.0, gas 2) against the JAX
    engine from the same initial params: every layer runs B8 twice
    (remat) and B9 and B10 once, their plain versions here and the JAX
    kernels in interpret mode; losses, grad norms and the final state
    within 1e-5."""
    from deepspeed_tpu.ops import sparse_attention as jax_sa
    from deepspeed_tpu_torch.ops import sparse_attention as port_sa
    model = dict(SMALL, num_heads=2, max_seq_len=256, loss_chunk=64,
                 attn_impl="blocksparse")
    skw = dict(num_heads=2, block=32, num_local_blocks=2,
               num_global_blocks=1)
    config = CONFIG
    jm = jax_tf.TransformerLM(jax_tf.gpt2_config(
        "125m", dtype=jnp.float32,
        sparsity_config=jax_sa.FixedSparsityConfig(**skw), **model))
    mesh = build_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    je, _, _, _ = ds.initialize(model=jm, config=json.loads(
        json.dumps(config)), mesh=mesh)
    init = jax.device_get(je.state)
    pm = tt.TransformerLM(tt.gpt2_config(
        "125m", dtype=torch.float32,
        sparsity_config=port_sa.FixedSparsityConfig(**skw), **model))
    pe, _, _, _ = dt.initialize(model=pm, config=json.loads(
        json.dumps(config)), params=params_from_jax(init["params"], pm),
        device="cpu")
    rs = np.random.RandomState(20)
    for _ in range(5):
        b = {"input_ids": rs.randint(0, 256, (4, 256)).astype(np.int32)}
        jmet, pmet = je.train_step(b), pe.train_step(b)
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(pmet[key]), float(jmet[key]),
                                       rtol=REL, atol=0)
    assert_state_close(je.state, pe.state)
