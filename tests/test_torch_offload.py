"""ZeRO-Offload tier 1 (``runtime/zero/offload.py``), the offload wire
codec (``runtime/zero/wire_codec.py``) and ``remat="host_offload"`` of the
port against the JAX package.

* The codec, fed the JAX encoder's uniform draws, gives its payload and
  scales byte for byte at 8, 4 and 1 bits (against the jitted encoder:
  XLA computes the scale ``max / levels`` as ``max * (1 / levels)``, and
  so does the port); the parameter wire's host encode and device decode
  and the host ``decode_into`` are equal too; a chunk holding NaN poisons.
* Tier 1 at f32 (the tiny GPT-2 of ``test_torch_training.py``: 2 layers,
  d_model 64, 4 heads, T 64, vocab 256, flash, remat full, fused head at
  chunk 16, AdamW, clipping 1.0, gas 2), with the same initial params
  carried through ``models/convert.py::params_from_jax``: losses and grad
  norms within 1e-5 relative of the JAX tier-1 engine over 4 steps, the
  host masters within 1e-5; at ``offload_wire_bits`` 8 within the JAX
  tests' bound (2e-2 relative, ``tests/unit/test_offload.py``).
* ``HostLossScaler`` and ``validate_offload_config`` equal JAX's.
* ``remat="host_offload"`` gives JAX's loss and gradients within 1e-5 in
  f32, and ``remat="full"``'s exactly.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dt
from deepspeed_tpu.models import transformer as jax_tf
from deepspeed_tpu.parallel.topology import build_mesh
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deepspeed_tpu.runtime.config import MeshConfig
from deepspeed_tpu.runtime.fp16 import DynamicLossScaler as JaxScaler
from deepspeed_tpu.runtime.zero import offload as joff
from deepspeed_tpu.runtime.zero import wire_codec as jwc
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.runtime.checkpoint_engine import \
    get_fp32_state_dict_from_zero_checkpoint
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.fp16.loss_scaler import DynamicLossScaler
from deepspeed_tpu_torch.runtime.optimizers import tree_leaves
from deepspeed_tpu_torch.runtime.zero import offload as poff
from deepspeed_tpu_torch.runtime.zero import wire_codec as pwc

SMALL = dict(num_layers=2, d_model=64, num_heads=4, vocab_size=256,
             max_seq_len=64, attn_impl="flash", remat="full", loss_chunk=16)
ZERO = {"stage": 2, "offload_optimizer": {"device": "cpu"}}
CONFIG = {"train_micro_batch_size_per_gpu": 2,
          "gradient_accumulation_steps": 2,
          "optimizer": {"type": "AdamW",
                        "params": {"lr": 6e-4, "weight_decay": 0.1}},
          "gradient_clipping": 1.0, "steps_per_print": 0,
          "zero_optimization": ZERO}
REL = 1e-5
WIRE_REL = 2e-2


def port_model(**kw):
    return tt.TransformerLM(tt.gpt2_config(
        "125m", **{"dtype": torch.float32, **SMALL, **kw}))


def jax_engine(config):
    jm = jax_tf.TransformerLM(jax_tf.gpt2_config("125m", dtype=jnp.float32,
                                                 **SMALL))
    mesh = build_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    eng, _, _, _ = ds.initialize(model=jm, config=json.loads(
        json.dumps(config)), mesh=mesh)
    return eng


def port_engine(params, config):
    eng, _, _, _ = dt.initialize(model=port_model(),
                                 config=json.loads(json.dumps(config)),
                                 params=params, device="cpu")
    return eng


def batches(n, seed):
    rs = np.random.RandomState(seed)
    return [{"input_ids": rs.randint(0, 256, (4, 64)).astype(np.int32)}
            for _ in range(n)]


# -- the wire codec ---------------------------------------------------------
def grad_vector(n_chunks=8, seed=0, nan=False):
    rs = np.random.RandomState(seed)
    n = n_chunks * pwc.CHUNK
    g = (rs.randn(n) * rs.rand(n) * 3).astype(np.float32)
    g[pwc.CHUNK:2 * pwc.CHUNK] = 0.0            # an all-zero chunk
    if nan:
        g[3 * pwc.CHUNK + 5] = np.nan
    return g


@pytest.mark.parametrize("bits", [8, 4, 1])
def test_encode_bytes_equal_jax(bits):
    g = grad_vector(nan=True)
    key = jax.random.PRNGKey(7)
    u = np.array(jax.random.uniform(key, (g.size // pwc.CHUNK, pwc.CHUNK)))
    jp, js = jax.jit(jwc.encode, static_argnums=1)(jnp.asarray(g), bits, key)
    pp, ps = pwc.encode(torch.from_numpy(g), bits,
                        uniform=torch.from_numpy(u))
    jp, js = np.asarray(jp), np.asarray(js)
    np.testing.assert_array_equal(js, ps.numpy())    # NaN where NaN
    per = pwc.payload_bytes_per_chunk(bits)
    assert pp.numel() * 1 == g.size // pwc.CHUNK * per
    finite = np.isfinite(js)
    np.testing.assert_array_equal(jp.reshape(-1, per)[finite],
                                  pp.numpy().reshape(-1, per)[finite])
    assert pwc.wire_bytes(g.size, bits) == jwc.wire_bytes(g.size, bits)
    # a generator's draws are deterministic and unbiased-looking
    gen = torch.Generator().manual_seed(1)
    a = pwc.encode(torch.from_numpy(g), bits, gen)
    gen = torch.Generator().manual_seed(1)
    b = pwc.encode(torch.from_numpy(g), bits, gen)
    assert torch.equal(a[0], b[0])


@pytest.mark.parametrize("bits", [8, 4, 1])
@pytest.mark.parametrize("accumulate", [False, True])
def test_decode_into_equal_jax(bits, accumulate):
    g = grad_vector(seed=1)
    key = jax.random.PRNGKey(3)
    payload, scales = (np.asarray(x) for x in jax.jit(
        jwc.encode, static_argnums=1)(jnp.asarray(g), bits, key))
    out_j = np.full(g.size, 0.5, np.float32)
    out_p = out_j.copy()
    jwc.decode_into(out_j, payload, scales, bits, accumulate=accumulate)
    pwc.decode_into(out_p, payload, scales, bits, accumulate=accumulate)
    np.testing.assert_array_equal(out_j, out_p)
    # unbiased: the decode tracks the gradient within one scale a chunk
    dec = np.zeros(g.size, np.float32)
    pwc.decode_into(dec, payload, scales, bits)
    step = np.repeat(scales, pwc.CHUNK) * (2.0 if bits == 1 else 1.0)
    assert np.all(np.abs(dec - g) <= step * 1.0001)


@pytest.mark.parametrize("bits", [8, 4])
def test_param_wire_equal_jax(bits):
    g = grad_vector(seed=2, nan=True)
    bf = (torch.from_numpy(g).to(torch.bfloat16).view(torch.int16)
          .numpy().view(np.uint16))
    import ml_dtypes
    jp, js = jwc.encode_params_host(bf.view(ml_dtypes.bfloat16), bits)
    pp, ps = pwc.encode_params_host(bf, bits)
    np.testing.assert_array_equal(js, ps)
    finite = np.isfinite(js)
    per = pwc.payload_bytes_per_chunk(bits)
    np.testing.assert_array_equal(jp.reshape(-1, per)[finite],
                                  pp.reshape(-1, per)[finite])
    jd = np.asarray(jax.jit(jwc.decode_params, static_argnums=2)(
        jnp.asarray(pp), jnp.asarray(ps), bits)).astype(np.float32)
    pd = pwc.decode_params(torch.from_numpy(pp), torch.from_numpy(ps),
                           bits).to(torch.float32).numpy()
    np.testing.assert_array_equal(jd, pd)
    # the NaN master's chunk comes back NaN; the others finite
    chunks = pd.reshape(-1, pwc.CHUNK)
    assert np.isnan(chunks[3]).all() and np.isfinite(chunks[finite]).all()


@pytest.mark.parametrize("bits", [8, 4, 1])
def test_nonfinite_grads_poison_the_decode(bits):
    g = grad_vector(seed=4)
    g[10] = np.inf
    payload, scales = pwc.encode(torch.from_numpy(g), bits,
                                 torch.Generator().manual_seed(0))
    out = np.zeros(g.size, np.float32)
    pwc.decode_into(out, payload.numpy(), scales.numpy(), bits)
    assert not np.isfinite(out[:pwc.CHUNK]).any()
    assert np.isfinite(out[pwc.CHUNK:]).all()


def test_codec_rejects_ragged_vectors():
    with pytest.raises(ValueError, match="n % 2048"):
        pwc.encode(torch.zeros(100), 8)
    with pytest.raises(ValueError, match="n % 2048"):
        pwc.encode_params_host(np.zeros(100, np.float32), 8)


# -- tier 1 against the JAX engine -----------------------------------------------
def run_pair(config, n_steps=4):
    je = jax_engine(config)
    init = jax.device_get(je.state["params"])
    pe = port_engine(params_from_jax(init, port_model()), config)
    steps = []
    for b in batches(n_steps, seed=0):
        jm, pm = je.train_step(b), pe.train_step(b)
        steps.append(({k: float(v) for k, v in jm.items()},
                      {k: float(v) for k, v in pm.items()}))
    return je, pe, steps


@pytest.fixture(scope="module")
def tier1():
    return run_pair(CONFIG)


def test_tier1_steps_match_jax(tier1):
    _, _, steps = tier1
    for jm, pm in steps:
        for k in ("loss", "grad_norm", "lr"):
            assert pm[k] == pytest.approx(jm[k], rel=REL), k
        assert pm["overflow"] == jm["overflow"] == 0


def _paths(tree, pre=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, pre + (k,))
        else:
            yield "/".join(pre + (k,))


def test_tier1_host_state_matches_jax(tier1):
    je, pe, _ = tier1
    jo, po = je._host_opt.opt, pe._host_opt.opt
    assert po.step_count == jo.step_count == 4
    jtree = jax.tree_util.tree_unflatten(je._host_opt.treedef, jo.master)
    by_path = {"/".join(str(getattr(p, "key", p)) for p in path): leaf
               for path, leaf in jax.tree_util.tree_flatten_with_path(
                   jtree)[0]}
    paths = list(_paths(pe.state["params"]))
    assert len(paths) == len(po.master) == len(by_path)
    for path, mine in zip(paths, po.master):
        np.testing.assert_allclose(mine, by_path[path], atol=1e-5,
                                   rtol=1e-5)
    # the device copies are the masters (f32 compute)
    for leaf, mine in zip(tree_leaves(pe.state["params"]), po.master):
        np.testing.assert_array_equal(leaf.numpy(), mine)


def test_tier1_wire8_tracks_jax():
    cfg = json.loads(json.dumps(CONFIG))
    cfg["zero_optimization"]["offload_wire_bits"] = 8
    _, pe, steps = run_pair(cfg, n_steps=3)
    for jm, pm in steps:
        assert pm["loss"] == pytest.approx(jm["loss"], rel=WIRE_REL)
        assert pm["grad_norm"] == pytest.approx(jm["grad_norm"], rel=WIRE_REL)
    assert pe._host_opt.timing["pieces"] >= 1


def test_tier1_bf16_device_params_and_checkpoint(tmp_path):
    """bf16 compute: the device keeps bf16 params only (the host sweep
    emits them), the loss falls; save → load → the next step is equal,
    a module-only load re-derives the masters from the params."""
    cfg = json.loads(json.dumps(CONFIG))
    cfg["bf16"] = {"enabled": True}
    model = port_model(dtype=torch.bfloat16)
    eng, _, _, _ = dt.initialize(model=model, config=cfg, device="cpu")
    assert all(p.dtype == torch.bfloat16
               for p in tree_leaves(eng.state["params"]))
    assert "opt" not in eng.state
    bs = batches(4, seed=2)
    losses = [float(eng.train_step(bs[0])["loss"]) for _ in range(3)]
    assert losses[-1] < losses[0]
    for leaf, m in zip(tree_leaves(eng.state["params"]),
                       eng._host_opt.opt.master):
        np.testing.assert_array_equal(
            leaf.view(torch.int16).numpy(),
            torch.from_numpy(m).to(torch.bfloat16).view(torch.int16).numpy())
    eng.save_checkpoint(str(tmp_path), tag="off")
    assert (tmp_path / "off" / "host_opt.pt").exists()
    other, _, _, _ = dt.initialize(model=model, config=cfg, device="cpu",
                                   seed=5)
    other.load_checkpoint(str(tmp_path), tag="off")
    a, b = eng.train_step(bs[1]), other.train_step(bs[1])
    assert float(a["loss"]) == float(b["loss"])
    for x, y in zip(eng._host_opt.opt.master, other._host_opt.opt.master):
        np.testing.assert_array_equal(x, y)
    fp32 = get_fp32_state_dict_from_zero_checkpoint(str(tmp_path), "off")
    for leaf in tree_leaves(fp32):
        assert leaf.dtype == torch.float32
    third, _, _, _ = dt.initialize(model=model, config=cfg, device="cpu",
                                   seed=6)
    third.load_checkpoint(str(tmp_path), tag="off", load_module_only=True)
    assert third._host_opt.opt.step_count == 0
    for leaf, m in zip(tree_leaves(third.state["params"]),
                       third._host_opt.opt.master):
        np.testing.assert_array_equal(leaf.float().numpy(), m)


def test_tier1_fp16_tracks_scale_like_jax():
    """fp16: the host scaler's scale after 3 steps equals the JAX
    engine's (no overflow at 2^8)."""
    cfg = json.loads(json.dumps(CONFIG))
    cfg["fp16"] = {"enabled": True, "initial_scale_power": 8}
    eng, _, _, _ = dt.initialize(model=port_model(), config=cfg,
                                 device="cpu")
    for b in batches(3, seed=1):
        m = eng.train_step(b)
        assert np.isfinite(float(m["loss"]))
    assert eng.loss_scale == 256.0 and eng.skipped_steps == 0


def test_host_loss_scaler_equals_jax():
    seq = [True, False, False, True, True, False, False, False, True,
           False, False, False, False, False]
    for hysteresis in (1, 2):
        j = joff.HostLossScaler(JaxScaler(initial_scale_power=4,
                                          scale_window=2,
                                          hysteresis=hysteresis))
        p = poff.HostLossScaler(DynamicLossScaler(initial_scale_power=4,
                                                  scale_window=2,
                                                  hysteresis=hysteresis))
        for overflow in seq:
            j.update(overflow)
            p.update(overflow)
            assert (p.scale, p.good_steps, p.hysteresis) == \
                (j.scale, j.good_steps, j.hysteresis)


@pytest.mark.parametrize("zero,kind", [
    ({"stage": 2, "offload_optimizer": {"device": "cpu"},
      "offload_wire_bits": 3}, ValueError),
    ({"stage": 0, "offload_wire_bits": 8}, ValueError),
    ({"stage": 2, "offload_optimizer": {"device": "nvme",
                                        "nvme_path": "/tmp"}},
     NotImplementedError),
])
def test_validate_offload_config_messages_equal_jax(zero, kind):
    cfg = {"train_batch_size": 4, "zero_optimization": zero}
    try:
        want = joff.validate_offload_config(JaxConfig(dict(cfg)))
    except Exception as e:   # noqa: BLE001 - compared below
        want = e
    try:
        got = poff.validate_offload_config(DeepSpeedConfig(dict(cfg)))
    except Exception as e:   # noqa: BLE001 - compared below
        got = e
    if isinstance(want, ValueError) and not isinstance(got, Exception):
        # pydantic refuses wire bits 3 while parsing, the port while
        # validating the block
        pytest.fail(f"port accepted {zero}")
    assert isinstance(got, kind)
    if isinstance(want, Exception) and type(want) is type(got):
        assert str(got) == str(want)


def test_validate_offload_config_modes_equal_jax():
    for zero, mode in ((None, "none"),
                       ({"stage": 2, "offload_optimizer": {"device": "cpu"}},
                        "optimizer"),
                       ({"stage": 3, "offload_param": {"device": "cpu"},
                         "offload_optimizer": {"device": "cpu"}},
                        "infinity")):
        cfg = {"train_batch_size": 4}
        if zero:
            cfg["zero_optimization"] = zero
        assert poff.validate_offload_config(DeepSpeedConfig(dict(cfg))) \
            == joff.validate_offload_config(JaxConfig(dict(cfg))) == mode


def test_offload_refuses_the_compat_surface_and_client_optimizers():
    eng = port_engine(None, CONFIG)
    with pytest.raises(NotImplementedError, match="not wired for offload"):
        eng.forward(batches(1, 0)[0])
    with pytest.raises(ValueError, match="config-named optimizer"):
        dt.initialize(model=port_model(), config=json.loads(json.dumps(
            CONFIG)), optimizer=torch.optim.SGD, device="cpu")


def test_pipelined_pieces_cut_leaves():
    pieces = poff.plan_pieces([5, 3, 9], 4)
    assert [(p.lo, p.hi) for p in pieces] == [(0, 4), (4, 8), (8, 12),
                                              (12, 16), (16, 17)]
    assert pieces[1].segments == [(0, 4, 5, 0), (1, 0, 3, 1)]
    covered = sum(b - a for p in pieces for _, a, b, _ in p.segments)
    assert covered == 17


# -- remat="host_offload" ---------------------------------------------------------
def test_host_offload_remat_equals_jax_and_full():
    jm = jax_tf.TransformerLM(jax_tf.gpt2_config(
        "125m", dtype=jnp.float32, **{**SMALL, "remat": "host_offload"}))
    params = jm.init(jax.random.PRNGKey(0))
    ids = np.random.RandomState(0).randint(0, 256, (2, 64)).astype(np.int32)
    jl, jg = jax.value_and_grad(
        lambda p: jm.loss(p, {"input_ids": jnp.asarray(ids)}))(params)
    want = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_flatten_with_path(
                jax.device_get(jg))[0]}
    out = {}
    for remat in ("host_offload", "full"):
        pm = port_model(remat=remat)
        tp = params_from_jax(jax.device_get(params), pm)
        leaves = []

        def req(tree, pre=()):
            for k, v in tree.items():
                if isinstance(v, dict):
                    req(v, pre + (k,))
                else:
                    tree[k] = v.requires_grad_(True)
                    leaves.append(("/".join(pre + (k,)), tree[k]))
        req(tp)
        loss = pm.loss(tp, {"input_ids": torch.from_numpy(ids).long()})
        loss.backward()
        out[remat] = (float(loss), {k: v.grad.numpy() for k, v in leaves})
    assert out["host_offload"][0] == pytest.approx(float(jl), rel=REL)
    assert out["host_offload"][0] == out["full"][0]
    for k, g in out["host_offload"][1].items():
        np.testing.assert_allclose(g, want[k], atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(g, out["full"][1][k])


def test_host_offload_remat_trains_moe():
    """An MoE superblock (capacity and routing counts pass through the
    offloaded block beside the differentiable outputs) under
    ``host_offload`` equals ``full``."""
    kw = dict(moe_num_experts=4, moe_freq=2, moe_k=1, num_layers=2)
    ids = torch.from_numpy(np.random.RandomState(1).randint(
        0, 256, (2, 64))).long()
    res = {}
    for remat in ("host_offload", "full"):
        pm = port_model(remat=remat, **kw)
        g = torch.Generator().manual_seed(0)
        p = pm.init(g, "cpu", torch.float32)
        leaves = [x.requires_grad_(True) for x in tree_leaves(p)]
        loss = pm.loss(p, {"input_ids": ids})
        res[remat] = (float(loss), [t.numpy() for t in torch.autograd.grad(
            loss, leaves)])
    assert res["host_offload"][0] == res["full"][0]
    for a, b in zip(res["host_offload"][1], res["full"][1]):
        np.testing.assert_array_equal(a, b)


def test_training_block_accepts_host_offload():
    cfg = {"train_batch_size": 4, "training": {"remat": "host_offload"}}
    eng = port_engine(None, {**json.loads(json.dumps(CONFIG)), **cfg,
                             "zero_optimization": {"stage": 0}})
    assert eng.model.config.remat == "host_offload"
    m = eng.train_step(batches(1, 3)[0])
    assert np.isfinite(float(m["loss"]))
