"""ZeRO-Infinity of the port (``runtime/zero/infinity.py``) against the
JAX package's ``InfinityStepper`` and the port's in-HBM engine.

The model is the JAX tests' ``TINY`` (``tests/unit/test_infinity.py``: 3
layers, d_model 32, 2 heads, vocab 128, T 32, float32 params, bf16
compute) on a one-device mesh, AdamW lr 1e-3, a batch of 4.  The three
engines start from the same params: the JAX Infinity engine's own init,
carried through ``models/convert.py::params_from_jax``.  Each step's loss
agrees within 5e-3 and its grad norm within 5 % of max(1, norm), the JAX
tests' bounds for an Infinity engine against the in-HBM one (bf16
compute: the streamed step rounds where the in-HBM step does, in another
order), in all three step modes (pure stream, streamed gas, clip-gated),
under the param wire (8 and 4 bits, whose host encodes are byte-equal in
both packages), the grad wire (8 bits; stochastic rounding, so only
within the bounds) and with MoE.  The NVMe tiers equal the DRAM ones bit
for bit.  Checkpoints cross in both directions in the JAX package's
layout (``slot_NNNNN.npz``, ``resident.npz``, ``meta.json``).  The
refusals carry the JAX messages.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from deepspeed_tpu.models.transformer import TransformerConfig as JaxTC
from deepspeed_tpu.models.transformer import TransformerLM as JaxLM
from deepspeed_tpu.parallel import topology as topo
from deepspeed_tpu.runtime.engine import DeepSpeedEngine as JaxEngine
import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.runtime.checkpoint_engine import \
    get_fp32_state_dict_from_zero_checkpoint
from deepspeed_tpu_torch.runtime.resilience import (FatalIOError,
                                                    FaultInjector,
                                                    install_fault_injector)
from deepspeed_tpu_torch.runtime.zero.infinity import sorted_leaves

TINY = dict(vocab_size=128, max_seq_len=32, num_layers=3, num_heads=2,
            d_model=32, loss_chunk=0)
LOSS_TOL, GNORM_REL = 5e-3, 5e-2
MODES = {"stream": (1, 0.0), "gas": (2, 0.0), "clip": (2, 1.0)}


def single_mesh():
    axes = (topo.DCN_DATA_AXIS, topo.PIPE_AXIS, topo.DATA_AXIS,
            topo.EXPERT_AXIS, topo.SEQUENCE_AXIS, topo.MODEL_AXIS)
    return Mesh(np.asarray(jax.devices()[:1]).reshape((1,) * 6), axes)


def ids_batch(seed=1):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (4, 32),
                                         0, 128))


def engine_cfg(gas=1, clip=0.0, zero=None):
    cfg = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 4 // gas,
           "gradient_accumulation_steps": gas,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
           "bf16": {"enabled": True}, "gradient_clipping": clip}
    if zero:
        cfg["zero_optimization"] = zero
    return cfg


def infinity_zero(param="cpu", opt="cpu", nvme=None, **kw):
    return {"stage": 3,
            "offload_param": {"device": param, "nvme_path": nvme},
            "offload_optimizer": {"device": opt, "nvme_path": nvme}, **kw}


def jax_model(**over):
    return JaxLM(JaxTC(**{**TINY, "param_dtype": jnp.float32,
                          "dtype": jnp.bfloat16, **over}))


def port_model(**over):
    return tt.TransformerLM(tt.TransformerConfig(**{
        **TINY, "param_dtype": torch.float32, "dtype": torch.bfloat16,
        **over}))


def jax_infinity(cfg, over=None, rng=0):
    cfg = dict(cfg, mesh={"data": 1})
    return JaxEngine(jax_model(**(over or {})), config=cfg,
                     rng=jax.random.PRNGKey(rng), mesh=single_mesh())


def port_engine(cfg, params, over=None):
    eng, _, _, _ = dt.initialize(model=port_model(**(over or {})),
                                 config=json.loads(json.dumps(cfg)),
                                 params=params, device="cpu")
    return eng


def three_way(cfg_kw, zero_kw=None, over=None, steps=3):
    """The JAX Infinity engine, the port's and the port's in-HBM engine
    from the JAX engine's init, ``steps`` steps each: their metrics."""
    gas, clip = cfg_kw
    zero = infinity_zero(**(zero_kw or {}))
    je = jax_infinity(engine_cfg(gas, clip, zero), over)
    init = je._infinity.gather_params()
    pm = port_model(**(over or {}))
    pi = port_engine(engine_cfg(gas, clip, zero),
                     params_from_jax(init, pm), over)
    pb = port_engine(engine_cfg(gas, clip), params_from_jax(init, pm), over)
    ids = ids_batch()
    rows = []
    for _ in range(steps):
        rows.append(tuple({k: float(v) for k, v in e.train_step(
            {"input_ids": ids}).items()} for e in (je, pi, pb)))
    return je, pi, pb, rows


def close(a, b):
    assert abs(a["loss"] - b["loss"]) < LOSS_TOL, (a, b)
    assert abs(a["grad_norm"] - b["grad_norm"]) < \
        GNORM_REL * max(1.0, b["grad_norm"]), (a, b)


@pytest.fixture(scope="module", params=sorted(MODES))
def mode_run(request):
    return request.param, three_way(MODES[request.param])


def test_step_modes_match_jax_and_in_hbm(mode_run):
    mode, (_, pi, _, rows) = mode_run
    st = pi._infinity
    assert st._grad_accum is None if mode == "stream" else \
        st._grad_accum.shape == (st.L, st.n_pad)
    for jm, im, bm in rows:
        close(im, jm)
        close(im, bm)
        assert im["overflow"] == 0 and im["lr"] == pytest.approx(1e-3)
    assert int(pi.state["step"]) == 3 and pi.global_steps == 3


def test_masters_track_jax(mode_run):
    """After 3 steps the port's host masters are within 2 x 3 x lr of the
    JAX stepper's: Adam's first updates are about lr x sign(g), so a
    gradient near zero that bf16 rounding flips moves a weight by lr the
    other way each step (biases, whose gradients are tiny, show it)."""
    _, (je, pi, _, _) = mode_run
    want = je._infinity.gather_params()
    got = pi._infinity.gather_params()
    for (path, g), (_, w) in zip(sorted_leaves(got),
                                 sorted_leaves(jax.device_get(want))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=6e-3,
                                   err_msg="/".join(path))


def test_param_wire_matches_jax():
    je, pi, pb, rows = three_way((1, 0.0), {"offload_param_bits": 8},
                                 steps=2)
    for jm, im, _ in rows:
        close(im, jm)
    st = pi._infinity
    assert st.param_bits == 8 and st.n_pad % 2048 == 0
    # the encode cache: every layer cached by an eval, reused while the
    # masters hold, invalidated by the next sweep
    pi.eval_loss({"input_ids": ids_batch()})
    assert set(st._enc_cache) == set(range(st.L))
    before = {i: id(st._enc_cache[i][0]) for i in st._enc_cache}
    pi.eval_loss({"input_ids": ids_batch()})
    assert {i: id(st._enc_cache[i][0]) for i in st._enc_cache} == before
    v0 = list(st._enc_version)
    pi.train_step({"input_ids": ids_batch()})
    assert all(b > a for a, b in zip(v0, st._enc_version))


def test_param_wire4_grad_wire_gas_clip_match_jax():
    """The 4-bit param wire composed with the 8-bit grad wire, gas 2 and
    clipping (the JAX tests' composition case)."""
    _, pi, _, rows = three_way((2, 1.0), {"offload_wire_bits": 8,
                                          "offload_param_bits": 4}, steps=2)
    for jm, im, _ in rows:
        close(im, jm)
    assert pi._infinity.wire_bits == 8 and pi._infinity.param_bits == 4


def test_moe_matches_in_hbm():
    """Top-2 MoE every other layer: the experts stream inside the layer
    vector and the aux loss's gradient rides each layer's backward; held
    to the port's in-HBM MoE engine, which ``tests/test_torch_moe.py``
    holds to the JAX engine."""
    over = dict(moe_num_experts=4, moe_freq=2, moe_k=2, moe_use_rts=False,
                num_layers=4)
    init = port_model(**over).init_streamed(0, "cpu", torch.float32)
    pi = port_engine(engine_cfg(zero=infinity_zero()), init, over)
    pb = port_engine(engine_cfg(), init, over)
    ids = ids_batch()
    for _ in range(3):
        close({k: float(v) for k, v in pi.train_step(
            {"input_ids": ids}).items()},
            {k: float(v) for k, v in pb.train_step(
                {"input_ids": ids}).items()})
    assert pi._infinity.L == 2


def test_nvme_bitwise_matches_dram(tmp_path):
    init = port_model().init_streamed(0, "cpu", torch.float32)
    dram = port_engine(engine_cfg(zero=infinity_zero()), init)
    nvme = port_engine(engine_cfg(zero=infinity_zero("nvme", "nvme",
                                                     str(tmp_path))), init)
    ids = ids_batch()
    for _ in range(2):
        a = dram.train_step({"input_ids": ids})
        b = nvme.train_step({"input_ids": ids})
        assert float(a["loss"]) == float(b["loss"])
    for (path, x), (_, y) in zip(sorted_leaves(dram._infinity.gather_params()),
                                 sorted_leaves(nvme._infinity.gather_params())):
        assert torch.equal(x, y), path
    assert nvme._infinity.opt.disk_bytes > 0
    assert os.path.exists(tmp_path / "optimizer.swp")
    nvme._infinity.close()


def test_streamed_init_is_the_models_per_layer_draw():
    """Without params, the stepper draws layer i alone from
    ``superblock_keys(seed)[i]`` (never more than one layer on the
    device): its masters equal ``init_streamed(seed)`` bit for bit, and
    the layers' statistics are the model init's."""
    cfg = engine_cfg(zero=infinity_zero())
    eng, _, _, _ = dt.initialize(model=port_model(), config=cfg,
                                 device="cpu", seed=3)
    got = eng._infinity.gather_params()
    want = port_model().init_streamed(3, "cpu", torch.float32)
    for (p, a), (q, b) in zip(sorted_leaves(got), sorted_leaves(want)):
        assert p == q
        assert torch.equal(a, b), p
    m = port_model()
    keys = m.superblock_keys(3)
    layer1 = m.init_superblock(torch.Generator().manual_seed(keys[1]), "cpu",
                               torch.float32)
    for path, leaf in sorted_leaves(layer1):
        node = want["blocks"]
        for k in path:
            node = node[k]
        assert torch.equal(node[1], leaf)
    ref = m.init(torch.Generator().manual_seed(0), "cpu", torch.float32)
    for (p, a), (_, b) in zip(sorted_leaves(want), sorted_leaves(ref)):
        assert a.shape == b.shape, p
        assert float(a.std()) == pytest.approx(float(b.std()), rel=0.35,
                                               abs=1e-6), p


def _step_all(engines, ids):
    return [float(e.train_step({"input_ids": ids})["loss"]) for e in engines]


@pytest.fixture(scope="module")
def pair():
    """A JAX Infinity engine and the port's from its init (the eval test
    reads them, then the checkpoint test trains them)."""
    je = jax_infinity(engine_cfg(zero=infinity_zero()))
    init = je._infinity.gather_params()
    pi = port_engine(engine_cfg(zero=infinity_zero()),
                     params_from_jax(init, port_model()))
    return je, pi, init


def test_eval_labels_and_mask_match_in_hbm(pair):
    je, pi, init = pair
    pb = port_engine(engine_cfg(), params_from_jax(init, port_model()))
    ids = ids_batch()
    labels = np.roll(ids, -1, axis=1)
    mask = np.ones_like(ids, np.float32)
    mask[:, -4:] = 0.0
    batch = {"input_ids": ids, "labels": labels, "loss_mask": mask}
    assert float(pi.eval_loss(batch)) == pytest.approx(
        float(pb.eval_loss(batch)), abs=LOSS_TOL)
    assert float(pi.eval_loss(batch)) == pytest.approx(
        float(je.eval_loss(batch)), abs=LOSS_TOL)
    assert pi.num_parameters() == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(init))
    # the labels and mask path of a step, against the in-HBM engine from
    # the same params
    pl = port_engine(engine_cfg(zero=infinity_zero()),
                     params_from_jax(init, port_model()))
    close({k: float(v) for k, v in pl.train_step(batch).items()},
          {k: float(v) for k, v in pb.train_step(batch).items()})


def test_checkpoint_crosses_both_ways(pair, tmp_path):
    """A JAX ``save_to_dir`` loads into the port and the next losses
    match; the port's save of the state it reached loads back into the
    JAX stepper and the next losses match again.  meta.json holds the
    JAX leaf paths."""
    je, pi, _ = pair
    ids = ids_batch()
    for _ in range(2):
        je.train_step({"input_ids": ids})
    je._infinity.save_to_dir(str(tmp_path / "jax"))
    pi._infinity.load_from_dir(str(tmp_path / "jax"))
    pi.state["step"] = torch.tensor(2, dtype=torch.int32)
    assert pi._infinity.opt.step_count == je._infinity.opt.step_count == 2
    a, b = _step_all([je, pi], ids)
    assert abs(a - b) < LOSS_TOL
    pi._infinity.save_to_dir(str(tmp_path / "port"))
    je._infinity.load_from_dir(str(tmp_path / "port"))
    meta = json.loads((tmp_path / "port" / "meta.json").read_text())
    jtpl = jax.eval_shape(jax_model().init_superblock, jax.random.PRNGKey(0))
    want = ["/".join(str(getattr(k, "key", k)) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(jtpl)[0]]
    assert [x["path"] for x in meta["layer_leaves"]] == want
    assert meta["step_count"] == 3
    assert sorted(os.listdir(tmp_path / "port")) == [
        "meta.json", "resident.npz", "slot_00000.npz", "slot_00001.npz",
        "slot_00002.npz"]
    for _ in range(2):
        a, b = _step_all([je, pi], ids)
        assert abs(a - b) < LOSS_TOL


def test_engine_checkpoint_resumes_bitwise(tmp_path):
    """``save_checkpoint`` streams the stores into ``<tag>/infinity``; a
    fresh engine that loads it steps as the engine that never stopped,
    bit for bit; the offline float32 tree equals the live gather; a
    module-only load keeps the params and zeroes the moments."""
    ids = ids_batch()
    a = port_engine(engine_cfg(zero=infinity_zero()), None)
    for _ in range(2):
        a.train_step({"input_ids": ids})
    a.save_checkpoint(str(tmp_path), tag="t2")
    assert (tmp_path / "t2" / "infinity" / "meta.json").exists()
    live = a._infinity.gather_params()
    offline = get_fp32_state_dict_from_zero_checkpoint(str(tmp_path), "t2")
    for (p, x), (q, y) in zip(sorted_leaves(live), sorted_leaves(offline)):
        assert p == q and torch.equal(x, y), p
    b, _, _, _ = dt.initialize(model=port_model(), config=engine_cfg(
        zero=infinity_zero()), device="cpu", seed=7)
    b.load_checkpoint(str(tmp_path))
    assert b.global_steps == 2 and int(b.state["step"]) == 2
    ra, rb = a.train_step({"input_ids": ids}), b.train_step({"input_ids": ids})
    assert float(ra["loss"]) == float(rb["loss"])
    assert float(ra["grad_norm"]) == float(rb["grad_norm"])
    c, _, _, _ = dt.initialize(model=port_model(), config=engine_cfg(
        zero=infinity_zero()), device="cpu", seed=9)
    c.load_checkpoint(str(tmp_path), tag="t2", load_module_only=True)
    p, m, v = c._infinity.opt.state(0)
    assert not m.any() and not v.any() and c._infinity.opt.step_count == 0
    np.testing.assert_array_equal(p[:c._infinity.n_elems],
                                  live_layer0(live, c._infinity))


def live_layer0(tree, st):
    return np.concatenate([_node(tree["blocks"], p)[0].reshape(-1).numpy()
                           for p in st._paths])


def _node(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_slot_write_fault_site_retries(tmp_path):
    """``infinity.slot_write`` runs under the retry policy: a transient
    fault is absorbed, a fatal one raises."""
    pi = port_engine(dict(engine_cfg(zero=infinity_zero()), resilience={
        "io_retry_base_delay_s": 0.0, "io_retry_max_delay_s": 0.0}), None)
    fi = FaultInjector()
    fi.add_plan("infinity.slot_write", "fail", count=1)
    install_fault_injector(fi)
    try:
        pi._infinity.save_to_dir(str(tmp_path / "a"))
        assert fi.fire_count("infinity.slot_write") == 1
        fi.reset()
        fi.add_plan("infinity.slot_read", "fail", count=1)
        pi._infinity.load_from_dir(str(tmp_path / "a"))
        assert fi.fire_count("infinity.slot_read") == 1
        fi.reset()
        fi.add_plan("infinity.slot_write", "fatal")
        with pytest.raises(FatalIOError):
            pi._infinity.save_to_dir(str(tmp_path / "b"))
    finally:
        install_fault_injector(FaultInjector())


def test_device_layer_cache_budget():
    """``max_live_parameters`` bounds the device layer cache in bytes (at
    least the double buffer); a quantized cache holds twice the layers
    (the JAX stepper's formula: 2 and 3 layers here)."""
    n = port_engine(engine_cfg(zero=infinity_zero()), None)._infinity.n_elems
    for bits, want in ((0, 2), (8, 3)):
        zero = infinity_zero(max_live_parameters=int(1.5 * n),
                             offload_param_bits=bits)
        st = port_engine(engine_cfg(zero=zero), None)._infinity
        assert st.max_live_layers == want
        st.engine.train_step({"input_ids": ids_batch()})
        assert not st._dev and not st._pending_uploads


@pytest.mark.parametrize("case", ["windows", "fp16", "optimizer",
                                  "no-optimizer-offload"])
def test_refusals_equal_jax(case):
    over, cfg = {}, engine_cfg(zero=infinity_zero())
    if case == "windows":
        over = dict(attention_layers=("global", "local", "global"),
                    local_attention_window=8)
    elif case == "fp16":
        del cfg["bf16"]
        cfg["fp16"] = {"enabled": True}
    elif case == "optimizer":
        cfg["optimizer"] = {"type": "SGD", "params": {"lr": 0.1}}
    else:
        cfg["zero_optimization"] = {"stage": 3,
                                    "offload_param": {"device": "cpu"}}
    with pytest.raises(Exception) as je:
        jax_infinity(cfg, over)
    with pytest.raises(Exception) as pe:
        port_engine(cfg, None, over)
    assert type(pe.value) is type(je.value)
    assert str(pe.value) == str(je.value)


def test_offload_gauges_and_spans(tmp_path):
    """With metrics on, the host bytes of the stores go to the registry
    (``dstpu_offload_host_bytes``) and the wire's bytes to its counters."""
    from deepspeed_tpu_torch.observability import get_registry
    cfg = dict(engine_cfg(zero=infinity_zero()), observability={
        "metrics": {"enabled": True, "json_path": str(tmp_path / "m.json")}})
    pi = port_engine(cfg, None)
    pi.train_step({"input_ids": ids_batch()})
    reg = get_registry()
    st = pi._infinity
    assert reg.gauge("dstpu_offload_host_bytes").value == \
        st.param_store.host_bytes + st.opt.host_bytes
    assert reg.counter("dstpu_offload_h2d_bytes_total").value >= \
        st.L * st.n_pad * 2
    assert reg.counter("dstpu_offload_d2h_bytes_total").value >= \
        st.L * st.n_pad * 2
    assert set(st.timing) >= {"walk_s", "join_s", "sweep_s", "h2d_bytes"}
