"""fp16 training in the port against the JAX package's, and the kernels'
shape gate.

* ``DynamicLossScaler`` (``runtime/fp16/loss_scaler.py``) against the JAX
  one over scripted overflow sequences: the same scale, good_steps and
  hysteresis after every step (exact: both hold f32 scales that are
  powers of the factor, and int32 counters).
* A tiny GPT-2 (2 layers, d_model 64, 4 heads, vocab 128, T 32, as
  ``tests/unit/test_engine.py``'s ``tiny_model``) in float16 with
  ``fp16.enabled``, from the JAX engine's initial params: 3 steps give
  the same losses (rtol 1e-5: both compute in f16 with f32 sums, and the
  loss is an f32 mean of f32 NLLs), grad norms (rtol 1e-3: the f16
  backward rounds at a few points in another order) and loss scales
  (exact); an inf-poisoned step is skipped with the scale halved, as
  ``tests/unit/test_engine.py::TestMixedPrecision`` pins for JAX.
* The float16 plain versions of B1-B4 against the JAX kernels in
  interpret mode, in float16.
* A tiny block-sparse GPT-2 in fp16 (B8-B10's f16 plain versions)
  against the JAX engine over 3 steps, at the same limits.
* ``build.kernel_supports`` admits every configuration the repo names in
  bf16 and f16 alike (float16 takes exactly the shapes bfloat16 takes),
  and the model's ``_paged_supported`` never admits what B5-B7 refuse.
* ``build.build()`` compiles every source to objects (a source of
  ``build.PARTS`` as parallel parts) and links them (with a stand-in
  compiler: this host has none); ``build.build_in_background()``
  compiles on a thread of its own while ``load_library`` waits for a
  library still compiling, each compiled once.
"""
import dataclasses
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dt
from deepspeed_tpu.models import transformer as jax_tf
from deepspeed_tpu.ops.transformer import flash_attention as JFA
from deepspeed_tpu.parallel.topology import build_mesh
from deepspeed_tpu.runtime.config import MeshConfig
from deepspeed_tpu.runtime.fp16 import loss_scaler as JLS
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.convert import (params_from_jax,
                                                state_from_jax,
                                                state_to_jax)
from deepspeed_tpu_torch.module_inject import policies
from deepspeed_tpu_torch.ops import build
from deepspeed_tpu_torch.ops.transformer import flash_attention as FA
from deepspeed_tpu_torch.runtime.fp16 import loss_scaler as PLS
from deepspeed_tpu_torch.runtime.optimizers import tree_leaves

TINY = dict(num_layers=2, d_model=64, num_heads=4, vocab_size=128,
            max_seq_len=32)
CONFIG = {"train_batch_size": 16, "train_micro_batch_size_per_gpu": 2,
          "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
          "gradient_clipping": 1.0, "steps_per_print": 0}
LOSS_TOL = dict(rtol=1e-5, atol=0)
NORM_TOL = dict(rtol=1e-3, atol=0)


# -- the scaler ------------------------------------------------------------------
#: overflow sequences: a run that grows the scale past its window, an
#: overflow the hysteresis absorbs, a pair that halves it, overflows that
#: reach min_scale, and a fall right after a growth
SEQUENCES = [
    [0, 0, 0, 0, 0, 0, 0],
    [0, 1, 0, 0, 1, 1, 0, 0, 0, 0],
    [1, 1, 1, 1, 1, 1, 1, 1],
    [0, 0, 0, 1, 0, 1, 1, 0, 0, 0, 1, 1, 1],
]
SCALERS = [dict(initial_scale_power=4, scale_window=3, min_scale=1.0,
                hysteresis=2),
           dict(initial_scale_power=2, scale_window=2, min_scale=2.0,
                hysteresis=1),
           dict(initial_scale_power=16, scale_window=1000, min_scale=1.0,
                hysteresis=2, scale_factor=4.0)]


def _state(s):
    return (float(np.asarray(s.scale)), int(np.asarray(s.good_steps)),
            int(np.asarray(s.hysteresis)))


@pytest.mark.parametrize("kw", SCALERS)
@pytest.mark.parametrize("seq", SEQUENCES)
def test_dynamic_loss_scaler_matches_jax(seq, kw):
    """The same (scale, good_steps, hysteresis) as JAX's scaler after
    every step of a scripted overflow sequence."""
    js, ps = JLS.DynamicLossScaler(**kw), PLS.DynamicLossScaler(**kw)
    jst, pst = js.init(), ps.init()
    assert _state(pst) == _state(jst)
    for ov in seq:
        jst = js.update(jst, jnp.asarray(bool(ov)))
        pst = ps.update(pst, torch.tensor(bool(ov)))
        assert _state(pst) == _state(jst), (seq, kw)


def test_static_loss_scaler_matches_jax():
    """A static scale never moves and never detects overflow."""
    js, ps = JLS.static_loss_scaler(128.0), PLS.static_loss_scaler(128.0)
    assert ps.detect_overflow is js.detect_overflow is False
    jst, pst = js.init(), ps.init()
    for ov in (1, 0, 1, 1, 0):
        jst = js.update(jst, jnp.asarray(bool(ov)))
        pst = ps.update(pst, torch.tensor(bool(ov)))
        assert _state(pst) == _state(jst) and _state(pst)[0] == 128.0


@pytest.mark.parametrize("bad", [None, float("inf"), float("nan")])
def test_overflow_check_matches_jax(bad):
    rng = np.random.default_rng(0)
    grads = [rng.standard_normal((4, 3)).astype(np.float32),
             rng.standard_normal((5,)).astype(np.float32)]
    if bad is not None:
        grads[1][2] = bad
    want = bool(JLS.DynamicLossScaler.has_overflow(
        [jnp.asarray(g) for g in grads]))
    got = bool(PLS.DynamicLossScaler.has_overflow(
        [torch.from_numpy(g) for g in grads]))
    assert got == want == (bad is not None)


# -- the engine ------------------------------------------------------------------
def jax_engine(config):
    jm = jax_tf.TransformerLM(jax_tf.gpt2_config("125m", dtype=jnp.float16,
                                                 **TINY))
    mesh = build_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    eng, _, _, _ = ds.initialize(model=jm, config=json.loads(
        json.dumps(config)), mesh=mesh)
    return eng


def port_engine(config, params, **model_kw):
    pm = tt.TransformerLM(tt.gpt2_config("125m", dtype=torch.float32,
                                         **TINY, **model_kw))
    eng, _, _, _ = dt.initialize(model=pm, config=json.loads(
        json.dumps(config)), params=params_from_jax(params, pm),
        device="cpu")
    return eng


def batches(n, seed=0):
    rs = np.random.RandomState(seed)
    return [{"input_ids": rs.randint(0, 128, (16, 32)).astype(np.int32)}
            for _ in range(n)]


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_fp16_three_steps_match_jax(attn_impl):
    """fp16 with a dynamic scale (2^8): the model trains in float16 (the
    engine rebuilds it so), and the losses, grad norms and loss scales of
    3 steps match the JAX engine's from the same params."""
    cfg = {**CONFIG, "fp16": {"enabled": True, "initial_scale_power": 8}}
    je = jax_engine(cfg) if attn_impl == "xla" else None
    if je is None:
        jm = jax_tf.TransformerLM(jax_tf.gpt2_config(
            "125m", dtype=jnp.float16, attn_impl="flash", **TINY))
        mesh = build_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
        je, _, _, _ = ds.initialize(model=jm, config=json.loads(
            json.dumps(cfg)), mesh=mesh)
    init = jax.device_get(je.state)
    pe = port_engine(cfg, init["params"], attn_impl=attn_impl)
    assert pe.model.config.dtype == torch.float16
    assert pe.loss_scale == 2.0 ** 8
    for b in batches(3):
        jm = {k: float(v) for k, v in je.train_step(b).items()}
        pm = {k: float(v) for k, v in pe.train_step(b).items()}
        np.testing.assert_allclose(pm["loss"], jm["loss"], **LOSS_TOL)
        np.testing.assert_allclose(pm["grad_norm"], jm["grad_norm"],
                                   **NORM_TOL)
        assert pm["loss_scale"] == jm["loss_scale"] == 2.0 ** 8
        assert pm["overflow"] == jm["overflow"] == 0
    assert pe.loss_scale == je.loss_scale
    assert int(pe.state["step"]) == int(je.state["step"]) == 3


def test_fp16_overflow_skips_step_like_jax():
    """An inf in one embedding entry makes the gradients overflow: the step
    is skipped (``step`` held, ``skipped`` counted, params and moments
    kept) and, with hysteresis 1, the scale halves (2^4 to 2^3), as the
    JAX engine does."""
    cfg = {**CONFIG, "fp16": {"enabled": True, "initial_scale_power": 4,
                              "hysteresis": 1}}
    je = jax_engine(cfg)
    init = jax.device_get(je.state)
    pe = port_engine(cfg, init["params"])
    je.state["params"]["embed"]["embedding"] = \
        je.state["params"]["embed"]["embedding"].at[0, 0].set(jnp.inf)
    pe.state["params"]["embed"]["embedding"][0, 0] = float("inf")
    before = [p.clone() for p in tree_leaves(pe.state["params"])]
    b = batches(1)[0]
    jm, pm = je.train_step(b), pe.train_step(b)
    assert int(pm["overflow"]) == int(jm["overflow"]) == 1
    assert int(pe.state["step"]) == int(je.state["step"]) == 0
    assert int(pe.state["skipped"]) == int(je.state["skipped"]) == 1
    assert pe.loss_scale == je.loss_scale == 2.0 ** 3
    assert int(pe.state["opt"]["step"]) == 0
    for a, b in zip(tree_leaves(pe.state["params"]), before):
        assert torch.equal(a, b)


def test_fp16_hysteresis_two_needs_two_overflows():
    """With hysteresis 2 the first overflow is skipped without a fall and
    the second halves the scale; a clean step after them leaves it."""
    cfg = {**CONFIG, "fp16": {"enabled": True, "initial_scale_power": 6,
                              "hysteresis": 2}}
    je = jax_engine(cfg)
    init = jax.device_get(je.state)
    pe = port_engine(cfg, init["params"])
    b = batches(1)[0]
    scales = []
    for poison in (True, True):
        pe.state["params"]["embed"]["embedding"][0, 0] = (
            float("inf") if poison else 0.0)
        pe.train_step(b)
        scales.append(pe.loss_scale)
    assert scales == [2.0 ** 6, 2.0 ** 5]
    assert int(pe.state["skipped"]) == 2 and int(pe.state["step"]) == 0


def test_fp16_static_scale_never_skips():
    """A static loss_scale never detects overflow (the reference's
    ``LossScaler``): the engine steps and the scale stays."""
    cfg = {**CONFIG, "fp16": {"enabled": True, "loss_scale": 64.0}}
    je = jax_engine(cfg)
    init = jax.device_get(je.state)
    pe = port_engine(cfg, init["params"])
    b = batches(1)[0]
    jm, pm = je.train_step(b), pe.train_step(b)
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               **LOSS_TOL)
    assert pe.loss_scale == je.loss_scale == 64.0
    assert int(pe.state["step"]) == 1


def test_fp16_state_crosses_the_bridge():
    """``state_from_jax`` / ``state_to_jax`` carry the loss scaler's state
    (scale, good_steps, hysteresis) with the params and moments, and a
    port engine resumed from a JAX fp16 state takes the JAX engine's next
    step."""
    cfg = {**CONFIG, "fp16": {"enabled": True, "initial_scale_power": 8,
                              "loss_scale_window": 2}}
    je = jax_engine(cfg)
    init = jax.device_get(je.state)
    for b in batches(2, seed=3):
        je.train_step(b)
    js = jax.device_get(je.state)
    pe = port_engine(cfg, init["params"])
    pe.state = state_from_jax(js, pe.model)
    back = state_to_jax(pe.state)
    assert [float(x) for x in back["scaler"]] == [
        float(np.asarray(x)) for x in js["scaler"]]
    assert pe.loss_scale == je.loss_scale == 2.0 ** 9   # grew after 2 steps
    b = batches(1, seed=9)[0]
    jm, pm = je.train_step(b), pe.train_step(b)
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               **LOSS_TOL)
    assert pe.loss_scale == je.loss_scale


# -- float16 B1-B4 plain versions ----------------------------------------------
#: float16 against float16: both sides round p and ds to f16 at the same
#: points and sum in f32, so the results differ by about one f16 ulp
F16_TOL = dict(atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("d", [64, 96])
def test_float16_flash_matches_jax(d, g):
    """The float16 B1 (o) and B2 / B3 + B4 (dq, dk, dv) plain versions
    against JAX's kernels in interpret mode on float16 inputs, T 48."""
    rng = np.random.default_rng(d + g)
    q, do = (rng.standard_normal((2 * g, 48, d)).astype(np.float16)
             for _ in range(2))
    k, v = (rng.standard_normal((2, 48, d)).astype(np.float16)
            for _ in range(2))

    def f(a, b, c):
        return JFA.flash_attention(a, b, c, True, None, 1024, 1024, True)
    o_j, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    grads_j = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    o_t = FA.flash_attention(tq, tk, tv, True)
    o_t.backward(torch.from_numpy(do))
    assert o_t.dtype == torch.float16
    np.testing.assert_allclose(o_t.detach().float().numpy(),
                               np.asarray(o_j, np.float32), **F16_TOL)
    for got, want in zip((tq.grad, tk.grad, tv.grad), grads_j):
        assert got.dtype == torch.float16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **F16_TOL)


# -- float16 serving and block-sparse training (C2 closed) --------------------
def test_float16_serving_and_blocksparse_build():
    """float16 serving (B5-B7) and a float16 block-sparse model (B8-B10)
    build: ``init_inference(dtype="float16")`` holds f16 weights, and the
    model's paged path is admitted at kv_bits 0, 8 and 4."""
    model = tt.TransformerLM(tt.gpt2_config("125m", dtype=torch.float32,
                                            **TINY))
    eng = dt.init_inference(model, {"dtype": "float16"}, device="cpu")
    assert eng.module.config.dtype == torch.float16
    assert all(p.dtype == torch.float16 for p in tree_leaves(eng.params))
    for kv_bits in (0, 8, 4):
        assert eng.module._paged_supported(kv_bits) is None
    from deepspeed_tpu_torch.ops.sparse_attention import (
        FixedSparsityConfig)
    sparse = tt.TransformerLM(tt.gpt2_config(
        "125m", dtype=torch.float16, attn_impl="blocksparse",
        sparsity_config=FixedSparsityConfig(num_heads=4, block=16),
        **TINY))
    assert sparse.config.dtype == torch.float16


def test_fp16_blocksparse_three_steps_match_jax():
    """A tiny block-sparse GPT-2 (T 64, a Fixed layout of 16-row blocks)
    trained in fp16 with dynamic loss scaling (the kernels' plain versions
    B8-B10 in float16 here, the JAX kernels in interpret mode): three
    steps from the JAX engine's params give its losses (1e-5), grad norms
    (1e-3) and loss scales (exact)."""
    from deepspeed_tpu.ops import sparse_attention as jax_sa
    from deepspeed_tpu_torch.ops import sparse_attention as port_sa
    skw = dict(num_heads=4, block=16, num_local_blocks=2,
               num_global_blocks=1)
    cfg = {**CONFIG, "fp16": {"enabled": True, "initial_scale_power": 8}}
    jm = jax_tf.TransformerLM(jax_tf.gpt2_config(
        "125m", dtype=jnp.float16, attn_impl="blocksparse",
        sparsity_config=jax_sa.FixedSparsityConfig(**skw),
        **{**TINY, "max_seq_len": 64}))
    mesh = build_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    je, _, _, _ = ds.initialize(model=jm, config=json.loads(
        json.dumps(cfg)), mesh=mesh)
    init = jax.device_get(je.state)
    pm = tt.TransformerLM(tt.gpt2_config(
        "125m", dtype=torch.float32, attn_impl="blocksparse",
        sparsity_config=port_sa.FixedSparsityConfig(**skw),
        **{**TINY, "max_seq_len": 64}))
    pe, _, _, _ = dt.initialize(model=pm, config=json.loads(
        json.dumps(cfg)), params=params_from_jax(init["params"], pm),
        device="cpu")
    assert pe.model.config.dtype == torch.float16
    rs = np.random.RandomState(12)
    for _ in range(3):
        b = {"input_ids": rs.randint(0, 128, (16, 64)).astype(np.int32)}
        jmet = {k: float(v) for k, v in je.train_step(b).items()}
        pmet = {k: float(v) for k, v in pe.train_step(b).items()}
        np.testing.assert_allclose(pmet["loss"], jmet["loss"], **LOSS_TOL)
        np.testing.assert_allclose(pmet["grad_norm"], jmet["grad_norm"],
                                   **NORM_TOL)
        assert pmet["loss_scale"] == jmet["loss_scale"]
        assert pmet["overflow"] == jmet["overflow"]


# -- the kernels' shape gate ---------------------------------------------------
#: head dims and kv groups of published models the reference's policies
#: load (``deepspeed_tpu/module_inject/policies.py``): GPT-J 6B (4096 over
#: 16 heads), GPT-NeoX-20B (6144 over 64), BLOOM-176B (14336 over 112),
#: OPT-30B (7168 over 56), LLaMA-2-70B (8192 over 64, 8 kv heads)
PUBLISHED = {"gpt-j-6b": (256, 1), "gpt-neox-20b": (96, 1),
             "bloom-176b": (128, 1), "opt-30b": (128, 1),
             "llama-2-70b": (128, 8)}


def repo_configs():
    out = {f"gpt2-{k}": tt.gpt2_config(k) for k in tt.GPT2_SIZES}
    out["tinyllama-1.1b"] = policies.hf_llama_config(
        policies.TINYLLAMA_1_1B)
    return out


@pytest.mark.parametrize("name", sorted(repo_configs()))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_gate_admits_every_config_of_the_repo(name, dtype):
    """Every GPT-2/GPT-3 size and TinyLlama-1.1B: every kernel (the flash
    B1-B4, the decode B5-B7 at kv_bits 0, 8 and 4, the block-sparse
    B8-B10) takes its head dim and kv group in bf16 and in f16 alike, and
    its paged path is admitted at kv_bits 0, 8 and 4 in both."""
    c = repo_configs()[name]
    g = c.num_heads // c.kv_heads
    for k in build.FLASH_KERNELS:
        assert build.kernel_supports(
            k, c.hdim, 1 if k == "flash_attention_bwd" else g, dtype) is None
    for k in build.SPARSE_KERNELS + build.DECODE_KERNELS:
        for kv_bits in ((0, 8, 4) if k in build.QUANT_KERNELS else (0,)):
            assert build.kernel_supports(k, c.hdim, g, dtype,
                                         kv_bits) is None
    model = tt.TransformerLM(dataclasses.replace(c, dtype=dtype))
    for kv_bits in (0, 8, 4):
        assert model._paged_supported(kv_bits) is None


def test_f16_takes_every_shape_bf16_takes():
    """C2 closed: ``kernel_supports`` gives float16 exactly bfloat16's
    answer for every B5-B10 library at every head dim up to 264, kv group
    (1, 3, 8, 32), kv_bits and layout block tried."""
    for k in build.SPARSE_KERNELS + build.DECODE_KERNELS:
        for d in range(8, 265, 8):
            for g in (1, 3, 8, 32):
                for kv_bits in (0, 8, 4, 2):
                    for block in ((None, 16, 48, 40) if k in
                                  build.SPARSE_KERNELS else (None,)):
                        bf = build.kernel_supports(k, d, g, torch.bfloat16,
                                                   kv_bits, block)
                        f16 = build.kernel_supports(k, d, g, torch.float16,
                                                    kv_bits, block)
                        assert (bf is None) == (f16 is None), (k, d, g)
    assert not hasattr(build, "C2")


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_gate_admits_published_head_dims(name):
    d, g = PUBLISHED[name]
    for k in build.FLASH_KERNELS + build.SPARSE_KERNELS + build.DECODE_KERNELS:
        for kv_bits in ((0, 8, 4) if k in build.DECODE_KERNELS[1:] else (0,)):
            assert build.kernel_supports(
                k, d, 1 if k == "flash_attention_bwd" else g,
                torch.bfloat16, kv_bits) is None, (k, kv_bits)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_bits", [0, 8, 4])
def test_paged_supported_never_admits_what_the_kernels_refuse(dtype,
                                                              kv_bits):
    """Over head dims 8-264 and groups 1-32: wherever the model's
    ``_paged_supported`` admits a config, the B5, B6 and B7 gates admit
    its head dim and group too (so a server cannot build at a shape its
    kernels refuse), and it refuses head dims the reference refuses."""
    for hd in range(8, 272, 8):
        for g in (1, 2, 3, 4, 8, 16, 32):
            c = tt.gpt2_config("125m", num_heads=g, d_model=g * hd,
                               num_layers=1, dtype=dtype)
            if g > 1:
                c = tt.TransformerConfig(**{
                    **{f: getattr(c, f) for f in
                       c.__dataclass_fields__}, "num_kv_heads": 1})
            model = tt.TransformerLM(c)
            why = model._paged_supported(kv_bits)
            gates = [build.kernel_supports(
                k, hd, c.num_heads // c.kv_heads, dtype,
                0 if k == "decode_attention" else kv_bits)
                for k in build.DECODE_KERNELS]
            if why is None:
                assert gates == [None] * 3, (hd, g, gates)
            else:
                assert any(gates) or hd > 256, (hd, g, why)
            if dtype == torch.bfloat16 and hd <= 256:
                assert why is None, (hd, g, why)


def test_gate_refuses_with_c1_remainder():
    """What stays refused: flash head dims that are not a multiple of 16,
    and any head dim past 256, named as C1's remainder; block-sparse
    blocks that are not a multiple of 16."""
    for d in (24, 72, 272):
        assert "C1" in build.kernel_supports("flash_attention_fwd", d)
    assert build.kernel_supports("blocksparse_flash_fwd", 64,
                                 block=24) is not None
    assert build.kernel_supports("blocksparse_flash_fwd", 64,
                                 block=48) is None
    assert build.kernel_supports("paged_decode_attention", 264) is not None


# -- the build of a source in parts ----------------------------------------------
def test_build_compiles_parts_and_links_them(tmp_path, monkeypatch):
    """``build.build()`` with a stand-in ``nvcc`` (this host has none):
    every source is compiled to objects with ``-c`` and without
    ``-shared`` (a source listed in ``PARTS`` as that many, each with
    ``-DDSTT_PART=p``), then its objects are linked into its library,
    their reports joined into ``<library>.log``."""
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    calls = tmp_path / "calls.txt"
    fake.write_text(
        "#!/usr/bin/env python3\n"
        "import sys\n"
        "a = sys.argv[1:]\n"
        f"open({str(calls)!r}, 'a').write(' '.join(a) + '\\n')\n"
        "print('report', ' '.join(x for x in a if x.startswith('-D')))\n"
        "open(a[a.index('-o') + 1], 'w').write('built')\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", f"{fake.parent}:{os.environ['PATH']}")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    libs = build.build(["paged_decode_attention", "decode_attention"])
    lines = calls.read_text().splitlines()
    parts = [ln for ln in lines if "-DDSTT_PART=" in ln]
    assert len(parts) == build.PARTS["paged_decode_attention"] == 3
    assert all(" -c " in ln and "-shared" not in ln for ln in parts)
    whole = [ln for ln in lines if ln.endswith("decode_attention.cu")
             and "paged" not in ln]
    assert len(whole) == 1 and " -c " in whole[0]
    assert "-shared" not in whole[0] and "-DDSTT_PART" not in whole[0]
    link = [ln for ln in lines if " -c " not in ln]
    assert len(link) == 2 and all("-shared" in ln for ln in link)
    assert sorted(ln.count(".part") for ln in link) == [1, 3]
    log = (libs["paged_decode_attention"].parent /
           f"{libs['paged_decode_attention'].name}.log").read_text()
    assert [f"-DDSTT_PART={p}" in log for p in range(3)] == [True] * 3
    assert log.count("nvcc wall time") == 3
    log = (libs["decode_attention"].parent /
           f"{libs['decode_attention'].name}.log").read_text()
    assert log.count("nvcc wall time") == 1
    for lib in libs.values():
        assert lib.read_text() == "built"
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == sorted(
        [lib.name for lib in libs.values()]
        + [f"{lib.name}.log" for lib in libs.values()])


def test_background_build_and_waiting_load(tmp_path, monkeypatch):
    """``build.build_in_background()`` with a stand-in ``nvcc`` that takes
    half a second a source: ``load_library`` of a library still
    compiling waits until it is linked (never compiles it again), each
    library is reported to ``on_built`` once, and the thread's result
    holds the libraries and the build's seconds."""
    import time
    from deepspeed_tpu_torch.ops import build
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    calls = tmp_path / "calls.txt"
    fake.write_text(
        "#!/usr/bin/env python3\n"
        "import sys, time\n"
        "a = sys.argv[1:]\n"
        "time.sleep(0.5 if '-c' in a else 0.0)\n"
        f"open({str(calls)!r}, 'a').write(' '.join(a) + '\\n')\n"
        "open(a[a.index('-o') + 1], 'w').write('built')\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", f"{fake.parent}:{os.environ['PATH']}")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: ("loaded", path))
    names = ["decode_attention", "flash_attention_fwd"]
    seen = []
    thread = build.build_in_background(
        names, on_built=lambda name, path: seen.append((name, path)))
    assert set(build._pending) == set(names)    # registered before return
    t0 = time.perf_counter()
    kind, path = build.load_library("flash_attention_fwd")
    waited = time.perf_counter() - t0
    assert kind == "loaded" and path == str(
        build.library_path("flash_attention_fwd"))
    assert waited >= 0.3 and Path(path).read_text() == "built"
    thread.join(timeout=60)
    assert not thread.is_alive() and "error" not in thread.result
    assert thread.result["libs"] == {n: build.library_path(n) for n in names}
    assert thread.result["seconds"] >= 0.5
    assert sorted(seen) == sorted((n, build.library_path(n)) for n in names)
    compiles = [ln for ln in calls.read_text().splitlines() if " -c " in ln]
    assert len(compiles) == 2 and build._pending == {}
    assert build._running == set()
