"""The port's native host optimizer (``csrc/cpu_adam.cpp`` built by g++,
``ops/adam/cpu_adam.py``) against the JAX package's native library and
against its own plain PyTorch version.

Both packages compile the same source with the same flags, so after 3
steps the masters, the moments and the bf16 emission are equal bit for
bit (float32 and bf16-bit gradients, AdamW and Adam, Adagrad).  The plain
version (``impl="plain"``, torch on CPU tensors) is held within 1e-6 of
the native one (powf and the reciprocal of the scale round differently).
A failed build raises: nothing falls back to numpy or to the plain
version.
"""
import numpy as np
import pytest

from deepspeed_tpu.ops.adam import cpu_adam as jca
from deepspeed_tpu_torch.ops import build
from deepspeed_tpu_torch.ops.adam import cpu_adam as pca
from deepspeed_tpu_torch.runtime.swap_tensor.partitioned_optimizer_swapper \
    import SlotOptimizer

PLAIN_TOL = 1e-6
SHAPES = [(1000,), (30, 7), (5, 4, 3)]


def leaves(seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randn(*s).astype(np.float32) for s in SHAPES]


def grads(step, g16=False):
    rs = np.random.RandomState(100 + step)
    gs = [rs.randn(*s).astype(np.float32) for s in SHAPES]
    return [pca.bf16_bits(g) for g in gs] if g16 else gs


def jax_step(lib, opt, gs, lr, scale, outs):
    """One JAX-library step over every leaf (its class takes f32 grads;
    bf16 grads go through the C symbol directly)."""
    opt.step_count += 1
    b1, b2 = opt.betas
    for i, g in enumerate(gs):
        p, m, v = opt.master[i], opt.m[i], opt.v[i]
        if g.dtype == np.uint16:
            lib.ds_adam_step_g16(
                p.size, jca._ptr(p, jca._C_F32), jca._ptr(m, jca._C_F32),
                jca._ptr(v, jca._C_F32), jca._ptr(g, jca._C_U16), lr, b1,
                b2, opt.eps, opt.weight_decay, opt.step_count, scale,
                int(opt.adamw_mode), jca._ptr(outs[i], jca._C_U16))
        else:
            opt.step_one(i, g, lr=lr, grad_scale=scale, out_bf16=outs[i])


@pytest.mark.parametrize("g16", [False, True], ids=["f32-grads", "bf16-grads"])
@pytest.mark.parametrize("adamw,wd", [(True, 0.1), (False, 0.01),
                                      (True, 0.0)])
def test_native_adam_bit_equal_to_jax_native(adamw, wd, g16):
    jo = jca.DeepSpeedCPUAdam(leaves(), lr=1e-2, weight_decay=wd,
                              adamw_mode=adamw)
    assert jo._lib is not None
    po = pca.DeepSpeedCPUAdam(leaves(), lr=1e-2, weight_decay=wd,
                              adamw_mode=adamw)
    pl = pca.DeepSpeedCPUAdam(leaves(), lr=1e-2, weight_decay=wd,
                              adamw_mode=adamw, impl="plain")
    for step in range(3):
        gs = grads(step, g16)
        jout = [np.empty(s, np.uint16) for s in SHAPES]
        pout = [np.empty(s, np.uint16) for s in SHAPES]
        lout = [np.empty(s, np.uint16) for s in SHAPES]
        jax_step(jo._lib, jo, gs, 1e-2, 2.0, jout)
        po.step(gs, lr=1e-2, grad_scale=2.0, out_bf16=pout)
        pl.step(gs, lr=1e-2, grad_scale=2.0, out_bf16=lout)
    for name in ("master", "m", "v"):
        for a, b, c in zip(getattr(jo, name), getattr(po, name),
                           getattr(pl, name)):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_allclose(c, b, atol=PLAIN_TOL, rtol=PLAIN_TOL)
    for a, b in zip(jout, pout):
        np.testing.assert_array_equal(a, b)
    # the plain emission rounds the plain masters; they match but for
    # a last-ulp tie
    assert sum(int((a != b).sum()) for a, b in zip(lout, pout)) <= 2


def test_native_adagrad_bit_equal_to_jax_native():
    jo = jca.DeepSpeedCPUAdagrad(leaves(), lr=1e-2, eps=1e-10,
                                 weight_decay=0.01)
    po = pca.DeepSpeedCPUAdagrad(leaves(), lr=1e-2, eps=1e-10,
                                 weight_decay=0.01)
    pl = pca.DeepSpeedCPUAdagrad(leaves(), lr=1e-2, eps=1e-10,
                                 weight_decay=0.01, impl="plain")
    for step in range(3):
        jout = [np.empty(s, np.uint16) for s in SHAPES]
        pout = [np.empty(s, np.uint16) for s in SHAPES]
        for o, out in ((jo, jout), (po, pout), (pl, None)):
            o.step(grads(step), lr=1e-2, grad_scale=3.0, out_bf16=out)
    for name in ("master", "sq"):
        for a, b, c in zip(getattr(jo, name), getattr(po, name),
                           getattr(pl, name)):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_allclose(c, b, atol=PLAIN_TOL, rtol=PLAIN_TOL)
    for a, b in zip(jout, pout):
        np.testing.assert_array_equal(a, b)


def test_native_f32_to_bf16_and_accum_equal_jax():
    """``ds_f32_to_bf16`` and ``ds_accum_g16`` give the JAX library's bits;
    the plain bf16 rounding (torch, to nearest even) gives them too."""
    jl, pl = jca._lib(), pca._lib()
    x = np.random.RandomState(3).randn(4099).astype(np.float32) * 1e3
    a, b = np.empty(x.size, np.uint16), np.empty(x.size, np.uint16)
    jl.ds_f32_to_bf16(x.size, jca._ptr(x, jca._C_F32), jca._ptr(a, jca._C_U16))
    pl.ds_f32_to_bf16(x.size, pca._ptr(x, pca._C_F32), pca._ptr(b, pca._C_U16))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pca.bf16_bits(x), b)
    acc_j, acc_p, acc_plain = (np.ones(x.size, np.float32) for _ in range(3))
    jl.ds_accum_g16(x.size, jca._ptr(acc_j, jca._C_F32),
                    jca._ptr(a, jca._C_U16))
    pca.accum_bf16(acc_p, b, pl)
    pca.accum_bf16(acc_plain, b)
    np.testing.assert_array_equal(acc_j, acc_p)
    np.testing.assert_array_equal(acc_plain, acc_p)


@pytest.mark.parametrize("g16", [False, True], ids=["f32-grads", "bf16-grads"])
def test_slot_optimizer_equals_flat_adam(g16):
    """``SlotOptimizer`` (one slot a layer, the native sweep over the
    store's bytes) equals the flat-leaf Adam on the same vectors, and its
    plain version stays within 1e-6."""
    rs = np.random.RandomState(5)
    rows = [rs.randn(4096).astype(np.float32) for _ in range(3)]
    so = SlotOptimizer(3, 4096, lr=1e-3, weight_decay=0.1)
    sp = SlotOptimizer(3, 4096, lr=1e-3, weight_decay=0.1, impl="plain")
    flat = pca.DeepSpeedCPUAdam(rows, lr=1e-3, weight_decay=0.1)
    for i, r in enumerate(rows):
        so.init_slot(i, r)
        sp.init_slot(i, r)
    for step in range(3):
        gs = [rs.randn(4096).astype(np.float32) for _ in range(3)]
        if g16:
            gs = [pca.bf16_bits(g) for g in gs]
        so.begin_step()
        sp.begin_step()
        outs = [np.empty(4096, np.uint16) for _ in range(3)]
        fouts = [np.empty(4096, np.uint16) for _ in range(3)]
        for i, g in enumerate(gs):
            so.step_slot(i, g, lr=1e-3, grad_scale=2.0, out_bf16=outs[i])
            sp.step_slot(i, g, lr=1e-3, grad_scale=2.0)
        flat.step(gs, lr=1e-3, grad_scale=2.0, out_bf16=fouts)
        for a, b in zip(outs, fouts):
            np.testing.assert_array_equal(a, b)
    for i in range(3):
        for a, b, c in zip(so.state(i), (flat.master[i], flat.m[i],
                                         flat.v[i]), sp.state(i)):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_allclose(c, a, atol=PLAIN_TOL, rtol=PLAIN_TOL)


def test_span_steps_equal_whole_leaf():
    """A leaf stepped in spans (the pipelined sweep's pieces) equals the
    leaf stepped whole."""
    a = pca.DeepSpeedCPUAdam(leaves(), lr=1e-2)
    b = pca.DeepSpeedCPUAdam(leaves(), lr=1e-2)
    g = grads(0)
    a.step(g)
    b.step_count += 1
    for i, gi in enumerate(g):
        flat = gi.reshape(-1)
        for lo in range(0, flat.size, 64):
            hi = min(lo + 64, flat.size)
            b.step_one(i, flat[lo:hi], lr=1e-2, span=(lo, hi))
    for x, y in zip(a.master, b.master):
        np.testing.assert_array_equal(x, y)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source g++ refuses raises ``RuntimeError`` at first use; the
    optimizer never falls back."""
    (tmp_path / "cpu_adam.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_host_libs", {})
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for cpu_adam"):
        pca.DeepSpeedCPUAdam(leaves())
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        SlotOptimizer(2, 64)
    # the plain version was asked for: no library is needed
    assert pca.DeepSpeedCPUAdam(leaves(), impl="plain")._lib is None
    with pytest.raises(ValueError, match="impl"):
        pca.DeepSpeedCPUAdam(leaves(), impl="numpy")


def test_library_is_built_by_gxx_into_build_dir():
    path = build.host_library_path("cpu_adam")
    assert "cpu_adam" in build.HOST_LIBS and "aio" in build.HOST_LIBS
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("libcpu_adam-host-")
    assert build.load_host_library("cpu_adam") is pca._lib()
    assert path.exists()


def test_state_arrays_roundtrip():
    a = pca.DeepSpeedCPUAdam(leaves(), lr=1e-2)
    a.step(grads(0))
    b = pca.DeepSpeedCPUAdam(leaves(seed=9), lr=1e-2)
    b.load_state_arrays(a.state_arrays(), a.step_count)
    a.step(grads(1))
    b.step(grads(1))
    for x, y in zip(a.master, b.master):
        np.testing.assert_array_equal(x, y)
