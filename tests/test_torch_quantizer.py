"""The port's quantization codecs (``deepspeed_tpu_torch/ops/quantizer``)
against the JAX package's on the same numpy inputs.

Integer outputs must be bit-equal and f32 scales equal (NaN where JAX
gives NaN): both sides compute in f32 with round-half-to-even, the same
clamps, and a NaN value quantizing to 0.  The JAX functions run under
``jit``, as the JAX package runs them (inside its serving step and its
int8 engine's quantization pass), where XLA computes ``max / qmax`` as
``max * (1 / qmax)``; the port writes that product.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.quantizer import quantizer as _JQ
from deepspeed_tpu_torch.ops.quantizer import quantizer as Q


class JQ:
    """The JAX codecs as its programs run them: jitted, the bit widths,
    group counts and flags static."""
    kv_quantize = jax.jit(_JQ.kv_quantize, static_argnums=1)
    kv_dequantize = jax.jit(_JQ.kv_dequantize, static_argnums=(2, 3))
    pack_int4 = jax.jit(_JQ.pack_int4)
    unpack_int4 = jax.jit(_JQ.unpack_int4, static_argnums=1)
    quantize = jax.jit(_JQ.quantize, static_argnums=(1, 2, 3, 4))
    dequantize = staticmethod(_JQ.dequantize)     # no division to fold


def _t(a):
    return torch.from_numpy(np.array(a))


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert str(got.dtype).split(".")[-1] == want.dtype.name
    np.testing.assert_array_equal(got.numpy(), want)


def kv_rows(shape, seed):
    """Normal rows with a NaN row, an all-zero row, values on the .5
    rounding boundaries of their scale, and an int4 odd-signed mix."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) * 2.5
    x[0, 1] = np.nan
    x[1, 0] = 0.0
    x[2, 2] = np.linspace(-7.5, 7.5, shape[-1], dtype=np.float32)
    return x


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("d", [16, 64])
def test_kv_quantize_bit_equal_to_jax(bits, d):
    x = kv_rows((5, 4, 3, d), bits + d)
    q, s = Q.kv_quantize(_t(x), bits)
    jq, js = JQ.kv_quantize(jnp.asarray(x), bits)
    _same(q, jq)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))  # NaN == NaN
    assert q.shape[-1] == (d if bits == 8 else d // 2)
    assert np.isnan(s.numpy()[0, 1]).all()


@pytest.mark.parametrize("bits", [8, 4])
def test_kv_quantize_of_bf16_rows_equals_jax(bits):
    """The serving step quantizes bf16 activations: the same bf16 values
    give the same bytes and scales."""
    x = kv_rows((6, 3, 32), 3 + bits)
    xt = _t(x).to(torch.bfloat16)
    jx = jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16)
    q, s = Q.kv_quantize(xt, bits)
    jq, js = JQ.kv_quantize(jx, bits)
    _same(q, jq)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("bits", [8, 4])
def test_kv_dequantize_bit_equal_to_jax(bits):
    x = kv_rows((5, 4, 3, 32), 9 + bits)
    jq, js = JQ.kv_quantize(jnp.asarray(x), bits)
    q, s = _t(np.asarray(jq)), _t(np.asarray(js))
    got = Q.kv_dequantize(q, s, bits)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JQ.kv_dequantize(jq, js, bits)))
    assert got.shape == x.shape
    got16 = Q.kv_dequantize(q, s, bits, torch.bfloat16)
    assert got16.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got16.float().numpy(),
        np.asarray(JQ.kv_dequantize(jq, js, bits, jnp.bfloat16)
                   .astype(jnp.float32)))


def test_kv_int4_layout_is_split_by_feature():
    """Byte j holds feature j in its low nibble and feature j + D/2 in its
    high nibble, sign-extended on the way back (not pack_int4's pairs)."""
    ints = np.array([[-7, -1, 0, 7, 3, -5, 1, -2]], np.int32)
    x = ints.astype(np.float32) * 0.5            # scale 3.5 / 7 = 0.5
    q, s = Q.kv_quantize(_t(x), 4)
    lo, hi = ints[:, :4], ints[:, 4:]
    want = ((lo & 0xF) | ((hi & 0xF) << 4)).astype(np.uint8).view(np.int8)
    np.testing.assert_array_equal(q.numpy(), want)
    np.testing.assert_array_equal(s.numpy(), [0.5])
    np.testing.assert_array_equal(Q.kv_dequantize(q, s, 4).numpy(), x)
    assert not np.array_equal(q.numpy(), Q.pack_int4(_t(ints)).numpy())


@pytest.mark.parametrize("size", [1, 6, 7, 33])
def test_pack_unpack_int4_round_trip(size):
    rng = np.random.default_rng(size)
    v = rng.integers(-8, 8, (3, size)).astype(np.int8)
    packed = Q.pack_int4(_t(v))
    _same(packed, JQ.pack_int4(jnp.asarray(v)))
    assert packed.shape == (3, (size + 1) // 2)
    back = Q.unpack_int4(packed, size)
    _same(back, JQ.unpack_int4(jnp.asarray(packed.numpy()), size))
    np.testing.assert_array_equal(back.numpy(), v)


@pytest.mark.parametrize("bits,groups,symmetric,pack", [
    (8, 1, True, False), (8, 4, True, False), (4, 2, True, False),
    (4, 4, True, True), (8, 3, False, False), (4, 2, False, False)])
def test_quantize_dequantize_equal_jax(bits, groups, symmetric, pack):
    rng = np.random.default_rng(bits * groups)
    x = rng.standard_normal((6, 16)).astype(np.float32)
    x[0, 3] = 0.0
    q, s, z = Q.quantize(_t(x), bits, groups, symmetric, pack)
    jq, js, jz = JQ.quantize(jnp.asarray(x), bits, groups, symmetric, pack)
    _same(q, jq)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert (z is None) == (jz is None)
    if z is not None:
        np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
    back = Q.dequantize(q, s, z, x.shape, packed=pack)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(JQ.dequantize(jq, js, jz, x.shape,
                                               packed=pack)))
    # within half a quantization step of the input
    assert np.abs(back.numpy() - x).max() <= 0.5 * s.numpy().max() + 1e-6


def test_quantize_of_a_1d_leaf_and_bf16_dequant():
    """The int8 engine's per-layer bias and norm leaves: a 1-D leaf in
    groups, dequantized to bf16 as JAX's engine does."""
    x = np.random.default_rng(2).standard_normal(96).astype(np.float32)
    q, s, _ = Q.quantize(_t(x), 8, 3, True)
    jq, js, _ = JQ.quantize(jnp.asarray(x), 8, 3, True)
    _same(q, jq)
    got = Q.dequantize(q, s, None, (96,), torch.bfloat16)
    want = JQ.dequantize(jq, js, None, (96,), jnp.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("call,match", [
    (lambda: Q.kv_quantize(torch.zeros(2, 7), 4), "even head_dim"),
    (lambda: Q.kv_quantize(torch.zeros(2, 8), 3), "4 or 8"),
    (lambda: Q.kv_dequantize(torch.zeros(2, 8, dtype=torch.int8),
                             torch.zeros(2), 6), "4 or 8"),
    (lambda: Q.quantize(torch.zeros(4, 8), 8, 1, True, pack=True),
     "pack=True"),
    (lambda: Q.quantize(torch.zeros(4, 8), 4, 1, False, pack=True),
     "pack=True"),
])
def test_codec_errors_match_jax(call, match):
    with pytest.raises(ValueError, match=match):
        call()
