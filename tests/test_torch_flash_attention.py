"""The port's flash attention (kernels B1, B2, B3 and B4 behind one
autograd function) against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain versions (the tensors lie
on the CPU); the JAX kernels run in interpret mode, as
``tests/unit/test_flash_attention.py`` runs them.  Inputs are made with
numpy from a seed and handed to both, in float32.  The CUDA kernels
themselves are held against these plain versions on the card by
``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.transformer import flash_attention as JFA
from deepspeed_tpu_torch.ops.transformer import flash_attention as FA

#: forward: same f32 math; only the summation order differs
FWD_TOL = dict(atol=1e-5, rtol=1e-5)
#: gradients: ds = p * (dP - delta) subtracts two nearly equal f32 sums,
#: and dq/dk then sum T such terms, so the rounding of the summation
#: order is amplified relative to the result (observed up to ~2e-6)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


def qkvdo(bh, t, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((bh, t, d)).astype(np.float32)
            for _ in range(4)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [64, 100, 128])
@pytest.mark.parametrize("d", [16, 64])
def test_forward_and_vjp_match_jax(causal, t, d):
    """o and lse of the forward, and dq/dk/dv through ``jax.vjp``
    against the port's autograd, B*H = 3; T = 100 is ragged against
    every tile of the port's kernel."""
    q, k, v, do = qkvdo(3, t, d, seed=t + d + causal)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    o_j, res = JFA._fa_fwd(jq, jk, jv, causal, None, 1024, 1024, True)
    lse_j = np.asarray(res[4])[:, 0, :]

    def f(a, b, c):
        return JFA.flash_attention(a, b, c, causal, None, 1024, 1024, True)
    _, vjp = jax.vjp(f, jq, jk, jv)
    grads_j = [np.asarray(g) for g in vjp(jnp.asarray(do))]

    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    o_t = FA.flash_attention(tq, tk, tv, causal)
    _, lse_t = FA.flash_attention_fwd(tq.detach(), tk.detach(),
                                      tv.detach(), causal)
    o_t.backward(torch.from_numpy(do))
    np.testing.assert_allclose(o_t.detach().numpy(), np.asarray(o_j),
                               **FWD_TOL)
    np.testing.assert_allclose(lse_t.numpy(), lse_j, **FWD_TOL)
    for got, want in zip((tq.grad, tk.grad, tv.grad), grads_j):
        np.testing.assert_allclose(got.numpy(), want, **GRAD_TOL)


def test_bthd_layout_matches_jax():
    """The model-layout adapter ``[B, T, H, D]`` on both sides."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, 40, 3, 16)).astype(np.float32)
               for _ in range(3))
    want = JFA.flash_attention_bthd(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), interpret=True)
    got = FA.flash_attention_bthd(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


def jax_fwd_and_vjp(q, k, v, do, causal, blocks):
    """The JAX kernels' (o, [dq, dk, dv]) in interpret mode."""
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))

    def f(a, b, c):
        return JFA.flash_attention(a, b, c, causal, None, *blocks, True)
    o, vjp = jax.vjp(f, jq, jk, jv)
    return np.asarray(o), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def port_fwd_and_grads(q, k, v, do, causal, blocks):
    """The port's (o, [dq, dk, dv]) through ``flash_attention``'s
    autograd (B1, then B2 or B3 + B4: their plain versions on the CPU)."""
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    o = FA.flash_attention(tq, tk, tv, causal, None, *blocks)
    o.backward(torch.from_numpy(do))
    return o.detach().numpy(), [t.grad.numpy() for t in (tq, tk, tv)]


def qkv_grouped(bkv, g, t, d, seed):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((bkv * g, t, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((bkv, t, d)).astype(np.float32)
            for _ in range(2))
    return q, k, v, do


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t,blocks", [(40, (16, 16)), (64, (1024, 1024))])
@pytest.mark.parametrize("g", [1, 2, 4])
def test_gqa_forward_and_vjp_match_jax(g, t, blocks, causal):
    """o and the three gradients against JAX's VJP for query groups of
    1, 2 and 4 heads per kv head (k/v at kv-head width on both sides):
    T 40 in 16-row blocks is ragged and multi-block (JAX's and the
    port's two-pass backward, B3 + B4); T 64 in one block takes the
    fused B2 for g = 1 and B3 + B4 otherwise, by the JAX rule."""
    q, k, v, do = qkv_grouped(2, g, t, 16, seed=7 * g + t + causal)
    assert FA.check_dispatch(q.shape, k.shape, *blocks) == (
        g == 1 and blocks == (1024, 1024))
    o_j, grads_j = jax_fwd_and_vjp(q, k, v, do, causal, blocks)
    o_t, grads_t = port_fwd_and_grads(q, k, v, do, causal, blocks)
    np.testing.assert_allclose(o_t, o_j, **FWD_TOL)
    for got, want in zip(grads_t, grads_j):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **GRAD_TOL)


@pytest.mark.parametrize("case", ["gqa", "t_past_block", "small_blocks"])
def test_two_pass_cases_raise_naming_b3_b4(case):
    """The JAX dispatch rule sends GQA and multi-block sequences to the
    two-pass backward, B3 then B4: each such case dispatches there and
    matches JAX's kernels (forward and the three gradients); the fused
    B2 wrapper itself still refuses GQA, naming B3 and B4."""
    shape_q, shape_k, blocks = {
        "gqa": ((4, 64, 16), (2, 64, 16), (1024, 1024)),
        "t_past_block": ((2, 1030, 16), (2, 1030, 16), (1024, 1024)),
        "small_blocks": ((2, 128, 16), (2, 128, 16), (64, 64)),
    }[case]
    q, k, v, do = qkv_grouped(shape_k[0], shape_q[0] // shape_k[0],
                              shape_q[1], shape_q[2], seed=len(case))
    assert FA.check_dispatch(q.shape, k.shape, *blocks) is False
    o_j, grads_j = jax_fwd_and_vjp(q, k, v, do, True, blocks)
    o_t, grads_t = port_fwd_and_grads(q, k, v, do, True, blocks)
    np.testing.assert_allclose(o_t, o_j, **FWD_TOL)
    for got, want in zip(grads_t, grads_j):
        np.testing.assert_allclose(got, want, **GRAD_TOL)
    if case == "gqa":
        tq, tk = torch.from_numpy(q), torch.from_numpy(k)
        lse = torch.zeros(shape_q[:2])
        with pytest.raises(ValueError, match="B3.*B4"):
            FA.flash_attention_bwd(tq, tk, tk.clone(), tq, lse, tq, True)


def test_dispatch_rule_is_jax_rule():
    """B2 exactly when the sequence fits one block and there is one kv
    head per query head; only Tq != Tk raises."""
    assert FA.check_dispatch((8, 1024, 64), (8, 1024, 64))
    assert not FA.check_dispatch((8, 1025, 64), (8, 1025, 64))
    assert not FA.check_dispatch((8, 64, 64), (2, 64, 64))
    assert not FA.check_dispatch((8, 128, 64), (8, 128, 64), 64, 64)
    with pytest.raises(ValueError, match="divisible"):
        FA.check_dispatch((6, 64, 64), (4, 64, 64))
    with pytest.raises(NotImplementedError, match="key length"):
        FA.check_dispatch((4, 64, 64), (4, 65, 64))


def test_plain_versions_keep_the_rounding_points():
    """In bf16 the plain forward rounds the unnormalised probabilities
    exp(s - m) to bf16 before P.V and divides by their f32 sum after, as
    the TPU kernel does: the result equals that computation bit for bit
    and differs from rounding nothing."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 32, 16))
                                .astype(np.float32)).to(torch.bfloat16)
               for _ in range(3))
    o, lse = FA.flash_attention_fwd_plain(q, k, v, True)
    s = (q.float() @ k.float().transpose(1, 2)) / 4.0
    s = s.masked_fill(~torch.ones(32, 32, dtype=torch.bool).tril(),
                      float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    want = ((p.to(torch.bfloat16).float() @ v.float()) / l).to(
        torch.bfloat16)
    unrounded = ((p @ v.float()) / l).to(torch.bfloat16)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert torch.equal(o, want)
    assert not torch.equal(o, unrounded)
    torch.testing.assert_close(lse, (m + torch.log(l))[..., 0], atol=0,
                               rtol=0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("g", [1, 3])
@pytest.mark.parametrize("d", [80, 96])
def test_head_dims_of_the_reference_match_jax(d, g, causal):
    """The head dims of GPT-3 2.7B (80) and 760M (96), with kv groups of 1
    and 3, T 70 in one block (B2 at g 1, B3 + B4 at g 3): o and the three
    gradients against JAX's VJP of its interpreted kernels."""
    q, k, v, do = qkv_grouped(2, g, 70, d, seed=d + g + causal)
    o_j, grads_j = jax_fwd_and_vjp(q, k, v, do, causal, (1024, 1024))
    o_t, grads_t = port_fwd_and_grads(q, k, v, do, causal, (1024, 1024))
    np.testing.assert_allclose(o_t, o_j, **FWD_TOL)
    for got, want in zip(grads_t, grads_j):
        np.testing.assert_allclose(got, want, **GRAD_TOL)
