"""The port's flash attention (kernels B1 and B2 behind one autograd
function) against the JAX package's Pallas kernels.

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


@pytest.mark.parametrize("case", ["gqa", "t_past_block", "small_blocks"])
def test_two_pass_cases_raise_naming_b3_b4(case):
    """The JAX dispatch rule sends GQA and multi-block sequences to the
    two-pass backward (B3/B4), a later slice: the port raises, and so
    does the B2 wrapper itself at its 1024-row block."""
    rng = np.random.default_rng(0)
    shape_q, shape_k, blocks = {
        "gqa": ((4, 64, 16), (2, 64, 16), (1024, 1024)),
        "t_past_block": ((2, 1030, 16), (2, 1030, 16), (1024, 1024)),
        "small_blocks": ((2, 128, 16), (2, 128, 16), (64, 64)),
    }[case]
    q = torch.from_numpy(rng.standard_normal(shape_q).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal(shape_k).astype(np.float32))
    with pytest.raises(NotImplementedError, match="B3.*B4"):
        FA.flash_attention(q, k, k.clone(), True, None, *blocks)
    if blocks == (1024, 1024):
        lse = torch.zeros(shape_q[:2])
        with pytest.raises(NotImplementedError, match="B3.*B4"):
            FA.flash_attention_bwd(q, k, k.clone(), q, lse, q, True)


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
