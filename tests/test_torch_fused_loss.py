"""The port's fused loss head (``fused_linear_xent``) against the JAX
package's, on the same inputs.

Value, count and gradients in x, w and bias, for the tied ``[V, D]`` and
untied ``[D, V]`` (+ bias) heads, with and without a loss mask, chunked
and in one chunk.  float32 on the CPU; atol = rtol = 1e-5 (the same
products and reductions, summed in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.transformer.fused_loss import \
    fused_linear_xent as jax_xent
from deepspeed_tpu_torch.ops.transformer.fused_loss import fused_linear_xent

TOL = dict(atol=1e-5, rtol=1e-5)
N, D, V = 32, 16, 50


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("chunk", [0, 8, 12])
def test_value_and_grads_match_jax(tied, masked, chunk):
    """chunk 8 walks 4 chunks; chunk 12 does not divide N and falls back
    to one chunk, as in the JAX package."""
    rng = np.random.default_rng(10 * tied + 2 * masked + chunk)
    x = rng.standard_normal((N, D)).astype(np.float32)
    w = (0.3 * rng.standard_normal((V, D) if tied else (D, V))
         ).astype(np.float32)
    bias = None if tied else rng.standard_normal(V).astype(np.float32)
    labels = rng.integers(0, V, N).astype(np.int32)
    mask = ((rng.random(N) > 0.3).astype(np.float32) if masked else None)

    def jax_loss(x, w, b):
        tot, cnt = jax_xent(x, w, jnp.asarray(labels),
                            None if mask is None else jnp.asarray(mask),
                            bias=b, transpose_w=tied, chunk=chunk)
        return tot / jnp.maximum(cnt, 1.0), (tot, cnt)
    argnums = (0, 1) if tied else (0, 1, 2)
    (jl, (jtot, jcnt)), jgrads = jax.value_and_grad(
        jax_loss, argnums=argnums, has_aux=True)(
        jnp.asarray(x), jnp.asarray(w),
        None if bias is None else jnp.asarray(bias))

    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    tb = None if bias is None else torch.from_numpy(bias).requires_grad_(
        True)
    tot, cnt = fused_linear_xent(
        tx, tw, torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask), bias=tb,
        transpose_w=tied, chunk=chunk)
    loss = tot / torch.clamp(cnt, min=1.0)
    loss.backward()
    assert float(cnt) == float(jcnt)
    np.testing.assert_allclose(float(tot.detach()), float(jtot), **TOL)
    np.testing.assert_allclose(float(loss.detach()), float(jl), **TOL)
    got = [tx.grad, tw.grad] + ([] if tb is None else [tb.grad])
    for g, j in zip(got, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), **TOL)


def test_backward_saves_no_logits():
    """Only x, w, bias, labels and the mask cross to the backward: no
    saved tensor has the vocabulary width N x V."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((V, D)).astype(np.float32))
    x.requires_grad_(True)
    w.requires_grad_(True)
    tot, _ = fused_linear_xent(x, w, torch.zeros(N, dtype=torch.long),
                               transpose_w=True, chunk=8)
    shapes = [tuple(t.shape) for t in tot.grad_fn.saved_tensors
              if t is not None]
    assert (N, V) not in shapes and shapes[:2] == [(N, D), (V, D)]
