"""Token sampling shared by ``generate()`` and the serving engine.

Counterpart of ``deepspeed_tpu/inference/sampling.py``.  Temperature 0
is the argmax of the f32 logits (exact, first index on ties, as
``jnp.argmax``).  Otherwise the logits are scaled and filtered step for
step as ``sample_tokens_per_row`` does (top-k by the k-th largest value,
then top-p over the top-k-filtered logits, neutral values masking
nothing) and the draw is ``argmax(filtered + Gumbel noise)``.

Key schedule: the noise for output index ``j`` of a request comes from a
``torch.Generator`` seeded with :func:`token_seed` ``(key, j)``, so a
stream depends only on its key and positions, never on batch
composition, as ``fold_in(key, j)`` makes it in JAX.  The draws cannot
equal JAX's threefry draws; only the kept set and the greedy path are
shared with the JAX package.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch

_MASK64 = (1 << 64) - 1


def token_seed(key: int, index: int) -> int:
    """Seed for output token ``index`` of a request with ``key``
    (splitmix64 finaliser over the pair)."""
    z = ((int(key) & 0xFFFFFFFF) << 32 | (int(index) & 0xFFFFFFFF))
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def _rows(x: Union[float, Sequence[float], torch.Tensor], n: int,
          dtype, device) -> torch.Tensor:
    t = torch.as_tensor(x, dtype=dtype, device=device)
    return t.expand(n) if t.dim() == 0 else t


def filter_logits(logits: torch.Tensor, temperature, top_k, top_p
                  ) -> torch.Tensor:
    """Temperature-scaled logits ``[B, V]`` with everything outside the
    top-k / top-p kept set at ``-inf`` (per-row or scalar params; top_k 0
    and top_p >= 1 keep everything)."""
    b, v = logits.shape
    dev = logits.device
    t = _rows(temperature, b, torch.float32, dev)
    k = _rows(top_k, b, torch.int64, dev)
    p = _rows(top_p, b, torch.float32, dev)
    scaled = logits.float() / t.clamp_min(1e-8)[:, None]
    k_eff = torch.where(k > 0, k.clamp(1, v), torch.full_like(k, v))
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = torch.gather(sorted_desc, 1, (k_eff - 1)[:, None])
    neg = torch.full_like(scaled, float("-inf"))
    filt = torch.where(scaled < kth, neg, scaled)
    s2 = torch.sort(filt, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(s2, dim=-1), dim=-1)
    cutoff_idx = (cum < p[:, None]).sum(dim=-1)
    cutoff_idx = torch.where(p >= 1.0, torch.full_like(cutoff_idx, v - 1),
                             cutoff_idx).clamp(max=v - 1)
    cutoff = torch.gather(s2, 1, cutoff_idx[:, None])
    return torch.where(filt < cutoff, neg, filt)


def gumbel_noise(key: int, index: int, shape, device) -> torch.Tensor:
    """Gumbel(0, 1) noise of ``shape`` for output ``index`` of ``key``."""
    g = torch.Generator(device=device)
    g.manual_seed(token_seed(key, index))
    u = torch.rand(shape, generator=g, device=device, dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp_min(1e-20)))


def sample_tokens(logits: torch.Tensor, keys: Sequence[int],
                  indices: Sequence[int], temperature, top_k, top_p
                  ) -> torch.Tensor:
    """One token per row of ``logits [B, V]``; row b draws with
    ``(keys[b], indices[b])``.  Rows with temperature 0 take the argmax
    of the raw logits.  Returns int64 ``[B]``."""
    b, v = logits.shape
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1)
    t = _rows(temperature, b, torch.float32, "cpu")
    if not bool((t > 0).any()):
        return greedy
    filt = filter_logits(logits, temperature, top_k, top_p)
    noise = torch.stack([gumbel_noise(keys[i], indices[i], (v,),
                                      logits.device) for i in range(b)])
    sampled = torch.argmax(filt + noise, dim=-1)
    return torch.where(t.to(logits.device) > 0, sampled, greedy)


def sample_batch(logits: torch.Tensor, key: int, index: int,
                 temperature: float, top_k: int, top_p: float
                 ) -> torch.Tensor:
    """``generate()``'s draw: one key for the whole batch, as the JAX
    package draws ``categorical(fold_in(key, j), logits [B, V])`` — the
    noise is one ``[B, V]`` draw, so row 0 of a batch (and a batch of
    one) sees exactly the noise a serving request with the same key
    sees at the same index."""
    logits = logits.float()
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    filt = filter_logits(logits, temperature, top_k, top_p)
    return torch.argmax(filt + gumbel_noise(key, index, tuple(filt.shape),
                                            logits.device), dim=-1)
