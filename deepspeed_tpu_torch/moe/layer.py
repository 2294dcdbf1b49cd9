"""MoE layer of the port: gate, dispatch, experts, combine on one device.

Counterpart of ``deepspeed_tpu/moe/layer.py`` (``MoEConfig``,
``mlp_expert``, ``MoELayer``) with the same params tree: the experts'
leaves stacked ``[E, ...]`` under ``experts``, the gate ``gate.kernel
[M, E]``, and with PR-MoE (``use_residual``) a dense ``residual_mlp``
and a 2-way ``coefficient`` whose per-token softmax mixes the two.
``apply`` returns ``(y, l_aux, exp_counts)``; train mode routes with
``capacity_factor`` and the noise policy, eval mode with
``eval_capacity_factor``, no noise and no RTS.

The gate's product runs in float32 on the gate kernel as stored (the
engines cast every float leaf to the compute dtype, so on bf16 weights
it is an f32 product of bf16-rounded weights, as in the JAX package;
nothing in the port enables TF32, so the card takes the f32 product
too).  Dispatch gathers each expert slot's token (an empty slot reads a
zero row) and combine sums each token's k expert outputs times its
weights, cast to x's dtype first: the values of the JAX layer's GShard
einsums ``sec,sm->ecm`` and ``sec,ecm->sm``.  The experts run as one
batched product over ``[E, C, M]``, as the JAX ``vmap`` does: every
expert runs its C slots, filled or not.

Left out, because they belong to multi-device work (ROADMAP.md queue A
item 7): ``partition_specs`` and the ``constrain`` hooks that place the
expert axis on a mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..models import layers as L
from ..utils.logging import logger
from .sharded_moe import GateNoise, Routing, draw_noise, route

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """The reference ``MoE.__init__`` surface."""
    num_experts: int = 1
    k: int = 1
    capacity_factor: float = 1.0
    eval_capacity_factor: float = 1.0
    min_capacity: int = 4
    use_residual: bool = False
    noisy_gate_policy: Optional[str] = None
    use_rts: bool = True
    aux_loss_coef: float = 0.01


class Expert(NamedTuple):
    """An expert as functions: ``init(generator, device, dtype)`` → one
    expert's params; ``apply(p, x [..., M])``; ``apply_stacked(p, x [E,
    C, M])`` over params stacked ``[E, ...]``."""
    init: Callable
    apply: Callable
    apply_stacked: Callable


def mlp_expert(d_model: int, d_ff: int, activation: str = "gelu",
               use_bias: bool = True,
               depth_scale: Optional[int] = None) -> Expert:
    """The standard FFN expert: ``fc_in``, the activation, ``fc_out``;
    ``depth_scale`` (the model's depth) gives ``fc_out`` the GPT-2 scaled
    init 0.02 / sqrt(2 L), as the dense blocks'."""
    act = L.ACT_FNS[activation]

    def init(generator, device, dtype=torch.float32):
        def normal(shape, std=0.02):
            return L.normal_init(shape, std, generator, device, dtype)
        out_kernel = (L.scaled_init((d_ff, d_model), 0.02, depth_scale,
                                    generator, device, dtype)
                      if depth_scale else normal((d_ff, d_model)))
        p = {"fc_in": {"kernel": normal((d_model, d_ff))},
             "fc_out": {"kernel": out_kernel}}
        if use_bias:
            p["fc_in"]["bias"] = torch.zeros(d_ff, dtype=dtype,
                                             device=device)
            p["fc_out"]["bias"] = torch.zeros(d_model, dtype=dtype,
                                              device=device)
        return p

    def apply(p, x):
        return L.dense_apply(p["fc_out"], act(L.dense_apply(p["fc_in"], x)))

    def stacked_dense(p, x):
        w = p["kernel"].to(x.dtype)
        b = p.get("bias")
        if b is None:
            return torch.bmm(x, w)
        return torch.baddbmm(b.to(x.dtype)[:, None, :], x, w)

    def apply_stacked(p, x):
        return stacked_dense(p["fc_out"], act(stacked_dense(p["fc_in"], x)))

    return Expert(init, apply, apply_stacked)


class MoELayer:
    """Functional MoE layer: ``init(generator, device, dtype)`` → params;
    ``apply(params, x, generator=None, train=True, noise=None)`` → ``(y,
    l_aux, exp_counts)`` for x ``[..., M]``."""

    _warned_no_rts_rng = False

    def __init__(self, d_model: int, config: MoEConfig,
                 expert: Optional[Expert] = None, d_ff: Optional[int] = None,
                 depth_scale: Optional[int] = None):
        self.d_model = d_model
        self.config = config
        self.expert = expert or mlp_expert(d_model, d_ff or 4 * d_model,
                                           depth_scale=depth_scale)

    def init(self, generator: torch.Generator, device,
             dtype: torch.dtype = torch.float32) -> Params:
        """Fresh weights: the gate N(0, 0.02) kept in float32 (routing
        decisions are precision-critical), each expert drawn in turn and
        stacked, then the PR-MoE leaves."""
        c = self.config
        gate = L.normal_init((self.d_model, c.num_experts), 0.02, generator,
                             device, torch.float32)
        params = {"gate": {"kernel": gate},
                  "experts": stack_trees(c.num_experts, lambda: self.expert
                                         .init(generator, device, dtype))}
        if c.use_residual:
            params["residual_mlp"] = self.expert.init(generator, device,
                                                      dtype)
            params["coefficient"] = {
                "kernel": L.normal_init((self.d_model, 2), 0.02, generator,
                                        device, dtype),
                "bias": torch.zeros(2, dtype=dtype, device=device)}
        return params

    def draw_noise(self, generator: Optional[torch.Generator],
                   num_tokens: int, train: bool = True) -> GateNoise:
        """The noise a call over ``num_tokens`` tokens draws from
        ``generator`` (none in eval mode)."""
        c = self.config
        if not train:
            return GateNoise()
        return draw_noise(generator, num_tokens, c.num_experts, c.k,
                          c.noisy_gate_policy, c.use_rts)

    def apply(self, params: Params, x: torch.Tensor,
              generator: Optional[torch.Generator] = None,
              train: bool = True, noise: Optional[GateNoise] = None):
        y, r = self.apply_routed(params, x, generator, train, noise)
        return y, r.l_aux, r.exp_counts

    def apply_routed(self, params: Params, x: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     train: bool = True, noise: Optional[GateNoise] = None
                     ) -> Tuple[torch.Tensor, Routing]:
        """``apply`` that returns the whole :class:`Routing` beside y."""
        c = self.config
        if noise is None:
            noise = self.draw_noise(generator, x.numel() // x.shape[-1],
                                    train)
        if (train and c.use_rts and noise.uniform is None
                and not MoELayer._warned_no_rts_rng):
            # RTS without noise degrades to drop-by-token-order: legal,
            # but the user asked for randomness
            logger.warning(
                "MoE use_rts=True but no rng provided (pass batch['moe_rng'] "
                "through the engine); token selection is deterministic")
            MoELayer._warned_no_rts_rng = True
        orig_shape = x.shape
        m = orig_shape[-1]
        tokens = x.reshape(-1, m)                               # [S, M]
        s = tokens.shape[0]
        logits = tokens.float() @ params["gate"]["kernel"].float()
        r = route(logits, c.k,
                  c.capacity_factor if train else c.eval_capacity_factor,
                  c.min_capacity,
                  noisy_gate_policy=c.noisy_gate_policy if train else None,
                  use_rts=c.use_rts and train, noise=noise)
        e, cap = c.num_experts, r.capacity
        k = r.expert.shape[1]
        # each (token, choice)'s slot row e * C + c, or e * C (past the
        # slots: a zero row) where dropped; and each slot's (token,
        # choice) s * k + j, or S * k where empty
        flat = torch.where(r.kept, r.expert * cap + r.slot,
                           torch.full_like(r.slot, e * cap))     # [S, k]
        owner = torch.full((e * cap + 1,), s * k, dtype=torch.long,
                           device=x.device)
        owner.scatter_(0, flat.reshape(-1),
                       torch.arange(s * k, device=x.device))
        owner = owner[:-1]
        # dispatch: slot (e, c) reads its token, an empty slot a zero row
        dispatched = _gather_rows(tokens, owner // k, flat).reshape(e, cap,
                                                                    m)
        expert_out = self.expert.apply_stacked(params["experts"],
                                               dispatched)
        # combine: each token's k outputs times its weights in x's dtype
        # (dropped choices weigh 0 and read a zero row)
        picked = _gather_rows(expert_out.reshape(e * cap, m), flat,
                              owner[:, None])                   # [S, k, M]
        w = r.weight.to(x.dtype)
        if r.expert.shape[1] == 1:
            combined = picked[:, 0] * w
        else:
            combined = torch.bmm(w[:, None, :], picked)[:, 0]
        if c.use_residual:
            # PR-MoE: out = moe(x) * w0 + mlp(x) * w1, per-token softmax mix
            mlp_out = self.expert.apply(params["residual_mlp"], tokens)
            coef = torch.softmax(
                L.dense_apply(params["coefficient"], tokens).float(), dim=-1)
            combined = (combined * coef[:, 0:1].to(x.dtype)
                        + mlp_out * coef[:, 1:2].to(x.dtype))
        return combined.reshape(orig_shape), r


class _GatherRows(torch.autograd.Function):
    """``out = src[idx]`` with a zero row at index ``len(src)``, for an
    ``idx`` that reads each row of src at most ``inv.shape[1]`` times:
    ``inv [R, n]`` lists the flat positions of ``idx`` that read row r
    (``idx.numel()`` where fewer).  The backward is the gather ``grad[inv]``
    summed over n, not a scatter: routing is a (partial) permutation, so
    the gradient needs no accumulating index kernel."""

    @staticmethod
    def forward(ctx, src, idx, inv):
        ctx.save_for_backward(inv)
        ctx.idx_shape = idx.shape
        padded = torch.cat([src, src.new_zeros((1,) + src.shape[1:])])
        return padded[idx]

    @staticmethod
    def backward(ctx, grad):
        (inv,) = ctx.saved_tensors
        rows = grad.reshape((-1,) + grad.shape[len(ctx.idx_shape):])
        padded = torch.cat([rows, rows.new_zeros((1,) + rows.shape[1:])])
        return padded[inv].sum(1), None, None


def _gather_rows(src, idx, inv):
    return _GatherRows.apply(src, idx, inv)


def stack_trees(n: int, make) -> Params:
    """``n`` trees from ``make()`` stacked leaf by leaf on a new leading
    axis, each written into the stacked leaves as soon as it is made (no
    list of ``n`` trees is held)."""
    first = make()

    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        return torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                           device=t.device)

    def put(out, t, i):
        if isinstance(t, dict):
            for k in t:
                put(out[k], t[k], i)
        else:
            out[i] = t
    out = alloc(first)
    put(out, first, 0)
    del first
    for i in range(1, n):
        put(out, make(), i)
    return out
