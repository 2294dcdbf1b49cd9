"""MoE layer of the port: gate, dispatch, experts, combine.

Counterpart of ``deepspeed_tpu/moe/layer.py`` (``MoEConfig``,
``mlp_expert``, ``MoELayer``) with the same params tree: the experts'
leaves stacked ``[E, ...]`` under ``experts``, the gate ``gate.kernel
[M, E]``, and with PR-MoE (``use_residual``) a dense ``residual_mlp``
and a 2-way ``coefficient`` whose per-token softmax mixes the two.
``apply`` returns ``(y, l_aux, exp_counts)``; train mode routes with
``capacity_factor`` and the noise policy, eval mode with
``eval_capacity_factor``, no noise and no RTS.  ``partition_specs`` is
the JAX layer's: the expert stacks cut over ``expert`` on E and, inside
each expert, ``fc_in``'s columns and ``fc_out``'s rows over ``model``
(the residual MLP likewise); the gate and the coefficient replicated.

The gate's product runs in float32 on the gate kernel as stored (the
engines cast every float leaf to the compute dtype, so on bf16 weights
it is an f32 product of bf16-rounded weights, as in the JAX package;
nothing in the port enables TF32, so the card takes the f32 product
too).  Dispatch gathers each expert slot's token (an empty slot reads a
zero row) and combine sums each token's k expert outputs times its
weights, cast to x's dtype first: the values of the JAX layer's GShard
einsums ``sec,sm->ecm`` and ``sec,ecm->sm``.

Where the layer runs is its :class:`Placement`, the JAX layer's one
function on every mesh written with explicit collectives:

* tokens the same on every rank (one device, or serving, where every
  rank holds the whole batch): the experts this rank holds run as one
  batched product over their global slots ``[E / ep, C, M]``, filled or
  not (the JAX ``vmap``); at ``expert`` ep > 1 each rank's combine is
  partial (its experts' choices) and one all-reduce over ``expert``
  sums it;
* tokens spread over the batch axes (training on a data-like mesh):
  each rank's f32 logits are all-gathered over the batch axes in the
  global batch's order and every rank routes the whole batch, so the
  capacity, the slots, ``exp_counts`` and ``l_aux`` are the global ones
  and every rank holds the same decisions.  A rank sends each of its
  kept ``(token, choice)`` rows, in ``(expert, slot)`` order, to the
  rank of its expert group (the ranks that differ only on ``expert``)
  that holds that expert (``all_to_all`` with split sizes: every rank
  knows the whole routing, so no count crosses).  The owner packs each
  of its experts' rows to the largest such count, so a rank's expert
  FLOPs follow the tokens it was sent, not the global capacity; the
  outputs go back by the reverse exchange and combine as above.  At
  ep 1 the exchange is the identity: a rank runs its own tokens.

Under a ``model`` axis the expert FFN and the residual MLP take the
model's ``fin`` before and ``red`` after (``fc_out``'s bias is divided
by mp where the model's Megatron layout divides it), the gate and the
coefficient run replicated, and the model ranks of one data coordinate
hold the same rows, so they route alike.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from .. import comm
from ..models import layers as L
from ..parallel.collectives import all_to_all, gather_rows, own_rows
from ..utils.logging import logger
from .sharded_moe import GateNoise, Routing, draw_noise, route, spread_plan

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
    C, M])`` over params stacked ``[E, ...]``; ``specs()`` → one
    expert's spec tree over ``model``."""
    init: Callable
    apply: Callable
    apply_stacked: Callable
    specs: Callable


def _identity(x):
    return x


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where an MoE layer's tokens and experts live: ``batch_axes``, the
    axes whose ranks hold different rows (their rows are ``runs`` runs,
    the micro batches of a gathered run, as ``gather_rows`` takes them);
    ``expert_axis``, the axis the expert stacks are cut over; ``fin`` and
    ``red``, the model axis's entry into and exit from shard-local
    compute around the expert FFN.  The default is one device."""
    batch_axes: Tuple[str, ...] = ()
    runs: int = 1
    expert_axis: Optional[str] = None
    fin: Callable = _identity
    red: Callable = _identity

    def spread(self) -> int:
        """The batch group's size: above 1, tokens differ across it."""
        return comm.axis_size(self.batch_axes) if self.batch_axes else 1

    def ep(self) -> int:
        return comm.axis_size(self.expert_axis) if self.expert_axis else 1


LOCAL = Placement()


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

    def specs():
        sp = {"fc_in": {"kernel": (None, "model")},
              "fc_out": {"kernel": ("model", None)}}
        if use_bias:
            sp["fc_in"]["bias"] = ("model",)
            sp["fc_out"]["bias"] = (None,)
        return sp

    return Expert(init, apply, apply_stacked, specs)


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

    def partition_specs(self) -> Params:
        """The JAX layer's specs: expert leaves ``("expert", ...)`` with
        the expert's ``model`` cut behind it; the gate, the residual's
        and the coefficient's as the JAX layer keeps them."""
        exp = self.expert.specs()

        def lead(t):
            if isinstance(t, dict):
                return {k: lead(v) for k, v in t.items()}
            return ("expert",) + tuple(t)
        specs = {"gate": {"kernel": (None, None)}, "experts": lead(exp)}
        if self.config.use_residual:
            specs["residual_mlp"] = exp
            specs["coefficient"] = {"kernel": (None, None), "bias": (None,)}
        return specs

    def draw_noise(self, generator: Optional[torch.Generator],
                   num_tokens: int, train: bool = True) -> GateNoise:
        """The noise a call over ``num_tokens`` tokens (the whole routed
        batch's) draws from ``generator`` (none in eval mode)."""
        c = self.config
        if not train:
            return GateNoise()
        return draw_noise(generator, num_tokens, c.num_experts, c.k,
                          c.noisy_gate_policy, c.use_rts)

    def apply(self, params: Params, x: torch.Tensor,
              generator: Optional[torch.Generator] = None,
              train: bool = True, noise: Optional[GateNoise] = None,
              place: Placement = LOCAL):
        y, r = self.apply_routed(params, x, generator, train, noise, place)
        return y, r.l_aux, r.exp_counts

    def apply_routed(self, params: Params, x: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     train: bool = True, noise: Optional[GateNoise] = None,
                     place: Placement = LOCAL
                     ) -> Tuple[torch.Tensor, Routing]:
        """``apply`` that returns the whole batch's :class:`Routing`
        beside y (this rank's rows)."""
        c = self.config
        spread = place.spread()
        if noise is None:
            noise = self.draw_noise(
                generator, x.numel() // x.shape[-1] * spread, train)
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
        tokens = x.reshape(-1, m)                               # [S_r, M]
        logits = tokens.float() @ params["gate"]["kernel"].float()
        mine = None
        if spread > 1:
            # the whole batch's logits, in its order, on every rank
            rows = x.reshape(x.shape[0], -1, m)
            logits = gather_rows(logits.reshape(rows.shape[:2] + (-1,)),
                                 place.batch_axes, place.runs)
            s = logits.shape[0] * logits.shape[1]
            mine = own_rows(torch.arange(s, device=x.device).reshape(
                logits.shape[:2]), place.batch_axes, place.runs).reshape(-1)
            logits = logits.reshape(s, -1)
        r = route(logits, c.k,
                  c.capacity_factor if train else c.eval_capacity_factor,
                  c.min_capacity,
                  noisy_gate_policy=c.noisy_gate_policy if train else None,
                  use_rts=c.use_rts and train, noise=noise)
        if mine is None:
            combined = self._combine_local(params, tokens, r, place)
        else:
            combined = self._combine_spread(params, tokens, r, mine,
                                            rows.shape[1], place)
        if c.use_residual:
            # PR-MoE: out = moe(x) * w0 + mlp(x) * w1, per-token softmax mix
            mlp_out = place.red(self.expert.apply(params["residual_mlp"],
                                                  place.fin(tokens)))
            coef = torch.softmax(
                L.dense_apply(params["coefficient"], tokens).float(), dim=-1)
            combined = (combined * coef[:, 0:1].to(x.dtype)
                        + mlp_out * coef[:, 1:2].to(x.dtype))
        return combined.reshape(orig_shape), r

    def _experts(self, params, dispatched, place):
        return place.red(self.expert.apply_stacked(params["experts"],
                                                   place.fin(dispatched)))

    @staticmethod
    def _weigh(picked, weight):
        """Each token's k outputs ``[S, k, M]`` times its weights."""
        w = weight.to(picked.dtype)
        if picked.shape[1] == 1:
            return picked[:, 0] * w
        return torch.bmm(w[:, None, :], picked)[:, 0]

    def _combine_local(self, params, tokens, r: Routing, place):
        """Tokens the same on every rank: this rank's experts over their
        global slots; their partial combine summed over ``expert``."""
        s, m = tokens.shape
        k, cap = r.expert.shape[1], r.capacity
        el = _num_local(params)
        ep = place.ep()
        e0 = (comm.axis_index(place.expert_axis) * el if ep > 1 else 0)
        local = r.kept & (r.expert >= e0) & (r.expert < e0 + el)
        # each (token, choice)'s slot row (e - e0) * C + c, or el * C (past
        # the slots: a zero row) where dropped or held elsewhere; and each
        # slot's (token, choice) s * k + j, or S * k where empty
        flat = torch.where(local, (r.expert - e0) * cap + r.slot,
                           torch.full_like(r.slot, el * cap))    # [S, k]
        owner = torch.full((el * cap + 1,), s * k, dtype=torch.long,
                           device=tokens.device)
        owner.scatter_(0, flat.reshape(-1),
                       torch.arange(s * k, device=tokens.device))
        owner = owner[:-1]
        # dispatch: slot (e, c) reads its token, an empty slot a zero row
        dispatched = _gather_rows(tokens, owner // k, flat).reshape(
            el, cap, m)
        expert_out = self._experts(params, dispatched, place)
        # combine: each token's k outputs times its weights in x's dtype
        # (dropped choices weigh 0 and read a zero row)
        picked = _gather_rows(expert_out.reshape(el * cap, m), flat,
                              owner[:, None])                   # [S, k, M]
        combined = self._weigh(picked, r.weight)
        if ep > 1:
            combined = comm.all_reduce(combined, comm.ReduceOp.SUM,
                                       place.expert_axis)
        return combined

    def _combine_spread(self, params, tokens, r: Routing, mine, per_row,
                        place):
        """Tokens spread over the batch axes: this rank's kept rows to
        their experts' ranks and back (``spread_plan``), each rank's
        experts over its packed rows."""
        s_r, m = tokens.shape
        k = r.expert.shape[1]
        plan = spread_plan(r, mine, per_row, place.runs,
                           place.spread(), comm.axis_index(place.batch_axes),
                           place.ep(), _num_local(params))
        # this rank's kept (token, choice) rows in (expert, slot) order
        send = _gather_rows(tokens, plan.order // k, plan.pos)
        recv = all_to_all(send, place.expert_axis or (), plan.send,
                          plan.recv)
        packed = _gather_rows(recv, plan.slot_src, plan.slot[:, None])
        out = self._experts(params, packed.reshape(plan.el, plan.c_loc, m),
                            place)
        out = _gather_rows(out.reshape(-1, m), plan.slot,
                           plan.slot_src[:, None])
        back = all_to_all(out, place.expert_axis or (), plan.recv,
                          plan.send)
        picked = _gather_rows(back, plan.pos, plan.order[:, None])
        return self._weigh(picked, r.weight[mine])


def _num_local(params) -> int:
    """The number of experts whose stacks this rank holds."""
    leaf = params["experts"]
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return int(leaf.shape[0])


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
