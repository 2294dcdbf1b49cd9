"""Top-k gating (GShard-style) for the port.

Counterpart of ``deepspeed_tpu/moe/sharded_moe.py`` with the same
semantics:

* capacity is static from the call's token count S:
  ``max(ceil(S / E * capacity_factor), min_capacity)``; top-2 uses twice
  the factor;
* slots are taken in token order (``cumsum - 1``); top-2's second
  choices queue behind all first choices;
* ``exp_counts`` counts each expert's first choices before the drop;
* ``l_aux`` is ``sum(me * ce) * E`` for top-1 and ``mean(me * ce) * E *
  E`` for top-2; top-2's gates are renormalised by ``max(g1 + g2,
  eps)``;
* everything runs in float32; ``drop_tokens=False`` raises with the JAX
  package's message.

Randomness comes from an explicit ``torch.Generator``, never the global
RNG: Random Token Selection (``use_rts``) ranks each expert's tokens by
uniform noise (a stable double argsort) and re-packs the survivors in
token order; the RSample policy adds Gumbel noise to the routing logits;
top-2 with a generator picks its second expert by Gumbel-max.  Without a
generator RTS falls back to token order and RSample raises.  The noise
is drawn by :func:`draw_noise` and may be passed in as a
:class:`GateNoise`, so a caller can draw it once and route the same
tokens again (the model's recomputed forward under remat).

Besides the JAX package's dense ``[S, E, C]`` :class:`GateOutput`, the
gates return their decisions per token as a :class:`Routing` (expert,
slot and weight of each of the k choices), from which the MoE layer
dispatches by an index gather and combines by a weighted sum: the values
of the GShard einsums, without their ``[S, E, C]`` tensors.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch


class GateOutput(NamedTuple):
    l_aux: torch.Tensor            # scalar load-balance loss (f32)
    combine_weights: torch.Tensor  # [S, E, C] f32
    dispatch_mask: torch.Tensor    # [S, E, C] bool
    exp_counts: torch.Tensor       # [E] int32, tokens routed (pre-drop)


class GateNoise(NamedTuple):
    """Noise of one gate call, ``[S, E]`` f32 each (None: not drawn):
    Gumbel noise for RSample or top-2's second choice, uniform priorities
    for RTS."""
    gumbel: Optional[torch.Tensor] = None
    uniform: Optional[torch.Tensor] = None


class Routing(NamedTuple):
    """Each token's k choices: ``expert``, ``slot`` (its place in that
    expert's capacity; 0 where dropped) and combine ``weight`` (f32, 0
    where dropped), all ``[S, k]``; ``kept`` ``[S, k]`` bool."""
    l_aux: torch.Tensor
    exp_counts: torch.Tensor
    expert: torch.Tensor
    slot: torch.Tensor
    weight: torch.Tensor
    kept: torch.Tensor
    capacity: int

    def dense(self) -> GateOutput:
        """The JAX package's ``[S, E, C]`` combine weights and dispatch
        mask (``combine > 0``)."""
        s, k = self.expert.shape
        e, c = self.exp_counts.shape[0], self.capacity
        combine = torch.zeros((s, e * c), dtype=torch.float32,
                              device=self.weight.device)
        combine.scatter_add_(1, self.expert * c + self.slot,
                             torch.where(self.kept, self.weight,
                                         torch.zeros_like(self.weight)))
        combine = combine.reshape(s, e, c)
        return GateOutput(self.l_aux, combine, combine > 0, self.exp_counts)


def capacity(num_tokens: int, num_experts: int, capacity_factor: float,
             min_capacity: int) -> int:
    """Static per-expert capacity."""
    cap = int(math.ceil((num_tokens / num_experts) * capacity_factor))
    return max(cap, min_capacity)


def _gumbel(generator: torch.Generator, shape) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log u)``, u uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=generator.device,
                   dtype=torch.float32)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def draw_noise(generator: Optional[torch.Generator], num_tokens: int,
               num_experts: int, k: int = 1,
               noisy_gate_policy: Optional[str] = None,
               use_rts: bool = True) -> GateNoise:
    """The noise one gate call draws from ``generator`` (on its device):
    top-1 takes Gumbel noise for RSample, then RTS priorities; top-2 the
    Gumbel noise of its second choice.  No generator: no noise."""
    if generator is None:
        return GateNoise()
    shape = (num_tokens, num_experts)
    if k == 1:
        gumbel = (_gumbel(generator, shape)
                  if noisy_gate_policy == "RSample" else None)
        uniform = (torch.rand(shape, generator=generator,
                              device=generator.device, dtype=torch.float32)
                   if use_rts else None)
        return GateNoise(gumbel, uniform)
    return GateNoise(_gumbel(generator, shape), None)


def _noise(noise: Optional[GateNoise], generator, s, e, k,
           noisy_gate_policy, use_rts) -> GateNoise:
    if noise is not None:
        return noise
    return draw_noise(generator, s, e, k, noisy_gate_policy, use_rts)


def _cumsum0(mask: torch.Tensor) -> torch.Tensor:
    """``cumsum(mask, 0)`` of an ``[S, E]`` mask, taken along the rows of
    its transpose (a scan along the outer dimension of 16 K tokens is the
    slow form of the same sum on the card)."""
    return torch.cumsum(mask.t().contiguous(), dim=1).t()


def _one_hot(idx: torch.Tensor, e: int) -> torch.Tensor:
    return torch.nn.functional.one_hot(idx, e).to(torch.int32)


def _rank_within_expert(mask: torch.Tensor,
                        priority: Optional[torch.Tensor]) -> torch.Tensor:
    """Position of each selected token within its expert's queue, ``[S,
    E]``: token order without ``priority``, else descending priority (a
    stable double argsort; unselected tokens rank after every selected
    one)."""
    if priority is None:
        return _cumsum0(mask) - 1
    keyed = torch.where(mask > 0, priority,
                        torch.full_like(priority, -math.inf))
    order = torch.argsort(-keyed, dim=0, stable=True)
    return torch.argsort(order, dim=0, stable=True)


def top1_route(logits: torch.Tensor, capacity_factor: float = 1.0,
               min_capacity: int = 4,
               used_token: Optional[torch.Tensor] = None,
               noisy_gate_policy: Optional[str] = None,
               drop_tokens: bool = True, use_rts: bool = True,
               generator: Optional[torch.Generator] = None,
               noise: Optional[GateNoise] = None) -> Routing:
    """Switch-style top-1 routing as a :class:`Routing`."""
    if not drop_tokens:
        raise ValueError(
            "drop_tokens=False needs data-dependent shapes under jit; raise "
            "capacity_factor (e.g. to num_experts) for the same effect")
    s, e = logits.shape
    logits = logits.float()
    gates = torch.softmax(logits, dim=-1)
    cap = capacity(s, e, capacity_factor, min_capacity)
    noise = _noise(noise, generator, s, e, 1, noisy_gate_policy, use_rts)

    if noisy_gate_policy == "RSample":
        if noise.gumbel is None:
            raise ValueError("noisy_gate_policy='RSample' needs an rng: a "
                             "torch.Generator (batch['moe_rng'] through "
                             "the engine)")
        indices1 = torch.argmax(logits + noise.gumbel, dim=1)
    else:
        indices1 = torch.argmax(gates, dim=1)
    mask1 = _one_hot(indices1, e)
    if used_token is not None:
        mask1 = mask1 * used_token[:, None].to(torch.int32)
    exp_counts = mask1.sum(0).to(torch.int32)

    me = gates.mean(0)
    ce = mask1.float().mean(0)
    l_aux = torch.sum(me * ce) * e

    prio = noise.uniform if use_rts else None
    locations1 = _rank_within_expert(mask1, prio)
    mask1 = mask1 * (locations1 < cap).to(torch.int32)
    if prio is not None:
        # re-pack the surviving tokens contiguously into capacity slots
        locations1 = _cumsum0(mask1) - 1
    slot = torch.sum(locations1 * mask1, dim=1)
    kept = mask1.sum(1) > 0
    weight = torch.sum(gates * mask1.float(), dim=1)
    return Routing(l_aux, exp_counts, indices1[:, None], slot[:, None].long(),
                   weight[:, None], kept[:, None], cap)


def top2_route(logits: torch.Tensor, capacity_factor: float = 1.0,
               min_capacity: int = 4,
               generator: Optional[torch.Generator] = None,
               noise: Optional[GateNoise] = None) -> Routing:
    """GShard top-2 routing as a :class:`Routing`: the second expert by
    Gumbel-max with noise, else the second argmax."""
    s, e = logits.shape
    logits = logits.float()
    gates = torch.softmax(logits, dim=-1)
    cap = capacity(s, e, capacity_factor * 2.0, min_capacity)
    noise = _noise(noise, generator, s, e, 2, None, False)

    indices1 = torch.argmax(gates, dim=1)
    mask1 = _one_hot(indices1, e)
    logits2 = logits if noise.gumbel is None else logits + noise.gumbel
    logits_except1 = torch.where(mask1 > 0,
                                 torch.full_like(logits2, -math.inf),
                                 logits2)
    indices2 = torch.argmax(logits_except1, dim=1)
    mask2 = _one_hot(indices2, e)

    locations1 = _cumsum0(mask1) - 1
    # second-choice tokens queue behind ALL first-choice tokens
    locations2 = (_cumsum0(mask2) - 1
                  + mask1.sum(0, keepdim=True))

    exp_counts = mask1.sum(0).to(torch.int32)
    me = gates.mean(0)
    ce = mask1.float().mean(0)
    l_aux = torch.mean(me * ce) * e * e

    mask1 = mask1 * (locations1 < cap).to(torch.int32)
    mask2 = mask2 * (locations2 < cap).to(torch.int32)
    slot1 = torch.sum(locations1 * mask1, dim=1)
    slot2 = torch.sum(locations2 * mask2, dim=1)

    gates1 = torch.sum(gates * mask1.float(), dim=1)
    gates2 = torch.sum(gates * mask2.float(), dim=1)
    denom = torch.clamp(gates1 + gates2,
                        min=torch.finfo(torch.float32).eps)
    weight = torch.stack([gates1 / denom, gates2 / denom], dim=1)
    kept = torch.stack([mask1.sum(1) > 0, mask2.sum(1) > 0], dim=1)
    return Routing(l_aux, exp_counts,
                   torch.stack([indices1, indices2], dim=1),
                   torch.stack([slot1, slot2], dim=1).long(), weight, kept,
                   cap)


def top1_gating(logits: torch.Tensor, capacity_factor: float = 1.0,
                min_capacity: int = 4,
                used_token: Optional[torch.Tensor] = None,
                noisy_gate_policy: Optional[str] = None,
                drop_tokens: bool = True, use_rts: bool = True,
                generator: Optional[torch.Generator] = None,
                noise: Optional[GateNoise] = None) -> GateOutput:
    """Switch-style top-1 routing (dense ``[S, E, C]`` output)."""
    return top1_route(logits, capacity_factor, min_capacity, used_token,
                      noisy_gate_policy, drop_tokens, use_rts, generator,
                      noise).dense()


def top2_gating(logits: torch.Tensor, capacity_factor: float = 1.0,
                min_capacity: int = 4,
                generator: Optional[torch.Generator] = None,
                noise: Optional[GateNoise] = None) -> GateOutput:
    """GShard top-2 routing (dense ``[S, E, C]`` output)."""
    return top2_route(logits, capacity_factor, min_capacity, generator,
                      noise).dense()


def route(logits: torch.Tensor, k: int, capacity_factor: float = 1.0,
          min_capacity: int = 4,
          generator: Optional[torch.Generator] = None,
          noisy_gate_policy: Optional[str] = None, use_rts: bool = True,
          noise: Optional[GateNoise] = None) -> Routing:
    """k-dispatch front door (k in {1, 2}) as a :class:`Routing`."""
    if k == 1:
        return top1_route(logits, capacity_factor, min_capacity,
                          noisy_gate_policy=noisy_gate_policy,
                          use_rts=use_rts, generator=generator, noise=noise)
    if k == 2:
        return top2_route(logits, capacity_factor, min_capacity,
                          generator=generator, noise=noise)
    raise ValueError(f"Only top-1 and top-2 gating supported, got k={k}")


def gate(logits: torch.Tensor, k: int, capacity_factor: float = 1.0,
         min_capacity: int = 4, generator: Optional[torch.Generator] = None,
         noisy_gate_policy: Optional[str] = None, use_rts: bool = True,
         noise: Optional[GateNoise] = None) -> GateOutput:
    """k-dispatch front door (k in {1, 2}), dense ``[S, E, C]`` output."""
    return route(logits, k, capacity_factor, min_capacity, generator,
                 noisy_gate_policy, use_rts, noise).dense()
