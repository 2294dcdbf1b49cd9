"""Optimizers as ``(init, apply)`` pairs over params trees.

Counterpart of ``deepspeed_tpu/runtime/optimizers.py``: the same API
(``opt = get_optimizer("adamw", weight_decay=0.1)``, ``state =
opt.init(params)``, ``new_params, new_state = opt.apply(grads, state,
params, lr)``) and, for Adam/AdamW, the same float32 arithmetic in the
same order (weight decay is added to the update ``u``, not to the
gradient, in AdamW mode).  ``torch.optim.AdamW`` is not used: it rounds
in another order and keeps no ``(init, apply)`` state.

``apply`` is out of place, as in the JAX package: it returns new trees
and leaves its inputs untouched, so the engine can keep the old state on
a skipped step with ``torch.where``.  ``lr`` and the state's ``step``
are tensors on the params' device; nothing syncs with the host.

LAMB, SGD, Adagrad and the 1-bit optimizers are later
slices of the port and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of equal structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    else:
        yield tree


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable
    apply: Callable          # (grads, state, params, lr) -> (params, state)
    hyperparams: Dict[str, Any] = dataclasses.field(default_factory=dict)


def _zeros_like_f32(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def adam(lr_default: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
         weight_decay: float = 0.0, adamw_mode: bool = True,
         bias_correction: bool = True) -> Optimizer:
    b1, b2 = betas

    def init(params):
        dev = next(tree_leaves(params)).device
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "m": _zeros_like_f32(params),
                "v": _zeros_like_f32(params)}

    def apply(grads, state, params, lr):
        step = state["step"] + 1
        t = step.to(torch.float32)
        if bias_correction:
            c1 = 1.0 - b1 ** t
            c2 = 1.0 - b2 ** t
        else:
            c1 = c2 = 1.0

        def upd(g, m, v, p):
            g32 = g.to(torch.float32)
            m = b1 * m + (1 - b1) * g32
            v = b2 * v + (1 - b2) * g32 * g32
            mhat = m / c1
            vhat = v / c2
            u = mhat / (torch.sqrt(vhat) + eps)
            p32 = p.to(torch.float32)
            if weight_decay and adamw_mode:
                u = u + weight_decay * p32
            return (p32 - lr * u).to(p.dtype), m, v

        if weight_decay and not adamw_mode:
            grads = tree_map(lambda g, p: g + weight_decay * p.to(g.dtype),
                             grads, params)
        out = tree_map(upd, grads, state["m"], state["v"], params)
        new_params = tree_map(lambda o: o[0], out)
        new_m = tree_map(lambda o: o[1], out)
        new_v = tree_map(lambda o: o[2], out)
        return new_params, {"step": step, "m": new_m, "v": new_v}

    return Optimizer("adamw" if adamw_mode else "adam", init, apply,
                     dict(lr=lr_default, betas=betas, eps=eps,
                          weight_decay=weight_decay))


_LATER = {
    ("lamb", "fusedlamb"): "LAMB",
    ("sgd",): "SGD",
    ("adagrad", "cpuadagrad"): "Adagrad",
    ("onebitadam", "onebitlamb", "zerooneadam"): "the 1-bit optimizers",
}


def get_optimizer(name: str, **params) -> Optimizer:
    """Name dispatch of the JAX package's ``get_optimizer``."""
    name_l = name.lower()
    lr = params.pop("lr", None)
    betas = params.pop("betas", (0.9, 0.999))
    if isinstance(betas, list):
        betas = tuple(betas)
    if name_l in ("adam", "adamw", "fusedadam", "cpuadam",
                  "deepspeedcpuadam"):
        opt = adam(lr if lr is not None else 1e-3, betas,
                   params.pop("eps", 1e-8), params.pop("weight_decay", 0.0),
                   adamw_mode=params.pop("adam_w_mode", name_l != "adam"),
                   bias_correction=params.pop("bias_correction", True))
        if params:
            raise ValueError(
                f"Unknown parameter(s) for optimizer {name}: "
                f"{sorted(params)}")
        return opt
    for names, what in _LATER.items():
        if name_l in names:
            raise NotImplementedError(
                f"optimizer {name}: {what} is not in the training slice of "
                f"the PyTorch port (Adam/AdamW only); a later slice of "
                f"ROADMAP.md queue A brings it")
    raise ValueError(f"Unknown optimizer: {name}")
