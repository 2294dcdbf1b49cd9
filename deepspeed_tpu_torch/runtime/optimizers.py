"""Optimizers as ``(init, apply)`` pairs over params trees.

Counterpart of ``deepspeed_tpu/runtime/optimizers.py``: the same API
(``opt = get_optimizer("adamw", weight_decay=0.1)``, ``state =
opt.init(params)``, ``new_params, new_state = opt.apply(grads, state,
params, lr)``) and, for Adam/AdamW, LAMB, SGD (momentum, Nesterov) and
Adagrad, the same float32 arithmetic in the same order (weight decay is
added to the update ``u``, not to the gradient, in AdamW mode and in
LAMB).  ``torch.optim``'s classes are not used for these: they round in
another order and keep no ``(init, apply)`` state.

``apply`` is out of place, as in the JAX package: it returns new trees
and leaves its inputs untouched, so the engine can keep the old state on
a skipped step with ``torch.where``.  ``lr`` and the state's ``step``
are tensors on the params' device; nothing syncs with the host.

LAMB's trust ratio is taken over a whole leaf, as the JAX package takes
it: the blocks' leaves are stacked on a layer axis, so one ratio spans
every layer of a stacked leaf (the square roots of the leaf's sums of
squares, chosen by ``torch.where``, no host branch).  Where a rank holds
a piece of a leaf (ZeRO over data, a model or a pipe axis), ``apply``'s
``leaf_sums`` makes each piece's two sums the whole leaf's
(``ZeroPartition.leaf_sums``: one all-reduce an axis group a step); the
other optimizers work element by element and ignore it.

``wrap_torch`` is the counterpart of ``wrap_optax``: a client
``torch.optim.Optimizer`` (a class or factory of a list of tensors)
becomes an :class:`Optimizer` that carries its own learning rate.  The
1-bit optimizers are a later part of ROADMAP queue A item 7 (part 7)
and raise ``NotImplementedError``.
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
    #: (grads, state, params, lr, leaf_sums=None) -> (params, state);
    #: ``leaf_sums`` maps a tree of per-leaf partial sums over this
    #: rank's pieces to the sums over the whole leaves (None: whole
    #: leaves, the identity); only LAMB reads it
    apply: Callable
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

    def apply(grads, state, params, lr, leaf_sums=None):
        del leaf_sums  # elementwise: a shard's step is the leaf's
        step = state["step"] + 1
        t = step.to(torch.float32)
        if bias_correction:
            c1 = 1.0 - b1 ** t
            c2 = 1.0 - b2 ** t
        else:
            c1 = c2 = 1.0

        def upd(g, m, v, p):
            # the same elementwise operations in the same order, written
            # into fresh temporaries where it saves a leaf-sized buffer
            # (a 1.9 B-parameter model's largest leaf is 3.6 GB)
            g32 = g.to(torch.float32)
            m = (b1 * m).add_((1 - b1) * g32)
            v = (b2 * v).add_(((1 - b2) * g32).mul_(g32))
            u = (m / c1).div_((v / c2).sqrt_().add_(eps))
            p32 = p.to(torch.float32)
            if weight_decay and adamw_mode:
                u = u.add_(weight_decay * p32)
            return (p32 - u.mul_(lr)).to(p.dtype), m, v

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


def lamb(lr_default: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-6,
         weight_decay: float = 0.0, max_coeff: float = 10.0,
         min_coeff: float = 0.01) -> Optimizer:
    b1, b2 = betas

    def init(params):
        dev = next(tree_leaves(params)).device
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "m": _zeros_like_f32(params),
                "v": _zeros_like_f32(params)}

    def apply(grads, state, params, lr, leaf_sums=None):
        step = state["step"] + 1

        def moments(g, m, v, p):
            g32 = g.to(torch.float32)
            m = b1 * m + (1 - b1) * g32
            v = b2 * v + (1 - b2) * g32 * g32
            u = m / (torch.sqrt(v) + eps)
            p32 = p.to(torch.float32)
            if weight_decay:
                u = u + weight_decay * p32
            return m, v, u, p32

        out = tree_map(moments, grads, state["m"], state["v"], params)
        # sum(p32^2) and sum(u^2) of the piece of each leaf this rank
        # holds, made whole-leaf sums in one call (one all-reduce an axis
        # group under ZeRO, a model or a pipe axis)
        sq = tree_map(lambda o: torch.stack([torch.sum(o[3] * o[3]),
                                             torch.sum(o[2] * o[2])]), out)
        if leaf_sums is not None:
            sq = leaf_sums(sq)

        def upd(o, s, p):
            m, v, u, p32 = o
            # the trust ratio of the whole leaf (every layer of a
            # stacked leaf), selected on the device
            w_norm, u_norm = torch.sqrt(s[0]), torch.sqrt(s[1])
            ratio = torch.where(
                (w_norm > 0) & (u_norm > 0),
                torch.clamp(w_norm / u_norm, min_coeff, max_coeff),
                torch.ones_like(w_norm))
            return (p32 - lr * ratio * u).to(p.dtype), m, v

        out = tree_map(upd, out, sq, params)
        new_params = tree_map(lambda o: o[0], out)
        new_m = tree_map(lambda o: o[1], out)
        new_v = tree_map(lambda o: o[2], out)
        return new_params, {"step": step, "m": new_m, "v": new_v}

    return Optimizer("lamb", init, apply,
                     dict(lr=lr_default, betas=betas, eps=eps,
                          weight_decay=weight_decay))


def sgd(lr_default: float = 1e-2, momentum: float = 0.0,
        weight_decay: float = 0.0, nesterov: bool = False) -> Optimizer:
    def init(params):
        dev = next(tree_leaves(params)).device
        state = {"step": torch.zeros((), dtype=torch.int32, device=dev)}
        if momentum:
            state["mom"] = _zeros_like_f32(params)
        return state

    def apply(grads, state, params, lr, leaf_sums=None):
        del leaf_sums  # elementwise
        step = state["step"] + 1

        def upd(g, p, buf=None):
            g32 = g.to(torch.float32)
            p32 = p.to(torch.float32)
            if weight_decay:
                g32 = g32 + weight_decay * p32
            if buf is not None:
                buf = momentum * buf + g32
                g32 = (g32 + momentum * buf) if nesterov else buf
                return (p32 - lr * g32).to(p.dtype), buf
            return (p32 - lr * g32).to(p.dtype)

        if momentum:
            out = tree_map(upd, grads, params, state["mom"])
            return (tree_map(lambda o: o[0], out),
                    {"step": step, "mom": tree_map(lambda o: o[1], out)})
        return tree_map(upd, grads, params), {"step": step}

    return Optimizer("sgd", init, apply,
                     dict(lr=lr_default, momentum=momentum))


def adagrad(lr_default: float = 1e-2, eps: float = 1e-10,
            weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        dev = next(tree_leaves(params)).device
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "sq": _zeros_like_f32(params)}

    def apply(grads, state, params, lr, leaf_sums=None):
        del leaf_sums  # elementwise
        step = state["step"] + 1

        def upd(g, sq, p):
            g32 = g.to(torch.float32)
            p32 = p.to(torch.float32)
            if weight_decay:
                g32 = g32 + weight_decay * p32
            sq = sq + g32 * g32
            return (p32 - lr * g32 / (torch.sqrt(sq) + eps)).to(p.dtype), sq

        out = tree_map(upd, grads, state["sq"], params)
        return (tree_map(lambda o: o[0], out),
                {"step": step, "sq": tree_map(lambda o: o[1], out)})

    return Optimizer("adagrad", init, apply, dict(lr=lr_default, eps=eps))


def get_optimizer(name: str, **params) -> Optimizer:
    """Name dispatch of the JAX package's ``get_optimizer``: the same
    names, defaults and unknown-key error."""
    name_l = name.lower()
    lr = params.pop("lr", None)
    betas = params.pop("betas", (0.9, 0.999))
    if isinstance(betas, list):
        betas = tuple(betas)

    def done(opt):
        if params:
            raise ValueError(
                f"Unknown parameter(s) for optimizer {name}: "
                f"{sorted(params)}")
        return opt

    if name_l in ("adam", "adamw", "fusedadam", "cpuadam",
                  "deepspeedcpuadam"):
        return done(adam(
            lr if lr is not None else 1e-3, betas,
            params.pop("eps", 1e-8), params.pop("weight_decay", 0.0),
            adamw_mode=params.pop("adam_w_mode", name_l != "adam"),
            bias_correction=params.pop("bias_correction", True)))
    if name_l in ("lamb", "fusedlamb"):
        return done(lamb(
            lr if lr is not None else 1e-3, betas,
            params.pop("eps", 1e-6), params.pop("weight_decay", 0.0),
            params.pop("max_coeff", 10.0), params.pop("min_coeff", 0.01)))
    if name_l == "sgd":
        return done(sgd(
            lr if lr is not None else 1e-2, params.pop("momentum", 0.0),
            params.pop("weight_decay", 0.0), params.pop("nesterov", False)))
    if name_l in ("adagrad", "cpuadagrad"):
        return done(adagrad(
            lr if lr is not None else 1e-2, params.pop("eps", 1e-10),
            params.pop("weight_decay", 0.0)))
    if name_l in ("onebitadam", "onebitlamb", "zerooneadam"):
        raise NotImplementedError(
            f"optimizer {name}: the 1-bit optimizers (ROADMAP.md queue A "
            f"item 7 part 7), not in the PyTorch port yet")
    raise ValueError(f"Unknown optimizer: {name}")


def wrap_torch(factory: Callable) -> Optimizer:
    """A client ``torch.optim.Optimizer`` as an :class:`Optimizer`, the
    counterpart of the JAX package's ``wrap_optax``.  ``factory`` is an
    optimizer class or any callable that builds one from a list of
    tensors (``functools.partial(torch.optim.SGD, lr=0.1)``); its
    learning rate is its own, so the engine's schedule does not apply
    (``hyperparams["external_lr"]``).

    ``apply`` stays out of place: each call steps fresh copies of the
    params with the factory's optimizer, loaded with copies of the
    per-leaf state, so the old params and state are left as they were
    and a skipped step can keep them.  The state is ``{"step", "torch":
    {leaf index: the optimizer's state of that leaf}}``; it is empty
    until the first step builds it, as ``torch.optim`` builds it."""

    def init(params):
        dev = next(tree_leaves(params)).device
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "torch": {}}

    def apply(grads, state, params, lr, leaf_sums=None):
        # the factory's optimizer holds its own rate; it steps whatever
        # tensors it is handed (under ZeRO this rank's master shards, as
        # the reference hands a client optimizer its fp32 partition)
        del lr, leaf_sums
        work = [p.detach().clone() for p in tree_leaves(params)]
        for w, g in zip(work, tree_leaves(grads)):
            w.grad = g.to(w.dtype)
        opt = factory(work)
        for i, w in enumerate(work):
            old = state["torch"].get(str(i))
            if old:
                opt.state[w] = {k: v.clone() if isinstance(v, torch.Tensor)
                                else v for k, v in old.items()}
        opt.step()
        for w in work:
            w.grad = None
        new = {str(i): dict(opt.state[w]) for i, w in enumerate(work)
               if opt.state.get(w)}
        it = iter(work)
        return (tree_map(lambda _: next(it), params),
                {"step": state["step"] + 1, "torch": new})

    return Optimizer(getattr(factory, "__name__", "torch"), init, apply,
                     {"external_lr": True})
