"""Weights and train states between the JAX package and the port.

The JAX ``TransformerLM.init`` tree (after ``jax.device_get``: nested
dicts of numpy arrays, block leaves stacked on the leading layer axis
for ``lax.scan``) and the port's tree have the same paths, shapes and
layouts for every family (``ln_embed``, ``type_embed``, ``mlm_head``,
GPT-J's ``lm_head.bias`` and an MoE model's superblocks ``blocks.dense``
/ ``blocks.moe_blk.moe.{gate, experts, residual_mlp, coefficient}``
included), so the bridge is a leaf-by-leaf numpy <-> torch map.  bfloat16
arrays (``ml_dtypes.bfloat16`` on the numpy side) cross bit-exactly
through their 16-bit patterns.  A train state crosses as its counters
(``step``, ``skipped``, the optimizer's ``step``) plus the trees of the
params' shape: ``params`` and the optimizer's (Adam's and LAMB's ``m``
and ``v``, SGD's momentum ``mom``, Adagrad's sums ``sq``); a checkpoint
of the port holds the same state tree (``runtime/checkpoint_engine``).

Tensor parallelism crosses the same trees: ``tp_slice`` cuts a whole
tree into a model rank's slice by the model's partition rule
(``tp_dims`` of ``TransformerLM.partition_specs``) and ``tp_gather``
puts the slices back together, so checkpoints and tests always see the
whole tree in the JAX layout.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..runtime.fp16.loss_scaler import LossScaleState
from .transformer import TransformerLM


def leaf_to_torch(a: Any, device, dtype: Optional[torch.dtype] = None
                  ) -> torch.Tensor:
    """One numpy (or array-like) leaf as a tensor on ``device``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes    # only where a bf16 leaf must cross
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def tree_map(tree, fn):
    """``fn`` applied to every leaf of nested dicts (and lists: the
    diffusion family's blocks)."""
    if isinstance(tree, dict):
        return {k: tree_map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(v, fn) for v in tree]
    return fn(tree)


def check_params(model: TransformerLM, params: Dict[str, Any]) -> None:
    """Raise ``ValueError`` naming the first path whose presence or shape
    differs from the tree ``model`` expects (``lm_head.bias`` is the one
    optional leaf: GPT-J's head carries it)."""
    def walk(want, got, path):
        if isinstance(want, dict):
            if not isinstance(got, dict):
                raise ValueError(f"params{path}: expected a subtree")
            missing = sorted(set(want) - set(got))
            extra = sorted(set(got) - set(want))
            if missing or extra:
                raise ValueError(f"params{path}: missing {missing}, "
                                 f"unexpected {extra}")
            for k in want:
                walk(want[k], got[k], f"{path}.{k}")
        elif tuple(got.shape) != tuple(want):
            raise ValueError(f"params{path}: shape {tuple(got.shape)} != "
                             f"{tuple(want)}")
    head_bias = "bias" in (params.get("lm_head") or {})
    walk(model.param_shapes(head_bias=head_bias), params, "")


def params_from_jax(tree: Dict[str, Any], model: TransformerLM,
                    device="cpu", dtype: Optional[torch.dtype] = None
                    ) -> Dict[str, torch.Tensor]:
    """JAX params tree (numpy leaves) → the port's tree on ``device``;
    floating leaves cast to ``dtype`` when given.  The host is the
    default because this stages weights, as loading a checkpoint does:
    ``init_inference(params=...)`` places them on the engine's device."""
    check_params(model, tree)
    return tree_map(tree, lambda a: leaf_to_torch(a, device, dtype))


def tp_dims(specs) -> Dict[str, Any]:
    """A spec tree (``TransformerLM.partition_specs``) → each leaf's
    model-sharded dim, or None where it is replicated over ``model``."""
    def dim(spec):
        return spec.index("model") if "model" in spec else None
    if isinstance(specs, dict):
        return {k: tp_dims(v) for k, v in specs.items()}
    return dim(specs)


def tp_slice(tree: Dict[str, Any], dims: Dict[str, Any], mp: int,
             index: int) -> Dict[str, Any]:
    """Model shard ``index`` of ``mp`` of a whole tree (tensors or numpy
    leaves): each leaf's contiguous chunk ``index`` along its dim in
    ``dims`` (``tp_dims``), a contiguous tensor of its own; a replicated
    leaf as it is."""
    def one(t, d):
        if d is None or mp == 1:
            return t
        if t.shape[d] % mp:
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not divide "
                             f"over {mp} model shards")
        if not isinstance(t, torch.Tensor):
            return np.ascontiguousarray(np.split(t, mp, axis=d)[index])
        return t.chunk(mp, d)[index].clone(
            memory_format=torch.contiguous_format)
    return _zip(one, tree, dims)


def tp_gather(tree: Dict[str, Any], dims: Dict[str, Any],
              axis: str = "model") -> Dict[str, Any]:
    """The whole tree from every model shard's slice (a collective over
    ``axis``: every rank of it calls it)."""
    from .. import comm

    def one(t, d):
        return t if d is None else comm.all_gather(t, axis, axis=d)
    return _zip(one, tree, dims)


def _zip(fn, tree, other):
    if isinstance(tree, dict):
        return {k: _zip(fn, v, other[k]) for k, v in tree.items()}
    return fn(tree, other)


def params_to_jax(params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's tree → numpy leaves in the JAX package's layout."""
    return tree_map(params, _leaf_to_numpy)


#: the optimizer state trees of the params' shape: Adam's and LAMB's
#: moments, SGD's momentum, Adagrad's sums of squares
OPT_TREES = ("m", "v", "mom", "sq")


def _opt_keys(opt: Dict[str, Any]) -> list:
    extra = sorted(set(opt) - set(OPT_TREES) - {"step"})
    if extra:
        raise ValueError(f"optimizer state keys {extra} do not cross to the "
                         f"JAX package (a client optimizer's own state)")
    return [k for k in OPT_TREES if k in opt]


def state_from_jax(tree: Dict[str, Any], model: TransformerLM,
                   device="cpu") -> Dict[str, Any]:
    """A JAX train state ``{step, skipped, params, opt: {step, ...}}``
    (numpy leaves, after ``jax.device_get``; with fp16 also ``scaler``)
    → the port engine's state on ``device``: counters as int32 scalars,
    params and the optimizer's trees (``OPT_TREES``) as given (float32
    masters and moments), the loss scaler's state as a
    :class:`LossScaleState`."""
    keys = _opt_keys(tree["opt"])
    check_params(model, tree["params"])
    for k in keys:
        check_params(model, tree["opt"][k])

    def counter(a):
        return torch.tensor(int(np.asarray(a)), dtype=torch.int32,
                            device=device)
    opt = {"step": counter(tree["opt"]["step"])}
    for k in keys:
        opt[k] = params_from_jax(tree["opt"][k], model, device)
    state = {"step": counter(tree["step"]),
             "skipped": counter(tree["skipped"]),
             "params": params_from_jax(tree["params"], model, device),
             "opt": opt}
    if "scaler" in tree:                # fp16: (scale, good_steps, hysteresis)
        scale, good, hys = (np.asarray(a) for a in tree["scaler"])
        state["scaler"] = LossScaleState(
            torch.tensor(float(scale), dtype=torch.float32, device=device),
            counter(good), counter(hys))
    return state


def state_to_jax(state: Dict[str, Any]) -> Dict[str, Any]:
    """The port engine's state → numpy leaves in the JAX engine's layout
    (int32 counters as 0-d arrays)."""
    def counter(t):
        return np.asarray(int(t), dtype=np.int32)
    opt = {"step": counter(state["opt"]["step"])}
    for k in _opt_keys(state["opt"]):
        opt[k] = params_to_jax(state["opt"][k])
    out = {"step": counter(state["step"]),
           "skipped": counter(state["skipped"]),
           "params": params_to_jax(state["params"]),
           "opt": opt}
    if "scaler" in state:               # as the JAX LossScaleState's fields
        sc = state["scaler"]
        out["scaler"] = (np.asarray(float(sc.scale), dtype=np.float32),
                         counter(sc.good_steps), counter(sc.hysteresis))
    return out
