"""Weights and train states between the JAX package and the port.

The JAX ``TransformerLM.init`` tree (after ``jax.device_get``: nested
dicts of numpy arrays, block leaves stacked on the leading layer axis
for ``lax.scan``) and the port's tree have the same paths, shapes and
layouts, so the bridge is a leaf-by-leaf numpy <-> torch map.  bfloat16
arrays (``ml_dtypes.bfloat16`` on the numpy side) cross bit-exactly
through their 16-bit patterns.  A train state crosses as its counters
(``step``, ``skipped``, the optimizer's ``step``) plus three trees of the
params' shape (``params``, ``opt.m``, ``opt.v``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

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
    """``fn`` applied to every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(v, fn) for k, v in tree.items()}
    return fn(tree)


def check_params(model: TransformerLM, params: Dict[str, Any]) -> None:
    """Raise ``ValueError`` naming the first path whose presence or shape
    differs from the tree ``model`` expects."""
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
    walk(model.param_shapes(), params, "")


def params_from_jax(tree: Dict[str, Any], model: TransformerLM,
                    device="cpu", dtype: Optional[torch.dtype] = None
                    ) -> Dict[str, torch.Tensor]:
    """JAX params tree (numpy leaves) → the port's tree on ``device``;
    floating leaves cast to ``dtype`` when given.  The host is the
    default because this stages weights, as loading a checkpoint does:
    ``init_inference(params=...)`` places them on the engine's device."""
    check_params(model, tree)
    return tree_map(tree, lambda a: leaf_to_torch(a, device, dtype))


def params_to_jax(params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's tree → numpy leaves in the JAX package's layout."""
    return tree_map(params, _leaf_to_numpy)


def state_from_jax(tree: Dict[str, Any], model: TransformerLM,
                   device="cpu") -> Dict[str, Any]:
    """A JAX train state ``{step, skipped, params, opt: {step, m, v}}``
    (numpy leaves, after ``jax.device_get``) → the port engine's state
    on ``device``: counters as int32 scalars, params and moments as
    given (float32 masters and moments)."""
    for tree_name in ("params", "m", "v"):
        check_params(model, tree[tree_name] if tree_name == "params"
                     else tree["opt"][tree_name])

    def counter(a):
        return torch.tensor(int(np.asarray(a)), dtype=torch.int32,
                            device=device)
    return {"step": counter(tree["step"]),
            "skipped": counter(tree["skipped"]),
            "params": params_from_jax(tree["params"], model, device),
            "opt": {"step": counter(tree["opt"]["step"]),
                    "m": params_from_jax(tree["opt"]["m"], model, device),
                    "v": params_from_jax(tree["opt"]["v"], model, device)}}


def state_to_jax(state: Dict[str, Any]) -> Dict[str, Any]:
    """The port engine's state → numpy leaves in the JAX engine's layout
    (int32 counters as 0-d arrays)."""
    def counter(t):
        return np.asarray(int(t), dtype=np.int32)
    return {"step": counter(state["step"]),
            "skipped": counter(state["skipped"]),
            "params": params_to_jax(state["params"]),
            "opt": {"step": counter(state["opt"]["step"]),
                    "m": params_to_jax(state["opt"]["m"]),
                    "v": params_to_jax(state["opt"]["v"])}}
