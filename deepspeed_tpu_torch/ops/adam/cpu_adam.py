"""Host CPU Adam/Adagrad for the offload tiers.

Counterpart of ``deepspeed_tpu/ops/adam/cpu_adam.py`` (``DeepSpeedCPUAdam``,
``DeepSpeedCPUAdagrad``): the optimizer state as host numpy arrays,
stepped in place by the native library ``csrc/cpu_adam.cpp`` (the JAX
package's source, built by ``g++`` at first use through
``ops/build.py::load_host_library``).  Each step can also emit the bf16
device copy in the same sweep.

A failed build raises: nothing falls back.  ``impl="plain"`` runs the
plain PyTorch version of the same update over CPU tensors instead; it is
the oracle the native library is held to, and runs only when a caller
asks for it.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..build import load_host_library

_C_F32 = ctypes.POINTER(ctypes.c_float)
_C_U16 = ctypes.POINTER(ctypes.c_uint16)

#: the two implementations of a step
IMPLS = ("native", "plain")


def _lib() -> ctypes.CDLL:
    """The native library with its argument types (built at first use;
    raises when it cannot be built)."""
    lib = load_host_library("cpu_adam")
    lib.ds_adam_step.argtypes = [
        ctypes.c_int64, _C_F32, _C_F32, _C_F32, _C_F32,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int, _C_U16]
    lib.ds_adagrad_step.argtypes = [
        ctypes.c_int64, _C_F32, _C_F32, _C_F32,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        _C_U16]
    lib.ds_f32_to_bf16.argtypes = [ctypes.c_int64, _C_F32, _C_U16]
    lib.ds_adam_step_g16.argtypes = [
        ctypes.c_int64, _C_F32, _C_F32, _C_F32, _C_U16,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int, _C_U16]
    lib.ds_accum_g16.argtypes = [ctypes.c_int64, _C_F32, _C_U16]
    return lib


def _ptr(a: np.ndarray, typ):
    return a.ctypes.data_as(typ)


#: leaves past this many bytes have their host pages faulted in by
#: several threads before the copy (one thread faults ~1-2 GB/s)
PREFAULT_BYTES = 256 << 20


def prefault(a: np.ndarray, threads: int = 8) -> None:
    """Touch every page of ``a`` from ``threads`` threads at once (numpy
    drops the GIL over each range); its contents become zero."""
    from concurrent.futures import ThreadPoolExecutor
    flat = a.reshape(-1).view(np.uint8)
    step = max(flat.size // (threads * 8), 1 << 20)
    with ThreadPoolExecutor(threads) as ex:
        list(ex.map(lambda i: np.bitwise_and(
            flat[i:i + step], 0, out=flat[i:i + step]),
            range(0, flat.size, step)))


def host_f32(leaf) -> np.ndarray:
    """A fresh, writable, C-contiguous float32 host copy of ``leaf`` (a
    tensor on any device, or an array)."""
    if isinstance(leaf, torch.Tensor):
        out = np.empty(tuple(leaf.shape), np.float32)
        if out.nbytes >= PREFAULT_BYTES:
            prefault(out)
        torch.from_numpy(out).copy_(leaf.detach())
        return out
    return np.array(leaf, dtype=np.float32, order="C")


def bf16_bits(a: np.ndarray) -> np.ndarray:
    """float32 → bf16 bits (uint16), rounded to nearest even, as the
    native ``f32_to_bf16``."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    """bf16 bits (uint16) → float32 values (exact)."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _grad_f32(g: np.ndarray) -> np.ndarray:
    """A float32 gradient from f32 values or bf16 bits (uint16)."""
    if g.dtype == np.uint16:
        return bf16_to_f32(g)
    return np.ascontiguousarray(g, dtype=np.float32)


def plain_adam_update(p: np.ndarray, m: np.ndarray, v: np.ndarray,
                      g: np.ndarray, lr: float, betas: Tuple[float, float],
                      eps: float, weight_decay: float, step: int,
                      grad_scale: float, adamw: bool,
                      out_bf16: Optional[np.ndarray] = None) -> None:
    """The plain PyTorch Adam/AdamW update over CPU tensors, in place on
    ``p``, ``m``, ``v`` (views of the numpy arrays): the native
    ``ds_adam_step``'s arithmetic in float32 (``g`` float32 or bf16
    bits)."""
    b1, b2 = betas
    tp, tm, tv = (torch.from_numpy(a) for a in (p, m, v))
    grad = torch.from_numpy(_grad_f32(g)) * (1.0 / grad_scale)
    if not adamw and weight_decay:
        grad = grad + weight_decay * tp
    tm.mul_(b1).add_((1.0 - b1) * grad)
    tv.mul_(b2).add_((1.0 - b2) * grad * grad)
    c1 = 1.0 - b1 ** step
    c2 = 1.0 - b2 ** step
    u = (tm / c1) / (torch.sqrt(tv / c2) + eps)
    if adamw and weight_decay:
        u = u + weight_decay * tp
    tp.sub_(lr * u)
    if out_bf16 is not None:
        out_bf16[:] = bf16_bits(p)


def plain_adagrad_update(p: np.ndarray, sq: np.ndarray, g: np.ndarray,
                         lr: float, eps: float, weight_decay: float,
                         grad_scale: float,
                         out_bf16: Optional[np.ndarray] = None) -> None:
    """The plain PyTorch Adagrad update (the native
    ``ds_adagrad_step``'s arithmetic) in place on ``p``, ``sq``."""
    tp, ts = torch.from_numpy(p), torch.from_numpy(sq)
    grad = torch.from_numpy(_grad_f32(g)) * (1.0 / grad_scale)
    if weight_decay:
        grad = grad + weight_decay * tp
    ts.add_(grad * grad)
    tp.sub_(lr * grad / (torch.sqrt(ts) + eps))
    if out_bf16 is not None:
        out_bf16[:] = bf16_bits(p)


def _check_impl(impl: str) -> Optional[ctypes.CDLL]:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return _lib() if impl == "native" else None


class DeepSpeedCPUAdam:
    """Flat-leaf host Adam.  ``leaves``: the master params (tensors or
    arrays), copied into float32 host arrays stepped in place; the moments
    are allocated here."""

    def __init__(self, leaves: Iterable, lr: float = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 adamw_mode: bool = True, impl: str = "native"):
        self._lib = _check_impl(impl)
        self.impl = impl
        self.master: List[np.ndarray] = [host_f32(l) for l in leaves]
        self.m = [np.zeros_like(l) for l in self.master]
        self.v = [np.zeros_like(l) for l in self.master]
        self.lr, self.betas, self.eps = lr, tuple(betas), eps
        self.weight_decay, self.adamw_mode = weight_decay, adamw_mode
        self.step_count = 0

    def step(self, grads: List[np.ndarray], lr: Optional[float] = None,
             grad_scale: float = 1.0,
             out_bf16: Optional[List[np.ndarray]] = None) -> None:
        """In-place update of every leaf.  ``grad_scale`` divides the
        grads (loss scale x micro batches x clip, folded into the sweep);
        ``out_bf16``: optional uint16 buffers receiving the bf16 copies of
        the updated params."""
        lr = self.lr if lr is None else float(lr)
        self.step_count += 1
        for i, g in enumerate(grads):
            self.step_one(i, g, lr=lr, grad_scale=grad_scale,
                          out_bf16=out_bf16[i] if out_bf16 is not None
                          else None)

    def step_one(self, i: int, g: np.ndarray, lr: float,
                 grad_scale: float = 1.0,
                 out_bf16: Optional[np.ndarray] = None,
                 span: Optional[Tuple[int, int]] = None) -> None:
        """Update leaf ``i`` only (elements ``span`` of its flat view when
        given; ``g`` and ``out_bf16`` then cover the span): the bucketed
        sweeps advance ``step_count`` once themselves, then call this per
        piece."""
        p, m, v = (a.reshape(-1) for a in (self.master[i], self.m[i],
                                           self.v[i]))
        if span is not None:
            p, m, v = p[span[0]:span[1]], m[span[0]:span[1]], \
                v[span[0]:span[1]]
        g = g.reshape(-1)
        ob = None if out_bf16 is None else out_bf16.reshape(-1)
        if self._lib is None:
            plain_adam_update(p, m, v, g, lr, self.betas, self.eps,
                              self.weight_decay, self.step_count, grad_scale,
                              self.adamw_mode, ob)
            return
        b1, b2 = self.betas
        if g.dtype == np.uint16:
            self._lib.ds_adam_step_g16(
                p.size, _ptr(p, _C_F32), _ptr(m, _C_F32), _ptr(v, _C_F32),
                _ptr(np.ascontiguousarray(g), _C_U16), lr, b1, b2, self.eps,
                self.weight_decay, self.step_count, grad_scale,
                int(self.adamw_mode),
                _ptr(ob, _C_U16) if ob is not None else _C_U16())
            return
        g = np.ascontiguousarray(g, dtype=np.float32)
        self._lib.ds_adam_step(
            p.size, _ptr(p, _C_F32), _ptr(m, _C_F32), _ptr(v, _C_F32),
            _ptr(g, _C_F32), lr, b1, b2, self.eps, self.weight_decay,
            self.step_count, grad_scale, int(self.adamw_mode),
            _ptr(ob, _C_U16) if ob is not None else _C_U16())

    def state_arrays(self) -> Dict[str, List[np.ndarray]]:
        return {"master": self.master, "m": self.m, "v": self.v}

    def load_state_arrays(self, state: Dict[str, List[np.ndarray]],
                          step_count: int) -> None:
        for name in ("master", "m", "v"):
            for d, s in zip(getattr(self, name), state[name]):
                np.copyto(d, np.asarray(s, dtype=np.float32).reshape(d.shape))
        self.step_count = step_count


class DeepSpeedCPUAdagrad:
    """Host Adagrad over flat leaves (``ds_adagrad_step``)."""

    def __init__(self, leaves: Iterable, lr: float = 1e-2,
                 eps: float = 1e-10, weight_decay: float = 0.0,
                 impl: str = "native"):
        self._lib = _check_impl(impl)
        self.impl = impl
        self.master = [host_f32(l) for l in leaves]
        self.sq = [np.zeros_like(l) for l in self.master]
        self.lr, self.eps, self.weight_decay = lr, eps, weight_decay
        self.step_count = 0

    def step(self, grads, lr=None, grad_scale: float = 1.0,
             out_bf16=None) -> None:
        lr = self.lr if lr is None else float(lr)
        self.step_count += 1
        for i, g in enumerate(grads):
            self.step_one(i, g, lr=lr, grad_scale=grad_scale,
                          out_bf16=out_bf16[i] if out_bf16 is not None
                          else None)

    def step_one(self, i: int, g, lr: float, grad_scale: float = 1.0,
                 out_bf16=None, span: Optional[Tuple[int, int]] = None
                 ) -> None:
        p, sq = self.master[i].reshape(-1), self.sq[i].reshape(-1)
        if span is not None:
            p, sq = p[span[0]:span[1]], sq[span[0]:span[1]]
        g = g.reshape(-1)
        ob = None if out_bf16 is None else out_bf16.reshape(-1)
        if self._lib is None:
            plain_adagrad_update(p, sq, g, lr, self.eps, self.weight_decay,
                                 grad_scale, ob)
            return
        g = _grad_f32(g)
        self._lib.ds_adagrad_step(
            p.size, _ptr(p, _C_F32), _ptr(sq, _C_F32), _ptr(g, _C_F32), lr,
            self.eps, self.weight_decay, grad_scale,
            _ptr(ob, _C_U16) if ob is not None else _C_U16())

    def state_arrays(self):
        return {"master": self.master, "sq": self.sq}

    def load_state_arrays(self, state, step_count):
        for name in ("master", "sq"):
            for d, s in zip(getattr(self, name), state[name]):
                np.copyto(d, np.asarray(s, dtype=np.float32).reshape(d.shape))
        self.step_count = step_count


def accum_bf16(acc: np.ndarray, g16: np.ndarray, lib=None) -> None:
    """``acc += g16`` (float32 += bf16 bits): the native ``ds_accum_g16``,
    or its plain version without ``lib``."""
    if lib is None:
        acc += bf16_to_f32(g16)
        return
    lib.ds_accum_g16(acc.size, _ptr(acc, _C_F32),
                     _ptr(np.ascontiguousarray(g16), _C_U16))
