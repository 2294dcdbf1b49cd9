"""Slot-partitioned host optimizer: the optimizer half of ZeRO-Infinity.

Counterpart of ``deepspeed_tpu/runtime/swap_tensor/
partitioned_optimizer_swapper.py`` (``SlotOptimizer``): the float32 master
and the Adam moments of each scan layer live in one *slot* of a
``SlotStore`` (DRAM or NVMe, ``slot_store.py``), and the native sweep
(``ds_adam_step_g16`` on bf16 wire gradients, ``ds_adam_step`` on float32
ones, from ``csrc/cpu_adam.cpp``) runs slot by slot while neighbouring
slots stream through the store's pinned-buffer ring.  The bf16 device copy
is emitted by the same sweep into the parameter store's slot.

Slot layout: ``[master | m | v]``, three contiguous float32 spans of
``n_elems`` each, so one aio read or write moves a layer's whole
optimizer state.  ``impl="plain"`` runs the plain PyTorch update instead
of the native library (the oracle; only when asked for).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...ops.adam.cpu_adam import (_C_F32, _C_U16, _check_impl, _ptr,
                                  plain_adam_update)
from .slot_store import SlotStore, make_slot_store


class SlotOptimizer:
    """Adam/AdamW over uniform slots of ``n_elems`` parameters each."""

    STATE_SPANS = 3   # master, m, v

    def __init__(self, n_slots: int, n_elems: int, device: str = "cpu",
                 nvme_path: Optional[str] = None, aio=None,
                 buffer_count: int = 4, lr: float = 1e-3,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, adamw_mode: bool = True,
                 name: str = "opt", impl: str = "native"):
        self._lib = _check_impl(impl)
        self.n_slots, self.n_elems = int(n_slots), int(n_elems)
        self.lr, self.betas, self.eps = lr, tuple(betas), eps
        self.weight_decay, self.adamw_mode = weight_decay, adamw_mode
        self.step_count = 0
        slot_nbytes = self.STATE_SPANS * self.n_elems * 4
        self.store: SlotStore = make_slot_store(
            device, n_slots, slot_nbytes, nvme_path=nvme_path, aio=aio,
            buffer_count=buffer_count, name=name)

    # -- views -------------------------------------------------------------
    def _spans(self, buf: np.ndarray):
        f = buf[:self.STATE_SPANS * self.n_elems * 4].view(np.float32)
        n = self.n_elems
        return f[:n], f[n:2 * n], f[2 * n:3 * n]

    # -- lifecycle ---------------------------------------------------------
    def init_slot(self, slot: int, master_f32) -> None:
        """The slot's master from ``master_f32`` (an array, or a float32
        tensor on any device, copied straight into the slot), moments
        zero."""
        buf = self.store.acquire(slot)
        p, m, v = self._spans(buf)
        if isinstance(master_f32, torch.Tensor):
            torch.from_numpy(p).copy_(master_f32.reshape(-1))
        else:
            p[:] = master_f32.reshape(-1)
        m[:] = 0.0
        v[:] = 0.0
        self.store.release(slot, dirty=True)

    def master(self, slot: int) -> np.ndarray:
        """A copy of the slot's float32 master vector."""
        buf = self.store.acquire(slot)
        out = self._spans(buf)[0].copy()
        self.store.release(slot, dirty=False)
        return out

    def state(self, slot: int):
        buf = self.store.acquire(slot)
        out = tuple(a.copy() for a in self._spans(buf))
        self.store.release(slot, dirty=False)
        return out

    def load_state(self, slot: int, p: np.ndarray, m: np.ndarray,
                   v: np.ndarray) -> None:
        buf = self.store.acquire(slot)
        for dst, src in zip(self._spans(buf), (p, m, v)):
            dst[:] = src.reshape(-1)
        self.store.release(slot, dirty=True)

    # -- the sweep ---------------------------------------------------------
    def prefetch(self, slot: int) -> None:
        self.store.prefetch(slot)

    def step_slot(self, slot: int, grad: np.ndarray, lr: float,
                  grad_scale: float = 1.0,
                  out_bf16: Optional[np.ndarray] = None) -> None:
        """One layer's Adam update.  ``step_count`` must have been
        advanced by :meth:`begin_step` for this optimizer step.  ``grad``:
        a float32 vector, or a uint16 vector of bf16 bits (the Infinity
        grad stream's format, widened inline by the native sweep);
        ``out_bf16``: a uint16 view (the parameter store's slot) that
        receives the updated bf16 params."""
        buf = self.store.acquire(slot)
        p, m, v = self._spans(buf)
        g = grad.reshape(-1)
        b1, b2 = self.betas
        ob = _ptr(out_bf16, _C_U16) if out_bf16 is not None else _C_U16()
        if self._lib is None:
            plain_adam_update(p, m, v, g, lr, self.betas, self.eps,
                              self.weight_decay, self.step_count, grad_scale,
                              self.adamw_mode, out_bf16)
        elif g.dtype == np.uint16:
            self._lib.ds_adam_step_g16(
                p.size, _ptr(p, _C_F32), _ptr(m, _C_F32), _ptr(v, _C_F32),
                _ptr(np.ascontiguousarray(g), _C_U16), lr, b1, b2, self.eps,
                self.weight_decay, self.step_count, grad_scale,
                int(self.adamw_mode), ob)
        else:
            g = np.ascontiguousarray(g, dtype=np.float32)
            self._lib.ds_adam_step(
                p.size, _ptr(p, _C_F32), _ptr(m, _C_F32), _ptr(v, _C_F32),
                _ptr(g, _C_F32), lr, b1, b2, self.eps, self.weight_decay,
                self.step_count, grad_scale, int(self.adamw_mode), ob)
        self.store.release(slot, dirty=True)

    def begin_step(self) -> int:
        self.step_count += 1
        return self.step_count

    def flush(self) -> None:
        self.store.flush()

    def close(self) -> None:
        self.store.close()

    @property
    def host_bytes(self) -> int:
        return self.store.host_bytes

    @property
    def disk_bytes(self) -> int:
        return self.store.disk_bytes
