"""ZeRO-Offload tier 1: optimizer state and float32 masters in host memory.

Counterpart of ``deepspeed_tpu/runtime/zero/offload.py``:

* the device holds only the compute-dtype parameters and the float32
  gradient sum; the float32 masters and the Adam (or Adagrad) moments are
  host numpy arrays stepped by the native library ``csrc/cpu_adam.cpp``
  (``ops/adam/cpu_adam.py``), 12 host bytes against 2 device bytes a
  parameter;
* the host folds loss scale x micro batches x clip factor into the sweep's
  one gradient multiply, and the same sweep emits the bf16 copies that go
  back to the device;
* fp16 dynamic loss scaling runs its state machine on the host
  (:class:`HostLossScaler`, the same semantics as ``runtime/fp16``).

:meth:`ZeroOffloadHostOptimizer.step_pipelined` walks the gradient in
pieces of about ``bucket_bytes`` (``[a, b)`` spans of the leaves'
concatenation, so a stacked leaf of gigabytes is cut too) with three lanes
in flight: piece i+1's device-to-host fetch, piece i's native sweep on one
worker thread (ctypes releases the GIL) and piece i-1's host-to-device
upload.  On a card the fetch and the upload are ``non_blocking`` copies on
a side stream through a small ring of pinned host buffers: the host reads
a grad buffer only after its copy's event has completed, and refills an
upload buffer only after its copy's event has completed.  On the CPU
(``device="cpu"``) pinning and the side stream are skipped because the
CPU was asked for.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...observability import get_registry, trace_span
from ...ops.adam.cpu_adam import DeepSpeedCPUAdagrad, DeepSpeedCPUAdam

#: optimizer names the host sweep takes (the JAX package's)
ADAM_NAMES = ("adam", "adamw", "fusedadam", "cpuadam", "deepspeedcpuadam")
ADAGRAD_NAMES = ("adagrad", "cpuadagrad")

#: pinned buffers in each ring (grads down, params up)
RING = 3


class HostLossScaler:
    """Host-side mirror of DynamicLossScaler's state machine."""

    def __init__(self, scaler):
        self.scale = float(scaler.initial_scale)
        self.window = scaler.scale_window
        self.min_scale = scaler.min_scale
        self.factor = scaler.scale_factor
        self.hysteresis0 = scaler.hysteresis
        self.hysteresis = scaler.hysteresis
        self.good_steps = 0
        self.detect_overflow = scaler.detect_overflow

    def update(self, overflow: bool) -> None:
        if overflow:
            self.hysteresis = max(self.hysteresis - 1, 0)
            if self.hysteresis <= 0:
                self.scale = max(self.scale / self.factor, self.min_scale)
                self.hysteresis = self.hysteresis0
            self.good_steps = 0
        else:
            self.good_steps += 1
            if self.good_steps >= self.window:
                self.scale *= self.factor
                self.good_steps = 0
                self.hysteresis = self.hysteresis0


def host_optimizer(cfg, leaves):
    """The host optimizer the config names over ``leaves`` (Adam/AdamW
    or Adagrad), and its configured lr."""
    oc = cfg.optimizer
    name = (oc.type if oc is not None else "adamw").lower()
    params = dict(oc.params) if oc is not None else {}
    lr = params.pop("lr", 1e-3)
    if name in ADAM_NAMES:
        betas = params.pop("betas", (0.9, 0.999))
        return DeepSpeedCPUAdam(
            leaves, lr=lr, betas=tuple(betas), eps=params.pop("eps", 1e-8),
            weight_decay=params.pop("weight_decay", 0.0),
            adamw_mode=params.pop("adam_w_mode", name != "adam")), lr
    if name in ADAGRAD_NAMES:
        return DeepSpeedCPUAdagrad(
            leaves, lr=lr, eps=params.pop("eps", 1e-10),
            weight_decay=params.pop("weight_decay", 0.0)), lr
    raise NotImplementedError(
        f"offload_optimizer supports Adam/AdamW/Adagrad, got {name} "
        f"(reference cpu_offload has the same restriction)")


class Piece:
    """One bucket of the pipelined sweep: ``[lo, hi)`` of the leaves'
    concatenation, as segments ``(leaf, a, b, offset in the piece)``."""

    __slots__ = ("lo", "hi", "segments")

    def __init__(self, lo: int, hi: int, segments):
        self.lo, self.hi, self.segments = lo, hi, segments


def plan_pieces(sizes: Sequence[int], piece_elems: int) -> List[Piece]:
    """Cut the concatenation of leaves of ``sizes`` into pieces of
    ``piece_elems`` elements (the last one shorter)."""
    offsets = np.cumsum([0] + list(sizes)).tolist()
    total = offsets[-1]
    pieces = []
    for lo in range(0, total, piece_elems):
        hi = min(lo + piece_elems, total)
        segs = []
        for k, (o, n) in enumerate(zip(offsets, sizes)):
            a, b = max(lo, o), min(hi, o + n)
            if a < b:
                segs.append((k, a - o, b - o, a - lo))
        pieces.append(Piece(lo, hi, segs))
    return pieces


class Transfers:
    """The copy lane between a device and host memory: on a card a side
    stream and rings of pinned buffers, each copy followed by an event the
    host waits on before it touches the buffer; on the CPU plain
    arrays."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self._rings: Dict[Tuple[str, torch.dtype, int], torch.Tensor] = {}
        self.d2h_bytes = 0
        self.h2d_bytes = 0

    def buffer(self, name: str, slot: int, n: int,
               dtype: torch.dtype) -> torch.Tensor:
        """Host buffer ``slot`` of ring ``name`` (at least ``n`` elements
        of ``dtype``; pinned on a card), grown on demand."""
        key = (name, dtype, slot)
        buf = self._rings.get(key)
        if buf is None or buf.numel() < n:
            buf = self._rings[key] = torch.empty(n, dtype=dtype,
                                                 pin_memory=self.cuda)
        return buf[:n]

    def after_compute(self) -> None:
        """Order the copy stream after the work queued so far."""
        if self.cuda:
            self.stream.wait_stream(torch.cuda.current_stream(self.device))

    def to_host(self, dst: torch.Tensor, src: torch.Tensor):
        """Start ``dst <- src`` (device to host); returns the event the
        host must wait on before reading ``dst`` (None on the CPU)."""
        self.d2h_bytes += src.numel() * src.element_size()
        if not self.cuda:
            dst.copy_(src)
            return None
        with torch.cuda.stream(self.stream):
            src.record_stream(self.stream)
            dst.copy_(src, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.stream)
        return ev

    def to_device(self, dst: torch.Tensor, src: torch.Tensor):
        """Start ``dst <- src`` (host to device); returns the event after
        which ``src`` may be refilled (None on the CPU)."""
        self.h2d_bytes += src.numel() * src.element_size()
        if not self.cuda:
            dst.copy_(src)
            return None
        with torch.cuda.stream(self.stream):
            dst.record_stream(self.stream)
            dst.copy_(src, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.stream)
        return ev

    @staticmethod
    def wait(ev) -> None:
        """Block the host until ``ev`` (a copy's event) has completed."""
        if ev is not None:
            ev.synchronize()

    def join(self) -> None:
        """Order the compute stream after every copy queued so far."""
        if self.cuda:
            torch.cuda.current_stream(self.device).wait_stream(self.stream)

    def observe(self) -> None:
        """The wire's bytes since the last call into the registry."""
        reg = get_registry()
        if reg.enabled:
            reg.counter("dstpu_offload_d2h_bytes_total").inc(self.d2h_bytes)
            reg.counter("dstpu_offload_h2d_bytes_total").inc(self.h2d_bytes)
        self.d2h_bytes = self.h2d_bytes = 0


class ZeroOffloadHostOptimizer:
    """Host half of the offload engine: masters, moments and the step.
    ``leaves``: the float32 masters in the engine's leaf order (tensors
    on any device or arrays; each is copied to the host as it is
    taken)."""

    def __init__(self, engine, leaves):
        self.opt, self.lr_default = host_optimizer(engine._config, leaves)
        self.shapes = [m.shape for m in self.opt.master]
        self.sizes = [m.size for m in self.opt.master]
        self._bf16: Optional[List[np.ndarray]] = None
        self._pool: Optional[ThreadPoolExecutor] = None
        #: the last pipelined step's lanes: seconds in the fetch lane, the
        #: sweep (worker) and the upload lane, the wall time, the bytes
        #: each way and the number of pieces
        self.timing: Dict[str, float] = {}
        self.transfers = Transfers(engine.device)
        self.host_bytes = sum(
            sum(a.nbytes for a in arrs)
            for arrs in self.opt.state_arrays().values())
        reg = get_registry()
        if reg.enabled:
            reg.gauge("dstpu_offload_host_bytes").set(float(self.host_bytes))

    def step(self, grad_leaves: List[np.ndarray], lr: float,
             grad_scale: float, emit_bf16: bool) -> List[np.ndarray]:
        """Update the masters in place from host gradients; returns the
        upload arrays (bf16 bits when ``emit_bf16``, else the masters)."""
        if emit_bf16 and self._bf16 is None:
            self._bf16 = [np.empty(s, np.uint16) for s in self.shapes]
        self.opt.step(grad_leaves, lr=lr, grad_scale=grad_scale,
                      out_bf16=self._bf16 if emit_bf16 else None)
        return self._bf16 if emit_bf16 else self.opt.master

    def step_pipelined(self, grads: Optional[torch.Tensor],
                       params: List[torch.Tensor], lr: float,
                       grad_scale: float,
                       fetch: Optional[Callable[[Piece, torch.Tensor],
                                                Any]] = None,
                       bucket_bytes: int = 64 << 20) -> None:
        """The overlapped step: ``grads`` is the flat float32 gradient
        sum on the device (the leaves' concatenation), ``params`` the
        device's compute-dtype leaves, overwritten in place with the
        updated values.  ``fetch(piece, host_f32)``, when given, fills a
        piece's host gradient itself (the wire codec's decode) and returns
        None (the host may read it at once) or the copy's event."""
        import time
        t_start = time.perf_counter()
        lanes = {"fetch_s": 0.0, "sweep_s": 0.0, "upload_s": 0.0}
        emit_bf16 = params[0].dtype == torch.bfloat16
        up_dtype = params[0].dtype
        pieces = plan_pieces(self.sizes, max(bucket_bytes // 4, 1))
        tr = self.transfers
        self.opt.step_count += 1
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix="offload-opt")
        tr.after_compute()
        flat_params = [p.view(-1) for p in params]
        up_events: List[Any] = [None] * RING

        def sweep(piece: Piece, g: np.ndarray, out: np.ndarray, ev):
            # the offload-opt worker thread: its own trace track
            tr.wait(ev)                     # the grad copy has landed
            t0 = time.perf_counter()
            with trace_span("offload/sweep_bucket",
                            leaves=len(piece.segments)):
                for k, a, b, off in piece.segments:
                    n = b - a
                    ob = out[off:off + n] if emit_bf16 else None
                    self.opt.step_one(k, g[off:off + n], lr=lr,
                                      grad_scale=grad_scale, out_bf16=ob,
                                      span=(a, b))
                    if not emit_bf16:
                        src = self.opt.master[k].reshape(-1)[a:b]
                        out[off:off + n] = src.astype(out.dtype, copy=False)
            lanes["sweep_s"] += time.perf_counter() - t0

        def upload(piece: Piece, slot: int, buf: torch.Tensor):
            t0 = time.perf_counter()
            with trace_span("offload/upload_bucket",
                            leaves=len(piece.segments)):
                src = buf.view(torch.bfloat16) if emit_bf16 else buf
                evs = [tr.to_device(flat_params[k][a:b],
                                    src[off:off + b - a])
                       for k, a, b, off in piece.segments]
            up_events[slot] = evs[-1] if evs else None
            lanes["upload_s"] += time.perf_counter() - t0

        up_torch = torch.int16 if emit_bf16 else up_dtype
        prev = None
        for j, piece in enumerate(pieces):
            slot = j % RING
            n = piece.hi - piece.lo
            gbuf = tr.buffer("grad", slot, n, torch.float32)
            ubuf = tr.buffer("param", slot, n, up_torch)
            # the upload that last read this slot's buffer must be done
            tr.wait(up_events[slot])
            t0 = time.perf_counter()
            with trace_span("offload/fetch_bucket",
                            leaves=len(piece.segments)):
                ev = (fetch(piece, gbuf) if fetch is not None else
                      tr.to_host(gbuf, grads[piece.lo:piece.hi]))
            lanes["fetch_s"] += time.perf_counter() - t0
            out = ubuf.numpy()
            if emit_bf16:
                out = out.view(np.uint16)
            fut = self._pool.submit(sweep, piece, gbuf.numpy(), out, ev)
            if prev is not None:
                # upload piece j-1 while the worker sweeps piece j
                p_piece, p_slot, p_buf, p_fut = prev
                p_fut.result()
                upload(p_piece, p_slot, p_buf)
            prev = (piece, slot, ubuf, fut)
        with trace_span("offload/upload"):
            # the last piece's upload, then every copy landed
            if prev is not None:
                p_piece, p_slot, p_buf, p_fut = prev
                p_fut.result()
                upload(p_piece, p_slot, p_buf)
            t0 = time.perf_counter()
            for ev in up_events:
                tr.wait(ev)
            lanes["upload_s"] += time.perf_counter() - t0
        tr.join()
        self.timing = {**lanes, "wall_s": time.perf_counter() - t_start,
                       "d2h_bytes": tr.d2h_bytes, "h2d_bytes": tr.h2d_bytes,
                       "pieces": len(pieces)}
        tr.observe()

    def reset_from_params(self, params: List[torch.Tensor]) -> None:
        """Masters from (restored) device params, moments zeroed: the
        module-only load."""
        sd = self.opt.state_arrays()
        fresh = {name: ([p.detach().to("cpu", torch.float32).numpy()
                         for p in params] if name == "master"
                        else [np.zeros_like(a) for a in arrs])
                 for name, arrs in sd.items()}
        self.opt.load_state_arrays(fresh, step_count=0)

    # -- checkpoint --------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        return {"arrays": self.opt.state_arrays(),
                "step_count": self.opt.step_count}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.opt.load_state_arrays(sd["arrays"], int(sd["step_count"]))

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None


def validate_offload_config(cfg) -> str:
    """Classify the offload config → ``"none" | "optimizer" |
    "infinity"``; raises on configs the framework cannot honor (silent
    no-ops are bugs).  ``optimizer``: host-memory optimizer state,
    params stay on the device (this module).  ``infinity``: parameter
    streaming and host/NVMe optimizer state
    (``runtime/zero/infinity.py``)."""
    z = cfg.zero_config
    oo = z.offload_device("offload_optimizer")
    op = z.offload_device("offload_param")
    bits = int(getattr(z, "offload_wire_bits", 0) or 0)
    if bits not in (0, 1, 4, 8):
        raise ValueError(
            f"zero_optimization.offload_wire_bits must be 0, 1, 4 or 8; "
            f"got {bits}")
    if bits and oo == "none" and op == "none":
        raise ValueError(
            "zero_optimization.offload_wire_bits compresses the OFFLOAD "
            "grad wire, but no offload is configured — set "
            "offload_optimizer: {device: cpu} (tier 1) or offload_param "
            "(Infinity), or drop offload_wire_bits (a silently ignored "
            "knob is a bug)")
    if op != "none":
        return "infinity"
    if oo == "none":
        return "none"
    if oo == "nvme":
        raise NotImplementedError(
            "offload_optimizer device=nvme without offload_param is not a "
            "built configuration — the NVMe optimizer tier rides the "
            "ZeRO-Infinity path (add offload_param: {device: cpu}) or use "
            "device=cpu")
    return "optimizer"
