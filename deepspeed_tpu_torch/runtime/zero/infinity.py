"""ZeRO-Infinity: train past device memory by streaming layer parameters.

Counterpart of ``deepspeed_tpu/runtime/zero/infinity.py``
(``InfinityStepper``) on one device.  The model's own structure is the
swap schedule: the transformer is a stack of identical scan layers, so the
step walks the layers in Python.  Each layer's parameters are one flat
bf16 vector (its leaves in the JAX package's order, sorted keys) held in a
host slot store (DRAM or NVMe), and its float32 master and Adam moments in
the slot optimizer (``swap_tensor/partitioned_optimizer_swapper.py``).

* Forward: the layers run under ``torch.no_grad``, each block input
  stashed (one ``[B, T, D]`` tensor a layer); layer i+1's vector goes
  host-to-device one layer ahead, as a ``non_blocking`` copy on a side
  stream from the store's page-locked memory, and the compute stream
  waits on that copy's event before it reads the layer.
* Backward: for layer i the block is recomputed with grad over views of
  the flat vector and ``torch.autograd.grad`` with dy gives dx and dflat
  (kernel B1 runs twice a layer, B2 once, through the flash-attention
  autograd function); dflat goes device-to-host into a ring of pinned
  buffers, an event recorded behind it, and a host worker waits on the
  event before the native Adam sweep (``ds_adam_step_g16``) folds it into
  the masters and writes the layer's new bf16 vector into its parameter
  slot.  An upload's slot stays pinned until its copy's event has
  completed; on the NVMe tier a ring that runs dry reclaims such pins
  through ``NvmeSlotStore.reclaim``.

The device holds the resident params (embeddings, final norm, head: float32
masters stepped by the engine's own optimizer, with their moments), at
most ``max_live_layers`` layer vectors (``zero_optimization.
max_live_parameters``), one layer's recompute and the activation stash.

Step modes, as in the JAX package, all with the host work overlapping the
backward through one single-thread worker per host core up to 8, layer i
on worker i % N (per-layer order kept, layers in parallel):

* pure stream: gas 1, no clipping; each layer's update runs inside the
  backward, with no host gradient accumulator;
* streamed gas: gas > 1, no clipping; micro batches 0 .. gas-2 accumulate
  into a host float32 store, and in the last one each layer's update runs
  as soon as its accumulation completes;
* clip-gated: clipping on; accumulate and record each layer's exact
  accumulated squared norm as it completes, so the global norm is ready
  when the last layer's grad lands, then sweep every layer.

``offload_wire_bits`` compresses each layer's gradient on the device
(``wire_codec.encode``) and the host decodes it; ``offload_param_bits``
uploads each layer as a round-to-nearest payload decoded on the device,
with an encode cache invalidated whenever a layer's masters change.  An
MoE model composes (its experts stream inside the layer vector; its aux
loss's gradient rides each layer's backward).  Checkpoints use the JAX
package's on-disk layout (``slot_NNNNN.npz``, ``resident.npz``,
``meta.json`` with the leaf paths), so either package reads the other's.
On the CPU (``device="cpu"``) page-locking and the side stream are
skipped because the CPU was asked for.  Restrictions (raised): bf16
compute, Adam/AdamW, no per-layer attention windows.
"""
from __future__ import annotations

import json
import math
import os
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...models.convert import check_params, leaf_to_torch
from ...observability import get_registry, trace_span
from ...ops.adam.cpu_adam import _lib as adam_lib
from ...ops.adam.cpu_adam import accum_bf16, bf16_bits
from ...utils.logging import logger
from ..resilience import get_fault_injector, policy_from_config, retry_call
from . import wire_codec
from .offload import ADAM_NAMES, RING, Transfers


def _savez_retry(path: str, policy=None, **arrays) -> None:
    """One slot .npz write through the shared retry policy and the
    ``infinity.slot_write`` fault site (a failed partial write is simply
    overwritten by the retry)."""
    def _write():
        get_fault_injector().check("infinity.slot_write", path=path)
        np.savez(path, **arrays)
    retry_call(_write, policy=policy,
               what=f"infinity slot write {os.path.basename(path)}")


def _load_npz_retry(path: str, policy=None):
    """Open a slot .npz through the retry policy and the
    ``infinity.slot_read`` site."""
    def _open():
        get_fault_injector().check("infinity.slot_read", path=path)
        return np.load(path)
    return retry_call(_open, policy=policy,
                      what=f"infinity slot read {os.path.basename(path)}")


def sorted_leaves(tree, prefix: Tuple[str, ...] = ()):
    """``(path, leaf)`` pairs of a nested dict, keys sorted at every
    level: the JAX package's leaf order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from sorted_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _nest(tree: dict, path: Tuple[str, ...], value) -> None:
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _tree_from(paths, leaves) -> dict:
    out: dict = {}
    for p, leaf in zip(paths, leaves):
        _nest(out, p, leaf)
    return out


class InfinityStepper:
    """Layer-streamed train step with host/NVMe parameter and optimizer
    state, owned by ``DeepSpeedEngine`` when ``offload_param`` is set.
    ``params``: the initial tree (its ``blocks`` stacked as the model's),
    else the model's streamed init from ``seed``."""

    def __init__(self, engine, params=None, seed: int = 0):
        self.engine = engine
        model = engine.model
        cfg = engine._config
        self._validate(engine, model, cfg)
        self.model = model
        self.device = engine.device
        c = model.config
        self.L = c.scan_length
        self.gas = engine.gradient_accumulation_steps
        self.clip = float(cfg.gradient_clipping or 0.0)
        zc = cfg.zero_config
        op, oo = zc.offload("offload_param"), zc.offload("offload_optimizer")

        # -- optimizer hyperparams from the config ---------------------
        oc = cfg.optimizer
        name = (oc.type if oc is not None else "adamw").lower()
        hp = dict(oc.params) if oc is not None else {}
        self.lr_default = hp.pop("lr", 1e-3)
        betas = tuple(hp.pop("betas", (0.9, 0.999)))
        eps = hp.pop("eps", 1e-8)
        wd = hp.pop("weight_decay", 0.0)
        adamw = hp.pop("adam_w_mode", name != "adam")

        # -- layout: one layer's leaves in sorted-key order --------------
        layer = list(sorted_leaves(model.superblock_shapes()))
        self._paths = [p for p, _ in layer]
        self._shapes = [tuple(s) for _, s in layer]
        self._sizes = [int(np.prod(s)) if s else 1 for s in self._shapes]
        self._offsets = np.cumsum([0] + self._sizes).tolist()
        self.n_elems = int(self._offsets[-1])
        res = list(sorted_leaves(model.resident_shapes()))
        self._res_paths = [p for p, _ in res]
        self._res_shapes = [tuple(s) for _, s in res]
        self.total_params = self.L * self.n_elems + sum(
            int(np.prod(s)) for s in self._res_shapes)
        self.wire_bits = int(getattr(zc, "offload_wire_bits", 0) or 0)
        if self.wire_bits not in (0, 1, 4, 8):
            raise ValueError(
                f"zero_optimization.offload_wire_bits must be 0, 1, 4 or 8; "
                f"got {self.wire_bits}")
        self.param_bits = int(getattr(zc, "offload_param_bits", 0) or 0)
        if self.param_bits not in (0, 4, 8):
            raise ValueError(
                f"zero_optimization.offload_param_bits must be 0, 4 or 8; "
                f"got {self.param_bits}")
        quantum = (wire_codec.CHUNK if (self.wire_bits or self.param_bits)
                   else 1)
        self.n_pad = -(-self.n_elems // quantum) * quantum
        # device layer cache: how many streamed layers may stay resident
        # (2 = the double buffer), counted in bytes so a quantized cache
        # holds more layers in the same budget
        cache_bytes_pp = {0: 2.0, 8: 1.0, 4: 0.5}[self.param_bits]
        budget_bytes = int(zc.max_live_parameters) * 2
        per_layer_bytes = max(self.n_elems, 1) * cache_bytes_pp
        self.max_live_layers = int(np.clip(
            int(budget_bytes / per_layer_bytes), 2, self.L))

        # -- host stores -------------------------------------------------
        from ..swap_tensor.partitioned_optimizer_swapper import SlotOptimizer
        from ..swap_tensor.slot_store import make_slot_store
        shared_aio = None
        if "nvme" in (op.device, oo.device):
            from ...ops.aio import AsyncIOHandle
            shared_aio = AsyncIOHandle(block_size=cfg.aio.block_size,
                                       num_threads=cfg.aio.thread_count)
        self._aio = shared_aio
        self.param_store = make_slot_store(
            op.device, self.L, self.n_pad * 2, nvme_path=op.nvme_path,
            aio=shared_aio, buffer_count=max(4, op.buffer_count),
            name="params")
        # upload pins are held by the streaming thread until each copy's
        # event completes: the store may reclaim them when its ring runs
        # dry, from the streaming thread only (a worker waits instead)
        self._stream_thread = threading.current_thread()

        def _reclaim():
            if threading.current_thread() is self._stream_thread:
                self._sweep_uploads(block=True)
        self.param_store.reclaim = _reclaim
        self._io_policy = policy_from_config(getattr(cfg, "resilience",
                                                     None))
        self._skip_nonfinite = bool(
            getattr(cfg, "resilience", None) is not None
            and cfg.resilience.skip_nonfinite_grad_steps)
        self.param_store.io_policy = self._io_policy
        self.opt = SlotOptimizer(
            self.L, self.n_pad, device=oo.device, nvme_path=oo.nvme_path,
            aio=shared_aio, buffer_count=max(3, oo.buffer_count),
            lr=self.lr_default, betas=betas, eps=eps, weight_decay=wd,
            adamw_mode=adamw, name="optimizer")
        self.opt.store.io_policy = self._io_policy
        self._lib = adam_lib()
        self.tr = Transfers(self.device)
        self.opt.store.prefault()
        self.param_store.prefault()
        if self.tr.cuda:
            self.param_store.page_lock()

        # collect-mode gradient accumulator, allocated lazily ([L, n])
        self._grad_accum: Optional[np.ndarray] = None
        self._layer_sq = np.zeros(self.L, np.float64)

        # the param wire's encode cache (DRAM parameter store only: an
        # NVMe ring must not be acquired from a worker while the stream
        # thread waits on that worker)
        self._enc_lock = threading.Lock()
        self._enc_cache: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._enc_version = [0] * self.L
        self._enc_futures: Dict[int, Future] = {}
        self._enc_async = bool(self.param_bits) and op.device == "cpu"

        nw = int(oo.worker_count or 0)
        if nw <= 0:
            nw = min(os.cpu_count() or 1, 8)
        if "nvme" in (op.device, oo.device):
            # each sweep task pins one buffer of each ring: stay below
            # the smaller ring
            nw = min(nw, 2)
        self._workers = [ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"infinity-opt{k}")
            for k in range(nw)]

        # -- init ----------------------------------------------------------
        self._init_state(params, seed)
        self._res_optim = engine.optimizer
        self.res_state = self._res_optim.init(self.resident)

        # slot -> (device tensors, upload event); pending uploads as
        # (slot | None, event, host refs kept alive for the copy)
        self._dev: Dict[int, Tuple[Tuple[torch.Tensor, ...], Any]] = {}
        self._pending_uploads: List[Tuple] = []
        # the grad wire's draws: one generator, advancing (no device-side
        # state to checkpoint, as the JAX package's folded key)
        self._wire_gen = torch.Generator(device=self.device)
        self._wire_gen.manual_seed(0x1bad)
        # the grad wire's ring of pinned buffers (Transfers.buffer) and the
        # task reading each slot
        self._grad_slot = 0
        self._grad_users: List[Optional[Future]] = [None] * (RING + 1)
        self._last_metrics: Optional[Dict] = None
        self._sweep_s, self._h2d, self._d2h = 0.0, 0, 0
        #: the last step's host timeline (seconds) and wire bytes
        self.timing: Dict[str, float] = {}
        host_gb = (self.param_store.host_bytes + self.opt.host_bytes) / 2**30
        disk_gb = (self.param_store.disk_bytes + self.opt.disk_bytes) / 2**30
        reg = get_registry()
        if reg.enabled:
            reg.gauge("dstpu_offload_host_bytes").set(host_gb * 2**30)
            reg.gauge("dstpu_offload_nvme_bytes").set(disk_gb * 2**30)
        logger.info(
            f"ZeRO-Infinity: {self.total_params / 1e9:.2f}B params, "
            f"{self.L} layers x {self.n_elems / 1e6:.1f}M elems; host "
            f"{host_gb:.1f} GiB, nvme {disk_gb:.1f} GiB (params="
            f"{op.device}, optimizer={oo.device}); device layer cache "
            f"{self.max_live_layers}/{self.L} layers"
            + (f"; D2H wire {self.wire_bits}-bit stochastic-rounded"
               if self.wire_bits else "")
            + (f"; H2D param wire {self.param_bits}-bit RTN"
               if self.param_bits else ""))

    # ------------------------------------------------------------------
    @staticmethod
    def _validate(engine, model, cfg) -> None:
        if getattr(getattr(model, "config", None), "attention_layers", ()):
            raise NotImplementedError(
                "ZeRO-Infinity streams layers through a layer-index-free "
                "block_fwd, which cannot carry the per-layer attention "
                "windows of attention_layers (GPT-Neo family); train this "
                "model with the in-HBM engine, or drop attention_layers")
        for attr in ("init_superblock", "init_resident", "superblock_apply"):
            if not hasattr(model, attr):
                raise NotImplementedError(
                    "ZeRO-Infinity needs a scan-layer model exposing "
                    "init_superblock/init_resident (TransformerLM does); "
                    f"got {type(model).__name__}")
        if engine.fp16_enabled:
            raise NotImplementedError(
                "ZeRO-Infinity requires bf16 (fp16 loss scaling is not "
                "wired into the streamed step); set bf16.enabled")
        oc = cfg.optimizer
        name = (oc.type if oc is not None else "adamw").lower()
        if name not in ADAM_NAMES:
            raise NotImplementedError(
                f"ZeRO-Infinity host sweep supports Adam/AdamW, got {name}")
        if cfg.zero_config.offload_device("offload_optimizer") == "none":
            raise ValueError(
                "offload_param without offload_optimizer would keep full "
                "optimizer state in HBM, defeating the point — set "
                "offload_optimizer: {device: cpu|nvme}")

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------
    def _gen(self, seed: int, device) -> torch.Generator:
        g = torch.Generator(device=device)
        g.manual_seed(int(seed))
        return g

    def _init_state(self, params, seed: int) -> None:
        """Fill the stores one layer at a time: from ``params`` when
        given, else the model's streamed init (layer i from its own seed,
        never more than one layer on the device; with
        ``infinity_host_init`` the layers are drawn on the host)."""
        model, dev = self.model, self.device
        if params is not None:
            check_params(model, params)

            def put(a):
                t = a if isinstance(a, torch.Tensor) else leaf_to_torch(
                    a, "cpu")
                return t.to(dev, torch.float32)
            self.resident = {k: _map(v, put) for k, v in params.items()
                             if k != "blocks"}
            blocks = params["blocks"]
            for i in range(self.L):
                flat = np.concatenate([
                    np.asarray(_host(_get(blocks, p)[i]), np.float32)
                    .reshape(-1) for p in self._paths])
                self._init_slot_from_full(i, flat)
        else:
            self.resident = model.init_resident(self._gen(seed, dev), dev,
                                                torch.float32)
            host = self.engine._config.zero_config.infinity_host_init
            ldev = torch.device("cpu") if host else dev
            for i, k in enumerate(model.superblock_keys(seed)):
                lp = model.init_superblock(self._gen(k, ldev), ldev,
                                           torch.float32)
                flat = torch.zeros(self.n_pad, dtype=torch.float32,
                                   device=ldev)
                torch.cat([_get(lp, p).reshape(-1) for p in self._paths],
                          out=flat[:self.n_elems])
                del lp
                # straight into the slots; the bf16 rounding where the
                # layer was drawn
                self.opt.init_slot(i, flat)
                self._write_params(i, bits=flat.to(torch.bfloat16))
                del flat
        self.param_store.flush()
        self.opt.flush()

    def _local_f32(self, flat: np.ndarray) -> np.ndarray:
        """The padded vector of a logical one (pad tail zeros)."""
        out = np.zeros(self.n_pad, np.float32)
        out[:self.n_elems] = np.asarray(flat, np.float32).reshape(-1)[
            :self.n_elems]
        return out

    def _write_params(self, i: int, p: Optional[np.ndarray] = None,
                      bits: Optional[torch.Tensor] = None) -> None:
        """Layer i's parameter slot: the bf16 bits of float32 ``p``, or
        the bf16 tensor ``bits`` (any device) as given."""
        buf = self.param_store.acquire(i)
        dst = buf[:self.n_pad * 2].view(np.uint16)
        if bits is None:
            dst[:] = bf16_bits(p)
        else:
            torch.from_numpy(dst.view(np.int16)).copy_(
                bits.view(torch.int16))
        self.param_store.release(i, dirty=True)
        self._invalidate_encoded(i)

    def _init_slot_from_full(self, i: int, flat: np.ndarray) -> None:
        loc = self._local_f32(flat)
        self.opt.init_slot(i, loc)
        self._write_params(i, loc)

    # ------------------------------------------------------------------
    # device layer cache
    # ------------------------------------------------------------------
    def _sweep_uploads(self, block: bool = False) -> None:
        """Release the parameter-store pins whose host-to-device copy has
        completed (``block``: wait for every copy first): the pin must
        outlive the copy, or the NVMe ring could recycle the buffer under
        it."""
        still = []
        for slot, ev, refs in self._pending_uploads:
            if block:
                self.tr.wait(ev)
            if ev is None or ev.query():
                if slot is not None:
                    self.param_store.release(slot, dirty=False)
            else:
                still.append((slot, ev, refs))
        self._pending_uploads = still

    def _upload(self, src: torch.Tensor):
        """Start one host-to-device copy of ``src`` into fresh device
        memory: ``(tensor, event)``."""
        self.tr.h2d_bytes += src.numel() * src.element_size()
        if not self.tr.cuda:
            return src.clone(), None
        with torch.cuda.stream(self.tr.stream):
            dst = torch.empty(src.shape, dtype=src.dtype, device=self.device)
            dst.copy_(src, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.tr.stream)
        return dst, ev

    def _ensure_layer(self, i: int, keep) -> None:
        """Layer i's vector on the device (bf16 flat, or payload and
        scales under the param wire), uploaded from its slot on a miss.
        Layers stay cached up to ``max_live_layers``, the oldest upload
        evicted first (on a forward sweep that keeps the layers the
        backward needs first)."""
        if i in self._dev:
            return
        while len(self._dev) >= self.max_live_layers:
            victim = next((k for k in self._dev if k not in keep), None)
            if victim is None:
                break
            del self._dev[victim]
        self._sweep_uploads()
        if self.param_bits:
            payload, scales = self._encoded_params(i)
            pay, _ = self._upload(torch.from_numpy(payload))
            sc, ev = self._upload(torch.from_numpy(scales))
            arrs = (pay, sc)
            self._pending_uploads.append((None, ev, (payload, scales)))
        else:
            buf = self.param_store.acquire(i)
            host = torch.from_numpy(buf[:self.n_pad * 2].view(np.int16))
            flat, ev = self._upload(host)
            arrs = (flat.view(torch.bfloat16),)
            self._pending_uploads.append((i, ev, ()))   # pin held
        self._dev[i] = (arrs, ev)

    def _layer(self, i: int) -> torch.Tensor:
        """Layer i's bf16 flat vector for the compute stream (which
        waits on its upload's event first)."""
        arrs, ev = self._dev[i]
        if self.tr.cuda and ev is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(ev)
            for t in arrs:
                t.record_stream(cur)
        if self.param_bits:
            return wire_codec.decode_params(arrs[0], arrs[1],
                                            self.param_bits)
        return arrs[0]

    # -- the param wire's encode cache ------------------------------------
    def _invalidate_encoded(self, i: int) -> None:
        """Layer i's masters changed (sweep, load, init): any cached or
        in-flight encoded payload is stale."""
        if not self.param_bits:
            return
        with self._enc_lock:
            self._enc_version[i] += 1
            self._enc_cache.pop(i, None)
            self._enc_futures.pop(i, None)

    def _encode_now(self, i: int):
        buf = self.param_store.acquire(i)
        try:
            host = buf[:self.n_pad * 2].view(np.uint16)
            return wire_codec.encode_params_host(host, self.param_bits)
        finally:
            self.param_store.release(i, dirty=False)

    def _encode_slot(self, i: int, version: int):
        """Worker task (layer i's own worker, so it runs after any queued
        sweep of the layer): the slot's encode, cached if still fresh."""
        enc = self._encode_now(i)
        with self._enc_lock:
            if self._enc_version[i] == version:
                self._enc_cache[i] = enc
        return version, enc

    def _prefetch_encode(self, i: int) -> None:
        """Queue layer i's quantize pass ahead of need, so the streaming
        thread uploads a ready payload."""
        if not self._enc_async or not 0 <= i < self.L or i in self._dev:
            return
        with self._enc_lock:
            if i in self._enc_cache or i in self._enc_futures:
                return
            self._enc_futures[i] = self._submit(i, self._encode_slot,
                                                self._enc_version[i])

    def _encoded_params(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """Layer i's (payload, scales): cache hit, in-flight prefetch, or
        an inline encode."""
        if self._enc_async:
            with self._enc_lock:
                enc = self._enc_cache.get(i)
                fut = self._enc_futures.pop(i, None)
            if enc is not None:
                return enc
            if fut is not None:
                version, enc = fut.result()
                with self._enc_lock:
                    if self._enc_version[i] == version:
                        return enc
        with self._enc_lock:
            v0 = self._enc_version[i]
        enc = self._encode_now(i)
        if self._enc_async:
            with self._enc_lock:
                if self._enc_version[i] == v0:
                    self._enc_cache[i] = enc
        return enc

    # ------------------------------------------------------------------
    # the layer programs
    # ------------------------------------------------------------------
    def _unflatten(self, flat: torch.Tensor) -> dict:
        return _tree_from(self._paths, [
            flat[o:o + s].view(sh) for o, s, sh in
            zip(self._offsets, self._sizes, self._shapes)])

    def _cast_res(self, res):
        return self.engine._cast_for_compute(res)

    def _block_fwd(self, i: int, x: torch.Tensor):
        with torch.no_grad():
            return self.model.superblock_apply(
                self._unflatten(self._layer(i)), x)

    def _block_vjp(self, i: int, x: torch.Tensor, dy: torch.Tensor):
        """Recompute layer i with grad and pull dy back: ``(dflat, dx,
        ||dflat||^2)``; an MoE layer's aux loss gets the cotangent
        ``moe_aux_loss_coef``, so the gate trains under streaming."""
        c = self.model.config
        flat = self._layer(i).detach().requires_grad_(True)
        xr = x.detach().requires_grad_(True)
        with torch.enable_grad():
            y, laux = self.model.superblock_apply(self._unflatten(flat), xr)
        outs, cots = [y], [dy]
        if c.moe_enabled and laux.requires_grad:
            outs.append(laux)
            cots.append(torch.full((), float(c.moe_aux_loss_coef),
                                   dtype=torch.float32, device=x.device))
        dflat, dx = torch.autograd.grad(outs, [flat, xr], cots)
        return dflat, dx, torch.sum(torch.square(dflat.to(torch.float32)))

    def _res_leaves_req(self):
        leaves = [_get(self.resident, p).detach().requires_grad_(True)
                  for p in self._res_paths]
        return leaves, _tree_from(self._res_paths, leaves)

    def _embed(self, res, ids, tt):
        pos = torch.arange(ids.shape[1], device=ids.device)[None]
        return self.model._embed(self._cast_res(res), ids, pos, tt)

    def _head_loss(self, res, x, labels, mask):
        rc = self._cast_res(res)
        return self.model.nll_from_hidden(
            rc, self.model._final_norm(rc, x), labels, mask)

    def _grads_or_zeros(self, out, wrt, cot=None):
        gs = torch.autograd.grad(out, wrt, cot, allow_unused=True)
        return [torch.zeros_like(w) if g is None else g
                for g, w in zip(gs, wrt)]

    # ------------------------------------------------------------------
    # micro batches
    # ------------------------------------------------------------------
    def _prep_batch(self, batch, split: bool = True):
        def host(a):
            if a is None:
                return None
            a = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
            if split and a.ndim == 2:
                if a.shape[0] % self.gas:
                    raise ValueError(f"batch {a.shape[0]} not divisible by "
                                     f"gas {self.gas}")
                a = a.reshape(self.gas, a.shape[0] // self.gas, *a.shape[1:])
            return a
        return (host(batch["input_ids"]), host(batch.get("labels")),
                host(batch.get("loss_mask")),
                host(batch.get("token_type_ids")))

    def _to_dev(self, ids, labels, mask, tt):
        """Ids, labels and mask on the device, the labels shifted from the
        ids (last position masked) when none are given, as the model's
        loss does."""
        dev = self.device
        ids = torch.from_numpy(np.array(ids)).long().to(dev)
        if labels is None:
            labels = torch.cat([ids[:, 1:], torch.zeros_like(ids[:, :1])],
                               dim=1)
            last = torch.ones(ids.shape, dtype=torch.float32, device=dev)
            last[:, -1] = 0.0
            mask = last if mask is None else (
                torch.from_numpy(np.asarray(mask, np.float32)).to(dev)
                * last)
        else:
            labels = torch.from_numpy(np.array(labels)).long().to(dev)
            if mask is not None:
                mask = torch.from_numpy(np.asarray(mask, np.float32)).to(dev)
        if tt is not None:
            tt = torch.from_numpy(np.array(tt)).long().to(dev)
        return ids, labels, mask, tt

    def _forward_stream(self, ids, tt, stash: bool = True):
        """The streamed forward → (activation stash | None, final hidden,
        summed MoE aux loss)."""
        with torch.no_grad():
            x = self._embed(self.resident, ids, tt)
        acts: Optional[List[Any]] = [None] * self.L if stash else None
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        self._ensure_layer(0, {0})
        self._prefetch_encode(1)
        for i in range(self.L):
            if i + 1 < self.L:
                self._ensure_layer(i + 1, {i, i + 1})
            self._prefetch_encode(i + 2)
            if stash:
                acts[i] = x
            x, la = self._block_fwd(i, x)
            aux = aux + la
        return acts, x, aux

    def _send_grad(self, dflat: torch.Tensor):
        """Start layer i's gradient down the wire: bf16 bits, or the
        encoded payload and scales, into the next pinned ring slot (after
        the task that last read the slot has finished); returns what the
        worker needs to read it."""
        slot = self._grad_slot % len(self._grad_users)
        self._grad_slot += 1
        user = self._grad_users[slot]
        if user is not None and not user.done():
            # the task still reading this slot may need a parameter-ring
            # buffer that only this thread's upload pins can free
            self._sweep_uploads(block=True)
            user.result()
        self.tr.after_compute()
        if self.wire_bits:
            payload, scales = wire_codec.encode(dflat, self.wire_bits,
                                                self._wire_gen)
            pbuf = self.tr.buffer("wire", slot, payload.numel(), torch.uint8)
            sbuf = self.tr.buffer("scales", slot, scales.numel(),
                                  torch.float32)
            self.tr.to_host(pbuf, payload)
            ev = self.tr.to_host(sbuf, scales)
            return slot, ("enc", pbuf.numpy(), sbuf.numpy(), ev)
        gbuf = self.tr.buffer("grad", slot, dflat.numel(), torch.int16)
        ev = self.tr.to_host(gbuf, dflat.view(torch.int16))
        return slot, ("raw", gbuf.numpy().view(np.uint16), ev)

    def _micro_fwd_bwd(self, ids, labels, mask, tt,
                       on_layer_grad: Callable[[int, Any], Future]):
        """One micro batch forward and backward, each layer's gradient
        handed to ``on_layer_grad`` (which returns the task reading it).
        Returns (loss, resident grads, their squared norm, the total
        squared norm), all on the device."""
        ids, labels, mask, tt = self._to_dev(ids, labels, mask, tt)
        acts, xL, aux = self._forward_stream(ids, tt)
        res_leaves, res_req = self._res_leaves_req()
        xr = xL.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = self._head_loss(res_req, xr, labels, mask)
        *d_head, dy = self._grads_or_zeros(loss, res_leaves + [xr])
        loss = loss.detach()
        if self.model.config.moe_enabled:
            loss = loss + self.model.config.moe_aux_loss_coef * aux
        sqs = []
        for i in reversed(range(self.L)):
            if i - 1 >= 0:
                self._ensure_layer(i - 1, {i, i - 1})
            self._prefetch_encode(i - 2)
            dflat, dy, sq = self._block_vjp(i, acts[i], dy)
            acts[i] = None
            slot, wire = self._send_grad(dflat)
            del dflat
            sqs.append(sq)
            self._grad_users[slot] = on_layer_grad(i, wire)
        res_leaves, res_req = self._res_leaves_req()
        with torch.enable_grad():
            x0 = self._embed(res_req, ids, tt)
        d_embed = self._grads_or_zeros(x0, res_leaves, dy)
        d_res = [a.to(torch.float32) + b.to(torch.float32)
                 for a, b in zip(d_head, d_embed)]
        res_sq = sum(torch.sum(torch.square(g)) for g in d_res)
        return loss, d_res, res_sq, res_sq + sum(sqs)

    # ------------------------------------------------------------------
    # the host side: worker tasks
    # ------------------------------------------------------------------
    def _submit(self, i: int, fn, *args) -> Future:
        """Layer i's task on its pinned worker (i % N)."""
        return self._workers[i % len(self._workers)].submit(fn, i, *args)

    def _fetch_grad(self, wire) -> np.ndarray:
        """The host gradient of a wire entry, after its copy's event: bf16
        bits, or the decoded float32 values."""
        if wire[0] == "raw":
            self.tr.wait(wire[2])
            return wire[1]
        _, payload, scales, ev = wire
        self.tr.wait(ev)
        g32 = np.empty(self.n_pad, np.float32)
        wire_codec.decode_into(g32, payload, scales, self.wire_bits)
        return g32

    def _sweep_slot(self, i: int, g: np.ndarray, lr: float,
                    grad_scale: float) -> None:
        """The native Adam sweep of layer i, its bf16 vector written into
        its parameter slot."""
        t0 = time.perf_counter()
        self.opt.prefetch(i)
        pbuf = self.param_store.acquire(i)
        out16 = pbuf[:self.n_pad * 2].view(np.uint16)
        self.opt.step_slot(i, g, lr=lr, grad_scale=grad_scale,
                           out_bf16=out16)
        self.param_store.release(i, dirty=True)
        self._invalidate_encoded(i)
        with self._enc_lock:          # summed across the workers
            self._sweep_s += time.perf_counter() - t0

    def _step_layer(self, i: int, wire, lr: float,
                    grad_scale: float) -> None:
        """Stream mode: the landed gradient straight into the sweep."""
        with trace_span("infinity/opt_layer", layer=i, mode="stream"):
            g = self._fetch_grad(wire)
            if self.wire_bits:
                # the reported norm describes the grads applied: the
                # stochastically rounded decode
                self._layer_sq[i] = float(np.dot(g, g))
            self._sweep_slot(i, g, lr, grad_scale)

    def _accum_layer(self, i: int, wire) -> None:
        """Collect mode: the gradient into the float32 host store."""
        if wire[0] == "enc":
            _, payload, scales, ev = wire
            self.tr.wait(ev)
            wire_codec.decode_into(self._grad_accum[i], payload, scales,
                                   self.wire_bits, accumulate=True)
            return
        accum_bf16(self._grad_accum[i], self._fetch_grad(wire), self._lib)

    def _apply_layer_from_accum(self, i: int, lr: float,
                                grad_scale: float) -> None:
        with trace_span("infinity/opt_layer", layer=i, mode="accum"):
            self._sweep_slot(i, self._grad_accum[i], lr, grad_scale)
            self._grad_accum[i] = 0.0

    def _finish_layer(self, i: int, wire, lr: float,
                      apply_scale: Optional[float]) -> None:
        """The last micro batch of a layer: accumulate, record the exact
        accumulated squared norm and, when no clipping gates the update,
        sweep at once (overlapped with the backward below)."""
        self._accum_layer(i, wire)
        row = self._grad_accum[i]
        self._layer_sq[i] = float(np.dot(row, row))
        if apply_scale is not None:
            self._apply_layer_from_accum(i, lr, apply_scale)

    def _step_resident(self, grads: List[torch.Tensor], lr: float,
                       grad_scale: float) -> None:
        """The resident params' update by the engine's optimizer (its
        moments on the device); ``grad_scale`` folds micro batches x
        clip factor, as the native sweep's."""
        g = _tree_from(self._res_paths, [x / grad_scale for x in grads])
        self.resident, self.res_state = self._res_optim.apply(
            g, self.res_state, self.resident,
            torch.tensor(lr, dtype=torch.float32, device=self.device))

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def train_step(self, batch) -> Dict[str, torch.Tensor]:
        t0 = time.perf_counter()
        self._stream_thread = threading.current_thread()
        engine = self.engine
        ids, labels, mask, tt = self._prep_batch(batch)
        lr = float(engine.lr_schedule(engine.state["step"]))
        gas = self.gas
        # pure stream: grads are final on arrival and no norm gates them
        pure_stream = gas == 1 and self.clip == 0.0
        self.opt.begin_step()
        self._sweep_s = 0.0
        self._h2d, self._d2h = self.tr.h2d_bytes, self.tr.d2h_bytes
        futures: List[Future] = []
        micro_stats: List[Tuple] = []
        res_acc = None
        self._dev.clear()
        if not pure_stream and self._grad_accum is None:
            self._grad_accum = np.zeros((self.L, self.n_pad), np.float32)
        self._layer_sq = np.zeros(self.L, np.float64)
        for j in range(gas):
            last = j == gas - 1
            if pure_stream:
                def on_grad(i, wire):
                    futures.append(self._submit(i, self._step_layer, wire,
                                                lr, 1.0))
                    return futures[-1]
            elif last:
                # clip 0: each layer's update as its sum completes;
                # clip > 0: record the exact norms, sweep after
                apply_scale = float(gas) if self.clip == 0.0 else None

                def on_grad(i, wire, s=apply_scale):
                    futures.append(self._submit(i, self._finish_layer, wire,
                                                lr, s))
                    return futures[-1]
            else:
                def on_grad(i, wire):
                    futures.append(self._submit(i, self._accum_layer, wire))
                    return futures[-1]
            loss, d_res, res_sq, sq = self._micro_fwd_bwd(
                ids[j], labels[j] if labels is not None else None,
                mask[j] if mask is not None else None,
                tt[j] if tt is not None else None, on_grad)
            micro_stats.append((loss, res_sq, sq))
            res_acc = d_res if res_acc is None else [
                a + b for a, b in zip(res_acc, d_res)]
        # release every upload pin before waiting on the workers: once
        # this thread parks, nobody else may reclaim them
        t_walk = time.perf_counter()
        if self.tr.cuda:
            torch.cuda.synchronize(self.device)   # the backward has run
        t_dev = time.perf_counter()
        self._sweep_uploads(block=True)
        with trace_span("infinity/worker_join", tasks=len(futures)):
            for f in futures:
                f.result()
        t_join = time.perf_counter()
        stats = torch.stack([torch.stack(s) for s in micro_stats]).cpu()
        loss_total, res_sq_total, sq_total = stats.sum(0).tolist()
        grad_scale = float(gas)
        if pure_stream:
            if self.wire_bits:
                gnorm = math.sqrt(res_sq_total + float(np.sum(
                    self._layer_sq)))
            else:
                gnorm = math.sqrt(sq_total)
        else:
            # the exact norm of the accumulated grads (clipping must see
            # the true norm); per-layer terms recorded by _finish_layer
            sq = float(sum(torch.sum(torch.square(g)) for g in res_acc))
            sq += float(np.sum(self._layer_sq))
            gnorm = math.sqrt(sq) / gas
            if self.clip > 0.0:
                if not np.isfinite(gnorm) and self._skip_nonfinite:
                    # the sweep has not run yet: a poisoned step can still
                    # be skipped (resilience.skip_nonfinite_grad_steps)
                    logger.warning(
                        f"non-finite global grad norm ({gnorm}) — skipping "
                        f"the optimizer sweep for this step")
                    self.opt.step_count -= 1
                    self._grad_accum[:] = 0.0
                    engine.state["skipped"] = engine.state["skipped"] + 1
                    self._end_step()
                    return self._metrics(loss_total / gas, gnorm, lr, 1, t0)
                if np.isfinite(gnorm) and gnorm > self.clip:
                    grad_scale *= gnorm / self.clip
                with trace_span("infinity/clip_sweep", layers=self.L):
                    sweep = [self._submit(i, self._apply_layer_from_accum,
                                          lr, grad_scale)
                             for i in range(self.L)]
                    for f in sweep:
                        f.result()
        t_sweep = time.perf_counter()
        self._step_resident(res_acc, lr, grad_scale)
        self._end_step()
        engine.state["step"] = engine.state["step"] + 1
        # where the host's time went: the walk's enqueue, the device's
        # backward past it, the workers' tail after the device finished
        # (the sweep not hidden in the backward), the clip-gated sweep
        self.timing = {"walk_s": t_walk - t0, "device_tail_s": t_dev - t_walk,
                       "join_s": t_join - t_dev,
                       "clip_sweep_s": t_sweep - t_join,
                       "sweep_s": self._sweep_s,
                       "h2d_bytes": self._h2d, "d2h_bytes": self._d2h}
        return self._metrics(loss_total / gas, gnorm, lr, 0, t0)

    def _end_step(self) -> None:
        self._dev.clear()      # the device copies are stale after a sweep
        self._sweep_uploads(block=True)
        self.param_store.flush()
        self.opt.flush()
        self._h2d = self.tr.h2d_bytes - self._h2d
        self._d2h = self.tr.d2h_bytes - self._d2h
        self.tr.observe()

    def _metrics(self, loss, gnorm, lr, overflow, t0) -> Dict:
        m = {"loss": loss, "grad_norm": gnorm, "lr": lr,
             "overflow": overflow, "loss_scale": 1.0,
             "step_time": time.perf_counter() - t0}
        self._last_metrics = m
        return {k: torch.tensor(v) for k, v in m.items()}

    @torch.no_grad()
    def eval_loss(self, batch) -> float:
        """The whole batch's loss (no gas split), streamed forward with no
        activation stash."""
        self._stream_thread = threading.current_thread()
        self._dev.clear()
        ids, labels, mask, tt = self._to_dev(*self._prep_batch(batch, False))
        _, xL, aux = self._forward_stream(ids, tt, stash=False)
        out = self._head_loss(self.resident, xL, labels, mask)
        if self.model.config.moe_enabled:
            out = out + self.model.config.moe_aux_loss_coef * aux
        out = float(out)
        self._sweep_uploads(block=True)
        return out

    def gather_params(self) -> Dict[str, Any]:
        """The full params tree (blocks stacked) as float32 host tensors:
        the masters (``zero_to_fp32``'s role, for tests and export)."""
        blocks_flat = np.stack([self.opt.master(i)[:self.n_elems]
                                for i in range(self.L)])
        leaves = [torch.from_numpy(np.ascontiguousarray(
            blocks_flat[:, o:o + s]).reshape((self.L,) + sh))
            for o, s, sh in zip(self._offsets, self._sizes, self._shapes)]
        out = _map(self.resident, lambda t: t.detach().to("cpu",
                                                          torch.float32))
        out["blocks"] = _tree_from(self._paths, leaves)
        return out

    # -- checkpoint --------------------------------------------------------
    def _layer_meta(self):
        return [{"path": "/".join(p), "shape": list(s)}
                for p, s in zip(self._paths, self._shapes)]

    def _res_meta(self):
        return [{"path": "/".join(p), "shape": list(s)}
                for p, s in zip(self._res_paths, self._res_shapes)]

    @property
    def res_step_count(self) -> int:
        return int(self.res_state["step"])

    def _resident_state_host(self) -> Dict[str, List[np.ndarray]]:
        """The resident params and moments as host leaf lists, in the
        JAX package's leaf order."""
        def host(tree):
            return [_get(tree, p).detach().to("cpu", torch.float32).numpy()
                    for p in self._res_paths]
        return {"master": host(self.resident), "m": host(self.res_state["m"]),
                "v": host(self.res_state["v"])}

    def _load_resident_state(self, res: Dict[str, List[np.ndarray]],
                             step_count: int) -> None:
        def put(leaves):
            return _tree_from(self._res_paths, [
                torch.from_numpy(np.array(a, np.float32)).to(self.device)
                for a in leaves])
        self.resident = put(res["master"])
        self.res_state = {"step": torch.tensor(int(step_count),
                                               dtype=torch.int32,
                                               device=self.device),
                          "m": put(res["m"]), "v": put(res["v"])}

    def save_to_dir(self, path: str) -> None:
        """Stream the whole host state (masters, moments, the resident
        optimizer) to ``path`` one slot at a time, in the JAX package's
        layout: ``slot_NNNNN.npz`` (p, m, v: logical, unpadded vectors),
        ``resident.npz`` and ``meta.json``."""
        os.makedirs(path, exist_ok=True)
        n = self.n_elems
        for i in range(self.L):
            p, m, v = self.opt.state(i)
            _savez_retry(os.path.join(path, f"slot_{i:05d}.npz"),
                         self._io_policy, p=p[:n], m=m[:n], v=v[:n])
        res = self._resident_state_host()
        _savez_retry(os.path.join(path, "resident.npz"), self._io_policy,
                     **{f"{k}_{j}": a for k, arrs in res.items()
                        for j, a in enumerate(arrs)})
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({"L": self.L, "n_elems": self.n_elems,
                       "step_count": self.opt.step_count,
                       "res_step_count": self.res_step_count,
                       "n_res_leaves": len(res["master"]),
                       "layer_leaves": self._layer_meta(),
                       "res_leaves": self._res_meta()}, f)

    def load_from_dir(self, path: str, load_optimizer_states: bool = True
                      ) -> None:
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        if meta["L"] != self.L or meta["n_elems"] != self.n_elems:
            raise ValueError(
                f"checkpoint layout (L={meta['L']}, n={meta['n_elems']}) "
                f"does not match this model (L={self.L}, n={self.n_elems})")
        zl = np.zeros(self.n_pad, np.float32)
        for i in range(self.L):
            with _load_npz_retry(os.path.join(path, f"slot_{i:05d}.npz"),
                                 self._io_policy) as z:
                p = self._local_f32(z["p"])
                m = self._local_f32(z["m"]) if load_optimizer_states else zl
                v = self._local_f32(z["v"]) if load_optimizer_states else zl
            self.opt.load_state(i, p, m, v)
            self._write_params(i, p)
        with _load_npz_retry(os.path.join(path, "resident.npz"),
                             self._io_policy) as z:
            nres = meta["n_res_leaves"]
            res = {k: [z[f"{k}_{j}"] for j in range(nres)]
                   for k in ("master", "m", "v")}
        if not load_optimizer_states:
            res = {k: (arrs if k == "master"
                       else [np.zeros_like(a) for a in arrs])
                   for k, arrs in res.items()}
        self._load_resident_state(
            res, meta["res_step_count"] if load_optimizer_states else 0)
        self.opt.step_count = (int(meta["step_count"])
                               if load_optimizer_states else 0)
        self.param_store.flush()
        self.opt.flush()

    def state_dict(self) -> Dict:
        n = self.n_elems
        return {"step_count": self.opt.step_count,
                "slots": [tuple(a[:n] for a in self.opt.state(i))
                          for i in range(self.L)],
                "resident": self._resident_state_host(),
                "res_step_count": self.res_step_count}

    def load_state_dict(self, sd: Dict) -> None:
        self.opt.step_count = int(sd["step_count"])
        for i, (p, m, v) in enumerate(sd["slots"]):
            p, m, v = (self._local_f32(np.asarray(a)) for a in (p, m, v))
            self.opt.load_state(i, p, m, v)
            self._write_params(i, p)
        self._load_resident_state(sd["resident"], sd["res_step_count"])
        self.param_store.flush()
        self.opt.flush()

    def close(self) -> None:
        for w in self._workers:
            w.shutdown(wait=True)
        self.param_store.close()
        self.opt.close()
        if self._aio is not None:
            self._aio.close()


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _host(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float32).numpy()
    return np.asarray(a, np.float32)


def infinity_fp32_state_dict(inf_path: str) -> Dict[str, Any]:
    """The full float32 params tree of an Infinity checkpoint directory,
    from its flat slots and the leaf layout in its meta (no live engine:
    the offline half of ``zero_to_fp32``); float32 host tensors."""
    with open(os.path.join(inf_path, "meta.json")) as f:
        meta = json.load(f)
    if "layer_leaves" not in meta:
        raise ValueError(
            f"{inf_path} was saved before leaf layouts were recorded — "
            f"load it through a live engine instead")
    nl = meta["L"]
    rows = []
    for i in range(nl):
        with np.load(os.path.join(inf_path, f"slot_{i:05d}.npz")) as z:
            rows.append(z["p"])
    slots = np.stack(rows)
    params: dict = {}
    blocks: dict = {}
    off = 0
    for leaf in meta["layer_leaves"]:
        size = int(np.prod(leaf["shape"])) if leaf["shape"] else 1
        arr = np.ascontiguousarray(slots[:, off:off + size]).reshape(
            [nl] + leaf["shape"])
        _nest(blocks, tuple(leaf["path"].split("/")), torch.from_numpy(arr))
        off += size
    if off != slots.shape[1]:
        raise ValueError(
            f"infinity checkpoint layout mismatch: leaf shapes cover {off} "
            f"elements but slots hold {slots.shape[1]} — meta.json was "
            f"written by a different model revision")
    params["blocks"] = blocks
    with np.load(os.path.join(inf_path, "resident.npz")) as z:
        for j, leaf in enumerate(meta["res_leaves"]):
            _nest(params, tuple(leaf["path"].split("/")),
                  torch.from_numpy(np.array(z[f"master_{j}"], np.float32)))
    return params
