"""Training engine of the port on one device.

Counterpart of ``deepspeed_tpu/runtime/engine.py`` (``DeepSpeedEngine``)
for ZeRO stage 0 on one card: the same state tree, the same step
semantics, the same native (``train_step``/``train_batch``) and compat
(``forward``/``backward``/``step``) surfaces.  Where the JAX engine
compiles the step into one program, this one runs it eagerly:

* state: ``{"step", "skipped", "params", "opt"}`` with float32 master
  params, the optimizer's float32 state (Adam's and LAMB's ``{"step",
  "m", "v"}``, SGD's momentum, Adagrad's sums, or a client
  ``torch.optim`` optimizer's own) and int32 counters, all on the
  engine's device;
* each micro batch runs the model's loss on the params cast to the
  compute dtype (bf16 with ``bf16.enabled``, f16 with ``fp16.enabled``,
  the model's activations then in float16 too) times the loss scale;
  the gradient reaches the float32 masters through the cast's backward,
  and the gas loop sums float32 gradients and scaled losses;
* an MoE model's ``batch["moe_rng"]`` (a seed) becomes one routing seed
  per micro batch (``moe_seeds``), kept on the host; the model's loss
  draws each layer's RTS or Gumbel noise from a generator seeded with
  it, so one seed gives one routing and micro batches differ;
* ``_apply_grads`` divides by ``scale * gas``, checks the gradients for
  inf/NaN when a dynamic loss scaler runs (``runtime/fp16``), takes the
  global norm before clipping, clips by ``min(1, clip / max(norm,
  1e-6))``, reads the lr of ``state["step"]`` before the increment, and
  on overflow or a non-finite norm keeps params, moments and Adam's step
  (``torch.where`` on the device, no host sync) while ``skipped`` counts
  the step; the scaler's state (``state["scaler"]``) moves the same way.

Metrics come back as device tensors, as the JAX engine returns device
scalars; nothing in a step waits for the card unless ``steps_per_print``,
``wall_clock_breakdown`` or the ``observability`` block asks to read
them.  With that block (``observability/``) the step records the
``engine/*`` spans (``engine/train_step`` around the step, and inside it
``engine/forward`` and ``engine/backward`` per micro batch and
``engine/optimizer_step``: host time of eager launches, no sync), then
``engine/step_sync``, the one span that waits for the card, feeding
``dstpu_step_time_seconds``, ``dstpu_train_steps_total``,
``dstpu_train_skipped_steps_total``, the flight recorder and the overlap
profiler; ``flush_observability()`` writes the trace and the metric
exports.  A ``Heartbeat`` (``DSTPU_HEARTBEAT_FILE``) beats every step
and around checkpoint writes.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ..accelerator import resolve_device
from ..models.convert import check_params, leaf_to_torch
from ..observability import trace_span
from ..utils.logging import logger
from . import lr_schedules
from .config import DeepSpeedConfig
from .fp16.loss_scaler import DynamicLossScaler, static_loss_scaler
from .optimizers import (Optimizer, get_optimizer, tree_leaves, tree_map,
                         wrap_torch)
from .resilience.heartbeat import Heartbeat

_COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                   "float32": torch.float32}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree_leaves(tree)))


def moe_seeds(rng: Any, gas: int) -> torch.Tensor:
    """``batch["moe_rng"]`` as one routing seed per micro batch, an int64
    CPU tensor ``[gas]`` (the JAX engine splits its key into one per
    micro batch, so gate noise differs across gradient accumulation): a
    seed (int, 0-d or one-element) spawns ``gas`` seeds from a generator
    seeded with it; ``gas`` seeds are taken as given."""
    if isinstance(rng, torch.Generator):
        raise ValueError(
            "batch['moe_rng'] must be a seed (an int) or one seed per "
            f"micro batch ({gas},), not a torch.Generator")
    t = torch.as_tensor(np.asarray(rng.cpu() if isinstance(rng, torch.Tensor)
                                   else rng), dtype=torch.int64).reshape(-1)
    if t.numel() == 1:
        g = torch.Generator()
        g.manual_seed(int(t[0]))
        return torch.randint(0, 2**62, (gas,), generator=g,
                             dtype=torch.int64)
    if t.numel() != gas:
        raise ValueError(f"moe_rng must be a seed or per-microbatch seeds "
                         f"({gas},); got {tuple(t.shape)}")
    return t


class DeepSpeedEngine:
    """Training engine on one device (``device`` None = the card; raises
    without one).  ``params`` seeds the masters (a tree of tensors or
    numpy arrays, e.g. from the JAX package through
    ``models/convert.py``); without it the model's own init runs from
    ``seed``."""

    def __init__(self, model, config: Any = None,
                 optimizer: Optional[Optimizer] = None,
                 lr_scheduler: Optional[Callable] = None,
                 loss_fn: Optional[Callable] = None,
                 params: Optional[Dict[str, Any]] = None,
                 device=None, seed: int = 0):
        self._config = (config if isinstance(config, DeepSpeedConfig)
                        else DeepSpeedConfig(config or {}))
        self._config.refuse_out_of_slice()
        self.device = resolve_device(device)
        # worker side of a hung-worker watchdog: beat the file named by
        # DSTPU_HEARTBEAT_FILE once per interval (no-op without it)
        self._heartbeat = Heartbeat(
            interval_s=self._config.resilience.heartbeat_interval_s)
        # observability: the process-global tracer and registry (the
        # newest engine's block wins), the flight recorder and the
        # overlap profiler; each site is one attribute check when off
        from ..observability import (configure, get_flight_recorder,
                                     get_overlap_profiler)
        self._tracer, self._obs = configure(self._config.observability)
        self._flight = get_flight_recorder()
        self._ovl = get_overlap_profiler()
        self._skip_burst = 0
        if self._obs.enabled:
            self._obs.set_collector("engine", self._obs_collect)
        model = self._apply_training_overrides(model)
        self.model = model
        self.dp_world_size = 1
        self._config.resolve_batch_sizes(self.dp_world_size)
        self.zero_stage = self._config.zero_optimization_stage
        self.fp16_enabled = self._config.fp16.enabled
        self.bf16_enabled = self._config.bf16.enabled
        self.compute_dtype = _COMPUTE_DTYPES[self._config.precision_dtype]
        self.gradient_accumulation_steps = (
            self._config.gradient_accumulation_steps or 1)
        self.train_micro_batch_size_per_gpu = \
            self._config.train_micro_batch_size_per_gpu
        self.train_batch_size = self._config.train_batch_size
        self._loss_fn = loss_fn or getattr(model, "loss", None)
        if self._loss_fn is None:
            raise ValueError("Need model.loss or an explicit loss_fn")
        self.optimizer = self._configure_optimizer(optimizer)
        self.lr_schedule = self._configure_lr_schedule(lr_scheduler)
        fp16c = self._config.fp16
        self.loss_scaler: Optional[DynamicLossScaler] = None
        if self.fp16_enabled:
            self.loss_scaler = (
                DynamicLossScaler(
                    initial_scale_power=fp16c.initial_scale_power,
                    scale_window=fp16c.loss_scale_window,
                    min_scale=fp16c.min_loss_scale,
                    hysteresis=fp16c.hysteresis)
                if fp16c.dynamic else static_loss_scaler(fp16c.loss_scale))
        self.global_steps = 0
        self.micro_steps = 0
        self._step_times: list = []
        self.state = self.init_state(params, seed)
        self._grad_acc = None
        self._grad_acc_count = 0
        self._last_metrics: Optional[Dict[str, torch.Tensor]] = None
        self._last_lr = float(self.optimizer.hyperparams.get("lr", 0.0))

    # ------------------------------------------------------------------
    # configuration
    # ------------------------------------------------------------------
    def _configure_optimizer(self, optimizer) -> Optimizer:
        """An :class:`Optimizer`, a client ``torch.optim`` class or
        factory (wrapped by ``wrap_torch``, as the JAX engine wraps an
        optax transformation), or the config's ``optimizer`` block."""
        if isinstance(optimizer, Optimizer):
            return optimizer
        if optimizer is not None:
            if not callable(optimizer):
                raise TypeError(
                    f"optimizer must be an Optimizer or a torch.optim "
                    f"class or factory of a list of tensors, got "
                    f"{type(optimizer).__name__}")
            return wrap_torch(optimizer)
        oc = self._config.optimizer
        if oc is None:
            return get_optimizer("adamw")
        return get_optimizer(oc.type, **dict(oc.params))

    def _configure_lr_schedule(self, lr_scheduler):
        sc = self._config.scheduler
        if self.optimizer.hyperparams.get("external_lr"):
            if sc is not None or callable(lr_scheduler):
                raise ValueError(
                    "a client torch.optim optimizer carries its own "
                    "learning rate; remove the engine scheduler (set the "
                    "rate in the optimizer's factory instead)")
            return lr_schedules.constant_lr(0.0)  # reported lr is N/A
        if callable(lr_scheduler):
            return lr_scheduler
        if sc is None:
            return lr_schedules.constant_lr(
                self.optimizer.hyperparams.get("lr", 1e-3))
        return lr_schedules.get_lr_schedule(sc.type, dict(sc.params))

    def _apply_training_overrides(self, model):
        """Rebuild ``model`` with the ``training`` block's model-side
        overrides (remat / fused_loss_head / loss_chunk) and, with
        ``fp16.enabled``, float16 activations (the JAX engine trains fp16
        with the model in float16)."""
        overrides = self._config.training.model_overrides()
        if self._config.fp16.enabled:
            overrides["dtype"] = torch.float16
        if not overrides:
            return model
        mcfg = getattr(model, "config", None)
        if mcfg is None or not dataclasses.is_dataclass(mcfg):
            raise ValueError(
                f"config has training overrides {sorted(overrides)} but "
                f"{type(model).__name__} has no dataclass .config to "
                f"rebuild from")
        applicable = {k: v for k, v in overrides.items()
                      if hasattr(mcfg, k)}
        missing = set(overrides) - set(applicable)
        if missing:
            raise ValueError(
                f"training overrides {sorted(missing)} have no matching "
                f"field on {type(mcfg).__name__}")
        if all(getattr(mcfg, k) == v for k, v in applicable.items()):
            return model
        return type(model)(dataclasses.replace(mcfg, **applicable))

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------
    def init_state(self, params: Optional[Dict[str, Any]] = None,
                   seed: int = 0) -> Dict[str, Any]:
        """The train state on the engine's device: float32 masters (bf16
        when ``bf16.master_weights`` is off), float32 moments, int32
        counters."""
        if params is None:
            g = torch.Generator(device=self.device)
            g.manual_seed(seed)
            params = self.model.init(g, self.device, torch.float32)
        else:
            if hasattr(self.model, "param_shapes"):
                check_params(self.model, params)
            params = tree_map(
                lambda a: (a if isinstance(a, torch.Tensor)
                           else leaf_to_torch(a, "cpu")).to(
                    self.device, torch.float32), params)
        if not self._config.bf16.master_weights and self.bf16_enabled:
            params = tree_map(lambda p: p.to(torch.bfloat16), params)
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        state = {"step": zero.clone(), "skipped": zero.clone(),
                 "params": params, "opt": self.optimizer.init(params)}
        if self.loss_scaler is not None:
            state["scaler"] = self.loss_scaler.init(self.device)
        return state

    def _cast_for_compute(self, params):
        if self.compute_dtype == torch.float32:
            return params
        return tree_map(lambda p: p.to(self.compute_dtype)
                        if p.is_floating_point() else p, params)

    def _current_scale(self, state=None) -> torch.Tensor:
        """The loss scale of ``state`` (default the engine's): the
        scaler's, or 1."""
        state = self.state if state is None else state
        if self.loss_scaler is not None:
            return state["scaler"].scale
        return torch.ones((), dtype=torch.float32, device=self.device)

    def _micro_loss_and_grads(self, params, micro_batch, scale):
        """(scaled loss, float32 grads of the masters) of one micro
        batch: the loss runs on the compute-dtype cast of the masters and
        the gradient comes back through the cast."""
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with trace_span("engine/forward", micro_step=self.micro_steps):
            loss = self._loss_fn(self._cast_for_compute(leaves),
                                 micro_batch) * scale
        flat = list(tree_leaves(leaves))
        with trace_span("engine/backward", micro_step=self.micro_steps):
            grads = torch.autograd.grad(loss, flat)
        it = iter(g.to(torch.float32) for g in grads)
        return loss.detach(), tree_map(lambda _: next(it), leaves)

    def _accumulate_micro_grads(self, state, batch, scale):
        """The gas loop: sum float32 grads and scaled losses over the
        micro batches of ``batch`` (leaves ``[gas, micro, ...]``)."""
        gsum, lsum = None, torch.zeros((), dtype=torch.float32,
                                       device=self.device)
        for i in range(self.gradient_accumulation_steps):
            mb = {k: v[i] for k, v in batch.items()}
            loss, grads = self._micro_loss_and_grads(state["params"], mb,
                                                     scale)
            gsum = grads if gsum is None else tree_map(torch.add, gsum,
                                                       grads)
            lsum = lsum + loss
        return gsum, lsum

    def _apply_grads(self, state, grads, n_micro, overflow=None):
        """Summed grads → clipped AdamW update → (new state, metrics)."""
        cfg = self._config
        scale = self._current_scale(state)
        denom = scale * n_micro
        # the summed grads are the engine's own float32 buffers: scaled
        # (and clipped below) in place, so no second tree of gradients
        # lives at the step's peak of memory
        grads = tree_map(lambda g: (g.div_(denom) if g.dtype == torch.float32
                                    else g.to(torch.float32) / denom), grads)
        if overflow is None:
            if (self.loss_scaler is not None
                    and self.loss_scaler.detect_overflow):
                overflow = DynamicLossScaler.has_overflow(
                    tree_leaves(grads)).to(self.device)
            else:
                overflow = torch.zeros((), dtype=torch.bool,
                                       device=self.device)
        gnorm = global_norm(grads)
        if cfg.resilience.skip_nonfinite_grad_steps:
            # a NaN/Inf global norm would poison params and moments:
            # skip the update and count it in state["skipped"]
            overflow = overflow | ~torch.isfinite(gnorm)
        if cfg.gradient_clipping and cfg.gradient_clipping > 0:
            factor = torch.clamp(
                cfg.gradient_clipping / torch.clamp(gnorm, min=1e-6),
                max=1.0)
            grads = tree_map(lambda g: g.mul_(factor), grads)
        lr = self.lr_schedule(state["step"])
        new_params, new_opt = self.optimizer.apply(
            grads, state["opt"], state["params"], lr)

        def select(new, old):
            """``old`` where the step overflowed, else ``new``, leaf by
            leaf on the device.  Where the two trees differ in structure
            (a client optimizer's state, built lazily on its first step)
            the choice is made on the host, once."""
            if isinstance(new, dict) and isinstance(old, dict) \
                    and new.keys() == old.keys():
                return {k: select(new[k], old[k]) for k in new}
            if isinstance(new, torch.Tensor) and \
                    isinstance(old, torch.Tensor):
                if new is old:
                    return old
                # into the optimizer's fresh tensor: no third copy of the
                # params and moments beside the old and the new
                return torch.where(overflow.to(new.device), old, new,
                                   out=new)
            return old if bool(overflow) else new
        new_state = {
            "step": state["step"] + (~overflow).to(torch.int32),
            "skipped": state["skipped"] + overflow.to(torch.int32),
            "params": select(new_params, state["params"]),
            "opt": select(new_opt, state["opt"])}
        if self.loss_scaler is not None:
            new_state["scaler"] = self.loss_scaler.update(state["scaler"],
                                                          overflow)
        metrics = {"grad_norm": gnorm, "lr": lr,
                   "overflow": overflow.to(torch.int32),
                   "loss_scale": scale}
        return new_state, metrics

    # ------------------------------------------------------------------
    # native API
    # ------------------------------------------------------------------
    def shard_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Host batch ``[gas * micro, ...]`` or ``[gas, micro, ...]`` →
        tensors ``[gas, micro, ...]`` on the engine's device (token ids
        as int64)."""
        gas = self.gradient_accumulation_steps
        global_b = self.train_batch_size

        def prep(x):
            t = x if isinstance(x, torch.Tensor) else \
                torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
            if not t.is_floating_point():
                t = t.long()
            if t.dim() >= 1 and t.shape[0] == global_b:
                t = t.reshape((gas, global_b // gas) + tuple(t.shape[1:]))
            elif not (t.dim() >= 2 and t.shape[0] == gas):
                raise ValueError(
                    f"batch leading dim {t.shape[0]} matches neither the "
                    f"batch ({global_b}) nor [gas={gas}, ...] layout")
            return t.to(self.device, non_blocking=True)
        return {k: (moe_seeds(v, gas) if k == "moe_rng" else prep(v))
                for k, v in batch.items()}

    def train_step(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """One optimizer step over ``gas`` micro batches; returns metrics
        as device tensors (loss, grad_norm, lr, overflow, loss_scale)."""
        self._heartbeat.maybe_beat()
        with trace_span("engine/shard_batch"):
            batch = self.shard_batch(batch)
        t0 = time.perf_counter()
        with trace_span("engine/train_step", mode="eager",
                        step=self.global_steps):
            scale = self._current_scale()
            gsum, lsum = self._accumulate_micro_grads(self.state, batch,
                                                      scale)
            gas = self.gradient_accumulation_steps
            with trace_span("engine/optimizer_step", step=self.global_steps):
                self.state, metrics = self._apply_grads(self.state, gsum,
                                                        float(gas))
            metrics["loss"] = lsum / (scale * gas)
        # launches returned: the overlap profiler's enqueue/device-wait
        # boundary (the wait ends at the step_sync join below)
        t_enq = time.perf_counter()
        self.global_steps += 1
        self.micro_steps += gas
        step_s = None
        if self._obs.enabled or self._flight.enabled or self._ovl.enabled:
            # the one join the telemetry needs, on the step's loss: the
            # only span that waits for the card
            with trace_span("engine/step_sync", step=self.global_steps):
                metrics["loss"].item()
            t_end = time.perf_counter()
            step_s = t_end - t0
            if self._ovl.enabled:
                self._ovl.observe("train", total_s=step_s,
                                  enqueue_s=t_enq - t0,
                                  wait_s=t_end - t_enq)
        if self._config.wall_clock_breakdown:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._step_times.append(time.perf_counter() - t0)
        self._last_metrics = metrics
        self._post_step_observe(metrics, step_s)
        return metrics

    def _post_step_observe(self, metrics: Dict[str, torch.Tensor],
                           step_s: Optional[float] = None) -> None:
        """The periodic log line, the flight recorder's snapshot (a burst
        of skipped steps dumps a post-mortem bundle), the step counters
        and the step-time histogram, and the periodic metric export.
        Reading the metrics is a host sync; it happens only when one of
        these is on."""
        every = self._config.steps_per_print
        do_print = bool(every) and self.global_steps % every == 0
        obs, fr = self._obs, self._flight
        if not (do_print or obs.enabled or fr.enabled):
            return
        m = {k: float(v) for k, v in metrics.items()}
        step = self.global_steps
        if fr.enabled:
            fr.record({"kind": "train_step", "step": step, "t": time.time(),
                       "loss": m.get("loss"), "grad_norm": m.get("grad_norm"),
                       "loss_scale": m.get("loss_scale"),
                       "overflow": bool(m.get("overflow"))})
            if m.get("overflow"):
                self._skip_burst += 1
                if self._skip_burst >= fr.skip_burst_steps:
                    fr.dump("skipped_step_burst",
                            f"{self._skip_burst} consecutive skipped "
                            f"steps ending at step {step}",
                            extra={"loss_scale": m.get("loss_scale"),
                                   "grad_norm": m.get("grad_norm")})
                    self._skip_burst = 0
            else:
                self._skip_burst = 0
        if obs.enabled:
            obs.counter("dstpu_train_steps_total").inc()
            if m.get("overflow"):
                obs.counter("dstpu_train_skipped_steps_total").inc()
            if step_s is not None:
                obs.histogram("dstpu_step_time_seconds").observe(step_s)
            from ..observability import export_interval_steps, export_metrics
            ivl = export_interval_steps()
            if ivl and step % ivl == 0:
                export_metrics()
        if do_print:
            logger.info(f"step={step} loss={m['loss']:.4f} "
                        f"lr={m['lr']:.3e} grad_norm={m['grad_norm']:.3f} "
                        f"loss_scale={m['loss_scale']:.0f}")

    def _obs_collect(self) -> None:
        """Export-time refresh of the device-memory watermark (a host-side
        read of the allocator's statistics; no device sync)."""
        if self.device.type == "cuda":
            self._obs.gauge("dstpu_device_peak_memory_bytes").set(
                float(torch.cuda.max_memory_allocated(self.device)))

    def flush_observability(self, sync: bool = True):
        """Write the span trace and the metric exports.  ``sync=True``
        first joins the last step's loss, the explicit flush-boundary
        device sync, so the trace covers fully executed work.  Returns
        the files written."""
        from ..observability import flush_all
        val = None
        if sync and self._last_metrics:
            val = self._last_metrics.get("loss")
        return flush_all(sync=val)

    def train_batch(self, data_iter: Optional[Iterable] = None,
                    batch: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        """Pull one batch from ``data_iter`` (a loader is iterated across
        calls and restarted at its end) and step."""
        if batch is None:
            if not hasattr(data_iter, "__next__"):
                if getattr(self, "_data_iter_src", None) is not data_iter:
                    self._data_iter_src = data_iter
                    self._data_iter = iter(data_iter)
                try:
                    batch = next(self._data_iter)
                except StopIteration:
                    self._data_iter = iter(data_iter)
                    batch = next(self._data_iter)
            else:
                batch = next(data_iter)
        return self.train_step(batch)

    @torch.no_grad()
    def eval_loss(self, batch: Dict[str, Any]) -> torch.Tensor:
        """The loss of the whole batch (micro batches flattened), no
        gradient."""
        sq = {k: (v[0] if k == "moe_rng" else
                  v.reshape((-1,) + tuple(v.shape[2:])))
              for k, v in self.shard_batch(batch).items()}
        return self._loss_fn(self._cast_for_compute(self.state["params"]),
                             sq)

    # ------------------------------------------------------------------
    # compat API: forward / backward / step
    # ------------------------------------------------------------------
    def forward(self, batch: Dict[str, Any]) -> torch.Tensor:
        """Loss and gradients of one micro batch ``[micro, ...]``; the
        gradients wait for :meth:`backward`."""
        mb = {k: (v if isinstance(v, torch.Tensor) else
                  torch.from_numpy(np.ascontiguousarray(np.asarray(v))))
              for k, v in batch.items()}
        mb = {k: (v.reshape(()) if k == "moe_rng" else
                  (v if v.is_floating_point() else v.long()).to(self.device))
              for k, v in mb.items()}
        self._last_loss, self._last_grads = self._micro_loss_and_grads(
            self.state["params"], mb, self._current_scale())
        return self._last_loss

    __call__ = forward

    def backward(self, loss=None) -> None:
        """Accumulate the gradients of the last forward."""
        del loss  # the gradients were taken alongside forward
        grads = self._last_grads
        self._grad_acc = (grads if self._grad_acc is None else
                          tree_map(torch.add, self._grad_acc, grads))
        self._grad_acc_count += 1
        self.micro_steps += 1

    def is_gradient_accumulation_boundary(self) -> bool:
        return self._grad_acc_count >= self.gradient_accumulation_steps

    def step(self) -> None:
        self._heartbeat.maybe_beat()
        if self._grad_acc is None:
            return
        n = torch.tensor(float(self._grad_acc_count), dtype=torch.float32,
                         device=self.device)
        with trace_span("engine/optimizer_step", step=self.global_steps):
            self.state, metrics = self._apply_grads(self.state,
                                                    self._grad_acc, n)
        self._grad_acc = None
        self._grad_acc_count = 0
        self.global_steps += 1
        self._last_metrics = metrics

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def get_lr(self) -> float:
        return float(self.lr_schedule(self.state["step"]))

    def get_global_grad_norm(self) -> Optional[float]:
        m = self._last_metrics
        return float(m["grad_norm"]) if m else None

    @property
    def skipped_steps(self) -> int:
        return int(self.state["skipped"])

    @property
    def loss_scale(self) -> float:
        return float(self._current_scale())

    def num_parameters(self) -> int:
        return sum(int(p.numel()) for p in tree_leaves(self.state["params"]))

    # ------------------------------------------------------------------
    # checkpointing (runtime/checkpoint_engine)
    # ------------------------------------------------------------------
    def save_checkpoint(self, save_dir: str, tag: Optional[str] = None,
                        client_state: Optional[dict] = None) -> str:
        """Save the train state under ``save_dir/tag`` (default
        ``global_step<N>``) and point ``latest`` at it once committed."""
        from .checkpoint_engine.engine import save_checkpoint as _save
        # a long checkpoint write is the longest legitimate gap between
        # steps: beat around it so a watchdog does not read it as a hang
        self._heartbeat.beat_now()
        try:
            return _save(self, save_dir, tag=tag,
                         client_state=client_state or {})
        finally:
            self._heartbeat.beat_now()

    def load_checkpoint(self, load_dir: str, tag: Optional[str] = None,
                        **kw):
        """Restore the train state (``latest`` unless ``tag``); returns
        ``(path, client_state)``."""
        from .checkpoint_engine.engine import load_checkpoint as _load
        self._heartbeat.maybe_beat()
        return _load(self, load_dir, tag=tag, **kw)
