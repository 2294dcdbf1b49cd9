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

With an offload block (``zero_optimization`` stage 1-3: one device runs
them as one program) the engine runs the JAX engine's offload tiers:
``offload_optimizer`` alone is ZeRO-Offload (``zero/offload.py``: state
``{"step", "skipped", "params"}`` with compute-dtype params on the
device, float32 masters and moments on the host, each step's grads summed
into one flat float32 buffer and swept by the native host Adam in
overlapped pieces, one host sync a step), and ``offload_param`` is
ZeRO-Infinity (``zero/infinity.py``: the params live in host or NVMe
slot stores and stream a layer at a time); both return host metrics and
refuse the compat ``forward``/``backward``/``step``.

Data parallelism with ZeRO stages 0-3 (``zero_optimization.stage``
without offload, or a ``mesh`` whose ``data``/``dcn_data`` axes are
above 1) runs one process per rank on ``torch.distributed``
(``comm.init_distributed``): the engine builds the rank's
``ProcessMesh`` and a ``ZeroPartition`` (``zero/partitioned.py``) from
the JAX package's sharding policy (``zero/sharding.py``), so rank r
holds the shards device r holds on the JAX engine's ``data`` mesh.
Each rank runs its local slice of the global batch; the step then
all-reduces the summed grads (stage 0, 1; stage 1 keeps its shard),
reduce-scatters them each micro batch (stage 2), or takes them from
stage 3's per-layer gather (``GatherCast``'s backward), updates its
float32 master and moment shards, and all-gathers the new
compute-dtype params (stages 1-2).  Each rank's backward runs at the
loss scale over dp, so the sum over the ranks is the global mean's
gradient.  The global norm sums each shard's squares over the ranks and
counts a resident leaf once; an fp16 overflow is reduced over the
ranks; the loss is the ranks' mean.

Tensor parallelism (a ``mesh`` with ``model`` above 1, or
``tensor_parallel.tp_size``, at ZeRO stages 0-2) composes Megatron's
layout with ZeRO over ``data``: each rank keeps its slice of every leaf
the model's ``partition_specs`` shards (the fused qkv stays whole over
``model``) and ZeRO's shard of that slice, and the loss runs the model's
per-shard view (``tp_train_view``: ``copy_to``/``reduce_from`` around
each branch, the vocab-parallel cross-entropy).  Inside the
differentiated function each shard gathers its own qkv columns and
divides the row-parallel biases by mp (``_tp_localize``), so those
leaves' gradients are partial: one all-reduce over ``model`` sums them
after the data-axis reduction (``psum_tp_partials``).  The global norm
sums a model-sharded leaf's squares over the model ranks and counts a
replicated one once.  The ranks of one data coordinate take the same
rows of the global batch (``dp_rank``).  On
``nccl`` nothing in the step waits for the card; ``gloo`` stages each
collective through host memory (``comm.py``).  A mesh with ``pipe``
above 1 takes the subclass ``runtime/pipe/engine.py::PipelineEngine``,
which keeps this step's state, plans and optimizer over its stage's
slice (``_train_specs``, ``_local_slice`` and ``_whole`` are its
hooks) and replaces the gas loop by the pipeline schedule.

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

from .. import comm
from ..accelerator import resolve_device
from ..models.convert import (OPT_TREES, check_params, leaf_to_torch,
                              tp_dims, tp_gather, tp_slice)
from ..parallel.collectives import (TP_PARTIAL_SUFFIXES, psum_tp_partials,
                                    qkv_shard_columns)
from ..parallel.topology import (DATA_AXES, MODEL_AXIS, build_mesh,
                                 dp_world_size, mp_world_size,
                                 pp_world_size)
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


def config_mesh(config: DeepSpeedConfig, mesh=None):
    """The rank's process mesh: ``mesh`` when given, else the config's
    ``mesh`` block with ``tensor_parallel``'s size as its model axis."""
    if mesh is not None:
        return mesh
    mesh_cfg = config.mesh
    tp = config.tensor_parallel.degree()
    if tp > 1:
        if mesh_cfg.model not in (1, tp):
            raise ValueError(
                f"tensor_parallel.tp_size {tp} disagrees with mesh.model "
                f"{mesh_cfg.model}")
        mesh_cfg = dataclasses.replace(mesh_cfg, model=tp)
    return build_mesh(mesh_cfg)


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
                 device=None, seed: int = 0, mesh=None):
        self._config = (config if isinstance(config, DeepSpeedConfig)
                        else DeepSpeedConfig(config or {}))
        self._config.refuse_out_of_slice()
        self.device = resolve_device(device)
        # the rank's place on the mesh (one rank, all axes 1, without
        # torch.distributed); collectives resolve axis names against it
        self.mesh = config_mesh(self._config, mesh)
        comm.set_mesh(self.mesh)
        self.dp_world_size = dp_world_size(self.mesh)
        self.mp_world_size = mp_world_size(self.mesh)
        #: this rank's data coordinate: the rows of the global batch it
        #: takes (``dataloader.rank_slice``); the model ranks of one data
        #: coordinate take the same rows
        self.dp_rank = self.mesh.axis_index(DATA_AXES)
        self._config.refuse_out_of_slice(mesh_shape=self.mesh.shape)
        if self._config.comms_logger_dict and \
                self._config.comms_logger_dict.get("enabled"):
            comm.configure(config=self._config.comms_logger_dict)
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
        # tensor parallelism: the loss runs the model's per-shard view
        # over this rank's slice (stages 0-2)
        self._tp_view = None
        if self.mp_world_size > 1:
            if loss_fn is not None or not hasattr(model, "tp_train_view"):
                raise NotImplementedError(
                    "tensor parallelism trains a TransformerLM through its "
                    "own loss (a client loss_fn has no per-shard view)")
            self._tp_view = model.tp_train_view(self.mp_world_size,
                                                MODEL_AXIS)
            loss_fn = self._tp_view.loss
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
        # -- ZeRO-Offload tiers (host optimizer / Infinity streaming) --
        from .zero.offload import validate_offload_config
        offload_mode = validate_offload_config(self._config)
        self.offload_enabled = offload_mode == "optimizer"
        self.infinity_enabled = offload_mode == "infinity"
        self._host_opt = None
        self._host_scaler = None
        self._infinity = None
        if offload_mode != "none" and optimizer is not None:
            raise ValueError(
                "offload needs a config-named optimizer (Adam/AdamW/"
                "Adagrad) — the host step runs in native code, not "
                "through a user optimizer object")
        # ZeRO over the data-parallel ranks (zero/partitioned.py); built
        # in init_state once the params' shapes are known
        self._zero = None
        self._live = None
        self._zero_bytes: Dict[str, int] = {}
        if offload_mode == "none" and (self.zero_stage >= 1
                                       or self.dp_world_size > 1
                                       or self.mp_world_size > 1
                                       or pp_world_size(self.mesh) > 1):
            self._refuse_zero_optimizer()
            self._zero_path = True
        else:
            self._zero_path = False
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
        if self.infinity_enabled:
            from .zero.infinity import InfinityStepper
            self._infinity = InfinityStepper(self, params, seed)
            zero = torch.zeros((), dtype=torch.int32, device=self.device)
            return {"step": zero.clone(), "skipped": zero.clone()}
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
        if self.offload_enabled:
            return self._init_state_offload(params)
        if self._zero_path:
            return self._init_state_zero(params)
        if not self._config.bf16.master_weights and self.bf16_enabled:
            params = tree_map(lambda p: p.to(torch.bfloat16), params)
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        state = {"step": zero.clone(), "skipped": zero.clone(),
                 "params": params, "opt": self.optimizer.init(params)}
        if self.loss_scaler is not None:
            state["scaler"] = self.loss_scaler.init(self.device)
        return state

    def _refuse_zero_optimizer(self) -> None:
        """The optimizers a data-parallel ZeRO step, or a model- or
        stage-sharded one, cannot run on shards: LAMB's trust ratio
        spans a whole leaf, and a client torch.optim optimizer's state
        is not a tree of the params' shape."""
        if self.mp_world_size > 1 or pp_world_size(self.mesh) > 1:
            if self.optimizer.name == "lamb" or \
                    self.optimizer.hyperparams.get("external_lr"):
                kind = "tensor" if self.mp_world_size > 1 else "pipeline"
                raise NotImplementedError(
                    f"LAMB or a client torch.optim optimizer under {kind} "
                    f"parallelism: no rank holds a whole leaf (not in the "
                    f"PyTorch port yet)")
            return
        if self.dp_world_size == 1 or self.zero_stage == 0:
            return
        if self.optimizer.name == "lamb":
            raise NotImplementedError(
                "LAMB under ZeRO stage >= 1 at a data-parallel size above "
                "1: its trust ratio spans a whole leaf, which no rank "
                "holds (not in the PyTorch port yet)")
        if self.optimizer.hyperparams.get("external_lr"):
            raise NotImplementedError(
                "a client torch.optim optimizer under ZeRO stage >= 1 at a "
                "data-parallel size above 1 (not in the PyTorch port yet)")

    def _init_state_zero(self, params) -> Dict[str, Any]:
        """ZeRO init: the plans from the whole params' shapes, then this
        rank keeps its float32 master shards, its moment shards (the
        optimizer's init over the shards) and, at stages 1-2, the whole
        params in the compute dtype."""
        from .zero.partitioned import ZeroPartition, shape_tree
        from .zero.sharding import ZeroShardingPolicy
        zc = self._config.zero_config
        self._full_shapes = shape_tree(params)
        specs = self._train_specs(params)
        tdims = None
        if self._tp_view is not None:
            tdims = self._tp_dims = tp_dims(specs)
        params = self._local_slice(params)
        policy = ZeroShardingPolicy(
            self.zero_stage, self.mesh, self._full_shapes, specs,
            param_persistence_threshold=(zc.param_persistence_threshold
                                         if self.zero_stage >= 3 else 0))
        self._zero = ZeroPartition(policy, self.mesh, tp_dims=tdims)
        self._param_shapes = shape_tree(params)
        if not self._config.bf16.master_weights and self.bf16_enabled:
            params = tree_map(lambda p: p.to(torch.bfloat16), params)
        masters = self._zero.shard(params, self._zero.master_dims)
        if self.zero_stage in (1, 2):
            self._live = self._cast_for_compute(params)
        del params
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        state = {"step": zero.clone(), "skipped": zero.clone(),
                 "params": masters, "opt": self.optimizer.init(masters)}
        if self.loss_scaler is not None:
            state["scaler"] = self.loss_scaler.init(self.device)
        return state

    # ------------------------------------------------------------------
    # tensor parallelism
    # ------------------------------------------------------------------
    def _train_specs(self, params):
        """The spec tree ZeRO's policy starts from (None: every dim
        free)."""
        return (self._tp_train_specs(params) if self._tp_view is not None
                else None)

    def _local_slice(self, tree):
        """A whole tree in the world-1 layout → this rank's part of it
        before ZeRO's data shard: its model slice."""
        if self._tp_view is not None:
            tree = tp_slice(tree, self._tp_dims, self.mp_world_size,
                            self.mesh.axis_index(MODEL_AXIS))
        return tree

    def _whole(self, tree):
        """The inverse of :meth:`_local_slice` (a collective: every rank
        calls it)."""
        if self._tp_view is not None:
            tree = tp_gather(tree, self._tp_dims, MODEL_AXIS)
        return tree

    def _tp_train_specs(self, params):
        """The model's Megatron specs with the fused qkv replicated over
        ``model``: each shard gathers its own columns inside the
        differentiated step (``_tp_localize``), and their partial
        gradients are summed at the step's exit."""
        def strip(tree, path=()):
            if isinstance(tree, dict):
                return {k: strip(v, path + (k,)) for k, v in tree.items()}
            if path[-2:] in (("qkv", "kernel"), ("qkv", "bias")):
                return tuple(None if e == MODEL_AXIS else e for e in tree)
            return tree
        # the params' own tree, so the specs' leaves come in its order
        return strip(self.model.partition_specs(params))

    def _tp_localize(self, params):
        """Inside the differentiated function: each shard's fused-qkv
        columns (``qkv_shard_columns``; the gather's backward puts the
        partial gradient back in the whole layout) and the row-parallel
        biases divided by mp (``reduce_from`` restores them).  The
        identity without a model axis."""
        if self._tp_view is None:
            return params
        c, mp = self.model.config, self.mp_world_size
        cols = torch.as_tensor(
            qkv_shard_columns(c.num_heads, c.kv_heads, c.hdim, mp)[
                self.mesh.axis_index(MODEL_AXIS)], dtype=torch.long,
            device=self.device)

        def walk(tree, path=()):
            if isinstance(tree, dict):
                return {k: walk(v, path + (k,)) for k, v in tree.items()}
            tail = path[-2:]
            if tail in (("qkv", "kernel"), ("qkv", "bias")):
                return tree.index_select(-1, cols)
            if tail in TP_PARTIAL_SUFFIXES:
                return tree / mp
            return tree
        return walk(params)

    def _zero_micro(self, mb, scale):
        """(scaled loss, float32 grads) of one micro batch on this rank
        under ZeRO: stage 0 through the cast of the whole masters, stages
        1-2 of the live compute-dtype params, stage 3 of the master
        shards through the per-layer gather (sharded leaves' grads come
        back reduce-scattered)."""
        z, dtype = self._zero, self.compute_dtype
        if self.zero_stage == 0:
            return self._micro_loss_and_grads(self.state["params"], mb,
                                              scale)
        src = self._live if self.zero_stage < 3 else self.state["params"]
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), src)
        with z.hooks(self.model, dtype):
            with trace_span("engine/forward", micro_step=self.micro_steps):
                params = (leaves if self.zero_stage < 3 else
                          z.stage3_params(leaves, dtype))
                loss = self._loss_fn(self._tp_localize(params), mb) * scale
            with trace_span("engine/backward", micro_step=self.micro_steps):
                grads = torch.autograd.grad(loss, list(tree_leaves(leaves)))
        it = iter(g.to(torch.float32) for g in grads)
        return loss.detach(), tree_map(lambda _: next(it), leaves)

    def _zero_accumulate(self, batch, scale):
        """The gas loop under ZeRO: each micro batch's grads, of its loss
        times ``scale / dp``, reduced as the stage says
        (``ZeroPartition.reduce_micro``) and summed in place; then
        ``finish`` (the step's all-reduces) and the loss summed over the
        ranks."""
        gsum, lsum = None, torch.zeros((), dtype=torch.float32,
                                       device=self.device)
        # each rank's loss is its local mean: over dp it is 1/dp of the
        # global mean's, so the backward runs at scale / dp and the grads
        # summed over the ranks are the global mean's (the JAX engine's,
        # and an fp16 overflow at the same scale)
        scale = scale / self.dp_world_size
        for i in range(self.gradient_accumulation_steps):
            mb = {k: v[i] for k, v in batch.items()}
            loss, grads = self._zero_micro(mb, scale)
            grads = self._zero.reduce_micro(grads)
            gsum = grads if gsum is None else tree_map(
                lambda a, b: a.add_(b), gsum, grads)
            lsum = lsum + loss
        self._zero_bytes = self.zero_state_bytes(grads=gsum)
        gsum = self._zero.finish(gsum)
        if self._tp_view is not None:
            # the partial leaves' exit reduction over the model ranks
            gsum = psum_tp_partials(gsum, MODEL_AXIS)
        lsum = comm.all_reduce(lsum, comm.ReduceOp.SUM, self._zero.axes)
        return gsum, lsum

    def zero_state_bytes(self, grads=None) -> Dict[str, int]:
        """This rank's bytes by kind, counted from its tensors: float32
        masters (``params``), the optimizer's trees of the params' shape
        (``opt``: moments, momentum or sums; not its counters), the live
        compute-dtype params (``live``, stages 1-2) and the last step's
        float32 gradient sum (``grads``, as it stood before the step's
        final reduction)."""
        from .zero.partitioned import tree_bytes
        b = {"params": tree_bytes(self.state["params"]),
             "opt": sum(tree_bytes(self.state["opt"][k])
                        for k in OPT_TREES if k in self.state["opt"]),
             "live": tree_bytes(self._live or {})}
        if grads is not None:
            b["grads"] = tree_bytes(grads)
        elif "grads" in self._zero_bytes:
            b["grads"] = self._zero_bytes["grads"]
        return b

    def full_state(self) -> Dict[str, Any]:
        """The train state as a world-1 run keeps it: every rank's master
        and moment shards all-gathered (a collective: every rank calls
        it)."""
        if self._zero is None:
            return self.state
        z = self._zero

        def whole(tree):
            return self._whole(z.gather(tree, z.master_dims))
        st = dict(self.state)
        st["params"] = whole(self.state["params"])
        opt = dict(self.state["opt"])
        for k in OPT_TREES:
            if k in opt:
                opt[k] = whole(opt[k])
        st["opt"] = opt
        return st

    def adopt_state(self, full: Dict[str, Any], partial: bool) -> None:
        """A world-1 layout state (from a checkpoint, on the device) →
        this rank's shards; ``partial`` takes the params and step
        only."""
        z = self._zero
        mine = self._local_slice      # then the data shard
        params = mine(full["params"])
        if partial:
            self.state["params"] = z.shard(params, z.master_dims)
            self.state["step"] = full["step"]
        else:
            st = dict(full)
            st["params"] = z.shard(params, z.master_dims)
            opt = dict(full["opt"])
            for k in OPT_TREES:
                if k in opt:
                    opt[k] = z.shard(mine(opt[k]), z.master_dims)
            st["opt"] = opt
            self.state = st
        if self.zero_stage in (1, 2):
            self._live = self._cast_for_compute(params)

    def _init_state_offload(self, params) -> Dict[str, Any]:
        """Offload init: each float32 leaf's host copy becomes a master of
        the host optimizer and the device keeps its compute-dtype cast
        only (the float32 leaf is dropped as soon as it is taken)."""
        from .zero.offload import HostLossScaler, ZeroOffloadHostOptimizer
        nodes = []

        def walk(tree):
            for k, v in tree.items():
                if isinstance(v, dict):
                    walk(v)
                else:
                    nodes.append((tree, k))
        walk(params)

        def masters():
            for node, k in nodes:
                leaf = node[k]
                yield leaf
                node[k] = leaf.to(self.compute_dtype)
        self._host_opt = ZeroOffloadHostOptimizer(self, masters())
        if self.loss_scaler is not None:
            self._host_scaler = HostLossScaler(self.loss_scaler)
        logger.info(
            f"ZeRO-Offload: {self._host_opt.host_bytes / 2**30:.2f} GiB "
            f"optimizer state in host memory; the device holds "
            f"{self.compute_dtype} params and the float32 grad sum")
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        return {"step": zero.clone(), "skipped": zero.clone(),
                "params": params}

    def _offload_grads(self, batch, scale: float):
        """The gas loop of the offload step into one flat float32 buffer
        on the device (the leaves' concatenation, zero-padded to the wire
        codec's chunk): ``(flat, scaled loss sum)``.  Each micro batch's
        compute-dtype gradient is summed into it leaf by leaf and dropped,
        so no float32 tree of gradients sits beside the buffer."""
        from .zero.wire_codec import CHUNK
        params = self.state["params"]
        leaves = list(tree_leaves(params))
        n = sum(p.numel() for p in leaves)
        n_pad = -(-n // CHUNK) * CHUNK
        flat = getattr(self, "_grad_flat", None)
        if flat is None or flat.numel() != n_pad:
            flat = self._grad_flat = torch.zeros(n_pad, dtype=torch.float32,
                                                 device=self.device)
        views, off = [], 0
        for p in leaves:
            views.append(flat[off:off + p.numel()].view(p.shape))
            off += p.numel()
        lsum = torch.zeros((), dtype=torch.float32, device=self.device)
        for i in range(self.gradient_accumulation_steps):
            mb = {k: v[i] for k, v in batch.items()}
            req = tree_map(lambda p: p.detach().requires_grad_(True), params)
            with trace_span("engine/forward", micro_step=self.micro_steps):
                loss = self._loss_fn(req, mb) * scale
            with trace_span("engine/backward", micro_step=self.micro_steps):
                grads = list(torch.autograd.grad(loss,
                                                 list(tree_leaves(req))))
            for j, view in enumerate(views):
                if i == 0:
                    view.copy_(grads[j])
                else:
                    view.add_(grads[j])
                grads[j] = None          # free each grad once it is summed
            lsum = lsum + loss.detach()
        return flat, lsum

    def _offload_train_step(self, batch) -> Dict[str, torch.Tensor]:
        """grads on the device → the host native sweep → params back (the
        JAX engine's ``_offload_train_step``): one host sync a step, where
        the loss, the norm and the lr cross together."""
        import math
        cfg = self._config
        gas = self.gradient_accumulation_steps
        scale = self._host_scaler.scale if self._host_scaler else 1.0
        step_i = int(self.state["step"])
        t0 = time.perf_counter()
        with trace_span("offload/grads", gas=gas):
            flat, lsum = self._offload_grads(batch, scale)
            gnorm_raw = torch.sqrt(torch.sum(torch.square(flat)))
            lr_t = torch.as_tensor(self.lr_schedule(self.state["step"]),
                                   dtype=torch.float32).to(self.device)
            lsum_h, gnorm_h, lr = torch.stack(
                [lsum, gnorm_raw, lr_t]).cpu().tolist()
        self.offload_timing = {"grads_s": time.perf_counter() - t0}
        denom = scale * gas
        gnorm = gnorm_h / denom
        # a non-finite norm skips the host sweep when the fp16 scaler says
        # so or when resilience hygiene does
        overflow = (not math.isfinite(gnorm)) and (
            (self._host_scaler is not None
             and self._host_scaler.detect_overflow)
            or cfg.resilience.skip_nonfinite_grad_steps)
        if overflow:
            self.state["skipped"] = self.state["skipped"] + 1
        else:
            factor = 1.0
            if cfg.gradient_clipping and cfg.gradient_clipping > 0 \
                    and math.isfinite(gnorm):
                factor = min(1.0, cfg.gradient_clipping / max(gnorm, 1e-6))
            bits = int(cfg.zero_config.offload_wire_bits or 0)
            with trace_span("offload/host_sweep", bucketed=True):
                self._host_opt.step_pipelined(
                    flat, list(tree_leaves(self.state["params"])), lr=lr,
                    grad_scale=denom / factor,
                    fetch=self._wire_fetch(flat, bits, step_i)
                    if bits else None)
            self.offload_timing.update(self._host_opt.timing)
            self.state["step"] = self.state["step"] + 1
        if self._host_scaler is not None:
            self._host_scaler.update(overflow)
        metrics = {"loss": lsum_h / denom, "grad_norm": gnorm, "lr": lr,
                   "overflow": int(overflow), "loss_scale": scale}
        return {k: torch.tensor(v) for k, v in metrics.items()}

    def _wire_fetch(self, flat: torch.Tensor, bits: int, step_i: int):
        """The compressed grad wire of the offload step: each piece of
        the flat gradient is encoded on the device (stochastic rounding,
        draws from a generator seeded with the step), its payload and
        scales cross to pinned host buffers, and the host decodes them
        into the piece's float32 buffer.  The JAX engine encodes the flat
        vector in one program; the pieces are chunk-aligned, so the
        format and the scales are the same."""
        from .zero import wire_codec
        gen = torch.Generator(device=self.device)
        gen.manual_seed(step_i)
        tr = self._host_opt.transfers
        count = [0]

        def fetch(piece, host_f32):
            lo, n = piece.lo, piece.hi - piece.lo
            hi = -(-piece.hi // wire_codec.CHUNK) * wire_codec.CHUNK
            payload, scales = wire_codec.encode(flat[lo:hi], bits, gen)
            slot = count[0] % 3
            count[0] += 1
            pbuf = tr.buffer("wire", slot, payload.numel(), torch.uint8)
            sbuf = tr.buffer("scales", slot, scales.numel(), torch.float32)
            tr.after_compute()
            tr.to_host(pbuf, payload)
            tr.wait(tr.to_host(sbuf, scales))   # one stream: both landed
            out = host_f32.numpy() if hi - lo == n else \
                np.empty(hi - lo, np.float32)
            wire_codec.decode_into(out, pbuf.numpy(), sbuf.numpy(), bits)
            if hi - lo != n:
                host_f32.numpy()[:] = out[:n]
            return None
        return fetch

    def _cast_for_compute(self, params):
        if self.compute_dtype == torch.float32:
            return params
        return tree_map(lambda p: p.to(self.compute_dtype)
                        if p.is_floating_point() else p, params)

    def _current_scale(self, state=None) -> torch.Tensor:
        """The loss scale of ``state`` (default the engine's): the
        scaler's, or 1."""
        state = self.state if state is None else state
        if self._host_scaler is not None:
            return torch.tensor(self._host_scaler.scale, dtype=torch.float32)
        if self.loss_scaler is not None:
            return state["scaler"].scale
        return torch.ones((), dtype=torch.float32, device=self.device)

    def _micro_loss_and_grads(self, params, micro_batch, scale):
        """(scaled loss, float32 grads of the masters) of one micro
        batch: the loss runs on the compute-dtype cast of the masters and
        the gradient comes back through the cast."""
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with trace_span("engine/forward", micro_step=self.micro_steps):
            loss = self._loss_fn(
                self._tp_localize(self._cast_for_compute(leaves)),
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
                if self._zero is not None:
                    # each rank checked its shards: every rank skips
                    # the step if any saw an inf or NaN
                    overflow = self._zero.reduce_flag(overflow)
            else:
                overflow = torch.zeros((), dtype=torch.bool,
                                       device=self.device)
        gnorm = (global_norm(grads) if self._zero is None
                 else self._zero.global_norm(grads))
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
        """This rank's host batch ``[gas * micro, ...]`` or ``[gas, micro,
        ...]`` → tensors ``[gas, micro, ...]`` on the engine's device
        (token ids as int64).  With data parallelism each process passes
        its local slice of the global batch, the JAX engine's multi-host
        contract (``runtime/dataloader.py::rank_slice`` cuts it)."""
        gas = self.gradient_accumulation_steps
        global_b = self.train_batch_size // self.dp_world_size

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
                    f"process-local batch ({global_b}"
                    f"{f' = {self.train_batch_size}/{self.dp_world_size} ranks' if self.dp_world_size > 1 else ''}"
                    f") nor [gas={gas}, ...] layout")
            return t.to(self.device, non_blocking=True)
        return {k: (moe_seeds(v, gas) if k == "moe_rng" else prep(v))
                for k, v in batch.items()}

    def train_step(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """One optimizer step over ``gas`` micro batches; returns metrics
        as device tensors (loss, grad_norm, lr, overflow, loss_scale)."""
        self._heartbeat.maybe_beat()
        comm.set_mesh(self.mesh)
        if self.infinity_enabled:
            t0 = time.perf_counter()
            with trace_span("engine/train_step", mode="infinity",
                            step=self.global_steps):
                metrics = self._infinity.train_step(batch)
            return self._host_step_done(metrics, t0)
        with trace_span("engine/shard_batch"):
            batch = self.shard_batch(batch)
        t0 = time.perf_counter()
        if self.offload_enabled:
            with trace_span("engine/train_step", mode="offload",
                            step=self.global_steps):
                metrics = self._offload_train_step(batch)
            return self._host_step_done(metrics, t0)
        with trace_span("engine/train_step", mode="eager",
                        step=self.global_steps):
            scale = self._current_scale()
            if self._zero is None:
                gsum, lsum = self._accumulate_micro_grads(self.state, batch,
                                                          scale)
            else:
                gsum, lsum = self._zero_accumulate(batch, scale)
            gas = self.gradient_accumulation_steps
            with trace_span("engine/optimizer_step", step=self.global_steps):
                self.state, metrics = self._apply_grads(self.state, gsum,
                                                        float(gas))
                if self._live is not None:
                    self._live = self._zero.live_params(
                        self.state["params"], self.compute_dtype)
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

    def _host_step_done(self, metrics: Dict[str, torch.Tensor],
                        t0: float) -> Dict[str, torch.Tensor]:
        """The bookkeeping after an offload or Infinity step, which is
        synchronous already (its metrics are host values)."""
        step_s = time.perf_counter() - t0
        self.global_steps += 1
        self.micro_steps += self.gradient_accumulation_steps
        if self._config.wall_clock_breakdown:
            self._step_times.append(step_s)
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
        if self.infinity_enabled:
            return torch.tensor(self._infinity.eval_loss(batch))
        sq = {k: (v[0] if k == "moe_rng" else
                  v.reshape((-1,) + tuple(v.shape[2:])))
              for k, v in self.shard_batch(batch).items()}
        if self._zero is None:
            return self._loss_fn(
                self._cast_for_compute(self.state["params"]), sq)
        z, dtype = self._zero, self.compute_dtype
        with z.hooks(self.model, dtype):
            if self.zero_stage in (1, 2):
                params = self._live
            elif self.zero_stage == 3:
                params = z.stage3_params(self.state["params"], dtype)
            else:
                params = self._cast_for_compute(self.state["params"])
            return z.mean(self._loss_fn(self._tp_localize(params), sq))

    # ------------------------------------------------------------------
    # compat API: forward / backward / step
    # ------------------------------------------------------------------
    def forward(self, batch: Dict[str, Any]) -> torch.Tensor:
        """Loss and gradients of one micro batch ``[micro, ...]``; the
        gradients wait for :meth:`backward`."""
        if self.offload_enabled or self.infinity_enabled:
            raise NotImplementedError(
                "the compat forward/backward/step surface is not wired for "
                "offload — use train_step()/train_batch()")
        if self._zero is not None:
            raise NotImplementedError(
                "the compat forward/backward/step surface runs ZeRO stage 0 "
                "on one rank — use train_step()/train_batch() under ZeRO "
                "or data parallelism")
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
        if self.infinity_enabled:
            return self._infinity.total_params
        if self._zero is not None:
            return sum(int(np.prod(s)) for s in
                       tree_leaves(self._full_shapes))
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
