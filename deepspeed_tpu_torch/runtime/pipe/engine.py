"""Pipeline-parallel engine.

Counterpart of ``deepspeed_tpu/runtime/pipe/engine.py`` (the reference's
``PipelineEngine``, ``runtime/pipe/engine.py:37``).  The JAX engine
compiles the whole schedule into one program (a scan over ticks,
activations rotated by ``ppermute``); the port keeps PyTorch's idiom,
which is also the reference's: one process a stage, each running an
interpreter over its stage's instruction lists (``schedule.py``) and
exchanging activations and their gradients by point-to-point sends on
the ``pipe`` axis (``comm.send`` / ``comm.recv``).  The arithmetic is
the JAX engine's:

  - the params tree is stage-stacked (``PipelinedLM``: ``blocks`` leaves
    ``[L, ...]`` → ``[S, L / S, ...]``); rank (p, d, m) holds stage p's
    slice, its model slice (Megatron's layout, the fused qkv replicated
    over ``model``) and ZeRO's data shard of that, so the gathered state
    is the JAX engine's leaf for leaf;
  - ``1f1b`` (dense models; ``TrainSchedule``): a forward keeps the
    stage's autograd graph for each micro batch in flight (at most
    ``num_pipe_buffers``), a backward takes the gradients of the stage's
    output against the received cotangent (``torch.autograd.grad``);
    the last stage's cotangent is the loss scale (over dp) on its micro
    batch's mean loss (``chunked_ce``);
  - ``gpipe`` (MoE models, or on request): every forward, then every
    backward in reverse; each stage adds ``moe_aux_loss_coef`` times its
    layers' aux loss to its micro batch's loss, so the loss is the
    global token mean plus the aux loss summed over the stages and
    averaged over the micro batches (the JAX ``_pipeline_loss``);
  - gradients accumulate in float32 over the micro batches; then the
    exit reductions: the replicated leaves' gradients (``embed``,
    ``pos_embed`` on stage 0; ``ln_f``, ``lm_head`` or the tied
    ``embed`` on the last) summed over ``pipe`` in one all-reduce (the
    tied embedding's two parts add there), ZeRO's reduction over
    ``data`` (``ZeroPartition``), then ``psum_tp_partials`` over
    ``model``; the loss is summed over ``pipe`` and ``data``, so every
    rank returns the same one.

ZeRO stage 3 keeps 1/dp of the stage's slice: the leaves outside
``blocks`` are gathered whole once a step (their grads reduce-scattered
at the exit) and each layer of the stage's ``blocks`` is gathered inside
``stage_apply`` through the block hook (``_stage3_hooks``), its
gradient reduce-scattered in the backward; the JAX region gathers the
params whole at entry, which computes the same numbers.  An MoE model
over the batch axes routes the whole micro batch, as the JAX region
(which leaves the expert, data and model axes to GSPMD) does: each MoE
layer gathers its f32 gate logits over the stage's batch group
(``(dcn_data, data, expert)``), every rank routes the whole micro batch,
and the rows go to the ranks that hold their experts and back over
``expert`` (``moe/layer.py``); under a model axis each expert's FFN is
cut over ``model`` as the dense MLP is.
ZeRO-Offload (data-parallel size 1) runs the schedule into the flat
gradient buffer each stage's host optimizer sweeps (``_offload_grads``).

The global norm sums a stage's leaves' squares over the stages and
counts a replicated leaf once; the fp16 overflow flag is reduced over
every axis (``zero/partitioned.py``).  ``eval_loss`` runs the
fill-drain ``InferenceSchedule`` (an MoE model routes the whole batch at
once, as the JAX engine's ``eval_loss``).  The compat ``forward`` runs
the schedule's forwards of a batch, ``backward`` its backwards and
``step`` the exit reductions and the update.
``measure_bubble_fraction`` fits the
loss-and-grad program's time at two micro-batch counts (the
``pipe/bubble_probe`` span, the ``dstpu_train_bubble_frac`` gauge);
each step's instruction loop is the ``pipe/schedule`` span.  The
interpreter runs no idle tick: a stage with nothing to do waits in its
receive.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Optional

import torch

from ... import comm
from ...models.convert import check_params
from ...models.transformer import masked_nll_sum
from ...observability import trace_span
from ...parallel.collectives import copy_to, psum_tp_partials
from ...parallel.topology import (AXIS_ORDER, BATCH_AXES, EXPERT_AXIS,
                                  MODEL_AXIS, PIPE_AXIS, mp_world_size,
                                  pp_world_size)
from ..config import DeepSpeedConfig
from ..engine import DeepSpeedEngine, config_mesh
from ..optimizers import tree_leaves, tree_map
from .schedule import (BackwardPass, ForwardPass, InferenceSchedule,
                       LoadMicroBatch, OptimizerStep, RecvActivation,
                       RecvGrad, ReduceGrads, ReduceTiedGrads,
                       SendActivation, SendGrad, TrainSchedule)

def chunked_ce(proj, norm_fn, ln_params, y, tok, chunk: int,
               tp_axis: Optional[str] = None):
    """The head loss of both schedules: the final norm, then the
    cross-entropy of the next token over ``chunk``-token slices, the
    last position masked (``models/transformer.py::masked_nll_sum``).
    Returns ``(sum of the NLL, token count)``.  ``tp_axis``: Megatron's
    vocab-parallel form, ``proj`` mapping the shard-local stream
    (entered through ``copy_to`` here) to the local ``[.., V / mp]``
    logits."""
    mb, t = tok.shape
    x = norm_fn(ln_params, y)
    labels = torch.cat([tok[:, 1:], torch.zeros_like(tok[:, :1])], dim=1)
    mask = torch.ones((mb, t), dtype=torch.float32, device=y.device)
    mask[:, -1] = 0.0
    def logits(xc):
        return proj(xc if tp_axis is None else copy_to(xc, tp_axis))
    return (masked_nll_sum(logits, x, labels, mask, chunk, tp_axis),
            mask.sum())


class PipelinedLM:
    """A ``TransformerLM`` with its params stage-stacked for the
    pipeline: ``blocks`` leaves ``[L, ...]`` → ``[S, L / S, ...]`` (dim 0
    on ``pipe``); the embeddings and the final norm stay whole on every
    stage (the first and the last read them: the reference's
    ``TiedLayerSpec``)."""

    #: set by the engine under a model axis: the embedding and the head
    #: keep their vocab-sharded layout (else replicated over ``model``)
    use_onehot_embed = False

    def __init__(self, model, num_stages: int):
        cfg = model.config
        n_scan = getattr(cfg, "scan_length", cfg.num_layers)
        if n_scan % num_stages != 0:
            raise ValueError(
                f"scanned blocks ({n_scan}) must divide evenly into "
                f"{num_stages} pipeline stages")
        self.model = model
        self.config = cfg
        self.num_stages = num_stages
        self.layers_per_stage = n_scan // num_stages

    def init(self, generator, device=None, dtype=None):
        return self.stack(self.model.init(generator, device, dtype))

    def stack(self, params):
        """The model's tree → the stage-stacked one (torch or numpy
        leaves; a view where the leaf allows)."""
        s, lps = self.num_stages, self.layers_per_stage
        params = dict(params)
        params["blocks"] = tree_map(
            lambda x: x.reshape((s, lps) + tuple(x.shape[1:])),
            params["blocks"])
        return params

    def unstack(self, params):
        params = dict(params)
        params["blocks"] = tree_map(
            lambda x: x.reshape((-1,) + tuple(x.shape[2:])),
            params["blocks"])
        return params

    def param_shapes(self, head_bias: bool = False):
        shapes = dict(self.model.param_shapes(head_bias=head_bias))
        s, lps = self.num_stages, self.layers_per_stage
        shapes["blocks"] = tree_map(lambda sh: (s, lps) + tuple(sh[1:]),
                                    shapes["blocks"])
        return shapes

    def partition_specs(self, params=None):
        """The stacked tree's specs: ``pipe`` on the blocks' stage dim,
        the model's Megatron specs behind it (an MoE layer's: the expert
        stacks over ``expert``); the embedding and the head replicated
        unless ``use_onehot_embed`` (a live model axis)."""
        tree = self.param_shapes() if params is None else params
        specs = dict(self.model.partition_specs(tree))
        if not self.use_onehot_embed:
            for k in ("embed", "lm_head"):
                if k in specs:
                    specs[k] = tree_map(lambda sp: (None,) * len(sp),
                                        specs[k])
        specs["blocks"] = tree_map(lambda sp: ("pipe",) + tuple(sp[1:]),
                                   specs["blocks"])
        return specs

    def loss(self, params, batch):
        return self.model.loss(self.unstack(params), batch)

    def tp_train_view(self, model_shards: int, tp_axis: Optional[str]):
        return self.model.tp_train_view(model_shards, tp_axis)

    def stage_slice(self, tree, stage: int):
        """Stage ``stage``'s part of a stage-stacked tree (its blocks'
        ``[1, L / S, ...]``, each a tensor of its own)."""
        tree = dict(tree)
        tree["blocks"] = tree_map(
            lambda x: x.narrow(0, stage, 1).clone(
                memory_format=torch.contiguous_format), tree["blocks"])
        return tree

    def stage_gather(self, tree):
        """The stage-stacked tree from every stage's slice (a collective
        over ``pipe``)."""
        tree = dict(tree)
        tree["blocks"] = tree_map(
            lambda x: comm.all_gather(x, PIPE_AXIS, axis=0), tree["blocks"])
        return tree


def gpipe_steps(micro_batches: int, stages: int, stage_id: int):
    """The gpipe schedule in the 1F1B instruction set: every micro
    batch's forward (fill, drain), then every backward in reverse order,
    then the reductions and the optimizer step."""
    first, last = stage_id == 0, stage_id == stages - 1
    for m in range(micro_batches):
        cmds = [] if first else [RecvActivation(m)]
        if first or last:
            cmds.append(LoadMicroBatch(m))
        cmds.append(ForwardPass(m))
        if not last:
            cmds.append(SendActivation(m))
        yield cmds
    for m in reversed(range(micro_batches)):
        cmds = [] if last else [RecvGrad(m)]
        cmds.append(BackwardPass(m))
        if not first:
            cmds.append(SendGrad(m))
        yield cmds
    yield [ReduceTiedGrads(), ReduceGrads(), OptimizerStep()]


class PipelineEngine(DeepSpeedEngine):
    """The training engine over a mesh whose ``pipe`` axis is 2 or more
    (``initialize`` builds it there).  ``gradient_accumulation_steps`` is
    the micro-batch count M: train_batch = micro * M * dp."""

    def __init__(self, model, config: Any = None, optimizer=None,
                 lr_scheduler=None, loss_fn=None,
                 params: Optional[Dict[str, Any]] = None, device=None,
                 seed: int = 0, mesh=None):
        config = (config if isinstance(config, DeepSpeedConfig)
                  else DeepSpeedConfig(config or {}))
        config.refuse_out_of_slice()
        mesh = config_mesh(config, mesh)
        if pp_world_size(mesh) < 2:
            raise ValueError("PipelineEngine needs a mesh with pipe>=2")
        self.num_stages = pp_world_size(mesh)
        adapter = model if isinstance(model, PipelinedLM) else PipelinedLM(
            model, self.num_stages)
        adapter.use_onehot_embed = mp_world_size(mesh) > 1
        self.adapter = adapter
        mcfg = adapter.config
        moe = mcfg.moe_enabled
        self.schedule = config.pipeline.schedule
        if self.schedule == "auto":
            # the MoE aux loss rides the gpipe loss; dense → 1F1B
            self.schedule = "gpipe" if moe else "1f1b"
        if self.schedule not in ("1f1b", "gpipe"):
            raise ValueError(f"pipeline.schedule must be auto|1f1b|gpipe, "
                             f"got {self.schedule}")
        if self.schedule == "1f1b" and moe:
            raise NotImplementedError(
                "1f1b schedule does not carry the MoE aux loss yet; use "
                "pipeline.schedule=gpipe for MoE models")
        if getattr(mcfg, "attn_impl", None) in ("ring", "ulysses"):
            raise NotImplementedError(
                "ring/ulysses attention (sequence parallel) inside the "
                "compiled pipeline loop would nest manual collectives over "
                "pipe+sequence — not supported yet; use sequence "
                "parallelism without PP")
        if moe and mcfg.moe_noisy_gate_policy == "RSample":
            raise NotImplementedError(
                "RSample noisy gating has no rng path in the compiled "
                "pipeline loop yet; use deterministic gating under "
                "PipelineEngine")
        ps = config.pipeline.stages
        if ps != "auto" and int(ps) != self.num_stages:
            raise ValueError(
                f"pipeline.stages ({ps}) != mesh pipe axis "
                f"({self.num_stages}): this config was exported for a "
                f"different topology")
        pmb = config.pipeline.micro_batches
        if pmb:
            tb, mb, gas = config._user_batch_triple
            if gas is not None and gas != pmb:
                raise ValueError(
                    f"pipeline.micro_batches ({pmb}) conflicts with "
                    f"gradient_accumulation_steps ({gas})")
            # micro_batches IS the accumulation count M; the per-device
            # micro batch re-derives from train_batch_size when pinned
            config._user_batch_triple = (
                tb, None if tb is not None else mb, pmb)
        mp = mp_world_size(mesh)
        dense = not moe
        if dense and mesh.shape.get(EXPERT_AXIS, 1) > 1:
            raise NotImplementedError(
                "expert mesh axis > 1 under a dense pipeline model: the "
                "3D region reduces gradients over (dcn_data, data) only — "
                "drop the expert axis or use an MoE model")
        if dense and mp > 1 and mcfg.vocab_size % mp:
            raise ValueError(
                f"model mesh axis ({mp}) must divide vocab_size "
                f"({mcfg.vocab_size}) for vocab-parallel embed/CE")
        # the port's own limits, after the JAX engine's checks
        if loss_fn is not None:
            raise NotImplementedError(
                "a client loss_fn under the pipeline: each stage runs its "
                "slice of the model's own program")
        if not mcfg.causal or mcfg.mlm_head or not mcfg.final_layernorm:
            raise NotImplementedError(
                "the pipeline trains causal LMs with a final norm (its "
                "head is the next-token loss after ln_f)")
        self.stage_id = mesh.axis_index(PIPE_AXIS)
        super().__init__(model=adapter, config=config, optimizer=optimizer,
                         lr_scheduler=lr_scheduler, params=params,
                         device=device, seed=seed, mesh=mesh)
        #: the model each stage runs: the per-shard view under a model
        #: axis; an MoE model's view over the batch axes routes the whole
        #: micro batch, as the JAX region does
        self._stage_model = self._tp_view or self.adapter.model
        if moe and self.dp_world_size > 1:
            self._stage_model = self._stage_model.moe_view(BATCH_AXES,
                                                           EXPERT_AXIS)
        #: whether stage 3's block hook gathers ``blocks`` this step
        self._hooked = False

    @property
    def micro_batches(self) -> int:
        return self.gradient_accumulation_steps

    @property
    def is_first_stage(self) -> bool:
        return self.stage_id == 0

    @property
    def is_last_stage(self) -> bool:
        return self.stage_id == self.num_stages - 1

    # -- the stage's slice of the state ------------------------------------
    def _apply_training_overrides(self, model):
        inner = super()._apply_training_overrides(model.model)
        if inner is model.model:
            return model
        out = PipelinedLM(inner, self.num_stages)
        out.use_onehot_embed = model.use_onehot_embed
        self.adapter = out
        return out

    def init_state(self, params=None, seed: int = 0):
        """As the base engine's, from the stage-stacked tree: ``params``
        may be the model's own tree (stacked here) or the stacked one."""
        if params is not None and self._is_model_tree(params):
            params = self.adapter.stack(params)
        return super().init_state(params, seed)

    def _is_model_tree(self, params) -> bool:
        """Whether ``params`` is the model's own tree (blocks ``[L,
        ...]``) rather than the stage-stacked one."""
        try:
            check_params(self.adapter.model, params)
        except ValueError:
            return False
        return True

    def _train_specs(self, params):
        return self._tp_train_specs(params)

    def _local_slice(self, tree):
        return super()._local_slice(
            self.adapter.stage_slice(tree, self.stage_id))

    def _whole(self, tree):
        return self.adapter.stage_gather(super()._whole(tree))

    def _stage_windows(self, model, sid: int):
        """This stage's slice of the per-layer attention windows (the
        GPT-Neo family's ``attention_layers``), or None."""
        if not model.config.attention_layers:
            return None
        lps = self.adapter.layers_per_stage
        return model._layer_windows()[sid * lps:(sid + 1) * lps]

    def _compute_params(self, grad: bool = True):
        """The stage's params, as leaves the micro batches' gradients are
        taken against (``grad``): the live compute-dtype copy at ZeRO
        stages 1-2; at stage 3 the leaves outside ``blocks`` gathered
        whole in the compute dtype once a step and ``blocks`` as the
        float32 master shards, which the block hook gathers a layer at a
        time (``_stage3_hooks``); else the cast of the masters."""
        if self.zero_stage == 3 and self._zero is not None:
            src = self._zero.stage3_params(self.state["params"],
                                           self.compute_dtype,
                                           autograd=False)
        else:
            src = (self._live if self._live is not None
                   else self._cast_for_compute(self.state["params"]))
        return tree_map(lambda p: p.detach().requires_grad_(grad), src)

    def _stage3_hooks(self):
        """Stage 3's per-layer gather on the model the stage runs: a
        layer view of the stage's ``blocks`` drops the stage dim and the
        layer dim."""
        return self._zero.hooks(self._stage_model, self.compute_dtype,
                                post=self._tp_localize, lead=2)

    def _whole_keys(self):
        """The subtrees stage 3 gathers whole once a step (their grads
        are reduce-scattered at the exit): all but a sharded
        ``blocks``."""
        return {k for k in self.state["params"]
                if not (k == "blocks" and self._hooked)}

    # -- the interpreter ----------------------------------------------------
    def _steps(self, m: int):
        if self.schedule == "1f1b":
            return TrainSchedule(m, self.num_stages, self.stage_id).steps()
        return gpipe_steps(m, self.num_stages, self.stage_id)

    def _forward(self, st, leaves, train: bool) -> None:
        """One micro batch's stage forward: ``st["y"]`` the stage's
        output, ``st["loss"]`` its part of the micro batch's loss (the
        head's mean NLL on the last stage, the MoE aux loss), and on the
        last stage ``st["nll"]`` = (sum, count)."""
        mdl, cfg = self._stage_model, self.adapter.config
        p = self._tp_localize(leaves, skip_blocks=self._hooked)
        tok = st.get("tok")
        if self.is_first_stage:
            t = tok.shape[1]
            x = mdl._embed(p, tok, torch.arange(t, device=tok.device)[None])
        else:
            x = st["x"]
        # MoE routes in train mode in evaluation too: the JAX engine's
        # eval_loss is the model's loss
        y, laux = mdl.stage_apply(tree_map(lambda a: a[0], p["blocks"]), x,
                                  self._windows, train=True)
        loss = cfg.moe_aux_loss_coef * laux if cfg.moe_enabled else None
        st["aux"] = loss
        if self.is_last_stage:
            t = tok.shape[1]
            chunk = (cfg.loss_chunk if cfg.loss_chunk and t > cfg.loss_chunk
                     and t % cfg.loss_chunk == 0 else t)
            tp = MODEL_AXIS if self._tp_view is not None else None
            proj = ((lambda xc: mdl._project_local(p, xc)) if tp else
                    (lambda xc: mdl._project(p, xc)))
            tot, cnt = chunked_ce(proj, mdl._norm, p["ln_f"], y, tok, chunk,
                                  tp_axis=tp)
            st["nll"] = (tot, cnt)
            nll = tot / torch.clamp(cnt, min=1.0)
            loss = nll if loss is None else nll + loss
        st["y"], st["loss"] = y, loss

    def _interpret(self, steps, ids, leaves, cot=None, run=None):
        """Run one stage's instruction lists over the micro batches ``ids``
        ``[M, micro, T]``.  With ``cot`` (the cotangent of each micro
        batch's loss: the scale over dp) it trains: returns the float32
        gradient sums of ``leaves`` and the sum of this stage's losses
        times ``cot``; without, it evaluates: returns the last stage's
        NLL sum and token count, and the sum of this stage's MoE aux
        losses.  ``run`` (a dict, filled on the first call) carries the
        interpreter's state across calls, so the compat surface runs a
        step's forwards and its backwards as two calls."""
        train = cot is not None
        cfg = self.adapter.config
        first, last = self.is_first_stage, self.is_last_stage
        sid = self.stage_id
        _, mb, t = ids.shape
        act = dict(size=(mb, t, cfg.d_model), dtype=cfg.dtype,
                   device=self.device)
        flat = list(tree_leaves(leaves))
        run = {} if run is None else run
        if not run:
            zero = torch.zeros((), dtype=torch.float32, device=self.device)
            run.update(
                acc=[torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in flat]
                if train else None,
                lsum=zero, cnt=zero, aux=zero, slots={}, next_micro=0,
                cot=(torch.as_tensor(cot, dtype=torch.float32,
                                     device=self.device) if train else None))
        acc, cot_t, slots = run["acc"], run["cot"], run["slots"]
        for cmds in steps:
            for cmd in cmds:
                buf = getattr(cmd, "buffer_id", None)
                if isinstance(cmd, (RecvActivation, LoadMicroBatch)) and (
                        buf not in slots or "y" in slots[buf]):
                    # a new micro batch
                    slots[buf] = {"m": run["next_micro"]}
                    run["next_micro"] += 1
                st = slots.get(buf)
                if isinstance(cmd, RecvActivation):
                    x = comm.recv(torch.empty(**act), sid - 1, PIPE_AXIS)
                    st["x"] = x.requires_grad_(train)
                elif isinstance(cmd, LoadMicroBatch):
                    st["tok"] = ids[st["m"]]
                elif isinstance(cmd, ForwardPass):
                    if last:
                        # the labels (InferenceSchedule loads on stage 0
                        # only)
                        st.setdefault("tok", ids[st["m"]])
                    with torch.set_grad_enabled(train):
                        self._forward(st, leaves, train)
                    if train and st["loss"] is not None:
                        run["lsum"] = run["lsum"] + st["loss"].detach() * cot_t
                    if not train:
                        if last:
                            tot, n = st.pop("nll")
                            run["lsum"] = run["lsum"] + tot
                            run["cnt"] = run["cnt"] + n
                        if st["aux"] is not None:
                            run["aux"] = run["aux"] + st["aux"]
                elif isinstance(cmd, SendActivation):
                    comm.send(st["y"].detach(), sid + 1, PIPE_AXIS)
                elif isinstance(cmd, RecvGrad):
                    st["dy"] = comm.recv(torch.empty(**act), sid + 1,
                                         PIPE_AXIS)
                elif isinstance(cmd, BackwardPass):
                    outs, gouts = [], []
                    if not last:
                        outs.append(st.pop("y"))
                        gouts.append(st.pop("dy"))
                    if st["loss"] is not None:
                        outs.append(st["loss"])
                        gouts.append(cot_t)
                    inputs = flat if first else flat + [st["x"]]
                    grads = torch.autograd.grad(outs, inputs, gouts,
                                                allow_unused=True)
                    for a, g in zip(acc, grads[:len(flat)]):
                        if g is not None:
                            a.add_(g)
                    if first:
                        del slots[buf]
                    else:
                        st.clear()
                        st["dx"] = grads[-1]
                elif isinstance(cmd, SendGrad):
                    comm.send(slots.pop(buf)["dx"], sid - 1, PIPE_AXIS)
        comm.wait_sends()
        if not train:
            return run["lsum"], run["cnt"], run["aux"]
        it = iter(acc)
        return tree_map(lambda _: next(it), leaves), run["lsum"]

    @staticmethod
    def _sum_replicated(gsum) -> None:
        """The replicated leaves' gradients (all but ``blocks``) summed
        over ``pipe`` in place, one all-reduce of their concatenation
        (the tied embedding's two parts add there)."""
        reps = [g for k in gsum if k != "blocks"
                for g in tree_leaves(gsum[k])]
        if reps:
            cat = comm.all_reduce(torch.cat([g.reshape(-1) for g in reps]),
                                  comm.ReduceOp.SUM, PIPE_AXIS)
            for g, part in zip(reps, cat.split([g.numel() for g in reps])):
                g.copy_(part.view_as(g))

    def _exit_reduce(self, gsum):
        """The step's gradient reductions: the replicated leaves summed
        over ``pipe``, ZeRO's reduction over ``data`` (at stage 3 also the
        reduce-scatter of the leaves gathered whole for the step), then
        the partial leaves over ``model``."""
        self._sum_replicated(gsum)
        gsum = self._zero.reduce_micro(
            gsum, keys=self._whole_keys() if self.zero_stage == 3 else None)
        self._zero_bytes = self.zero_state_bytes(grads=gsum)
        gsum = self._zero.finish(gsum)
        if self._tp_view is not None:
            gsum = psum_tp_partials(gsum, MODEL_AXIS)
        return gsum

    def _offload_grads(self, batch, scale: float):
        """ZeRO-Offload's step body under the pipeline (data-parallel size
        1): the schedule over this stage's compute-dtype params, the
        replicated leaves summed over ``pipe`` and the partial leaves over
        ``model``, into the flat float32 buffer the host sweep reads;
        ``(flat, scaled loss sum over the stages)``."""
        ids = batch["input_ids"]
        self._windows = self._stage_windows(self._stage_model,
                                            self.stage_id)
        with trace_span("pipe/schedule", schedule=self.schedule,
                        stages=self.num_stages, stage=self.stage_id,
                        micro_batches=int(ids.shape[0])):
            gsum, lsum = self._interpret(
                self._steps(int(ids.shape[0])), ids, self._compute_params(),
                cot=scale)
        self._sum_replicated(gsum)
        if self._tp_view is not None:
            gsum = psum_tp_partials(gsum, MODEL_AXIS)
        flat, views = self._grad_flat_views()
        for view, g in zip(views, tree_leaves(gsum)):
            view.copy_(g)
        del gsum
        return flat, comm.all_reduce(lsum, comm.ReduceOp.SUM, PIPE_AXIS)

    def _schedule_half(self, m: int, backward: bool):
        """The gpipe lists' forwards (every micro batch's) or backwards
        (every one's, in reverse): the compat surface's two halves of a
        step (gpipe and 1F1B compute one function)."""
        steps = list(gpipe_steps(m, self.num_stages, self.stage_id))[:-1]
        return steps[m:] if backward else steps[:m]

    def _zero_accumulate(self, batch, scale):
        """The pipeline's step body (the base engine's ``train_step``
        calls it): the schedule over ``batch["input_ids"]`` ``[M, micro,
        T]``, each micro batch's loss backpropagated at ``scale / dp`` (so
        the sum over the data ranks is the mean's gradient), then the
        exit reductions; the loss summed over ``pipe`` and ``data``."""
        ids = batch["input_ids"]
        self._windows = self._stage_windows(self._stage_model,
                                            self.stage_id)
        with self._stage3_hooks() as hooked:
            self._hooked = hooked
            with trace_span("pipe/schedule", schedule=self.schedule,
                            stages=self.num_stages, stage=self.stage_id,
                            micro_batches=int(ids.shape[0])):
                gsum, lsum = self._interpret(
                    self._steps(int(ids.shape[0])), ids,
                    self._compute_params(), cot=scale / self.dp_world_size)
        gsum = self._exit_reduce(gsum)
        self._hooked = False
        return gsum, self._loss_over_ranks(lsum)

    def _loss_over_ranks(self, lsum):
        lsum = comm.all_reduce(lsum, comm.ReduceOp.SUM, PIPE_AXIS)
        return comm.all_reduce(lsum, comm.ReduceOp.SUM, BATCH_AXES)

    @torch.no_grad()
    def eval_loss(self, batch: Dict[str, Any]) -> torch.Tensor:
        """The loss of the whole batch through the fill-drain
        ``InferenceSchedule``, the same on every rank: the token mean
        (an MoE model's plus its aux losses, summed over the stages, the
        whole batch routed at once as the JAX engine's ``eval_loss``
        routes it: one run of every rank's micro batches, gathered over
        the data ranks in the global batch's order)."""
        comm.set_mesh(self.mesh)
        ids = self.shard_batch(batch)["input_ids"]
        moe = self.adapter.config.moe_enabled
        mdl = self._stage_model
        if moe:
            m = int(ids.shape[0])
            ids = ids.reshape((1, -1) + tuple(ids.shape[2:]))
            if mdl._moe_batch:
                self._stage_model = mdl.moe_view(BATCH_AXES, EXPERT_AXIS, m)
        self._windows = self._stage_windows(mdl, self.stage_id)
        try:
            with self._stage3_hooks() as hooked:
                self._hooked = hooked
                tot, cnt, aux = self._interpret(
                    InferenceSchedule(int(ids.shape[0]), self.num_stages,
                                      self.stage_id).steps(), ids,
                    self._compute_params(grad=False))
        finally:
            self._hooked = False
            self._stage_model = mdl
        both = torch.stack([tot, cnt, aux])
        both = comm.all_reduce(both, comm.ReduceOp.SUM, PIPE_AXIS)
        nll = comm.all_reduce(both[:2].contiguous(), comm.ReduceOp.SUM,
                              BATCH_AXES)
        # the aux loss is the whole batch's, the same on every data rank
        return nll[0] / torch.clamp(nll[1], min=1.0) + both[2]

    # -- measured bubble fraction -----------------------------------------
    def _max_over_ranks(self, x: float) -> float:
        t = torch.tensor(x, dtype=torch.float64)
        for axis in AXIS_ORDER:
            if self.mesh.shape[axis] > 1:
                t = comm.all_reduce(t, comm.ReduceOp.MAX, axis)
        return float(t)

    def measure_bubble_fraction(self, micro_counts=None, repeats: int = 2,
                                seq_len: Optional[int] = None) -> Dict:
        """The schedule's bubble fraction, measured on this engine's
        instruction loop (every micro batch's forward, backward and
        sends; not the exit reductions, whose time does not grow with M
        and would read as bubble; the state is not changed) by a
        two-point slope fit: the time at M1 < M micro batches gives the
        per-micro-batch cost as the slope, and the intercept is the fill
        and drain,

            bubble = (t(M) - M * slope) / t(M).

        Each time is the wall time between two device synchronizations,
        the largest over the ranks, the best of ``repeats`` after one
        warm-up.  Records the ``dstpu_train_bubble_frac`` gauge and
        returns the fit.  A collective: every rank calls it."""
        m_full = self.micro_batches
        if micro_counts is not None:
            m_small, m_full = micro_counts
        else:
            m_small = max(1, m_full // 2)
        if not m_small < m_full:
            raise ValueError(
                f"bubble fit needs two distinct microbatch counts, got "
                f"({m_small}, {m_full}) — run with "
                f"gradient_accumulation_steps >= 2")
        comm.set_mesh(self.mesh)
        cfg = self.adapter.config
        t_len = int(seq_len or cfg.max_seq_len)
        mb = self.train_micro_batch_size_per_gpu
        self._windows = self._stage_windows(self._stage_model,
                                            self.stage_id)

        def sync():
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            comm.barrier()

        def probe(ids):
            with self._stage3_hooks() as hooked:
                self._hooked = hooked
                self._interpret(self._steps(int(ids.shape[0])), ids,
                                self._compute_params(), cot=1.0)
            self._hooked = False

        times = {}
        with trace_span("pipe/bubble_probe", schedule=self.schedule,
                        stages=self.num_stages, m_small=m_small,
                        m_full=m_full):
            for m in (m_small, m_full):
                ids = torch.zeros((m, mb, t_len), dtype=torch.long,
                                  device=self.device)
                probe(ids)                                   # warm-up
                best = float("inf")
                for _ in range(max(1, repeats)):
                    sync()
                    t0 = time.perf_counter()
                    probe(ids)
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                    best = min(best, self._max_over_ranks(
                        time.perf_counter() - t0))
                times[m] = best
        slope = (times[m_full] - times[m_small]) / (m_full - m_small)
        frac = 0.0
        if times[m_full] > 0:
            frac = (times[m_full] - m_full * slope) / times[m_full]
        frac = min(1.0, max(0.0, frac))
        self._ovl.record_bubble(frac)
        return {"bubble_frac": frac, "schedule": self.schedule,
                "stages": self.num_stages,
                "micro_counts": (m_small, m_full),
                "step_time_s": times[m_full], "per_micro_s": max(slope, 0.0)}

    # -- the compat surface --------------------------------------------------
    def forward(self, batch):
        """The schedule's forwards of the batch's micro batches (``batch``
        as :meth:`train_step` takes it: ``[M * micro, ...]`` or ``[M,
        micro, ...]``), each stage keeping their graphs for
        :meth:`backward`; returns the batch's loss, the same on every
        rank.  The two halves run gpipe's order (every forward, then
        every backward), which computes 1F1B's function."""
        self._refuse_compat_offload()
        comm.set_mesh(self.mesh)
        ids = self.shard_batch(batch)["input_ids"]
        m = int(ids.shape[0])
        self._windows = self._stage_windows(self._stage_model,
                                            self.stage_id)
        scale = self._current_scale()
        hooks = contextlib.ExitStack()
        self._hooked = hooks.enter_context(self._stage3_hooks())
        leaves, run = self._compute_params(), {}
        cot = scale / self.dp_world_size
        with trace_span("engine/forward", micro_step=self.micro_steps):
            self._interpret(self._schedule_half(m, False), ids, leaves,
                            cot=cot, run=run)
        self._compat = (hooks, ids, leaves, run, cot)
        self._last_loss = self._loss_over_ranks(run["lsum"].clone()) / (
            scale * m)
        return self._last_loss

    __call__ = forward

    def backward(self, loss=None) -> None:
        """The schedule's backwards of the last :meth:`forward`: the
        float32 gradient sums of this stage's leaves wait for
        :meth:`step`."""
        del loss  # the cotangents are the schedule's own
        hooks, ids, leaves, run, cot = self._compat
        m = int(ids.shape[0])
        try:
            with trace_span("engine/backward", micro_step=self.micro_steps):
                self._grad_acc, _ = self._interpret(
                    self._schedule_half(m, True), ids, leaves, cot=cot,
                    run=run)
        finally:
            hooks.close()
            self._compat = None
        self._grad_acc_count = m
        self.micro_steps += m

    def step(self) -> None:
        """The exit reductions and the update of :meth:`train_step`."""
        self._heartbeat.maybe_beat()
        if self._grad_acc is None:
            return
        comm.set_mesh(self.mesh)
        with trace_span("engine/optimizer_step", step=self.global_steps):
            gsum = self._exit_reduce(self._grad_acc)
            self._hooked = False
            self.state, metrics = self._apply_grads(
                self.state, gsum, float(self._grad_acc_count))
            if self._live is not None:
                self._live = self._zero.live_params(self.state["params"],
                                                    self.compute_dtype)
        metrics["loss"] = self._last_loss
        self._grad_acc = None
        self._grad_acc_count = 0
        self.global_steps += 1
        self._last_metrics = metrics
