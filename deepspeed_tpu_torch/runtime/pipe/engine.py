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

The global norm sums a stage's leaves' squares over the stages and
counts a replicated leaf once; the fp16 overflow flag is reduced over
every axis (``zero/partitioned.py``).  ``eval_loss`` runs the
fill-drain ``InferenceSchedule``.  ``measure_bubble_fraction`` fits the
loss-and-grad program's time at two micro-batch counts (the
``pipe/bubble_probe`` span, the ``dstpu_train_bubble_frac`` gauge);
each step's instruction loop is the ``pipe/schedule`` span.  The
interpreter runs no idle tick: a stage with nothing to do waits in its
receive.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional

import torch

from ... import comm
from ...models.convert import check_params
from ...models.transformer import masked_nll_sum
from ...observability import trace_span
from ...parallel.collectives import copy_to, psum_tp_partials
from ...parallel.topology import (AXIS_ORDER, EXPERT_AXIS, MODEL_AXIS,
                                  PIPE_AXIS, dp_world_size, mp_world_size,
                                  pp_world_size)
from ..config import DeepSpeedConfig
from ..engine import DeepSpeedEngine, config_mesh
from ..optimizers import tree_leaves, tree_map
from .schedule import (BackwardPass, ForwardPass, InferenceSchedule,
                       LoadMicroBatch, OptimizerStep, RecvActivation,
                       RecvGrad, ReduceGrads, ReduceTiedGrads,
                       SendActivation, SendGrad, TrainSchedule)

#: the compat surface's refusal (the JAX engine runs it as a plain
#: GSPMD program over the whole model, which no stage holds here)
COMPAT_REFUSAL = (
    "the compat forward/backward/step surface under a pipe mesh: no rank "
    "holds the whole model (queue A item 7's third part, the 3D "
    "composition) — use train_step()/train_batch()")


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
        the model's Megatron specs behind it; the embedding and the head
        replicated unless ``use_onehot_embed`` (a live model axis).  An
        MoE model's leaves have no model-axis layout (every dim
        free)."""
        tree = self.param_shapes() if params is None else params
        if self.config.moe_enabled:
            specs = tree_map(lambda a: (None,) * len(tuple(
                getattr(a, "shape", a))), tree)
        else:
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
        if moe and (mp > 1 or dp_world_size(mesh) > 1):
            raise NotImplementedError(
                "an MoE model under a pipe mesh with a data or model axis: "
                "each data rank would route its own rows where the JAX "
                "region routes the whole micro batch (queue A item 7's "
                "third part, the 3D composition)")
        self.stage_id = mesh.axis_index(PIPE_AXIS)
        super().__init__(model=adapter, config=config, optimizer=optimizer,
                         lr_scheduler=lr_scheduler, params=params,
                         device=device, seed=seed, mesh=mesh)
        #: the model each stage runs: the per-shard view under a model
        #: axis
        self._stage_model = self._tp_view or self.adapter.model

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
        """The stage's params in the compute dtype, as leaves the
        micro batches' gradients are taken against (``grad``): the live
        copy at ZeRO stages 1-2, else the cast of the masters."""
        src = (self._live if self._live is not None
               else self._cast_for_compute(self.state["params"]))
        return tree_map(lambda p: p.detach().requires_grad_(grad), src)

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
        p = self._tp_localize(leaves)
        tok = st.get("tok")
        if self.is_first_stage:
            t = tok.shape[1]
            x = mdl._embed(p, tok, torch.arange(t, device=tok.device)[None])
        else:
            x = st["x"]
        y, laux = mdl.stage_apply(tree_map(lambda a: a[0], p["blocks"]), x,
                                  self._windows, train=train)
        loss = cfg.moe_aux_loss_coef * laux if cfg.moe_enabled else None
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

    def _interpret(self, steps, ids, leaves, cot=None):
        """Run one stage's instruction lists over the micro batches ``ids``
        ``[M, micro, T]``.  With ``cot`` (the cotangent of each micro
        batch's loss: the scale over dp) it trains: returns the float32
        gradient sums of ``leaves`` and the sum of this stage's losses
        times ``cot``; without, it evaluates: returns the last stage's
        NLL sum and token count."""
        train = cot is not None
        cfg = self.adapter.config
        first, last = self.is_first_stage, self.is_last_stage
        sid = self.stage_id
        _, mb, t = ids.shape
        act = dict(size=(mb, t, cfg.d_model), dtype=cfg.dtype,
                   device=self.device)
        flat = list(tree_leaves(leaves))
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in flat] if train else None
        lsum = torch.zeros((), dtype=torch.float32, device=self.device)
        cnt = torch.zeros((), dtype=torch.float32, device=self.device)
        cot_t = (torch.as_tensor(cot, dtype=torch.float32,
                                 device=self.device) if train else None)
        slots: Dict[int, Dict[str, Any]] = {}
        next_micro = 0
        for cmds in steps:
            for cmd in cmds:
                buf = getattr(cmd, "buffer_id", None)
                if isinstance(cmd, (RecvActivation, LoadMicroBatch)) and (
                        buf not in slots or "y" in slots[buf]):
                    slots[buf] = {"m": next_micro}   # a new micro batch
                    next_micro += 1
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
                        lsum = lsum + st["loss"].detach() * cot_t
                    if not train and last:
                        tot, n = st.pop("nll")
                        lsum, cnt = lsum + tot, cnt + n
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
            return lsum, cnt
        it = iter(acc)
        return tree_map(lambda _: next(it), leaves), lsum

    def _exit_reduce(self, gsum):
        """The step's gradient reductions: the replicated leaves summed
        over ``pipe`` (one all-reduce of their concatenation), ZeRO's
        reduction over ``data``, then the partial leaves over
        ``model``."""
        keys = [k for k in gsum if k != "blocks"]
        reps = [g for k in keys for g in tree_leaves(gsum[k])]
        if reps:
            cat = comm.all_reduce(torch.cat([g.reshape(-1) for g in reps]),
                                  comm.ReduceOp.SUM, PIPE_AXIS)
            for g, part in zip(reps, cat.split([g.numel() for g in reps])):
                g.copy_(part.view_as(g))
        gsum = self._zero.reduce_micro(gsum)
        self._zero_bytes = self.zero_state_bytes(grads=gsum)
        gsum = self._zero.finish(gsum)
        if self._tp_view is not None:
            gsum = psum_tp_partials(gsum, MODEL_AXIS)
        return gsum

    def _zero_accumulate(self, batch, scale):
        """The pipeline's step body (the base engine's ``train_step``
        calls it): the schedule over ``batch["input_ids"]`` ``[M, micro,
        T]``, each micro batch's loss backpropagated at ``scale / dp`` (so
        the sum over the data ranks is the mean's gradient), then the
        exit reductions; the loss summed over ``pipe`` and ``data``."""
        ids = batch["input_ids"]
        self._windows = self._stage_windows(self._stage_model,
                                            self.stage_id)
        with trace_span("pipe/schedule", schedule=self.schedule,
                        stages=self.num_stages, stage=self.stage_id,
                        micro_batches=int(ids.shape[0])):
            gsum, lsum = self._interpret(
                self._steps(int(ids.shape[0])), ids, self._compute_params(),
                cot=scale / self.dp_world_size)
        gsum = self._exit_reduce(gsum)
        lsum = comm.all_reduce(lsum, comm.ReduceOp.SUM, PIPE_AXIS)
        lsum = comm.all_reduce(lsum, comm.ReduceOp.SUM, self._zero.axes)
        return gsum, lsum

    @torch.no_grad()
    def eval_loss(self, batch: Dict[str, Any]) -> torch.Tensor:
        """The token-mean loss of the whole batch through the fill-drain
        ``InferenceSchedule``, the same on every rank."""
        if self.adapter.config.moe_enabled:
            raise NotImplementedError(
                "eval_loss of an MoE model under a pipe mesh: the JAX "
                "engine routes the whole batch at once, the stages route "
                "a micro batch (queue A item 7's third part, the 3D "
                "composition)")
        comm.set_mesh(self.mesh)
        ids = self.shard_batch(batch)["input_ids"]
        self._windows = self._stage_windows(self._stage_model,
                                            self.stage_id)
        leaves = self._compute_params(grad=False)
        tot, cnt = self._interpret(
            InferenceSchedule(int(ids.shape[0]), self.num_stages,
                              self.stage_id).steps(), ids, leaves)
        both = torch.stack([tot, cnt])
        both = comm.all_reduce(both, comm.ReduceOp.SUM, PIPE_AXIS)
        both = comm.all_reduce(both, comm.ReduceOp.SUM, self._zero.axes)
        return both[0] / torch.clamp(both[1], min=1.0)

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
            self._interpret(self._steps(int(ids.shape[0])), ids,
                            self._compute_params(), cot=1.0)

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
        raise NotImplementedError(COMPAT_REFUSAL)

    __call__ = forward

    def backward(self, loss=None):
        raise NotImplementedError(COMPAT_REFUSAL)

    def step(self):
        raise NotImplementedError(COMPAT_REFUSAL)
