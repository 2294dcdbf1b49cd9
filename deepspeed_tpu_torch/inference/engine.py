"""Inference engine of the port: weights, ``generate()``, latency stats
and the continuous-batching server.

Counterpart of ``deepspeed_tpu/inference/engine.py`` on one device, for
every model family of ``module_inject/policies.py``.  ``forward()``
returns full-sequence logits through the uncached forward (kernel B1
with kernel injection; an encoder's too, without the causal mask, and
with its ``token_type_ids``).  ``generate()`` refuses an encoder.  ``generate()`` prefills a dense KV
cache through plain attention and then decodes one token at a time; with
kernel injection
(``replace_with_kernel_inject``, the default) the model's attention is
``flash`` and each decode step runs kernel B5 over the cache.  Where the
JAX engine compiles two programs, this one runs eagerly: the prompt
forward plus first sample is timed as TTFT, the remaining steps as
decode latency, both ending in a device synchronise.

``quant.enabled`` serves int8 weights (the JAX engine's "group" mode):
every matrix leaf in scope becomes int8 values and f32 group scales, the
stacked ``blocks`` quantized one layer at a time; ``forward()``,
``generate()`` and the server take the model's params through
``_model_params``, and the model dequantizes one layer at a time through
its ``block_transform`` seam.  As in the JAX engine, scope is decided by
the rank of the stacked leaf, so each layer's biases and norm scales
(``[L, d]``) are quantized too, and with MoE each layer's gate ``[M, E]``
and stacked experts ``[E, M, F]``.

An MoE model (``moe.enabled`` with ``ep_size`` 1; more devices are queue A
item 7) is served by ``generate()`` and ``forward()``, routed in eval
mode; its prompts are padded to ``prompt_bucket`` as in the JAX engine,
and the padded positions take capacity slots there too, so both route
the same S tokens.  The server refuses it, as the JAX server does.

Tensor parallelism, one process per rank on ``torch.distributed``:
``tensor_parallel.tp_size`` mp builds the mesh ``{data: world / mp,
model: mp}`` and ``serving.mesh`` (with ``serving.enabled``) the mesh
``{data, model}`` it names, which must cover the world exactly.  The
layout is the model's Megatron ``partition_specs``.  The whole weights
(given, from a checkpoint, or drawn from seed 0 alike on every rank) are
cast, quantized when ``quant.enabled`` (per output channel whenever a
model axis is live: grouped scales would cross the shard boundaries),
then cut once into this rank's slice (``_prep_tp_params``: the fused
qkv's columns permuted into per-shard order, the row-parallel biases
divided by mp, each leaf's chunk along its model dim), and the whole
tree is dropped.  ``generate()`` and ``forward()`` run the model's
per-shard view (``tp_serving_view``) on the card's B5 and B1 at ``H /
mp`` heads, and the server its view with the data axis
(``serving/engine.py``).  A world that does not fit the mesh, or NCCL
with more ranks than cards, raises; no rank runs a smaller mesh.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import comm
from ..accelerator import resolve_device
from ..models.convert import (check_params, leaf_to_torch, tp_dims, tp_slice,
                              tree_map)
from ..models.transformer import ENCODER_DECODE, TransformerLM
from ..ops.quantizer.quantizer import dequantize, quantize
from ..parallel.collectives import qkv_shard_columns
from ..parallel.topology import MODEL_AXIS, MeshSpec, ProcessMesh
from ..runtime.checkpoint_engine.engine import latest_tag, read_state
from ..utils.logging import logger
from .config import DeepSpeedInferenceConfig
from .sampling import sample_batch


def refuse_out_of_slice(cfg: DeepSpeedInferenceConfig) -> None:
    """Config blocks this slice of the port cannot run."""
    later = []
    if cfg.moe.enabled and cfg.moe.ep_size > 1:
        later.append(f"moe.ep_size {cfg.moe.ep_size} (expert parallelism: "
                     f"multi-device, queue A item 7)")
    if later:
        raise NotImplementedError(
            f"{', '.join(later)}: not in the slices of the PyTorch port so "
            f"far; see ROADMAP.md queue A for the slice that brings it")


def _map_with_path(tree, fn, path=()):
    """``fn(path, leaf)`` over a nested dict."""
    if isinstance(tree, dict):
        return {k: _map_with_path(v, fn, path + (k,))
                for k, v in tree.items()}
    return fn(path, tree)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _zip_map(fn, tree, *rest):
    """``fn(leaf, *leaves)`` over nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _groups(shape) -> int:
    """Quantization groups of a leaf: the largest divisor of its element
    count at or under count / 2048 (the JAX engine's ``g_of``)."""
    n = int(np.prod(shape))
    for g in range(max(1, n // 2048), 0, -1):
        if n % g == 0:
            return g
    return 1


#: roots that keep full precision unless quant.quantize_embeddings
_QUANT_SKIP_ROOTS = ("embed", "pos_embed", "type_embed", "lm_head",
                     "mlm_head")


class InferenceEngine:
    def __init__(self, model: TransformerLM,
                 config: Optional[DeepSpeedInferenceConfig] = None,
                 params: Optional[Dict[str, Any]] = None, device=None,
                 mesh: Optional[ProcessMesh] = None):
        self.config = config or DeepSpeedInferenceConfig()
        refuse_out_of_slice(self.config)
        self.device = resolve_device(device)
        # an explicit observability block arms the process-global
        # telemetry before the server is built (the server takes its
        # tracer, registry and profiler handles at construction); None
        # leaves them as another engine of the process configured them
        if self.config.observability is not None:
            from ..observability import configure as _obs_configure
            _obs_configure(self.config.observability)
        self.dtype = self.config.compute_dtype()
        # kernel injection: flash routes t == 1 decode through kernel B5,
        # xla keeps plain attention (the JAX engine's rewrite).  Only the
        # xla/flash pair is rewritten: blocksparse is a model choice whose
        # layout must survive serving, and per-layer windows or another
        # softmax scale (GPT-Neo) pin a model to xla, as in the JAX
        # engine.  The model's activations take the engine's dtype, the
        # dtype of its weights, caches and pools, so the kernels never
        # meet a cast.
        mc = model.config
        want = mc.attn_impl
        if (want in ("xla", "flash") and not mc.attention_layers
                and not mc.attn_softmax_scale):
            want = "flash" if self.config.replace_with_kernel_inject else "xla"
        if (model.config.attn_impl, model.config.dtype) != (want, self.dtype):
            model = TransformerLM(dataclasses.replace(
                model.config, attn_impl=want, dtype=self.dtype))
        self.module = model
        self._init_mesh(mesh)
        if params is not None:
            check_params(model, params)
            self.params = tree_map(params, self._cast)
        elif self.config.checkpoint:
            self.params = self._load_checkpoint(self.config.checkpoint,
                                                self.config.checkpoint_tag)
        else:
            logger.warning("init_inference without params — using fresh "
                           "random weights (seed 0)")
            g = torch.Generator(device=self.device)
            g.manual_seed(0)
            # every float leaf in the engine's dtype, an MoE gate too
            # (the JAX engine casts its fresh init the same way)
            self.params = tree_map(model.init(g, self.device, self.dtype),
                                   self._cast)
        # int8 weight-only serving: int8 leaves in self.params, f32
        # scales in the parallel tree self._scales
        self._quantized = False
        self._scales = None
        #: int8 scales: "group" (one device) or "channel" (a live model
        #: axis, the JAX engine's rule)
        self._qmode = "channel" if self.tp_model_size > 1 else "group"
        if self.config.quant.enabled:
            self._quantize_weights()
        # the rank's slice, and the per-shard view generate() and
        # forward() run (made after quantization: the view shares the
        # model's block_transform as it stands)
        self._tp_model = model
        if self.tp_model_size > 1:
            self._prep_tp_params()
            self._tp_model = model.tp_serving_view(self.tp_model_size,
                                                   MODEL_AXIS, None)
        self._latencies: list = []      # per-token DECODE-only seconds
        self._ttfts: list = []          # prefill -> first-token seconds
        self._serving = None

    # ------------------------------------------------------------------
    # tensor parallelism
    # ------------------------------------------------------------------
    def _init_mesh(self, mesh: Optional[ProcessMesh]) -> None:
        """The (data, model) mesh: ``mesh`` as given, else from
        ``tensor_parallel.tp_size`` or ``serving.mesh``, checked against
        the world and the model's shapes; ``tp_data_size`` x
        ``tp_model_size`` 1 x 1 without one."""
        cfg = self.config
        if mesh is not None:
            extra = {a: n for a, n in mesh.shape.items()
                     if n > 1 and a not in ("data", "model")}
            if extra:
                raise ValueError(f"an inference mesh has data and model "
                                 f"axes only, got {extra}")
        tp = cfg.tensor_parallel.tp_size if cfg.tensor_parallel.enabled \
            else 1
        sdp, smp = ((cfg.serving.mesh.data, cfg.serving.mesh.model)
                    if cfg.serving.enabled else (1, 1))
        if tp > 1 and sdp * smp > 1 and tp != smp:
            raise ValueError(
                f"tensor_parallel.tp_size ({tp}) and serving.mesh.model "
                f"({smp}) must agree: the engine holds one model slice for "
                f"generate() and the server")
        n = comm.get_world_size()
        if mesh is not None:
            dp, mp = mesh.shape["data"], mesh.shape["model"]
            what = "the mesh's model axis"
        elif sdp * smp > 1:
            dp, mp, what = sdp, smp, "serving.mesh.model"
        elif tp > 1:
            mp, what = tp, "tensor_parallel.tp_size"
            dp = n // tp if n % tp == 0 else 1
        else:
            dp = mp = 1
        self.tp_data_size, self.tp_model_size = dp, mp
        self.mesh = None
        if dp * mp == 1:
            return
        c = self.module.config
        if mp > 1:
            if c.moe_enabled:
                raise NotImplementedError(
                    "tensor parallelism over an MoE model: the expert "
                    "stacks' model-axis layout is queue A item 7's "
                    "expert-parallel part")
            for name, dim in (("kv_heads", c.kv_heads),
                              ("num_heads", c.num_heads),
                              ("d_ff", c.ff_dim),
                              ("vocab_size", c.vocab_size)):
                if dim % mp:
                    raise ValueError(
                        f"{what} ({mp}) must divide {name} ({dim}) — "
                        f"heads/MLP columns/vocab partition evenly over "
                        f"the model axis")
        # the world must be the mesh exactly: no rank runs a smaller one
        if mesh is None and sdp * smp > 1 and n != dp * mp:
            raise ValueError(
                f"serving.mesh (data={dp}, model={mp}) needs {dp * mp} "
                f"devices, have {n}")
        if mesh is None and tp > 1 and n % tp:
            raise ValueError(
                f"tp_size {tp} x ep_size 1 does not divide {n} devices")
        self.mesh = mesh or ProcessMesh(MeshSpec(data=dp, model=mp),
                                        comm.get_rank())
        comm.set_mesh(self.mesh)

    def _prep_tp_params(self) -> None:
        """This rank's slice of the whole weights, once: the fused qkv's
        columns (kernel, bias and their channel scales) permuted into
        per-shard order (the JAX server's ``_tp_qkv_perm``: the rows of
        ``qkv_shard_columns`` end to end), the
        row-parallel ``out``/``fc_out`` biases divided by mp (the
        per-layer all-reduce restores them; a quantized bias through its
        scale), then each leaf's chunk along its model dim; a channel
        scale follows its kernel's last dim."""
        c, mp = self.module.config, self.tp_model_size
        index = self.mesh.axis_index(MODEL_AXIS)
        perm = torch.as_tensor(qkv_shard_columns(
            c.num_heads, c.kv_heads, c.hdim, mp).reshape(-1),
            dtype=torch.long, device=self.device)
        flags = self._qflags if self._quantized else None

        def prep(path, t, scale=False):
            tail = path[-2:]
            flagged = flags is not None and _at(flags, path)
            if tail in (("qkv", "kernel"), ("qkv", "bias")) and \
                    (not scale or flagged):
                t = t.index_select(-1, perm)
            if tail in (("out", "bias"), ("fc_out", "bias")) and \
                    flagged == scale:
                t = t / mp
            return t
        dims = tp_dims(self.module.partition_specs(self.params))
        if self._quantized:
            # a channel scale [(L,) last] is sharded where its kernel's
            # last dim is
            sdims = _zip_map(
                lambda d, v, f, sc: (sc.dim() - 1 if f and d == v.dim() - 1
                                     else None),
                dims, self.params, flags, self._scales)
            self._scales = tp_slice(_map_with_path(
                self._scales, lambda p, t: prep(p, t, scale=True)), sdims,
                mp, index)
        self.params = tp_slice(_map_with_path(self.params, prep), dims, mp,
                               index)

    def _load_checkpoint(self, ckpt_dir: str, tag) -> Dict[str, Any]:
        """The params subtree of a training checkpoint of the port
        (``runtime/checkpoint_engine``; tag as given, else ``latest``),
        cast to the engine's dtype on its device, as the JAX engine's
        ``_load_checkpoint`` restores its orbax state's params."""
        if tag is None:
            tag = latest_tag(ckpt_dir)
        path = os.path.join(os.path.abspath(ckpt_dir), str(tag))
        params = read_state(path)["params"]
        check_params(self.module, params)
        logger.info(f"inference weights loaded from {path}")
        return tree_map(params, self._cast)

    def _cast(self, x: Any) -> torch.Tensor:
        t = x if isinstance(x, torch.Tensor) else leaf_to_torch(x, "cpu")
        if t.is_floating_point():
            t = t.to(self.dtype)
        return t.to(self.device)

    # ------------------------------------------------------------------
    # int8 weight-only
    # ------------------------------------------------------------------
    def _quantize_weights(self) -> None:
        """Matrix leaves to int8 + f32 group scales (per output channel,
        ``[(L,) last]``, in "channel" mode), kept as parallel trees.  A stacked ``blocks`` leaf ``[L, ...]`` quantizes per layer
        (``[L, G, n / G]`` values, ``[L, G, 1]`` scales), so the model
        dequantizes one layer at a time through ``block_transform``.  A
        leaf out of scope keeps its tensor and an empty ``[(L,) 0, 1]``
        scale, as in the JAX engine."""
        bits = self.config.quant.bits or 8
        skip = (() if self.config.quant.quantize_embeddings
                else _QUANT_SKIP_ROOTS)

        def flag(path, l):
            return (l.dim() >= 2 and l.is_floating_point()
                    and path[0] not in skip)
        self._qflags = _map_with_path(self.params, flag)
        # logical matrix shape per leaf: a block leaf's per-layer slice
        self._qshapes = _map_with_path(
            self.params, lambda p, l: tuple(l.shape[1:] if p[0] == "blocks"
                                            else l.shape))

        levels = float(2 ** (bits - 1) - 1)

        def one(l, shape):
            if self._qmode == "channel":
                # per output channel: the max over every axis but the
                # last (a 1-D leaf: each element its own channel)
                x = l.to(torch.float32)
                a = (x.abs().amax(dim=tuple(range(x.dim() - 1)))
                     if x.dim() > 1 else x.abs())
                s = torch.where(a > 0, a * (1.0 / levels),
                                torch.ones_like(a))
                q = torch.clamp(torch.round(x / s), -levels, levels)
                return q.to(torch.int8), s
            q, s, _ = quantize(l, bits, _groups(shape), True)
            return q.to(torch.int8), s

        def qz(path, l):
            flagged = flag(path, l)
            if path[0] != "blocks":
                if not flagged:
                    return l, l.new_zeros((0, 1), dtype=torch.float32)
                return one(l, tuple(l.shape))
            n = l.shape[0]
            if not flagged:
                return l, l.new_zeros((n, 0, 1), dtype=torch.float32)
            if self._qmode == "channel":
                pairs = [one(l[i], tuple(l.shape[1:])) for i in range(n)]
                return (torch.stack([p[0] for p in pairs]),
                        torch.stack([p[1] for p in pairs]))
            g = _groups(l.shape[1:])
            q = torch.empty((n, g, l[0].numel() // g), dtype=torch.int8,
                            device=l.device)
            s = torch.empty((n, g, 1), dtype=torch.float32, device=l.device)
            for i in range(n):
                q[i], s[i] = one(l[i], tuple(l.shape[1:]))
            return q, s
        pairs = _map_with_path(self.params, qz)
        self.params = _zip_map(lambda t: t[0], pairs)
        self._scales = _zip_map(lambda t: t[1], pairs)
        self._quantized = True
        self.module.block_transform = self._block_dequant
        q_bytes = sum(t.numel() * t.element_size()
                      for t in _leaves(self.params))
        logger.info(f"int8 weight-only serving: params now "
                    f"{q_bytes / 2**20:.1f} MiB on device (bits={bits})")

    def _dequant_leaf(self, q, s, flagged, shape):
        if not flagged:
            return q
        if self._qmode == "channel":
            # per output channel: shard-local under tensor parallelism
            return (q.to(torch.float32) * s).to(self.dtype)
        return dequantize(q, s, None, shape, self.dtype)

    def _block_dequant(self, sl):
        """The model's ``block_transform``: one layer's ``{q, s}`` view to
        the standard block tree in the engine's dtype (full precision
        lives for one layer)."""
        return _zip_map(self._dequant_leaf, sl["q"], sl["s"],
                        self._qflags["blocks"], self._qshapes["blocks"])

    def _model_params(self, params=None, scales=None):
        """The params tree the model takes: as stored when unquantized;
        else non-block leaves dequantized here (none in the default
        scope) and the int8 blocks passed on as ``{q, s}`` for the
        per-layer seam."""
        params = self.params if params is None else params
        if not self._quantized:
            return params
        scales = self._scales if scales is None else scales
        out = {k: _zip_map(self._dequant_leaf, v, scales[k],
                           self._qflags[k], self._qshapes[k])
               for k, v in params.items() if k != "blocks"}
        out["blocks"] = {"q": params["blocks"], "s": scales["blocks"]}
        return out

    def _enter_mesh(self) -> None:
        """Point the collectives at this engine's mesh (another engine of
        the process may have set its own since)."""
        if self.mesh is not None:
            comm.set_mesh(self.mesh)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def forward(self, input_ids, token_type_ids=None) -> torch.Tensor:
        """Full-sequence f32 logits ``[B, T, V]`` of ``input_ids [B, T]``
        (an encoder's ``token_type_ids`` default to 0) through the
        uncached forward (kernel B1 with kernel injection, B8 on a
        block-sparse model)."""
        def ids(x):
            x = (x if isinstance(x, torch.Tensor)
                 else torch.as_tensor(np.asarray(x)))
            return x.to(self.device, torch.int64)
        self._enter_mesh()
        return self._tp_model.apply(
            self._model_params(), ids(input_ids),
            token_type_ids=(None if token_type_ids is None
                            else ids(token_type_ids)))

    __call__ = forward

    # ------------------------------------------------------------------
    # generation
    # ------------------------------------------------------------------
    def _prefill(self, ids: torch.Tensor, true_len: int, cache_len: int):
        """Prompt forward into a fresh dense cache → (cache with index at
        the true length, f32 logits of the last true position)."""
        cache = self._tp_model.init_cache(ids.shape[0], cache_len,
                                          dtype=self.dtype,
                                          device=self.device)
        logits, cache = self._tp_model.apply(self._model_params(), ids,
                                             cache=cache)
        # bucketing: rows past the true length hold padding; resetting the
        # index lets decode overwrite them, and no kernel reads past it
        cache["index"] = true_len
        return cache, logits[:, true_len - 1]

    @torch.inference_mode()
    def generate(self, input_ids, max_new_tokens: int = 32,
                 temperature: Optional[float] = None,
                 top_k: Optional[int] = None, top_p: Optional[float] = None,
                 eos_token_id: Optional[int] = None, seed: int = 0,
                 num_beams: int = 1) -> torch.Tensor:
        """Prompt ``[B, T]`` → generated tokens ``[B, max_new_tokens]``
        (int64, on the engine's device).  Output token j is drawn with
        ``(seed, j)`` (see ``sampling.py``); temperature 0 is greedy."""
        if num_beams > 1:
            raise NotImplementedError(
                "num_beams > 1 is not supported: the decode path holds one "
                "KV-cache line per batch row. Use sampling (temperature / "
                "top_k / top_p) or expand the batch with repeated prompts.")
        if not self.module.config.causal:
            raise NotImplementedError(ENCODER_DECODE)
        ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.int64)
        if ids.dim() != 2:
            raise ValueError(f"input_ids must be [B, T], got "
                             f"{tuple(ids.shape)}")
        temperature = (self.config.temperature if temperature is None
                       else temperature)
        top_k = self.config.top_k if top_k is None else top_k
        top_p = self.config.top_p if top_p is None else top_p
        batch, true_len = ids.shape
        bucket = self.config.prompt_bucket
        if bucket:
            padded = max(bucket, -(-true_len // bucket) * bucket)
            padded = min(padded,
                         max(true_len,
                             self.config.max_out_tokens - max_new_tokens))
            if padded > true_len:
                ids = torch.nn.functional.pad(ids, (0, padded - true_len))
        cache_len = ids.shape[1] + max_new_tokens
        if cache_len > self.config.max_out_tokens:
            raise ValueError(
                f"prompt+new = {cache_len} exceeds max_out_tokens "
                f"({self.config.max_out_tokens})")
        if batch > self.config.max_batch_size:
            raise ValueError(
                f"batch {batch} exceeds max_batch_size "
                f"({self.config.max_batch_size}) — raise it in the config "
                f"(it bounds the KV workspace, reference inference_context.h)")
        ids = ids.to(self.device)
        self._enter_mesh()

        def sample(logits, j):
            return sample_batch(logits, seed, j, temperature, top_k, top_p)

        t0 = time.perf_counter()
        cache, last = self._prefill(ids, true_len, cache_len)
        tok = sample(last, 0)
        done = (torch.zeros_like(tok, dtype=torch.bool)
                if eos_token_id is None else tok == eos_token_id)
        self._sync()
        t1 = time.perf_counter()
        toks = [tok]
        params = self._model_params()
        for j in range(1, max_new_tokens):
            logits, cache = self._tp_model.apply(params, tok[:, None],
                                                 cache=cache)
            nxt = sample(logits[:, -1], j)
            if eos_token_id is not None:
                nxt = torch.where(done, torch.full_like(nxt, eos_token_id),
                                  nxt)
                done = done | (nxt == eos_token_id)
            toks.append(nxt)
            tok = nxt
        out = torch.stack(toks, dim=1)
        self._sync()
        t2 = time.perf_counter()
        self._ttfts.append(t1 - t0)
        # decode-only per-token latency: the prefill cost lives in TTFT
        self._latencies.append((t2 - t1) / max(max_new_tokens - 1, 1))
        return out

    def latency_stats(self) -> Dict[str, float]:
        """Decode and first-token latency over ``generate`` calls so far:
        ``p50_ms``/``p90_ms``/``tokens_per_sec`` are decode-only per-token
        numbers, ``ttft_p50_ms``/``ttft_p90_ms`` prompt-to-first-token.
        The first call (kernel build and warm-up) is dropped when there
        are more."""
        if not self._latencies:
            return {}
        lat = np.asarray(self._latencies[1:] or self._latencies)
        ttft = np.asarray(self._ttfts[1:] or self._ttfts)
        return {"p50_ms": float(np.percentile(lat, 50) * 1e3),
                "p90_ms": float(np.percentile(lat, 90) * 1e3),
                "tokens_per_sec": float(1.0 / np.mean(lat)),
                "ttft_p50_ms": float(np.percentile(ttft, 50) * 1e3),
                "ttft_p90_ms": float(np.percentile(ttft, 90) * 1e3)}

    # ------------------------------------------------------------------
    # continuous-batching serving
    # ------------------------------------------------------------------
    def serving_engine(self, seed: Optional[int] = None, draft_model=None,
                       draft_params=None):
        """The continuous-batching server over this engine's weights,
        gated on the ``serving`` config block.  ``seed`` is the base
        sampling key of requests submitted without their own.
        ``draft_model`` (a smaller model sharing the target's vocab, its
        params in ``draft_params`` — None draws an untrained draft from
        seed 1) arms speculative decoding: ``serving.spec_k`` proposals
        per slot per iteration, verified by the target in the same mixed
        step, with streams equal to the plain server's."""
        if not self.config.serving.enabled:
            raise ValueError(
                "continuous-batching serving is disabled — set "
                '{"serving": {"enabled": true}} in the inference config')
        if self._serving is None:
            from .serving.engine import ServingEngine
            self._serving = ServingEngine(self, seed=seed,
                                          draft_model=draft_model,
                                          draft_params=draft_params)
        elif draft_model is not None \
                and self._serving._draft_given is not draft_model:
            raise ValueError(
                "serving engine already built without this draft model "
                "— pass draft_model on the FIRST serving_engine() call")
        return self._serving


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
