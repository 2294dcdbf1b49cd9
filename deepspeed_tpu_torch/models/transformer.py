"""Transformer LM of the port: every model family of the JAX package's
``module_inject/policies.py`` (GPT-2/GPT-3, GPT-NeoX, GPT-J, OPT, BLOOM,
GPT-Neo, LLaMA, BERT and DistilBERT).

Counterpart of ``deepspeed_tpu/models/transformer.py``: learned
positions, rotary embeddings (``rotary_pct``, ``rotary_base``, GPT-J
interleaved or rotate-half pairing) or ALiBi (BLOOM; never on a kernel:
flash and B5 are skipped for it and the paged server refuses it, as in
the JAX model); LayerNorm or RMSNorm; pre-norm blocks with a serial or a
parallel residual (NeoX, GPT-J: ``x + attn(ln1 x) + mlp(ln2 x)``) or
post-norm encoder blocks (BERT: ``ln(x + f(x))``, ``causal=False``, no
final norm, token types, the MLM head); an optional layernorm on the
embeddings (BLOOM, BERT); a plain or gated (SwiGLU) MLP with any of the
JAX package's activations; multi-head or grouped-query attention
(``num_kv_heads``; the fused qkv projection is q | k | v along its
output); per-layer local windows and an unscaled softmax (GPT-Neo:
``attention_layers``, ``attn_softmax_scale``, on plain attention only);
tied or untied (``lm_head``, with GPT-J's optional bias) output, with or
without biases; bf16 activations with f32 norms, rotary, softmax and
logits.  Mixture-of-Experts (``moe_num_experts``): every ``moe_freq``-th
layer's MLP is an MoE layer of ``moe/layer.py`` (the JAX model's
superblock: ``blocks = {"dense": ..., "moe_blk": {..., "moe": ...}}``
stacked on ``num_layers / moe_freq``); ``loss`` adds
``moe_aux_loss_coef`` times the summed load-balance loss and routes in
train mode (``batch["moe_rng"]`` seeds the noise), while ``apply``
routes in eval mode.

Parameters are a nested dict in the JAX package's layout (dense kernels
``[in, out]``, block leaves stacked on a leading layer axis), so
``models/convert.py`` moves weights between the packages with no
transpose.  Where the JAX model runs ``lax.scan`` over the stacked
blocks, this one runs a Python loop over layer views of the same
tensors, taken with one ``unbind(0)`` per leaf (under autograd its
backward is one ``stack``, where per-layer indexing would build a zero
tensor of the whole stack for every layer).

Training: ``loss`` (labels shifted, the last position masked) runs
``hidden_states`` and ``nll_from_hidden`` (the fused loss head, the
chunked checkpointed head, or the dense head, as in the JAX package).
With ``attn_impl="flash"`` the uncached forward runs kernel B1 (k/v at
kv-head width) and its backward kernel B2, or B3 and B4 for a sequence
past one 1024-row block or grouped-query attention (the JAX dispatch
rule); ``remat="full"`` recomputes each block in the backward
(``torch.utils.checkpoint``), so B1 runs twice per layer and step, and
``dots_saveable``, ``dots_no_batch`` and ``nothing_saveable`` keep the
JAX model's selective policies (``REMAT_POLICIES``); ``host_offload`` is
``full`` with each block's one saved input copied to pinned host memory
between the forward and the backward (``HostOffloadBlock``).  With
``attn_impl="blocksparse"`` and a ``sparsity_config`` the uncached
forward walks the layout's blocks: k/v expanded over the group, then
kernel B8 and, in the backward, B9 and B10 when T divides by the block;
plain attention masked by the layout at any other T and on the dense
cache (never kernel B5), as in the JAX model.  The paged server refuses
such a model (its kernels do not apply the layout).

Caches are updated IN PLACE (JAX returns new arrays): ``apply`` writes
the new rows into the dense cache tensors it was given (``[L, B, T, H,
D]`` in layer order for an MoE model too, where the JAX model keeps
``[scan, A, B, T, H, D]``: no cache crosses between the packages; the
paged server refuses MoE, as the JAX one does), and the paged
mixed step scatters every new k/v row (encoded with ``kv_quantize`` into
values and scales for an int8 or packed-int4 pool) into the pool tensors
it was given before the attention kernels read them.

``block_transform`` (default the identity) is applied to each layer's
view of ``params["blocks"]`` in every layer loop: the seam through which
the int8 weight-only engine hands the model quantized blocks and
dequantizes one layer at a time, as the JAX model's scan body does.

Tensor parallelism (Megatron's layout, ``partition_specs``): a rank runs
the per-shard view of :meth:`TransformerLM.tp_serving_view` or
:meth:`TransformerLM.tp_train_view`, whose config carries ``num_heads /
mp`` and ``kv_heads / mp`` heads, over its slice of the params
(``models/convert.py::tp_slice``; the fused qkv in per-shard column
order, the row-parallel ``out`` and ``fc_out`` biases divided by mp).
Every kernel then simply sees fewer heads.  Each branch output is a
partial sum over the ``model`` ranks, reduced once a branch (``_red``:
an all-reduce when serving, ``reduce_from`` in training, where
``copy_to`` marks the branch inputs, ``_fin``); the embedding is a
vocab-sharded masked lookup reduced the same way, with the position and
type tables added after it; serving's head all-gathers the local logits
in vocab order, and training's loss is the vocab-parallel cross-entropy
(``masked_nll_sum``), so the whole ``[.., V]`` logits never exist
there.  ALiBi takes each shard's slice of the whole model's slopes.  On
a serving mesh with a ``data`` axis the paged mixed step holds this
rank's decode slots only: the block tables are all-gathered once a step
for the chunk, and the decode rows' k/v (and their write indices and
scales) are all-gathered over ``data`` before the scatter, so every data
rank's pool replica applies every slot's row.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from . import layers as L
from .. import comm
from ..accelerator import resolve_device
from ..parallel.collectives import copy_to, reduce_from
from ..ops import build
from ..ops.transformer.decode_attention import decode_attention
from ..ops.transformer.flash_attention import flash_attention_bthd
from ..ops.transformer.fused_loss import fused_linear_xent
from ..ops.quantizer.quantizer import kv_quantize
from ..ops.transformer.paged_decode_attention import (
    paged_decode_attention, paged_prefill_attention)
from ..ops.sparse_attention.blocksparse_flash import (
    blocksparse_attention_bthd)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 50304
    max_seq_len: int = 1024
    num_layers: int = 12
    num_heads: int = 12
    num_kv_heads: int = 0              # 0 = MHA
    d_model: int = 768
    d_ff: int = 0                      # 0 -> 4 * d_model
    head_dim: int = 0                  # 0 -> d_model // num_heads
    pos_embedding: str = "learned"     # learned | rotary | alibi | none
    # decoder (causal) vs encoder (bidirectional: BERT)
    causal: bool = True
    # "pre": x + f(ln x) (decoders); "post": ln(x + f(x)) (BERT)
    norm_position: str = "pre"
    # final norm after the block stack (BERT has none)
    final_layernorm: bool = True
    # BLOOM/BERT layernorm on the embedding output (params["ln_embed"])
    embed_layernorm: bool = False
    # BERT token-type (segment) embeddings (params["type_embed"]); 0: none
    token_type_vocab: int = 0
    # BERT MLM head: dense, act, LN, the tied decoder and a vocab bias
    # (params["mlm_head"])
    mlm_head: bool = False
    # NeoX/GPT-J: x + attn(ln1 x) + mlp(ln2 x)
    parallel_residual: bool = False
    norm_type: str = "layernorm"
    activation: str = "gelu"
    gated_mlp: bool = False
    use_bias: bool = True
    tie_embeddings: bool = True
    dtype: torch.dtype = torch.bfloat16        # activation dtype
    param_dtype: torch.dtype = torch.float32
    remat: str = "none"                # none | full (per block)
    attn_impl: str = "xla"             # xla | flash | blocksparse
    # attn_impl="blocksparse": an ops.sparse_attention SparsityConfig
    # whose layout the uncached forward walks (kernels B8-B10)
    sparsity_config: Any = None
    layernorm_eps: float = 1e-5
    rotary_pct: float = 1.0
    rotary_base: float = 10000.0
    # True = GPT-J "rotate_every_two" pairing, False = rotate_half (NeoX,
    # LLaMA)
    rotary_interleaved: bool = True
    # softmax scale: 0 = 1/sqrt(head_dim); GPT-Neo trains unscaled (1.0)
    attn_softmax_scale: float = 0.0
    # GPT-Neo: "global"/"local" per layer; a local layer sees its last
    # ``local_attention_window`` keys (itself included).  Empty: global
    attention_layers: tuple = ()
    local_attention_window: int = 256
    # chunked cross-entropy: tokens per loss chunk (0 = off)
    loss_chunk: int = 512
    # analytic loss head (ops/transformer/fused_loss.py)
    fused_loss_head: bool = True
    # -- MoE (``moe/``): every ``moe_freq``-th layer's MLP is an MoE
    moe_num_experts: int = 0           # 0: a dense model
    moe_freq: int = 2                  # 1: every layer, 2: every other
    moe_k: int = 1                     # top-1 or top-2 gating
    moe_capacity_factor: float = 1.0
    moe_eval_capacity_factor: float = 1.0
    moe_min_capacity: int = 4
    moe_use_residual: bool = False     # PR-MoE
    moe_noisy_gate_policy: Optional[str] = None
    moe_use_rts: bool = True
    moe_aux_loss_coef: float = 0.01
    moe_d_ff: int = 0                  # 0: ff_dim

    @property
    def ff_dim(self) -> int:
        return self.d_ff or 4 * self.d_model

    @property
    def moe_enabled(self) -> bool:
        return self.moe_num_experts > 0

    @property
    def scan_length(self) -> int:
        """Stacked superblocks: ``num_layers / moe_freq`` with MoE (a
        dense layer then an MoE layer at ``moe_freq`` 2, an MoE layer at
        1), else ``num_layers``."""
        if not self.moe_enabled:
            return self.num_layers
        if self.moe_freq not in (1, 2):
            raise ValueError("moe_freq must be 1 or 2")
        if self.num_layers % self.moe_freq:
            raise ValueError(
                f"num_layers ({self.num_layers}) must divide by moe_freq "
                f"({self.moe_freq})")
        return self.num_layers // self.moe_freq

    @property
    def attn_per_block(self) -> int:
        return self.moe_freq if self.moe_enabled else 1

    @property
    def hdim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def kv_heads(self) -> int:
        n = self.num_kv_heads or self.num_heads
        if self.num_heads % n:
            raise ValueError(f"num_heads {self.num_heads} must divide by "
                             f"num_kv_heads {n}")
        return n

    @property
    def qkv_dim(self) -> int:
        return (self.num_heads + 2 * self.kv_heads) * self.hdim

    @property
    def rotary_dim(self) -> int:
        d = int(self.hdim * self.rotary_pct)
        return d - d % 2

    def num_params(self, active: bool = False) -> int:
        """Parameters of the model; with MoE every expert, the gate and
        the PR-MoE leaves count.  ``active``: those one token runs
        through (an MoE layer's gate, its k experts and the PR-MoE
        leaves, not all E experts), the N of a step's 6 N flops."""
        d, f, v = self.d_model, self.ff_dim, self.vocab_size
        nhd = self.num_heads * self.hdim
        norm = 2 * d if self.norm_type == "layernorm" else d
        attn = d * self.qkv_dim + nhd * d + 2 * norm
        mlp = 2 * d * f
        if self.gated_mlp:
            mlp += d * f
        if self.use_bias:
            attn += self.qkv_dim + d
            mlp += f + d
            if self.gated_mlp:
                mlp += f
        n_moe = self.scan_length if self.moe_enabled else 0
        layers = (self.num_layers - n_moe) * (attn + mlp)
        if n_moe:
            fe = self.moe_d_ff or f
            expert = 2 * d * fe + fe + d       # GELU MLP with biases
            moe = d * self.moe_num_experts + expert * (
                self.moe_k if active else self.moe_num_experts)
            if self.moe_use_residual:
                moe += expert + 2 * d + 2
            layers += n_moe * (attn + moe)
        emb = v * d + (self.max_seq_len * d
                       if self.pos_embedding == "learned" else 0)
        head = 0 if self.tie_embeddings else d * v
        return layers + emb + head + norm


GPT2_SIZES = {
    "125m": dict(num_layers=12, num_heads=12, d_model=768),
    "350m": dict(num_layers=24, num_heads=16, d_model=1024),
    "760m": dict(num_layers=24, num_heads=16, d_model=1536),
    "1.3b": dict(num_layers=24, num_heads=32, d_model=2048),
    "2.7b": dict(num_layers=32, num_heads=32, d_model=2560),
    "6.7b": dict(num_layers=32, num_heads=32, d_model=4096),
    "13b": dict(num_layers=40, num_heads=40, d_model=5120),
}


NEOX_SIZES = {
    "1.3b": dict(num_layers=24, num_heads=16, d_model=2048),
    "20b": dict(num_layers=44, num_heads=64, d_model=6144, rotary_pct=0.25),
}


def gpt2_config(size: str = "125m", **kw) -> TransformerConfig:
    return TransformerConfig(**{"pos_embedding": "learned",
                                "parallel_residual": False,
                                **GPT2_SIZES[size], **kw})


def neox_config(size: str = "1.3b", **kw) -> TransformerConfig:
    """The GPT-NeoX family: rotary (rotate-half pairing), parallel
    residual."""
    return TransformerConfig(**{"pos_embedding": "rotary",
                                "parallel_residual": True,
                                "rotary_interleaved": False,
                                **NEOX_SIZES[size], **kw})


#: what each configuration outside the port's slices so far needs, and
#: the later slice (ROADMAP.md queue A) that brings it
_OUT_OF_SLICE = (
    (lambda c: c.attn_impl not in ("xla", "flash", "blocksparse"),
     "attn_impl={attn_impl!r}", "multi-device (ROADMAP.md queue A item 7)"),
)

#: the message of a KV-cache decode on an encoder (the JAX model's)
ENCODER_DECODE = ("KV-cache decode on a non-causal (encoder) model is "
                  "meaningless — encoders have no autoregressive order")


_aten = torch.ops.aten
#: matrix products without a batch dimension (a dense layer's GEMM, the
#: loss head's), and the batched ones (attention's einsums)
_DOTS_NO_BATCH = frozenset(
    (_aten.mm, _aten.addmm, _aten.mv, _aten.addmv, _aten.dot))
_DOTS = _DOTS_NO_BATCH | frozenset((_aten.bmm, _aten.baddbmm))


def _save_only(ops):
    """A selective-checkpoint policy: save the outputs of ``ops``,
    recompute everything else."""
    def policy(ctx, op, *args, **kwargs):
        del ctx, args, kwargs
        return (CheckpointPolicy.MUST_SAVE
                if getattr(op, "overloadpacket", None) in ops
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return policy


#: the JAX model's ``jax.checkpoint`` policies (``None``: no block is
#: checkpointed; "full": only its input is kept), as the selective
#: policies of ``torch.utils.checkpoint``.  The CUDA kernels launch
#: through ctypes, where the dispatcher never sees them: they and the
#: buffers they fill are recomputed under every policy, never saved, as a
#: Pallas call is no "dot" to ``jax.checkpoint``
REMAT_POLICIES = {
    "none": None,
    "full": None,
    "dots_saveable": _save_only(_DOTS),
    "dots_no_batch": _save_only(_DOTS_NO_BATCH),
    "nothing_saveable": _save_only(frozenset()),
}


def check_in_slice(c: TransformerConfig) -> None:
    """Raise for a configuration the port does not run (yet), and for
    the ones the JAX model's constructor refuses."""
    for test, what, where in _OUT_OF_SLICE:
        if test(c):
            raise NotImplementedError(
                f"{what.format(**dataclasses.asdict(c))} is outside the "
                f"slices of the PyTorch port so far; {where} brings it")
    if c.attention_layers:
        if len(c.attention_layers) != c.num_layers:
            raise ValueError(
                f"attention_layers has {len(c.attention_layers)} entries "
                f"for {c.num_layers} layers")
        bad = set(c.attention_layers) - {"global", "local"}
        if bad:
            raise ValueError(f"attention_layers entries must be "
                             f"'global'/'local', got {sorted(bad)}")
        if c.moe_enabled:
            raise NotImplementedError(
                "attention_layers (per-layer local windows) is not "
                "plumbed through the MoE superblock scan")
        if c.attn_impl != "xla":
            raise NotImplementedError(
                f"attention_layers needs attn_impl='xla' (the kernels take "
                f"no per-layer window operand); got {c.attn_impl!r}")
    if c.attn_softmax_scale and c.attn_impl != "xla":
        raise NotImplementedError(
            "attn_softmax_scale != 1/sqrt(hd) needs attn_impl='xla' (B1 "
            "and B5 run on the model's paths at the standard scale)")
    if c.pos_embedding == "alibi" and c.attn_impl == "blocksparse":
        raise NotImplementedError(
            "ALiBi with attn_impl='blocksparse': the block-sparse kernels "
            "take no bias (the JAX model drops it on that path)")
    if c.pos_embedding not in ("learned", "rotary", "alibi", "none"):
        raise ValueError(f"unknown pos_embedding {c.pos_embedding!r}")
    if c.norm_position not in ("pre", "post"):
        raise ValueError(f"unknown norm_position {c.norm_position!r}")
    if c.remat not in REMAT_POLICIES and c.remat != "host_offload":
        raise ValueError(f"unknown remat policy {c.remat!r} (one of "
                         f"{sorted(REMAT_POLICIES)} or 'host_offload')")
    if c.moe_enabled:
        _ = c.scan_length              # raises unless moe_freq is 1 or 2
        #                                and divides num_layers
        if c.moe_k not in (1, 2):
            raise ValueError(f"Only top-1 and top-2 gating supported, got "
                             f"k={c.moe_k}")


def _tensor_leaves(tree, out: List[torch.Tensor]):
    """``tree`` with each tensor leaf replaced by its index in ``out``."""
    if isinstance(tree, dict):
        return {k: _tensor_leaves(v, out) for k, v in tree.items()}
    out.append(tree)
    return len(out) - 1


def _fill(tree, leaves):
    if isinstance(tree, dict):
        return {k: _fill(v, leaves) for k, v in tree.items()}
    return leaves[tree]


class HostOffloadBlock(torch.autograd.Function):
    """``remat="host_offload"``: the block runs without grad in the
    forward, and its input (the residual stream, the JAX model's
    ``block_in``) is the one tensor kept, copied to pinned host memory
    on the current stream (a ``non_blocking`` copy, so the host never
    touches it); the backward copies it back on the same stream and
    recomputes the block with grad: ``remat="full"``'s arithmetic.  On the
    CPU the input is kept as it is (no pinning was asked for)."""

    @staticmethod
    def forward(ctx, run, x, *leaves):
        ctx.run = run
        with torch.no_grad():
            outs = run(x, leaves)
        if x.is_cuda:
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            host.copy_(x, non_blocking=True)
        else:
            host = x.detach()
        ctx.x_host, ctx.x_device = host, x.device
        ctx.save_for_backward(*leaves)
        ctx.mark_non_differentiable(*[o for o in outs
                                      if not o.is_floating_point()])
        return outs

    @staticmethod
    def backward(ctx, *douts):
        x = ctx.x_host.to(ctx.x_device, non_blocking=True)
        x = x.detach().requires_grad_(True)
        leaves = [t.detach().requires_grad_(t.requires_grad)
                  for t in ctx.saved_tensors]
        with torch.enable_grad():
            outs = ctx.run(x, leaves)
        pairs = [(o, g) for o, g in zip(outs, douts)
                 if g is not None and o.requires_grad]
        wrt = [x] + [t for t in leaves if t.requires_grad]
        grads = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                         [g for _, g in pairs],
                                         allow_unused=True))
        dx = next(grads)
        dleaves = [next(grads) if t.requires_grad else None for t in leaves]
        return (None, dx, *dleaves)


def host_offload_checkpoint(fn, params: Params, x: torch.Tensor, *rest):
    """``fn(params, x, *rest)`` under ``HostOffloadBlock``: tensor
    outputs pass through the autograd function, others (an MoE block's
    capacity) come back as ``fn`` gave them."""
    leaves: List[torch.Tensor] = []
    skeleton = _tensor_leaves(params, leaves)
    box = {}

    def run(xx, ls):
        out = fn(_fill(skeleton, ls), xx, *rest)
        out = out if isinstance(out, tuple) else (out,)
        box["kinds"] = [None if torch.is_tensor(o) else o for o in out]
        return tuple(o for o in out if torch.is_tensor(o))
    tensors = iter(HostOffloadBlock.apply(run, x, *leaves))
    out = tuple(next(tensors) if k is None else k for k in box["kinds"])
    return out if len(out) > 1 else out[0]


def layer_views(blocks: Params) -> List[Params]:
    """Per-layer views of the stacked block tree (no copy): one
    ``unbind(0)`` per leaf."""
    flat = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                flat[path + (k,)] = v.unbind(0)
    walk(blocks, ())
    n = len(next(iter(flat.values())))
    layers = []
    for i in range(n):
        layer: Params = {}
        for path, views in flat.items():
            node = layer
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = views[i]
        layers.append(layer)
    return layers


def moe_generator(rng: Any, device) -> Optional[torch.Generator]:
    """A routing generator on ``device`` from ``batch["moe_rng"]``: a
    ``torch.Generator`` as given, a seed (int or one-element tensor) as
    a new generator seeded with it, None as None."""
    if rng is None or isinstance(rng, torch.Generator):
        return rng
    g = torch.Generator(device=device)
    g.manual_seed(int(rng))
    return g


def masked_nll_sum(proj, x: torch.Tensor, labels: torch.Tensor,
                   mask: torch.Tensor, chunk: int,
                   tp_axis: Optional[str] = None) -> torch.Tensor:
    """Sum over the tokens of ``mask`` times the NLL of ``labels`` under
    the f32 logits ``proj(x)``, in ``chunk``-token columns (each
    recomputed in the backward when ``chunk`` is below T and gradients
    are on, so one ``[B, chunk, V]`` block of logits is live).  With
    ``tp_axis``, Megatron's vocab-parallel form: ``proj`` gives the
    shard's ``[.., V / mp]`` logits, the max over the shards carries no
    gradient, and the sum of exponentials and the target logit (zero off
    the shard that owns the label) reduce through ``reduce_from``."""
    t = labels.shape[1]
    idx = comm.axis_index(tp_axis) if tp_axis is not None else 0

    def body(xc, yc, mc):
        logits = proj(xc)
        if tp_axis is None:
            lse = torch.logsumexp(logits, dim=-1)
            tgt = logits.gather(-1, yc[..., None])[..., 0]
            return torch.sum((lse - tgt) * mc)
        vloc = logits.shape[-1]
        local = yc - idx * vloc
        mine = (local >= 0) & (local < vloc)
        with torch.no_grad():
            m = comm.all_reduce(logits.amax(dim=-1), comm.ReduceOp.MAX,
                                tp_axis)
        se = torch.exp(logits - m[..., None]).sum(dim=-1)
        lse = m + torch.log(reduce_from(se, tp_axis))
        tgt = logits.gather(-1, local.clamp(0, vloc - 1)[..., None])[..., 0]
        tgt = reduce_from(torch.where(mine, tgt, torch.zeros_like(tgt)),
                          tp_axis)
        return torch.sum((lse - tgt) * mc)
    remat = chunk < t and torch.is_grad_enabled()
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, t, chunk):
        part = (x[:, c0:c0 + chunk], labels[:, c0:c0 + chunk],
                mask[:, c0:c0 + chunk])
        tot = tot + (checkpoint(body, *part, use_reentrant=False,
                                preserve_rng_state=False)
                     if remat else body(*part))
    return tot


class TransformerLM(nn.Module):
    """``init`` → params tree, ``apply`` → f32 logits.  The module holds
    the config only; weights live in the tree the caller passes (the
    inference engine owns them), as in the JAX package."""

    def __init__(self, config: TransformerConfig):
        super().__init__()
        check_in_slice(config)
        self.config = config
        # rotary (cos, sin) tables per device, built on first use
        self._rotary: Dict[torch.device, Tuple[torch.Tensor,
                                               torch.Tensor]] = {}
        # the block-sparse layout at the training context, per device
        self._layout: Dict[torch.device, torch.Tensor] = {}
        # per-layer params hook: one layer's view of params["blocks"] to
        # the standard block tree (int8 serving dequantizes here)
        self.block_transform = lambda bp: bp
        # each MoE layer's (exp_counts [E] int32, tokens kept, capacity)
        # of the last forward, in layer order (device tensors: no sync)
        self.moe_stats: List[Tuple[torch.Tensor, torch.Tensor, int]] = []
        self._moe = None
        if config.moe_enabled:
            from ..moe.layer import MoEConfig, MoELayer
            self._moe = MoELayer(
                config.d_model,
                MoEConfig(num_experts=config.moe_num_experts,
                          k=config.moe_k,
                          capacity_factor=config.moe_capacity_factor,
                          eval_capacity_factor=config.moe_eval_capacity_factor,
                          min_capacity=config.moe_min_capacity,
                          use_residual=config.moe_use_residual,
                          noisy_gate_policy=config.moe_noisy_gate_policy,
                          use_rts=config.moe_use_rts,
                          aux_loss_coef=config.moe_aux_loss_coef),
                d_ff=config.moe_d_ff or config.ff_dim,
                depth_scale=config.num_layers)

    # -- tensor parallelism -------------------------------------------------
    #: the model axis of a per-shard view (None: the whole model), the
    #: serving mesh's data axis, training's conjugate collectives, and
    #: the whole model's head count (ALiBi's slopes)
    _tp_axis: Optional[str] = None
    _dp_axis: Optional[str] = None
    _tp_exact_bwd = False
    _tp_full_heads = 0

    def tp_serving_view(self, model_shards: int, tp_axis: Optional[str],
                        dp_axis: Optional[str]) -> "TransformerLM":
        """Shallow copy of this model whose config carries per-shard head
        counts (``num_heads`` and ``kv_heads`` over ``model_shards``,
        ``head_dim`` pinned), the seam tensor-parallel serving runs
        through: the fused-qkv split, the rotary reshape and every
        kernel's heads become shard-local with no kernel change.
        ``tp_axis`` arms the collectives (the all-reduce of each branch,
        the vocab-sharded embedding and head), ``dp_axis`` the paged
        step's decode-slot sharding.  The original model is untouched;
        rotary tables and ``block_transform`` are shared by reference."""
        c = self.config
        if model_shards > 1:
            if c.kv_heads % model_shards or c.num_heads % model_shards:
                raise ValueError(
                    f"model_shards {model_shards} must divide num_heads "
                    f"{c.num_heads} and kv_heads {c.kv_heads}")
            if c.moe_enabled:
                raise NotImplementedError(
                    "tensor parallelism over an MoE model: the expert "
                    "stacks' model-axis layout is queue A item 7's "
                    "expert-parallel part")
            if c.mlm_head:
                raise NotImplementedError(
                    "tensor parallelism over the MLM head (BERT): its "
                    "vocab bias has no model-axis layout in the port "
                    "(queue A item 7)")
            local = dataclasses.replace(
                c, num_heads=c.num_heads // model_shards,
                num_kv_heads=c.kv_heads // model_shards, head_dim=c.hdim)
        else:
            local = c
        view = copy.copy(self)
        view.config = local
        view._tp_axis = tp_axis if model_shards > 1 else None
        view._dp_axis = dp_axis
        view._tp_full_heads = c.num_heads
        view._tp_exact_bwd = False
        return view

    def tp_train_view(self, model_shards: int,
                      tp_axis: Optional[str]) -> "TransformerLM":
        """The per-shard view for training: the serving view's heads,
        with ``copy_to``/``reduce_from`` as the per-branch collectives
        (so autograd sees exact gradients) and the vocab-parallel loss.
        The fused-qkv column gather and the row-parallel bias division
        happen inside the differentiated step
        (``runtime/engine.py``), not here."""
        view = self.tp_serving_view(model_shards, tp_axis, None)
        view._tp_exact_bwd = view._tp_axis is not None
        return view

    def _red(self, u: torch.Tensor) -> torch.Tensor:
        """Where shard-local partial outputs rejoin the replicated stream:
        an all-reduce over the model axis (``reduce_from`` in training);
        the identity without one."""
        if self._tp_axis is None:
            return u
        if self._tp_exact_bwd:
            return reduce_from(u, self._tp_axis)
        return comm.all_reduce(u, comm.ReduceOp.SUM, self._tp_axis)

    def _fin(self, u: torch.Tensor) -> torch.Tensor:
        """Where the replicated stream enters shard-local compute:
        ``copy_to`` in training, the identity otherwise."""
        return copy_to(u, self._tp_axis) if self._tp_exact_bwd else u

    # TP rules keyed on the trailing (module, weight) path pair, for the
    # weight's own dims; leading stack axes are prepended
    _SUFFIX_RULES = {
        ("embed", "embedding"): ("model", None),
        ("pos_embed", "embedding"): (None, None),
        ("qkv", "kernel"): (None, "model"),
        ("qkv", "bias"): ("model",),
        ("out", "kernel"): ("model", None),
        ("out", "bias"): (None,),
        ("fc_in", "kernel"): (None, "model"),
        ("fc_in", "bias"): ("model",),
        ("fc_gate", "kernel"): (None, "model"),
        ("fc_gate", "bias"): ("model",),
        ("fc_out", "kernel"): ("model", None),
        ("fc_out", "bias"): (None,),
        ("lm_head", "kernel"): (None, "model"),
        ("type_embed", "embedding"): (None, None),
        ("dense", "kernel"): (None, None),     # mlm_head transform
        ("dense", "bias"): (None,),
        ("mlm_head", "bias"): (None,),
    }

    def partition_specs(self, params=None) -> Dict:
        """Params-shaped tree of specs (tuples of None / ``"model"``, one
        entry a dim): the Megatron column/row split over the ``model``
        axis, as the JAX model's ``partition_specs``; norms replicate,
        the leading layer axis of ``blocks`` leaves is never sharded.
        ``params`` (any tree of shapes or tensors) defaults to the
        model's own shapes."""
        if self.config.moe_enabled:
            raise NotImplementedError(
                "partition_specs of an MoE model: the MoE layer's specs "
                "are queue A item 7's expert-parallel part")
        tree = self.param_shapes() if params is None else params

        def walk(node, keys):
            if isinstance(node, dict):
                return {k: walk(v, keys + (k,)) for k, v in node.items()}
            ndim = len(tuple(getattr(node, "shape", node)))
            if any(k.startswith("ln") for k in keys):   # norms replicate
                inner = (None,) * (1 if keys[0] != "blocks" else ndim - 1)
            else:
                inner = self._SUFFIX_RULES.get(keys[-2:])
                if inner is None:
                    raise KeyError(f"No partition rule for param {keys}")
            return (None,) * (ndim - len(inner)) + tuple(inner)
        return walk(tree, ())

    # -- parameters ---------------------------------------------------------
    def param_shapes(self, head_bias: bool = False) -> Params:
        """The params tree's leaf shapes (the JAX package's tree: no
        ``pos_embed`` without learned positions, RMSNorm leaves hold
        ``scale`` only, ``mlp.fc_gate`` with a gated MLP, ``lm_head.kernel
        [D, V]`` when untied (and ``lm_head.bias [V]`` with
        ``head_bias``: GPT-J's loader adds it, no init makes it), no
        biases without ``use_bias``, ``ln_f`` only with a final norm,
        ``ln_embed``, ``type_embed`` and ``mlm_head`` when configured;
        with MoE ``blocks`` is ``{"dense": ..., "moe_blk": {..., "moe":
        ...}}`` stacked on ``scan_length``, only ``moe_blk`` at
        ``moe_freq`` 1)."""
        c = self.config
        d, f = c.d_model, c.ff_dim
        hd = c.num_heads * c.hdim

        def norm(*lead):
            p = {"scale": lead + (d,)}
            if c.norm_type == "layernorm":
                p["bias"] = lead + (d,)
            return p

        def block(n, mlp=True):
            def dense(i, o):
                p = {"kernel": (n, i, o)}
                if c.use_bias:
                    p["bias"] = (n, o)
                return p
            blk = {"ln1": norm(n), "ln2": norm(n),
                   "attn": {"qkv": dense(d, c.qkv_dim), "out": dense(hd, d)}}
            if mlp:
                blk["mlp"] = {"fc_in": dense(d, f), "fc_out": dense(f, d)}
                if c.gated_mlp:
                    blk["mlp"]["fc_gate"] = dense(d, f)
            return blk
        tree = {"embed": {"embedding": (c.vocab_size, d)}}
        if c.moe_enabled:
            n, e = c.scan_length, c.moe_num_experts
            fe = c.moe_d_ff or f

            def expert(*lead):
                return {"fc_in": {"kernel": lead + (d, fe),
                                  "bias": lead + (fe,)},
                        "fc_out": {"kernel": lead + (fe, d),
                                   "bias": lead + (d,)}}
            moe = {"gate": {"kernel": (n, d, e)}, "experts": expert(n, e)}
            if c.moe_use_residual:
                moe["residual_mlp"] = expert(n)
                moe["coefficient"] = {"kernel": (n, d, 2), "bias": (n, 2)}
            blocks = {"moe_blk": {**block(n, mlp=False), "moe": moe}}
            if c.moe_freq == 2:
                blocks = {"dense": block(n), **blocks}
            tree["blocks"] = blocks
        else:
            tree["blocks"] = block(c.num_layers)
        if c.final_layernorm:
            tree["ln_f"] = norm()
        if c.pos_embedding == "learned":
            tree["pos_embed"] = {"embedding": (c.max_seq_len, d)}
        if not c.tie_embeddings:
            tree["lm_head"] = {"kernel": (d, c.vocab_size)}
            if head_bias:
                tree["lm_head"]["bias"] = (c.vocab_size,)
        if c.embed_layernorm:
            tree["ln_embed"] = norm()
        if c.token_type_vocab:
            tree["type_embed"] = {"embedding": (c.token_type_vocab, d)}
        if c.mlm_head:
            tree["mlm_head"] = {"dense": {"kernel": (d, d), "bias": (d,)},
                                "ln": norm(), "bias": (c.vocab_size,)}
        return tree

    def init(self, generator: torch.Generator, device=None,
             dtype: Optional[torch.dtype] = None) -> Params:
        """Fresh weights from ``generator`` (the JAX package's init:
        N(0, 0.02), positions N(0, 0.01), residual-branch outputs scaled
        by 1/sqrt(2 L), norm scales 1 and biases 0), drawn one layer at a
        time on ``device`` (default the card; raises without one) in f32
        and stored in ``dtype`` (default ``param_dtype``; an MoE gate
        stays f32, as in the JAX package).  Random numbers differ from
        the JAX init; the leaves only some families have (``ln_embed``,
        ``type_embed``, ``mlm_head``) are drawn last, so the others keep
        their numbers; an MoE model draws its dense superblock part, then
        its MoE blocks' attention, then each layer's MoE leaves."""
        c = self.config
        dtype = dtype or c.param_dtype
        device = resolve_device(device)

        def normal(shape, std):
            return L.normal_init(shape, std, generator, device, dtype)

        def zeros(*shape):
            return torch.zeros(shape, dtype=dtype, device=device)

        def ones(*shape):
            return torch.ones(shape, dtype=dtype, device=device)
        d, f = c.d_model, c.ff_dim
        hd = c.num_heads * c.hdim

        def norm(*lead):
            p = {"scale": ones(*lead, d)}
            if c.norm_type == "layernorm":
                p["bias"] = zeros(*lead, d)
            return p

        def block(n, mlp=True):
            def stacked(shape, std, scaled=False):
                out = torch.empty((n,) + tuple(shape), dtype=dtype,
                                  device=device)
                for i in range(n):
                    out[i] = (L.scaled_init(shape, std, c.num_layers,
                                            generator, device, dtype)
                              if scaled else normal(shape, std))
                return out

            def dense(i, o, scaled=False):
                p = {"kernel": stacked((i, o), 0.02, scaled)}
                if c.use_bias:
                    p["bias"] = zeros(n, o)
                return p
            blk = {
                "ln1": norm(n),
                "attn": {"qkv": dense(d, c.qkv_dim),
                         "out": dense(hd, d, scaled=True)},
                "ln2": norm(n),
            }
            if mlp:
                blk["mlp"] = {"fc_in": dense(d, f),
                              "fc_out": dense(f, d, scaled=True)}
                if c.gated_mlp:
                    blk["mlp"]["fc_gate"] = dense(d, f)
            return blk
        params = {"embed": {"embedding": normal((c.vocab_size, d), 0.02)}}
        if c.pos_embedding == "learned":
            params["pos_embed"] = {"embedding": normal((c.max_seq_len, d),
                                                       0.01)}
        if c.final_layernorm:
            params["ln_f"] = norm()
        if c.moe_enabled:
            n = c.scan_length
            blocks = {"dense": block(n)} if c.moe_freq == 2 else {}
            moe_blk = block(n, mlp=False)
            from ..moe.layer import stack_trees
            moe_blk["moe"] = stack_trees(
                n, lambda: self._moe.init(generator, device, dtype))
            blocks["moe_blk"] = moe_blk
            params["blocks"] = blocks
        else:
            params["blocks"] = block(c.num_layers)
        if not c.tie_embeddings:
            params["lm_head"] = {"kernel": normal((d, c.vocab_size), 0.02)}
        if c.embed_layernorm:
            params["ln_embed"] = norm()
        if c.token_type_vocab:
            params["type_embed"] = {"embedding": normal(
                (c.token_type_vocab, d), 0.02)}
        if c.mlm_head:
            params["mlm_head"] = {
                "dense": {"kernel": normal((d, d), 0.02), "bias": zeros(d)},
                "ln": norm(), "bias": zeros(c.vocab_size)}
        return params

    # -- the streamed pieces (ZeRO-Infinity) ---------------------------------
    def superblock_shapes(self) -> Params:
        """One scan layer's leaf shapes: ``param_shapes()["blocks"]``
        without the leading layer axis."""
        def strip(tree):
            return {k: strip(v) if isinstance(v, dict) else tuple(v[1:])
                    for k, v in tree.items()}
        return strip(self.param_shapes()["blocks"])

    def resident_shapes(self) -> Params:
        """The leaf shapes of everything outside the scanned blocks."""
        return {k: v for k, v in self.param_shapes().items()
                if k != "blocks"}

    def superblock_keys(self, seed: int) -> List[int]:
        """The per-layer seeds of a streamed init from ``seed``: layer i is
        ``init_superblock`` from a generator seeded with ``keys[i]``."""
        g = torch.Generator()
        g.manual_seed(int(seed))
        return torch.randint(0, 2**62, (self.config.scan_length,),
                             generator=g, dtype=torch.int64).tolist()

    def init_superblock(self, generator: torch.Generator, device=None,
                        dtype: Optional[torch.dtype] = None) -> Params:
        """One scan layer's params (no leading axis), drawn from
        ``generator`` as :meth:`init` draws the stack: N(0, 0.02),
        residual-branch outputs scaled by 1/sqrt(2 L), norm scales 1,
        biases 0, an MoE layer's gate in float32.  The streamed init draws
        each layer from its own seed (:meth:`superblock_keys`), so its
        numbers differ from :meth:`init`'s, which draws leaf by leaf
        across the layers."""
        c = self.config
        dtype = dtype or c.param_dtype
        device = resolve_device(device)
        d, f = c.d_model, c.ff_dim
        hd = c.num_heads * c.hdim

        def norm():
            p = {"scale": torch.ones(d, dtype=dtype, device=device)}
            if c.norm_type == "layernorm":
                p["bias"] = torch.zeros(d, dtype=dtype, device=device)
            return p

        def dense(i, o, scaled=False):
            w = (L.scaled_init((i, o), 0.02, c.num_layers, generator, device,
                               dtype) if scaled else
                 L.normal_init((i, o), 0.02, generator, device, dtype))
            p = {"kernel": w}
            if c.use_bias:
                p["bias"] = torch.zeros(o, dtype=dtype, device=device)
            return p

        def block(mlp=True):
            blk = {"ln1": norm(),
                   "attn": {"qkv": dense(d, c.qkv_dim),
                            "out": dense(hd, d, scaled=True)},
                   "ln2": norm()}
            if mlp:
                blk["mlp"] = {"fc_in": dense(d, f),
                              "fc_out": dense(f, d, scaled=True)}
                if c.gated_mlp:
                    blk["mlp"]["fc_gate"] = dense(d, f)
            return blk
        if not c.moe_enabled:
            return block()
        moe_blk = block(mlp=False)
        moe_blk["moe"] = self._moe.init(generator, device, dtype)
        out = {"moe_blk": moe_blk}
        if c.moe_freq == 2:
            out = {"dense": block(), **out}
        return out

    def init_resident(self, generator: torch.Generator, device=None,
                      dtype: Optional[torch.dtype] = None) -> Params:
        """Everything outside the scanned blocks (embeddings, final norm,
        untied head, the families' extra leaves), drawn as :meth:`init`
        draws them: the params a streamed path keeps on the device."""
        c = self.config
        dtype = dtype or c.param_dtype
        device = resolve_device(device)
        d = c.d_model

        def normal(shape, std):
            return L.normal_init(shape, std, generator, device, dtype)

        def norm():
            p = {"scale": torch.ones(d, dtype=dtype, device=device)}
            if c.norm_type == "layernorm":
                p["bias"] = torch.zeros(d, dtype=dtype, device=device)
            return p
        params = {"embed": {"embedding": normal((c.vocab_size, d), 0.02)}}
        if c.pos_embedding == "learned":
            params["pos_embed"] = {"embedding": normal((c.max_seq_len, d),
                                                       0.01)}
        if c.final_layernorm:
            params["ln_f"] = norm()
        if not c.tie_embeddings:
            params["lm_head"] = {"kernel": normal((d, c.vocab_size), 0.02)}
        if c.embed_layernorm:
            params["ln_embed"] = norm()
        if c.token_type_vocab:
            params["type_embed"] = {"embedding": normal(
                (c.token_type_vocab, d), 0.02)}
        if c.mlm_head:
            params["mlm_head"] = {
                "dense": {"kernel": normal((d, d), 0.02),
                          "bias": torch.zeros(d, dtype=dtype, device=device)},
                "ln": norm(),
                "bias": torch.zeros(c.vocab_size, dtype=dtype,
                                    device=device)}
        return params

    def init_streamed(self, seed: int, device=None,
                      dtype: Optional[torch.dtype] = None) -> Params:
        """The whole tree of a streamed init from ``seed`` (the resident
        leaves from a generator seeded with ``seed``, layer i from
        ``superblock_keys(seed)[i]``), stacked: what ZeRO-Infinity's
        host stores hold after its init, for tests and export."""
        device = resolve_device(device)

        def gen(s):
            g = torch.Generator(device=device)
            g.manual_seed(int(s))
            return g
        params = self.init_resident(gen(seed), device, dtype)
        layers = [self.init_superblock(gen(k), device, dtype)
                  for k in self.superblock_keys(seed)]

        def stack(trees):
            if isinstance(trees[0], dict):
                return {k: stack([t[k] for t in trees]) for k in trees[0]}
            return torch.stack(trees)
        params["blocks"] = stack(layers)
        return params

    def superblock_apply(self, sp: Params, x: torch.Tensor,
                         train: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One scan unit over one layer's params ``sp`` (no layer index,
        so no per-layer window; an MoE layer routes without noise):
        ``(y, l_aux)``, l_aux a float32 scalar (0 without MoE)."""
        c = self.config
        sp = self.block_transform(sp)
        if not c.moe_enabled:
            return (self._block(sp, x, self._attend_full),
                    torch.zeros((), dtype=torch.float32, device=x.device))
        r = None
        for kind, bp in self._units(sp):
            if kind == "moe":
                x, r = self._moe_block(bp, x, self._attend_full, None, None,
                                       train)
            else:
                x = self._block(bp, x, self._attend_full)
        return x, r.l_aux.to(torch.float32)

    def stage_apply(self, blocks: Params, x: torch.Tensor,
                    windows: Optional[List[Optional[int]]] = None,
                    train: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """A run of stacked superblocks ``blocks`` (leaves ``[n, ...]``:
        the whole model's, or a pipeline stage's slice) over ``x``, each
        a remat unit: ``(y, l_aux)``, l_aux summed over the MoE layers
        (0 without MoE).  ``windows``: each layer's attention window
        (the stage's slice of ``_layer_windows``); an MoE layer routes
        without noise."""
        laux = torch.zeros((), dtype=torch.float32, device=x.device)
        if not self.config.moe_enabled:
            block = self._remat(lambda bp, x, window: self._block(
                self.block_transform(bp), x,
                functools.partial(self._attend_full, window=window)))
            views = layer_views(blocks)
            for bp, window in zip(views, windows or [None] * len(views)):
                x = block(bp, x, window)
            return x, laux
        sb = self._remat(lambda sp, x: self.superblock_apply(sp, x, train))
        for sp in layer_views(blocks):
            x, la = sb(sp, x)
            laux = laux + la
        return x, laux

    # -- pieces ---------------------------------------------------------------
    def _norm(self, p: Params, x: torch.Tensor) -> torch.Tensor:
        norm = (L.layernorm_apply if self.config.norm_type == "layernorm"
                else L.rmsnorm_apply)
        return norm(p, x, eps=self.config.layernorm_eps)

    def _embed(self, params: Params, ids: torch.Tensor,
               positions: torch.Tensor,
               token_type_ids: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
        """Word (+ position, + token-type) embeddings, then the embedding
        layernorm when configured (BLOOM, BERT)."""
        c = self.config
        if self._tp_axis is not None:
            # the vocab-sharded table [V / mp, D]: each shard looks up
            # the ids it owns, zeroes the rest, and one reduction over
            # the model axis rebuilds the word embedding; the position
            # and type tables and the embedding norm come after it
            vloc = params["embed"]["embedding"].shape[0]
            local = ids - comm.axis_index(self._tp_axis) * vloc
            mine = (local >= 0) & (local < vloc)
            x = L.embedding_apply(params["embed"],
                                  torch.where(mine, local, 0), c.dtype)
            x = self._red(torch.where(mine[..., None], x,
                                      torch.zeros((), dtype=x.dtype,
                                                  device=x.device)))
        else:
            x = L.embedding_apply(params["embed"], ids, c.dtype)
        if c.pos_embedding == "learned":
            x = x + L.embedding_apply(params["pos_embed"], positions, c.dtype)
        if c.token_type_vocab:
            tt = (torch.zeros_like(ids) if token_type_ids is None
                  else token_type_ids.to(ids.device, torch.int64))
            x = x + L.embedding_apply(params["type_embed"], tt, c.dtype)
        if c.embed_layernorm:
            x = self._norm(params["ln_embed"], x)
        return x

    def _final_norm(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return (self._norm(params["ln_f"], x) if self.config.final_layernorm
                else x)

    @property
    def _attn_scale(self) -> Optional[float]:
        return self.config.attn_softmax_scale or None

    def _layer_windows(self) -> List[Optional[int]]:
        """Each layer's attention window: ``local_attention_window`` on
        a "local" layer of ``attention_layers``, else None (every key;
        the JAX model's ``_GLOBAL_WINDOW`` masks nothing either)."""
        c = self.config
        if not c.attention_layers:
            return [None] * c.num_layers
        return [c.local_attention_window if a == "local" else None
                for a in c.attention_layers]

    def _plain_attention(self, q, k, v, offset: int = 0,
                         window: Optional[int] = None,
                         mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
        """Plain attention of queries at positions ``offset .. offset +
        Tq - 1`` over keys 0 .. Tk - 1 with the model's causality and
        softmax scale, the ALiBi bias at those positions, the layer's
        ``window`` (a key ``window`` or more positions back is hidden)
        and ``mask`` on top."""
        c = self.config
        tq, tk = q.shape[1], k.shape[1]
        qpos = offset + torch.arange(tq, device=q.device)
        bias = None
        if c.pos_embedding == "alibi":
            bias = L.alibi_bias(c.num_heads, tk, qpos,
                                slopes=self._alibi_slopes())[None]
        if window is not None:
            band = (qpos[:, None] - torch.arange(tk, device=q.device)
                    [None, :]) < window
            mask = band if mask is None else mask & band
        return L.gqa_attention(q, k, v, mask=mask, scale=self._attn_scale,
                               kv_positions_offset=offset, causal=c.causal,
                               bias=bias)

    def _alibi_slopes(self) -> torch.Tensor:
        """This shard's ALiBi slopes: its heads' slice of the whole
        model's (a shard's own head count would give other slopes)."""
        c = self.config
        if self._tp_axis is None:
            return L.alibi_slopes(c.num_heads)
        lo = comm.axis_index(self._tp_axis) * c.num_heads
        return L.alibi_slopes(self._tp_full_heads)[lo:lo + c.num_heads]

    def _rotary_tables(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """f32 (cos, sin) ``[max_seq_len, rotary_dim / 2]`` on ``device``,
        computed on the CPU once and copied, so every device sees the
        same bits."""
        tables = self._rotary.get(device)
        if tables is None:
            c = self.config
            cos, sin = L.rotary_freqs(c.rotary_dim, c.max_seq_len,
                                      c.rotary_base)
            tables = self._rotary[device] = (cos.to(device), sin.to(device))
        return tables

    def _qkv(self, p: Params, h: torch.Tensor,
             positions: Optional[torch.Tensor] = None):
        """q ``[B, T, H, D]`` and k, v ``[B, T, KVH, D]`` from the fused
        projection (q | k | v along its output), rotary applied at
        ``positions`` (``[B|1, T]``; None = 0 .. T-1)."""
        c = self.config
        nh, nkv, hd = c.num_heads, c.kv_heads, c.hdim
        qkv = L.dense_apply(p["qkv"], h)
        b, t = qkv.shape[0], qkv.shape[1]
        q = qkv[..., :nh * hd].reshape(b, t, nh, hd)
        k = qkv[..., nh * hd:(nh + nkv) * hd].reshape(b, t, nkv, hd)
        v = qkv[..., (nh + nkv) * hd:].reshape(b, t, nkv, hd)
        if c.pos_embedding == "rotary":
            cos, sin = self._rotary_tables(qkv.device)
            q = L.apply_rotary(q, cos, sin, positions,
                               interleaved=c.rotary_interleaved)
            k = L.apply_rotary(k, cos, sin, positions,
                               interleaved=c.rotary_interleaved)
        return q, k, v

    def _mlp(self, p: Params, x: torch.Tensor) -> torch.Tensor:
        act = L.ACT_FNS[self.config.activation]
        if self.config.gated_mlp:
            g = act(L.dense_apply(p["fc_gate"], x))
            return L.dense_apply(p["fc_out"],
                                 g * L.dense_apply(p["fc_in"], x))
        return L.dense_apply(p["fc_out"], act(L.dense_apply(p["fc_in"], x)))

    def _block(self, bp: Params, x: torch.Tensor, attend,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One block: pre-norm with a serial residual, pre-norm with a
        parallel one (NeoX, GPT-J), or post-norm (BERT); ``attend(q, k,
        v)`` returns ``[.., T, H*D]`` attention output for this layer."""
        c = self.config
        red, fin = self._red, self._fin

        def attn(h):
            q, k, v = self._qkv(bp["attn"], h, positions)
            return L.dense_apply(bp["attn"]["out"], attend(q, k, v))
        if c.norm_position == "post":
            x = self._norm(bp["ln1"], x + red(attn(fin(x))))
            return self._norm(bp["ln2"],
                              x + red(self._mlp(bp["mlp"], fin(x))))
        if c.parallel_residual:
            a = attn(fin(self._norm(bp["ln1"], x)))
            return x + red(a + self._mlp(bp["mlp"],
                                         fin(self._norm(bp["ln2"], x))))
        x = x + red(attn(fin(self._norm(bp["ln1"], x))))
        return x + red(self._mlp(bp["mlp"], fin(self._norm(bp["ln2"], x))))

    def _moe_block(self, bp: Params, x: torch.Tensor, attend,
                   positions: Optional[torch.Tensor], noise, train: bool):
        """Attention and the MoE FFN (pre-norm, serial or parallel
        residual, as the JAX model's ``_moe_block``) → ``(x, Routing)``;
        ``noise`` is the layer's :class:`GateNoise`, drawn by the
        caller."""
        def attn(h):
            q, k, v = self._qkv(bp["attn"], h, positions)
            return L.dense_apply(bp["attn"]["out"], attend(q, k, v))

        def moe(h):
            return self._moe.apply_routed(bp["moe"], h, train=train,
                                          noise=noise)
        if self.config.parallel_residual:
            a = attn(self._norm(bp["ln1"], x))
            m, r = moe(self._norm(bp["ln2"], x))
            return x + a + m, r
        x = x + attn(self._norm(bp["ln1"], x))
        m, r = moe(self._norm(bp["ln2"], x))
        return x + m, r

    def _units(self, sp: Params) -> List[Tuple[str, Params]]:
        """The attention layers of one superblock view, in order:
        ``("dense", block)`` or ``("moe", block)``."""
        c = self.config
        if not c.moe_enabled:
            return [("dense", sp)]
        units = [("moe", sp["moe_blk"])]
        return [("dense", sp["dense"])] + units if c.moe_freq == 2 else units

    def _project(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """f32 logits from operands in x's dtype: the MLM head (dense,
        act, LN, the tied decoder, the vocab bias), the tied embedding,
        or the untied ``lm_head`` (plus its f32 bias when it has one)."""
        c = self.config
        if c.mlm_head:
            mh = params["mlm_head"]
            h = L.ACT_FNS[c.activation](L.dense_apply(mh["dense"], x))
            logits = L.embedding_attend(params["embed"],
                                        self._norm(mh["ln"], h))
            return logits + mh["bias"].float()
        logits = self._project_local(params, x)
        if self._tp_axis is not None:
            # the vocab-sharded head's local [.., V / mp] logits tile
            # back into the whole vocab: shard order is vocab order, so
            # every shard holds the same bits and samples the same token
            logits = comm.all_gather(logits, self._tp_axis, axis=-1)
        return logits

    def _project_local(self, params: Params, x: torch.Tensor
                       ) -> torch.Tensor:
        """f32 logits of the tied embedding or the untied ``lm_head``
        over the vocab rows this shard holds (all of them without a
        model axis)."""
        if self.config.tie_embeddings:
            return L.embedding_attend(params["embed"], x)
        logits = L.f32_product(x, params["lm_head"]["kernel"])
        if "bias" in params["lm_head"]:
            logits = logits + params["lm_head"]["bias"].float()
        return logits

    # -- full forward and dense-cache decode ------------------------------
    def apply(self, params: Params, input_ids: torch.Tensor,
              cache: Optional[Dict[str, Any]] = None,
              token_type_ids: Optional[torch.Tensor] = None):
        """input_ids ``[B, T]`` (and an encoder's ``token_type_ids``,
        default 0) → f32 logits ``[B, T, V]``; with ``cache`` (from
        :meth:`init_cache`) returns ``(logits, cache)`` after writing the
        T new rows at ``cache["index"]`` in place."""
        c = self.config
        b, t = input_ids.shape
        if cache is None:
            # inference semantics: eval capacity factor, no gate noise
            return self._project(params, self.hidden_states(
                params, input_ids, token_type_ids, train=False))
        if not c.causal:
            raise NotImplementedError(ENCODER_DECODE)
        idx = int(cache["index"])
        if idx + t > cache["k"].shape[2]:
            raise ValueError(f"cache holds {cache['k'].shape[2]} rows, "
                             f"writing {t} at {idx}")
        pos = idx + torch.arange(t, device=input_ids.device)[None]
        x = self._embed(params, input_ids, pos)
        sparse = None
        if c.attn_impl == "blocksparse":
            sparse = self._sparse_mask(idx, t, cache["k"].shape[2],
                                       input_ids.device)[..., :idx + t]
        windows = self._layer_windows()
        stats = []
        i = 0
        for sp in layer_views(params["blocks"]):
            for kind, bp in self._units(self.block_transform(sp)):
                ck, cv = cache["k"][i], cache["v"][i]

                def attend(q, k, v, ck=ck, cv=cv, window=windows[i]):
                    ck[:, idx:idx + t] = k
                    cv[:, idx:idx + t] = v
                    if (t == 1 and c.attn_impl == "flash"
                            and c.pos_embedding != "alibi"):
                        # token-at-a-time hot path: kernel B5 over the
                        # cache at kv-head width (query head h reads kv
                        # head h // g; the JAX model expands the cache with
                        # `expand_kv` first, which gives the same result)
                        o = decode_attention(q[:, 0].contiguous(), ck, cv,
                                             idx + 1)
                        return o.reshape(b, 1, -1)
                    # plain attention: the layout the model trained with
                    # at the query positions (block-sparse), ALiBi, the
                    # layer's window (the JAX model's dense-cache path)
                    o = self._plain_attention(q, ck[:, :idx + t],
                                              cv[:, :idx + t], idx, window,
                                              sparse)
                    return o.reshape(b, t, -1)
                if kind == "moe":
                    # inference routing: eval capacity, no noise, no RTS
                    x, r = self._moe_block(bp, x, attend, pos, None, False)
                    stats.append((r.exp_counts, r.kept.sum(), r.capacity))
                else:
                    x = self._block(bp, x, attend, pos)
                i += 1
        self.moe_stats = stats
        logits = self._project(params, self._final_norm(params, x))
        return logits, {"k": cache["k"], "v": cache["v"], "index": idx + t}

    forward = apply

    # -- training ----------------------------------------------------------
    def _remat(self, fn):
        """Wrap a block function with the configured remat policy:
        "full" keeps only the block's input and recomputes the rest in
        the backward, "host_offload" the same with that input in pinned
        host memory; "dots_saveable" also keeps every matrix product's
        output, "dots_no_batch" those with no batch dimension (the dense
        layers', not attention's), "nothing_saveable" none of them
        (``torch.utils.checkpoint``'s selective contexts)."""
        remat = self.config.remat
        if remat == "none":
            return fn
        if remat == "host_offload":
            return functools.partial(host_offload_checkpoint, fn)
        policy = REMAT_POLICIES[remat]
        kw = {} if policy is None else {"context_fn": functools.partial(
            create_selective_checkpoint_contexts, policy)}

        def wrapped(*args):
            # the blocks draw no random numbers (an MoE layer's routing
            # noise is drawn outside and passed in): no RNG state to
            # replay, and the recomputed forward routes the same tokens
            return checkpoint(fn, *args, use_reentrant=False,
                              preserve_rng_state=False, **kw)
        return wrapped

    def _attend_full(self, q, k, v, window: Optional[int] = None):
        """Self-attention over a whole sequence (causal, or full on an
        encoder), q ``[B, T, H, D]`` and k/v ``[B, T, KVH, D]`` → ``[B, T,
        H*D]``: kernels B1 and B2 (or B3/B4) with ``flash`` (but for
        ALiBi, which takes plain attention as in the JAX model), B8 and
        B9/B10 with ``blocksparse`` (plain attention masked by the layout
        when T does not divide by its block), plain attention with
        ``xla`` (ALiBi, the layer's ``window``, the softmax scale)."""
        c = self.config
        b, t = q.shape[0], q.shape[1]
        if c.attn_impl == "flash" and c.pos_embedding != "alibi":
            o = flash_attention_bthd(q, k, v, causal=c.causal)
        elif c.attn_impl == "blocksparse":
            scfg = self._sparsity_config()
            if t % scfg.block == 0:
                # the kernels take one kv head per query head (the JAX
                # model's expand_kv)
                g = c.num_heads // c.kv_heads
                if g > 1:
                    k = k.repeat_interleave(g, dim=2)
                    v = v.repeat_interleave(g, dim=2)
                o = blocksparse_attention_bthd(q, k, v, scfg)
            else:
                o = L.gqa_attention(q, k, v, causal=c.causal,
                                    mask=self._sparse_mask(0, t, t, q.device))
        else:
            o = self._plain_attention(q, k, v, 0, window)
        return o.reshape(b, t, -1)

    def _sparsity_config(self):
        scfg = self.config.sparsity_config
        if scfg is None:
            raise ValueError(
                "attn_impl='blocksparse' needs sparsity_config (an "
                "ops.sparse_attention.SparsityConfig instance) on the "
                "TransformerConfig")
        return scfg

    def _sparse_mask(self, idx: int, t: int, tk: int, device
                     ) -> torch.Tensor:
        """Bool mask of queries ``idx .. idx + t - 1`` over ``tk`` keys,
        ``[1, KVH|1, g|1, t, tk]`` for :func:`layers.gqa_attention`: the
        layout's block rows at the query positions, so the dense cache
        applies the pattern the model trained with.  The layout is built
        at the training context (``max_seq_len``), since a stochastic
        layout (BigBird's random blocks) depends on the block count; a
        cache past it raises, as in the JAX model."""
        c = self.config
        blk = self._sparsity_config().block
        nbk = -(-tk // blk)
        nb_train = c.max_seq_len // blk
        if nbk > nb_train:
            raise NotImplementedError(
                f"blocksparse decode cache ({tk} tokens) exceeds the "
                f"training context ({c.max_seq_len}) — the layout beyond "
                f"it is undefined; cap max_out_tokens at max_seq_len")
        layout = self._layout.get(device)
        if layout is None:
            lay = np.asarray(c.sparsity_config.make_layout(nb_train * blk),
                             bool)
            if lay.ndim == 2:
                lay = lay[None]                           # [1|H, nb, nb]
            layout = self._layout[device] = torch.from_numpy(
                np.ascontiguousarray(lay)).to(device)
        qpos = idx + torch.arange(t, device=device)
        rows = layout[:, qpos // blk, :nbk]                # [1|H, t, nbk]
        mask = rows.repeat_interleave(blk, dim=-1)[..., :tk]
        if mask.shape[0] == 1:
            return mask[None, :, None]
        return mask.reshape(1, c.kv_heads, c.num_heads // c.kv_heads, t, tk)

    def hidden_states(self, params: Params, input_ids: torch.Tensor,
                      token_type_ids: Optional[torch.Tensor] = None,
                      train: bool = True) -> torch.Tensor:
        """Forward up to the final norm (when the model has one),
        pre-projection: ``[B, T, D]``."""
        return self.hidden_states_and_aux(params, input_ids,
                                          token_type_ids=token_type_ids,
                                          train=train)[0]

    def hidden_states_and_aux(self, params: Params, input_ids: torch.Tensor,
                              generator: Optional[torch.Generator] = None,
                              train: bool = True,
                              token_type_ids: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Forward up to the final norm → ``([B, T, D], l_aux)``: l_aux
        summed over the MoE layers (0 without MoE).  ``train`` routes
        with the training capacity factor and, with ``generator``, the
        noise policy and RTS; each MoE layer's noise is drawn from
        ``generator`` before its superblock runs, outside the remat
        function.  Each remat unit is one superblock, as in the JAX
        model's scan."""
        c = self.config
        b, t = input_ids.shape
        pos = torch.arange(t, device=input_ids.device)[None]
        x = self._embed(params, input_ids, pos, token_type_ids)
        laux = torch.zeros((), dtype=torch.float32, device=x.device)
        if not c.moe_enabled:
            x, _ = self.stage_apply(params["blocks"], x,
                                    self._layer_windows())
            self.moe_stats = []
            return self._final_norm(params, x), laux

        def superblock(sp, x, noise):
            for kind, bp in self._units(self.block_transform(sp)):
                if kind == "moe":      # one MoE layer a superblock
                    x, r = self._moe_block(bp, x, self._attend_full, None,
                                           noise, train)
                else:
                    x = self._block(bp, x, self._attend_full)
            return x, r.l_aux, r.exp_counts, r.kept.sum(), r.capacity
        sb = self._remat(superblock)
        stats = []
        for sp in layer_views(params["blocks"]):
            noise = self._moe.draw_noise(generator, b * t, train)
            x, la, counts, kept, cap = sb(sp, x, noise)
            laux = laux + la
            stats.append((counts.detach(), kept.detach(), cap))
        self.moe_stats = stats
        return self._final_norm(params, x), laux

    def loss(self, params: Params, batch: Dict[str, Any]) -> torch.Tensor:
        """Causal LM loss.  ``batch``: {"input_ids" [B, T]} (labels are
        the ids shifted left, the last position masked out) or explicit
        {"input_ids", "labels", optional "loss_mask"}; with MoE the NLL
        plus ``moe_aux_loss_coef`` times the summed l_aux, routed in
        train mode, with the noise of ``batch["moe_rng"]`` (a seed or a
        ``torch.Generator``; the engine gives each micro batch its own
        seed) when given."""
        ids = batch["input_ids"]
        mask = batch.get("loss_mask")
        if "labels" in batch:
            labels = batch["labels"]
        else:
            # keep the full T through the model and mask the final
            # position instead of slicing it off
            labels = torch.cat([ids[:, 1:], torch.zeros_like(ids[:, :1])],
                               dim=1)
            last = torch.ones(ids.shape, dtype=torch.float32,
                              device=ids.device)
            last[:, -1] = 0.0
            mask = last if mask is None else mask * last
        x, laux = self.hidden_states_and_aux(
            params, ids, generator=moe_generator(batch.get("moe_rng"),
                                                 ids.device))
        nll = self.nll_from_hidden(params, x, labels, mask)
        if self.config.moe_enabled:
            return nll + self.config.moe_aux_loss_coef * laux
        return nll

    def nll_from_hidden(self, params: Params, x: torch.Tensor,
                        labels: torch.Tensor,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Mean masked NLL from final hidden states ``[B, T, D]``: the
        loss head alone (fused, chunked with remat, or dense; never fused
        for the MLM head, whose transform sits before the decoder, as in
        the JAX model).  Under a model axis (training) the fused head is
        off, as in the JAX model, and the loss is the vocab-parallel
        cross-entropy over the local ``[.., V / mp]`` logits
        (``masked_nll_sum``)."""
        c = self.config
        chunk = c.loss_chunk
        b, t = labels.shape
        if c.fused_loss_head and not c.mlm_head and self._tp_axis is None:
            if c.tie_embeddings:
                w, bias, tw = params["embed"]["embedding"], None, True
            else:
                w = params["lm_head"]["kernel"]
                bias = params["lm_head"].get("bias")
                tw = False
            rows = b * t
            # chunk in whole token columns, like the checkpointed path
            row_chunk = b * chunk if (chunk and t > chunk
                                      and t % chunk == 0) else 0
            tot, cnt = fused_linear_xent(
                x.reshape(rows, x.shape[-1]), w, labels.reshape(rows),
                None if mask is None else mask.reshape(rows), bias=bias,
                transpose_w=tw, chunk=row_chunk)
            return tot / torch.clamp(cnt, min=1.0)
        if not (chunk and t > chunk and t % chunk == 0):
            chunk = t
        mc = (mask.to(torch.float32) if mask is not None else
              torch.ones(labels.shape, dtype=torch.float32,
                         device=labels.device))
        if self._tp_axis is not None:
            tot = masked_nll_sum(
                lambda xc: self._project_local(params, self._fin(xc)), x,
                labels, mc, chunk, self._tp_axis)
        else:
            tot = masked_nll_sum(lambda xc: self._project(params, xc), x,
                                 labels, mc, chunk)
        return tot / torch.clamp(mc.sum(), min=1.0)

    def init_cache(self, batch: int, max_len: int,
                   dtype: Optional[torch.dtype] = None,
                   device=None) -> Dict[str, Any]:
        """Dense KV cache ``[L, B, max_len, kv_heads, head_dim]`` on
        ``device`` (default the card; raises without one)."""
        c = self.config
        shape = (c.num_layers, batch, max_len, c.kv_heads, c.hdim)
        dtype = dtype or c.dtype
        device = resolve_device(device)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device),
                "index": 0}

    # -- paged serving state -------------------------------------------------
    def _paged_supported(self, kv_bits: int = 0) -> Optional[str]:
        """None when the paged decode path serves this config with a pool
        of ``kv_bits``, else the reason it cannot: the JAX model's rule,
        then the gate of the kernels that path runs (B5, B6, B7:
        ``build.kernel_supports`` at the model's dtype and kv group), so a
        server is never built at a shape its kernels refuse."""
        c = self.config
        if not c.causal:
            return "paged decode needs a causal (decoder) model"
        if c.moe_num_experts > 0:
            return "paged decode does not cover MoE block stacks yet"
        if c.attention_layers:
            return ("paged decode does not apply per-layer local windows "
                    "(GPT-Neo family)")
        if c.pos_embedding == "alibi":
            return "paged decode does not carry the ALiBi bias yet"
        if c.hdim % 8:
            return f"head_dim {c.hdim} is not lane-aligned (multiple of 8)"
        if c.attn_impl == "blocksparse":
            # the JAX model's rule lets this through and its paged kernels
            # then attend densely: a silent change of semantics
            return ("paged decode does not apply the block-sparse layout "
                    "(attn_impl='blocksparse'); generate() serves it on "
                    "the dense cache")
        g = c.num_heads // c.kv_heads
        for name in ("decode_attention", "paged_decode_attention",
                     "paged_prefill_attention"):
            why = build.kernel_supports(
                name, c.hdim, g, c.dtype,
                0 if name == "decode_attention" else kv_bits)
            if why is not None:
                return why
        return None

    def init_paged_cache(self, num_blocks: int, block_size: int,
                         dtype: Optional[torch.dtype] = None,
                         kv_bits: int = 0, device=None) -> Dict[str, Any]:
        """Per-layer paged KV pools ``[L, num_blocks, block_size, kv_heads,
        head_dim]`` on ``device`` (default the card; raises without one).
        Block 0 is the allocator's reserved null block.  ``kv_bits`` 8 or 4
        stores the pools compressed: int8 at head_dim (8-bit) or packed
        nibbles at head_dim / 2 (4-bit), with per-row per-head f32 scales
        ``k_scale``/``v_scale`` ``[L, num_blocks, block_size, kv_heads]``
        that the attention kernels fold into their loads."""
        c = self.config
        if kv_bits not in (0, 4, 8):
            raise ValueError(f"kv_bits must be 0, 4 or 8, got {kv_bits}")
        if kv_bits == 4 and c.hdim % 2:
            raise ValueError(
                f"packed int4 KV needs an even head_dim, got {c.hdim}")
        dtype = dtype or c.dtype
        device = resolve_device(device)
        if kv_bits:
            d_eff = c.hdim if kv_bits == 8 else c.hdim // 2
            shape = (c.num_layers, num_blocks, block_size, c.kv_heads,
                     d_eff)
            zeros = torch.zeros(shape[:-1], dtype=torch.float32,
                                device=device)
            return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                    "v": torch.zeros(shape, dtype=torch.int8, device=device),
                    "k_scale": zeros, "v_scale": zeros.clone()}
        shape = (c.num_layers, num_blocks, block_size, c.kv_heads, c.hdim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    @staticmethod
    def _paged_kv_bits(pool_k: torch.Tensor,
                       k_scale: Optional[torch.Tensor], hd: int) -> int:
        """The pool's kv-cache width from its shape: 0 when unquantized,
        else 8 (int8 at full head_dim) or 4 (packed nibbles at head_dim /
        2)."""
        if k_scale is None:
            return 0
        return 8 if pool_k.shape[-1] == hd else 4

    def _apply_paged_mixed(self, params: Params, cache: Dict[str, Any],
                           dec_tokens: torch.Tensor,
                           dec_active: torch.Tensor,
                           chunk_ids: torch.Tensor, chunk_slot: int,
                           chunk_start: int, chunk_len: int,
                           spec_tokens: Optional[torch.Tensor] = None,
                           spec_active: Optional[torch.Tensor] = None):
        """Mixed continuous-batching step: one decode token per slot
        (``dec_tokens``/``dec_active`` ``[B]`` int32, or ``[0]``: no
        decode lane) plus ``chunk_ids`` ``[C]`` of one slot's prompt at
        rows ``chunk_start ..`` (C may be 0: no chunk; ids past
        ``chunk_len`` are padding), plus, with ``spec_tokens`` ``[B, S]``,
        a speculative verify run per slot (Leviathan et al.): row b holds
        the slot's last emitted token then draft proposals d_1..d_{S-1},
        fed at positions ``lens[b] .. lens[b] + S - 1``; ``spec_active``
        ``[B]`` selects the verifying slots (their ``dec_active`` is 0).

        ``cache``: {"k"/"v": pools, "block_tables": ``[S, pages]`` int32,
        "lens": ``[S]`` int32 rows already in the pool, and with a
        quantized pool "k_scale"/"v_scale"} for all S slots.  Every new
        k/v row is scattered into the pools in place in one combined write
        per layer (decode rows at ``table[len // blk]``, spec row i of slot
        b at position ``lens[b] + i`` with its page clamped to the table,
        chunk rows at ``base + i`` of the chunk slot's table, inactive and
        padded rows to the null block 0), encoded with ``kv_quantize`` into
        values and scales when the pool is quantized; then kernel B6
        attends for the decode slots, B6 once per spec depth i with
        lengths ``where(spec_active, lens + i + 1, 0)`` (the causality
        between draft rows), and kernel B7 for the chunk.  A lane of width
        0 runs no kernel, so without ``spec_tokens`` the step launches
        exactly what it did before the spec lane.  Returns ``(dec_logits
        [B, V], chunk_logits [V] at the chunk's last valid row or None
        when C is 0, cache with the new lens)``, with ``spec_logits [B, S,
        V]`` inserted after ``dec_logits`` when the spec lane runs (the
        caller advances lens past accepted spec rows; rejected rows are
        never attended and are rewritten before they can be)."""
        c = self.config
        pool_k, pool_v = cache["k"], cache["v"]
        pool_ks, pool_vs = cache.get("k_scale"), cache.get("v_scale")
        kv_bits = self._paged_kv_bits(pool_k, pool_ks, c.hdim)
        tables, lens = cache["block_tables"], cache["lens"]
        dev = dec_tokens.device
        bsl, nc = dec_tokens.shape[0], chunk_ids.shape[0]
        nsp, sw = (0, 0) if spec_tokens is None else spec_tokens.shape
        nb, blk = pool_k.shape[1], pool_k.shape[2]
        npages = tables.shape[1]
        dp = self._dp_axis
        if dp is not None and sw:
            raise NotImplementedError(
                "the speculative lane over data-sharded decode slots "
                "(queue A item 7)")

        def shard_cat(a):
            # data-sharded slots: this rank's decode rows (the first bsl)
            # tile back into global slot order, so every data rank's pool
            # replica applies every slot's new row; the chunk's rows are
            # the same on every data rank and stay as they are
            if dp is None or not bsl:
                return a
            return torch.cat([comm.all_gather(a[:bsl].contiguous(), dp,
                                              axis=0), a[bsl:]])
        act = dec_active > 0
        dtables, dlens = tables[:bsl], lens[:bsl]
        dlens_l = dlens.long()
        slot = torch.arange(bsl, device=dev)
        page = (dlens_l // blk).clamp(max=npages - 1)
        wd = torch.where(act, dtables[slot, page].long() * blk
                         + dlens_l % blk, torch.zeros_like(dlens_l))
        writes, pos_parts, id_parts = [wd], [dlens_l], [dec_tokens.long()]
        if sw:
            stables, slens = tables[:nsp], lens[:nsp]
            sact = spec_active > 0
            spos = slens.long()[:, None] + torch.arange(sw, device=dev)[None]
            spage = (spos // blk).clamp(max=npages - 1)
            ws = torch.where(sact[:, None],
                             torch.gather(stables.long(), 1, spage) * blk
                             + spos % blk, torch.zeros_like(spos))
            writes.append(ws.reshape(-1))
            # inactive slots' rows sit at position 0 (null-block rows)
            pos_parts.append(torch.where(sact[:, None], spos,
                                         torch.zeros_like(spos)).reshape(-1))
            id_parts.append(spec_tokens.long().reshape(-1))
        ci = torch.arange(nc, device=dev)
        # padded chunk rows take position 0 (past chunk_len, base + i can
        # exceed the learned or rotary table) and write into the null
        # block
        cpos = torch.where(ci < chunk_len, chunk_start + ci,
                           torch.zeros_like(ci))
        # chunk_slot is a global slot id: with data-sharded slots it
        # indexes the block tables gathered over data, once a step
        tables_g = (tables if dp is None or not nc else
                    comm.all_gather(tables, dp, axis=0))
        ctable = tables_g[chunk_slot] if nc else tables[0]
        cpage = (cpos // blk).clamp(max=npages - 1)
        wc = torch.where(ci < chunk_len, ctable[cpage].long() * blk
                         + cpos % blk, torch.zeros_like(ci))
        write = shard_cat(torch.cat(writes + [wc]))
        dec_lens = torch.where(act, dlens + 1, torch.zeros_like(dlens))
        positions = torch.cat(pos_parts + [cpos])[None]
        ids = torch.cat(id_parts + [chunk_ids.long()])[None]
        x = self._embed(params, ids, positions)
        nsample = bsl + nsp * sw
        t = nsample + nc

        for i, bp in enumerate(layer_views(params["blocks"])):
            pk, pv = pool_k[i], pool_v[i]
            ks = vs = None
            if kv_bits:
                ks, vs = pool_ks[i], pool_vs[i]

            def attend(q, k, v, pk=pk, pv=pv, ks=ks, vs=vs):
                new = [(pk, k[0]), (pv, v[0])]
                if kv_bits:
                    (kq, kscale), (vq, vscale) = (kv_quantize(k[0], kv_bits),
                                                  kv_quantize(v[0], kv_bits))
                    new = [(pk, kq), (pv, vq), (ks, kscale), (vs, vscale)]
                new = [(pool, shard_cat(rows)) for pool, rows in new]
                for pool, rows in new:
                    pool.view((nb * blk,) + tuple(pool.shape[2:])).index_copy_(
                        0, write, rows)
                quant = dict(sm_scale=self._attn_scale, k_scale=ks,
                             v_scale=vs, kv_bits=kv_bits)
                parts = []
                if bsl:
                    parts.append(paged_decode_attention(
                        q[0, :bsl].contiguous(), pk, pv, dec_lens, dtables,
                        **quant))
                if sw:
                    # spec depth i attends the prefix plus draft rows
                    # 0..i, all in the pool since the combined scatter
                    qs = q[0, bsl:nsample].reshape(nsp, sw, *q.shape[2:])
                    zero = torch.zeros_like(slens)
                    parts.append(torch.stack([paged_decode_attention(
                        qs[:, d].contiguous(), pk, pv,
                        torch.where(sact, slens + d + 1, zero), stables,
                        **quant) for d in range(sw)], dim=1).reshape(
                            nsp * sw, *q.shape[2:]))
                if nc:
                    parts.append(paged_prefill_attention(
                        q[0, nsample:].contiguous(), pk, pv, chunk_start,
                        chunk_len, ctable, **quant))
                return torch.cat(parts).reshape(1, t, -1)
            x = self._block(self.block_transform(bp), x, attend, positions)
        x = self._final_norm(params, x)
        rows = [x[0, :nsample]]
        if nc:
            last = nsample + max(chunk_len - 1, 0)
            rows.append(x[0, last:last + 1])
        logits = self._project(params, torch.cat(rows))
        new_lens = lens.clone()
        new_lens[:bsl] += act.to(lens.dtype)
        # with data-sharded slots the chunk's slot is this rank's row
        # only on its owner
        cs = chunk_slot - (0 if dp is None else
                           comm.axis_index(dp) * lens.shape[0])
        if nc and 0 <= cs < lens.shape[0]:
            new_lens[cs] += chunk_len
        new_cache = {"k": pool_k, "v": pool_v, "block_tables": tables,
                     "lens": new_lens}
        if kv_bits:
            new_cache["k_scale"], new_cache["v_scale"] = pool_ks, pool_vs
        chunk_logits = logits[nsample] if nc else None
        if sw:
            return (logits[:bsl], logits[bsl:nsample].reshape(nsp, sw, -1),
                    chunk_logits, new_cache)
        return logits[:bsl], chunk_logits, new_cache
