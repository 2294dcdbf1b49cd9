"""Decoder-only transformer LM of the port: the GPT-2/GPT-3 family.

Counterpart of ``deepspeed_tpu/models/transformer.py`` for the subset
``gpt2_config`` defines: learned positions, pre-norm LayerNorm, tanh-GELU
MLP, tied embeddings, multi-head attention, bf16 activations with f32
LayerNorm and softmax.  Other families raise ``NotImplementedError``.

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
With ``attn_impl="flash"`` the uncached forward runs kernel B1 and its
backward kernel B2; ``remat="full"`` recomputes each block in the
backward (``torch.utils.checkpoint``), so B1 runs twice per layer and
step.

Caches are updated IN PLACE (JAX returns new arrays): ``apply`` writes
the new rows into the dense cache tensors it was given, and the paged
mixed step scatters every new k/v row into the pool tensors it was given
before the attention kernels read them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import layers as L
from ..accelerator import resolve_device
from ..ops.transformer.decode_attention import decode_attention
from ..ops.transformer.flash_attention import flash_attention_bthd
from ..ops.transformer.fused_loss import fused_linear_xent
from ..ops.transformer.paged_decode_attention import (
    paged_decode_attention, paged_prefill_attention)

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
    pos_embedding: str = "learned"     # the JAX package also has rotary|alibi|none
    causal: bool = True
    norm_position: str = "pre"
    final_layernorm: bool = True
    parallel_residual: bool = False
    norm_type: str = "layernorm"
    activation: str = "gelu"
    gated_mlp: bool = False
    use_bias: bool = True
    tie_embeddings: bool = True
    dtype: torch.dtype = torch.bfloat16        # activation dtype
    param_dtype: torch.dtype = torch.float32
    remat: str = "none"                # none | full (per block)
    attn_impl: str = "xla"             # xla | flash (kernel injection)
    layernorm_eps: float = 1e-5
    attn_softmax_scale: float = 0.0
    # chunked cross-entropy: tokens per loss chunk (0 = off)
    loss_chunk: int = 512
    # analytic loss head (ops/transformer/fused_loss.py)
    fused_loss_head: bool = True
    moe_num_experts: int = 0

    @property
    def ff_dim(self) -> int:
        return self.d_ff or 4 * self.d_model

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

    def num_params(self) -> int:
        d, f, v = self.d_model, self.ff_dim, self.vocab_size
        nhd = self.num_heads * self.hdim
        per_layer = d * self.qkv_dim + nhd * d + 2 * d * f + 4 * d
        if self.use_bias:
            per_layer += self.qkv_dim + d + f + d
        return (self.num_layers * per_layer + v * d
                + self.max_seq_len * d + 2 * d)


GPT2_SIZES = {
    "125m": dict(num_layers=12, num_heads=12, d_model=768),
    "350m": dict(num_layers=24, num_heads=16, d_model=1024),
    "760m": dict(num_layers=24, num_heads=16, d_model=1536),
    "1.3b": dict(num_layers=24, num_heads=32, d_model=2048),
    "2.7b": dict(num_layers=32, num_heads=32, d_model=2560),
    "6.7b": dict(num_layers=32, num_heads=32, d_model=4096),
    "13b": dict(num_layers=40, num_heads=40, d_model=5120),
}


def gpt2_config(size: str = "125m", **kw) -> TransformerConfig:
    return TransformerConfig(**{"pos_embedding": "learned",
                                "parallel_residual": False,
                                **GPT2_SIZES[size], **kw})


#: what each configuration outside the GPT-2 family needs, and the later
#: slice of the port (ROADMAP.md queue A) that brings it
_OUT_OF_SLICE = (
    (lambda c: c.pos_embedding != "learned",
     "pos_embedding={pos_embedding!r} (rotary/ALiBi families)"),
    (lambda c: c.norm_type != "layernorm", "norm_type={norm_type!r} (RMSNorm)"),
    (lambda c: c.gated_mlp, "gated_mlp (SwiGLU)"),
    (lambda c: c.activation != "gelu", "activation={activation!r}"),
    (lambda c: c.num_kv_heads not in (0, c.num_heads),
     "num_kv_heads={num_kv_heads} (GQA models)"),
    (lambda c: c.parallel_residual, "parallel_residual (NeoX)"),
    (lambda c: c.moe_num_experts > 0, "moe_num_experts (MoE)"),
    (lambda c: not c.causal or c.norm_position != "pre"
     or not c.final_layernorm, "encoder / post-norm families (BERT)"),
    (lambda c: not c.tie_embeddings, "untied lm_head"),
    (lambda c: c.attn_softmax_scale, "attn_softmax_scale (GPT-Neo)"),
    (lambda c: c.attn_impl not in ("xla", "flash"),
     "attn_impl={attn_impl!r}"),
)


#: remat policies of the JAX model that this slice runs
REMAT_POLICIES = ("none", "full")


def check_in_slice(c: TransformerConfig) -> None:
    for test, what in _OUT_OF_SLICE:
        if test(c):
            raise NotImplementedError(
                f"{what.format(**dataclasses.asdict(c))} is outside the "
                f"first slice of the PyTorch port (GPT-2 family); the "
                f"model-families slice of ROADMAP.md queue A brings it")
    if c.remat not in REMAT_POLICIES:
        raise NotImplementedError(
            f"remat={c.remat!r}: the training slice of the PyTorch port "
            f"runs remat 'none' and 'full'; the other policies come with "
            f"the training follow-ups of ROADMAP.md queue A item 1 "
            f"('host_offload' with offload, item 8)")


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


class TransformerLM(nn.Module):
    """``init`` → params tree, ``apply`` → f32 logits.  The module holds
    the config only; weights live in the tree the caller passes (the
    inference engine owns them), as in the JAX package."""

    def __init__(self, config: TransformerConfig):
        super().__init__()
        check_in_slice(config)
        self.config = config

    # -- parameters ---------------------------------------------------------
    def param_shapes(self) -> Params:
        """The params tree's leaf shapes (the JAX package's tree)."""
        c = self.config
        d, f, n = c.d_model, c.ff_dim, c.num_layers
        hd = c.num_heads * c.hdim

        def dense(i, o):
            p = {"kernel": (n, i, o)}
            if c.use_bias:
                p["bias"] = (n, o)
            return p
        norm = {"scale": (n, d), "bias": (n, d)}
        return {
            "embed": {"embedding": (c.vocab_size, d)},
            "pos_embed": {"embedding": (c.max_seq_len, d)},
            "ln_f": {"scale": (d,), "bias": (d,)},
            "blocks": {"ln1": dict(norm), "ln2": dict(norm),
                       "attn": {"qkv": dense(d, c.qkv_dim),
                                "out": dense(hd, d)},
                       "mlp": {"fc_in": dense(d, f),
                               "fc_out": dense(f, d)}},
        }

    def init(self, generator: torch.Generator, device=None,
             dtype: Optional[torch.dtype] = None) -> Params:
        """Fresh weights from ``generator`` (GPT-2 init: N(0, 0.02),
        positions N(0, 0.01), residual-branch outputs scaled by
        1/sqrt(2 L), LayerNorm 1/0, biases 0), drawn one layer at a time
        on ``device`` (default the card; raises without one) in f32 and
        stored in ``dtype`` (default ``param_dtype``).  Random numbers
        differ from the JAX init."""
        c = self.config
        dtype = dtype or c.param_dtype
        device = resolve_device(device)
        n = c.num_layers

        def normal(shape, std):
            return L.normal_init(shape, std, generator, device, dtype)

        def stacked(shape, std, scaled=False):
            out = torch.empty((n,) + tuple(shape), dtype=dtype,
                              device=device)
            for i in range(n):
                out[i] = (L.scaled_init(shape, std, n, generator, device,
                                        dtype) if scaled
                          else normal(shape, std))
            return out

        def zeros(*shape):
            return torch.zeros(shape, dtype=dtype, device=device)

        def ones(*shape):
            return torch.ones(shape, dtype=dtype, device=device)
        d, f = c.d_model, c.ff_dim
        hd = c.num_heads * c.hdim

        def dense(i, o, scaled=False):
            p = {"kernel": stacked((i, o), 0.02, scaled)}
            if c.use_bias:
                p["bias"] = zeros(n, o)
            return p
        return {
            "embed": {"embedding": normal((c.vocab_size, d), 0.02)},
            "pos_embed": {"embedding": normal((c.max_seq_len, d), 0.01)},
            "ln_f": {"scale": ones(d), "bias": zeros(d)},
            "blocks": {
                "ln1": {"scale": ones(n, d), "bias": zeros(n, d)},
                "attn": {"qkv": dense(d, c.qkv_dim),
                         "out": dense(hd, d, scaled=True)},
                "ln2": {"scale": ones(n, d), "bias": zeros(n, d)},
                "mlp": {"fc_in": dense(d, f),
                        "fc_out": dense(f, d, scaled=True)},
            },
        }

    # -- pieces ---------------------------------------------------------------
    def _norm(self, p: Params, x: torch.Tensor) -> torch.Tensor:
        return L.layernorm_apply(p, x, eps=self.config.layernorm_eps)

    def _embed(self, params: Params, ids: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
        c = self.config
        return (L.embedding_apply(params["embed"], ids, c.dtype)
                + L.embedding_apply(params["pos_embed"], positions, c.dtype))

    def _qkv(self, p: Params, h: torch.Tensor):
        c = self.config
        qkv = L.dense_apply(p["qkv"], h)
        b, t = qkv.shape[0], qkv.shape[1]
        qkv = qkv.view(b, t, 3, c.num_heads, c.hdim)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]

    def _mlp(self, p: Params, x: torch.Tensor) -> torch.Tensor:
        return L.dense_apply(p["fc_out"],
                             L.gelu(L.dense_apply(p["fc_in"], x)))

    def _block(self, bp: Params, x: torch.Tensor, attend) -> torch.Tensor:
        """Pre-norm serial residual block; ``attend(q, k, v)`` returns
        ``[.., T, H*D]`` attention output for this layer."""
        q, k, v = self._qkv(bp["attn"], self._norm(bp["ln1"], x))
        x = x + L.dense_apply(bp["attn"]["out"], attend(q, k, v))
        return x + self._mlp(bp["mlp"], self._norm(bp["ln2"], x))

    def _project(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return L.embedding_attend(params["embed"], x)

    # -- full forward and dense-cache decode ------------------------------
    def apply(self, params: Params, input_ids: torch.Tensor,
              cache: Optional[Dict[str, Any]] = None):
        """input_ids ``[B, T]`` → f32 logits ``[B, T, V]``; with ``cache``
        (from :meth:`init_cache`) returns ``(logits, cache)`` after
        writing the T new rows at ``cache["index"]`` in place."""
        c = self.config
        b, t = input_ids.shape
        if cache is None:
            return self._project(params, self.hidden_states(params,
                                                            input_ids))
        idx = int(cache["index"])
        if idx + t > cache["k"].shape[2]:
            raise ValueError(f"cache holds {cache['k'].shape[2]} rows, "
                             f"writing {t} at {idx}")
        pos = idx + torch.arange(t, device=input_ids.device)[None]
        x = self._embed(params, input_ids, pos)
        for i, bp in enumerate(layer_views(params["blocks"])):
            ck, cv = cache["k"][i], cache["v"][i]

            def attend(q, k, v, ck=ck, cv=cv):
                ck[:, idx:idx + t] = k
                cv[:, idx:idx + t] = v
                if t == 1 and c.attn_impl == "flash":
                    # token-at-a-time hot path: kernel B5 over the cache
                    o = decode_attention(q[:, 0].contiguous(), ck, cv,
                                         idx + 1)
                    return o.reshape(b, 1, -1)
                o = L.causal_attention(q, ck[:, :idx + t], cv[:, :idx + t],
                                       kv_positions_offset=idx)
                return o.reshape(b, t, -1)
            x = self._block(bp, x, attend)
        logits = self._project(params, self._norm(params["ln_f"], x))
        return logits, {"k": cache["k"], "v": cache["v"], "index": idx + t}

    forward = apply

    # -- training ----------------------------------------------------------
    def _remat(self, fn):
        """Wrap a block function with the configured remat policy:
        "full" keeps only the block's input and recomputes the rest in
        the backward."""
        if self.config.remat == "none":
            return fn

        def wrapped(*args):
            # the blocks draw no random numbers: no RNG state to replay
            return checkpoint(fn, *args, use_reentrant=False,
                              preserve_rng_state=False)
        return wrapped

    def _attend_full(self, q, k, v):
        """Causal self-attention over a whole sequence ``[B, T, H, D]``
        → ``[B, T, H*D]``: kernels B1/B2 with ``flash``, plain attention
        with ``xla``."""
        b, t = q.shape[0], q.shape[1]
        if self.config.attn_impl == "flash":
            o = flash_attention_bthd(q, k, v, causal=True)
        else:
            o = L.causal_attention(q, k, v)
        return o.reshape(b, t, -1)

    def hidden_states(self, params: Params,
                      input_ids: torch.Tensor) -> torch.Tensor:
        """Forward up to the final norm, pre-projection: ``[B, T, D]``."""
        t = input_ids.shape[1]
        pos = torch.arange(t, device=input_ids.device)[None]
        x = self._embed(params, input_ids, pos)
        block = self._remat(
            lambda bp, x: self._block(bp, x, self._attend_full))
        for bp in layer_views(params["blocks"]):
            x = block(bp, x)
        return self._norm(params["ln_f"], x)

    def loss(self, params: Params, batch: Dict[str, torch.Tensor]
             ) -> torch.Tensor:
        """Causal LM loss.  ``batch``: {"input_ids" [B, T]} (labels are
        the ids shifted left, the last position masked out) or explicit
        {"input_ids", "labels", optional "loss_mask"}."""
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
        x = self.hidden_states(params, ids)
        return self.nll_from_hidden(params, x, labels, mask)

    def nll_from_hidden(self, params: Params, x: torch.Tensor,
                        labels: torch.Tensor,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Mean masked NLL from final hidden states ``[B, T, D]``: the
        loss head alone (fused, chunked with remat, or dense)."""
        c = self.config
        chunk = c.loss_chunk
        b, t = labels.shape
        if c.fused_loss_head:
            rows = b * t
            # chunk in whole token columns, like the checkpointed path
            row_chunk = b * chunk if (chunk and t > chunk
                                      and t % chunk == 0) else 0
            tot, cnt = fused_linear_xent(
                x.reshape(rows, x.shape[-1]), params["embed"]["embedding"],
                labels.reshape(rows),
                None if mask is None else mask.reshape(rows),
                transpose_w=True, chunk=row_chunk)
            return tot / torch.clamp(cnt, min=1.0)
        if chunk and t > chunk and t % chunk == 0:
            def chunk_nll(xc, yc, mc):
                logits = self._project(params, xc)
                lse = torch.logsumexp(logits, dim=-1)
                tgt = logits.gather(-1, yc[..., None])[..., 0]
                return torch.sum((lse - tgt) * mc)
            mc_all = (mask.to(torch.float32) if mask is not None else
                      torch.ones(labels.shape, dtype=torch.float32,
                                 device=labels.device))
            tot = torch.zeros((), dtype=torch.float32, device=x.device)
            for c0 in range(0, t, chunk):
                sl = slice(c0, c0 + chunk)
                tot = tot + checkpoint(chunk_nll, x[:, sl], labels[:, sl],
                                       mc_all[:, sl], use_reentrant=False,
                                       preserve_rng_state=False)
            return tot / torch.clamp(mc_all.sum(), min=1.0)
        logits = self._project(params, x)
        lse = torch.logsumexp(logits, dim=-1)
        nll = lse - logits.gather(-1, labels[..., None])[..., 0]
        if mask is None:
            return nll.mean()
        mask = mask.to(nll.dtype)
        return torch.sum(nll * mask) / torch.clamp(mask.sum(), min=1.0)

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
    def _paged_supported(self) -> Optional[str]:
        """None when the paged path serves this config (the slice's
        family always is, given a head_dim that is a multiple of 8)."""
        if self.config.hdim % 8:
            return (f"head_dim {self.config.hdim} is not a multiple of 8")
        return None

    def init_paged_cache(self, num_blocks: int, block_size: int,
                         dtype: Optional[torch.dtype] = None,
                         kv_bits: int = 0, device=None) -> Dict[str, Any]:
        """Per-layer paged KV pools ``[L, num_blocks, block_size, kv_heads,
        head_dim]`` on ``device`` (default the card; raises without one).
        Block 0 is the allocator's reserved null block."""
        if kv_bits not in (0, 4, 8):
            raise ValueError(f"kv_bits must be 0, 4 or 8, got {kv_bits}")
        if kv_bits:
            raise NotImplementedError(
                f"kv_bits={kv_bits} (quantized KV pools) is a later slice "
                f"of the port")
        c = self.config
        shape = (c.num_layers, num_blocks, block_size, c.kv_heads, c.hdim)
        dtype = dtype or c.dtype
        device = resolve_device(device)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    def _apply_paged_mixed(self, params: Params, cache: Dict[str, Any],
                           dec_tokens: torch.Tensor,
                           dec_active: torch.Tensor,
                           chunk_ids: torch.Tensor, chunk_slot: int,
                           chunk_start: int, chunk_len: int
                           ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                      Dict[str, Any]]:
        """Mixed continuous-batching step: one decode token per slot
        (``dec_tokens``/``dec_active`` ``[B]`` int32, or ``[0]``: no
        decode lane) plus ``chunk_ids`` ``[C]`` of one slot's prompt at
        rows ``chunk_start ..`` (C may be 0: no chunk; ids past
        ``chunk_len`` are padding).

        ``cache``: {"k"/"v": pools, "block_tables": ``[S, pages]`` int32,
        "lens": ``[S]`` int32 rows already in the pool} for all S slots.
        Every new k/v row is scattered into the pools in place in one
        combined write per layer (decode rows at ``table[len // blk]``,
        chunk rows at ``base + i`` of the chunk slot's table, inactive and
        padded rows to the null block 0); then kernel B6 attends for the
        decode slots and kernel B7 for the chunk.  A lane of width 0 runs
        no kernel.  Returns ``(dec_logits [B, V], chunk_logits [V] at the
        chunk's last valid row or None when C is 0, cache with the new
        lens)``."""
        c = self.config
        pool_k, pool_v = cache["k"], cache["v"]
        tables, lens = cache["block_tables"], cache["lens"]
        dev = dec_tokens.device
        bsl, nc = dec_tokens.shape[0], chunk_ids.shape[0]
        nb, blk = pool_k.shape[1], pool_k.shape[2]
        npages = tables.shape[1]
        act = dec_active > 0
        dtables, dlens = tables[:bsl], lens[:bsl]
        dlens_l = dlens.long()
        slot = torch.arange(bsl, device=dev)
        page = (dlens_l // blk).clamp(max=npages - 1)
        wd = torch.where(act, dtables[slot, page].long() * blk
                         + dlens_l % blk, torch.zeros_like(dlens_l))
        ci = torch.arange(nc, device=dev)
        # padded chunk rows take position 0 (the learned table's bound)
        # and write into the null block
        cpos = torch.where(ci < chunk_len, chunk_start + ci,
                           torch.zeros_like(ci))
        ctable = tables[chunk_slot] if nc else tables[0]
        cpage = (cpos // blk).clamp(max=npages - 1)
        wc = torch.where(ci < chunk_len, ctable[cpage].long() * blk
                         + cpos % blk, torch.zeros_like(ci))
        write = torch.cat([wd, wc])
        dec_lens = torch.where(act, dlens + 1, torch.zeros_like(dlens))
        positions = torch.cat([dlens_l, cpos])[None]
        ids = torch.cat([dec_tokens.long(), chunk_ids.long()])[None]
        x = self._embed(params, ids, positions)
        t = bsl + nc

        for i, bp in enumerate(layer_views(params["blocks"])):
            pk, pv = pool_k[i], pool_v[i]

            def attend(q, k, v, pk=pk, pv=pv):
                flat = (nb * blk,) + tuple(pk.shape[2:])
                pk.view(flat).index_copy_(0, write, k[0])
                pv.view(flat).index_copy_(0, write, v[0])
                parts = []
                if bsl:
                    parts.append(paged_decode_attention(
                        q[0, :bsl].contiguous(), pk, pv, dec_lens, dtables))
                if nc:
                    parts.append(paged_prefill_attention(
                        q[0, bsl:].contiguous(), pk, pv, chunk_start,
                        chunk_len, ctable))
                return torch.cat(parts).reshape(1, t, -1)
            x = self._block(bp, x, attend)
        x = self._norm(params["ln_f"], x)
        rows = [x[0, :bsl]]
        if nc:
            last = bsl + max(chunk_len - 1, 0)
            rows.append(x[0, last:last + 1])
        logits = self._project(params, torch.cat(rows))
        new_lens = lens.clone()
        new_lens[:bsl] += act.to(lens.dtype)
        if nc:
            new_lens[chunk_slot] += chunk_len
        new_cache = {"k": pool_k, "v": pool_v, "block_tables": tables,
                     "lens": new_lens}
        return logits[:bsl], (logits[bsl] if nc else None), new_cache
