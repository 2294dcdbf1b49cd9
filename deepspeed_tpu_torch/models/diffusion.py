"""Stable-Diffusion-class model family of the port: UNet, VAE, CLIP text.

Counterpart of ``deepspeed_tpu/models/diffusion.py`` (the published SD
v1.x component specs: ``UNet2DConditionModel``, ``AutoencoderKL``,
``CLIPTextModel``; HF checkpoints load through
``module_inject/diffusion_policies.py``), in plain PyTorch on cuDNN's
convolutions and cuBLAS's products.  No TPU kernel lies on this path:
the JAX package runs it on XLA, so the port has no hand-written kernel
to bring here.

Params keep the JAX package's layout (conv kernels ``HWIO``, dense
kernels ``[in, out]``, blocks in lists), so trees cross between the
packages leaf by leaf (:func:`to_torch_tree`).  ``F.conv2d`` takes
``OIHW`` weights: :func:`prepare` converts a tree once (each conv's
``kernel`` to a ``weight`` in channels-last memory, every float leaf to
one dtype, on one device), and ``conv_apply`` takes either form, so a
pipeline converts at build, never per call.  Inside the modules
activations are ``NCHW`` tensors in channels-last memory (the bytes of
the JAX package's NHWC arrays); the modules take and return NHWC, as
the JAX ones do.

Numerics follow the JAX modules: GroupNorm and LayerNorm in float32
(eps 1e-5, the VAE's and the transformer's GroupNorm 1e-6), the
timestep embedding and its MLP in float32, attention scores cast to
float32 before the softmax (``_attn``), strided convs padded
symmetrically ``(k - 1) // 2`` on each side, nearest-neighbour
upsampling by two.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import layers as L
from .convert import leaf_to_torch, tree_map

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------
def to_torch_tree(tree, device="cpu", dtype: Optional[torch.dtype] = None):
    """A params tree of numpy (or JAX, after ``jax.device_get``) arrays
    or tensors as tensors on ``device``; float leaves cast to ``dtype``
    when given."""
    def one(a):
        if isinstance(a, torch.Tensor):
            return (a.to(dtype) if dtype is not None and a.is_floating_point()
                    else a).to(device)
        return leaf_to_torch(a, device, dtype)
    return tree_map(tree, one)


def prepare(tree, device, dtype: torch.dtype):
    """The tree the modules run on ``device`` in ``dtype``: each conv's
    ``kernel`` (4-D, HWIO) becomes its ``weight`` (OIHW in channels-last
    memory), every float leaf ``dtype``.  Already prepared convs pass
    through."""
    def walk(t):
        if isinstance(t, dict):
            k = t.get("kernel")
            if isinstance(k, torch.Tensor) and k.dim() == 4:
                w = k.to(device, dtype).permute(3, 2, 0, 1)
                out = {"weight": w.contiguous(
                    memory_format=torch.channels_last)}
                out.update({n: walk(v) for n, v in t.items()
                            if n != "kernel"})
                return out
            return {n: walk(v) for n, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(v) for v in t]
        t = t.to(device)
        return t.to(dtype) if t.is_floating_point() else t
    return walk(tree)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC → the NCHW view of the same bytes (channels-last memory)."""
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# primitives (NCHW tensors, channels-last memory)
# ---------------------------------------------------------------------------
def conv_init(generator, kh, kw, cin, cout, device, dtype=torch.float32):
    k = torch.randn((kh, kw, cin, cout), generator=generator, device=device,
                    dtype=torch.float32) / math.sqrt(kh * kw * cin)
    return {"kernel": k.to(dtype),
            "bias": torch.zeros(cout, dtype=dtype, device=device)}


def conv_apply(p: Params, x: torch.Tensor, stride: int = 1,
               padding="SAME") -> torch.Tensor:
    """2-D convolution of x ``[N, C, H, W]``: ``"SAME"`` pads
    ``(k - 1) // 2`` on each side (torch ``Conv2d`` semantics; XLA's
    SAME pads asymmetrically under a stride), ``"VALID"`` pads none.
    Takes a prepared ``weight`` (OIHW) or a raw ``kernel`` (HWIO)."""
    w = p.get("weight")
    if w is None:
        w = p["kernel"].permute(3, 2, 0, 1)
    k = w.shape[-1]
    pad = (k - 1) // 2 if padding == "SAME" else 0
    return F.conv2d(x, w.to(x.dtype), p["bias"].to(x.dtype), stride, pad)


def groupnorm_init(c, device, dtype=torch.float32):
    return {"scale": torch.ones(c, dtype=dtype, device=device),
            "bias": torch.zeros(c, dtype=dtype, device=device)}


def groupnorm_apply(p: Params, x: torch.Tensor, groups: int = 32,
                    eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm of x ``[N, C, H, W]`` computed in float32 (diffusers'
    eps 1e-5; the VAE's 1e-6), returned in x's dtype."""
    g = min(groups, x.shape[1])
    y = F.group_norm(x.float(), g, p["scale"].float(), p["bias"].float(),
                     eps)
    return y.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0,
                       flip_sin_to_cos: bool = True,
                       shift: float = 0.0) -> torch.Tensor:
    """Sinusoidal timestep embedding ``[B, dim]`` f32 (diffusers'
    ``get_timestep_embedding``: SD flips to cos first)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :] + shift
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


def _attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          heads: int) -> torch.Tensor:
    """Multi-head attention over token axes ``[B, T, C]``: the scores in
    q's dtype, then softmax in float32, probabilities cast to v's
    dtype for the value product (the JAX ``_attn``)."""
    b, tq, c = q.shape
    tk = k.shape[1]
    dh = c // heads
    q = q.reshape(b, tq, heads, dh).transpose(1, 2)
    k = k.reshape(b, tk, heads, dh).transpose(1, 2)
    v = v.reshape(b, tk, heads, dh).transpose(1, 2)
    s = torch.matmul(q, k.transpose(-1, -2)).float() / math.sqrt(dh)
    a = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(a, v).transpose(1, 2).reshape(b, tq, c)


def _dense_init(generator, din, dout, device, dtype=torch.float32,
                use_bias=True):
    p = {"kernel": L.normal_init((din, dout), 0.02, generator, device,
                                 dtype)}
    if use_bias:
        p["bias"] = torch.zeros(dout, dtype=dtype, device=device)
    return p


#: a LayerNorm's leaves are a GroupNorm's: scale 1, bias 0
_layernorm_init = groupnorm_init


# ---------------------------------------------------------------------------
# UNet building blocks
# ---------------------------------------------------------------------------
def _resnet_init(g, cin, cout, temb_dim, device, dtype):
    p = {"norm1": groupnorm_init(cin, device, dtype),
         "conv1": conv_init(g, 3, 3, cin, cout, device, dtype),
         "norm2": groupnorm_init(cout, device, dtype),
         "conv2": conv_init(g, 3, 3, cout, cout, device, dtype)}
    if temb_dim:
        p["time_emb_proj"] = _dense_init(g, temb_dim, cout, device)
    if cin != cout:
        p["conv_shortcut"] = conv_init(g, 1, 1, cin, cout, device, dtype)
    return p


def _resnet_apply(p, x, temb, groups=32, eps=1e-5):
    h = conv_apply(p["conv1"], silu(groupnorm_apply(p["norm1"], x, groups,
                                                    eps)))
    if temb is not None and "time_emb_proj" in p:
        h = h + L.dense_apply(p["time_emb_proj"], silu(temb))[
            :, :, None, None].to(h.dtype)
    h = conv_apply(p["conv2"], silu(groupnorm_apply(p["norm2"], h, groups,
                                                    eps)))
    if "conv_shortcut" in p:
        x = conv_apply(p["conv_shortcut"], x)
    return x + h


def _basic_tblock_init(g, dim, ctx_dim, device, dtype):
    """BasicTransformerBlock: self-attention, cross-attention, GEGLU."""
    d = dim

    def attn(kv_dim):
        return {"to_q": _dense_init(g, d, d, device, use_bias=False),
                "to_k": _dense_init(g, kv_dim, d, device, use_bias=False),
                "to_v": _dense_init(g, kv_dim, d, device, use_bias=False),
                "to_out": _dense_init(g, d, d, device)}
    return {"norm1": _layernorm_init(d, device),
            "attn1": attn(d),
            "norm2": _layernorm_init(d, device),
            "attn2": attn(ctx_dim),
            "norm3": _layernorm_init(d, device),
            "ff": {"proj_in": _dense_init(g, d, 8 * d, device),
                   "proj_out": _dense_init(g, 4 * d, d, device)}}


def _basic_tblock_apply(p, x, ctx, heads):
    def run_attn(ap, h, kv):
        q = L.dense_apply(ap["to_q"], h)
        k = L.dense_apply(ap["to_k"], kv)
        v = L.dense_apply(ap["to_v"], kv)
        return L.dense_apply(ap["to_out"], _attn(q, k, v, heads))

    h = L.layernorm_apply(p["norm1"], x)
    x = x + run_attn(p["attn1"], h, h)
    x = x + run_attn(p["attn2"], L.layernorm_apply(p["norm2"], x), ctx)
    h = L.dense_apply(p["ff"]["proj_in"], L.layernorm_apply(p["norm3"], x))
    a, gate = h.chunk(2, dim=-1)
    # GEGLU with the exact GELU (diffusers' F.gelu)
    return x + L.dense_apply(p["ff"]["proj_out"],
                             a * F.gelu(gate, approximate="none"))


def _transformer2d_init(g, c, ctx_dim, depth, device, dtype):
    return {"norm": groupnorm_init(c, device, dtype),
            "proj_in": conv_init(g, 1, 1, c, c, device, dtype),
            "blocks": [_basic_tblock_init(g, c, ctx_dim, device, dtype)
                       for _ in range(depth)],
            "proj_out": conv_init(g, 1, 1, c, c, device, dtype)}


def _transformer2d_apply(p, x, ctx, heads, groups=32):
    n, c, h, w = x.shape
    res = x
    x = conv_apply(p["proj_in"], groupnorm_apply(p["norm"], x, groups,
                                                 1e-6))
    x = _nhwc(x).reshape(n, h * w, c)
    for bp in p["blocks"]:
        x = _basic_tblock_apply(bp, x, ctx, heads)
    x = _nchw(x.reshape(n, h, w, c))
    return conv_apply(p["proj_out"], x) + res


def _upsample(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour x2 (``jax.image.resize`` "nearest" at twice the
    size reads input pixel i // 2)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


# ---------------------------------------------------------------------------
# UNet2DCondition
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class UNetConfig:
    """SD v1.x ``UNet2DConditionModel`` surface (HF config names)."""
    sample_size: int = 64
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    attention_head_dim: int = 8          # the head COUNT in SD1 configs
    transformer_depth: int = 1
    norm_num_groups: int = 32
    # which down blocks carry cross-attention (SD1: all but the last)
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D", "DownBlock2D")
    up_block_types: Tuple[str, ...] = (
        "UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D")
    dtype: torch.dtype = torch.float32   # params' dtype at init


class UNet2DCondition:
    """Denoising UNet with text cross-attention."""

    def __init__(self, config: UNetConfig):
        self.config = config

    def init(self, generator: torch.Generator, device="cpu") -> Params:
        c = self.config
        dt = c.dtype
        bo = c.block_out_channels
        temb = bo[0] * 4
        g = generator
        p: Params = {
            "conv_in": conv_init(g, 3, 3, c.in_channels, bo[0], device, dt),
            "time_embedding": {
                "linear_1": _dense_init(g, bo[0], temb, device),
                "linear_2": _dense_init(g, temb, temb, device)},
        }
        downs = []
        ch = bo[0]
        for bi, btype in enumerate(c.down_block_types):
            cout = bo[bi]
            blk = {"resnets": [], "attentions": []}
            for li in range(c.layers_per_block):
                blk["resnets"].append(_resnet_init(
                    g, ch if li == 0 else cout, cout, temb, device, dt))
                if btype == "CrossAttnDownBlock2D":
                    blk["attentions"].append(_transformer2d_init(
                        g, cout, c.cross_attention_dim, c.transformer_depth,
                        device, dt))
            if bi != len(bo) - 1:
                blk["downsample"] = conv_init(g, 3, 3, cout, cout, device,
                                              dt)
            downs.append(blk)
            ch = cout
        p["down_blocks"] = downs
        p["mid_block"] = {
            "resnets": [_resnet_init(g, ch, ch, temb, device, dt),
                        _resnet_init(g, ch, ch, temb, device, dt)],
            "attentions": [_transformer2d_init(
                g, ch, c.cross_attention_dim, c.transformer_depth, device,
                dt)],
        }
        ups = []
        rev = list(reversed(bo))
        for bi, btype in enumerate(c.up_block_types):
            cout = rev[bi]
            prev = rev[max(bi - 1, 0)]
            skip_base = rev[min(bi + 1, len(rev) - 1)]
            blk = {"resnets": [], "attentions": []}
            for li in range(c.layers_per_block + 1):
                res_skip = skip_base if li == c.layers_per_block else cout
                res_in = prev if li == 0 else cout
                blk["resnets"].append(_resnet_init(
                    g, res_in + res_skip, cout, temb, device, dt))
                if btype == "CrossAttnUpBlock2D":
                    blk["attentions"].append(_transformer2d_init(
                        g, cout, c.cross_attention_dim, c.transformer_depth,
                        device, dt))
            if bi != len(bo) - 1:
                blk["upsample"] = conv_init(g, 3, 3, cout, cout, device, dt)
            ups.append(blk)
        p["up_blocks"] = ups
        p["conv_norm_out"] = groupnorm_init(bo[0], device, dt)
        p["conv_out"] = conv_init(g, 3, 3, bo[0], c.out_channels, device, dt)
        return p

    def apply(self, p: Params, sample: torch.Tensor,
              timesteps: torch.Tensor,
              encoder_hidden_states: torch.Tensor) -> torch.Tensor:
        """sample ``[B, H, W, C_in]`` (NHWC latents), timesteps ``[B]``,
        encoder_hidden_states ``[B, T_text, ctx_dim]`` → eps ``[B, H, W,
        C_out]``, computed in sample's dtype (the time embedding's MLP in
        float32)."""
        c = self.config
        g = c.norm_num_groups
        heads = c.attention_head_dim
        ctx = encoder_hidden_states
        te = p["time_embedding"]
        temb = timestep_embedding(torch.as_tensor(timesteps,
                                                  device=sample.device),
                                  c.block_out_channels[0])
        temb = L.dense_apply(te["linear_2"],
                             silu(L.dense_apply(te["linear_1"], temb)))

        x = conv_apply(p["conv_in"], _nchw(sample))
        skips = [x]
        for blk in p["down_blocks"]:
            has_attn = len(blk["attentions"]) > 0
            for li, rp in enumerate(blk["resnets"]):
                x = _resnet_apply(rp, x, temb, g)
                if has_attn:
                    x = _transformer2d_apply(blk["attentions"][li], x, ctx,
                                             heads, g)
                skips.append(x)
            if "downsample" in blk:
                x = conv_apply(blk["downsample"], x, stride=2)
                skips.append(x)

        mid = p["mid_block"]
        x = _resnet_apply(mid["resnets"][0], x, temb, g)
        x = _transformer2d_apply(mid["attentions"][0], x, ctx, heads, g)
        x = _resnet_apply(mid["resnets"][1], x, temb, g)

        for blk in p["up_blocks"]:
            has_attn = len(blk["attentions"]) > 0
            for li, rp in enumerate(blk["resnets"]):
                x = torch.cat([x, skips.pop()], dim=1)
                x = _resnet_apply(rp, x, temb, g)
                if has_attn:
                    x = _transformer2d_apply(blk["attentions"][li], x, ctx,
                                             heads, g)
            if "upsample" in blk:
                x = conv_apply(blk["upsample"], _upsample(x))

        x = silu(groupnorm_apply(p["conv_norm_out"], x, g))
        return _nhwc(conv_apply(p["conv_out"], x))


# ---------------------------------------------------------------------------
# VAE (AutoencoderKL)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    dtype: torch.dtype = torch.float32


class AutoencoderKL:
    """VAE encoder/decoder (SD latent space); each mid block holds one
    single-head self-attention (diffusers' AttnBlock)."""

    def __init__(self, config: VAEConfig):
        self.config = config

    @staticmethod
    def _attnblock_init(g, ch, device):
        return {"group_norm": groupnorm_init(ch, device),
                "to_q": _dense_init(g, ch, ch, device),
                "to_k": _dense_init(g, ch, ch, device),
                "to_v": _dense_init(g, ch, ch, device),
                "to_out": _dense_init(g, ch, ch, device)}

    @staticmethod
    def _attnblock_apply(p, x, groups):
        n, ch, h, w = x.shape
        hh = _nhwc(groupnorm_apply(p["group_norm"], x, groups, 1e-6))
        hh = hh.reshape(n, h * w, ch)
        q = L.dense_apply(p["to_q"], hh)
        k = L.dense_apply(p["to_k"], hh)
        v = L.dense_apply(p["to_v"], hh)
        o = L.dense_apply(p["to_out"], _attn(q, k, v, heads=1))
        return x + _nchw(o.reshape(n, h, w, ch))

    def _mid_init(self, g, ch, device, dt):
        return {"resnets": [_resnet_init(g, ch, ch, 0, device, dt),
                            _resnet_init(g, ch, ch, 0, device, dt)],
                "attentions": [self._attnblock_init(g, ch, device)]}

    def _mid_apply(self, m, x, g):
        x = _resnet_apply(m["resnets"][0], x, None, g, 1e-6)
        x = self._attnblock_apply(m["attentions"][0], x, g)
        return _resnet_apply(m["resnets"][1], x, None, g, 1e-6)

    def init(self, generator: torch.Generator, device="cpu") -> Params:
        c = self.config
        dt = c.dtype
        bo = c.block_out_channels
        g = generator
        enc: Params = {"conv_in": conv_init(g, 3, 3, c.in_channels, bo[0],
                                            device, dt),
                       "down_blocks": []}
        ch = bo[0]
        for bi, cout in enumerate(bo):
            blk = {"resnets": [_resnet_init(
                g, ch if li == 0 else cout, cout, 0, device, dt)
                for li in range(c.layers_per_block)]}
            if bi != len(bo) - 1:
                blk["downsample"] = conv_init(g, 3, 3, cout, cout, device,
                                              dt)
            enc["down_blocks"].append(blk)
            ch = cout
        enc["mid_block"] = self._mid_init(g, ch, device, dt)
        enc["conv_norm_out"] = groupnorm_init(ch, device, dt)
        enc["conv_out"] = conv_init(g, 3, 3, ch, 2 * c.latent_channels,
                                    device, dt)
        dec: Params = {"conv_in": conv_init(g, 3, 3, c.latent_channels, ch,
                                            device, dt),
                       "mid_block": self._mid_init(g, ch, device, dt),
                       "up_blocks": []}
        rev = list(reversed(bo))
        for bi, cout in enumerate(rev):
            cin = rev[max(bi - 1, 0)]
            blk = {"resnets": [_resnet_init(
                g, cin if li == 0 else cout, cout, 0, device, dt)
                for li in range(c.layers_per_block + 1)]}
            if bi != len(bo) - 1:
                blk["upsample"] = conv_init(g, 3, 3, cout, cout, device, dt)
            dec["up_blocks"].append(blk)
        dec["conv_norm_out"] = groupnorm_init(bo[0], device, dt)
        dec["conv_out"] = conv_init(g, 3, 3, bo[0], c.in_channels, device,
                                    dt)
        lc = c.latent_channels
        return {"encoder": enc, "decoder": dec,
                "quant_conv": conv_init(g, 1, 1, 2 * lc, 2 * lc, device, dt),
                "post_quant_conv": conv_init(g, 1, 1, lc, lc, device, dt)}

    def encode(self, p: Params, images: torch.Tensor):
        """images ``[B, H, W, 3]`` → (mean, logvar) ``[B, h, w, 4]`` of
        the latent posterior."""
        g = self.config.norm_num_groups
        e = p["encoder"]
        x = conv_apply(e["conv_in"], _nchw(images))
        for blk in e["down_blocks"]:
            for rp in blk["resnets"]:
                x = _resnet_apply(rp, x, None, g, 1e-6)
            if "downsample" in blk:
                x = conv_apply(blk["downsample"], F.pad(x, (0, 1, 0, 1)),
                               stride=2, padding="VALID")
        x = self._mid_apply(e["mid_block"], x, g)
        x = silu(groupnorm_apply(e["conv_norm_out"], x, g, 1e-6))
        x = conv_apply(p["quant_conv"], conv_apply(e["conv_out"], x))
        mean, logvar = _nhwc(x).chunk(2, dim=-1)
        return mean, logvar

    def decode(self, p: Params, latents: torch.Tensor) -> torch.Tensor:
        """latents ``[B, h, w, 4]`` (already divided by the scaling
        factor) → images ``[B, H, W, 3]``."""
        g = self.config.norm_num_groups
        d = p["decoder"]
        x = conv_apply(p["post_quant_conv"], _nchw(latents))
        x = self._mid_apply(d["mid_block"], conv_apply(d["conv_in"], x), g)
        for blk in d["up_blocks"]:
            for rp in blk["resnets"]:
                x = _resnet_apply(rp, x, None, g, 1e-6)
            if "upsample" in blk:
                x = conv_apply(blk["upsample"], _upsample(x))
        x = silu(groupnorm_apply(d["conv_norm_out"], x, g, 1e-6))
        return _nhwc(conv_apply(d["conv_out"], x))


# ---------------------------------------------------------------------------
# CLIP text encoder
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.float32


class CLIPTextEncoder:
    """CLIP text tower (HF ``CLIPTextModel``: causal mask, quick_gelu,
    final LayerNorm; returns the last hidden state)."""

    def __init__(self, config: CLIPTextConfig):
        self.config = config

    def init(self, generator: torch.Generator, device="cpu") -> Params:
        c = self.config
        d = c.hidden_size
        g = generator

        def emb(n):
            return {"embedding": L.normal_init((n, d), 0.02, g, device,
                                               torch.float32)}
        p = {"token_embedding": emb(c.vocab_size),
             "position_embedding": emb(c.max_position_embeddings),
             "final_layer_norm": _layernorm_init(d, device),
             "layers": []}
        for _ in range(c.num_hidden_layers):
            p["layers"].append({
                "layer_norm1": _layernorm_init(d, device),
                "q_proj": _dense_init(g, d, d, device),
                "k_proj": _dense_init(g, d, d, device),
                "v_proj": _dense_init(g, d, d, device),
                "out_proj": _dense_init(g, d, d, device),
                "layer_norm2": _layernorm_init(d, device),
                "fc1": _dense_init(g, d, c.intermediate_size, device),
                "fc2": _dense_init(g, c.intermediate_size, d, device),
            })
        return p

    def apply(self, p: Params, input_ids: torch.Tensor) -> torch.Tensor:
        """input_ids ``[B, T]`` → ``[B, T, hidden]`` in the params'
        dtype."""
        c = self.config
        b, t = input_ids.shape
        dev = input_ids.device
        x = (L.embedding_apply(p["token_embedding"], input_ids)
             + L.embedding_apply(p["position_embedding"],
                                 torch.arange(t, device=dev)[None]))
        mask = torch.full((t, t), -math.inf, device=dev).triu(1)
        h = c.num_attention_heads
        dh = c.hidden_size // h
        eps = c.layer_norm_eps
        for lp in p["layers"]:
            y = L.layernorm_apply(lp["layer_norm1"], x, eps)
            q, k, v = (L.dense_apply(lp[n], y).reshape(b, t, h, dh)
                       .transpose(1, 2)
                       for n in ("q_proj", "k_proj", "v_proj"))
            s = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dh)
            a = torch.softmax(s.float() + mask, dim=-1).to(v.dtype)
            o = torch.matmul(a, v).transpose(1, 2).reshape(b, t,
                                                           c.hidden_size)
            x = x + L.dense_apply(lp["out_proj"], o)
            y = L.dense_apply(lp["fc1"],
                              L.layernorm_apply(lp["layer_norm2"], x, eps))
            y = y * torch.sigmoid(1.702 * y)              # quick_gelu
            x = x + L.dense_apply(lp["fc2"], y)
        return L.layernorm_apply(p["final_layer_norm"], x, eps)


# ---------------------------------------------------------------------------
# schedulers + pipeline
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class DDIMConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"    # SD default
    # SD's shipped scheduler config: timesteps shift up by one and the
    # final step targets alphas_cumprod[0], not alpha = 1
    steps_offset: int = 1
    set_alpha_to_one: bool = False


def _alphas_cumprod(c: DDIMConfig) -> np.ndarray:
    if c.beta_schedule == "scaled_linear":
        betas = np.linspace(c.beta_start ** 0.5, c.beta_end ** 0.5,
                            c.num_train_timesteps) ** 2
    else:
        betas = np.linspace(c.beta_start, c.beta_end,
                            c.num_train_timesteps)
    return np.cumprod(1.0 - betas)


def _timesteps(c: DDIMConfig, num_steps: int) -> np.ndarray:
    step = c.num_train_timesteps // num_steps
    ts = (np.arange(num_steps) * step).round()[::-1].astype(np.int32)
    return np.minimum(ts + c.steps_offset, c.num_train_timesteps - 1)


class DDIMScheduler:
    """Deterministic DDIM sampling (eta 0); numpy f32 tables, steps in
    float32."""

    def __init__(self, config: DDIMConfig = DDIMConfig()):
        self.config = config
        self.alphas_cumprod = _alphas_cumprod(config).astype(np.float32)
        self.final_alpha_cumprod = (np.float32(1.0) if config.set_alpha_to_one
                                    else self.alphas_cumprod[0])

    def timesteps(self, num_steps: int) -> np.ndarray:
        return _timesteps(self.config, num_steps)

    def step(self, eps: torch.Tensor, t: int, t_prev: int,
             sample: torch.Tensor) -> torch.Tensor:
        a_t = torch.tensor(self.alphas_cumprod[int(t)])
        a_prev = torch.tensor(self.alphas_cumprod[int(t_prev)]
                              if t_prev >= 0 else self.final_alpha_cumprod)
        x0 = (sample - torch.sqrt(1 - a_t) * eps) / torch.sqrt(a_t)
        return torch.sqrt(a_prev) * x0 + torch.sqrt(1 - a_prev) * eps

    def scale_model_input(self, sample: torch.Tensor, t: int) -> torch.Tensor:
        return sample

    def init_noise_sigma(self, t0) -> float:
        return 1.0


class EulerDiscreteScheduler:
    """Deterministic Euler sampling in sigma space (x = x0 + sigma eps,
    sigma = sqrt((1 - acp) / acp)): the UNet input is rescaled by 1 /
    sqrt(sigma^2 + 1), and each step is x += (sigma_prev - sigma) eps."""

    def __init__(self, config: DDIMConfig = DDIMConfig()):
        self.config = config
        ac = _alphas_cumprod(config)
        self.alphas_cumprod = ac.astype(np.float32)
        self.sigmas = np.sqrt((1.0 - ac) / ac).astype(np.float32)

    def timesteps(self, num_steps: int) -> np.ndarray:
        return _timesteps(self.config, num_steps)

    def init_noise_sigma(self, t0) -> float:
        return float(self.sigmas[int(t0)])

    def scale_model_input(self, sample: torch.Tensor, t: int) -> torch.Tensor:
        s = torch.tensor(self.sigmas[int(t)])
        return sample / torch.sqrt(s * s + 1.0)

    def step(self, eps: torch.Tensor, t: int, t_prev: int,
             sample: torch.Tensor) -> torch.Tensor:
        s = torch.tensor(self.sigmas[int(t)])
        s_prev = torch.tensor(self.sigmas[int(t_prev)] if t_prev >= 0
                              else np.float32(0.0))
        # epsilon prediction: dx/dsigma = eps
        return sample + (s_prev - s) * eps


class StableDiffusionPipeline:
    """Text → image: CLIP encodes ``[uncond, text]``, the scheduler's
    loop runs the UNet on both halves with classifier-free guidance, the
    VAE decodes, and the image is clipped to ``images * 0.5 + 0.5`` in
    [0, 1].  The modules run in ``dtype`` on ``device`` (the latents,
    guidance and scheduler stay float32); params are :func:`prepare`d
    once when given in the JAX layout."""

    def __init__(self, unet: UNet2DCondition, vae: AutoencoderKL,
                 text_encoder: CLIPTextEncoder, scheduler=None,
                 device="cpu", dtype: torch.dtype = torch.float32):
        self.unet, self.vae, self.text = unet, vae, text_encoder
        self.scheduler = scheduler or DDIMScheduler()
        self.device = torch.device(device)
        self.dtype = dtype

    def prepare(self, params: Params) -> Params:
        """``params`` on the pipeline's device in its dtype, convs in
        ``F.conv2d``'s layout (a no-op on a prepared tree)."""
        return prepare(params, self.device, self.dtype)

    def unet_step(self, up: Params, latents: torch.Tensor, t: int,
                  t_prev: int, ctx: torch.Tensor,
                  guidance: float) -> torch.Tensor:
        """One guided denoising step of f32 latents ``[B, h, w, C]``."""
        model_in = self.scheduler.scale_model_input(latents, t)
        both = torch.cat([model_in, model_in]).to(self.dtype)
        tt = torch.full((both.shape[0],), int(t), dtype=torch.int32,
                        device=latents.device)
        eps = self.unet.apply(up, both, tt, ctx).float()
        e_uncond, e_text = eps.chunk(2)
        eps = e_uncond + guidance * (e_text - e_uncond)
        return self.scheduler.step(eps, t, t_prev, latents)

    def encode_text(self, tp: Params, prompt_ids, uncond_ids) -> torch.Tensor:
        def ids(x):
            return torch.as_tensor(np.asarray(x), dtype=torch.int64,
                                   device=self.device)
        return torch.cat([self.text.apply(tp, ids(uncond_ids)),
                          self.text.apply(tp, ids(prompt_ids))])

    def decode(self, vp: Params, latents: torch.Tensor) -> torch.Tensor:
        z = (latents / self.vae.config.scaling_factor).to(self.dtype)
        return self.vae.decode(vp, z).float()

    @torch.inference_mode()
    def __call__(self, params: Params, prompt_ids, uncond_ids,
                 num_steps: int = 50, guidance: float = 7.5,
                 latents: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 height: Optional[int] = None,
                 width: Optional[int] = None) -> torch.Tensor:
        """params ``{"unet", "vae", "text_encoder"}``; prompt_ids and
        uncond_ids ``[B, T]`` CLIP token ids → images ``[B, H, W, 3]`` f32
        in [0, 1].  Latents default to ``generator``'s normal noise (seed
        0 without one) times the scheduler's initial sigma."""
        params = self.prepare(params)
        uc = self.unet.config
        b = np.asarray(prompt_ids).shape[0]
        hh = (height or uc.sample_size * 8) // 8
        ww = (width or uc.sample_size * 8) // 8
        ctx = self.encode_text(params["text_encoder"], prompt_ids,
                               uncond_ids)
        ts = self.scheduler.timesteps(num_steps)
        if latents is None:
            if generator is None:
                generator = torch.Generator(device=self.device)
                generator.manual_seed(0)
            latents = torch.randn((b, hh, ww, uc.in_channels),
                                  generator=generator, device=self.device,
                                  dtype=torch.float32)
            latents = latents * self.scheduler.init_noise_sigma(ts[0])
        latents = torch.as_tensor(latents, dtype=torch.float32,
                                  device=self.device)
        for i, t in enumerate(ts):
            t_prev = int(ts[i + 1]) if i + 1 < len(ts) else -1
            latents = self.unet_step(params["unet"], latents, int(t),
                                     t_prev, ctx, float(guidance))
        images = self.decode(params["vae"], latents)
        return torch.clamp(images * 0.5 + 0.5, 0.0, 1.0)
