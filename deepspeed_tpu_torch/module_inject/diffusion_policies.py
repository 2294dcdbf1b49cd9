"""HF diffusers/transformers checkpoints into the diffusion family's trees.

Counterpart of ``deepspeed_tpu/module_inject/diffusion_policies.py``: a
flat ``state_dict`` (torch tensors of any dtype and device, or numpy
arrays, by the published diffusers/transformers names) is re-laid-out
into the trees of ``models/diffusion.py``: torch's OIHW convs become
HWIO, ``Linear`` ``[out, in]`` becomes ``[in, out]``.  Every key must
be consumed and every key the architecture needs must be present, or the
loader raises (a misspelled mapping that silently drops weights is the
classic injection bug).  Leaves keep their source dtype, as CPU tensors
of their own.

Entry points::

    load_unet(config, state_dict)       -> UNet2DCondition params
    load_vae(config, state_dict)        -> AutoencoderKL params
    load_clip_text(config, state_dict)  -> CLIPTextEncoder params
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..utils.interop import to_tensor


class _SD:
    """State-dict view with presence tracking, so unconsumed keys are a
    loud error."""

    def __init__(self, sd: Dict[str, Any], prefix: str = ""):
        self.sd = dict(sd)
        self.used = set()
        self.prefix = prefix

    def has(self, name: str) -> bool:
        return self.prefix + name in self.sd

    def take(self, name: str) -> torch.Tensor:
        key = self.prefix + name
        if key not in self.sd:
            raise KeyError(
                f"checkpoint missing '{key}' — state dict does not match "
                f"the configured architecture")
        self.used.add(key)
        return to_tensor(self.sd[key])

    def check_consumed(self, ignore=()) -> None:
        left = [k for k in self.sd
                if k not in self.used
                and not any(k.startswith(i) for i in ignore)]
        if left:
            raise ValueError(
                f"{len(left)} checkpoint tensors were not consumed by the "
                f"policy (first: {left[:5]}) — refusing a silent partial "
                f"load")


def _hwio(w: torch.Tensor) -> torch.Tensor:
    return w.permute(2, 3, 1, 0).contiguous()


def _conv(sd: _SD, name: str) -> Dict:
    return {"kernel": _hwio(sd.take(f"{name}.weight")),      # from OIHW
            "bias": sd.take(f"{name}.bias")}


def _linear(sd: _SD, name: str, bias: bool = True) -> Dict:
    p = {"kernel": sd.take(f"{name}.weight").t().contiguous()}
    if bias:
        p["bias"] = sd.take(f"{name}.bias")
    return p


def _linear_or_conv1x1(sd: _SD, name: str) -> Dict:
    """SD1's proj_in/proj_out and the old VAE attention store 1x1 convs
    where newer checkpoints store ``Linear``: accept both, emit conv
    params."""
    w = sd.take(f"{name}.weight")
    b = sd.take(f"{name}.bias")
    if w.dim() == 4:
        return {"kernel": _hwio(w), "bias": b}
    return {"kernel": w.t().contiguous()[None, None], "bias": b}


def _norm(sd: _SD, name: str) -> Dict:
    return {"scale": sd.take(f"{name}.weight"),
            "bias": sd.take(f"{name}.bias")}


def _resnet(sd: _SD, name: str, temb: bool) -> Dict:
    p = {"norm1": _norm(sd, f"{name}.norm1"),
         "conv1": _conv(sd, f"{name}.conv1"),
         "norm2": _norm(sd, f"{name}.norm2"),
         "conv2": _conv(sd, f"{name}.conv2")}
    if temb and sd.has(f"{name}.time_emb_proj.weight"):
        p["time_emb_proj"] = _linear(sd, f"{name}.time_emb_proj")
    if sd.has(f"{name}.conv_shortcut.weight"):
        p["conv_shortcut"] = _conv(sd, f"{name}.conv_shortcut")
    elif sd.has(f"{name}.nin_shortcut.weight"):       # old VAE naming
        p["conv_shortcut"] = _conv(sd, f"{name}.nin_shortcut")
    return p


def _cross_attn(sd: _SD, name: str) -> Dict:
    return {"to_q": _linear(sd, f"{name}.to_q", bias=False),
            "to_k": _linear(sd, f"{name}.to_k", bias=False),
            "to_v": _linear(sd, f"{name}.to_v", bias=False),
            "to_out": _linear(sd, f"{name}.to_out.0")}


def _tblock(sd: _SD, name: str) -> Dict:
    return {"norm1": _norm(sd, f"{name}.norm1"),
            "attn1": _cross_attn(sd, f"{name}.attn1"),
            "norm2": _norm(sd, f"{name}.norm2"),
            "attn2": _cross_attn(sd, f"{name}.attn2"),
            "norm3": _norm(sd, f"{name}.norm3"),
            "ff": {"proj_in": _linear(sd, f"{name}.ff.net.0.proj"),
                   "proj_out": _linear(sd, f"{name}.ff.net.2")}}


def _transformer2d(sd: _SD, name: str, depth: int) -> Dict:
    return {"norm": _norm(sd, f"{name}.norm"),
            "proj_in": _linear_or_conv1x1(sd, f"{name}.proj_in"),
            "blocks": [_tblock(sd, f"{name}.transformer_blocks.{k}")
                       for k in range(depth)],
            "proj_out": _linear_or_conv1x1(sd, f"{name}.proj_out")}


# ---------------------------------------------------------------------------
# UNet
# ---------------------------------------------------------------------------
def load_unet(config, state_dict: Dict[str, Any]) -> Dict:
    """diffusers ``UNet2DConditionModel`` state dict → ``UNet2DCondition``
    params."""
    c = config
    sd = _SD(state_dict)
    p: Dict[str, Any] = {
        "conv_in": _conv(sd, "conv_in"),
        "time_embedding": {
            "linear_1": _linear(sd, "time_embedding.linear_1"),
            "linear_2": _linear(sd, "time_embedding.linear_2")},
    }
    downs = []
    for bi, btype in enumerate(c.down_block_types):
        blk = {"resnets": [], "attentions": []}
        for li in range(c.layers_per_block):
            blk["resnets"].append(
                _resnet(sd, f"down_blocks.{bi}.resnets.{li}", True))
            if btype == "CrossAttnDownBlock2D":
                blk["attentions"].append(_transformer2d(
                    sd, f"down_blocks.{bi}.attentions.{li}",
                    c.transformer_depth))
        if sd.has(f"down_blocks.{bi}.downsamplers.0.conv.weight"):
            blk["downsample"] = _conv(
                sd, f"down_blocks.{bi}.downsamplers.0.conv")
        downs.append(blk)
    p["down_blocks"] = downs
    p["mid_block"] = {
        "resnets": [_resnet(sd, "mid_block.resnets.0", True),
                    _resnet(sd, "mid_block.resnets.1", True)],
        "attentions": [_transformer2d(sd, "mid_block.attentions.0",
                                      c.transformer_depth)],
    }
    ups = []
    for bi, btype in enumerate(c.up_block_types):
        blk = {"resnets": [], "attentions": []}
        for li in range(c.layers_per_block + 1):
            blk["resnets"].append(
                _resnet(sd, f"up_blocks.{bi}.resnets.{li}", True))
            if btype == "CrossAttnUpBlock2D":
                blk["attentions"].append(_transformer2d(
                    sd, f"up_blocks.{bi}.attentions.{li}",
                    c.transformer_depth))
        if sd.has(f"up_blocks.{bi}.upsamplers.0.conv.weight"):
            blk["upsample"] = _conv(sd, f"up_blocks.{bi}.upsamplers.0.conv")
        ups.append(blk)
    p["up_blocks"] = ups
    p["conv_norm_out"] = _norm(sd, "conv_norm_out")
    p["conv_out"] = _conv(sd, "conv_out")
    sd.check_consumed()
    return p


# ---------------------------------------------------------------------------
# VAE
# ---------------------------------------------------------------------------
def _vae_attn(sd: _SD, name: str) -> Dict:
    if sd.has(f"{name}.to_q.weight"):      # modern diffusers Attention
        names = ("group_norm", "to_q", "to_k", "to_v", "to_out.0")
    else:                                  # pre-refactor diffusers
        names = ("group_norm", "query", "key", "value", "proj_attn")

    def lin(n):
        w = sd.take(f"{name}.{n}.weight")
        if w.dim() == 4:                   # 1x1 conv form
            w = w[:, :, 0, 0]
        return {"kernel": w.t().contiguous(),
                "bias": sd.take(f"{name}.{n}.bias")}
    return {"group_norm": _norm(sd, f"{name}.{names[0]}"),
            "to_q": lin(names[1]), "to_k": lin(names[2]),
            "to_v": lin(names[3]), "to_out": lin(names[4])}


def _vae_mid(sd: _SD, name: str) -> Dict:
    return {"resnets": [_resnet(sd, f"{name}.resnets.0", False),
                        _resnet(sd, f"{name}.resnets.1", False)],
            "attentions": [_vae_attn(sd, f"{name}.attentions.0")]}


def load_vae(config, state_dict: Dict[str, Any]) -> Dict:
    """diffusers ``AutoencoderKL`` state dict → ``AutoencoderKL``
    params."""
    c = config
    sd = _SD(state_dict)
    n_blocks = len(c.block_out_channels)
    enc: Dict[str, Any] = {"conv_in": _conv(sd, "encoder.conv_in"),
                           "down_blocks": []}
    for bi in range(n_blocks):
        blk = {"resnets": [
            _resnet(sd, f"encoder.down_blocks.{bi}.resnets.{li}", False)
            for li in range(c.layers_per_block)]}
        if sd.has(f"encoder.down_blocks.{bi}.downsamplers.0.conv.weight"):
            blk["downsample"] = _conv(
                sd, f"encoder.down_blocks.{bi}.downsamplers.0.conv")
        enc["down_blocks"].append(blk)
    enc["mid_block"] = _vae_mid(sd, "encoder.mid_block")
    enc["conv_norm_out"] = _norm(sd, "encoder.conv_norm_out")
    enc["conv_out"] = _conv(sd, "encoder.conv_out")

    dec: Dict[str, Any] = {"conv_in": _conv(sd, "decoder.conv_in"),
                           "mid_block": _vae_mid(sd, "decoder.mid_block"),
                           "up_blocks": []}
    for bi in range(n_blocks):
        blk = {"resnets": [
            _resnet(sd, f"decoder.up_blocks.{bi}.resnets.{li}", False)
            for li in range(c.layers_per_block + 1)]}
        if sd.has(f"decoder.up_blocks.{bi}.upsamplers.0.conv.weight"):
            blk["upsample"] = _conv(
                sd, f"decoder.up_blocks.{bi}.upsamplers.0.conv")
        dec["up_blocks"].append(blk)
    dec["conv_norm_out"] = _norm(sd, "decoder.conv_norm_out")
    dec["conv_out"] = _conv(sd, "decoder.conv_out")
    out = {"encoder": enc, "decoder": dec,
           "quant_conv": _conv(sd, "quant_conv"),
           "post_quant_conv": _conv(sd, "post_quant_conv")}
    sd.check_consumed()
    return out


# ---------------------------------------------------------------------------
# CLIP text
# ---------------------------------------------------------------------------
def load_clip_text(config, state_dict: Dict[str, Any]) -> Dict:
    """transformers ``CLIPTextModel`` state dict (with or without the
    ``text_model.`` prefix) → ``CLIPTextEncoder`` params."""
    pre = ("text_model."
           if any(k.startswith("text_model.") for k in state_dict) else "")
    sd = _SD(state_dict, prefix=pre)
    p = {"token_embedding": {"embedding": sd.take(
            "embeddings.token_embedding.weight")},
         "position_embedding": {"embedding": sd.take(
             "embeddings.position_embedding.weight")},
         "final_layer_norm": _norm(sd, "final_layer_norm"),
         "layers": []}
    for i in range(config.num_hidden_layers):
        base = f"encoder.layers.{i}"
        p["layers"].append({
            "layer_norm1": _norm(sd, f"{base}.layer_norm1"),
            "q_proj": _linear(sd, f"{base}.self_attn.q_proj"),
            "k_proj": _linear(sd, f"{base}.self_attn.k_proj"),
            "v_proj": _linear(sd, f"{base}.self_attn.v_proj"),
            "out_proj": _linear(sd, f"{base}.self_attn.out_proj"),
            "layer_norm2": _norm(sd, f"{base}.layer_norm2"),
            "fc1": _linear(sd, f"{base}.mlp.fc1"),
            "fc2": _linear(sd, f"{base}.mlp.fc2"),
        })
    sd.check_consumed(ignore=(pre + "embeddings.position_ids",))
    return p
