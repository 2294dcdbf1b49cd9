"""TiledLinear: one large linear split into tiles.

Counterpart of ``deepspeed_tpu/runtime/zero/tiling.py`` (the reference's
``TiledLinear``, ``runtime/zero/tiling.py:27``, which splits a huge
``nn.Linear`` so that ZeRO-3 gathers one tile at a time).  The params
are a grid of kernel tiles ``[in_splits, out_splits, tile_in,
tile_out]`` (the JAX layout, so a JAX tree applies unchanged) and an
optional bias; ``apply`` walks the input tiles in a Python loop, where
the JAX one runs ``lax.scan``, summing each tile row's partial product.
"""
from __future__ import annotations

from typing import Dict

import torch

from ...models import layers as L


class TiledLinear:
    def __init__(self, in_features: int, out_features: int,
                 in_splits: int = 1, out_splits: int = 1,
                 use_bias: bool = True):
        if in_features % in_splits or out_features % out_splits:
            raise ValueError(
                f"splits must divide features: {in_features}/{in_splits}, "
                f"{out_features}/{out_splits}")
        self.in_features = in_features
        self.out_features = out_features
        self.in_splits = in_splits
        self.out_splits = out_splits
        self.use_bias = use_bias
        self.tile_in = in_features // in_splits
        self.tile_out = out_features // out_splits

    def init(self, generator: torch.Generator, device=None,
             dtype=torch.float32) -> Dict[str, torch.Tensor]:
        """Tiles drawn from Normal(0, 0.02), the bias zero."""
        p = {"kernel": L.normal_init(
            (self.in_splits, self.out_splits, self.tile_in, self.tile_out),
            0.02, generator, device, dtype)}
        if self.use_bias:
            p["bias"] = torch.zeros(self.out_features, dtype=dtype,
                                    device=device)
        return p

    def apply(self, params: Dict[str, torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
        """x ``[..., in]`` → ``[..., out]``: one input tile (one row of
        kernel tiles) at a time."""
        lead = x.shape[:-1]
        xt = x.reshape(*lead, self.in_splits, self.tile_in)
        out = torch.zeros(*lead, self.out_features, dtype=x.dtype,
                          device=x.device)
        for i in range(self.in_splits):
            kt = params["kernel"][i].to(x.dtype)     # [out_splits, ti, to]
            part = torch.einsum("...i,oit->...ot", xt[..., i, :], kt)
            out = out + part.reshape(*lead, self.out_features)
        if self.use_bias:
            out = out + params["bias"].to(out.dtype)
        return out
