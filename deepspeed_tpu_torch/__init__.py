"""deepspeed_tpu_torch — the PyTorch/CUDA port of ``deepspeed_tpu``.

A second package beside the JAX one, for one NVIDIA H100: the same
config JSON and entry points, plain PyTorch around kernels written by
hand for Hopper (``csrc/``, built with ``nvcc`` at first use).  It never
imports ``jax`` or ``deepspeed_tpu``.  Entry points run on the card
unless the caller passes ``device="cpu"``, which runs each kernel's
plain PyTorch version instead.

This first slice serves: ``init_inference`` → ``generate()`` and the
continuous-batching server, for the GPT-2/GPT-3 model family.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

from .inference.config import DeepSpeedInferenceConfig
from .inference.engine import InferenceEngine
from .models.transformer import TransformerConfig, TransformerLM, gpt2_config

__all__ = ["DeepSpeedInferenceConfig", "InferenceEngine",
           "TransformerConfig", "TransformerLM", "gpt2_config",
           "init_inference"]


def init_inference(model: TransformerLM,
                   config: Union[None, Dict[str, Any],
                                 DeepSpeedInferenceConfig] = None,
                   params: Optional[Dict[str, Any]] = None,
                   device=None, **kwargs) -> InferenceEngine:
    """Build an inference engine (``deepspeed_tpu.init_inference``'s
    counterpart): ``config`` is the JSON dict (keyword arguments merge
    into it); ``params`` an explicit weights tree (see
    ``models/convert.py``), else fresh weights from seed 0; ``device``
    defaults to the CUDA card and raises if there is none."""
    if isinstance(config, DeepSpeedInferenceConfig):
        if kwargs:
            raise ValueError("keyword overrides need a dict config")
        cfg = config
    else:
        cfg_dict = dict(config) if isinstance(config, dict) else {}
        cfg_dict.update(kwargs)
        cfg = DeepSpeedInferenceConfig.from_dict(cfg_dict)
    return InferenceEngine(model, cfg, params=params, device=device)
