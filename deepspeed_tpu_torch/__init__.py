"""deepspeed_tpu_torch — the PyTorch/CUDA port of ``deepspeed_tpu``.

A second package beside the JAX one, for one NVIDIA H100: the same
config JSON and entry points, plain PyTorch around kernels written by
hand for Hopper (``csrc/``, built with ``nvcc`` at first use).  It never
imports ``jax`` or ``deepspeed_tpu``.  Entry points run on the card
unless the caller passes ``device="cpu"``, which runs each kernel's
plain PyTorch version instead.

Serving: ``init_inference`` → ``generate()``, ``forward()`` and the
continuous-batching server.  Training: ``initialize`` →
``engine.train_step`` / ``train_batch`` (and the compat
``forward``/``backward``/``step``).  Both for the GPT-2/GPT-3 model
family.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

from .inference.config import DeepSpeedInferenceConfig
from .inference.engine import InferenceEngine
from .models.transformer import TransformerConfig, TransformerLM, gpt2_config
from .runtime.config import DeepSpeedConfig
from .runtime.dataloader import DeepSpeedDataLoader, RepeatingLoader
from .runtime.engine import DeepSpeedEngine

__all__ = ["DeepSpeedConfig", "DeepSpeedDataLoader", "DeepSpeedEngine",
           "DeepSpeedInferenceConfig", "InferenceEngine", "RepeatingLoader",
           "TransformerConfig", "TransformerLM", "gpt2_config",
           "init_inference", "initialize"]


def initialize(args: Any = None, model: Any = None, optimizer: Any = None,
               model_parameters: Any = None, training_data: Any = None,
               lr_scheduler: Any = None, collate_fn: Any = None,
               config: Any = None, config_params: Any = None,
               loss_fn: Any = None, params: Optional[Dict[str, Any]] = None,
               device=None, seed: int = 0) -> Tuple:
    """Build a training engine (``deepspeed_tpu.initialize``'s
    counterpart) and return ``(engine, optimizer, dataloader,
    lr_schedule)``.  ``params`` seeds the masters (see
    ``models/convert.py``), else the model's init runs from ``seed``;
    ``device`` defaults to the CUDA card and raises if there is none."""
    del model_parameters  # params are part of the engine state
    if config is None:
        config = config_params
    if config is None and args is not None:
        config = getattr(args, "deepspeed_config", None)
    if model is None:
        raise ValueError("deepspeed_tpu_torch.initialize requires a model")
    ds_config = (config if isinstance(config, DeepSpeedConfig)
                 else DeepSpeedConfig(config or {}))
    engine = DeepSpeedEngine(model=model, config=ds_config,
                             optimizer=optimizer, lr_scheduler=lr_scheduler,
                             loss_fn=loss_fn, params=params, device=device,
                             seed=seed)
    dataloader = None
    if training_data is not None:
        dataloader = DeepSpeedDataLoader(
            training_data, batch_size=engine.train_batch_size,
            collate_fn=collate_fn)
    return engine, engine.optimizer, dataloader, engine.lr_schedule


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
