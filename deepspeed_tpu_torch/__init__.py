"""deepspeed_tpu_torch — the PyTorch/CUDA port of ``deepspeed_tpu``.

A second package beside the JAX one, for one NVIDIA H100: the same
config JSON and entry points, plain PyTorch around kernels written by
hand for Hopper (``csrc/``, built with ``nvcc`` at first use).  It never
imports ``jax`` or ``deepspeed_tpu``.  Entry points run on the card
unless the caller passes ``device="cpu"``, which runs each kernel's
plain PyTorch version instead.

Serving: ``init_inference`` → ``generate()``, ``forward()`` and the
continuous-batching server (``serving_engine(draft_model=...)`` arms
speculative decoding; ``inference.serving.ServingFrontend`` adds
multi-tenant fairness, SLO alerts and token streaming).  Both engines
take the ``observability`` block (``observability/``: span tracer,
metrics, request tracer, overlap profiler, flight recorder).  Training: ``initialize`` →
``engine.train_step`` / ``train_batch`` (and the compat
``forward``/``backward``/``step``).  Both for every model family of
the JAX package's ``module_inject/policies.py``: GPT-2/GPT-3, GPT-NeoX
(``neox_config``), GPT-J, OPT, BLOOM, GPT-Neo, LLaMA, and the encoders
BERT and DistilBERT (``forward()`` and training; no ``generate()``).
The ``hf_*_config`` functions map a Hugging Face config (an object or a
``config.json`` dict), and ``convert_hf_model`` a whole Hugging Face
model (its config and state dict) to ``(TransformerConfig, params)``.
Mixture-of-Experts models (``moe_num_experts``) train and serve through
the same entry points on one card; ``init_diffusion`` builds the Stable
Diffusion pipeline (UNet, VAE, CLIP text).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

from .comm import init_distributed
from .inference.config import DeepSpeedInferenceConfig
from .inference.engine import InferenceEngine
from .models.transformer import (TransformerConfig, TransformerLM,
                                 gpt2_config, neox_config)
from .module_inject.policies import (convert_hf_model, hf_bert_config,
                                     hf_bloom_config, hf_distilbert_config,
                                     hf_gpt2_config, hf_gptj_config,
                                     hf_gptneo_config, hf_llama_config,
                                     hf_neox_config, hf_opt_config)
from .moe import MoEConfig, MoELayer
from .parallel.topology import pp_world_size
from .runtime.config import DeepSpeedConfig
from .runtime.dataloader import DeepSpeedDataLoader, RepeatingLoader
from .runtime.engine import DeepSpeedEngine, config_mesh

__all__ = ["DeepSpeedConfig", "DeepSpeedDataLoader", "DeepSpeedEngine",
           "DeepSpeedInferenceConfig", "InferenceEngine", "MoEConfig",
           "MoELayer", "RepeatingLoader", "TransformerConfig",
           "TransformerLM", "convert_hf_model", "gpt2_config",
           "hf_bert_config", "hf_bloom_config", "hf_distilbert_config",
           "hf_gpt2_config", "hf_gptj_config", "hf_gptneo_config",
           "hf_llama_config", "hf_neox_config", "hf_opt_config",
           "init_diffusion", "init_distributed", "init_inference",
           "initialize", "neox_config"]


def initialize(args: Any = None, model: Any = None, optimizer: Any = None,
               model_parameters: Any = None, training_data: Any = None,
               lr_scheduler: Any = None, collate_fn: Any = None,
               config: Any = None, config_params: Any = None,
               loss_fn: Any = None, params: Optional[Dict[str, Any]] = None,
               device=None, seed: int = 0,
               dist_init_required: Optional[bool] = None,
               dist_backend: str = "nccl", mesh: Any = None) -> Tuple:
    """Build a training engine (``deepspeed_tpu.initialize``'s
    counterpart) and return ``(engine, optimizer, dataloader,
    lr_schedule)``.  ``params`` seeds the masters (see
    ``models/convert.py``), else the model's init runs from ``seed``
    (every rank the same); ``device`` defaults to this rank's card,
    ``cuda:{LOCAL_RANK}``, and raises if it does not exist.
    ``dist_init_required`` calls ``init_distributed(dist_backend)``
    first, as the JAX ``initialize`` does; ranks that share one card
    pass ``device="cuda:0"`` and ``dist_backend="gloo"``.  ``mesh`` (a
    ``parallel.topology.ProcessMesh``) overrides the one the config's
    ``mesh`` block (and ``tensor_parallel``) builds; a mesh whose
    ``pipe`` axis is 2 or more gives a ``runtime.pipe.engine.
    PipelineEngine``."""
    del model_parameters  # params are part of the engine state
    if config is None:
        config = config_params
    if config is None and args is not None:
        config = getattr(args, "deepspeed_config", None)
    if model is None:
        raise ValueError("deepspeed_tpu_torch.initialize requires a model")
    if dist_init_required:
        init_distributed(dist_backend)
    ds_config = (config if isinstance(config, DeepSpeedConfig)
                 else DeepSpeedConfig(config or {}))
    # the engine rides the topology: a mesh whose pipe axis is 2 or more
    # (given, or built from the config's mesh block) trains under the
    # pipeline schedule; no separate entry point
    ds_config.refuse_out_of_slice()
    mesh = config_mesh(ds_config, mesh)
    engine_cls = DeepSpeedEngine
    if pp_world_size(mesh) >= 2:
        from .runtime.pipe.engine import PipelineEngine
        engine_cls = PipelineEngine
    engine = engine_cls(model=model, config=ds_config,
                        optimizer=optimizer, lr_scheduler=lr_scheduler,
                        loss_fn=loss_fn, params=params, device=device,
                        seed=seed, mesh=mesh)
    dataloader = None
    if training_data is not None:
        dataloader = DeepSpeedDataLoader(
            training_data, batch_size=engine.train_batch_size,
            collate_fn=collate_fn,
            data_parallel_rank=engine.dp_rank,
            data_parallel_world_size=engine.dp_world_size,
            gradient_accumulation_steps=engine.gradient_accumulation_steps)
    return engine, engine.optimizer, dataloader, engine.lr_schedule


def init_inference(model: TransformerLM,
                   config: Union[None, Dict[str, Any],
                                 DeepSpeedInferenceConfig] = None,
                   params: Optional[Dict[str, Any]] = None,
                   device=None, mesh: Any = None,
                   **kwargs) -> InferenceEngine:
    """Build an inference engine (``deepspeed_tpu.init_inference``'s
    counterpart): ``config`` is the JSON dict (keyword arguments merge
    into it); ``params`` an explicit weights tree (see
    ``models/convert.py``), else fresh weights from seed 0; ``device``
    defaults to the CUDA card and raises if there is none.
    ``tensor_parallel.tp_size`` or ``serving.mesh`` build this rank's
    (data, model) mesh over ``torch.distributed``'s world; ``mesh`` (a
    ``ProcessMesh`` with ``data`` and ``model`` axes) gives it
    instead."""
    if isinstance(config, DeepSpeedInferenceConfig):
        if kwargs:
            raise ValueError("keyword overrides need a dict config")
        cfg = config
    else:
        cfg_dict = dict(config) if isinstance(config, dict) else {}
        cfg_dict.update(kwargs)
        cfg = DeepSpeedInferenceConfig.from_dict(cfg_dict)
    return InferenceEngine(model, cfg, params=params, device=device,
                           mesh=mesh)


def init_diffusion(unet_config=None, vae_config=None, text_config=None,
                   state_dicts: Optional[Dict[str, Any]] = None,
                   params: Optional[Dict[str, Any]] = None, scheduler=None,
                   device=None, dtype: Any = None, seed: int = 0):
    """Build a Stable-Diffusion-class pipeline
    (``deepspeed_tpu.init_diffusion``'s counterpart) → ``(pipeline,
    params)``.  ``state_dicts`` may hold any of "unet" / "vae" /
    "text_encoder" as HF-named checkpoints (diffusers / transformers
    names; another key raises); missing parts come from ``params`` (the
    JAX layout) or a fresh init from ``seed`` on the device.  ``device``
    defaults to the CUDA card and raises if there is none; ``dtype``
    (default float32) is the modules' compute dtype.  The returned
    params are prepared once for ``F.conv2d`` on that device."""
    import torch
    from .accelerator import resolve_device
    from .models.diffusion import (AutoencoderKL, CLIPTextConfig,
                                   CLIPTextEncoder, StableDiffusionPipeline,
                                   UNet2DCondition, UNetConfig, VAEConfig,
                                   to_torch_tree)
    from .module_inject import diffusion_policies as pol
    dev = resolve_device(device)
    unet = UNet2DCondition(unet_config or UNetConfig())
    vae = AutoencoderKL(vae_config or VAEConfig())
    text = CLIPTextEncoder(text_config or CLIPTextConfig())
    sds = state_dicts or {}
    unknown = set(sds) - {"unet", "vae", "text_encoder"}
    if unknown:
        raise ValueError(
            f"init_diffusion: unknown state_dicts entries {sorted(unknown)}"
            f" — expected a subset of ['unet', 'vae', 'text_encoder'] "
            f"(refusing a silent partial load)")
    params = {k: to_torch_tree(v) for k, v in (params or {}).items()}
    loaders = {"unet": (pol.load_unet, unet), "vae": (pol.load_vae, vae),
               "text_encoder": (pol.load_clip_text, text)}
    for name, sd in sds.items():
        load, mod = loaders[name]
        params[name] = load(mod.config, sd)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    for name, (_, mod) in loaders.items():
        if name not in params:
            params[name] = mod.init(g, dev)
    pipe = StableDiffusionPipeline(unet, vae, text, scheduler=scheduler,
                                   device=dev,
                                   dtype=dtype or torch.float32)
    return pipe, pipe.prepare(params)
