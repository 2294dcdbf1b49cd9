"""Inference engine of the port: weights, ``generate()``, latency stats
and the continuous-batching server.

Counterpart of ``deepspeed_tpu/inference/engine.py`` on one device.
``forward()`` returns full-sequence logits through the uncached forward
(kernel B1 with kernel injection).  ``generate()`` prefills a dense KV
cache through plain attention and then decodes one token at a time; with
kernel injection
(``replace_with_kernel_inject``, the default) the model's attention is
``flash`` and each decode step runs kernel B5 over the cache.  Where the
JAX engine compiles two programs, this one runs eagerly: the prompt
forward plus first sample is timed as TTFT, the remaining steps as
decode latency, both ending in a device synchronise.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..accelerator import resolve_device
from ..models.convert import check_params, leaf_to_torch, tree_map
from ..models.transformer import TransformerLM
from ..utils.logging import logger
from .config import DeepSpeedInferenceConfig
from .sampling import sample_batch


def refuse_out_of_slice(cfg: DeepSpeedInferenceConfig) -> None:
    """Config blocks this slice of the port cannot run."""
    later = []
    if cfg.quant.enabled:
        later.append("quant.enabled (int8 weight-only serving)")
    if cfg.tensor_parallel.enabled and cfg.tensor_parallel.tp_size > 1:
        later.append("tensor_parallel.tp_size > 1 (multi-device)")
    if cfg.moe.enabled:
        later.append("moe.enabled (MoE)")
    if cfg.observability is not None:
        later.append("observability (serving observability hooks)")
    if cfg.checkpoint is not None:
        later.append("checkpoint (checkpoint loading)")
    if later:
        raise NotImplementedError(
            f"{', '.join(later)}: not in the first slice of the PyTorch "
            f"port; see ROADMAP.md queue A for the slice that brings it")


class InferenceEngine:
    def __init__(self, model: TransformerLM,
                 config: Optional[DeepSpeedInferenceConfig] = None,
                 params: Optional[Dict[str, Any]] = None, device=None):
        self.config = config or DeepSpeedInferenceConfig()
        refuse_out_of_slice(self.config)
        self.device = resolve_device(device)
        self.dtype = self.config.compute_dtype()
        # kernel injection: flash routes t == 1 decode through kernel B5,
        # xla keeps plain attention (the JAX engine's rewrite).  The
        # model's activations take the engine's dtype, the dtype of its
        # weights, caches and pools, so the kernels never meet a cast.
        want = "flash" if self.config.replace_with_kernel_inject else "xla"
        if (model.config.attn_impl, model.config.dtype) != (want, self.dtype):
            model = TransformerLM(dataclasses.replace(
                model.config, attn_impl=want, dtype=self.dtype))
        self.module = model
        if params is not None:
            check_params(model, params)
            self.params = tree_map(params, self._cast)
        else:
            logger.warning("init_inference without params — using fresh "
                           "random weights (seed 0)")
            g = torch.Generator(device=self.device)
            g.manual_seed(0)
            self.params = model.init(g, self.device, self.dtype)
        self._latencies: list = []      # per-token DECODE-only seconds
        self._ttfts: list = []          # prefill -> first-token seconds
        self._serving = None

    def _cast(self, x: Any) -> torch.Tensor:
        t = x if isinstance(x, torch.Tensor) else leaf_to_torch(x, "cpu")
        if t.is_floating_point():
            t = t.to(self.dtype)
        return t.to(self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def forward(self, input_ids) -> torch.Tensor:
        """Full-sequence f32 logits ``[B, T, V]`` of ``input_ids [B, T]``
        through the uncached forward (kernel B1 with kernel injection)."""
        ids = (input_ids if isinstance(input_ids, torch.Tensor)
               else torch.as_tensor(np.asarray(input_ids)))
        return self.module.apply(self.params,
                                 ids.to(self.device, torch.int64))

    __call__ = forward

    # ------------------------------------------------------------------
    # generation
    # ------------------------------------------------------------------
    def _prefill(self, ids: torch.Tensor, true_len: int, cache_len: int):
        """Prompt forward into a fresh dense cache → (cache with index at
        the true length, f32 logits of the last true position)."""
        cache = self.module.init_cache(ids.shape[0], cache_len,
                                       dtype=self.dtype, device=self.device)
        logits, cache = self.module.apply(self.params, ids, cache=cache)
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
        for j in range(1, max_new_tokens):
            logits, cache = self.module.apply(self.params, tok[:, None],
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
        sampling key of requests submitted without their own."""
        if draft_model is not None or draft_params is not None:
            raise NotImplementedError(
                "speculative decoding (draft_model, serving.spec_k) is not "
                "in the first slice of the PyTorch port")
        if not self.config.serving.enabled:
            raise ValueError(
                "continuous-batching serving is disabled — set "
                '{"serving": {"enabled": true}} in the inference config')
        if self._serving is None:
            from .serving.engine import ServingEngine
            self._serving = ServingEngine(self, seed=seed)
        return self._serving
