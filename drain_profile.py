#!/usr/bin/env python3
"""Profile the server drains of ``chip_smoke.py`` (phases 5, 8 and 11) on
one CUDA card: each drain's device time and B6's and B7's shares of it.

Run from the root of a checkout::

    python3 drain_profile.py [ROOT]

``ROOT`` (default: this checkout) is the checkout whose
``deepspeed_tpu_torch`` package runs; the serving configuration, the
prompts, the drain and the profile come from this checkout's
``chip_smoke.py``, so two trees are compared on the same work (run parent,
change, change, parent in one call).  Drains: GPT-3 6.7B width (bf16,
random weights from seed 0) over a bf16 pool, then over int8 and int4
pools (``kv_cache_bits`` 8 and 4, the same weights), and TinyLlama-1.1B
over a bf16 pool.  Each engine first drains ``chip_smoke.py``'s 16
requests (32 new tokens each, every request checked) and then profiles
the drain again on fresh prompts of the same lengths
(``chip_smoke.drain_profile``: wall time, device time, busy share, B6's
and B7's device time and launches).
"""
from __future__ import annotations

import gc
import importlib.util
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent


def load_chip_smoke():
    """This checkout's ``chip_smoke.py``, whatever ``ROOT`` holds."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("drain_profile: no CUDA device", file=sys.stderr)
        return 2
    root = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else REPO
    if not (root / "deepspeed_tpu_torch" / "csrc").is_dir():
        print(f"drain_profile: {root} holds no deepspeed_tpu_torch package",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    import numpy as np
    CS = load_chip_smoke()
    from deepspeed_tpu_torch import hf_llama_config, init_inference
    from deepspeed_tpu_torch.accelerator import nvidia_smi_line
    from deepspeed_tpu_torch.models.transformer import (TransformerLM,
                                                        gpt2_config)
    from deepspeed_tpu_torch.module_inject.policies import TINYLLAMA_1_1B
    print(nvidia_smi_line(0))
    print(f"package: {root}")
    params = None
    for label, cfg, bits in (("GPT-3 6.7B", gpt2_config("6.7b"), 0),
                             ("GPT-3 6.7B", gpt2_config("6.7b"), 8),
                             ("GPT-3 6.7B", gpt2_config("6.7b"), 4),
                             ("TinyLlama-1.1B",
                              hf_llama_config(TINYLLAMA_1_1B), 0)):
        if label != "GPT-3 6.7B":
            params = None
        tag = f"{label} kv_cache_bits {bits}"
        eng = init_inference(TransformerLM(cfg), {
            "dtype": "bfloat16", "temperature": 0.0,
            "serving": {**CS.SERVING, "kv_cache_bits": bits}}, params=params)
        params = eng.params
        rng, _, lens, prompts = CS.serving_prompts(np, cfg.vocab_size)
        srv = eng.serving_engine()
        reqs, counts, wall = CS.drain(torch, srv, prompts, tag, bits)
        ntok = sum(len(r.output) for r in reqs)
        print(f"{tag}: drain of {len(prompts)} requests, {ntok} tokens in "
              f"{wall:.2f} s = {ntok / wall:.1f} tokens/s")
        CS.drain_profile(torch, srv, lens, cfg.vocab_size, rng, tag)
        del srv, eng
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
