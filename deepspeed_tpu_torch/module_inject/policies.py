"""Weight-injection policies: Hugging Face LLaMA configs and state dicts
→ the port's ``TransformerConfig`` and params tree.

Counterpart of ``deepspeed_tpu/module_inject/policies.py``
(``hf_llama_config``, ``load_hf_llama``, ``_map_act``).  No
``transformers`` import: a config is any object with the Hugging Face
attribute names (a ``types.SimpleNamespace``, a ``LlamaConfig``) or a
dict read from a ``config.json``; a state dict maps the Hugging Face
parameter names to torch tensors.  Conversion is data movement only:
torch ``Linear`` weights ``[out, in]`` transpose to the tree's
``[in, out]``, q | k | v concatenate into the fused projection, and
gate / up / down become ``fc_gate`` / ``fc_in`` / ``fc_out``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..models.transformer import TransformerConfig

#: TinyLlama-1.1B as published: Hugging Face
#: ``TinyLlama/TinyLlama-1.1B-intermediate-step-1431k-3T``, ``config.json``
#: (the keys the conversion reads)
TINYLLAMA_1_1B = {
    "model_type": "llama",
    "architectures": ["LlamaForCausalLM"],
    "hidden_act": "silu",
    "hidden_size": 2048,
    "intermediate_size": 5632,
    "max_position_embeddings": 2048,
    "num_attention_heads": 32,
    "num_hidden_layers": 22,
    "num_key_value_heads": 4,
    "rms_norm_eps": 1e-05,
    "rope_scaling": None,
    "rope_theta": 10000.0,
    "tie_word_embeddings": False,
    "vocab_size": 32000,
}

_MISSING = object()


def _field(cfg: Any, name: str, default: Any = _MISSING) -> Any:
    """``cfg.name`` or ``cfg[name]`` for a dict; ``default`` when absent
    (required when no default is given)."""
    if isinstance(cfg, dict):
        if name in cfg:
            return cfg[name]
    elif hasattr(cfg, name):
        return getattr(cfg, name)
    if default is _MISSING:
        raise KeyError(f"Hugging Face config has no {name!r}")
    return default


def _map_act(hf_act: str) -> str:
    """HF activation name → ``ACT_FNS`` key.  HF 'gelu' is the EXACT erf
    GeLU; 'gelu_new'/'gelu_fast'/'gelu_pytorch_tanh' are tanh
    approximations."""
    table = {"gelu": "gelu_exact", "gelu_new": "gelu", "gelu_fast": "gelu",
             "gelu_pytorch_tanh": "gelu", "relu": "relu", "silu": "silu"}
    if hf_act not in table:
        raise ValueError(f"Unsupported HF activation {hf_act!r}")
    return table[hf_act]


def hf_llama_config(hf_cfg: Any, **overrides) -> TransformerConfig:
    """A Hugging Face LLaMA config → ``TransformerConfig``: RMSNorm,
    SwiGLU gated MLP, full-dim rotate-half rotary, no biases, untied head
    unless the config ties it.  Grouped-query attention
    (``num_key_value_heads`` < heads) maps to ``num_kv_heads``;
    ``rope_scaling`` and bias-carrying checkpoints are refused (converting
    them would yield silently wrong logits)."""
    heads = _field(hf_cfg, "num_attention_heads")
    nkv = _field(hf_cfg, "num_key_value_heads", heads)
    rope_scaling = _field(hf_cfg, "rope_scaling", None)
    if rope_scaling:
        raise NotImplementedError(
            f"rope_scaling={rope_scaling!r} (Llama-3 / long-context "
            f"RoPE rescaling) is not implemented — converting without it "
            f"would yield silently wrong logits")
    if _field(hf_cfg, "attention_bias", False):
        raise NotImplementedError(
            "attention_bias=True checkpoints carry q/k/v biases this "
            "no-bias conversion would drop")
    if _field(hf_cfg, "mlp_bias", False):
        raise NotImplementedError(
            "mlp_bias=True checkpoints carry gate/up/down biases this "
            "no-bias conversion would drop")
    return TransformerConfig(
        vocab_size=_field(hf_cfg, "vocab_size"),
        max_seq_len=_field(hf_cfg, "max_position_embeddings"),
        num_layers=_field(hf_cfg, "num_hidden_layers"),
        num_heads=heads,
        num_kv_heads=(0 if nkv == heads else nkv),
        head_dim=_field(hf_cfg, "head_dim", None) or 0,
        d_model=_field(hf_cfg, "hidden_size"),
        d_ff=_field(hf_cfg, "intermediate_size"),
        pos_embedding="rotary",
        rotary_pct=1.0,
        rotary_base=_field(hf_cfg, "rope_theta", 10000.0),
        rotary_interleaved=False,     # HF llama rotate_half
        parallel_residual=False,
        norm_type="rmsnorm",
        activation=_map_act(_field(hf_cfg, "hidden_act")),
        gated_mlp=True,
        use_bias=False,
        tie_embeddings=bool(_field(hf_cfg, "tie_word_embeddings", False)),
        layernorm_eps=_field(hf_cfg, "rms_norm_eps"),
        **overrides)


def load_hf_llama(state_dict: Dict[str, torch.Tensor],
                  config: TransformerConfig) -> Dict[str, Any]:
    """A Hugging Face LLaMA state dict (torch tensors) → the port's params
    tree as float32 CPU tensors (torch kernels transpose; q|k|v
    concatenate into the fused layout; gate/up/down → fc_gate/fc_in/
    fc_out).  ``init_inference(params=...)`` or ``initialize(params=...)``
    place it on the engine's device."""
    sd = {k.replace("model.", "", 1): v for k, v in state_dict.items()}
    n = config.num_layers

    def f32(t):
        return t.detach().to("cpu", torch.float32)

    def t(name, i):
        return f32(sd[f"layers.{i}.{name}.weight"]).t()

    def stack(fn):
        return torch.stack([fn(i) for i in range(n)]).contiguous()

    def qkv(i):
        return torch.cat([t("self_attn.q_proj", i), t("self_attn.k_proj", i),
                          t("self_attn.v_proj", i)], dim=-1)

    def blk_t(name):
        return stack(lambda i: t(name, i))

    def blk_norm(name):
        return stack(lambda i: f32(sd[f"layers.{i}.{name}.weight"]))

    params = {
        "embed": {"embedding": f32(sd["embed_tokens.weight"]).clone()},
        "blocks": {
            "ln1": {"scale": blk_norm("input_layernorm")},
            "attn": {
                "qkv": {"kernel": stack(qkv)},
                "out": {"kernel": blk_t("self_attn.o_proj")},
            },
            "ln2": {"scale": blk_norm("post_attention_layernorm")},
            "mlp": {
                "fc_gate": {"kernel": blk_t("mlp.gate_proj")},
                "fc_in": {"kernel": blk_t("mlp.up_proj")},
                "fc_out": {"kernel": blk_t("mlp.down_proj")},
            },
        },
        "ln_f": {"scale": f32(sd["norm.weight"]).clone()},
    }
    if not config.tie_embeddings:
        params["lm_head"] = {"kernel": f32(
            state_dict["lm_head.weight"]).t().contiguous()}
    return params
