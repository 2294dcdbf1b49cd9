"""Weight-injection policies: Hugging Face configs and state dicts of
every model family → the port's ``TransformerConfig`` and params tree.

Counterpart of ``deepspeed_tpu/module_inject/policies.py``: GPT-2,
GPT-NeoX, OPT, BLOOM, BERT, LLaMA, GPT-J, DistilBERT and GPT-Neo, the
``POLICIES`` registry and ``convert_hf_model``.  No ``transformers``
import: a config is any object with the Hugging Face attribute names (a
``types.SimpleNamespace``, a ``transformers`` config) or a dict read
from a ``config.json``; a model is anything with ``.config`` (its
``model_type`` selects the policy) and ``.state_dict()``; a state dict
maps the Hugging Face parameter names to torch tensors or numpy arrays.
Conversion is data movement only, to float32 CPU tensors: torch
``Linear`` weights ``[out, in]`` transpose to the tree's ``[in, out]``
(GPT-2's ``Conv1D`` weights are ``[in, out]`` already), separate q / k / v
concatenate into the fused projection, and the per-head fused qkv of
NeoX and BLOOM (``[h, 3, hd]`` along the output) regroups to ``[3, h,
hd]``.  ``init_inference(params=...)`` or ``initialize(params=...)``
place the tree on the engine's device.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from ..models.transformer import TransformerConfig
from ..utils.interop import to_f32 as _f32

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

#: GPT-NeoX-20B as published: Hugging Face ``EleutherAI/gpt-neox-20b``,
#: ``config.json`` (the keys the conversion reads)
GPT_NEOX_20B = {
    "model_type": "gpt_neox",
    "architectures": ["GPTNeoXForCausalLM"],
    "hidden_act": "gelu_fast",
    "hidden_size": 6144,
    "intermediate_size": 24576,
    "layer_norm_eps": 1e-05,
    "max_position_embeddings": 2048,
    "num_attention_heads": 64,
    "num_hidden_layers": 44,
    "rotary_emb_base": 10000,
    "rotary_pct": 0.25,
    "tie_word_embeddings": False,
    "vocab_size": 50432,
    # not in the published file: the GPTNeoXConfig default it takes
    "use_parallel_residual": True,
}

#: BERT-large as published: Hugging Face ``bert-large-uncased``,
#: ``config.json`` (the keys the conversion reads)
BERT_LARGE_UNCASED = {
    "model_type": "bert",
    "architectures": ["BertForMaskedLM"],
    "hidden_act": "gelu",
    "hidden_size": 1024,
    "intermediate_size": 4096,
    "layer_norm_eps": 1e-12,
    "max_position_embeddings": 512,
    "num_attention_heads": 16,
    "num_hidden_layers": 24,
    "type_vocab_size": 2,
    "vocab_size": 30522,
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


def _stack(sd: Dict[str, Any], fmt: str, n: int) -> torch.Tensor:
    """``sd[fmt.format(i=i)]`` of every layer, stacked on a leading layer
    axis, as float32."""
    return torch.stack([_f32(sd[fmt.format(i=i)]) for i in range(n)])


def _lin_t(w: Any) -> torch.Tensor:
    """A torch ``Linear`` weight ``[out, in]`` as the tree's ``[in,
    out]``."""
    return _f32(w).t().contiguous()


def _stack_t(sd: Dict[str, Any], fmt: str, n: int) -> torch.Tensor:
    """Layer ``i``'s ``Linear`` ``fmt.format(i=i) + ".weight"``,
    transposed to ``[in, out]`` and stacked."""
    return _stack(sd, fmt + ".weight", n).transpose(1, 2).contiguous()


def _dense(sd: Dict[str, Any], fmt: str, n: int) -> Dict[str, Any]:
    """A stacked ``Linear``: kernel ``[L, in, out]`` and bias."""
    return {"kernel": _stack_t(sd, fmt, n),
            "bias": _stack(sd, fmt + ".bias", n)}


def _norm(sd: Dict[str, Any], fmt: str, n: int = 0) -> Dict[str, Any]:
    """A LayerNorm's ``weight`` and ``bias`` as ``scale`` and ``bias``:
    stacked over ``n`` layers, or one (``n`` 0)."""
    if n:
        return {"scale": _stack(sd, fmt + ".weight", n),
                "bias": _stack(sd, fmt + ".bias", n)}
    return {"scale": _f32(sd[fmt + ".weight"]),
            "bias": _f32(sd[fmt + ".bias"])}


def _qkv_cat(sd: Dict[str, Any], fmt: str, n: int,
             names=("q", "k", "v"), bias: bool = False) -> torch.Tensor:
    """Separate q / k / v ``Linear``s (``fmt`` with ``{}`` replaced by
    each of ``names``) fused into the tree's q | k | v projection: the
    kernels ``[L, in, (H + 2 KVH) D]``, or with ``bias`` the biases."""
    if bias:
        return torch.cat([_stack(sd, fmt.replace("{}", x) + ".bias", n)
                          for x in names], dim=-1)
    return torch.cat([_stack_t(sd, fmt.replace("{}", x), n)
                      for x in names], dim=-1)


def _per_head_qkv(sd: Dict[str, Any], fmt: str, n: int,
                  config: TransformerConfig) -> Dict[str, Any]:
    """NeoX's and BLOOM's fused qkv ``Linear`` (``[h, 3, hd]`` along its
    output) regrouped to the tree's ``[3, h, hd]``: kernel ``[L, D, 3 h
    hd]`` and bias ``[L, 3 h hd]``."""
    nh, hd, d = config.num_heads, config.hdim, config.d_model
    w = _stack(sd, fmt + ".weight", n)                  # [L, 3 h hd, D]
    w = (w.reshape(n, nh, 3, hd, d).permute(0, 4, 2, 1, 3)
         .reshape(n, d, 3 * nh * hd))
    b = _stack(sd, fmt + ".bias", n)
    b = b.reshape(n, nh, 3, hd).permute(0, 2, 1, 3).reshape(n, 3 * nh * hd)
    return {"kernel": w.contiguous(), "bias": b.contiguous()}


def _strip(state_dict: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    return {k.replace(prefix, ""): v for k, v in state_dict.items()}


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


def load_hf_llama(state_dict: Dict[str, Any],
                  config: TransformerConfig) -> Dict[str, Any]:
    """A Hugging Face LLaMA state dict → the port's params tree (torch
    kernels transpose; q|k|v concatenate into the fused layout; gate/up/
    down → fc_gate/fc_in/fc_out)."""
    sd = {k.replace("model.", "", 1): v for k, v in state_dict.items()}
    n = config.num_layers
    pre = "layers.{i}."
    params = {
        "embed": {"embedding": _f32(sd["embed_tokens.weight"])},
        "blocks": {
            "ln1": {"scale": _stack(sd, pre + "input_layernorm.weight", n)},
            "attn": {
                "qkv": {"kernel": _qkv_cat(sd, pre + "self_attn.{}_proj", n)},
                "out": {"kernel": _stack_t(sd, pre + "self_attn.o_proj", n)},
            },
            "ln2": {"scale": _stack(
                sd, pre + "post_attention_layernorm.weight", n)},
            "mlp": {
                "fc_gate": {"kernel": _stack_t(sd, pre + "mlp.gate_proj", n)},
                "fc_in": {"kernel": _stack_t(sd, pre + "mlp.up_proj", n)},
                "fc_out": {"kernel": _stack_t(sd, pre + "mlp.down_proj", n)},
            },
        },
        "ln_f": {"scale": _f32(sd["norm.weight"])},
    }
    if not config.tie_embeddings:
        params["lm_head"] = {"kernel": _lin_t(state_dict["lm_head.weight"])}
    return params


def _blocks(ln1, qkv, out, ln2, fc_in, fc_out) -> Dict[str, Any]:
    return {"ln1": ln1, "attn": {"qkv": qkv, "out": out}, "ln2": ln2,
            "mlp": {"fc_in": fc_in, "fc_out": fc_out}}


def hf_gpt2_config(hf_cfg: Any, **overrides) -> TransformerConfig:
    """A Hugging Face GPT-2 config → ``TransformerConfig``."""
    return TransformerConfig(
        vocab_size=_field(hf_cfg, "vocab_size"),
        max_seq_len=_field(hf_cfg, "n_positions"),
        num_layers=_field(hf_cfg, "n_layer"),
        num_heads=_field(hf_cfg, "n_head"),
        d_model=_field(hf_cfg, "n_embd"),
        pos_embedding="learned",
        parallel_residual=False,
        norm_type="layernorm",
        activation=_map_act(_field(hf_cfg, "activation_function")),
        use_bias=True,
        tie_embeddings=True,
        layernorm_eps=_field(hf_cfg, "layer_norm_epsilon"),
        **overrides)


def load_hf_gpt2(state_dict: Dict[str, Any],
                 config: TransformerConfig) -> Dict[str, Any]:
    """A Hugging Face GPT-2 state dict → params.  Its ``Conv1D`` weights
    are ``[in, out]`` already and ``c_attn`` is q | k | v along its
    output, the tree's layout: nothing transposes."""
    sd = _strip(state_dict, "transformer.")
    n = config.num_layers

    def conv(name):
        return {"kernel": _stack(sd, f"h.{{i}}.{name}.weight", n),
                "bias": _stack(sd, f"h.{{i}}.{name}.bias", n)}
    return {
        "embed": {"embedding": _f32(sd["wte.weight"])},
        "pos_embed": {"embedding": _f32(sd["wpe.weight"])},
        "blocks": _blocks(_norm(sd, "h.{i}.ln_1", n), conv("attn.c_attn"),
                          conv("attn.c_proj"), _norm(sd, "h.{i}.ln_2", n),
                          conv("mlp.c_fc"), conv("mlp.c_proj")),
        "ln_f": _norm(sd, "ln_f"),
    }


def hf_neox_config(hf_cfg: Any, **overrides) -> TransformerConfig:
    """A Hugging Face GPT-NeoX config → ``TransformerConfig``: partial
    rotate-half rotary, parallel residual (``use_parallel_residual``,
    default True as in ``GPTNeoXConfig``), untied head."""
    return TransformerConfig(
        vocab_size=_field(hf_cfg, "vocab_size"),
        max_seq_len=_field(hf_cfg, "max_position_embeddings"),
        num_layers=_field(hf_cfg, "num_hidden_layers"),
        num_heads=_field(hf_cfg, "num_attention_heads"),
        d_model=_field(hf_cfg, "hidden_size"),
        d_ff=_field(hf_cfg, "intermediate_size"),
        pos_embedding="rotary",
        rotary_pct=_field(hf_cfg, "rotary_pct"),
        rotary_base=_field(hf_cfg, "rotary_emb_base", 10000.0),
        rotary_interleaved=False,     # HF GPTNeoX uses rotate_half
        parallel_residual=_field(hf_cfg, "use_parallel_residual", True),
        norm_type="layernorm",
        activation=_map_act(_field(hf_cfg, "hidden_act")),
        use_bias=True,
        tie_embeddings=False,
        layernorm_eps=_field(hf_cfg, "layer_norm_eps"),
        **overrides)


def load_hf_neox(state_dict: Dict[str, Any],
                 config: TransformerConfig) -> Dict[str, Any]:
    """A Hugging Face GPT-NeoX state dict → params: ``Linear``s
    transpose, the per-head fused qkv regroups to q | k | v."""
    sd = _strip(state_dict, "gpt_neox.")
    n = config.num_layers
    pre = "layers.{i}."
    return {
        "embed": {"embedding": _f32(sd["embed_in.weight"])},
        "blocks": _blocks(
            _norm(sd, pre + "input_layernorm", n),
            _per_head_qkv(sd, pre + "attention.query_key_value", n, config),
            _dense(sd, pre + "attention.dense", n),
            _norm(sd, pre + "post_attention_layernorm", n),
            _dense(sd, pre + "mlp.dense_h_to_4h", n),
            _dense(sd, pre + "mlp.dense_4h_to_h", n)),
        "ln_f": _norm(sd, "final_layer_norm"),
        "lm_head": {"kernel": _lin_t(state_dict["embed_out.weight"])},
    }


def hf_opt_config(hf_cfg: Any, **overrides) -> TransformerConfig:
    """A Hugging Face OPT config → ``TransformerConfig`` (GPT-2's
    architecture with its own ``ffn_dim`` and activation); the post-norm
    350m variant (``do_layer_norm_before=False``) is refused."""
    if not _field(hf_cfg, "do_layer_norm_before", True):
        raise ValueError("OPT with do_layer_norm_before=False (350m "
                         "post-norm variant) is not supported")
    return TransformerConfig(
        vocab_size=_field(hf_cfg, "vocab_size"),
        max_seq_len=_field(hf_cfg, "max_position_embeddings"),
        num_layers=_field(hf_cfg, "num_hidden_layers"),
        num_heads=_field(hf_cfg, "num_attention_heads"),
        d_model=_field(hf_cfg, "hidden_size"),
        d_ff=_field(hf_cfg, "ffn_dim"),
        pos_embedding="learned",
        parallel_residual=False,
        norm_type="layernorm",
        activation=_map_act(_field(hf_cfg, "activation_function")),
        use_bias=True,
        tie_embeddings=True,
        layernorm_eps=1e-5,
        **overrides)


def load_hf_opt(state_dict: Dict[str, Any],
                config: TransformerConfig) -> Dict[str, Any]:
    """A Hugging Face OPT state dict → params: ``Linear``s transpose, the
    separate q / k / v fuse, and the position table drops its first two
    rows (``OPTLearnedPositionalEmbedding`` offsets positions by 2)."""
    sd = _strip(state_dict, "model.decoder.")
    n = config.num_layers
    pre = "layers.{i}."
    qkv = pre + "self_attn.{}_proj"
    return {
        "embed": {"embedding": _f32(sd["embed_tokens.weight"])},
        "pos_embed": {"embedding": _f32(
            sd["embed_positions.weight"])[2:].contiguous()},
        "blocks": _blocks(
            _norm(sd, pre + "self_attn_layer_norm", n),
            {"kernel": _qkv_cat(sd, qkv, n),
             "bias": _qkv_cat(sd, qkv, n, bias=True)},
            _dense(sd, pre + "self_attn.out_proj", n),
            _norm(sd, pre + "final_layer_norm", n),
            _dense(sd, pre + "fc1", n), _dense(sd, pre + "fc2", n)),
        "ln_f": _norm(sd, "final_layer_norm"),
    }


def hf_bloom_config(hf_cfg: Any, **overrides) -> TransformerConfig:
    """A Hugging Face BLOOM config → ``TransformerConfig``: ALiBi
    positions and the embedding layernorm."""
    return TransformerConfig(
        vocab_size=_field(hf_cfg, "vocab_size"),
        max_seq_len=2048,
        num_layers=_field(hf_cfg, "n_layer"),
        num_heads=_field(hf_cfg, "n_head"),
        d_model=_field(hf_cfg, "hidden_size"),
        pos_embedding="alibi",
        embed_layernorm=True,
        parallel_residual=False,
        norm_type="layernorm",
        activation="gelu",            # BloomGelu is the tanh approximation
        use_bias=True,
        tie_embeddings=True,
        layernorm_eps=_field(hf_cfg, "layer_norm_epsilon"),
        **overrides)


def load_hf_bloom(state_dict: Dict[str, Any],
                  config: TransformerConfig) -> Dict[str, Any]:
    """A Hugging Face BLOOM state dict → params: ``Linear``s transpose,
    the per-head fused qkv regroups to q | k | v."""
    sd = _strip(state_dict, "transformer.")
    n = config.num_layers
    pre = "h.{i}."
    return {
        "embed": {"embedding": _f32(sd["word_embeddings.weight"])},
        "ln_embed": _norm(sd, "word_embeddings_layernorm"),
        "blocks": _blocks(
            _norm(sd, pre + "input_layernorm", n),
            _per_head_qkv(sd, pre + "self_attention.query_key_value", n,
                          config),
            _dense(sd, pre + "self_attention.dense", n),
            _norm(sd, pre + "post_attention_layernorm", n),
            _dense(sd, pre + "mlp.dense_h_to_4h", n),
            _dense(sd, pre + "mlp.dense_4h_to_h", n)),
        "ln_f": _norm(sd, "ln_f"),
    }


def hf_bert_config(hf_cfg: Any, **overrides) -> TransformerConfig:
    """A Hugging Face BERT config → ``TransformerConfig``: a
    bidirectional post-norm encoder with token types, the embedding
    layernorm and the MLM head, no final norm."""
    return TransformerConfig(
        vocab_size=_field(hf_cfg, "vocab_size"),
        max_seq_len=_field(hf_cfg, "max_position_embeddings"),
        num_layers=_field(hf_cfg, "num_hidden_layers"),
        num_heads=_field(hf_cfg, "num_attention_heads"),
        d_model=_field(hf_cfg, "hidden_size"),
        d_ff=_field(hf_cfg, "intermediate_size"),
        pos_embedding="learned",
        causal=False,
        norm_position="post",
        final_layernorm=False,
        embed_layernorm=True,
        token_type_vocab=_field(hf_cfg, "type_vocab_size"),
        mlm_head=True,
        norm_type="layernorm",
        activation=_map_act(_field(hf_cfg, "hidden_act")),
        use_bias=True,
        tie_embeddings=True,
        layernorm_eps=_field(hf_cfg, "layer_norm_eps"),
        **overrides)


def _mlm_head(state_dict, dense: str, ln: str, bias: str) -> Dict[str, Any]:
    return {"dense": {"kernel": _lin_t(state_dict[dense + ".weight"]),
                      "bias": _f32(state_dict[dense + ".bias"])},
            "ln": _norm(state_dict, ln), "bias": _f32(state_dict[bias])}


def load_hf_bert(state_dict: Dict[str, Any],
                 config: TransformerConfig) -> Dict[str, Any]:
    """A Hugging Face ``BertForMaskedLM`` state dict → params: q / k / v
    fuse, ``attention.output.LayerNorm`` → ``ln1`` and
    ``output.LayerNorm`` → ``ln2`` (post-norm), the prediction head's
    transform and bias → ``mlm_head``."""
    sd = _strip(state_dict, "bert.")
    n = config.num_layers
    pre = "encoder.layer.{i}."
    qkv = pre + "attention.self.{}"
    return {
        "embed": {"embedding": _f32(sd["embeddings.word_embeddings.weight"])},
        "pos_embed": {"embedding": _f32(
            sd["embeddings.position_embeddings.weight"])},
        "type_embed": {"embedding": _f32(
            sd["embeddings.token_type_embeddings.weight"])},
        "ln_embed": _norm(sd, "embeddings.LayerNorm"),
        "blocks": _blocks(
            _norm(sd, pre + "attention.output.LayerNorm", n),
            {"kernel": _qkv_cat(sd, qkv, n, ("query", "key", "value")),
             "bias": _qkv_cat(sd, qkv, n, ("query", "key", "value"),
                              bias=True)},
            _dense(sd, pre + "attention.output.dense", n),
            _norm(sd, pre + "output.LayerNorm", n),
            _dense(sd, pre + "intermediate.dense", n),
            _dense(sd, pre + "output.dense", n)),
        "mlm_head": _mlm_head(state_dict, "cls.predictions.transform.dense",
                              "cls.predictions.transform.LayerNorm",
                              "cls.predictions.bias"),
    }


def hf_gptj_config(hf_cfg: Any, **overrides) -> TransformerConfig:
    """A Hugging Face GPT-J config → ``TransformerConfig``: partial
    interleaved rotary, the single-layernorm parallel residual (ln_1
    feeds attention and MLP: loaded as equal ``ln1`` and ``ln2``), no
    attention biases (loaded as zeros), an untied head with a bias."""
    n_embd, n_head = _field(hf_cfg, "n_embd"), _field(hf_cfg, "n_head")
    return TransformerConfig(
        vocab_size=_field(hf_cfg, "vocab_size"),
        max_seq_len=_field(hf_cfg, "n_positions"),
        num_layers=_field(hf_cfg, "n_layer"),
        num_heads=n_head,
        d_model=n_embd,
        d_ff=(_field(hf_cfg, "n_inner", None) or 4 * n_embd),
        pos_embedding="rotary",
        rotary_pct=_field(hf_cfg, "rotary_dim") / (n_embd // n_head),
        rotary_interleaved=True,      # GPT-J rotates every two
        parallel_residual=True,
        norm_type="layernorm",
        activation=_map_act(_field(hf_cfg, "activation_function")),
        use_bias=True,
        tie_embeddings=False,
        layernorm_eps=_field(hf_cfg, "layer_norm_epsilon"),
        **overrides)


def load_hf_gptj(state_dict: Dict[str, Any],
                 config: TransformerConfig) -> Dict[str, Any]:
    """A Hugging Face GPT-J state dict → params (``lm_head.bias``
    included)."""
    sd = _strip(state_dict, "transformer.")
    n, d = config.num_layers, config.d_model
    pre = "h.{i}."
    ln = _norm(sd, pre + "ln_1", n)
    return {
        "embed": {"embedding": _f32(sd["wte.weight"])},
        "blocks": _blocks(
            ln,
            {"kernel": _qkv_cat(sd, pre + "attn.{}_proj", n),
             "bias": torch.zeros(n, 3 * d)},
            {"kernel": _stack_t(sd, pre + "attn.out_proj", n),
             "bias": torch.zeros(n, d)},
            # single-LN parallel residual: ln2 := ln_1 (same input x)
            {k: v.clone() for k, v in ln.items()},
            _dense(sd, pre + "mlp.fc_in", n),
            _dense(sd, pre + "mlp.fc_out", n)),
        "ln_f": _norm(sd, "ln_f"),
        "lm_head": {"kernel": _lin_t(state_dict["lm_head.weight"]),
                    "bias": _f32(state_dict["lm_head.bias"])},
    }


def hf_distilbert_config(hf_cfg: Any, **overrides) -> TransformerConfig:
    """A Hugging Face DistilBERT config → ``TransformerConfig``: BERT's
    post-norm encoder without token types, the MLM head tied to the word
    embeddings; sinusoidal positions are refused."""
    if _field(hf_cfg, "sinusoidal_pos_embds", False):
        raise NotImplementedError(
            "DistilBERT with sinusoidal_pos_embds: only the learned-"
            "position variant (the published checkpoints) is mapped")
    return TransformerConfig(
        vocab_size=_field(hf_cfg, "vocab_size"),
        max_seq_len=_field(hf_cfg, "max_position_embeddings"),
        num_layers=_field(hf_cfg, "n_layers"),
        num_heads=_field(hf_cfg, "n_heads"),
        d_model=_field(hf_cfg, "dim"),
        d_ff=_field(hf_cfg, "hidden_dim"),
        pos_embedding="learned",
        causal=False,
        norm_position="post",
        final_layernorm=False,
        embed_layernorm=True,
        mlm_head=True,
        norm_type="layernorm",
        activation=_map_act(_field(hf_cfg, "activation")),
        use_bias=True,
        tie_embeddings=True,
        layernorm_eps=1e-12,
        **overrides)


def load_hf_distilbert(state_dict: Dict[str, Any],
                       config: TransformerConfig) -> Dict[str, Any]:
    """A Hugging Face ``DistilBertForMaskedLM`` state dict → params."""
    sd = _strip(state_dict, "distilbert.")
    n = config.num_layers
    pre = "transformer.layer.{i}."
    qkv = pre + "attention.{}_lin"
    return {
        "embed": {"embedding": _f32(sd["embeddings.word_embeddings.weight"])},
        "pos_embed": {"embedding": _f32(
            sd["embeddings.position_embeddings.weight"])},
        "ln_embed": _norm(sd, "embeddings.LayerNorm"),
        "blocks": _blocks(
            _norm(sd, pre + "sa_layer_norm", n),
            {"kernel": _qkv_cat(sd, qkv, n),
             "bias": _qkv_cat(sd, qkv, n, bias=True)},
            _dense(sd, pre + "attention.out_lin", n),
            _norm(sd, pre + "output_layer_norm", n),
            _dense(sd, pre + "ffn.lin1", n), _dense(sd, pre + "ffn.lin2", n)),
        "mlm_head": _mlm_head(state_dict, "vocab_transform",
                              "vocab_layer_norm", "vocab_projector.bias"),
    }


def _gptneo_layers(hf_cfg: Any) -> Tuple[str, ...]:
    """GPT-Neo's per-layer pattern: ``attention_layers``, or its
    ``config.json`` form ``attention_types`` ([[pattern, repeats], ...])
    expanded as ``GPTNeoConfig`` does."""
    layers = _field(hf_cfg, "attention_layers", None)
    if layers is None:
        layers = [kind for pattern, reps in _field(hf_cfg, "attention_types")
                  for _ in range(reps) for kind in pattern]
    return tuple(layers)


def hf_gptneo_config(hf_cfg: Any, **overrides) -> TransformerConfig:
    """A Hugging Face GPT-Neo config → ``TransformerConfig``: the
    unscaled softmax (``attn_softmax_scale`` 1.0) and the global/local
    pattern (``attention_layers`` with ``window_size``), both on plain
    attention (``attn_impl="xla"``)."""
    hidden = _field(hf_cfg, "hidden_size")
    return TransformerConfig(
        vocab_size=_field(hf_cfg, "vocab_size"),
        max_seq_len=_field(hf_cfg, "max_position_embeddings"),
        num_layers=_field(hf_cfg, "num_layers"),
        num_heads=_field(hf_cfg, "num_heads"),
        d_model=hidden,
        d_ff=_field(hf_cfg, "intermediate_size", None) or 4 * hidden,
        pos_embedding="learned",
        parallel_residual=False,
        norm_type="layernorm",
        activation=_map_act(_field(hf_cfg, "activation_function")),
        use_bias=True,
        tie_embeddings=True,
        layernorm_eps=_field(hf_cfg, "layer_norm_epsilon"),
        attn_softmax_scale=1.0,
        attention_layers=_gptneo_layers(hf_cfg),
        local_attention_window=_field(hf_cfg, "window_size"),
        attn_impl="xla",
        **overrides)


def load_hf_gptneo(state_dict: Dict[str, Any],
                   config: TransformerConfig) -> Dict[str, Any]:
    """A Hugging Face GPT-Neo state dict → params: every projection is a
    ``Linear`` (transposed); q / k / v carry no bias (the fused bias is
    zeros)."""
    sd = _strip(state_dict, "transformer.")
    n, d = config.num_layers, config.d_model
    pre = "h.{i}."
    return {
        "embed": {"embedding": _f32(sd["wte.weight"])},
        "pos_embed": {"embedding": _f32(sd["wpe.weight"])},
        "blocks": _blocks(
            _norm(sd, pre + "ln_1", n),
            {"kernel": _qkv_cat(sd, pre + "attn.attention.{}_proj", n),
             "bias": torch.zeros(n, 3 * d)},
            _dense(sd, pre + "attn.attention.out_proj", n),
            _norm(sd, pre + "ln_2", n),
            _dense(sd, pre + "mlp.c_fc", n),
            _dense(sd, pre + "mlp.c_proj", n)),
        "ln_f": _norm(sd, "ln_f"),
    }


#: model_type → (config mapping, state-dict loader), the JAX package's
#: registry
POLICIES: Dict[str, Tuple[Callable, Callable]] = {
    "gpt2": (hf_gpt2_config, load_hf_gpt2),
    "gpt_neox": (hf_neox_config, load_hf_neox),
    "opt": (hf_opt_config, load_hf_opt),
    "bloom": (hf_bloom_config, load_hf_bloom),
    "bert": (hf_bert_config, load_hf_bert),
    "llama": (hf_llama_config, load_hf_llama),
    "gptj": (hf_gptj_config, load_hf_gptj),
    "distilbert": (hf_distilbert_config, load_hf_distilbert),
    "gpt_neo": (hf_gptneo_config, load_hf_gptneo),
}


def convert_hf_model(hf_model: Any, **config_overrides
                     ) -> Tuple[TransformerConfig, Dict[str, Any]]:
    """A Hugging Face model (anything with ``.config``, whose
    ``model_type`` picks the policy, and ``.state_dict()``) →
    ``(TransformerConfig, params)``."""
    mtype = _field(hf_model.config, "model_type")
    if mtype not in POLICIES:
        raise ValueError(
            f"No policy for model_type={mtype!r}; have {list(POLICIES)}")
    cfg_fn, load_fn = POLICIES[mtype]
    cfg = cfg_fn(hf_model.config, **config_overrides)
    return cfg, load_fn(hf_model.state_dict(), cfg)
