"""Checkpoint conversion core: HF/Meta state dicts -> `.m` tensor plan.

Framework-agnostic (numpy in, numpy out) so the parity tests can exercise the
exact same mapping the CLI converters use. Mirrors the reference converter's
tensor plan and Q/K permutation (convert-hf.py:11-14,51-89): HF stores Q/K in
rotate-half rope layout; the `.m` format stores the Meta *interleaved-pair*
layout, related by a per-head even/odd interleave of rows.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from dllama_tpu_torch.models.config import ArchType, HiddenAct, LlamaConfig, RopeType
from dllama_tpu_torch.ops.quant import FloatType, parse_float_type


def permute_rope(w: np.ndarray, n_heads: int) -> np.ndarray:
    """HF rotate-half -> Meta interleaved layout for a [n_heads*hd, in] proj.

    Row-block view per head: [hd/2 "first halves", hd/2 "second halves"] ->
    interleaved (pair i = rows i and i+hd/2). Same transform as
    convert-hf.py:11-14.
    """
    out_dim = w.shape[0]
    return (
        w.reshape(n_heads, 2, out_dim // n_heads // 2, *w.shape[1:])
        .swapaxes(1, 2)
        .reshape(w.shape)
    )


def hf_config_to_llama(config: Mapping, weight_type: FloatType) -> LlamaConfig:
    """HF config.json -> LlamaConfig (mirrors convert-hf.py:152-195)."""
    arch = {
        "llama": ArchType.LLAMA,
        "mistral": ArchType.LLAMA,
        "mixtral": ArchType.LLAMA,
    }.get(config["model_type"])
    if arch is None:
        raise ValueError(f"unsupported arch type: {config['model_type']}")
    act = {"gelu": HiddenAct.GELU, "silu": HiddenAct.SILU}.get(config["hidden_act"])
    if act is None:
        raise ValueError(f"unsupported hidden act: {config['hidden_act']}")
    kwargs = dict(
        arch=arch,
        hidden_act=act,
        dim=config["hidden_size"],
        hidden_dim=config["intermediate_size"],
        n_layers=config["num_hidden_layers"],
        n_heads=config["num_attention_heads"],
        n_kv_heads=config["num_key_value_heads"],
        weight_type=weight_type,
        seq_len=config["max_position_embeddings"],
        vocab_size=config["vocab_size"],
        n_experts=int(config.get("num_local_experts") or 0),
        n_active_experts=int(
            config.get("num_active_local_experts") or config.get("num_experts_per_tok") or 0
        ),
        norm_epsilon=float(config.get("rms_norm_eps", 1e-5)),
    )
    if config.get("rope_theta") is not None:
        kwargs["rope_theta"] = float(config["rope_theta"])
    scaling = config.get("rope_scaling")
    if scaling is not None:
        if scaling.get("rope_type", scaling.get("type")) != "llama3":
            raise ValueError(f"unsupported rope scaling: {scaling}")
        kwargs.update(
            rope_type=RopeType.LLAMA3_1,
            rope_scaling_factor=float(scaling["factor"]),
            rope_scaling_low_freq_factor=float(scaling["low_freq_factor"]),
            rope_scaling_high_freq_factor=float(scaling["high_freq_factor"]),
            rope_scaling_orig_max_seq_len=int(scaling["original_max_position_embeddings"]),
        )
    return LlamaConfig(**kwargs)


# `.m` plan name -> HF tensor name template (convert-hf.py:51-89 order)
HF_NAME_MAP = {
    "embedding": "model.embed_tokens.weight",
    "wq": "model.layers.{l}.self_attn.q_proj.weight",
    "wk": "model.layers.{l}.self_attn.k_proj.weight",
    "wv": "model.layers.{l}.self_attn.v_proj.weight",
    "wo": "model.layers.{l}.self_attn.o_proj.weight",
    "w1": "model.layers.{l}.mlp.gate_proj.weight",
    "w2": "model.layers.{l}.mlp.down_proj.weight",
    "w3": "model.layers.{l}.mlp.up_proj.weight",
    "rms_att": "model.layers.{l}.input_layernorm.weight",
    "rms_ffn": "model.layers.{l}.post_attention_layernorm.weight",
    "final_norm": "model.norm.weight",
    "wcls": "lm_head.weight",
    # Mixtral-style sparse MoE (convert-hf.py:66-73 wrote these tensors too,
    # but the reference runtime never consumed them)
    "moe_gate": "model.layers.{l}.block_sparse_moe.gate.weight",
    "moe_w1": "model.layers.{l}.block_sparse_moe.experts.{e}.w1.weight",
    "moe_w2": "model.layers.{l}.block_sparse_moe.experts.{e}.w2.weight",
    "moe_w3": "model.layers.{l}.block_sparse_moe.experts.{e}.w3.weight",
}


def hf_tensor_for(name: str, cfg: LlamaConfig, get) -> np.ndarray:
    """Fetch + transform the HF tensor for a `.m` plan entry.

    `get(hf_name)` -> np.ndarray. Handles the Q/K rope permutation and tied
    embeddings (lm_head absent => reuse embed_tokens).
    """
    parts = name.split(".")
    if len(parts) == 3:
        _, layer, short = parts
        if short.startswith("moe_") and short != "moe_gate":
            return np.stack(
                [
                    get(HF_NAME_MAP[short].format(l=layer, e=e))
                    for e in range(cfg.n_experts)
                ],
                axis=0,
            )
        hf_name = HF_NAME_MAP[short].format(l=layer)
        x = get(hf_name)
        if short == "wq":
            x = permute_rope(x, cfg.n_heads)
        elif short == "wk":
            x = permute_rope(x, cfg.n_kv_heads)
        return x
    if name == "wcls":
        try:
            return get(HF_NAME_MAP["wcls"])
        except KeyError:
            return get(HF_NAME_MAP["embedding"])  # tied embeddings
    return get(HF_NAME_MAP[name])


def default_output_name(model_dir: str, weight_type_name: str) -> str:
    import os

    base = os.path.basename(os.path.normpath(model_dir)).lower().replace(" ", "-")
    return f"dllama_model_{base}_{weight_type_name.lower()}.m"


def write_model(cfg: LlamaConfig, output: str, get_tensor) -> str:
    """Stream the full tensor plan to `output`: header, then each tensor from
    ``get_tensor(plan_name) -> np.ndarray f32``, shape-checked and quantized
    per the plan. Shared by the HF and Meta converter CLIs."""
    import os
    import time

    from dllama_tpu_torch.models.formats import tensor_plan, write_header, write_tensor

    plan = tensor_plan(cfg)
    t0 = time.time()
    with open(output, "wb") as f:
        write_header(f, cfg)
        for i, (name, shape, ft) in enumerate(plan):
            x = get_tensor(name)
            if tuple(x.shape) != tuple(shape):
                raise ValueError(f"{name}: expected shape {shape}, got {x.shape}")
            nbytes = write_tensor(f, x, ft)
            print(f"💾 [{i + 1}/{len(plan)}] {name} {tuple(shape)} -> {nbytes} bytes", flush=True)
    print(f"✅ Created {output} ({os.path.getsize(output) / 1e9:.2f} GB, {time.time() - t0:.1f}s)")
    return output
