"""HF / mlx-community Qwen2 and Qwen3 checkpoints -> the port's state dict.

Counterpart of ``whisper_mlx_tpu/checkpoint/qwen_loader.py``: HF-format
safetensors with ``model.layers.N...`` names, fp weights or MLX quantized
exports (``weight`` packed uint32 + ``scales`` + ``biases`` per linear).
HF stores linears ``(out, in)``, the port's layout, so nothing is
transposed; quantized linears become :class:`QuantTensor` with int32 codes
of the same bits and fp32 affines. Tensors land on an explicit device.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from whisper_mlx_tpu_torch.checkpoint.io_util import load_safetensors_dir
from whisper_mlx_tpu_torch.models.qwen import Params, QwenConfig
from whisper_mlx_tpu_torch.ops.quant import QuantTensor, fuse_qwen_projections


def config_from_hf(cfg: Mapping[str, Any]) -> QwenConfig:
    return QwenConfig(
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        num_hidden_layers=cfg["num_hidden_layers"],
        num_attention_heads=cfg["num_attention_heads"],
        num_key_value_heads=cfg.get("num_key_value_heads", cfg["num_attention_heads"]),
        head_dim=cfg.get("head_dim"),
        rope_theta=cfg.get("rope_theta", 1e6),
        rms_norm_eps=cfg.get("rms_norm_eps", 1e-6),
        tie_word_embeddings=cfg.get("tie_word_embeddings", False),
        qk_norm="qwen3" in cfg.get("model_type", ""),
        attention_bias="qwen3" not in cfg.get("model_type", ""),
        max_position_embeddings=cfg.get("max_position_embeddings", 32_768),
    )


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(t)


def convert_hf_qwen_state(state: Mapping[str, Any], config: QwenConfig,
                          quant: dict | None = None, dtype: torch.dtype = torch.float32,
                          device: torch.device | str = "cpu") -> Params:
    sd = {k.removeprefix("model."): v for k, v in state.items()}

    def fp(a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(_np(a), np.float32)).to(device, dtype)

    def packed(tree: Mapping[str, Any], prefix: str) -> QuantTensor:
        words = np.ascontiguousarray(_np(tree[f"{prefix}weight"]).astype(np.uint32))
        return QuantTensor(
            torch.from_numpy(words.view(np.int32)).to(device),
            torch.from_numpy(np.ascontiguousarray(_np(tree[f"{prefix}scales"]), np.float32)).to(device),
            torch.from_numpy(np.ascontiguousarray(_np(tree[f"{prefix}biases"]), np.float32)).to(device),
            quant["bits"], quant["group_size"])

    def linear(prefix: str) -> Params:
        if quant is not None and f"{prefix}.scales" in sd:
            node: Params = {"w": packed(sd, f"{prefix}.")}
        else:
            node = {"w": fp(sd[f"{prefix}.weight"])}
        if f"{prefix}.bias" in sd:
            node["b"] = fp(sd[f"{prefix}.bias"])
        return node

    def layer(i: int) -> Params:
        pre = f"layers.{i}"
        attn: Params = {k: linear(f"{pre}.self_attn.{k}_proj") for k in ("q", "k", "v", "o")}
        if config.qk_norm:
            attn["q_norm"] = fp(sd[f"{pre}.self_attn.q_norm.weight"])
            attn["k_norm"] = fp(sd[f"{pre}.self_attn.k_norm.weight"])
        return {
            "input_ln": fp(sd[f"{pre}.input_layernorm.weight"]),
            "attn": attn,
            "post_ln": fp(sd[f"{pre}.post_attention_layernorm.weight"]),
            "mlp": {k: linear(f"{pre}.mlp.{k}_proj") for k in ("gate", "up", "down")},
        }

    if quant is not None and "embed_tokens.scales" in sd:
        embed = packed(sd, "embed_tokens.")
    else:
        embed = fp(sd["embed_tokens.weight"])
    params: Params = {
        "embed": embed,
        "layers": [layer(i) for i in range(config.num_hidden_layers)],
        "final_ln": fp(sd["norm.weight"]),
    }
    if not config.tie_word_embeddings:
        if "lm_head.weight" in state or "lm_head.scales" in state:
            sd_lm = {k.removeprefix("lm_head."): v for k, v in state.items()
                     if k.startswith("lm_head.")}
            if quant is not None and "scales" in sd_lm:
                params["lm_head"] = {"w": packed(sd_lm, "")}
            else:
                params["lm_head"] = {"w": fp(sd_lm["weight"])}
        else:  # the checkpoint ties although the config does not
            params["lm_head"] = {"w": fp(sd["embed_tokens.weight"])}
    return params


def load_qwen(model_dir: str | Path, dtype: torch.dtype = torch.float32,
              device: torch.device | str = "cpu",
              fuse_projections: bool = True) -> tuple[Params, QwenConfig]:
    """Config and params from a checkpoint directory onto ``device``;
    quantized checkpoints get fused ``qkv`` / ``gate_up`` projections."""
    model_dir = Path(model_dir)
    cfg = json.loads((model_dir / "config.json").read_text())
    config = config_from_hf(cfg)
    quant = cfg.get("quantization")
    params = convert_hf_qwen_state(load_safetensors_dir(model_dir), config, quant, dtype, device)
    if fuse_projections and quant is not None:
        params = fuse_qwen_projections(params)
    return params, config
