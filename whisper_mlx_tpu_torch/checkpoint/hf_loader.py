"""HF-format Whisper checkpoints -> the port's tree.

Counterpart of ``whisper_mlx_tpu/checkpoint/hf_loader.py``:
:func:`convert_hf_whisper_state` maps a HuggingFace ``WhisperModel`` /
``WhisperForConditionalGeneration`` state dict (torch tensors or numpy
arrays) onto the port's tree, and :func:`load_whisper` reads a local model
directory (``config.json`` and ``*.safetensors``). HF stores linears
``(out, in)`` and convs ``(out, in, k)``, the port's layouts, so nothing is
transposed. The mlx-community quantized format is ``quant_loader.py``'s.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from whisper_mlx_tpu_torch.checkpoint.io_util import load_safetensors_dir
from whisper_mlx_tpu_torch.models.whisper import Params, WhisperConfig


def config_from_hf(hf_config: Mapping[str, Any]) -> WhisperConfig:
    return WhisperConfig(
        n_mels=hf_config["num_mel_bins"],
        n_vocab=hf_config["vocab_size"],
        n_audio_ctx=hf_config.get("max_source_positions", 1500),
        n_audio_state=hf_config["d_model"],
        n_audio_head=hf_config["encoder_attention_heads"],
        n_audio_layer=hf_config["encoder_layers"],
        n_text_ctx=hf_config.get("max_target_positions", 448),
        n_text_state=hf_config["d_model"],
        n_text_head=hf_config["decoder_attention_heads"],
        n_text_layer=hf_config["decoder_layers"],
    )


def to_tensor(t, dtype: torch.dtype, device) -> torch.Tensor:
    """torch tensor or numpy array -> a tensor of ``dtype`` on ``device``."""
    if not isinstance(t, torch.Tensor):
        t = torch.from_numpy(np.array(t, order="C"))  # a copy: safetensors buffers are read-only
    return t.detach().to(device, dtype)


def convert_hf_whisper_state(state: Mapping[str, Any], config: WhisperConfig,
                             dtype: torch.dtype = torch.float32,
                             device: torch.device | str = "cpu") -> Params:
    """HF ``model.{encoder,decoder}...`` state dict -> the port's tree."""
    sd = {re.sub(r"^model\.", "", k): v for k, v in state.items()}

    def t(name: str) -> torch.Tensor:
        return to_tensor(sd[name], dtype, device)

    def dense(prefix: str, bias: bool = True) -> Params:
        p = {"w": t(f"{prefix}.weight")}
        if bias:
            p["b"] = t(f"{prefix}.bias")
        return p

    def ln(prefix: str) -> Params:
        return {"g": t(f"{prefix}.weight"), "b": t(f"{prefix}.bias")}

    def attn(prefix: str) -> Params:
        return {"q": dense(f"{prefix}.q_proj"), "k": dense(f"{prefix}.k_proj", bias=False),
                "v": dense(f"{prefix}.v_proj"), "o": dense(f"{prefix}.out_proj")}

    def block(pre: str, cross: bool) -> Params:
        blk = {"attn_ln": ln(f"{pre}.self_attn_layer_norm"),
               "attn": attn(f"{pre}.self_attn"),
               "mlp_ln": ln(f"{pre}.final_layer_norm"),
               "mlp": {"fc1": dense(f"{pre}.fc1"), "fc2": dense(f"{pre}.fc2")}}
        if cross:
            blk["cross_attn_ln"] = ln(f"{pre}.encoder_attn_layer_norm")
            blk["cross_attn"] = attn(f"{pre}.encoder_attn")
        return blk

    return {
        "encoder": {
            "conv1": dense("encoder.conv1"),
            "conv2": dense("encoder.conv2"),
            "pos_emb": t("encoder.embed_positions.weight"),
            "blocks": [block(f"encoder.layers.{i}", cross=False)
                       for i in range(config.n_audio_layer)],
            "ln_post": ln("encoder.layer_norm"),
        },
        "decoder": {
            "token_emb": t("decoder.embed_tokens.weight"),
            "pos_emb": t("decoder.embed_positions.weight"),
            "blocks": [block(f"decoder.layers.{i}", cross=True)
                       for i in range(config.n_text_layer)],
            "ln": ln("decoder.layer_norm"),
        },
    }


def load_whisper(model_dir: str | Path, dtype: torch.dtype = torch.float32,
                 device: torch.device | str = "cpu") -> tuple[Params, WhisperConfig]:
    """Load a local HF Whisper directory (config.json + safetensors shards)."""
    model_dir = Path(model_dir)
    config = config_from_hf(json.loads((model_dir / "config.json").read_text()))
    return convert_hf_whisper_state(load_safetensors_dir(model_dir), config, dtype, device), config
