"""OpenAI-format Whisper checkpoints (the original ``.pt`` files) -> the
port's tree.

Counterpart of ``whisper_mlx_tpu/checkpoint/openai_loader.py``: the
research release stores ``{"dims": {...}, "model_state_dict": {...}}`` with
module names ``encoder.blocks.N.attn.{query,key,value,out}`` /
``mlp.{0,2}``, linears ``(out, in)`` and convs ``(out, in, k)``, the port's
layouts. The encoder's sinusoid table is stored
(``encoder.positional_embedding``) and loaded as it is.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Mapping

import torch

from whisper_mlx_tpu_torch.checkpoint.hf_loader import to_tensor
from whisper_mlx_tpu_torch.models.whisper import Params, WhisperConfig

_DIMS = ("n_mels", "n_vocab", "n_audio_ctx", "n_audio_state", "n_audio_head", "n_audio_layer",
         "n_text_ctx", "n_text_state", "n_text_head", "n_text_layer")


def config_from_dims(dims: Mapping[str, Any]) -> WhisperConfig:
    return WhisperConfig(**{name: dims[name] for name in _DIMS})


def convert_openai_state(sd: Mapping[str, Any], config: WhisperConfig,
                         dtype: torch.dtype = torch.float32,
                         device: torch.device | str = "cpu") -> Params:
    def t(name: str) -> torch.Tensor:
        return to_tensor(sd[name], dtype, device)

    def dense(prefix: str) -> Params:
        node = {"w": t(f"{prefix}.weight")}
        if f"{prefix}.bias" in sd:
            node["b"] = t(f"{prefix}.bias")
        return node

    def ln(prefix: str) -> Params:
        return {"g": t(f"{prefix}.weight"), "b": t(f"{prefix}.bias")}

    def attn(prefix: str) -> Params:
        return {k: dense(f"{prefix}.{name}")
                for k, name in (("q", "query"), ("k", "key"), ("v", "value"), ("o", "out"))}

    def block(prefix: str, cross: bool) -> Params:
        blk = {"attn_ln": ln(f"{prefix}.attn_ln"),
               "attn": attn(f"{prefix}.attn"),
               "mlp_ln": ln(f"{prefix}.mlp_ln"),
               # the MLP is Sequential(Linear, GELU, Linear): mlp.0 / mlp.2
               "mlp": {"fc1": dense(f"{prefix}.mlp.0"), "fc2": dense(f"{prefix}.mlp.2")}}
        if cross:
            blk["cross_attn_ln"] = ln(f"{prefix}.cross_attn_ln")
            blk["cross_attn"] = attn(f"{prefix}.cross_attn")
        return blk

    return {
        "encoder": {
            "conv1": dense("encoder.conv1"),
            "conv2": dense("encoder.conv2"),
            "pos_emb": t("encoder.positional_embedding"),
            "blocks": [block(f"encoder.blocks.{i}", cross=False)
                       for i in range(config.n_audio_layer)],
            "ln_post": ln("encoder.ln_post"),
        },
        "decoder": {
            "token_emb": t("decoder.token_embedding.weight"),
            "pos_emb": t("decoder.positional_embedding"),
            "blocks": [block(f"decoder.blocks.{i}", cross=True)
                       for i in range(config.n_text_layer)],
            "ln": ln("decoder.ln"),
        },
    }


def load_openai_whisper(path: str | Path, dtype: torch.dtype = torch.float32,
                        device: torch.device | str = "cpu") -> tuple[Params, WhisperConfig]:
    """Load an original-release ``*.pt`` checkpoint onto ``device``. The file
    holds a dims dict and a state dict of tensors, so it is read with
    ``weights_only=True``: nothing else in it is unpickled."""
    ckpt = torch.load(str(path), map_location="cpu", weights_only=True)
    config = config_from_dims(ckpt["dims"])
    return convert_openai_state(ckpt["model_state_dict"], config, dtype, device), config
