"""mlx-community Whisper checkpoints (fp16 and 4/8-bit) <-> the port's tree.

Counterpart of ``whisper_mlx_tpu/checkpoint/quant_loader.py``. The format:

- ``weights.safetensors`` (or any ``*.safetensors``) and ``config.json`` with
  the model dimensions and an optional ``{"quantization": {group_size, bits}}``;
- linear weights ``(out, in)``, the port's layout; conv1d weights
  ``(out, k, in)``, the port's being ``(out, in, k)``;
- a quantized tensor is ``X.weight`` (packed uint32) + ``X.scales`` +
  ``X.biases``; it stays packed in a :class:`QuantTensor` (int32 words of the
  same bits, fp32 affines);
- ``decoder.positional_embedding`` is a bare parameter;
- the encoder's sinusoid table is not stored: it is recomputed in fp32.

Tensors land on an explicit ``device``. Files are read and written by
``checkpoint/io_util.py``, without the ``safetensors`` package.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from whisper_mlx_tpu_torch.checkpoint.io_util import load_safetensors_dir, save_safetensors_file
from whisper_mlx_tpu_torch.models.whisper import Params, WhisperConfig, sinusoids
from whisper_mlx_tpu_torch.ops.quant import QuantTensor, dequantize_params, fuse_whisper_qkv

_DIMS = ("n_mels", "n_vocab", "n_audio_ctx", "n_audio_state", "n_audio_head", "n_audio_layer",
         "n_text_ctx", "n_text_state", "n_text_head", "n_text_layer")


def config_from_mlx(cfg: Mapping[str, Any]) -> WhisperConfig:
    heads = cfg.get("alignment_heads")
    return WhisperConfig(
        **{name: cfg[name] for name in _DIMS},
        alignment_heads=tuple((int(l), int(h)) for l, h in heads) if heads else None)


def _fp(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32))).to(device, dtype)


def _quant(sd: Mapping[str, Any], prefix: str, quant: dict, device) -> QuantTensor:
    words = np.ascontiguousarray(np.asarray(sd[f"{prefix}.weight"]).astype(np.uint32))
    return QuantTensor(torch.from_numpy(words.view(np.int32)).to(device),
                       _fp(sd[f"{prefix}.scales"], torch.float32, device),
                       _fp(sd[f"{prefix}.biases"], torch.float32, device),
                       quant["bits"], quant["group_size"])


def _linear(sd: Mapping[str, Any], prefix: str, quant: dict | None, dtype, device) -> Params:
    """MLX linear -> the port's node (fp as it is, a QuantTensor packed)."""
    if quant is not None and f"{prefix}.scales" in sd:
        node: Params = {"w": _quant(sd, prefix, quant, device)}
    else:
        node = {"w": _fp(sd[f"{prefix}.weight"], dtype, device)}
    if f"{prefix}.bias" in sd:
        node["b"] = _fp(sd[f"{prefix}.bias"], dtype, device)
    return node


def _ln(sd: Mapping[str, Any], prefix: str, dtype, device) -> Params:
    return {"g": _fp(sd[f"{prefix}.weight"], dtype, device),
            "b": _fp(sd[f"{prefix}.bias"], dtype, device)}


def convert_mlx_whisper_state(sd: Mapping[str, Any], config: WhisperConfig, quant: dict | None,
                              dtype: torch.dtype = torch.float32,
                              device: torch.device | str = "cpu") -> Params:
    def attn(prefix: str) -> Params:
        return {k: _linear(sd, f"{prefix}.{name}", quant, dtype, device)
                for k, name in (("q", "query"), ("k", "key"), ("v", "value"), ("o", "out"))}

    def block(prefix: str, cross: bool) -> Params:
        blk = {
            "attn_ln": _ln(sd, f"{prefix}.attn_ln", dtype, device),
            "attn": attn(f"{prefix}.attn"),
            "mlp_ln": _ln(sd, f"{prefix}.mlp_ln", dtype, device),
            "mlp": {"fc1": _linear(sd, f"{prefix}.mlp1", quant, dtype, device),
                    "fc2": _linear(sd, f"{prefix}.mlp2", quant, dtype, device)},
        }
        if cross:
            blk["cross_attn_ln"] = _ln(sd, f"{prefix}.cross_attn_ln", dtype, device)
            blk["cross_attn"] = attn(f"{prefix}.cross_attn")
        return blk

    def conv(prefix: str) -> Params:
        # MLX conv1d weight (out, k, in) -> (out, in, k)
        w = np.asarray(sd[f"{prefix}.weight"], np.float32).transpose(0, 2, 1)
        return {"w": _fp(w, dtype, device), "b": _fp(sd[f"{prefix}.bias"], dtype, device)}

    if quant is not None and "decoder.token_embedding.scales" in sd:
        token_emb = _quant(sd, "decoder.token_embedding", quant, device)
    else:
        token_emb = _fp(sd["decoder.token_embedding.weight"], dtype, device)
    return {
        "encoder": {
            "conv1": conv("encoder.conv1"),
            "conv2": conv("encoder.conv2"),
            "pos_emb": _fp(sinusoids(config.n_audio_ctx, config.n_audio_state), dtype, device),
            "blocks": [block(f"encoder.blocks.{i}", cross=False)
                       for i in range(config.n_audio_layer)],
            "ln_post": _ln(sd, "encoder.ln_post", dtype, device),
        },
        "decoder": {
            "token_emb": token_emb,
            "pos_emb": _fp(sd["decoder.positional_embedding"], dtype, device),
            "blocks": [block(f"decoder.blocks.{i}", cross=True)
                       for i in range(config.n_text_layer)],
            "ln": _ln(sd, "decoder.ln", dtype, device),
        },
    }


def load_mlx_whisper(model_dir: str | Path, dtype: torch.dtype = torch.float32,
                     fuse_qkv: bool = True, dequant: bool | None = None,
                     device: torch.device | str = "cpu") -> tuple[Params, WhisperConfig]:
    """Load an mlx-community Whisper directory onto ``device``.

    ``fuse_qkv`` (quantized checkpoints only) stacks each self-attention
    block's q/k/v QuantTensors into one projection (exact). ``dequant``
    (default: ``WTPU_DEQUANT_AT_LOAD=1``, off) dequantizes the packed
    weights to bf16 once, on ``device``: the model then serves as a dense
    one, at four times the weight bytes."""
    model_dir = Path(model_dir)
    cfg = json.loads((model_dir / "config.json").read_text())
    config = config_from_mlx(cfg)
    quant = cfg.get("quantization")
    params = convert_mlx_whisper_state(load_safetensors_dir(model_dir), config, quant, dtype,
                                       device)
    if dequant is None:
        dequant = os.environ.get("WTPU_DEQUANT_AT_LOAD") == "1"
    if quant and dequant:
        return dequantize_params(params, dtype=torch.bfloat16), config
    if fuse_qkv and quant:
        params = fuse_whisper_qkv(params)
    return params, config


def export_mlx_whisper(params: Params, config: WhisperConfig, out_dir: str | Path,
                       quantization: dict | None = None) -> None:
    """Write the port's tree (unfused) as an MLX-format checkpoint."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    sd: dict[str, Any] = {}

    def f32(t: torch.Tensor) -> np.ndarray:
        return t.detach().float().cpu().numpy()

    def put_linear(prefix: str, node) -> None:
        w = node["w"] if isinstance(node, dict) else node
        if isinstance(w, QuantTensor):
            sd[f"{prefix}.weight"] = w.w_q.detach().cpu().numpy().view(np.uint32)
            sd[f"{prefix}.scales"] = f32(w.scales)
            sd[f"{prefix}.biases"] = f32(w.biases)
        else:
            sd[f"{prefix}.weight"] = f32(w)
        if isinstance(node, dict) and "b" in node:
            sd[f"{prefix}.bias"] = f32(node["b"])

    def put_ln(prefix: str, node: Params) -> None:
        sd[f"{prefix}.weight"] = f32(node["g"])
        sd[f"{prefix}.bias"] = f32(node["b"])

    def put_block(pre: str, blk: Params) -> None:
        for part in ("attn", "cross_attn"):
            if part in blk:
                put_ln(f"{pre}.{part}_ln", blk[f"{part}_ln"])
                for k, name in (("q", "query"), ("k", "key"), ("v", "value"), ("o", "out")):
                    put_linear(f"{pre}.{part}.{name}", blk[part][k])
        put_ln(f"{pre}.mlp_ln", blk["mlp_ln"])
        put_linear(f"{pre}.mlp1", blk["mlp"]["fc1"])
        put_linear(f"{pre}.mlp2", blk["mlp"]["fc2"])

    enc, dec = params["encoder"], params["decoder"]
    for name in ("conv1", "conv2"):  # (out, in, k) -> (out, k, in)
        sd[f"encoder.{name}.weight"] = np.ascontiguousarray(f32(enc[name]["w"]).transpose(0, 2, 1))
        sd[f"encoder.{name}.bias"] = f32(enc[name]["b"])
    for i, blk in enumerate(enc["blocks"]):
        put_block(f"encoder.blocks.{i}", blk)
    put_ln("encoder.ln_post", enc["ln_post"])
    put_linear("decoder.token_embedding", dec["token_emb"])
    sd["decoder.positional_embedding"] = f32(dec["pos_emb"])
    for i, blk in enumerate(dec["blocks"]):
        put_block(f"decoder.blocks.{i}", blk)
    put_ln("decoder.ln", dec["ln"])

    save_safetensors_file(out_dir / "weights.safetensors", sd)
    cfg: dict[str, Any] = {name: getattr(config, name) for name in _DIMS}
    if quantization:
        cfg["quantization"] = quantization
    if config.alignment_heads:
        cfg["alignment_heads"] = [list(p) for p in config.alignment_heads]
    (out_dir / "config.json").write_text(json.dumps(cfg))
