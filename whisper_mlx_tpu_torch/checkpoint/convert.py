"""Convert the JAX package's parameter tree into the port's state dict.

The JAX loaders (and ``whisper_mlx_tpu.models.whisper.init_params``)
produce a nested dict of arrays. ``params_from_jax`` takes that tree with
numpy leaves (``jax.tree.map(np.asarray, params)``) and returns the same
structure of torch tensors in PyTorch's layouts:

- linear ``w`` ``(n_in, n_out)`` -> ``(n_out, n_in)``;
- conv ``w`` ``(k, in, out)`` -> ``(out, in, k)``;
- ``pos_emb``, ``token_emb`` and LayerNorm ``g``/``b`` as they are.

An unknown or missing key raises ``ValueError``. A fused ``qkv``
projection or a quantized weight in a whisper tree raises
``NotImplementedError``: ``QuantTensor`` and ``quant_matmul`` (K5) exist
(``ops/quant.py``), but whisper's quantized walkers, its fused ``qkv`` and
the whisper loaders are ROADMAP.md M9.

``qwen_params_from_jax`` converts a Qwen tree (``models/qwen.py``), whose
``QuantTensor`` leaves carry numpy arrays (``jax.tree.map(np.asarray,
params)`` maps into their children), into the port's Qwen state dict.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from whisper_mlx_tpu_torch.models.qwen import QwenConfig
from whisper_mlx_tpu_torch.models.whisper import Params, WhisperConfig
from whisper_mlx_tpu_torch.ops.quant import QuantTensor

_LN = ("g", "b")
_ATTN = ("q", "k", "v", "o")
_DENSE = ("w", "b")


def _tensor(a: Any, path: str, device, dtype, layout: str) -> torch.Tensor:
    if not isinstance(a, np.ndarray) or a.dtype.kind != "f":
        raise NotImplementedError(f"params_from_jax: {path} is {type(a).__name__}, not a "
                                  "float numpy array: quantized whisper weights (walkers "
                                  "and loaders) are ROADMAP.md M9")
    if layout == "linear":
        a = a.T
    elif layout == "conv":
        a = a.transpose(2, 1, 0)
    return torch.from_numpy(np.array(a, np.float32, order="C")).to(device, dtype)


def _keys(node: Any, allowed: tuple[str, ...], path: str, required=()) -> None:
    if not isinstance(node, dict):
        raise ValueError(f"params_from_jax: {path} is not a dict")
    unknown = set(node) - set(allowed)
    if "qkv" in unknown:
        raise NotImplementedError(f"params_from_jax: fused whisper qkv projection at "
                                  f"{path}: ROADMAP.md M9")
    if unknown:
        raise ValueError(f"params_from_jax: unknown keys {sorted(unknown)} at {path}")
    missing = set(required) - set(node)
    if missing:
        raise ValueError(f"params_from_jax: missing keys {sorted(missing)} at {path}")


def params_from_jax(tree: Params, config: WhisperConfig, device="cpu",
                    dtype: torch.dtype | None = None) -> Params:
    """JAX param tree (numpy leaves) -> the port's state dict on ``device``."""
    dtype = dtype or config.dtype

    def t(a, path, layout="as_is"):
        return _tensor(a, path, device, dtype, layout)

    def dense(node, path):
        _keys(node, _DENSE, path, required=("w",))
        out = {"w": t(node["w"], f"{path}.w", "linear")}
        if "b" in node:
            out["b"] = t(node["b"], f"{path}.b")
        return out

    def ln(node, path):
        _keys(node, _LN, path, required=_LN)
        return {"g": t(node["g"], f"{path}.g"), "b": t(node["b"], f"{path}.b")}

    def attn(node, path):
        _keys(node, _ATTN, path, required=_ATTN)
        return {k: dense(node[k], f"{path}.{k}") for k in _ATTN}

    def block(node, path, cross: bool):
        names = ("attn_ln", "attn", "mlp_ln", "mlp")
        if cross:
            names += ("cross_attn_ln", "cross_attn")
        _keys(node, names, path, required=names)
        _keys(node["mlp"], ("fc1", "fc2"), f"{path}.mlp", required=("fc1", "fc2"))
        out = {
            "attn_ln": ln(node["attn_ln"], f"{path}.attn_ln"),
            "attn": attn(node["attn"], f"{path}.attn"),
            "mlp_ln": ln(node["mlp_ln"], f"{path}.mlp_ln"),
            "mlp": {k: dense(node["mlp"][k], f"{path}.mlp.{k}") for k in ("fc1", "fc2")},
        }
        if cross:
            out["cross_attn_ln"] = ln(node["cross_attn_ln"], f"{path}.cross_attn_ln")
            out["cross_attn"] = attn(node["cross_attn"], f"{path}.cross_attn")
        return out

    def conv(node, path):
        _keys(node, _DENSE, path, required=_DENSE)
        return {"w": t(node["w"], f"{path}.w", "conv"), "b": t(node["b"], f"{path}.b")}

    _keys(tree, ("encoder", "decoder"), "params", required=("encoder", "decoder"))
    enc, dec = tree["encoder"], tree["decoder"]
    enc_keys = ("conv1", "conv2", "pos_emb", "blocks", "ln_post")
    dec_keys = ("token_emb", "pos_emb", "blocks", "ln")
    _keys(enc, enc_keys, "encoder", required=enc_keys)
    _keys(dec, dec_keys, "decoder", required=dec_keys)
    if len(enc["blocks"]) != config.n_audio_layer or len(dec["blocks"]) != config.n_text_layer:
        raise ValueError("params_from_jax: layer counts do not match the config")
    return {
        "encoder": {
            "conv1": conv(enc["conv1"], "encoder.conv1"),
            "conv2": conv(enc["conv2"], "encoder.conv2"),
            "pos_emb": t(enc["pos_emb"], "encoder.pos_emb"),
            "blocks": [block(b, f"encoder.blocks.{i}", cross=False)
                       for i, b in enumerate(enc["blocks"])],
            "ln_post": ln(enc["ln_post"], "encoder.ln_post"),
        },
        "decoder": {
            "token_emb": t(dec["token_emb"], "decoder.token_emb"),
            "pos_emb": t(dec["pos_emb"], "decoder.pos_emb"),
            "blocks": [block(b, f"decoder.blocks.{i}", cross=True)
                       for i, b in enumerate(dec["blocks"])],
            "ln": ln(dec["ln"], "decoder.ln"),
        },
    }


def _qwen_leaf(a: Any, path: str, device, dtype, transpose: bool):
    if type(a).__name__ == "QuantTensor":
        words = np.ascontiguousarray(np.asarray(a.w_q).astype(np.uint32)).view(np.int32)
        return QuantTensor(torch.from_numpy(words).to(device),
                           torch.from_numpy(np.array(a.scales, np.float32)).to(device),
                           torch.from_numpy(np.array(a.biases, np.float32)).to(device),
                           int(a.bits), int(a.group_size))
    if not isinstance(a, np.ndarray) or a.dtype.kind != "f":
        raise NotImplementedError(f"qwen_params_from_jax: {path} is {type(a).__name__}: only "
                                  "float numpy arrays and QuantTensor leaves are ported "
                                  "(other resident layouts: ROADMAP.md M12, M15)")
    return _tensor(a, path, device, dtype, "linear" if transpose else "as_is")


def qwen_params_from_jax(tree: Params, config: QwenConfig, device="cpu",
                         dtype: torch.dtype | None = None) -> Params:
    """JAX Qwen params (numpy and QuantTensor leaves) -> the port's state
    dict: fp linear ``w`` ``(in, out)`` -> ``(out, in)``; ``QuantTensor``
    (already ``(out, in)``) -> the port's ``QuantTensor``; the embedding,
    norms and biases as they are. Fused ``qkv`` / ``gate_up`` are kept."""
    dtype = dtype or config.dtype

    def walk(node, path, key=None):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}.{k}", k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, f"{path}.{i}") for i, v in enumerate(node)]
        return _qwen_leaf(node, path, device, dtype, transpose=key == "w")

    _keys(tree, ("embed", "layers", "final_ln", "lm_head"), "params",
          required=("embed", "layers", "final_ln"))
    if len(tree["layers"]) != config.num_hidden_layers:
        raise ValueError("qwen_params_from_jax: layer count does not match the config")
    if ("lm_head" in tree) == config.tie_word_embeddings:
        raise ValueError("qwen_params_from_jax: lm_head presence does not match "
                         "tie_word_embeddings")
    return walk(tree, "params")
