"""Convert the JAX package's parameter tree into the port's state dict.

The JAX loaders (and ``whisper_mlx_tpu.models.whisper.init_params``)
produce a nested dict of arrays. ``params_from_jax`` takes that tree with
numpy leaves (``jax.tree.map(np.asarray, params)``) and returns the same
structure of torch tensors in PyTorch's layouts:

- linear ``w`` ``(n_in, n_out)`` -> ``(n_out, n_in)``;
- conv ``w`` ``(k, in, out)`` -> ``(out, in, k)``;
- ``pos_emb``, ``token_emb`` and LayerNorm ``g``/``b`` as they are.

A quantized whisper tree converts too: ``QuantTensor`` leaves (already
``(out, in)``; numpy children) at a linear's ``w`` or at ``token_emb``,
``QuantTensorT`` leaves (the few-row transposed layout), the native-code
leaves of ``prepare_native_params`` (``NativeQuantTensor``, its codes
packed into words exactly; ``DenseWeight``) and fused ``qkv`` nodes
(``ops/quant.py:fuse_whisper_qkv``) keep their codes, scales and biases bit
for bit. An unknown or missing key raises ``ValueError``; a leaf of another
type (an integer array) raises ``NotImplementedError``.

``qwen_params_from_jax`` converts a Qwen tree (``models/qwen.py``), whose
``QuantTensor``, ``QuantTensorT``, ``A8Tensor``, ``NativeQuantTensor`` and
``DenseWeight`` leaves carry numpy arrays (``jax.tree.map(np.asarray,
params)`` maps into their children),
into the port's Qwen state dict, and ``qwen_cache_from_jax`` a Qwen KV
cache (fp or quantized) into the port's layout. ``tmajor_cache_from_jax``
converts a whisper cache of the reference's time-major layout into the
port's position-major one.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from whisper_mlx_tpu_torch.models.qwen import QwenConfig
from whisper_mlx_tpu_torch.models.whisper import Params, WhisperConfig
from whisper_mlx_tpu_torch.ops.quant import DenseWeight, QuantTensor, native_from_codes
from whisper_mlx_tpu_torch.ops.quant_a8 import A8Tensor
from whisper_mlx_tpu_torch.ops.quant_matmul_mb import QuantTensorT

_LN = ("g", "b")
_ATTN = ("q", "k", "v", "o")
_FUSED_ATTN = ("qkv", "o")
_DENSE = ("w", "b")


def _tensor(a: Any, path: str, device, dtype, layout: str) -> torch.Tensor:
    if not isinstance(a, np.ndarray) or a.dtype.kind != "f":
        raise NotImplementedError(f"params_from_jax: {path} is {type(a).__name__} "
                                  f"{getattr(a, 'dtype', '')}: only float numpy arrays and "
                                  "the quantized leaf types convert")
    if layout == "linear":
        a = a.T
    elif layout == "conv":
        a = a.transpose(2, 1, 0)
    return torch.from_numpy(np.array(a, np.float32, order="C")).to(device, dtype)


def _keys(node: Any, allowed: tuple[str, ...], path: str, required=()) -> None:
    if not isinstance(node, dict):
        raise ValueError(f"params_from_jax: {path} is not a dict")
    unknown = set(node) - set(allowed)
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

    def weight(a, path, layout):
        q = _quant_leaf(a, device)
        return t(a, path, layout) if q is None else q

    def dense(node, path):
        _keys(node, _DENSE, path, required=("w",))
        out = {"w": weight(node["w"], f"{path}.w", "linear")}
        if "b" in node:
            out["b"] = t(node["b"], f"{path}.b")
        return out

    def ln(node, path):
        _keys(node, _LN, path, required=_LN)
        return {"g": t(node["g"], f"{path}.g"), "b": t(node["b"], f"{path}.b")}

    def attn(node, path):
        names = _FUSED_ATTN if isinstance(node, dict) and "qkv" in node else _ATTN
        _keys(node, names, path, required=names)
        return {k: dense(node[k], f"{path}.{k}") for k in names}

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
            "token_emb": weight(dec["token_emb"], "decoder.token_emb", "as_is"),
            "pos_emb": t(dec["pos_emb"], "decoder.pos_emb"),
            "blocks": [block(b, f"decoder.blocks.{i}", cross=True)
                       for i, b in enumerate(dec["blocks"])],
            "ln": ln(dec["ln"], "decoder.ln"),
        },
    }


def _words(a: Any) -> np.ndarray:
    """uint32 words -> int32 with the same bits (int8 codes as they are)."""
    a = np.array(a)  # a writable copy
    return a if a.dtype == np.int8 else a.astype(np.uint32).view(np.int32)


def _f32(a: Any, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(device)


def _mbt_leaf(a: Any, device) -> QuantTensorT:
    """JAX QuantTensorT (flat ``(rows, N)`` or pre-tiled ``contig``, words or
    int8 codes) -> the port's flat ``(rows, Np)`` layout, zero-padded."""
    wqt, sct, bit = _words(a.wqt), np.asarray(a.scalest), np.asarray(a.biasest)
    if a.contig:
        t, rows, tile = wqt.shape
        wqt = wqt.transpose(1, 0, 2).reshape(rows, t * tile)
    n = int(a.n_orig) if a.contig else wqt.shape[1]
    np_ = -(-n // int(a.tile_n)) * int(a.tile_n)

    def pad(v: np.ndarray) -> np.ndarray:
        return np.pad(v[:, :n], ((0, 0), (0, np_ - n)))

    wqt, sct, bit = pad(wqt), pad(sct), pad(bit)
    return QuantTensorT(torch.from_numpy(wqt).to(device), _f32(sct, device), _f32(bit, device),
                        int(a.bits), int(a.group_size), int(a.tile_n), int(a.depth),
                        bool(a.contig), n)


def _a8_leaf(a: Any, device) -> A8Tensor:
    """JAX A8Tensor (codes ``(K, Np)`` or ``contig`` ``(n_tiles, K, tile_n)``)
    -> the port's N-major ``(N, K)`` codes."""
    codes = np.asarray(a.codes)
    if a.contig:
        t, k, tile = codes.shape
        codes = codes.transpose(1, 0, 2).reshape(k, t * tile)
    n = int(a.n_orig)
    return A8Tensor(torch.from_numpy(np.ascontiguousarray(codes[:, :n].T)).to(device),
                    _f32(np.asarray(a.scale)[0, :n], device), int(a.tile_n), int(a.depth))


def _quant_leaf(a: Any, device):
    """A JAX quantized leaf -> the port's, or None for any other leaf."""
    kind = type(a).__name__
    if kind == "QuantTensor":
        return QuantTensor(torch.from_numpy(_words(a.w_q)).to(device), _f32(a.scales, device),
                           _f32(a.biases, device), int(a.bits), int(a.group_size))
    if kind == "QuantTensorT":
        return _mbt_leaf(a, device)
    if kind == "A8Tensor":
        return _a8_leaf(a, device)
    if kind == "NativeQuantTensor":  # u4 or uint8 codes in [0, 2**bits)
        codes = torch.from_numpy(np.asarray(a.codes).astype(np.uint8)).to(device)
        return native_from_codes(codes, _f32(a.scales, device), _f32(a.biases, device),
                                 int(a.bits), int(a.group_size))
    if kind == "DenseWeight":  # (out, in) in its own float type
        w = np.asarray(a.w)
        dt = torch.float32 if w.dtype == np.float32 else torch.bfloat16
        return DenseWeight(torch.from_numpy(w.astype(np.float32)).to(device, dt))
    return None


def _qwen_leaf(a: Any, path: str, device, dtype, transpose: bool):
    q = _quant_leaf(a, device)
    if q is not None:
        return q
    if not isinstance(a, np.ndarray) or a.dtype.kind != "f":
        raise NotImplementedError(f"qwen_params_from_jax: {path} is {type(a).__name__} "
                                  f"{getattr(a, 'dtype', '')}: only float numpy arrays and "
                                  "the quantized leaf types convert")
    return _tensor(a, path, device, dtype, "linear" if transpose else "as_is")


def qwen_params_from_jax(tree: Params, config: QwenConfig, device="cpu",
                         dtype: torch.dtype | None = None) -> Params:
    """JAX Qwen params (numpy and quantized leaves) -> the port's state
    dict: fp linear ``w`` ``(in, out)`` -> ``(out, in)``; ``QuantTensor``
    (already ``(out, in)``), ``QuantTensorT`` and ``A8Tensor`` -> the
    port's, with an equal ``dequantize``; the embedding, norms and biases
    as they are. Fused ``qkv`` / ``gate_up`` are kept."""
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


def qwen_cache_from_jax(cache: list[dict[str, Any]]) -> list[Params]:
    """The JAX package's Qwen KV cache (``models/qwen.py:init_kv_cache``,
    numpy leaves) -> the port's position-major cache, as the state a
    conversation carries across: time-minor fp ``kt``/``vt`` ``(b, kv, hd,
    T)`` become ``k``/``v`` ``(b, kv, T, hd)``; time-minor codes
    ``k8t``/``v8t`` become ``k8``/``v8``, int8 as they are and int4
    (``ml_dtypes.int4``) packed two nibbles a byte (low nibble = even d);
    scales ``ks``/``vs`` ``(b, kv, T, 1)`` become ``(b, kv, T)`` bf16."""
    from whisper_mlx_tpu_torch.ops.decode_attention import pack_int4

    out = []
    for i, layer in enumerate(cache):
        if set(layer) == {"kt", "vt"}:
            out.append({name: torch.from_numpy(np.ascontiguousarray(
                np.swapaxes(np.asarray(layer[f"{name}t"]), 2, 3).astype(np.float32)))
                for name in ("k", "v")})
            continue
        if set(layer) != {"k8t", "ks", "v8t", "vs"}:
            raise ValueError(f"qwen_cache_from_jax: layer {i} has keys {sorted(layer)}")
        entry = {}
        for name in ("k", "v"):
            codes = np.swapaxes(np.asarray(layer[f"{name}8t"]), 2, 3)
            if codes.dtype.name not in ("int8", "int4"):
                raise ValueError(f"qwen_cache_from_jax: layer {i} {name}8t is {codes.dtype}")
            packed = codes.dtype.name == "int4"
            codes = torch.from_numpy(np.ascontiguousarray(codes.astype(np.int8)))
            entry[f"{name}8"] = pack_int4(codes) if packed else codes
            scales = np.asarray(layer[f"{name}s"], np.float32)[..., 0]
            entry[f"{name}s"] = torch.from_numpy(np.ascontiguousarray(scales)).to(torch.bfloat16)
        out.append(entry)
    return out


def tmajor_cache_from_jax(cache: list[dict[str, Any]]) -> list[Params]:
    """A whisper KV cache of the JAX package's time-major layout
    (``WTPU_SELF_KV_LAYOUT`` / ``WTPU_KV_LAYOUT`` = ``tmajor``; numpy
    leaves) -> the port's position-major cache: codes ``kT``/``vT`` ``(T,
    b, h * d)`` become ``k8``/``v8`` ``(b, h, T, d)``, int8 as they are and
    int4 (``ml_dtypes.int4``) packed two nibbles a byte (low nibble = even
    d); scales ``ksT``/``vsT`` ``(T, b, h)`` become ``(b, h, T)`` bf16."""
    from whisper_mlx_tpu_torch.ops.decode_attention import pack_int4

    out = []
    for i, layer in enumerate(cache):
        if set(layer) != {"kT", "ksT", "vT", "vsT"}:
            raise ValueError(f"tmajor_cache_from_jax: layer {i} has keys {sorted(layer)}")
        entry = {}
        for name in ("k", "v"):
            codes = np.asarray(layer[f"{name}T"])
            if codes.dtype.name not in ("int8", "int4"):
                raise ValueError(f"tmajor_cache_from_jax: layer {i} {name}T is {codes.dtype}")
            scales = np.asarray(layer[f"{name}sT"], np.float32)
            t, b, h = scales.shape
            c = codes.astype(np.int8).reshape(t, b, h, -1).transpose(1, 2, 0, 3)
            c = torch.from_numpy(np.ascontiguousarray(c))
            entry[f"{name}8"] = pack_int4(c) if codes.dtype.name == "int4" else c
            entry[f"{name}s"] = torch.from_numpy(
                np.ascontiguousarray(scales.transpose(1, 2, 0))).to(torch.bfloat16)
        out.append(entry)
    return out
