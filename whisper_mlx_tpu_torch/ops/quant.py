"""Weight-only group quantization in the MLX format, and its matmul dispatch.

Counterpart of ``whisper_mlx_tpu/ops/quant.py`` for packed weights:

- groups of ``group_size`` (64 in every mlx-community checkpoint) along the
  input axis, affine dequant ``w = scales * q + biases``;
- codes packed little-endian into 32-bit words, 8 int4 or 4 int8 per word:
  nibble ``i`` of word ``w`` is column ``8w + i``;
- :class:`QuantTensor` keeps MLX's ``(out, in)`` layout, which is also the
  port's linear layout, so ``quant_matmul(x, q) = x @ dequant(q).T``.

Codes are held as ``torch.int32`` with the bits of MLX's uint32 words:
``torch.uint32`` has no shift operators on the CPU. An arithmetic shift
followed by ``& mask`` gives the same code as a logical one.

``quant_matmul`` sends calls of at most ``WTPU_QMM_PALLAS_MAX_ROWS`` (512)
rows to a kernel and larger ones to dequantize + ``torch.matmul``, the
reference's policy: a ``QuantTensor`` to K5 (``ops/quant_matmul.py``), or
with ``WTPU_QMM_MB="depth[,tile_n]"`` to K6 transposing per call; a
``QuantTensorT`` (``prepare_mbt_params``, ``WTPU_MBT_RESIDENT``) to K6
(``ops/quant_matmul_mb.py``); an ``A8Tensor`` (``ops/quant_a8.py``,
``WTPU_QWEN_A8``) to K7. The reference's other resident layouts
(``NativeQuantTensor``, ``DenseWeight``) and the whisper walkers are not
ported: ROADMAP.md M9 and M15.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch

from whisper_mlx_tpu_torch.ops.quant_matmul import quant_matmul_kernel

# leaf types of the reference that the port does not have yet -> ROADMAP item
_NOT_PORTED = {
    "NativeQuantTensor": "M15 (native-code residency)",
    "DenseWeight": "M9 (dequantize-once residency)",
}


@dataclasses.dataclass
class QuantTensor:
    """Group-quantized 2-D weight in MLX layout ``(out, in)``.

    ``w_q`` ``(out, in * bits // 32)`` int32 (the bits of MLX's uint32
    words); ``scales`` and ``biases`` ``(out, in // group_size)`` fp32.
    """

    w_q: torch.Tensor
    scales: torch.Tensor
    biases: torch.Tensor
    bits: int
    group_size: int

    @property
    def shape(self) -> tuple[int, int]:
        return (self.w_q.shape[0], self.w_q.shape[1] * (32 // self.bits))

    def dequantize(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return dequantize(self.w_q, self.scales, self.biases, self.bits,
                          self.group_size, dtype)

    def __repr__(self) -> str:
        return f"QuantTensor{self.shape}[{self.bits}b/g{self.group_size}]"


def _to_int32_bits(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 with the same 32 bits."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def quantize(w: torch.Tensor, bits: int = 4, group_size: int = 64) -> QuantTensor:
    """MLX-semantics affine group quantization of ``(out, in)`` weights on
    ``w``'s device: scale ``(max - min) / (2**bits - 1)`` (1e-8 where the
    group is constant), bias ``min``, codes rounded half to even.

    One function for the reference's ``quantize`` (numpy) and
    ``quantize_jax`` (on device); both give the same codes.
    """
    out_dim, in_dim = w.shape
    if in_dim % group_size or bits not in (4, 8):
        raise ValueError(f"quantize: in_dim {in_dim}, group_size {group_size}, bits {bits}")
    n_levels = (1 << bits) - 1
    g = w.reshape(out_dim, in_dim // group_size, group_size).float()
    w_min = g.amin(dim=-1)
    w_max = g.amax(dim=-1)
    scales = (w_max - w_min) / n_levels
    scales = torch.where(scales == 0, torch.full_like(scales, 1e-8), scales)
    q = torch.round((g - w_min[..., None]) / scales[..., None]).clamp(0, n_levels)
    per_word = 32 // bits
    q = q.to(torch.int64).reshape(out_dim, in_dim // per_word, per_word)
    shifts = torch.arange(per_word, device=w.device, dtype=torch.int64) * bits
    words = (q << shifts).sum(dim=-1)  # disjoint bit fields: sum == or
    return QuantTensor(_to_int32_bits(words), scales, w_min, bits, group_size)


def unpack(w_q: torch.Tensor, bits: int) -> torch.Tensor:
    """Packed words ``(..., n)`` -> int32 codes ``(..., n * 32 // bits)`` in
    ``[0, 2**bits)``."""
    per_word = 32 // bits
    shifts = torch.arange(per_word, device=w_q.device, dtype=torch.int32) * bits
    vals = (w_q.to(torch.int32)[..., None] >> shifts) & ((1 << bits) - 1)
    return vals.reshape(*w_q.shape[:-1], w_q.shape[-1] * per_word)


def dequantize(w_q, scales, biases, bits: int, group_size: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """-> ``(out, in)`` weights: ``codes * scale + bias`` in ``dtype``."""
    vals = unpack(w_q, bits).to(dtype)
    out_dim, in_dim = vals.shape
    vals = vals.reshape(out_dim, in_dim // group_size, group_size)
    w = vals * scales[..., None].to(dtype) + biases[..., None].to(dtype)
    return w.reshape(out_dim, in_dim)


def quant_rows(q: QuantTensor, rows: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Dequantize selected rows (embedding lookup): rows ``(...)`` ->
    ``(..., in)``, reading only the requested rows' words and affines."""
    _check_leaf(q)
    vals = unpack(q.w_q[rows], q.bits).to(dtype)
    *lead, in_dim = vals.shape
    vals = vals.reshape(*lead, in_dim // q.group_size, q.group_size)
    w = vals * q.scales[rows][..., None].to(dtype) + q.biases[rows][..., None].to(dtype)
    return w.reshape(*lead, in_dim)


def stack_quant(tensors: list[QuantTensor]) -> QuantTensor:
    """Concatenate quantized weights along the output dim. Quantization is
    per output row, so the stack dequantizes to the row-concatenation."""
    t0 = tensors[0]
    if any(t.bits != t0.bits or t.group_size != t0.group_size
           or t.shape[1] != t0.shape[1] for t in tensors):
        raise ValueError(f"stack_quant: mismatched {[repr(t) for t in tensors]}")
    return QuantTensor(torch.cat([t.w_q for t in tensors]),
                       torch.cat([t.scales for t in tensors]),
                       torch.cat([t.biases for t in tensors]),
                       t0.bits, t0.group_size)


def fuse_qwen_projections(params: dict) -> dict:
    """Fuse each Qwen layer's quantized q/k/v into one ``qkv`` and gate/up
    into one ``gate_up`` (exact row stacks); ``models/qwen.py`` splits the
    fused outputs at the head and FFN widths."""

    def fused_layer(blk: dict) -> dict:
        attn, mlp = blk["attn"], blk["mlp"]
        out = dict(blk)
        if all(isinstance(attn[k]["w"], QuantTensor) for k in ("q", "k", "v")):
            new_attn = {"qkv": {"w": stack_quant([attn[k]["w"] for k in ("q", "k", "v")])},
                        "o": attn["o"]}
            if "b" in attn["q"]:
                new_attn["qkv"]["b"] = torch.cat([attn[k]["b"] for k in ("q", "k", "v")])
            for k in ("q_norm", "k_norm"):
                if k in attn:
                    new_attn[k] = attn[k]
            out["attn"] = new_attn
        if all(isinstance(mlp[k]["w"], QuantTensor) for k in ("gate", "up")):
            out["mlp"] = {"gate_up": {"w": stack_quant([mlp["gate"]["w"], mlp["up"]["w"]])},
                          "down": mlp["down"]}
        return out

    fused = dict(params)
    fused["layers"] = [fused_layer(blk) for blk in params["layers"]]
    return fused


def dequantize_params(params: Any, dtype: torch.dtype = torch.bfloat16) -> Any:
    """Every QuantTensor of a tree -> dense ``(out, in)`` weights. The port's
    linear and embedding layouts are both ``(out, in)``, so unlike the
    reference nothing is transposed."""
    if isinstance(params, QuantTensor):
        return params.dequantize(dtype)
    if isinstance(params, dict):
        return {k: dequantize_params(v, dtype) for k, v in params.items()}
    if isinstance(params, list):
        return [dequantize_params(v, dtype) for v in params]
    return params


def _check_leaf(q: Any) -> None:
    item = _NOT_PORTED.get(type(q).__name__)
    if item is not None:
        raise NotImplementedError(f"{type(q).__name__} weights are not ported: ROADMAP.md {item}")
    if not isinstance(q, QuantTensor):
        raise TypeError(f"expected a QuantTensor, got {type(q).__name__}")


def prepare_mbt_params(params: Any, embed_keys: tuple = ("embed", "token_emb"),
                       max_k: int | None = None, max_n: int | None = None) -> Any:
    """Transpose every packed QuantTensor linear of a tree once to
    :class:`~whisper_mlx_tpu_torch.ops.quant_matmul_mb.QuantTensorT`, the
    layout of kernel K6 (``WTPU_MBT_RESIDENT``). Embedding tables (dict keys
    in ``embed_keys``) stay packed for their row gathers; linears deeper
    than ``max_k`` (``WTPU_MBT_MAX_K``) or wider than ``max_n``
    (``WTPU_MBT_MAX_N``, default 65536: the vocabulary head) stay packed
    too. Other leaves pass through."""
    from whisper_mlx_tpu_torch.ops.quant_matmul_mb import transpose_quant

    if max_k is None:
        mk = os.environ.get("WTPU_MBT_MAX_K", "")
        max_k = int(mk) if mk else None
    if max_n is None:
        mn = os.environ.get("WTPU_MBT_MAX_N", "")
        max_n = int(mn) if mn else 65536

    def walk(node):
        if isinstance(node, QuantTensor):
            n, k = node.shape
            if (max_k is not None and k > max_k) or n > max_n:
                return node
            return transpose_quant(node)
        if isinstance(node, dict):
            return {k: (v if k in embed_keys and isinstance(v, QuantTensor) else walk(v))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(params)


def quant_matmul(x: torch.Tensor, q: Any) -> torch.Tensor:
    """``x @ dequant(q).T``: x ``(..., in)`` -> ``(..., out)`` in x's dtype.

    At most ``WTPU_QMM_PALLAS_MAX_ROWS`` (512) rows: the leaf's kernel (its
    plain version on CPU tensors); more rows: dequantize to x's dtype and
    ``torch.matmul``, the reference's policy (module docstring). On CUDA
    tensors a bound below 512 raises: it would take calls away from the
    kernels.
    """
    from whisper_mlx_tpu_torch.ops.quant_a8 import A8Tensor, a8_matmul
    from whisper_mlx_tpu_torch.ops.quant_matmul_mb import (
        QuantTensorT,
        quant_matmul_mb,
        quant_matmul_mbt,
    )

    max_rows = int(os.environ.get("WTPU_QMM_PALLAS_MAX_ROWS", "512"))
    if x.is_cuda and max_rows < 512:
        raise ValueError(f"WTPU_QMM_PALLAS_MAX_ROWS={max_rows}: on CUDA the quantized "
                         "matmul kernels run every call of at most 512 rows (the bound "
                         "may only rise)")
    rows = x.numel() // x.shape[-1]
    if isinstance(q, (A8Tensor, QuantTensorT)):
        if rows > max_rows:
            return torch.matmul(x, q.dequantize(x.dtype).T)
        return a8_matmul(x, q) if isinstance(q, A8Tensor) else quant_matmul_mbt(x, q)
    _check_leaf(q)
    if rows > max_rows:
        return torch.matmul(x, q.dequantize(x.dtype).T)
    mb = os.environ.get("WTPU_QMM_MB", "")
    if mb:
        parts = mb.split(",")
        return quant_matmul_mb(x, q, tile_n=int(parts[1]) if len(parts) > 1 else 512,
                               depth=int(parts[0]))
    return quant_matmul_kernel(x, q.w_q, q.scales, q.biases, q.bits, q.group_size)
