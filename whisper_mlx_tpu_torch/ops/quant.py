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
``WTPU_QWEN_A8``) to K7.

Native-code residency (the reference's ``WTPU_NATIVE_RESIDENT``,
``ops/quant.py:64-480`` there): :func:`promote_resident_native` turns packed
leaves into :class:`NativeQuantTensor` (the LLM engine's opt-in), and
:func:`prepare_native_params` into native leaves at few decode rows or
:class:`DenseWeight` (dequantized once) at many. The reference holds a
native leaf's codes one a byte; here they stay in a ``QuantTensor``'s packed
words (half a byte an element at 4 bits), so that they run where the packed
route runs those bits: :func:`native_group_matmul` keeps the reference's row
rule, at most 32 rows and a grouped partial of at most 768 MiB on K5 (its
plain version on the CPU), past it dequantize to x's dtype and
``torch.matmul``, as the reference does outside any kernel. A
``DenseWeight`` is ``x @ w.T`` in ``torch.matmul``. ``WTPU_QMM``, the
reference's choice of epilogue for its grouped form (``einsum`` or
``reduce``, the same function), is not read.

The whisper walkers: :func:`quantize_params` (what an mlx-community 4-bit
checkpoint quantizes), :func:`fuse_whisper_qkv` / :func:`unfuse_whisper_qkv`
(one stacked self-attention projection for the packed path) and
:func:`maybe_dense_decode_params`, the reference's serving policy by decode
rows: at most ``WTPU_DENSE_ROWS_MIN`` (16) rows keep the packed tree on K5
(on K6 with ``WTPU_FEWROW_MBT=1``), more rows unfuse and dequantize once.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Any

import torch

from whisper_mlx_tpu_torch.ops.quant_matmul import quant_matmul_kernel

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


@dataclasses.dataclass
class NativeQuantTensor:
    """The reference's native-code leaf (``ops/quant.py:NativeQuantTensor``):
    codes in ``[0, 2**bits)`` with the affines of a :class:`QuantTensor`,
    ``(out, in)``. The codes are held as a QuantTensor's packed words, which
    encode them exactly (``codes`` unpacks them)."""

    w_q: torch.Tensor
    scales: torch.Tensor
    biases: torch.Tensor
    bits: int
    group_size: int

    shape = QuantTensor.shape
    dequantize = QuantTensor.dequantize

    @property
    def codes(self) -> torch.Tensor:
        """``(out, in)`` uint8 codes, as the reference holds them."""
        return unpack(self.w_q, self.bits).to(torch.uint8)

    def __repr__(self) -> str:
        return f"NativeQuantTensor{self.shape}[{self.bits}b/g{self.group_size}]"


@dataclasses.dataclass
class DenseWeight:
    """A weight dequantized once, in its ``(out, in)`` layout
    (``ops/quant.py:DenseWeight`` of the reference); ``quant_matmul`` is
    ``x @ w.T``."""

    w: torch.Tensor

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(self.w.shape)

    def dequantize(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return self.w.to(dtype)


def native_from_codes(codes: torch.Tensor, scales: torch.Tensor, biases: torch.Tensor,
                      bits: int, group_size: int) -> NativeQuantTensor:
    """``(out, in)`` codes in ``[0, 2**bits)`` -> a native leaf, the codes
    packed into 32-bit words as MLX packs them."""
    return NativeQuantTensor(_pack(codes, bits), scales, biases, bits, group_size)


def to_native(q: QuantTensor) -> NativeQuantTensor:
    """A packed leaf as a native one (``ops/quant.py:to_native``): its codes
    re-encoded into the same packed words, so the words are reused."""
    return NativeQuantTensor(q.w_q, q.scales, q.biases, q.bits, q.group_size)


def _to_int32_bits(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 with the same 32 bits."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def _pack(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """``(out, in)`` codes in ``[0, 2**bits)`` -> MLX's little-endian words
    ``(out, in * bits // 32)`` as int32 with the bits of its uint32."""
    per_word = 32 // bits
    out_dim, in_dim = codes.shape
    q = codes.to(torch.int64).reshape(out_dim, in_dim // per_word, per_word)
    shifts = torch.arange(per_word, device=codes.device, dtype=torch.int64) * bits
    return _to_int32_bits((q << shifts).sum(dim=-1))  # disjoint bit fields: sum == or


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
    return QuantTensor(_pack(q.reshape(out_dim, in_dim), bits), scales, w_min, bits, group_size)


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


def quant_rows(q: QuantTensor | NativeQuantTensor, rows: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Dequantize selected rows (embedding lookup): rows ``(...)`` ->
    ``(..., in)``, reading only the requested rows' words and affines. A
    native leaf's codes dequantize as the reference's do."""
    if not isinstance(q, NativeQuantTensor):
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


def quantize_params(params: dict, bits: int = 4, group_size: int = 64) -> dict:
    """Quantize every eligible linear of a whisper tree, as mlx-community
    checkpoints do: each 2-D ``w`` whose input dim is a multiple of
    ``group_size``, and the token embedding. The conv stem, LayerNorms and
    position tables stay as they are."""

    def walk(node):
        if isinstance(node, dict):
            w = node.get("w")
            if isinstance(w, torch.Tensor) and w.dim() == 2:
                if w.shape[1] % group_size:
                    return node
                new = {"w": quantize(w, bits, group_size)}
                if "b" in node:
                    new["b"] = node["b"]
                return new
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    out = {"encoder": walk(params["encoder"]), "decoder": {}}
    for name, val in params["decoder"].items():
        if name == "token_emb":
            ok = val.shape[1] % group_size == 0
            out["decoder"][name] = quantize(val, bits, group_size) if ok else val
        else:
            out["decoder"][name] = walk(val)
    return out


def _map_attn(params: dict, fn) -> dict:
    """A copy of a whisper tree with ``fn`` applied to every block's
    self-attention node (cross-attention K/V are computed once per window,
    so only self-attention shares activations across q, k and v)."""
    out = dict(params)
    for part in ("encoder", "decoder"):
        if isinstance(out.get(part), dict) and "blocks" in out[part]:
            out[part] = dict(out[part])
            out[part]["blocks"] = [
                {**blk, "attn": fn(blk["attn"])} if "attn" in blk else blk
                for blk in out[part]["blocks"]]
    return out


def fuse_whisper_qkv(params: dict) -> dict:
    """Replace q/k/v of every self-attention block whose three weights are
    QuantTensors by one stacked ``qkv`` (one dequant-matmul instead of
    three). Whisper's k projection has no bias: the fused bias carries fp32
    zeros there, which adds nothing."""

    def fuse(attn: dict) -> dict:
        if not all(k in attn and isinstance(attn[k]["w"], QuantTensor) for k in ("q", "k", "v")):
            return attn
        qw, kw, vw = (attn[k]["w"] for k in ("q", "k", "v"))
        zeros = torch.zeros(qw.shape[0], dtype=torch.float32, device=qw.w_q.device)
        bias = torch.cat([attn["q"].get("b", zeros).to(torch.float32), zeros,
                          attn["v"].get("b", zeros).to(torch.float32)])
        return {"qkv": {"w": stack_quant([qw, kw, vw]), "b": bias}, "o": attn["o"]}

    return _map_attn(params, fuse)


def unfuse_whisper_qkv(params: dict) -> dict:
    """Inverse of :func:`fuse_whisper_qkv`, exact: the stacked QuantTensor's
    rows and per-row affines are sliced. Only whisper's equal-width
    ``(3d, d)`` projections are split; k gets no bias back."""

    def split(attn: dict) -> dict:
        qkv = attn.get("qkv")
        if qkv is None or not isinstance(qkv.get("w"), QuantTensor):
            return attn
        w = qkv["w"]
        d = w.shape[1]
        if w.shape[0] != 3 * d:
            return attn

        def rows(lo, hi):
            return QuantTensor(w.w_q[lo:hi], w.scales[lo:hi], w.biases[lo:hi],
                               w.bits, w.group_size)

        out = {"q": {"w": rows(0, d)}, "k": {"w": rows(d, 2 * d)},
               "v": {"w": rows(2 * d, 3 * d)}, "o": attn["o"]}
        if qkv.get("b") is not None:
            out["q"]["b"] = qkv["b"][:d]
            out["v"]["b"] = qkv["b"][2 * d:]
        return out

    return _map_attn(params, split)


def _has_quant(node: Any) -> bool:
    if isinstance(node, QuantTensor):
        return True
    if isinstance(node, dict):
        return any(_has_quant(v) for v in node.values())
    if isinstance(node, (list, tuple)):
        return any(_has_quant(v) for v in node)
    return False


# id(packed tree) -> (packed tree, converted tree): the strong reference to
# the packed tree keeps its id stable, so the temperature ladder and the
# windows of a file reuse one conversion. The serving batcher calls the
# policy from worker threads: the lock keeps one thread at a time on it.
_DENSE_DECODE_CACHE: dict = {}
_DENSE_DECODE_LOCK = threading.Lock()


def maybe_dense_decode_params(params: Any, rows: int,
                              dtype: torch.dtype = torch.bfloat16) -> Any:
    """The serving policy for packed 4/8-bit whisper checkpoints by the
    decode loop's matmul rows (windows x beam or best_of), as the reference
    sets it:

    - ``rows <= WTPU_DENSE_ROWS_MIN`` (16): the packed tree as it is (the
      fused kernel K5 streams a quarter of the weight bytes), or with
      ``WTPU_FEWROW_MBT=1`` the tree transposed once to K6's layout;
    - more rows: the tree unfused and dequantized once to ``dtype``; the
      loop then runs plain matmuls.

    Conversions are cached by the packed tree's identity (at most three
    entries; both trees stay on the device while cached)."""
    few = rows <= int(os.environ.get("WTPU_DENSE_ROWS_MIN", "16"))
    if few and os.environ.get("WTPU_FEWROW_MBT", "0") != "1":
        return params
    key = ("mbt", id(params)) if few else id(params)
    with _DENSE_DECODE_LOCK:
        hit = _DENSE_DECODE_CACHE.get(key)
        if hit is not None and hit[0] is params:
            return hit[1]
        if few:
            out = prepare_mbt_params(params)
        elif not _has_quant(params):
            return params
        else:
            # fused qkv only helps the packed path: split it back first
            out = dequantize_params(unfuse_whisper_qkv(params), dtype=dtype)
            if len(_DENSE_DECODE_CACHE) > 2:
                _DENSE_DECODE_CACHE.clear()
        _DENSE_DECODE_CACHE[key] = (params, out)
    return out


def _check_leaf(q: Any) -> None:
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


def prepare_native_params(params: Any, embed_keys: tuple = ("embed", "token_emb"),
                          embed_dtype: torch.dtype = torch.bfloat16,
                          decode_rows: int = 1) -> Any:
    """Packed leaves -> decode-ready ones by the decode loop's matmul rows
    (``ops/quant.py:prepare_native_params`` of the reference): at most 16
    rows, :class:`NativeQuantTensor` leaves; more, :class:`DenseWeight`
    leaves dequantized once to ``embed_dtype``. Embedding tables (dict keys
    in ``embed_keys``) that are packed dequantize to ``embed_dtype`` tensors;
    native ones stay native at few rows."""
    native = decode_rows <= 16

    def walk(node):
        if isinstance(node, QuantTensor):
            return to_native(node) if native else DenseWeight(node.dequantize(embed_dtype))
        if isinstance(node, NativeQuantTensor):
            return node if native else DenseWeight(node.dequantize(embed_dtype))
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if k in embed_keys and isinstance(v, QuantTensor):
                    out[k] = v.dequantize(embed_dtype)
                elif k in embed_keys and isinstance(v, NativeQuantTensor):
                    out[k] = v if native else v.dequantize(embed_dtype)
                else:
                    out[k] = walk(v)
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(params)


def promote_resident_native(params: Any, budget_bytes: int | None = 9 << 30
                            ) -> tuple[Any, bool]:
    """Every packed leaf -> :class:`NativeQuantTensor`
    (``ops/quant.py:promote_resident_native`` of the reference), unless the
    tree holds more than ``budget_bytes`` elements (None: no limit; the
    reference's budget at one byte an element) -> ``(params, promoted)``."""
    leaves: list[QuantTensor] = []

    def scan(node):
        if isinstance(node, QuantTensor):
            leaves.append(node)
        elif isinstance(node, dict):
            for v in node.values():
                scan(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                scan(v)

    scan(params)
    if not leaves:
        return params, False
    if budget_bytes is not None and sum(q.shape[0] * q.shape[1] for q in leaves) > budget_bytes:
        return params, False

    def walk(node):
        if isinstance(node, QuantTensor):
            return to_native(node)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(params), True


NATIVE_MAX_ROWS = 32  # the grouped form's rows (``ops/quant.py:native_group_matmul``)
NATIVE_MAX_PARTIAL = 768 * 1024 * 1024  # bytes of its fp32 (rows, out, groups) partial


def native_group_matmul(x: torch.Tensor, q: NativeQuantTensor) -> torch.Tensor:
    """``x @ dequant(q).T`` over a native leaf by the reference's row rule:
    up to :data:`NATIVE_MAX_ROWS` rows and a grouped partial of at most
    :data:`NATIVE_MAX_PARTIAL` bytes, kernel K5 on the packed words (its
    plain version on a CPU tensor); past it, dequantize to x's dtype and
    ``torch.matmul``."""
    rows = x.numel() // x.shape[-1]
    n, groups = q.scales.shape
    if rows > NATIVE_MAX_ROWS or rows * n * groups * 4 > NATIVE_MAX_PARTIAL:
        return torch.matmul(x, q.dequantize(x.dtype).T)
    return quant_matmul_kernel(x, q.w_q, q.scales, q.biases, q.bits, q.group_size)


def quant_matmul(x: torch.Tensor, q: Any) -> torch.Tensor:
    """``x @ dequant(q).T``: x ``(..., in)`` -> ``(..., out)`` in x's dtype.

    At most ``WTPU_QMM_PALLAS_MAX_ROWS`` (512) rows: the leaf's kernel (its
    plain version on CPU tensors); more rows: dequantize to x's dtype and
    ``torch.matmul``, the reference's policy (module docstring). On CUDA
    tensors a bound below 512 raises: it would take calls away from the
    kernels.
    """
    from whisper_mlx_tpu_torch.ops import quant_a8
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
    if isinstance(q, DenseWeight):
        return torch.matmul(x, q.w.to(x.dtype).T)
    if isinstance(q, NativeQuantTensor):
        return native_group_matmul(x, q)
    rows = x.numel() // x.shape[-1]
    if isinstance(q, (A8Tensor, QuantTensorT)):
        if rows > max_rows:
            if isinstance(q, A8Tensor):
                quant_a8.ROWS_DEQUANT_CALLS += 1
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
