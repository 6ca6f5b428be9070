"""Decode attention over a quantized KV cache (kernel K3) and its plain
PyTorch version.

Cache layout, position-major within a head so a decode step's write is
one contiguous row per (row, head):

- codes ``(B, H, T, 64)`` int8, or ``(B, H, T, 32)`` uint8 holding two
  signed int4 nibbles per byte (low nibble = even d, high = odd d);
- scales ``(B, H, T)`` bf16 (``ops/kv_quant.py:quantize_kv``).

Query row ``b`` of ``q (B*g, H, Tq, 64)`` reads KV row ``b // g``: g = 1
is plain decode attention, g > 1 is the cross cache that best_of candidates
or beam lanes share. Keys ``t <= pos + i`` (``causal``) and
``t < valid_len`` are attended.

Two modes. The fp mode is the function of ``whisper_mlx_tpu/ops/
decode_attention.py:decode_attention_int8`` (``kv_quant.py:
attention_int8_auto`` / ``_grouped``). ``int_dot=True`` is the integer-dot
mode of ``kv_quant.py:attention_int8_mxu`` / ``_grouped_mxu``: q and the
value-side weights ``w * vs`` are re-quantized per row to int8
(:func:`quantize_rows`) and both dots are s8 x s8 -> s32.

On a CUDA tensor ``decode_attention`` launches ``csrc/decode_attention.cu``
(bf16 queries) in either mode; on a CPU tensor it runs
:func:`decode_attention_plain`.
"""

from __future__ import annotations

import torch

from whisper_mlx_tpu_torch.ops import _build

LAUNCHES = 0  # fp mode
INT_DOT_LAUNCHES = 0  # integer-dot mode
HEAD_DIM = 64
MAX_T = 2048


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """uint8 ``(..., d/2)`` nibble pairs -> int8 codes ``(..., d)``."""
    x = packed.to(torch.int16)
    lo = ((x & 0xF) ^ 8) - 8
    hi = ((x >> 4) ^ 8) - 8
    return torch.stack([lo, hi], dim=-1).flatten(-2).to(torch.int8)


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """int8 codes in [-8, 7] ``(..., d)`` -> uint8 nibble pairs ``(..., d/2)``."""
    x = codes.to(torch.int16)
    lo = x[..., 0::2] & 0xF
    hi = x[..., 1::2] & 0xF
    return (lo | (hi << 4)).to(torch.uint8)


def unpack_codes(codes: torch.Tensor) -> torch.Tensor:
    """int8 codes, or packed int4 widened to int8."""
    return unpack_int4(codes) if codes.dtype == torch.uint8 else codes


def quantize_rows(x32: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row (last axis) symmetric int8 of fp32 ``x32``: codes
    ``round_half_even(x / s)`` clipped to +-127 and the fp32 scale
    ``s = max(absmax, 1e-30) / 127`` (keepdim). The recipe of
    ``whisper_mlx_tpu/ops/kv_quant.py:_quantize_rows``. The divisor is a
    tensor: PyTorch divides by a Python number on CUDA as a product with its
    reciprocal, an ulp off the true quotient at times, which would move
    codes and the kernels' plain versions on the card."""
    absmax = x32.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(absmax, 1e-30) / torch.full_like(absmax, 127.0)
    return torch.clamp(torch.round(x32 / scale), -127.0, 127.0).to(torch.int8), scale


def int_einsum(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An einsum of int8 codes, exact: float64 holds every s32 sum of these
    shapes, and the result is rounded to fp32 as an s32 -> fp32 cast is."""
    return torch.einsum(spec, a.double(), b.double()).float()


def decode_attention_plain(q, k, ks, v, vs, *, pos: int = 0, causal: bool = False,
                           valid_len: int | None = None, group: int = 1,
                           int_dot: bool = False) -> torch.Tensor:
    """Scale-folded attention over the dequantized grid. fp mode: ``w * vs``
    is rounded to bf16 when the queries are bf16, as the kernel does.
    ``int_dot``: the integer-dot function of ``attention_int8_mxu``."""
    if int_dot:
        return _int_dot_plain(q, k, ks, v, vs, pos, causal, valid_len, group)
    bq, h, tq, hd = q.shape
    n = bq // group
    limit = k.shape[2] if valid_len is None else valid_len
    if causal:
        limit = min(limit, pos + tq)
    kf = unpack_codes(k[:, :, :limit]).float()
    vf = unpack_codes(v[:, :, :limit]).float()
    ksf = ks[:, :, :limit].float()[:, None, :, None, :]
    vsf = vs[:, :, :limit].float()[:, None, :, None, :]
    q5 = q.float().reshape(n, group, h, tq, hd)
    s = torch.einsum("nghqd,nhkd->nghqk", q5, kf) * ksf
    if causal:
        k_idx = torch.arange(limit, device=q.device)[None, :]
        q_idx = torch.arange(tq, device=q.device)[:, None] + pos
        s = s.masked_fill(k_idx > q_idx, float("-inf"))
    w = torch.softmax(s, dim=-1) * vsf
    if q.dtype == torch.bfloat16:
        w = w.to(torch.bfloat16).float()
    out = torch.einsum("nghqk,nhkd->nghqd", w, vf)
    return out.reshape(bq, h, tq, hd).to(q.dtype)


def _int_dot_plain(q, k, ks, v, vs, pos, causal, valid_len, group) -> torch.Tensor:
    bq, h, tq, hd = q.shape
    n = bq // group
    limit = k.shape[2] if valid_len is None else valid_len
    if causal:
        limit = min(limit, pos + tq)
    q8, qs = quantize_rows(q.float())
    s32 = int_einsum("nghqd,nhkd->nghqk", q8.reshape(n, group, h, tq, hd),
                     unpack_codes(k[:, :, :limit]))
    s = s32 * qs.reshape(n, group, h, tq, 1) * ks[:, :, :limit].float()[:, None, :, None, :]
    if causal:
        k_idx = torch.arange(limit, device=q.device)[None, :]
        q_idx = torch.arange(tq, device=q.device)[:, None] + pos
        s = s.masked_fill(k_idx > q_idx, float("-inf"))
    wv = torch.softmax(s, dim=-1) * vs[:, :, :limit].float()[:, None, :, None, :]
    w8, ws = quantize_rows(wv)
    out = int_einsum("nghqk,nhkd->nghqd", w8, unpack_codes(v[:, :, :limit])) * ws
    return out.reshape(bq, h, tq, hd).to(q.dtype)


def _check_inputs(q, k, ks, v, vs, pos, causal, valid_len, group) -> tuple[int, int]:
    """The kernel's input contract, checked on every device so the CPU
    tests hold the callers to it; returns (code width in bits, valid_len)."""
    if q.dim() != 4:
        raise ValueError(f"decode_attention: q must be (B, H, Tq, hd), got {tuple(q.shape)}")
    bq, h, tq, hd = q.shape
    if k.dtype != v.dtype or k.shape != v.shape:
        raise ValueError("decode_attention: k and v codes differ in dtype or shape")
    bits = {torch.int8: 8, torch.uint8: 4}.get(k.dtype)
    if bits is None or k.dim() != 4 or k.shape[-1] != hd * bits // 8:
        raise ValueError(f"decode_attention: codes must be int8 (.., {hd}) or "
                         f"uint8 (.., {hd // 2}), got {tuple(k.shape)} {k.dtype}")
    n, _, t_alloc, _ = k.shape
    for name, s in (("ks", ks), ("vs", vs)):
        if s.dtype != torch.bfloat16 or tuple(s.shape) != (n, h, t_alloc):
            raise ValueError(f"decode_attention: {name} must be ({n}, {h}, {t_alloc}) "
                             f"bfloat16, got {tuple(s.shape)} {s.dtype}")
    for name, t in (("q", q), ("k", k), ("ks", ks), ("v", v), ("vs", vs)):
        if not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be contiguous")
        if t.device != q.device:
            raise ValueError("decode_attention: tensors on different devices")
    if group < 1 or n * group != bq or k.shape[1] != h:
        raise ValueError(f"decode_attention: {bq} query rows, {n} KV rows, group {group}")
    valid = t_alloc if valid_len is None else valid_len
    if not 1 <= valid <= t_alloc or t_alloc > MAX_T:
        raise ValueError(f"decode_attention: valid_len {valid}, cache length {t_alloc}")
    if causal and not 0 <= pos <= t_alloc - tq:
        raise ValueError(f"decode_attention: pos {pos} + {tq} rows past cache {t_alloc}")
    return bits, valid


def decode_attention(q, k, ks, v, vs, *, pos: int = 0, causal: bool = False,
                     valid_len: int | None = None, group: int = 1,
                     int_dot: bool = False) -> torch.Tensor:
    """Attention over a quantized cache; kernel K3 on CUDA tensors.

    ``pos`` is a host int: the position of the first query row.
    ``int_dot`` selects the integer-dot mode."""
    bits, valid = _check_inputs(q, k, ks, v, vs, pos, causal, valid_len, group)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, ks, v, vs, pos=pos, causal=causal,
                                      valid_len=valid_len, group=group, int_dot=int_dot)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    if q.dtype != torch.bfloat16 or q.shape[-1] != HEAD_DIM:
        raise ValueError(f"decode_attention: the kernel takes (B, H, Tq, {HEAD_DIM}) "
                         f"bfloat16 queries, got {tuple(q.shape)} {q.dtype}")
    bq, h, tq, _ = q.shape
    ptrs = (k.data_ptr(), ks.data_ptr(), v.data_ptr(), vs.data_ptr())
    if (ptrs[0] | ptrs[1] | ptrs[2] | ptrs[3]) % 16:  # the kernel bulk-copies from 16-byte
        k, ks, v, vs = (t.clone() for t in (k, ks, v, vs))  # boundaries
        ptrs = (k.data_ptr(), ks.data_ptr(), v.data_ptr(), vs.data_ptr())
    out = torch.empty_like(q)
    rc = _build.lib().wmt_decode_attention(
        q.data_ptr(), *ptrs, out.data_ptr(), bq, h, tq, k.shape[2], group, int(pos),
        int(causal), valid, bits,
        int(int_dot), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, "wmt_decode_attention")
    global LAUNCHES, INT_DOT_LAUNCHES
    if int_dot:
        INT_DOT_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out
