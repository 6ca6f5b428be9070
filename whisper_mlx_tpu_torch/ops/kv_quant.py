"""Quantized KV caches: quantization and the attention dispatchers.

Counterpart of ``whisper_mlx_tpu/ops/kv_quant.py`` for the greedy and beam
paths. K/V are quantized per (row, head, position) with a bf16 scale, and
the dequantization folds exactly into the attention algebra:

    scores_t = (q . k8_t) * sk_t
    out      = sum_t (softmax_t * sv_t) . v8_t

Codes and scales are bit-identical to the JAX ``quantize_kv``. int4 codes
are packed two nibbles per byte along hd (``ops/decode_attention.py``).
The integer-dot mode (``attention_int8_mxu`` / ``_grouped_mxu``, the beam
default over quantized caches) re-quantizes q and ``w * vs`` per row with
:func:`_quantize_rows` and runs both dots s8 x s8 -> s32; it is kernel K3's
``int_dot`` mode. Beam self-attention over the flat cache is
``ops/beamflat_attention.py`` (kernel K8).

The reference's time-major caches (``WTPU_SELF_KV_LAYOUT`` /
``WTPU_KV_LAYOUT`` = ``tmajor``: codes ``(T, b, h * d)``, scales ``(T, b,
h)``) compute ``attention_int8_auto``'s fp32 function over another layout.
The port keeps its caches position-major and runs that function on K3's fp
mode (``models/whisper.py``); :func:`attention_int8_tmajor`,
:func:`attention_int8_tmajor_cross` and :func:`attention_int8_tmajor_grouped`
are plain CPU ports of the reference's three for the tests, which hold
them against K3's plain version through
``checkpoint/convert.py:tmajor_cache_from_jax``.
"""

from __future__ import annotations

import torch

from whisper_mlx_tpu_torch.ops.decode_attention import (
    decode_attention,
    pack_int4,
    quantize_rows as _quantize_rows,
    unpack_int4,
)

__all__ = ["quantize_kv", "pack_int4", "unpack_int4", "attention_int8_auto",
           "attention_int8_grouped", "attention_int8_mxu", "attention_int8_grouped_mxu",
           "attention_int8_tmajor", "attention_int8_tmajor_cross",
           "attention_int8_tmajor_grouped", "_quantize_rows"]


def quantize_kv(x: torch.Tensor, bits: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """(b, h, t, d) float -> codes + per-(b, h, t) bf16 scales ``(b, h, t)``.

    bits=8: int8 codes ``(b, h, t, d)`` (absmax/127); bits=4: packed uint8
    ``(b, h, t, d/2)`` (absmax/7). The scale is
    ``max(absmax/qmax, 1e-8) * (1 + 2^-8)`` rounded to bf16, and the codes
    are ``round_half_even(x / scale)`` clipped to +-qmax."""
    if bits not in (4, 8):
        raise ValueError(f"quantize_kv: bits must be 4 or 8, got {bits}")
    x32 = x.float().contiguous()  # codes and scales come out contiguous
    absmax = x32.abs().amax(dim=-1, keepdim=True)
    qmax = 127.0 if bits == 8 else 7.0
    # a true division by a tensor: on CUDA PyTorch divides by a Python number
    # as a product with its reciprocal, an ulp off the CPU's quotient at times
    ratio = absmax / torch.full_like(absmax, qmax)
    scale = (torch.clamp_min(ratio, 1e-8) * (1.0 + 2.0 ** -8)).to(torch.bfloat16)
    codes = torch.clamp(torch.round(x32 / scale.float()), -qmax, qmax).to(torch.int8)
    if bits == 4:
        codes = pack_int4(codes)
    return codes, scale[..., 0]


# The JAX package's dispatcher names: ``decode_attention`` already runs
# kernel K3 on CUDA tensors and its plain version on CPU tensors, and takes
# ``group`` for the grouped (best_of, beam) form.
attention_int8_auto = decode_attention
attention_int8_grouped = decode_attention


def attention_int8_mxu(q, k, ks, v, vs, **kw) -> torch.Tensor:
    """Integer-dot attention (``kv_quant.py:attention_int8_mxu``; with
    ``group=g`` its grouped twin): K3 in its ``int_dot`` mode."""
    return decode_attention(q, k, ks, v, vs, int_dot=True, **kw)


attention_int8_grouped_mxu = attention_int8_mxu


def _tmajor_kv(q, kT, vT):
    """CPU-only time-major codes ``(T, b, h * d)`` (int8 holding int8 or
    int4 values) -> fp32 ``(T, b, h, d)`` keys and values."""
    if q.is_cuda:
        raise ValueError("the time-major plain versions run on CPU tensors only; on CUDA the "
                         "caches are position-major and kernel K3 runs")
    t, b = kT.shape[:2]
    h, d = q.shape[1], q.shape[-1]
    return kT.float().reshape(t, b, h, d), vT.float().reshape(t, b, h, d)


def attention_int8_tmajor(q, kT, ksT, vT, vsT, pos: int) -> torch.Tensor:
    """Causal self-attention over a time-major cache
    (``kv_quant.py:attention_int8_tmajor``): pre-scaled q ``(b, h, tq, d)``,
    query i at position ``pos + i``; fp32 products and sums."""
    kv, vv = _tmajor_kv(q, kT, vT)
    t_len = kv.shape[0]
    s = torch.einsum("bhid,tbhd->tbhi", q.float(), kv) * ksT.float()[..., None]
    t_idx = torch.arange(t_len)[:, None, None, None]
    q_idx = pos + torch.arange(q.shape[2])[None, None, None, :]
    w = torch.softmax(s.masked_fill(t_idx > q_idx, float("-inf")), dim=0)
    out = torch.einsum("tbhi,tbhd->bhid", w * vsT.float()[..., None], vv)
    return out.to(q.dtype)


def attention_int8_tmajor_cross(q, kT, ksT, vT, vsT) -> torch.Tensor:
    """Non-causal twin (``kv_quant.py:attention_int8_tmajor_cross``): every
    position of the time-major cross cache is attended."""
    kv, vv = _tmajor_kv(q, kT, vT)
    s = torch.einsum("bhid,tbhd->tbhi", q.float(), kv) * ksT.float()[..., None]
    w = torch.softmax(s, dim=0) * vsT.float()[..., None]
    return torch.einsum("tbhi,tbhd->bhid", w, vv).to(q.dtype)


def attention_int8_tmajor_grouped(q5, kT, ksT, vT, vsT) -> torch.Tensor:
    """Grouped twin (``kv_quant.py:attention_int8_tmajor_grouped``): q5
    ``(n, g, h, tq, d)``, the g rows of a window sharing its cross cache
    ``(T, n, h * d)``."""
    n, g, h, tq, d = q5.shape
    kv, vv = _tmajor_kv(q5[:, 0], kT, vT)
    s = torch.einsum("nghid,tnhd->tnghi", q5.float(), kv) * ksT.float()[:, :, None, :, None]
    w = torch.softmax(s, dim=0) * vsT.float()[:, :, None, :, None]
    return torch.einsum("tnghi,tnhd->nghid", w, vv).to(q5.dtype)
