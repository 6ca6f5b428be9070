"""Quantized KV caches: quantization and the attention dispatchers.

Counterpart of ``whisper_mlx_tpu/ops/kv_quant.py`` for the greedy slice.
K/V are quantized per (row, head, position) with a bf16 scale, and the
dequantization folds exactly into the attention algebra:

    scores_t = (q . k8_t) * sk_t
    out      = sum_t (softmax_t * sv_t) . v8_t

Codes and scales are bit-identical to the JAX ``quantize_kv``. int4 codes
are packed two nibbles per byte along hd (``ops/decode_attention.py``).
The integer-dot mode (``attention_int8_mxu``) is not ported here.
"""

from __future__ import annotations

import torch

from whisper_mlx_tpu_torch.ops.decode_attention import (
    decode_attention,
    pack_int4,
    unpack_int4,
)

__all__ = ["quantize_kv", "pack_int4", "unpack_int4", "attention_int8_auto",
           "attention_int8_grouped"]


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
    scale = (torch.clamp_min(absmax / qmax, 1e-8) * (1.0 + 2.0 ** -8)).to(torch.bfloat16)
    codes = torch.clamp(torch.round(x32 / scale.float()), -qmax, qmax).to(torch.int8)
    if bits == 4:
        codes = pack_int4(codes)
    return codes, scale[..., 0]


# The JAX package's dispatcher names: ``decode_attention`` already runs
# kernel K3 on CUDA tensors and its plain version on CPU tensors, and takes
# ``group`` for the grouped (best_of) form.
attention_int8_auto = decode_attention
attention_int8_grouped = decode_attention
