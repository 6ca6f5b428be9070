"""Fused dequant-matmul over MLX group-affine int4/int8 weights (kernel K5)
and its plain PyTorch version.

``quant_matmul_kernel(x, w_q, scales, biases, bits, group_size)`` computes
``x @ (s * v + b).T`` for x ``(..., K)`` and packed weights ``(N, K * bits
/ 32)`` int32 with fp32 ``(N, K / group_size)`` scales and biases, and
returns ``(..., N)`` in x's dtype. The numerics are the TPU kernel's
(``whisper_mlx_tpu/ops/quant_pallas.py:_quant_matmul_kernel``), read in
MLX's packing order (the TPU kernel's planar permutation exists only for
Mosaic and is not ported):

- bf16 x: each group's scale is rounded to bf16, each ``code * scale`` is
  rounded to bf16, and the products with x accumulate in fp32;
- fp32 x: everything in fp32;
- the bias enters as ``xg @ biases.T`` in fp32, ``xg`` being the per-group
  sums of x in fp32;
- the result is cast to x's dtype.

On a CUDA tensor the wrapper launches ``csrc/quant_matmul.cu`` (a GEMV for
at most ``GEMV_ROWS`` rows or fp32 x, a tiled tensor-core kernel for more
bf16 rows); on a CPU tensor it runs :func:`quant_matmul_plain`.
Counterpart of ``whisper_mlx_tpu/ops/quant_pallas.py:quant_matmul_pallas``.
"""

from __future__ import annotations

import torch

from whisper_mlx_tpu_torch.ops import _build

LAUNCHES = 0
# rows up to which the GEMV kernel runs (bf16); above it the tiled kernel
GEMV_ROWS = 8


def quant_matmul_plain(x: torch.Tensor, w_q: torch.Tensor, scales: torch.Tensor,
                       biases: torch.Tensor, bits: int, group_size: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch (same rounding points)."""
    from whisper_mlx_tpu_torch.ops.quant import unpack

    *lead, k = x.shape
    n = w_q.shape[0]
    g = k // group_size
    x2 = x.reshape(-1, k)
    compute = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    s = scales.to(compute).float()
    vals = unpack(w_q, bits).float().reshape(n, g, group_size)
    w = (vals * s[..., None]).to(compute).float().reshape(n, k)
    acc = torch.matmul(x2.float(), w.T)
    xg = x2.float().reshape(-1, g, group_size).sum(-1)
    acc = acc + torch.matmul(xg, biases.float().T)
    return acc.to(x.dtype).reshape(*lead, n)


def _check_inputs(x, w_q, scales, biases, bits, group_size) -> None:
    k = x.shape[-1]
    per_word = 32 // bits if bits in (4, 8) else 0
    if not per_word or group_size % (128 // bits) or k % group_size:
        raise ValueError(f"quant_matmul: bits {bits}, group_size {group_size}, K {k}")
    n = w_q.shape[0]
    if (w_q.dtype != torch.int32 or tuple(w_q.shape) != (n, k // per_word)
            or tuple(scales.shape) != (n, k // group_size) or scales.shape != biases.shape
            or scales.dtype != torch.float32 or biases.dtype != torch.float32):
        raise ValueError(f"quant_matmul: x {tuple(x.shape)}, w_q {tuple(w_q.shape)} "
                         f"{w_q.dtype}, scales {tuple(scales.shape)} {scales.dtype}, "
                         f"biases {tuple(biases.shape)} {biases.dtype}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"quant_matmul: x must be bfloat16 or float32, got {x.dtype}")
    for name, t in (("x", x), ("w_q", w_q), ("scales", scales), ("biases", biases)):
        if t.device != x.device:
            raise ValueError(f"quant_matmul: {name} on {t.device}, x on {x.device}")


def quant_matmul_kernel(x: torch.Tensor, w_q: torch.Tensor, scales: torch.Tensor,
                        biases: torch.Tensor, bits: int, group_size: int) -> torch.Tensor:
    """``x @ dequant(w).T``; kernel K5 on CUDA tensors."""
    _check_inputs(x, w_q, scales, biases, bits, group_size)
    if x.device.type == "cpu":
        return quant_matmul_plain(x, w_q, scales, biases, bits, group_size)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul: unsupported device {x.device}")
    for name, t in (("w_q", w_q), ("scales", scales), ("biases", biases)):
        if not t.is_contiguous():
            raise ValueError(f"quant_matmul: {name} must be contiguous")
    *lead, k = x.shape
    n = w_q.shape[0]
    x2 = x.reshape(-1, k).contiguous()
    if x2.data_ptr() % 16:  # the kernels load x 16 bytes at a time
        x2 = x2.clone()
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return out.reshape(*lead, n)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if x.dtype == torch.float32 or m <= GEMV_ROWS or k % 64:
        rc = _build.lib().wmt_quant_gemv(
            x2.data_ptr(), w_q.data_ptr(), scales.data_ptr(), biases.data_ptr(),
            out.data_ptr(), m, n, k, bits, group_size,
            int(x.dtype == torch.bfloat16), stream)
        _build.check(rc, "wmt_quant_gemv")
    else:
        xg = x2.float().reshape(m, k // group_size, group_size).sum(-1)
        rc = _build.lib().wmt_quant_gemm(
            x2.data_ptr(), xg.data_ptr(), w_q.data_ptr(), scales.data_ptr(),
            biases.data_ptr(), out.data_ptr(), m, n, k, bits, group_size, stream)
        _build.check(rc, "wmt_quant_gemm")
    global LAUNCHES
    LAUNCHES += 1
    return out.reshape(*lead, n)
