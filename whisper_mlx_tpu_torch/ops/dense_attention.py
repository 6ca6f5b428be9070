"""Encoder self-attention (kernel K2) and its plain PyTorch version.

Non-causal attention over whole key rows with q and k pre-scaled by
``hd**-0.25``: fp32 scores, fp32 softmax, weights rounded to the
activations' dtype for ``w . v``. On a CUDA tensor ``dense_attention``
launches the hand-written kernel in ``csrc/dense_attention.cu`` (bf16,
hd = 64); on a CPU tensor it runs :func:`dense_attention_plain`.

Counterpart of ``whisper_mlx_tpu/ops/dense_attention.py:dense_attention``.
The bf16 softmax opt-in of the TPU kernel (``WTPU_DENSE_SOFTMAX``) is not
ported.
"""

from __future__ import annotations

import torch

from whisper_mlx_tpu_torch.ops import _build

LAUNCHES = 0
HEAD_DIM = 64


def dense_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, H, Tq, hd) x (B, H, Tk, hd) -> (B, H, Tq, hd), q and k pre-scaled."""
    compute = torch.bfloat16 if q.dtype == torch.bfloat16 else torch.float32
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    w = torch.softmax(s, dim=-1).to(compute)
    out = torch.matmul(w.float(), v.to(compute).float())
    return out.to(q.dtype)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Full non-causal attention; kernel K2 on CUDA tensors."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4 or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"dense_attention: {name} must be a contiguous (B, H, T, hd) "
                             f"tensor on {q.device}, got {tuple(t.shape)}")
    if k.shape != v.shape or q.shape[:2] != k.shape[:2] or q.shape[-1] != k.shape[-1]:
        raise ValueError(f"dense_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)} do not match")
    if q.device.type == "cpu":
        return dense_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"dense_attention: unsupported device {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or t.shape[-1] != HEAD_DIM:
            raise ValueError(f"dense_attention: the kernel takes (B, H, T, {HEAD_DIM}) "
                             f"bfloat16, got {name} {tuple(t.shape)} {t.dtype}")
    b, h, tq, _ = q.shape
    tk = k.shape[2]
    out = torch.empty_like(q)
    rc = _build.lib().wmt_dense_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, tq, tk,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, "wmt_dense_attention")
    global LAUNCHES
    LAUNCHES += 1
    return out
