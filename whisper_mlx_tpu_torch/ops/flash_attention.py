"""Online-softmax attention, causal or not, over grouped KV heads (kernel K4)
and its plain PyTorch version.

``flash_attention(q, k, v, causal)`` takes q ``(B, H, Tq, hd)`` and k, v
``(B, KV, Tk, hd)`` with ``H % KV == 0``; query head ``h`` reads KV head
``h // (H // KV)``, so GQA needs no repeated K/V. q and k come pre-scaled
by ``hd**-0.25``; no further scale is applied. ``causal`` masks keys after
the query's index (a prefill at position 0). The result has q's dtype.

On a CUDA tensor the wrapper launches ``csrc/flash_attention.cu`` (bf16,
hd in 16, 32, 64, 128); on a CPU tensor it runs
:func:`flash_attention_plain`, which computes in fp32 as the TPU kernel did.
Counterpart of ``whisper_mlx_tpu/ops/flash_attention.py:flash_attention``.
"""

from __future__ import annotations

import torch

from whisper_mlx_tpu_torch.ops import _build

LAUNCHES = 0
HEAD_DIMS = (16, 32, 64, 128)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False) -> torch.Tensor:
    """fp32 scores, softmax and ``p . v``; the result in q's dtype."""
    b, h, tq, hd = q.shape
    kvh, tk = k.shape[1], k.shape[2]
    q5 = q.float().reshape(b, kvh, h // kvh, tq, hd)
    s = torch.einsum("bgrqd,bgkd->bgrqk", q5, k.float())
    if causal:
        mask = torch.arange(tk, device=q.device)[None, :] > torch.arange(tq, device=q.device)[:, None]
        s = s.masked_fill(mask, float("-inf"))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrqk,bgkd->bgrqd", w, v.float())
    return out.reshape(b, h, tq, hd).to(q.dtype)


def _check_inputs(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4 or not t.is_contiguous() or t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} must be a contiguous (B, H, T, hd) "
                             f"{q.dtype} tensor on {q.device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    b, h, _, hd = q.shape
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd
            or k.shape[1] < 1 or h % k.shape[1]):
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)} do not match")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Attention over grouped KV heads; kernel K4 on CUDA tensors."""
    _check_inputs(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, h, tq, hd = q.shape
    if q.dtype != torch.bfloat16 or hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernel takes bfloat16 with hd in "
                         f"{HEAD_DIMS}, got {q.dtype} hd {hd}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k and v must be 16-byte aligned")
    out = torch.empty_like(q)
    rc = _build.lib().wmt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, k.shape[1],
        tq, k.shape[2], hd, int(causal), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "wmt_flash_attention")
    global LAUNCHES
    LAUNCHES += 1
    return out
