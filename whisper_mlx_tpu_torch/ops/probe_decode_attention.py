"""The decode-attention probe kernels (K11, K12) and their plain PyTorch
versions.

``batched_attention`` (K11) is the counterpart of
``scripts/bench_decode_attention.py:batched_attention``: attention of a few
query rows over an int8 cache with per-position fp32 scales, keys stored
time-minor ``(B, H, hd, Tk)`` and values time-major ``(B, H, Tk, hd)``
(kernel K3, ``ops/decode_attention.py``, keeps both position-major):

    s_t = (q . K[:, t]) * ks_t;   t < valid_len and, causal, t <= pos + i
    w   = softmax(s) in fp32;     w_t * vs_t rounded to bf16
    out = sum_t (w_t vs_t) V[t]   -> q's dtype

``ablation_stage`` (K12) is the counterpart of
``scripts/bench_da_ablation.py:run``: five cumulative stages of that work
over int8 K and V both ``(BH, hd, Tk)``, without scales, one query a pair:
``dmak`` (move K, use one element), ``dma`` (move K and V), ``cast`` (the
row maxima of both, added to q in bf16), ``dots`` (both dots around
``w = bf16(s * 1e-4)``) and ``full`` (with the fp32 softmax).

``bh_tile`` is the number of (row, head) pairs a block takes: K11 shares
the block's warps among them (four a pair up to 8 pairs, two up to 16, one
above), K12 gives each pair one warp. On a CUDA tensor both wrappers launch
``csrc/probe_decode_attention.cu`` or raise; on a CPU tensor they run the
plain versions. ``LAUNCHES`` counts K11's launches, ``STAGE_LAUNCHES`` K12's
by stage.
"""

from __future__ import annotations

import torch

from whisper_mlx_tpu_torch.ops import _build

HEAD_DIM = 64
STAGES = ("dmak", "dma", "cast", "dots", "full")
LAUNCHES = 0
STAGE_LAUNCHES = {name: 0 for name in STAGES}
# dynamic shared memory a block may ask for on the card
MAX_SMEM = 232_448


def batched_attention_plain(q, k8t, ks, v8, vs, pos: int = 0, causal: bool = False,
                            valid_len: int | None = None) -> torch.Tensor:
    """K11's function in plain PyTorch (same rounding points)."""
    tq, tk = q.shape[2], k8t.shape[3]
    limit = tk if valid_len is None else valid_len
    s = torch.matmul(q.to(torch.bfloat16).float(), k8t.float()) * ks.float()[:, :, None, :]
    k_idx = torch.arange(tk, device=q.device)[None, :]
    valid = (k_idx < limit).expand(tq, tk)
    if causal:
        valid = valid & (k_idx <= torch.arange(tq, device=q.device)[:, None] + pos)
    w = torch.softmax(s.masked_fill(~valid, -1e30), dim=-1) * vs.float()[:, :, None, :]
    out = torch.matmul(w.to(torch.bfloat16).float(), v8.float())
    return out.to(q.dtype)


def batched_attention(q: torch.Tensor, k8t: torch.Tensor, ks: torch.Tensor, v8: torch.Tensor,
                      vs: torch.Tensor, pos: int = 0, causal: bool = False,
                      valid_len: int | None = None, bh_tile: int = 16) -> torch.Tensor:
    """One-query attention over a time-minor int8 cache; kernel K11 on CUDA
    tensors. q ``(B, H, Tq, 64)`` bf16, ``k8t (B, H, 64, Tk)`` and
    ``v8 (B, H, Tk, 64)`` int8, ``ks``, ``vs`` ``(B, H, Tk)`` fp32."""
    b, h, tq, hd = q.shape
    tk = k8t.shape[-1]
    if valid_len is None:
        valid_len = tk
    want = {"k8t": ((b, h, hd, tk), torch.int8), "v8": ((b, h, tk, hd), torch.int8),
            "ks": ((b, h, tk), torch.float32), "vs": ((b, h, tk), torch.float32)}
    for name, t in (("k8t", k8t), ("v8", v8), ("ks", ks), ("vs", vs)):
        if (tuple(t.shape), t.dtype) != want[name] or t.device != q.device:
            raise ValueError(f"batched_attention: {name} must be {want[name]} on {q.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    if not 1 <= valid_len <= tk or pos < 0 or not 1 <= bh_tile <= 32:
        raise ValueError(f"batched_attention: valid_len {valid_len} of {tk}, pos {pos}, "
                         f"bh_tile {bh_tile}")
    if q.device.type == "cpu":
        return batched_attention_plain(q, k8t, ks, v8, vs, pos, causal, valid_len)
    if q.device.type != "cuda":
        raise ValueError(f"batched_attention: unsupported device {q.device}")
    tensors = (q, k8t, ks, v8, vs)
    if (q.dtype != torch.bfloat16 or hd != HEAD_DIM or tk % 4
            or any(not t.is_contiguous() or t.data_ptr() % 16 for t in tensors)):
        raise ValueError(f"batched_attention: the kernel takes contiguous, 16-byte aligned "
                         f"tensors, q (B, H, Tq, {HEAD_DIM}) bfloat16 and Tk a multiple of 4, "
                         f"got q {tuple(q.shape)} {q.dtype}, Tk {tk}")
    warps = 4 if bh_tile <= 8 else 2 if bh_tile <= 16 else 1  # warps a pair, as the launcher
    if bh_tile * (tk + HEAD_DIM + 8 + warps * HEAD_DIM) * 4 > MAX_SMEM:
        raise ValueError(f"batched_attention: bh_tile {bh_tile} x Tk {tk} scores do not fit "
                         f"a block's {MAX_SMEM} bytes of shared memory")
    out = torch.empty_like(q)
    rc = _build.lib().wmt_probe_batched_attention(
        q.data_ptr(), k8t.data_ptr(), ks.data_ptr(), v8.data_ptr(), vs.data_ptr(),
        out.data_ptr(), b * h, tq, tk, valid_len, int(causal), pos, bh_tile,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "wmt_probe_batched_attention")
    global LAUNCHES
    LAUNCHES += 1
    return out


def ablation_stage_plain(q: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor,
                         stage: str) -> torch.Tensor:
    """K12's function in plain PyTorch: q ``(BH, 1, 64)`` bf16, kt and vt
    ``(BH, 64, Tk)`` int8 -> ``(BH, 1, 64)`` bf16."""

    def bf(t):
        return t.to(torch.bfloat16)

    if stage == "dmak":
        return q + bf(kt[:, 0:1, 0:1])
    if stage == "dma":
        return q + bf(kt[:, 0:1, 0:1]) + bf(vt[:, 0:1, 0:1])
    if stage == "cast":
        return q + bf(kt).amax(dim=2)[:, None, :] + bf(vt).amax(dim=2)[:, None, :]
    s = torch.matmul(q.float(), kt.float())  # (BH, 1, Tk)
    w = bf(s * 1e-4) if stage == "dots" else bf(torch.softmax(s, dim=-1))
    return bf(torch.matmul(w.float(), vt.float().transpose(1, 2)))


def ablation_stage(q: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor, stage: str,
                   bh_tile: int = 16) -> torch.Tensor:
    """One ablation stage; kernel K12 on CUDA tensors."""
    if stage not in STAGES:
        raise ValueError(f"ablation_stage: stage {stage!r} is not one of {STAGES}")
    bh, one, hd = q.shape
    tk = kt.shape[-1]
    for name, t in (("kt", kt), ("vt", vt)):
        if tuple(t.shape) != (bh, hd, tk) or t.dtype != torch.int8 or t.device != q.device:
            raise ValueError(f"ablation_stage: {name} must be ({bh}, {hd}, Tk) int8 on "
                             f"{q.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    if one != 1 or q.dtype != torch.bfloat16 or not 1 <= bh_tile <= 32:
        raise ValueError(f"ablation_stage: q must be (BH, 1, hd) bfloat16 and bh_tile in "
                         f"1..32, got {tuple(q.shape)} {q.dtype}, bh_tile {bh_tile}")
    if q.device.type == "cpu":
        return ablation_stage_plain(q, kt, vt, stage)
    if q.device.type != "cuda":
        raise ValueError(f"ablation_stage: unsupported device {q.device}")
    if (hd != HEAD_DIM or tk % 16
            or any(not t.is_contiguous() or t.data_ptr() % 16 for t in (q, kt, vt))):
        raise ValueError(f"ablation_stage: the kernel takes contiguous, 16-byte aligned "
                         f"tensors, hd {HEAD_DIM} and Tk a multiple of 16, got hd {hd}, Tk {tk}")
    warp_bytes = 2 * tk + 512 + (4 * tk if stage in ("dots", "full") else 0)
    if bh_tile * warp_bytes > MAX_SMEM:
        raise ValueError(f"ablation_stage: bh_tile {bh_tile} x Tk {tk} at stage {stage} does "
                         f"not fit a block's {MAX_SMEM} bytes of shared memory")
    out = torch.empty_like(q)
    rc = _build.lib().wmt_probe_ablation(
        q.data_ptr(), kt.data_ptr(), vt.data_ptr(), out.data_ptr(), bh, tk,
        STAGES.index(stage), bh_tile, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, f"wmt_probe_ablation[{stage}]")
    STAGE_LAUNCHES[stage] += 1
    return out
