"""Beam self-attention over the lane-interleaved flat cache (kernel K8) and
its plain PyTorch version.

Cache layout, position-major like the port's other caches: a window's g
beam lanes share one cache whose row ``t * g + k`` holds lane k's position
t, so a step's write is the g contiguous rows ``[pos * g, pos * g + g)``:

- codes ``(n, H, T * g, 64)`` int8 or ``(n, H, T * g, 32)`` packed int4;
- scales ``(n, H, T * g)`` bf16;
- ``ancestry (n * g, T)`` int32 in ``[0, g)``: the lane whose row holds
  position t of lane b's hypothesis.

Query row b (window ``b // g``) attends positions ``t <= pos``, position t
at row ``t * g + ancestry[b, t]``. Two modes, as
``whisper_mlx_tpu/ops/kv_quant.py:attention_int8_beamflat``: fp
(``mxu=False``, the function of the TPU kernel
``ops/beamflat_attention.py:beamflat_attention_kernel``) and integer-dot
(``int_dot=True``, ``mxu=True``: q and ``w * vs`` re-quantized per row, s8 x
s8 -> s32 dots).

On a CUDA tensor :func:`beamflat_attention` launches
``csrc/beamflat_attention.cu``: one block per (window, head), or a cluster
of :func:`beamflat_plan`'s blocks past 256 positions, each reading the
distinct rows its span of positions needs (:func:`beamflat_rows_needed`
counts them); on a CPU tensor it runs
:func:`beamflat_attention_plain`, which masks all ``T * g`` rows as the
reference does. :func:`attention_fp_beamflat`, the fp cache's form, runs on
CPU tensors only.
"""

from __future__ import annotations

import torch

from whisper_mlx_tpu_torch.ops import _build
from whisper_mlx_tpu_torch.ops.decode_attention import (
    HEAD_DIM,
    MAX_T,
    int_einsum,
    quantize_rows,
    unpack_codes,
)

LAUNCHES = 0
MAX_CLUSTER = 8  # the portable cluster size
MAX_SPAN = MAX_T // MAX_CLUSTER  # most positions a block takes
LANES = 8  # lanes of a pass: the kernel's mma is 8 wide
CAP = 512  # most rows a chunk of the kernel's shared memory holds


def beamflat_plan(limit: int, group: int, span: int = MAX_SPAN) -> tuple[int, int]:
    """K8's launch, from shapes alone: ``cluster`` blocks a (window, head),
    block r taking positions ``[r * limit // cluster, (r + 1) * limit //
    cluster)`` of the ``limit = pos + 1`` live ones, at most ``span`` a
    block (by default one block up to 256 positions: on the H100 a
    cluster's two exchanges cost more than splitting them saves); and
    ``cap``, the rows a chunk of its shared memory holds: a pass's distinct
    rows at most (``min(group, 8)`` a position), in whole 16-row mma tiles,
    at most ``CAP`` (more rows take more chunks). -> (cluster, cap)."""
    if not 1 <= limit <= MAX_T or group < 1 or not 1 <= span <= MAX_SPAN:
        raise ValueError(f"beamflat_plan: limit {limit}, group {group}, span {span}")
    cluster = min(MAX_CLUSTER, limit, -(-limit // span))
    most = -(-limit // cluster)
    cap = min(CAP, -(-most * min(group, LANES) // 16) * 16)
    return cluster, cap


def beamflat_rows_needed(ancestry: torch.Tensor, group: int, pos: int) -> torch.Tensor:
    """``(n,)`` distinct cache rows each window's lanes attend at ``pos``:
    the rows ``t * g + ancestry[b, t]``, ``t <= pos``, of any of its lanes,
    each once. It sets K8's bound: the bytes a step must read."""
    t_pos = ancestry.shape[1]
    anc = ancestry.reshape(-1, group, t_pos)[:, :, :pos + 1].long()
    used = torch.zeros((anc.shape[0], pos + 1, group), dtype=torch.bool, device=anc.device)
    used.scatter_(2, anc.transpose(1, 2), True)
    return used.sum(dim=(1, 2))


def beamflat_mask(ancestry: torch.Tensor, group: int, rows: int, pos: int) -> torch.Tensor:
    """(n, g, rows) bool: row ``t * g + k`` is attendable by lane b iff lane
    k owns position t of b's hypothesis and ``t <= pos``
    (``kv_quant.py:_beamflat_mask``)."""
    t_pos = rows // group
    anc3 = ancestry.reshape(-1, group, t_pos)
    j = torch.arange(rows, device=ancestry.device)
    t_idx, k_idx = j // group, j % group
    own = anc3[:, :, t_idx] == k_idx.to(ancestry.dtype)
    return own & (t_idx <= pos)[None, None, :]


def beamflat_attention_plain(q, k, ks, v, vs, ancestry, pos: int, group: int,
                             int_dot: bool = False) -> torch.Tensor:
    """``attention_int8_beamflat`` over every row with the ancestry mask;
    fp32 throughout, integer dots exact (``int_einsum``)."""
    nb, h, tq, hd = q.shape
    n = nb // group
    rows = k.shape[2]
    mask = beamflat_mask(ancestry, group, rows, pos)[:, :, None, :]
    kc, vc = unpack_codes(k), unpack_codes(v)
    ksf = ks.float()[:, None]
    vsf = vs.float()[:, None]
    if int_dot:
        q8, qs = quantize_rows(q.float())
        s32 = int_einsum("nbhd,nhjd->nbhj", q8[:, :, 0].reshape(n, group, h, hd), kc)
        s = s32 * qs[:, :, 0].reshape(n, group, h, 1) * ksf
    else:
        s = torch.einsum("nbhd,nhjd->nbhj", q.float()[:, :, 0].reshape(n, group, h, hd),
                         kc.float()) * ksf
    w = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1) * vsf
    if int_dot:
        w8, ws = quantize_rows(w)
        out = int_einsum("nbhj,nhjd->nbhd", w8, vc) * ws
    else:
        out = torch.einsum("nbhj,nhjd->nbhd", w, vc.float())
    return out.reshape(nb, h, tq, hd).to(q.dtype)


def attention_fp_beamflat(q, kf, vf, ancestry, pos: int, group: int) -> torch.Tensor:
    """fp-cache form (``kv_quant.py:attention_fp_beamflat``): raw q and
    flat raw keys ``(n, H, T * g, d)``, each scaled by ``d**-0.25`` here.
    CPU tensors only: on CUDA the quantized caches and K8 are the path."""
    if q.is_cuda:
        raise ValueError("attention_fp_beamflat runs on CPU tensors only; on CUDA the beam "
                         "self cache is quantized (self_kv_bits 4|8) and kernel K8 runs")
    nb, h, tq, d = q.shape
    n = nb // group
    scale = d ** -0.25
    s = torch.einsum("nbhd,nhjd->nbhj", (q * scale).float()[:, :, 0].reshape(n, group, h, d),
                     (kf * scale).float())
    mask = beamflat_mask(ancestry, group, kf.shape[2], pos)[:, :, None, :]
    w = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    out = torch.einsum("nbhj,nhjd->nbhd", w, vf.float())
    return out.reshape(nb, h, tq, d).to(q.dtype)


def _check_inputs(q, k, ks, v, vs, ancestry, pos, group) -> int:
    """The kernel's input contract, checked on every device; returns the
    code width in bits."""
    if q.dim() != 4 or q.shape[2] != 1:
        raise ValueError(f"beamflat_attention: q must be (n*g, H, 1, hd), got {tuple(q.shape)}")
    nb, h, _, hd = q.shape
    if k.dtype != v.dtype or k.shape != v.shape:
        raise ValueError("beamflat_attention: k and v codes differ in dtype or shape")
    bits = {torch.int8: 8, torch.uint8: 4}.get(k.dtype)
    if bits is None or k.dim() != 4 or k.shape[-1] != hd * bits // 8 or k.shape[1] != h:
        raise ValueError(f"beamflat_attention: codes must be int8 (n, {h}, T*g, {hd}) or "
                         f"uint8 (n, {h}, T*g, {hd // 2}), got {tuple(k.shape)} {k.dtype}")
    n, _, rows, _ = k.shape
    if group < 1 or n * group != nb or rows % group:
        raise ValueError(f"beamflat_attention: {nb} lanes, {n} windows, group {group}, "
                         f"{rows} rows")
    for name, s in (("ks", ks), ("vs", vs)):
        if s.dtype != torch.bfloat16 or tuple(s.shape) != (n, h, rows):
            raise ValueError(f"beamflat_attention: {name} must be ({n}, {h}, {rows}) "
                             f"bfloat16, got {tuple(s.shape)} {s.dtype}")
    if ancestry.dtype != torch.int32 or tuple(ancestry.shape) != (nb, rows // group):
        raise ValueError(f"beamflat_attention: ancestry must be ({nb}, {rows // group}) "
                         f"int32, got {tuple(ancestry.shape)} {ancestry.dtype}")
    for name, t in (("q", q), ("k", k), ("ks", ks), ("v", v), ("vs", vs),
                    ("ancestry", ancestry)):
        if not t.is_contiguous():
            raise ValueError(f"beamflat_attention: {name} must be contiguous")
        if t.device != q.device:
            raise ValueError("beamflat_attention: tensors on different devices")
    if not 0 <= pos < min(rows // group, MAX_T):
        raise ValueError(f"beamflat_attention: pos {pos} past the cache's "
                         f"{rows // group} positions")
    return bits


def beamflat_attention(q, k, ks, v, vs, ancestry, pos: int, group: int,
                       int_dot: bool = False) -> torch.Tensor:
    """Beam self-attention of one step; kernel K8 on CUDA tensors.

    ``q (n*g, H, 1, 64)`` pre-scaled queries; ``pos`` a host int, the
    position being decoded."""
    bits = _check_inputs(q, k, ks, v, vs, ancestry, pos, group)
    if q.device.type == "cpu":
        return beamflat_attention_plain(q, k, ks, v, vs, ancestry, pos, group, int_dot)
    if q.device.type != "cuda":
        raise ValueError(f"beamflat_attention: unsupported device {q.device}")
    if q.dtype != torch.bfloat16 or q.shape[-1] != HEAD_DIM:
        raise ValueError(f"beamflat_attention: the kernel takes (n*g, H, 1, {HEAD_DIM}) "
                         f"bfloat16 queries, got {tuple(q.shape)} {q.dtype}")
    if (k.data_ptr() | v.data_ptr()) % 16 or (ks.data_ptr() | vs.data_ptr()) % 4:
        # the kernel copies codes in 16-byte pieces and scales in 4-byte pairs
        k, ks, v, vs = (t.clone() for t in (k, ks, v, vs))
    return _launch(q, k, ks, v, vs, ancestry, pos, group, int_dot, bits,
                   *beamflat_plan(int(pos) + 1, group))


def _launch(q, k, ks, v, vs, ancestry, pos: int, group: int, int_dot: bool, bits: int,
            cluster: int, cap: int) -> torch.Tensor:
    """One launch of K8 on checked CUDA tensors under a given plan."""
    nb, h = q.shape[:2]
    out = torch.empty_like(q)
    rc = _build.lib().wmt_beamflat_attention(
        q.data_ptr(), k.data_ptr(), ks.data_ptr(), v.data_ptr(), vs.data_ptr(),
        ancestry.data_ptr(), out.data_ptr(), nb, h, k.shape[2], ancestry.shape[1], group,
        int(pos) + 1, bits, int(int_dot), cluster, cap,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, "wmt_beamflat_attention")
    global LAUNCHES
    LAUNCHES += 1
    return out
