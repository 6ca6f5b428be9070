"""Beam self-attention over lane-addressed caches (kernel K8) and its plain
PyTorch versions.

Cache layouts, position-major like the port's other caches:

- flat (``models/whisper.py:beam_flat_cache``): a window's g beam lanes
  share one cache whose row ``t * g + k`` holds lane k's position t, so a
  step's write is the g contiguous rows ``[pos * g, pos * g + g)``: codes
  ``(n, H, T * g, 64)`` int8 or ``(n, H, T * g, 32)`` packed int4, scales
  ``(n, H, T * g)`` bf16;
- per-lane (the greedy cache, ``init_kv_cache``): codes ``(n * g, H, T,
  ...)``, scales ``(n * g, H, T)``;
- ``ancestry (n * g, T)`` int32 in ``[0, g)``: the lane whose row holds
  position t of lane b's hypothesis.

Query row b (window ``b // g``) attends positions ``t <= pos``, position t
at lane ``ancestry[b, t]``'s row. Over the flat cache, two modes, as
``whisper_mlx_tpu/ops/kv_quant.py:attention_int8_beamflat``: fp
(``mxu=False``, the function of the TPU kernel
``ops/beamflat_attention.py:beamflat_attention_kernel``) and integer-dot
(``int_dot=True``, ``mxu=True``: q and ``w * vs`` re-quantized per row, s8 x
s8 -> s32 dots). Two more functions of the reference, which it leaves to
XLA, are modes of the same kernel:

- the per-lane layout (:func:`ancestry_attention`), fp only, int8 or int4:
  ``kv_quant.py:attention_int8_ancestry``, what ``decode_step`` computes
  with ``beam_ancestry`` over a per-lane cache;
- the split mode (``beamflat_attention(..., s_fill=, overflow=)``), int8
  only, both modes: ``kv_quant.py:attention_int8_shared``, the shared-prefix
  beam scheme. Positions ``t < s_fill[window]`` form block S and the rest
  block W; each block has its own softmax statistics and, in the integer
  mode, its own per-row code scale of ``e * vs``, and the two merge as
  ``kv_quant.py:_merge_two_block``. The reference reads block S from a
  single copy S of the agreed prefix, filled from the window's first
  lane's ancestry (``beam.py:_build_S`` and the commits): here block S
  reads, for every lane of window w, row ``t * g + ancestry[w * g, t]`` of
  the flat cache, and no S buffer is kept. Its window W bounds only the
  beam loop's overflow rule, which keeps ``[s_fill, pos]`` inside it, so
  the function takes no W. With the device flag ``overflow`` set the call
  computes the flat function.

On a CUDA tensor the wrappers launch ``csrc/beamflat_attention.cu``: one
block per (window, head), or a cluster of :func:`beamflat_plan`'s blocks
past 256 positions, each reading the distinct rows its span of positions
needs (:func:`beamflat_rows_needed` counts them); on a CPU tensor they run
the plain versions, which mask every row as the reference does.
:func:`attention_fp_beamflat`, :func:`attention_fp_shared` and
:func:`attention_fp_ancestry`, the fp caches' forms, run on CPU tensors
only.
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

LAUNCHES = 0  # every launch of K8
SPLIT_LAUNCHES = 0  # of LAUNCHES, the split mode's
LANE_LAUNCHES = 0  # of LAUNCHES, the per-lane layout's
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


def beamflat_rows_needed(ancestry: torch.Tensor, group: int, pos: int,
                         s_fill: torch.Tensor | None = None) -> torch.Tensor:
    """``(n,)`` distinct cache rows each window's lanes attend at ``pos``:
    the rows ``t * g + ancestry[b, t]``, ``t <= pos``, of any of its lanes,
    each once (with ``s_fill``, the split's: at ``t < s_fill`` the window's
    first lane's row only). It sets K8's bound: the bytes a step must
    read."""
    t_pos = ancestry.shape[1]
    anc = ancestry.reshape(-1, group, t_pos)[:, :, :pos + 1].long()
    if s_fill is not None:
        in_s = torch.arange(pos + 1, device=anc.device)[None, :] < s_fill.long()[:, None]
        anc = torch.where(in_s[:, None], anc[:, :1], anc)
    used = torch.zeros((anc.shape[0], pos + 1, group), dtype=torch.bool, device=anc.device)
    used.scatter_(2, anc.transpose(1, 2), True)
    return used.sum(dim=(1, 2))


def beamflat_agreed_runs(ancestry: torch.Tensor, group: int, pos: int,
                         cluster: int) -> torch.Tensor:
    """``(n, passes, cluster)``: the positions each block of K8's flat mode
    and per-lane layout reads through its agreed-run route, one ancestry
    entry and one row a position (the split's run starts with block S and
    goes on the same way). A pass is up to 8 lanes of a window and block r
    of the plan's ``cluster`` spans ``[r L // cluster, (r + 1) L //
    cluster)`` of the ``L = pos + 1`` live positions; its run is the
    leading part of that span at which every lane of the pass names the
    same lane."""
    t_pos = ancestry.shape[1]
    live = pos + 1
    anc = ancestry.reshape(-1, group, t_pos)[:, :, :live]
    runs = []
    for r0 in range(0, group, LANES):
        lanes = anc[:, r0:r0 + LANES]
        agree = (lanes == lanes[:, :1]).all(dim=1).int()  # (n, L)
        runs.append(torch.stack([
            agree[:, r * live // cluster:(r + 1) * live // cluster].cumprod(dim=1).sum(dim=1)
            for r in range(cluster)], dim=1))
    return torch.stack(runs, dim=1)


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


def split_masks(ancestry: torch.Tensor, s_fill: torch.Tensor, group: int, rows: int,
                pos: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The shared scheme's two blocks over the flat cache's rows
    (``kv_quant.py:_shared_masks``): each (n, g, rows) bool. Block S, the
    positions ``t < s_fill[window]``, is the reference's single copy S
    (``beam.py:_build_S``): row ``t * g + ancestry[window * g, t]``, the
    window's first lane's, for every lane. Block W holds each lane's own
    rows at ``s_fill[window] <= t <= pos``. Where the lanes agree below
    s_fill, as the scheme's commits keep them, the two partition
    :func:`beamflat_mask`."""
    mask = beamflat_mask(ancestry, group, rows, pos)
    t_idx = torch.arange(rows, device=ancestry.device) // group
    in_s = (t_idx[None, :] < s_fill.long()[:, None])[:, None, :]
    t_pos = rows // group
    first = ancestry.reshape(-1, group, t_pos)[:, :1].expand(-1, group, -1).reshape(-1, t_pos)
    return beamflat_mask(first, group, rows, pos) & in_s, mask & ~in_s


def _merge_two_block(o_a, m_a, l_a, o_b, m_b, l_b) -> torch.Tensor:
    """Two blocks' partial softmax attention merged
    (``kv_quant.py:_merge_two_block``): an empty block arrives with m =
    -inf and l = 0 and merges away."""
    neg = torch.full_like(m_a, -1e30)
    m_a = torch.where(torch.isfinite(m_a), m_a, neg)
    m_b = torch.where(torch.isfinite(m_b), m_b, neg)
    m = torch.maximum(m_a, m_b)
    c_a, c_b = torch.exp(m_a - m), torch.exp(m_b - m)
    return (o_a * c_a[..., None] + o_b * c_b[..., None]) / (l_a * c_a + l_b * c_b)[..., None]


def _block(s, mask, vs, values, int_dot: bool):
    """One block of the split: (raw output sum, max, sum of exp) over the
    scores ``s`` (n, g, h, rows) where ``mask`` (n, g, 1, rows) holds, each
    e = exp(s - max) weighted by ``vs`` (None: an fp cache) into
    ``values``."""
    sm = s.masked_fill(~mask, float("-inf"))
    mx = sm.amax(dim=-1)
    safe = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    e = torch.where(mask, torch.exp(sm - safe[..., None]), torch.zeros_like(sm))
    w = e if vs is None else e * vs
    if int_dot:
        w8, ws = quantize_rows(w)
        out = int_einsum("nbhj,nhjd->nbhd", w8, values) * ws
    else:
        out = torch.einsum("nbhj,nhjd->nbhd", w, values.float())
    return out, mx, e.sum(dim=-1)


def beamflat_attention_plain(q, k, ks, v, vs, ancestry, pos: int, group: int,
                             int_dot: bool = False, s_fill: torch.Tensor | None = None,
                             overflow: torch.Tensor | None = None) -> torch.Tensor:
    """``attention_int8_beamflat`` over every row with the ancestry mask, or
    with ``s_fill`` (and ``overflow`` unset) ``attention_int8_shared``'s
    two blocks; fp32 throughout, integer dots exact (``int_einsum``)."""
    nb, h, tq, hd = q.shape
    n = nb // group
    rows = k.shape[2]
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
    if s_fill is not None and not (overflow is not None and bool(overflow)):
        mask_s, mask_w = split_masks(ancestry, s_fill, group, rows, pos)
        o_s, m_s, l_s = _block(s, mask_s[:, :, None], vsf, vc, int_dot)
        o_w, m_w, l_w = _block(s, mask_w[:, :, None], vsf, vc, int_dot)
        out = _merge_two_block(o_s, m_s, l_s, o_w, m_w, l_w)
        return out.reshape(nb, h, tq, hd).to(q.dtype)
    mask = beamflat_mask(ancestry, group, rows, pos)[:, :, None, :]
    w = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1) * vsf
    if int_dot:
        w8, ws = quantize_rows(w)
        out = int_einsum("nbhj,nhjd->nbhd", w8, vc) * ws
    else:
        out = torch.einsum("nbhj,nhjd->nbhd", w, vc.float())
    return out.reshape(nb, h, tq, hd).to(q.dtype)


def _cpu_only(q: torch.Tensor, name: str) -> None:
    if q.is_cuda:
        raise ValueError(f"{name} runs on CPU tensors only; on CUDA the beam self cache is "
                         "quantized (self_kv_bits 4|8) and kernel K8 runs")


def _fp_scores(q, keys, group: int) -> torch.Tensor:
    """fp caches: raw q (n*g, H, 1, d) against raw keys (n, H, rows, d),
    each scaled by ``d**-0.25`` -> fp32 scores (n, g, H, rows)."""
    nb, h, _, d = q.shape
    scale = d ** -0.25
    return torch.einsum("nbhd,nhjd->nbhj",
                        (q * scale).float()[:, :, 0].reshape(nb // group, group, h, d),
                        (keys * scale).float())


def attention_fp_beamflat(q, kf, vf, ancestry, pos: int, group: int) -> torch.Tensor:
    """fp-cache form (``kv_quant.py:attention_fp_beamflat``): raw q and
    flat raw keys ``(n, H, T * g, d)``, each scaled by ``d**-0.25`` here.
    CPU tensors only: on CUDA the quantized caches and K8 are the path."""
    _cpu_only(q, "attention_fp_beamflat")
    s = _fp_scores(q, kf, group)
    mask = beamflat_mask(ancestry, group, kf.shape[2], pos)[:, :, None, :]
    w = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    out = torch.einsum("nbhj,nhjd->nbhd", w, vf.float())
    return out.reshape(q.shape).to(q.dtype)


def attention_fp_shared(q, kf, vf, ancestry, s_fill: torch.Tensor, pos: int, group: int,
                        overflow: torch.Tensor | None = None) -> torch.Tensor:
    """fp-cache form of the split (``kv_quant.py:attention_fp_shared``), or
    with ``overflow`` set :func:`attention_fp_beamflat`. CPU tensors only."""
    _cpu_only(q, "attention_fp_shared")
    if overflow is not None and bool(overflow):
        return attention_fp_beamflat(q, kf, vf, ancestry, pos, group)
    s = _fp_scores(q, kf, group)
    mask_s, mask_w = split_masks(ancestry, s_fill, group, kf.shape[2], pos)
    o_s, m_s, l_s = _block(s, mask_s[:, :, None], None, vf, False)
    o_w, m_w, l_w = _block(s, mask_w[:, :, None], None, vf, False)
    return _merge_two_block(o_s, m_s, l_s, o_w, m_w, l_w).reshape(q.shape).to(q.dtype)


def _lane_select(ancestry: torch.Tensor, group: int, t_pos: int, pos: int) -> torch.Tensor:
    """(n, g lanes k, g rows b, 1, T) bool: lane k's row holds position t of
    row b's hypothesis, t <= pos."""
    n = ancestry.shape[0] // group
    anc = ancestry.reshape(n, group, t_pos)
    lanes = torch.arange(group, device=ancestry.device, dtype=ancestry.dtype)
    sel = anc[:, None] == lanes[None, :, None, None]
    valid = torch.arange(t_pos, device=ancestry.device) <= pos
    return (sel & valid)[:, :, :, None, :]


def attention_int8_ancestry_plain(q, k, ks, v, vs, ancestry, pos: int,
                                  group: int) -> torch.Tensor:
    """``kv_quant.py:attention_int8_ancestry``: pre-scaled q ``(n*g, H, 1,
    hd)`` over a per-lane quantized cache ``(n*g, H, T, ...)`` through the
    ancestry; fp32 throughout (the reference has no integer-dot form)."""
    nb, h, tq, hd = q.shape
    n, t_pos = nb // group, k.shape[2]
    kc = unpack_codes(k).float().reshape(n, group, h, t_pos, hd)
    vc = unpack_codes(v).float().reshape(n, group, h, t_pos, hd)
    ks5 = ks.float().reshape(n, group, h, t_pos)
    vs5 = vs.float().reshape(n, group, h, t_pos)
    sel = _lane_select(ancestry, group, t_pos, pos)  # (n, k, b, 1, T)
    s_all = torch.einsum("nbhd,nkhtd->nkbht", q.float()[:, :, 0].reshape(n, group, h, hd), kc)
    s = torch.where(sel, s_all * ks5[:, :, None], torch.zeros_like(s_all)).sum(dim=1)
    w = torch.softmax(s.masked_fill(~sel.any(dim=1), float("-inf")), dim=-1)  # (n, b, h, T)
    wv = torch.where(sel, w[:, None] * vs5[:, :, None], torch.zeros_like(s_all))
    out = torch.einsum("nkbht,nkhtd->nbhd", wv, vc)
    return out.reshape(nb, h, tq, hd).to(q.dtype)


def attention_fp_ancestry(q, k, v, ancestry, pos: int, group: int) -> torch.Tensor:
    """fp per-lane cache form (``kv_quant.py:attention_fp_ancestry``): raw q
    and keys ``(n*g, H, T, d)``, each scaled by ``d**-0.25`` here. CPU
    tensors only."""
    _cpu_only(q, "attention_fp_ancestry")
    nb, h, tq, d = q.shape
    n, t_pos = nb // group, k.shape[2]
    scale = d ** -0.25
    sel = _lane_select(ancestry, group, t_pos, pos)
    s_all = torch.einsum("nbhd,nkhtd->nkbht",
                         (q * scale).float()[:, :, 0].reshape(n, group, h, d),
                         (k * scale).float().reshape(n, group, h, t_pos, d))
    s = torch.where(sel, s_all, torch.zeros_like(s_all)).sum(dim=1)
    w = torch.softmax(s.masked_fill(~sel.any(dim=1), float("-inf")), dim=-1)
    wv = torch.where(sel, w[:, None].expand_as(s_all), torch.zeros_like(s_all))
    out = torch.einsum("nkbht,nkhtd->nbhd", wv, v.float().reshape(n, group, h, t_pos, d))
    return out.reshape(nb, h, tq, d).to(q.dtype)


def _check_inputs(q, k, ks, v, vs, ancestry, pos, group, per_lane: bool) -> int:
    """The kernel's input contract, checked on every device; returns the
    code width in bits."""
    if q.dim() != 4 or q.shape[2] != 1:
        raise ValueError(f"beamflat_attention: q must be (n*g, H, 1, hd), got {tuple(q.shape)}")
    nb, h, _, hd = q.shape
    if k.dtype != v.dtype or k.shape != v.shape:
        raise ValueError("beamflat_attention: k and v codes differ in dtype or shape")
    bits = {torch.int8: 8, torch.uint8: 4}.get(k.dtype)
    lead = "n*g" if per_lane else "n"
    time = "T" if per_lane else "T*g"
    if bits is None or k.dim() != 4 or k.shape[-1] != hd * bits // 8 or k.shape[1] != h:
        raise ValueError(f"beamflat_attention: codes must be int8 ({lead}, {h}, {time}, {hd}) "
                         f"or uint8 ({lead}, {h}, {time}, {hd // 2}), got {tuple(k.shape)} "
                         f"{k.dtype}")
    if group < 1 or nb % group:
        raise ValueError(f"beamflat_attention: {nb} lanes, group {group}")
    if per_lane:
        if k.shape[0] != nb:
            raise ValueError(f"beamflat_attention: a per-lane cache of {k.shape[0]} rows for "
                             f"{nb} lanes")
        t_pos = k.shape[2]
    else:
        if k.shape[0] * group != nb or k.shape[2] % group:
            raise ValueError(f"beamflat_attention: {nb} lanes, {k.shape[0]} windows, group "
                             f"{group}, {k.shape[2]} rows")
        t_pos = k.shape[2] // group
    for name, s in (("ks", ks), ("vs", vs)):
        if s.dtype != torch.bfloat16 or tuple(s.shape) != tuple(k.shape[:3]):
            raise ValueError(f"beamflat_attention: {name} must be {tuple(k.shape[:3])} "
                             f"bfloat16, got {tuple(s.shape)} {s.dtype}")
    if ancestry.dtype != torch.int32 or tuple(ancestry.shape) != (nb, t_pos):
        raise ValueError(f"beamflat_attention: ancestry must be ({nb}, {t_pos}) "
                         f"int32, got {tuple(ancestry.shape)} {ancestry.dtype}")
    for name, t in (("q", q), ("k", k), ("ks", ks), ("v", v), ("vs", vs),
                    ("ancestry", ancestry)):
        if not t.is_contiguous():
            raise ValueError(f"beamflat_attention: {name} must be contiguous")
        if t.device != q.device:
            raise ValueError("beamflat_attention: tensors on different devices")
    if not 0 <= pos < min(t_pos, MAX_T):
        raise ValueError(f"beamflat_attention: pos {pos} past the cache's {t_pos} positions")
    return bits


def _check_split(q, bits, s_fill, overflow, n) -> None:
    if bits != 8:
        raise ValueError("beamflat_attention: the split mode takes int8 codes (the reference's "
                         "shared scheme has no int4 form)")
    if (s_fill.dtype != torch.int32 or tuple(s_fill.shape) != (n,) or s_fill.device != q.device
            or not s_fill.is_contiguous()):
        raise ValueError(f"beamflat_attention: s_fill must be ({n},) int32 beside q, got "
                         f"{tuple(s_fill.shape)} {s_fill.dtype} on {s_fill.device}")
    if overflow is not None and (overflow.dtype != torch.bool or overflow.numel() != 1
                                 or overflow.device != q.device):
        raise ValueError("beamflat_attention: overflow must be one bool beside q")


def _check_kernel_inputs(q, k, ks, v, vs):
    """The kernel's own demands on a CUDA call; -> the tensors it reads."""
    if q.device.type != "cuda":
        raise ValueError(f"beamflat_attention: unsupported device {q.device}")
    if q.dtype != torch.bfloat16 or q.shape[-1] != HEAD_DIM:
        raise ValueError(f"beamflat_attention: the kernel takes (n*g, H, 1, {HEAD_DIM}) "
                         f"bfloat16 queries, got {tuple(q.shape)} {q.dtype}")
    if (k.data_ptr() | v.data_ptr()) % 16 or (ks.data_ptr() | vs.data_ptr()) % 4:
        # the kernel copies codes in 16-byte pieces and scales in 4-byte pairs
        k, ks, v, vs = (t.clone() for t in (k, ks, v, vs))
    return k, ks, v, vs


def beamflat_attention(q, k, ks, v, vs, ancestry, pos: int, group: int,
                       int_dot: bool = False, s_fill: torch.Tensor | None = None,
                       overflow: torch.Tensor | None = None) -> torch.Tensor:
    """Beam self-attention of one step over the flat cache; kernel K8 on
    CUDA tensors.

    ``q (n*g, H, 1, 64)`` pre-scaled queries; ``pos`` a host int, the
    position being decoded. ``s_fill`` ``(n,)`` int32 beside q: the split
    mode (int8 codes), unless the one-bool tensor ``overflow`` is set."""
    bits = _check_inputs(q, k, ks, v, vs, ancestry, pos, group, per_lane=False)
    if s_fill is not None:
        _check_split(q, bits, s_fill, overflow, k.shape[0])
    elif overflow is not None:
        raise ValueError("beamflat_attention: overflow without s_fill")
    if q.device.type == "cpu":
        return beamflat_attention_plain(q, k, ks, v, vs, ancestry, pos, group, int_dot,
                                        s_fill, overflow)
    k, ks, v, vs = _check_kernel_inputs(q, k, ks, v, vs)
    return _launch(q, k, ks, v, vs, ancestry, pos, group, int_dot, bits,
                   *beamflat_plan(int(pos) + 1, group), s_fill=s_fill, overflow=overflow)


def ancestry_attention(q, k, ks, v, vs, ancestry, pos: int, group: int) -> torch.Tensor:
    """Beam self-attention of one step over a per-lane quantized cache
    ``(n*g, H, T, ...)`` (``decode_step(beam_ancestry=)``); kernel K8's
    per-lane layout on CUDA tensors, fp mode (the reference's function has
    no integer-dot form)."""
    bits = _check_inputs(q, k, ks, v, vs, ancestry, pos, group, per_lane=True)
    if q.device.type == "cpu":
        return attention_int8_ancestry_plain(q, k, ks, v, vs, ancestry, pos, group)
    k, ks, v, vs = _check_kernel_inputs(q, k, ks, v, vs)
    return _launch(q, k, ks, v, vs, ancestry, pos, group, False, bits,
                   *beamflat_plan(int(pos) + 1, group), per_lane=True)


def _launch(q, k, ks, v, vs, ancestry, pos: int, group: int, int_dot: bool, bits: int,
            cluster: int, cap: int, s_fill=None, overflow=None,
            per_lane: bool = False) -> torch.Tensor:
    """One launch of K8 on checked CUDA tensors under a given plan."""
    nb, h = q.shape[:2]
    t_pos = k.shape[2] if per_lane else k.shape[2] // group
    out = torch.empty_like(q)
    rc = _build.lib().wmt_beamflat_attention(
        q.data_ptr(), k.data_ptr(), ks.data_ptr(), v.data_ptr(), vs.data_ptr(),
        ancestry.data_ptr(), None if s_fill is None else s_fill.data_ptr(),
        None if overflow is None else overflow.data_ptr(), out.data_ptr(), nb, h, t_pos,
        ancestry.shape[1], group, int(pos) + 1, bits, int(int_dot), int(per_lane), cluster, cap,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, "wmt_beamflat_attention")
    global LAUNCHES, SPLIT_LAUNCHES, LANE_LAUNCHES
    LAUNCHES += 1
    SPLIT_LAUNCHES += s_fill is not None
    LANE_LAUNCHES += per_lane
    return out
