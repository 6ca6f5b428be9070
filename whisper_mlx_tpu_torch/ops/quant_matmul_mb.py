"""Multi-buffered transposed dequant-matmul (kernel K6), its weight layout
and its plain PyTorch version.

Counterpart of ``whisper_mlx_tpu/ops/quant_pallas_mb.py``.
:func:`transpose_quant` turns a packed
:class:`~whisper_mlx_tpu_torch.ops.quant.QuantTensor` into a
:class:`QuantTensorT` once, at setup; ``quant_matmul_mbt(x, qt)`` then
computes ``x @ dequant(qt).T`` with K5's function and rounding points
(``ops/quant_matmul.py``): on a CUDA tensor it launches
``csrc/quant_matmul_mb.cu`` (bf16 x with 4-bit codes at most 8 rows: one
launch, K split across a cluster as :func:`mbt_gemv_plan` says; more bf16
rows: K5's tiled core over these layouts, as
:func:`~whisper_mlx_tpu_torch.ops.quant_matmul.tiled_plan` says), on a CPU
tensor it runs :func:`quant_matmul_mbt_plain`. :func:`quant_matmul_mb`
transposes per call (the ``WTPU_QMM_MB`` route).

The layouts hold the reference's values in one flat storage:
- packed words ``(K / per_word, Np)`` (int32 with the bits of MLX's
  uint32), or, with ``codes`` (``WTPU_MBT_DQ=i8``, 4-bit only), one code
  per byte ``(K, Np)`` int8; scales and biases ``(G, Np)``;
- N is padded with zeros to ``Np``, a ``tile_n`` multiple, at setup (the
  reference pads per call), so each 16-byte copy of a weight slab on the
  card is aligned.
``contig`` (``WTPU_MBT_CONTIG=1``) is recorded as the reference's knob
reads, but not stored: the reference pre-tiles to ``(n_tiles, rows,
tile_n)`` for its DMAs, and on the card the tiled and the flat storage
stream at the same rate (``PERF.md``).
The reference's other dequantization orders (``WTPU_MBT_DQ=planar|u8``,
``_planar_perm``, ``_u8_perm``) exist for Mosaic's tiling: they compute the
same function, and on the card the packed layout runs K6.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from whisper_mlx_tpu_torch.ops import _build
from whisper_mlx_tpu_torch.ops.quant import QuantTensor, dequantize, unpack
from whisper_mlx_tpu_torch.ops.quant_matmul import (
    GEMV_ROWS,
    MAX_CLUSTER as _MAX_CLUSTER,
    SMEM_LIMIT as _SMEM_LIMIT,
    SMEM_TWO_A_SM as _SMEM_TWO_A_SM,
    _round_up,
    cluster_split,
    group_matmul_plain,
    sm_count as _sm_count,
    tiled_plan,
    tiled_route,
)

LAUNCHES = 0
TILED_LAUNCHES = 0  # of LAUNCHES, those on the tiled core
MAX_STAGES = 8  # ring stages the kernels' shared memory holds
# csrc/quant_matmul_mb.cu, the SIMT GEMV (fp32 x, 8-bit codes, group sizes
# the other routes do not take): a block owns 256 columns; a ring slot holds
# 8 KB of codes, i.e. 8 rows of packed words or 32 rows of codes, and the
# scales and biases of every group they touch
_BLOCK_COLS = 256
_SLOT_ROWS = {False: 8, True: 32}  # by codes_resident
_SLOT_CODES = 8192
_SIMT_MAX_GROUPS = 64 // 8 + 1  # groups a slot's codes touch at most (64 k, groups of 8)
# ... and the tensor-core GEMV (bf16 x, 4-bit codes): a block owns 128
# columns; a stage holds 16 KB of codes, 256 k of packed words or 128 k of
# codes, and the scales and biases of its groups
_MMA_COLS = 128
_MMA_STAGE_K = {False: 256, True: 128}  # by codes_resident
_XCAP = 48 * 1024         # most bytes of x (bf16) a block holds


@dataclasses.dataclass
class QuantTensorT:
    """A QuantTensor transposed for K6 (see the module docstring).

    ``wqt`` ``(rows, Np)`` int32 words or int8 codes; ``scalest``/
    ``biasest`` ``(G, Np)`` fp32; ``n_orig`` the unpadded N; ``depth`` the
    ring's stages on the card (capped by shared memory: at most what
    leaves two blocks an SM on the tensor-core GEMV); ``contig`` the
    reference's layout flag.
    """

    wqt: torch.Tensor
    scalest: torch.Tensor
    biasest: torch.Tensor
    bits: int
    group_size: int
    tile_n: int
    depth: int
    contig: bool
    n_orig: int

    @property
    def codes_resident(self) -> bool:
        return self.wqt.dtype == torch.int8

    @property
    def shape(self) -> tuple[int, int]:  # natural (out, in), as QuantTensor
        rows = self.wqt.shape[0]
        return (self.n_orig, rows if self.codes_resident else rows * (32 // self.bits))

    def dequantize(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """-> ``(out, in)`` weights, as the reference computes them."""
        n, k = self.shape
        sct, bit = self.scalest[:, :n], self.biasest[:, :n]
        wqt = self.wqt[:, :n]
        if self.codes_resident:
            g = sct.shape[0]
            codes = wqt.T.float().reshape(n, g, k // g)
            return (codes * sct.T[..., None] + bit.T[..., None]).reshape(n, k).to(dtype)
        return dequantize(wqt.T, sct.T, bit.T, self.bits, self.group_size, dtype)

    def __repr__(self) -> str:
        return (f"QuantTensorT{self.shape}[{self.bits}b/g{self.group_size} t{self.tile_n}"
                f"d{self.depth}{'c' if self.contig else ''}{'i8' if self.codes_resident else ''}]")


def transpose_quant(q: QuantTensor, tile_n: int | None = None, depth: int | None = None,
                    codes: bool | None = None, contig: bool | None = None) -> QuantTensorT:
    """One-time layout conversion for :func:`quant_matmul_mbt`, with the
    reference's defaults and knobs: ``codes`` from ``WTPU_MBT_DQ=i8`` (4-bit
    only, and only up to ``WTPU_MBT_I8_MAX_K`` = 8192 input columns),
    ``contig`` (recorded only) from ``WTPU_MBT_CONTIG=1``, ``tile_n`` from ``WTPU_MBT_TILE``
    (1024 for N >= 16384, else 512), ``depth`` from ``WTPU_MBT_DEPTH`` (8,
    or 4 with codes, for N >= 16384, else 2)."""
    if codes is None:
        codes = os.environ.get("WTPU_MBT_DQ", "planar") == "i8" and q.bits == 4
    if contig is None:
        contig = os.environ.get("WTPU_MBT_CONTIG", "0") == "1"
    if codes:
        if q.bits != 4:
            raise ValueError(f"transpose_quant: codes-resident needs 4-bit weights, got {q.bits}")
        codes = q.shape[1] <= int(os.environ.get("WTPU_MBT_I8_MAX_K", "8192"))
    n = q.shape[0]
    if tile_n is None:
        env = os.environ.get("WTPU_MBT_TILE", "")
        tile_n = int(env) if env else (1024 if n >= 16384 else 512)
    if depth is None:
        env = os.environ.get("WTPU_MBT_DEPTH", "")
        depth = int(env) if env else ((4 if codes else 8) if n >= 16384 else 2)
    if tile_n < 16 or tile_n % 16:
        raise ValueError(f"transpose_quant: tile_n {tile_n} is not a positive multiple of 16")
    src = unpack(q.w_q, q.bits).to(torch.int8) if codes else q.w_q  # (N, rows)
    np_ = _round_up(n, tile_n)

    def padded_t(a: torch.Tensor) -> torch.Tensor:  # (N, c) -> (c, Np), zero columns
        out = a.new_zeros((a.shape[1], np_))
        out[:, :n] = a.T
        return out

    return QuantTensorT(padded_t(src), padded_t(q.scales), padded_t(q.biases), q.bits, q.group_size,
                        tile_n, depth, contig, n)


def quant_matmul_mbt_plain(x: torch.Tensor, qt: QuantTensorT) -> torch.Tensor:
    """The kernel's function in plain PyTorch: K5's, on the unpacked codes."""
    n, _ = qt.shape
    wqt = qt.wqt[:, :n].T
    codes = wqt if qt.codes_resident else unpack(wqt, qt.bits)
    return group_matmul_plain(x, codes, qt.scalest[:, :n].T, qt.biasest[:, :n].T,
                              qt.group_size)


def _check_inputs(x: torch.Tensor, qt: QuantTensorT) -> None:
    n, k = qt.shape
    if x.shape[-1] != k:
        raise ValueError(f"quant_matmul_mbt: x {tuple(x.shape)} against weights {qt!r}")
    if qt.bits not in (4, 8) or qt.group_size < 8 or qt.group_size % 8 or k % qt.group_size:
        raise ValueError(f"quant_matmul_mbt: bits {qt.bits}, group_size {qt.group_size}, K {k}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"quant_matmul_mbt: x must be bfloat16 or float32, got {x.dtype}")
    for name, t in (("wqt", qt.wqt), ("scalest", qt.scalest), ("biasest", qt.biasest)):
        if t.device != x.device:
            raise ValueError(f"quant_matmul_mbt: {name} on {t.device}, x on {x.device}")


def _gemv_splits(n: int, rows: int, slot_rows: int, sms: int) -> tuple[int, int]:
    """K splits of the GEMV: enough blocks for about four per SM, each split
    a whole number of ring slots. -> (splits, stored rows per split)."""
    col_blocks = -(-n // _BLOCK_COLS)
    slots = -(-rows // slot_rows)
    splits = max(1, min(slots, -(-4 * sms // col_blocks)))
    per = -(-slots // splits)
    return -(-slots // per), per * slot_rows


def simt_plan(m: int, n: int, k: int, qt: QuantTensorT, sms: int) -> tuple[int, int, int]:
    """The SIMT GEMV's launch: K's stored rows split for about four blocks
    an SM (:func:`_gemv_splits`), each slot carrying the affines of the
    ``ceil(slot_k / g) + 1`` groups its ``slot_k`` k can touch, and the
    ring as deep as ``qt.depth`` while shared memory holds it. -> (splits,
    stored rows a split, stages). A group size whose slot or ring cannot
    fit raises ``NotImplementedError`` (fault F4 of ROADMAP.md)."""
    codes = qt.codes_resident
    vpe = 1 if codes else 32 // qt.bits
    rows = k // vpe
    splits, per_split = _gemv_splits(n, rows, _SLOT_ROWS[codes], sms)
    g = qt.group_size
    ng = -(-_SLOT_ROWS[codes] * vpe // g) + 1
    xg = 8 * (per_split * vpe // g + 2) * 4

    def smem(stages: int) -> int:
        return stages * (_SLOT_CODES + 2 * ng * _BLOCK_COLS * 4) + xg

    stages = min(max(qt.depth, 1), MAX_STAGES)
    while stages > 1 and smem(stages) > _SMEM_LIMIT:
        stages -= 1
    if ng > _SIMT_MAX_GROUPS or smem(stages) > _SMEM_LIMIT:
        raise NotImplementedError(
            f"quant_matmul_mbt: group size {g} at K {k} does not fit the SIMT GEMV on the "
            "card (fault F4, ROADMAP.md)")
    return splits, per_split, stages


def mbt_route(m: int, k: int, dtype: torch.dtype, qt: QuantTensorT) -> str:
    """Which kernel of K6 a CUDA call takes: ``"mma"`` (the tensor-core
    GEMV: at most ``GEMV_ROWS`` rows or K not a multiple of 64, where
    :func:`mma_route` says), ``"tiled"`` (more bf16 rows, K a multiple of
    64, groups the tiled core takes) or ``"simt"`` (every other call: fp32
    x, 8-bit codes, any group of a multiple of 8 k, as
    :func:`simt_plan` says)."""
    if (m <= GEMV_ROWS or k % 64) and mma_route(dtype, qt):
        return "mma"
    if dtype == torch.float32 or m <= GEMV_ROWS or k % 64 or not tiled_route(qt.group_size):
        return "simt"
    return "tiled"


def mma_route(dtype: torch.dtype, qt: QuantTensorT) -> bool:
    """Whether a few-row call takes the tensor-core GEMV: bf16 x, 4-bit
    codes (packed or codes-resident), groups of 32 k or more that divide
    a stage's k."""
    sk = _MMA_STAGE_K[qt.codes_resident]
    return (dtype == torch.bfloat16 and qt.bits == 4 and qt.group_size % 32 == 0
            and sk % qt.group_size == 0)


def _mma_smem(codes: bool, group_size: int, stages: int, rows: int, kcap: int) -> int:
    """Shared memory of a tensor-core GEMV block (``TvSmem``): the ring
    (codes, scales and biases a stage), x's rows, their sums over each 32 k
    and each group, the cluster's fp32 slots, the barriers and the room to
    align the ring."""
    def up(v, a):
        return -(-v // a) * a

    aff = _MMA_STAGE_K[codes] // group_size * _MMA_COLS * 4
    stage = up(16384 + 2 * aff, 1024)
    return (stages * stage + rows * (2 * kcap + (64 if codes else 16))
            + up(rows * (kcap // 32) * 4, 16)
            + up(rows * (kcap // group_size) * 4, 16) + (_MMA_COLS * 8 + _MAX_CLUSTER) * 4
            + 16 * stages + 1024)


def mbt_gemv_plan(m: int, n: int, k: int, codes: bool, group_size: int, depth: int,
                  sms: int) -> tuple[int, int]:
    """The tensor-core GEMV's launch: K's stages (256 k packed, 128 k
    codes-resident) split over a cluster of C blocks (block r of it takes
    stages ``[r * S // C, (r + 1) * S // C)``), C from :func:`cluster_split`
    with two blocks an SM and x's rows within ``_XCAP``; the ring ``depth``
    deep, capped at what leaves two blocks an SM. -> (cluster, stages)."""
    rows = min(m, GEMV_ROWS)
    nst = -(-k // _MMA_STAGE_K[codes])

    def kcap(c: int) -> int:
        return -(-nst // c) * _MMA_STAGE_K[codes]

    c = cluster_split(-(-n // _MMA_COLS), nst, 2 * sms,
                      lambda c: rows * (2 * kcap(c) + 64) <= _XCAP or c == min(8, nst))
    stages = min(max(depth, 1), MAX_STAGES)
    while stages > 1 and _mma_smem(codes, group_size, stages, rows, kcap(c)) > _SMEM_TWO_A_SM:
        stages -= 1
    if _mma_smem(codes, group_size, stages, rows, kcap(c)) > _SMEM_LIMIT:
        raise ValueError(f"quant_matmul_mbt: K {k} is too long for the GEMV's shared memory")
    return c, stages


def quant_matmul_mbt(x: torch.Tensor, qt: QuantTensorT) -> torch.Tensor:
    """``x @ dequant(qt).T``: x ``(..., K)`` -> ``(..., N)`` in x's dtype;
    kernel K6 on CUDA tensors: at most ``GEMV_ROWS`` rows (or K not a
    multiple of 64) on the tensor-core GEMV in one launch where
    :func:`mma_route` says (bf16 x, 4-bit codes), else on the SIMT ring
    GEMV (fp32 x, 8-bit codes, group sizes no other route takes, at any row
    count: a second launch sums its K splits); more bf16 rows on the tiled
    core (:func:`mbt_route` decides) (``csrc/quant_tile.cuh``,
    one launch, as :func:`~whisper_mlx_tpu_torch.ops.quant_matmul.tiled_plan`
    says)."""
    _check_inputs(x, qt)
    if x.device.type == "cpu":
        return quant_matmul_mbt_plain(x, qt)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul_mbt: unsupported device {x.device}")
    for name, t in (("wqt", qt.wqt), ("scalest", qt.scalest), ("biasest", qt.biasest)):
        if not t.is_contiguous():
            raise ValueError(f"quant_matmul_mbt: {name} must be contiguous")
    if (qt.wqt.data_ptr() | qt.scalest.data_ptr() | qt.biasest.data_ptr()) % 16:  # TMA's
        qt = dataclasses.replace(qt, wqt=qt.wqt.clone(), scalest=qt.scalest.clone(),
                                 biasest=qt.biasest.clone())
    *lead, k = x.shape
    n = qt.n_orig
    x2 = x.reshape(-1, k).contiguous()
    if x2.data_ptr() % 16:  # the kernels load x 16 bytes at a time
        x2 = x2.clone()
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return out.reshape(*lead, n)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    bits = 0 if qt.codes_resident else qt.bits
    np_ = qt.scalest.shape[1]
    sms = _sm_count(x.device.index or 0)
    route = mbt_route(m, k, x.dtype, qt)
    if route == "mma":
        cluster, stages = mbt_gemv_plan(m, n, k, qt.codes_resident, qt.group_size, qt.depth, sms)
        rc = _build.lib().wmt_mbt_gemv_mma(
            x2.data_ptr(), qt.wqt.data_ptr(), qt.scalest.data_ptr(), qt.biasest.data_ptr(),
            out.data_ptr(), m, n, k, int(qt.codes_resident), qt.group_size, np_, stages,
            cluster, stream)
        _build.check(rc, "wmt_mbt_gemv_mma")
    elif route == "simt":
        splits, per_split, stages = simt_plan(m, n, k, qt, sms)
        partial = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
                   if splits > 1 else None)
        rc = _build.lib().wmt_mbt_gemv(
            x2.data_ptr(), qt.wqt.data_ptr(), qt.scalest.data_ptr(), qt.biasest.data_ptr(),
            out.data_ptr(), None if partial is None else partial.data_ptr(), m, n, k, bits,
            qt.group_size, np_, stages, splits, per_split,
            int(x.dtype == torch.bfloat16), stream)
        _build.check(rc, "wmt_mbt_gemv")
    else:
        plan = tiled_plan(m, n, k, qt.group_size, 32 if bits == 4 else 64, sms)
        rc = _build.lib().wmt_mbt_gemm(
            x2.data_ptr(), qt.wqt.data_ptr(), qt.scalest.data_ptr(), qt.biasest.data_ptr(),
            out.data_ptr(), m, n, k, bits, qt.group_size, np_, plan.nt, plan.cluster,
            plan.stages, stream)
        _build.check(rc, "wmt_mbt_gemm")
        global TILED_LAUNCHES
        TILED_LAUNCHES += 1
    global LAUNCHES
    LAUNCHES += 1
    return out.reshape(*lead, n)


def quant_matmul_mb(x: torch.Tensor, q: QuantTensor, tile_n: int = 512,
                    depth: int = 4) -> torch.Tensor:
    """Drop-in QuantTensor wrapper that transposes per call (the
    ``WTPU_QMM_MB`` route); decode loops transpose once with
    :func:`transpose_quant` (``WTPU_MBT_RESIDENT``)."""
    return quant_matmul_mbt(x, transpose_quant(q, tile_n=tile_n, depth=depth))
