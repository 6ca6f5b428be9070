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
at most ``GEMV_ROWS`` rows or fp32 x: on tensor cores with a cluster split
of K for int4 codes and bf16 x, else in SIMT; the Hopper tiled core of
``csrc/quant_tile.cuh`` for more bf16 rows, launched as :func:`tiled_plan`
says, which K6 shares); on a CPU tensor it runs :func:`quant_matmul_plain`.
Counterpart of ``whisper_mlx_tpu/ops/quant_pallas.py:quant_matmul_pallas``.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from whisper_mlx_tpu_torch.ops import _build

LAUNCHES = 0
TILED_LAUNCHES = 0  # of LAUNCHES, those on the tiled core
# rows up to which the GEMV kernel runs (bf16); above it the tiled kernel
GEMV_ROWS = 8
MAX_CLUSTER = 8                # the portable cluster size
SMEM_LIMIT = 227 * 1024        # bytes of shared memory a block may have
SMEM_TWO_A_SM = 112 * 1024     # ... and the most at which two blocks share an SM
# the tiled core (csrc/quant_tile.cuh): x rows a block takes (wgmma's n),
# 64 k a ring stage, at most 8 stages
TILED_ROWS = (16, 32, 64, 128)
# a split's cost to a block (the cluster sum, the blocks it adds), in ring
# stages; at 128 rows from a sweep of forced cluster sizes on the H100: one
# block a column block is the fastest at 512 rows, two or four at 128 and
# 384, and 14 makes the plan choose so
TILED_SPLIT_COST = {16: 2, 32: 2, 64: 2, 128: 14}
_TILED_STAGE_K = 64
_TILED_MAX_STAGES = 8


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def cluster_split(col_blocks: int, units: int, slots: int, fits,
                  sizes=range(1, MAX_CLUSTER + 1), split_cost: int = 0) -> int:
    """How many blocks of a cluster (one of ``sizes``, at most ``units``)
    split K's units (ring stages, or groups of them): the count that takes
    the fewest waves of ``slots`` blocks times the units a block streams
    plus one (a block's fixed cost: x's pass and the sums) plus
    ``split_cost`` when it splits (the cluster's sum), the least such
    count; ``fits(c)`` says whether a block of a c-way split holds its x."""
    best, best_cost = None, None
    for c in sizes:
        if c > min(MAX_CLUSTER, units) or not fits(c):
            continue
        cost = -(-col_blocks * c // slots) * (-(-units // c) + 1 + (split_cost if c > 1 else 0))
        if best_cost is None or cost < best_cost:
            best, best_cost = c, cost
    if best is None:
        raise ValueError(f"no split of {units} units fits a block's shared memory")
    return best


def tiled_route(group_size: int) -> bool:
    """Whether the tiled core takes this group size: groups of 16 or 32 k
    (several a 64-k stage) or of whole stages."""
    return group_size in (16, 32) or (group_size > 0 and group_size % _TILED_STAGE_K == 0)


def tiled_smem(nt: int, wbytes: int, group_size: int, stages: int,
               affine_window: bool) -> tuple[int, int]:
    """(a block's dynamic shared memory, its ring's bytes) on the tiled core:
    ``csrc/quant_tile.cuh:Layout``. A stage: x's tile (nt rows of 64 k,
    bf16), the codes (``wbytes`` a column: 32 for packed 4-bit words, 64 for
    8-bit words or one code a byte), the scales and biases (each column's
    window of 4 groups with ``affine_window``, K5's (N, G) layout; else the
    stage's groups) and x's sums of its groups; then three barriers a stage
    and the room to align."""
    cols = 256 if nt == 128 else 128
    gps = _TILED_STAGE_K // group_size if group_size < _TILED_STAGE_K else 1
    aff = 4 * cols if affine_window else gps * cols
    xg = _round_up(nt * 128, 1024) + cols * wbytes + 2 * aff * 4
    slot = _round_up(xg + gps * nt * 4, 1024)
    return stages * slot + 24 * stages + 1024, stages * slot


@dataclasses.dataclass(frozen=True)
class TiledPlan:
    """A launch of the tiled core: blocks of ``nt`` x rows (the wgmma's n)
    by ``cols`` output columns on a grid of ``cluster`` x ``row_blocks`` x
    ``col_blocks``; block r of a cluster of C takes K's ``units`` (64-k
    stages, or a group's stages past 64 k, so no group straddles two
    blocks) ``[r * units // C, (r + 1) * units // C)``; a ring of
    ``stages``; ``smem`` bytes of shared memory a block, ``per_sm`` blocks
    an SM."""

    nt: int
    cols: int
    row_blocks: int
    col_blocks: int
    units: int
    cluster: int
    stages: int
    smem: int
    per_sm: int


def tiled_plan(m: int, n: int, k: int, group_size: int, wbytes: int, sms: int,
               affine_window: bool = False) -> TiledPlan:
    """The tiled core's launch for an (m, k) x (n, k) product: the fewest x
    rows a block (16, 32, 64, or blocks of 128 rows, 256 columns, past 64),
    K split across a cluster by :func:`cluster_split` so that the grid
    fills ``sms`` SMs (two blocks an SM up to 64 rows), and the deepest
    ring (2-8 stages) shared memory holds, at least the cluster sum's room."""
    if k % _TILED_STAGE_K or not tiled_route(group_size) or k % group_size:
        raise ValueError(f"tiled core: K {k}, group_size {group_size}")
    nt = next((r for r in TILED_ROWS if m <= r), TILED_ROWS[-1])
    cols = 256 if nt == 128 else 128
    row_blocks, col_blocks = -(-m // nt), -(-n // cols)
    unit = group_size // _TILED_STAGE_K if group_size > _TILED_STAGE_K else 1
    units = k // _TILED_STAGE_K // unit
    per_sm = 1 if nt == 128 else 2
    # clusters of 1, 2, 4 or 8 blocks (3, 5, 6 or 7 leave SMs of a GPC
    # idle); a split's sum costs a block about TILED_SPLIT_COST stages
    cluster = cluster_split(row_blocks * col_blocks, units, per_sm * sms, lambda c: True,
                            sizes=(1, 2, 4, 8), split_cost=TILED_SPLIT_COST[nt])
    limit = SMEM_LIMIT if per_sm == 1 else SMEM_TWO_A_SM
    # the cluster's sum: the block's accumulators through the ring
    values = 2 * 64 * (cols // 128) * nt
    red = 4 * cluster * _round_up(-(-values // cluster), 4) if cluster > 1 else 0
    stages = _TILED_MAX_STAGES
    while stages > 2 and tiled_smem(nt, wbytes, group_size, stages, affine_window)[0] > limit:
        stages -= 1
    smem, ring = tiled_smem(nt, wbytes, group_size, stages, affine_window)
    if smem > limit or ring < red:
        raise ValueError(f"tiled core: no ring fits N {n}, K {k}, group_size {group_size}")
    return TiledPlan(nt, cols, row_blocks, col_blocks, units, cluster, stages, smem, per_sm)


def quant_matmul_plain(x: torch.Tensor, w_q: torch.Tensor, scales: torch.Tensor,
                       biases: torch.Tensor, bits: int, group_size: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch (same rounding points)."""
    from whisper_mlx_tpu_torch.ops.quant import unpack

    return group_matmul_plain(x, unpack(w_q, bits), scales, biases, group_size)


def group_matmul_plain(x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
                       biases: torch.Tensor, group_size: int) -> torch.Tensor:
    """``x @ (scales * codes + biases).T`` for unpacked codes ``(N, K)``
    with the kernels' rounding points: the function of K5 and K6."""
    *lead, k = x.shape
    n = codes.shape[0]
    g = k // group_size
    x2 = x.reshape(-1, k)
    compute = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    s = scales.to(compute).float()
    vals = codes.float().reshape(n, g, group_size)
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
    if x2.data_ptr() % 16:  # the kernels load x and the codes 16 bytes at a time
        x2 = x2.clone()
    if (w_q.data_ptr() | scales.data_ptr() | biases.data_ptr()) % 16:  # ... and the weights
        w_q, scales, biases = w_q.clone(), scales.clone(), biases.clone()
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return out.reshape(*lead, n)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    global LAUNCHES, TILED_LAUNCHES
    if x.dtype == torch.float32 or m <= GEMV_ROWS or k % 64 or not tiled_route(group_size):
        rc = _build.lib().wmt_quant_gemv(
            x2.data_ptr(), w_q.data_ptr(), scales.data_ptr(), biases.data_ptr(),
            out.data_ptr(), m, n, k, bits, group_size,
            int(x.dtype == torch.bfloat16), stream)
        _build.check(rc, "wmt_quant_gemv")
    else:
        plan = tiled_plan(m, n, k, group_size, 32 if bits == 4 else 64,
                          sm_count(x.device.index or 0), affine_window=True)
        rc = _build.lib().wmt_quant_gemm(
            x2.data_ptr(), w_q.data_ptr(), scales.data_ptr(), biases.data_ptr(),
            out.data_ptr(), m, n, k, bits, group_size, plan.nt, plan.cluster, plan.stages,
            stream)
        _build.check(rc, "wmt_quant_gemm")
        TILED_LAUNCHES += 1
    LAUNCHES += 1
    return out.reshape(*lead, n)
