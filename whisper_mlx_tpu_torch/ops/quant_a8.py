"""W8A8 matmul (kernel K7): per-channel int8 weights times per-row dynamic
int8 activations, its weight conversion and its plain PyTorch version.

Counterpart of ``whisper_mlx_tpu/ops/quant_a8.py`` (``WTPU_QWEN_A8=1``).
:func:`requant_a8` re-quantizes a packed
:class:`~whisper_mlx_tpu_torch.ops.quant.QuantTensor` once, at load, to
symmetric per-channel int8 (``w ~ s_n * c[n, k]``, ``c`` in [-127, 127],
the group zero points folded into the codes); :func:`a8_matmul` quantizes
each row of x to int8 (``amax / 127``, round half to even, a true
division), takes the int32 dot product and returns ``(float(acc) * s_n) *
sx`` in x's dtype. On a CUDA tensor it launches ``csrc/a8_matmul.cu`` (at
most 8 rows, or K not a multiple of 64: one launch with the quantization
fused, K split across a cluster as :func:`a8_gemv_plan` says; more rows:
quantize, then int8 tensor-core tiles), on a CPU tensor it runs
:func:`a8_matmul_plain`. :func:`prepare_a8_params` converts a parameter
tree.

Every quotient here is a true division by a tensor: PyTorch on CUDA divides
by a Python number as a product with its reciprocal, an ulp off at times,
which would move scales and codes on the card away from the CPU's, the JAX
package's and the kernel's.

Storage: the port keeps the codes ``(N, K)``, N-major, so the four k values
one ``__dp4a`` takes are one 32-bit word (the reference keeps ``(K, Np)``
or, ``contig``, ``(n_tiles, K, tile_n)`` for its DMA ring, and
``_codes_2d`` gives that view back). ``tile_n`` and ``depth`` stay on the
tensor: the reference's VMEM rule (:func:`a8_fits`) reads them to decide
whether a call takes the kernel or dequantize + matmul, which is a
different function (no activation quantization). ``WTPU_A8_XLA=1`` is the
reference's other lowering of the kernel's function; on the card K7 is its
only route.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Any

import torch

from whisper_mlx_tpu_torch.ops import _build
from whisper_mlx_tpu_torch.ops.quant import QuantTensor
from whisper_mlx_tpu_torch.ops.quant_matmul import SMEM_LIMIT, cluster_split

LAUNCHES = 0
TILED_LAUNCHES = 0  # of LAUNCHES, those on the tiled GEMM (more than 8 rows)
# calls the VMEM rule (a8_fits) sends to dequantize + matmul, and calls past
# WTPU_QMM_PALLAS_MAX_ROWS that ops/quant.py sends there: no kernel of K7
VMEM_DEQUANT_CALLS = 0
ROWS_DEQUANT_CALLS = 0


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass
class A8Tensor:
    """Per-channel int8 linear: ``codes`` ``(N, K)`` int8, ``scale`` ``(N,)``
    fp32; ``shape`` is the logical ``(out, in)`` like QuantTensor's."""

    codes: torch.Tensor
    scale: torch.Tensor
    tile_n: int
    depth: int

    @property
    def n_orig(self) -> int:
        return self.codes.shape[0]

    @property
    def shape(self) -> tuple[int, int]:
        return (self.codes.shape[0], self.codes.shape[1])

    def _codes_2d(self) -> torch.Tensor:
        """The reference's ``(K, Np)`` view: codes transposed, N padded with
        zero columns to a ``tile_n`` multiple."""
        n, k = self.shape
        out = self.codes.new_zeros((k, _round_up(n, self.tile_n)))
        out[:, :n] = self.codes.T
        return out

    def dequantize(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """``(out, in)`` weights: ``codes * scale`` in fp32, then ``dtype``."""
        return (self.codes.float() * self.scale[:, None]).to(dtype)

    def __repr__(self) -> str:
        return f"A8Tensor(out={self.shape[0]}, in={self.shape[1]})"


def _rows_to_a8(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 rows -> (int8 codes, fp32 scales): ``s = max(amax, 1e-12) / 127``,
    ``c = clip(round_half_even(w / s), -127, 127)``."""
    amax = w.abs().amax(dim=1)
    s = torch.clamp(amax, min=1e-12) / torch.full_like(amax, 127.0)
    return torch.clamp(torch.round(w / s[:, None]), -127, 127).to(torch.int8), s


def requant_a8(q: QuantTensor | torch.Tensor, tile_n: int = 512, depth: int = 4) -> A8Tensor:
    """Re-quantize a QuantTensor (or fp ``(out, in)`` weights) to per-channel
    symmetric int8, once at load. A QuantTensor with more than
    ``WTPU_A8_CHUNK_ROWS`` (16384) rows is converted that many rows at a
    time: the scales are per row, so the chunks give the same codes, and a
    vocabulary-wide head never dequantizes whole."""
    if isinstance(q, QuantTensor):
        n = q.shape[0]
        chunk = int(os.environ.get("WTPU_A8_CHUNK_ROWS", "16384"))
        if chunk and n > chunk:
            parts = [_rows_to_a8(QuantTensor(q.w_q[i:i + chunk], q.scales[i:i + chunk],
                                             q.biases[i:i + chunk], q.bits, q.group_size)
                                 .dequantize(torch.float32)) for i in range(0, n, chunk)]
            codes = torch.cat([c for c, _ in parts])
            scale = torch.cat([s for _, s in parts])
        else:
            codes, scale = _rows_to_a8(q.dequantize(torch.float32))
    else:
        codes, scale = _rows_to_a8(q.float())
    return A8Tensor(codes, scale, tile_n, depth)


def a8_fits(at: A8Tensor, rows: int) -> bool:
    """The reference's rule for which function a call computes: the TPU
    kernel keeps its (Mp, Np) fp32 output, ``depth`` (K, tile_n) code slabs,
    the (Mp, K) int8 x and the scales in VMEM; a call whose footprint is
    above ``WTPU_A8_MAX_VMEM_MB`` (48) MB takes dequantize + matmul."""
    n, k = at.shape
    mp = _round_up(max(rows, 8), 8)
    np_ = _round_up(n, at.tile_n)
    need = mp * np_ * 4 + min(at.depth, np_ // at.tile_n) * k * at.tile_n + mp * k + 4 * np_
    return need <= float(os.environ.get("WTPU_A8_MAX_VMEM_MB", "48")) * 1e6


def a8_matmul_plain(x: torch.Tensor, at: A8Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch; the int32 sum is taken in
    float64, where it is exact, and rounded to fp32 once."""
    *lead, k = x.shape
    xf = x.reshape(-1, k).float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    sx = torch.clamp(amax, min=1e-8) / torch.full_like(amax, 127.0)
    xq = torch.clamp(torch.round(xf / sx), -127, 127)
    acc = torch.matmul(xq.double(), at.codes.double().T)
    out = (acc.float() * at.scale) * sx
    return out.to(x.dtype).reshape(*lead, at.n_orig)


def a8_matmul(x: torch.Tensor, at: A8Tensor) -> torch.Tensor:
    """``x @ dequant(at).T`` with per-row dynamic int8 activations: x
    ``(..., K)`` -> ``(..., N)`` in x's dtype. Calls that :func:`a8_fits`
    refuses take dequantize + matmul, as in the reference; the others
    :func:`a8_matmul_kernel`."""
    k = x.shape[-1]
    if k != at.shape[1]:
        raise ValueError(f"a8_matmul: x {tuple(x.shape)} against weights {at!r}")
    if not a8_fits(at, x.numel() // k):
        global VMEM_DEQUANT_CALLS
        VMEM_DEQUANT_CALLS += 1
        return torch.matmul(x, at.dequantize(x.dtype).T)
    return a8_matmul_kernel(x, at)


# csrc/a8_matmul.cu's fused GEMV: a block owns 128 channels, a ring stage
# holds 128 channels x 256 k of codes (32 KB), x's rows sit quantized in
# shared memory, a launch takes at most 8 rows of x a block
GEMV_ROWS = 8
_CH, _KC, _STAGE = 128, 256, 128 * 256
_MAX_CLUSTER = 8
# two 32 KB stages: on the H100 three or more (two blocks an SM, 192 KB and
# more in flight) streamed slower at Qwen3-32B's shapes (PERF.md)
_STAGES = 2
_SMEM_TWO_A_SM = 112 * 1024   # bytes of shared memory at which two blocks share an SM
_XCAP = 48 * 1024             # most bytes of quantized x a block holds


def _gemv_smem(stages: int, rows: int, kcap: int) -> int:
    """Shared memory of a block (``FvSmem``): the ring, x's rows quantized,
    absmax and scales, the cluster's int32 slots, the barriers and the room
    to align the ring."""
    return stages * _STAGE + rows * (kcap + 16) + 64 + (_CH * 8 + _MAX_CLUSTER) * 4 \
        + 16 * stages + 1024


def a8_gemv_plan(m: int, n: int, k: int, sms: int) -> tuple[int, int]:
    """The fused GEMV's launch: K's 256-k chunks split over a cluster of C
    blocks (block r of it takes chunks ``[r * chunks // C, (r + 1) * chunks
    // C)``), C from :func:`~whisper_mlx_tpu_torch.ops.quant_matmul.cluster_split`
    with two blocks an SM and x's rows within ``_XCAP``; a ring of
    ``_STAGES`` stages. -> (cluster, stages)."""
    rows = min(m, GEMV_ROWS)
    chunks = -(-k // _KC)

    def kcap(c: int) -> int:
        return -(-chunks // c) * _KC

    c = cluster_split(-(-n // _CH), chunks, 2 * sms, lambda c: rows * (kcap(c) + 16) <= _XCAP)
    return c, _STAGES


# csrc/a8_matmul.cu's tiled GEMM (more than 8 rows): x rows a block (the
# wgmma's N) by the rows of the call, 128 k a ring stage of codes (cols x
# 128 B) and x (rows x 128 B), 2-8 stages, one block an SM. From sweeps of
# forced plans over Qwen3-32B's four linears at 24-512 rows on the H100:
# blocks of 64 rows and 128 channels took qkv, o and down at 128 rows in
# less time than blocks of 128 x 256, and a ring of 8 stages with one block
# an SM mostly less than 4 stages with two
TILED_ROWS = {16: 16, 32: 32, 128: 64}
_TILED_SK = 128
_TILED_MAX_STAGES = 8
# a split's cost to a block (the cluster sum of int32 partials through
# distributed shared memory, two cluster barriers), in 128-k stages, from
# the same sweeps: a split paid off only where it kept the grid in one wave
# over a long K (down at 24-64 rows), and every split of blocks of 128 rows
# ran as long as the unsplit launch or up to 4x longer, so those take none
TILED_SPLIT_COST = 32


def _tiled_smem(nt: int, stages: int) -> tuple[int, int]:
    """(a block's dynamic shared memory, its ring's bytes) on the tiled
    GEMM (``tiled8::Layout``): each stage the codes (``cols`` channels x 128
    k) and x's rows (``nt`` x 128 k), then two barriers a stage and the room
    to align."""
    cols = 256 if nt == 128 else 128
    slot = (cols + nt) * _TILED_SK
    return stages * slot + 16 * stages + 1024, stages * slot


@dataclasses.dataclass(frozen=True)
class A8TiledPlan:
    """A launch of the tiled GEMM: blocks of ``nt`` x rows by ``cols``
    channels on a grid of ``cluster`` x ``row_blocks`` x ``col_blocks``;
    block r of a cluster of C takes K's ``units`` 128-k stages ``[r * units
    // C, (r + 1) * units // C)``; a ring of ``stages``; ``smem`` bytes of
    shared memory a block, one block an SM."""

    nt: int
    cols: int
    row_blocks: int
    col_blocks: int
    units: int
    cluster: int
    stages: int
    smem: int


def a8_tiled_plan(m: int, n: int, k: int, sms: int) -> A8TiledPlan:
    """The tiled GEMM's launch for an (m, k) x (n, k) product, K a multiple
    of 64 (the last stage's upper half zero-filled when K is not one of
    128): blocks of 16, 32 or 64 rows (up to 16, 32 and 128 rows) and 128
    channels, or of 128 rows and 256 channels past 128 rows, one block an
    SM; below 128 rows a block, K split across a cluster of 1, 2, 4 or 8
    blocks by :func:`~whisper_mlx_tpu_torch.ops.quant_matmul.cluster_split`
    where the grid would not fill ``sms`` SMs, a split charged
    ``TILED_SPLIT_COST`` stages; the deepest ring (2-8 stages) shared
    memory holds, at least the cluster sum's room."""
    if m <= GEMV_ROWS or k % 64:
        raise ValueError(f"a8 tiled GEMM: M {m}, K {k}")
    nt = next((nt for rows, nt in TILED_ROWS.items() if m <= rows), 128)
    cols = 256 if nt == 128 else 128
    row_blocks, col_blocks = -(-m // nt), -(-n // cols)
    units = -(-k // _TILED_SK)
    # clusters of 1, 2, 4 or 8 blocks (3, 5, 6 or 7 leave SMs of a GPC idle)
    cluster = 1 if nt == 128 else cluster_split(
        row_blocks * col_blocks, units, sms, lambda c: True, sizes=(1, 2, 4, 8),
        split_cost=TILED_SPLIT_COST)
    red = 4 * cols * nt if cluster > 1 else 0  # every block's chunks of the sums
    stages = _TILED_MAX_STAGES
    while stages > 2 and _tiled_smem(nt, stages)[0] > SMEM_LIMIT:
        stages -= 1
    smem, ring = _tiled_smem(nt, stages)
    if smem > SMEM_LIMIT or ring < red:
        raise ValueError(f"a8 tiled GEMM: no ring fits N {n}, K {k}")
    return A8TiledPlan(nt, cols, row_blocks, col_blocks, units, cluster, stages, smem)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def a8_matmul_kernel(x: torch.Tensor, at: A8Tensor) -> torch.Tensor:
    """Kernel K7 on CUDA tensors (the fused GEMV for at most 8 rows or K
    not a multiple of 64, else x quantized by a launch of its own, then the
    tiled GEMM as :func:`a8_tiled_plan` says); its plain version on CPU
    tensors."""
    *lead, k = x.shape
    n = at.n_orig
    if k != at.shape[1]:
        raise ValueError(f"a8_matmul: x {tuple(x.shape)} against weights {at!r}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"a8_matmul: x must be bfloat16 or float32, got {x.dtype}")
    for name, t in (("codes", at.codes), ("scale", at.scale)):
        if t.device != x.device:
            raise ValueError(f"a8_matmul: {name} on {t.device}, x on {x.device}")
    if x.device.type == "cpu":
        return a8_matmul_plain(x, at)
    if x.device.type != "cuda":
        raise ValueError(f"a8_matmul: unsupported device {x.device}")
    if k % 16:
        raise ValueError(f"a8_matmul: K {k} is not a multiple of 16")
    if at.codes.dtype != torch.int8 or not at.codes.is_contiguous() or \
            at.scale.dtype != torch.float32 or not at.scale.is_contiguous():
        raise ValueError("a8_matmul: codes must be contiguous int8 and scale contiguous fp32")
    codes = at.codes if at.codes.data_ptr() % 16 == 0 else at.codes.clone()  # TMA's alignment
    x2 = x.reshape(-1, k).contiguous()
    if x2.data_ptr() % 16:  # the kernels load x 16 bytes at a time
        x2 = x2.clone()
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return out.reshape(*lead, n)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    bf16 = int(x.dtype == torch.bfloat16)
    lib = _build.lib()
    if m <= GEMV_ROWS or k % 64:
        cluster, stages = a8_gemv_plan(m, n, k, _sm_count(x.device.index or 0))
        _build.check(lib.wmt_a8_gemv(x2.data_ptr(), codes.data_ptr(), at.scale.data_ptr(),
                                     out.data_ptr(), m, n, k, bf16, cluster, stages, stream),
                     "wmt_a8_gemv")
    else:
        plan = a8_tiled_plan(m, n, k, _sm_count(x.device.index or 0))
        xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
        sx = torch.empty((m,), dtype=torch.float32, device=x.device)
        _build.check(lib.wmt_a8_quantize(x2.data_ptr(), xq.data_ptr(), sx.data_ptr(), m, k, bf16,
                                         stream), "wmt_a8_quantize")
        _build.check(lib.wmt_a8_gemm(xq.data_ptr(), sx.data_ptr(), codes.data_ptr(),
                                     at.scale.data_ptr(), out.data_ptr(), m, n, k, bf16, plan.nt,
                                     plan.cluster, plan.stages, stream), "wmt_a8_gemm")
        global TILED_LAUNCHES
        TILED_LAUNCHES += 1
    global LAUNCHES
    LAUNCHES += 1
    return out.reshape(*lead, n)


def _linear_name(path: tuple) -> Any:
    """The name of the linear a leaf belongs to: ``down`` for
    ``(..., "down", "w")`` and for ``(..., "down")``."""
    if len(path) > 1 and path[-1] == "w":
        return path[-2]
    return path[-1] if path else None


def prepare_a8_params(params: Any, embed_keys: tuple = ("embed", "token_emb"),
                      tile_n: int = 512, depth: int = 4, max_n: int | None = None,
                      free_source: bool | None = None, skip_keys: tuple | None = None) -> Any:
    """Re-quantize every QuantTensor linear of a tree to :class:`A8Tensor`,
    at load. Embedding tables (dict keys in ``embed_keys``) stay packed for
    their row gathers. Linears named in ``skip_keys`` (``WTPU_A8_SKIP``,
    comma-separated; a linear is named by its own key, so ``down`` keeps
    ``{"down": {"w": ...}}`` packed) and those wider than ``max_n``
    (``WTPU_A8_MAX_N``) stay packed too.

    ``free_source`` (``WTPU_A8_FREE_SRC=1``) frees each packed source's
    storage as soon as its A8Tensor exists, so the conversion's peak is
    about one tree; storage reachable under an embedding key (a tied head)
    is never freed. The caller's tree is dead afterwards."""
    if max_n is None:
        mn = os.environ.get("WTPU_A8_MAX_N", "")
        max_n = int(mn) if mn else None
    if free_source is None:
        free_source = os.environ.get("WTPU_A8_FREE_SRC", "0") == "1"
    if skip_keys is None:
        skip_keys = tuple(p for p in os.environ.get("WTPU_A8_SKIP", "").split(",") if p)

    protected: set[int] = set()

    def scan(node: Any, under_embed: bool) -> None:
        if isinstance(node, QuantTensor):
            if under_embed:
                protected.update(t.untyped_storage().data_ptr()
                                 for t in (node.w_q, node.scales, node.biases))
        elif isinstance(node, dict):
            for k, v in node.items():
                scan(v, under_embed or k in embed_keys)
        elif isinstance(node, (list, tuple)):
            for v in node:
                scan(v, under_embed)

    if free_source:
        scan(params, False)

    def walk(node: Any, path: tuple) -> Any:
        if isinstance(node, QuantTensor):
            if _linear_name(path) in skip_keys or (max_n is not None and node.shape[0] > max_n):
                return node
            out = requant_a8(node, tile_n=tile_n, depth=depth)
            if free_source:
                for t in (node.w_q, node.scales, node.biases):
                    storage = t.untyped_storage()
                    # storage that torch does not own (numpy's) cannot be freed
                    if storage.data_ptr() not in protected and storage.resizable():
                        storage.resize_(0)
            return out
        if isinstance(node, dict):
            return {k: (v if k in embed_keys and isinstance(v, QuantTensor)
                        else walk(v, path + (k,)))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path) for v in node)
        return node

    return walk(params, ())
