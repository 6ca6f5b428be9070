"""Beam lane reorders of a layer's cache tensors (kernel K9) and their plain
PyTorch versions.

Counterpart of ``whisper_mlx_tpu/ops/lane_permute.py``:

- :func:`permute_lanes` (out of place): ``out[b] = in[parent[b]]`` along
  axis 0 of every tensor;
- :func:`lane_move_inplace`: row ``b <- row src[b]`` where ``src[b] != b``,
  in place, under the precondition that every source row is a fixed point
  (``src[b] != b`` implies ``src[src[b]] == src[b]``), which the beam's
  copy-on-divergence bookkeeping guarantees.

Rows are plain bytes to the kernel, so int8 codes, packed int4 codes, bf16
scales and fp rows all take the same path. On CUDA tensors both launch
``csrc/lane_permute.cu`` (one launch for up to 8 tensors) over an int32 row
map, the kernel's own type (an int64 map is converted first, one more
device kernel a call); on CPU tensors they run the plain versions, and the
move checks its precondition there.
"""

from __future__ import annotations

import ctypes

import torch

from whisper_mlx_tpu_torch.ops import _build

PERMUTE_LAUNCHES = 0
MOVE_LAUNCHES = 0
MAX_TENSORS = 8


def permute_lanes_plain(tensors: list[torch.Tensor], parent: torch.Tensor) -> list[torch.Tensor]:
    return [t[parent.long()] for t in tensors]


def lane_move_inplace_plain(tensors: list[torch.Tensor], src: torch.Tensor) -> list[torch.Tensor]:
    src = src.long()
    moved = src != torch.arange(src.shape[0], device=src.device)
    if bool((src[src[moved]] != src[moved]).any()):
        raise ValueError("lane_move_inplace: a source row is itself moved "
                         "(src[src[b]] != src[b])")
    for t in tensors:
        t[moved] = t[src[moved]]
    return tensors


def _check(tensors, index, name) -> None:
    if not 1 <= len(tensors) <= MAX_TENSORS:
        raise ValueError(f"{name}: 1 to {MAX_TENSORS} tensors, got {len(tensors)}")
    nb = tensors[0].shape[0]
    if index.dim() != 1 or index.shape[0] != nb or index.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{name}: the row map must be ({nb},) int32/int64, got "
                         f"{tuple(index.shape)} {index.dtype}")
    for t in (*tensors, index):
        if t.device != index.device:
            raise ValueError(f"{name}: tensors on different devices")
    for t in tensors:
        if t.shape[0] != nb or not t.is_contiguous():
            raise ValueError(f"{name}: every tensor must be contiguous with {nb} rows")


def _launch(srcs, dsts, index, skip_fixed: int) -> None:
    """One kernel launch moving the rows of every tensor."""
    n = len(srcs)
    row_bytes = [t[0].numel() * t.element_size() for t in srcs]
    for t, nbytes in zip((*srcs, *dsts), row_bytes * 2):
        if nbytes % 16 == 0 and t.data_ptr() % 16:
            raise ValueError("lane kernel: 16-byte rows need a 16-byte aligned tensor")
    rc = _build.lib().wmt_lane_copy(
        (ctypes.c_void_p * n)(*(t.data_ptr() for t in srcs)),
        (ctypes.c_void_p * n)(*(t.data_ptr() for t in dsts)),
        (ctypes.c_longlong * n)(*row_bytes), n, index.data_ptr(), index.shape[0],
        skip_fixed, torch.cuda.current_stream(index.device).cuda_stream,
    )
    _build.check(rc, "wmt_lane_copy")


def _on_cuda(index: torch.Tensor, name: str) -> bool:
    if index.device.type == "cpu":
        return False
    if index.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {index.device}")
    return True


def permute_lanes(tensors: list[torch.Tensor], parent: torch.Tensor) -> list[torch.Tensor]:
    """New tensors with ``out[b] = in[parent[b]]``; kernel K9 on CUDA."""
    _check(tensors, parent, "permute_lanes")
    if not _on_cuda(parent, "permute_lanes"):
        return permute_lanes_plain(tensors, parent)
    outs = [torch.empty_like(t) for t in tensors]
    _launch(tensors, outs, parent.to(torch.int32), 0)
    global PERMUTE_LAUNCHES
    PERMUTE_LAUNCHES += 1
    return outs


def lane_move_inplace(tensors: list[torch.Tensor], src: torch.Tensor) -> list[torch.Tensor]:
    """Row ``b <- row src[b]`` where ``src[b] != b``, in place; kernel K9 on
    CUDA. Returns the same tensors."""
    _check(tensors, src, "lane_move_inplace")
    if not _on_cuda(src, "lane_move_inplace"):
        return lane_move_inplace_plain(tensors, src)
    _launch(tensors, tensors, src.to(torch.int32), 1)
    global MOVE_LAUNCHES
    MOVE_LAUNCHES += 1
    return tensors
