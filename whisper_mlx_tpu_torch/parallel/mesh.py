"""Ranks, the ``("dp", "tp")`` mesh and the collectives the models call.

Counterpart of ``whisper_mlx_tpu/parallel/mesh.py``. There the mesh is a
``jax.sharding.Mesh`` over every device of the job and XLA inserts the
collectives. Here each rank is one process on one device
(``torch.distributed``), every rank runs the same program (SPMD), and a
:class:`Mesh` holds this rank's coordinate and the process groups of its
two axes:

- "dp" splits the window batch: each rank encodes and decodes its
  contiguous slice, and the results are gathered in rank order;
- "tp" splits attention heads, MLP widths and the vocabulary (Megatron):
  the row-parallel linears sum their partials over "tp", the logits are
  gathered over it.

Rank ``r`` sits at ``(r // tp, r % tp)``: tp innermost, as in the JAX
package, so that a tensor-parallel group is made of neighbouring ranks.

Backends: NCCL when the ranks' devices are CUDA, gloo on the CPU; any other
backend only when the caller names it (two ranks sharing one card must name
gloo: NCCL refuses them). A failure is never retried on another backend.
Gloo reads host memory, so CUDA tensors go through host copies on a gloo
group. Every sum runs in :data:`REDUCE_DTYPE` (fp32) whatever the tensor's
dtype and the backend, so gloo and NCCL give the same numbers.

A mesh of one rank needs no process group: its collectives are the
identity.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any

import torch
import torch.distributed as dist

AXES = ("dp", "tp")
REDUCE_DTYPE = torch.float32
# how long a collective or the rendezvous waits for the other ranks
TIMEOUT = datetime.timedelta(seconds=600)
# collectives this process has run over more than one rank, by kind
COUNTS = {"all_sum": 0, "all_gather": 0, "broadcast": 0, "all_gather_objects": 0}


def default_device(rank: int = 0) -> torch.device:
    """``cuda:LOCAL_RANK`` on a CUDA host (``rank`` modulo the cards when
    ``LOCAL_RANK`` is unset), else the CPU."""
    if torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        return torch.device("cuda", local)
    return torch.device("cpu")


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, backend: str | None = None, *,
                     device: torch.device | str | None = None) -> None:
    """Join a job of ``num_processes`` ranks whose rendezvous is
    ``tcp://{coordinator}`` (``host:port``); a no-op for one process.

    ``backend`` defaults to NCCL when this rank's ``device`` (default:
    :func:`default_device`) is CUDA and to gloo otherwise."""
    if not num_processes or num_processes <= 1:
        return
    if coordinator is None or process_id is None:
        raise ValueError("init_distributed: a job of several processes needs coordinator "
                         "and process_id")
    device = torch.device(device) if device is not None else default_device(process_id)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id, timeout=TIMEOUT)


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's place in a ``dp x tp`` grid of ranks and the groups of
    its two axes (``None`` for an axis of one rank). Hashes by identity,
    so that a model config can carry it."""

    dp: int
    tp: int
    rank: int = 0
    device: torch.device = dataclasses.field(default_factory=lambda: torch.device("cpu"))
    groups: dict[str, Any] = dataclasses.field(default_factory=dict, repr=False)

    axis_names = AXES

    @property
    def shape(self) -> dict[str, int]:
        return {"dp": self.dp, "tp": self.tp}

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.rank // self.tp if axis == "dp" else self.rank % self.tp


def make_mesh(dp: int | None = None, tp: int = 1, devices=None) -> Mesh:
    """Mesh with axes ``("dp", "tp")`` over every rank of the job (one rank
    without a process group); ``dp`` defaults to ranks // tp. ``devices``
    names each rank's device in rank order. Every rank calls it, with the
    same arguments."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp}*{tp} != {n} devices")
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        if len(devices) != n:
            raise ValueError(f"make_mesh: {len(devices)} devices for {n} ranks")
    device = devices[rank] if devices is not None else default_device(rank)
    groups: dict[str, Any] = {"dp": None, "tp": None}
    if n > 1:
        # every rank creates every group, in the same order
        for d in range(dp):
            g = dist.new_group([d * tp + t for t in range(tp)]) if tp > 1 else None
            if rank // tp == d:
                groups["tp"] = g
        for t in range(tp):
            g = dist.new_group([d * tp + t for d in range(dp)]) if dp > 1 else None
            if rank % tp == t:
                groups["dp"] = g
    return Mesh(dp=dp, tp=tp, rank=rank, device=device, groups=groups)


# ---------------------------------------------------------------------------
# placements (the counterparts of NamedSharding: spec ``()`` is JAX's
# ``replicated``; ``sharding.py:shard_batch`` its ``dp_sharding``)
# ---------------------------------------------------------------------------


def local_slice(n: int, parts: int, index: int) -> slice:
    """Part ``index`` of ``n`` items split ``parts`` ways, ceil-sized as
    GSPMD pads an uneven dimension: the last parts may be shorter."""
    size = -(-n // parts)
    return slice(min(index * size, n), min((index + 1) * size, n))


def local_shard(x: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """This rank's piece of ``x`` under ``spec`` (one entry per dimension:
    an axis name, a tuple of them, or ``None``), as a contiguous copy of its
    own; a replicated spec returns ``x`` itself."""
    out = x
    for dim, entry in enumerate(spec):
        names = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
        parts, index = 1, 0
        for name in names:
            parts, index = parts * mesh.size(name), index * mesh.size(name) + mesh.index(name)
        if parts > 1:
            out = out[(slice(None),) * dim + (local_slice(x.shape[dim], parts, index),)]
    return out if out is x else out.clone(memory_format=torch.contiguous_format)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _group(mesh: Mesh | None, axis: str | None):
    """-> (group, size) of ``axis`` (``None``: every rank), or (None, 1)."""
    if mesh is None:
        return None, 1
    if axis is None:
        n = mesh.dp * mesh.tp
        return (dist.group.WORLD if n > 1 else None), n
    return mesh.groups.get(axis), mesh.size(axis)


def _staged(x: torch.Tensor, group) -> bool:
    """Whether a collective on ``group`` reads ``x`` through a host copy."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def all_sum(x: torch.Tensor, mesh: Mesh | None, axis: str = "tp") -> torch.Tensor:
    """Sum of ``x`` over ``axis``, computed in fp32, in ``x``'s dtype."""
    group, size = _group(mesh, axis)
    if size == 1:
        return x
    y = x.to("cpu" if _staged(x, group) else x.device, REDUCE_DTYPE, copy=True)
    COUNTS["all_sum"] += 1
    dist.all_reduce(y, group=group)
    return y.to(x.device, x.dtype)


def all_gather_cat(x: torch.Tensor, mesh: Mesh | None, axis: str, dim: int = 0,
                   total: int | None = None) -> torch.Tensor:
    """The pieces of ``axis``'s ranks concatenated along ``dim`` in axis
    order. ``total``: the full length of an uneven ceil split
    (:func:`local_slice`); pieces are padded to the ceil size and the
    result cut to ``total``."""
    group, size = _group(mesh, axis)
    if size == 1:
        return x
    dim = dim % x.dim()
    width = x.shape[dim] if total is None else -(-total // size)
    if x.shape[dim] < width:
        pad = list(x.shape)
        pad[dim] = width - x.shape[dim]
        x = torch.cat([x, x.new_zeros(pad)], dim=dim)
    src = x.movedim(dim, 0).contiguous()
    if _staged(src, group):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(size)]
    COUNTS["all_gather"] += 1
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=0).to(x.device).movedim(0, dim)
    if total is not None:
        out = out.narrow(dim, 0, total)
    return out.contiguous()


def broadcast(x: torch.Tensor, mesh: Mesh | None, axis: str | None = None) -> torch.Tensor:
    """``x`` of the first rank of ``axis`` (``None``: rank 0 of the job) on
    every rank of it; the others pass a tensor of the same shape and dtype
    to be filled."""
    group, size = _group(mesh, axis)
    if size == 1:
        return x
    y = x.cpu() if _staged(x, group) else x.contiguous()
    COUNTS["broadcast"] += 1
    dist.broadcast(y, src=dist.get_global_rank(group, 0) if axis is not None else 0,
                   group=group)
    return y.to(x.device)


def all_gather_objects(obj: Any, mesh: Mesh | None, axis: str | None) -> list:
    """Picklable ``obj`` of every rank of ``axis``, in axis order."""
    group, size = _group(mesh, axis)
    if size == 1:
        return [obj]
    out: list = [None] * size
    COUNTS["all_gather_objects"] += 1
    dist.all_gather_object(out, obj, group=group)
    return out
