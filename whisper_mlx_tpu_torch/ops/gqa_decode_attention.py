"""Grouped-query attention over the quantized LLM KV cache (kernel K3's GQA
mode) and its plain PyTorch version.

The function of ``whisper_mlx_tpu/models/qwen.py:289-300`` (the
reference's grouped path over an int8 / int4 cache, XLA on the TPU): query
head ``h`` reads KV head ``h // rep``, the key and value scales fold into
the attention exactly, and each batch row attends causally from its own
first position:

    s    = (q . k8_t) * (ks_t * scale)          fp32, t <= pos_b + i, t < live
    w    = softmax(s) * vs_t                    fp32
    out  = sum_t w_t v8_t                       fp32 -> out_dtype

Layouts (position-major, as ``models/qwen.py`` keeps the cache):

- ``q`` ``(B, KV * rep, Tq, hd)`` fp32 (rotated and normed, not
  pre-scaled: ``scale`` is applied in fp32);
- codes ``(B, KV, T, hd)`` int8, or ``(B, KV, T, hd/2)`` uint8 holding two
  signed int4 nibbles a byte (low nibble = even d), from
  ``ops/kv_quant.py:quantize_kv``;
- scales ``(B, KV, T)`` bf16;
- ``pos`` ``(B,)`` int32 on the queries' device: row ``b``'s query ``i``
  attends keys ``t <= pos[b] + i`` and ``t < live``; ``live`` is a host int,
  the keys any row may read (the grid is sized by it; each row reads only
  its own live prefix).

On a CUDA tensor :func:`gqa_decode_attention` launches
``csrc/gqa_decode_attention.cu`` (hd 64 or 128, Tq <= 16, T <= 32,768) on
the plan :func:`gqa_plan` makes from the shapes and the card's room for
clusters; on a CPU tensor it
runs :func:`gqa_decode_attention_plain`; on any other device it raises. The
plain version runs on any device; the model never calls it on the card.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from whisper_mlx_tpu_torch.ops import _build
from whisper_mlx_tpu_torch.ops.decode_attention import unpack_codes

LAUNCHES = 0
HEAD_DIMS = (64, 128)
MAX_TQ = 16  # the verify of k + 1 <= 16 positions
MAX_T = 32_768  # max_position_embeddings of every Qwen config
# the kernel's launch plan (mirrored in csrc/gqa_decode_attention.cu, which
# checks it at launch)
ROWS = 8  # query rows a pass: the mma's n
SPLIT = 64  # the fewest live keys a block of the cluster takes
MAX_BLOCKS = 16  # blocks a cluster (past the portable 8: a non-portable cluster)
WIDE_BLOCKS = (16, 8, 4)  # cluster sizes a launch held at once may take
CONSUMERS = 8  # consumer warps, a 16-key tile each a ring slot
STAGE_KEYS = 16 * CONSUMERS  # keys a ring slot
SCALE_SLOT = (STAGE_KEYS + 8) * 2  # a slot's scales from a 16-byte-aligned start
MAX_STAGES = 8
RING_ONE = 200_000  # the ring's room at one block an SM: 6 slots of int8 hd 128
RING_TWO = 100_000  # at two blocks an SM: 3 slots


@dataclasses.dataclass(frozen=True)
class GqaPlan:
    """K3's GQA launch: ``blocks`` a (batch row, KV head, pass), one
    thread-block cluster ``cluster``; ``rows`` query rows a pass of the
    ``rep * tq`` a KV head has, ``passes`` of them; a ring of ``stages``
    slots of ``STAGE_KEYS`` keys; ``smem`` bytes of shared memory a block;
    the launch's ``grid``; ``held``: every cluster of the launch on the card
    at once, one block an SM (the wide ring), else two blocks an SM."""

    blocks: int
    rows: int
    passes: int
    stages: int
    smem: int
    grid: tuple[int, int, int]
    held: bool

    @property
    def cluster(self) -> tuple[int, int, int]:
        return (self.blocks, 1, 1)


def gqa_stage_bytes(hd: int, bits: int) -> int:
    """A ring slot: its keys' K and V codes and their scales' windows."""
    return 2 * STAGE_KEYS * hd * bits // 8 + 2 * SCALE_SLOT


def gqa_ring_slots(hd: int, bits: int, held: bool) -> int:
    """The most ring slots a block takes: at one block an SM (``held``) or
    two."""
    return min(MAX_STAGES, (RING_ONE if held else RING_TWO) // gqa_stage_bytes(hd, bits))


def gqa_smem(hd: int, bits: int, stages: int) -> int:
    """A block's shared memory (the kernel's ``layout``): the ring, which
    the warps' outputs (rows of ``hd + 1``) take over after the key loop;
    the pass's query rows in 2 fp16 parts and their scales, the warps'
    row statistics, the statistics the cluster's blocks push and their
    factors, the outputs pushed, the ring's barriers."""
    red = (CONSUMERS * ROWS * (hd + 1) * 4 + 15) // 16 * 16
    return (max(stages * gqa_stage_bytes(hd, bits), red) + 2 * ROWS * hd * 2 + ROWS * 4
            + CONSUMERS * ROWS * 2 * 4 + MAX_BLOCKS * ROWS * 2 * 4 + MAX_BLOCKS * ROWS * 4
            + (ROWS * hd + MAX_BLOCKS) * 4 + 2 * MAX_STAGES * 8)


def gqa_plan(b: int, n_kv: int, rep: int, tq: int, hd: int, bits: int, live: int, *,
             room: dict | None = None, sms: int = 132) -> GqaPlan:
    """The launch from shapes and two facts of the card: ``room``, the
    clusters of 16, 8 and 4 blocks it holds at once at one block an SM
    (``cudaOccupancyMaxActiveClusters`` at the wide ring; none: no cluster
    is taken as held), and its ``sms``.

    The ``rep * tq`` query rows of a KV head go in passes of ``ROWS`` (one
    n8 tile: a decode step's 8 rows at rep 8 in one, Tq 5's 40 in five, rep
    7 padded to 8), a (batch row, KV head, pass) to a cluster. A cluster
    takes a block a ``SPLIT`` live keys of the longest row, at most
    ``MAX_BLOCKS``, and then as measured on the H100 (``PERF.md`` §6): the
    largest size of ``WIDE_BLOCKS`` whose clusters the card holds
    all at once, one block an SM, with a wide ring; where none is held (many
    rows or passes), about ``4 sms / 3`` blocks in all at two an SM (packing
    two blocks of a cluster onto an SM, or clusters in waves, cost 5-45 %).
    The ring takes as many slots as the longest block's keys need, at most
    its room (longer slices stream through it)."""
    if not (1 <= b <= 65535 and n_kv >= 1 and rep >= 1 and 1 <= tq <= MAX_TQ
            and hd in HEAD_DIMS and bits in (4, 8) and 1 <= live <= MAX_T and sms >= 1):
        raise ValueError(f"gqa_plan: b {b}, n_kv {n_kv}, rep {rep}, tq {tq}, hd {hd}, "
                         f"bits {bits}, live {live}, sms {sms}")
    passes = -(-rep * tq // ROWS)
    if n_kv * passes > 65535:
        raise ValueError(f"gqa_plan: {n_kv} KV heads x {passes} passes past the grid")
    clusters = b * n_kv * passes
    most_blocks = min(MAX_BLOCKS, -(-live // SPLIT))
    held = [c for c in WIDE_BLOCKS if c <= most_blocks and clusters <= (room or {}).get(c, 0)]
    blocks = held[0] if held else max(1, min(most_blocks, round(sms * 4 / 3 / clusters)))
    most = -(-live // blocks)  # the longest block's keys
    stages = min(gqa_ring_slots(hd, bits, bool(held)), -(-most // STAGE_KEYS))
    return GqaPlan(blocks, ROWS, passes, stages, gqa_smem(hd, bits, stages),
                   (blocks, n_kv * passes, b), bool(held))


_CARD: dict = {}


def gqa_cluster_room(device: torch.device, hd: int, bits: int, blocks: int) -> int:
    """``cudaOccupancyMaxActiveClusters`` for the kernel's clusters of
    ``blocks`` at its wide ring (one block an SM): how many the card holds
    at once."""
    with torch.cuda.device(device):
        room = _build.lib().wmt_gqa_cluster_room(hd, bits, blocks,
                                                 gqa_ring_slots(hd, bits, True))
    if room < 0:
        _build.check(-room, "wmt_gqa_cluster_room")
    return room


def _card(device: torch.device, hd: int, bits: int) -> tuple[dict, int]:
    """The plan's facts of the card (the room for each size of
    ``WIDE_BLOCKS``, the SM count), asked once a device and width."""
    key = (device.index, hd, bits)
    if key not in _CARD:
        _CARD[key] = ({c: gqa_cluster_room(device, hd, bits, c) for c in WIDE_BLOCKS},
                      torch.cuda.get_device_properties(device).multi_processor_count)
    return _CARD[key]


@functools.lru_cache(maxsize=4096)
def _device_plan(index: int, b: int, n_kv: int, rep: int, tq: int, hd: int, bits: int,
                 live: int) -> GqaPlan:
    """The plan on CUDA device ``index``: a decode step's layers share one."""
    room, sms = _card(torch.device("cuda", index), hd, bits)
    return gqa_plan(b, n_kv, rep, tq, hd, bits, live, room=room, sms=sms)


def causal_mask(pos: torch.Tensor, tq: int, live: int) -> torch.Tensor:
    """Additive causal mask ``(b, 1, 1, tq, live)`` fp32 over ``(b, kv, rep,
    tq, keys)``: row ``b``'s query ``i`` sees keys ``t <= pos[b] + i``."""
    q_idx = pos.long()[:, None] + torch.arange(tq, device=pos.device)
    k_idx = torch.arange(live, device=pos.device)
    return torch.where(k_idx <= q_idx[..., None], 0.0, float("-inf"))[:, None, None]


def grouped_attention(q, k, v, mask, scale: float, ks=None, vs=None) -> torch.Tensor:
    """The reference's grouped-query attention (``models/qwen.py:289-300``):
    query head ``h`` reads KV head ``h // rep`` with no repeat of the cache.

    ``q`` ``(b, H, tq, hd)``; ``k``, ``v`` ``(b, KV, keys, hd)``; ``mask``
    additive, broadcast over ``(b, KV, rep, tq, keys)``. With no scales
    (the fp cache) the scores are taken in ``q`` and ``k``'s promoted dtype
    and the weights cast to ``v``'s; with ``ks`` / ``vs`` ``(b, KV, keys)``
    fp32 (the quantized cache, ``k`` and ``v`` its codes in fp32) they fold
    in exactly: ``ks * scale`` into the scores, ``vs`` into the weights.
    -> ``(b, H, tq, hd)``."""
    b, h, tq, hd = q.shape
    q5 = q.reshape(b, k.shape[1], h // k.shape[1], tq, hd)
    cdt = torch.promote_types(q5.dtype, k.dtype)
    s = torch.einsum("bgrqd,bgkd->bgrqk", q5.to(cdt), k.to(cdt))
    s = s * scale if ks is None else s * (ks * scale)[:, :, None, None, :]
    w = torch.softmax(s.to(torch.promote_types(s.dtype, torch.float32)) + mask, dim=-1)
    if vs is not None:
        w = w * vs[:, :, None, None, :]
    return torch.einsum("bgrqk,bgkd->bgrqd", w.to(v.dtype), v).reshape(b, h, tq, hd)


def gqa_decode_attention_plain(q, k, ks, v, vs, pos, *, scale: float, live: int,
                               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The reference's scale-folded grouped attention in fp32."""
    out = grouped_attention(q.float(), unpack_codes(k[:, :, :live]).float(),
                            unpack_codes(v[:, :, :live]).float(),
                            causal_mask(pos.to(q.device), q.shape[2], live), scale,
                            ks[:, :, :live].float(), vs[:, :, :live].float())
    return out.to(out_dtype)


def _check_inputs(q, k, ks, v, vs, pos, live, out_dtype) -> int:
    """The input contract, checked on every device so the CPU tests hold the
    callers to it -> the code width in bits. Positions are read only on the
    CPU: on the card they stay on the device, and the kernel caps each row's
    keys at ``live``."""
    if q.dim() != 4 or q.dtype != torch.float32:
        raise ValueError(f"gqa_decode_attention: q must be (B, H, Tq, hd) float32, "
                         f"got {tuple(q.shape)} {q.dtype}")
    b, h, tq, hd = q.shape
    if k.dtype != v.dtype or k.shape != v.shape or k.dim() != 4:
        raise ValueError("gqa_decode_attention: k and v codes differ in dtype or shape")
    bits = {torch.int8: 8, torch.uint8: 4}.get(k.dtype)
    n, n_kv, t_alloc, width = k.shape
    if bits is None or width != hd * bits // 8:
        raise ValueError(f"gqa_decode_attention: codes must be int8 (.., {hd}) or uint8 "
                         f"(.., {hd // 2}), got {tuple(k.shape)} {k.dtype}")
    if n != b or n_kv < 1 or h % n_kv:
        raise ValueError(f"gqa_decode_attention: {b} query rows of {h} heads over "
                         f"{n} cache rows of {n_kv} KV heads")
    for name, s in (("ks", ks), ("vs", vs)):
        if s.dtype != torch.bfloat16 or tuple(s.shape) != (b, n_kv, t_alloc):
            raise ValueError(f"gqa_decode_attention: {name} must be ({b}, {n_kv}, {t_alloc}) "
                             f"bfloat16, got {tuple(s.shape)} {s.dtype}")
    if pos.dtype != torch.int32 or tuple(pos.shape) != (b,):
        raise ValueError(f"gqa_decode_attention: pos must be ({b},) int32, "
                         f"got {tuple(pos.shape)} {pos.dtype}")
    for name, t in (("q", q), ("k", k), ("ks", ks), ("v", v), ("vs", vs), ("pos", pos)):
        if not t.is_contiguous():
            raise ValueError(f"gqa_decode_attention: {name} must be contiguous")
        if t.device != q.device:
            raise ValueError("gqa_decode_attention: tensors on different devices")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gqa_decode_attention: out_dtype {out_dtype}")
    if not 1 <= live <= t_alloc:
        raise ValueError(f"gqa_decode_attention: live {live} past the cache of {t_alloc}")
    if q.device.type == "cpu" and not bool(((pos >= 0) & (pos < live)).all()):
        raise ValueError(f"gqa_decode_attention: positions {pos.tolist()} outside "
                         f"[0, {live}): a row past the cache end")
    return bits


def gqa_decode_attention(q, k, ks, v, vs, pos, *, scale: float, live: int,
                         out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Grouped-query attention over a quantized cache; K3's GQA mode on CUDA
    tensors, the plain version on CPU tensors."""
    bits = _check_inputs(q, k, ks, v, vs, pos, live, out_dtype)
    if q.device.type == "cpu":
        return gqa_decode_attention_plain(q, k, ks, v, vs, pos, scale=scale, live=live,
                                          out_dtype=out_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"gqa_decode_attention: unsupported device {q.device}")
    b, h, tq, hd = q.shape
    n_kv, t_alloc = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS or not 1 <= tq <= MAX_TQ or t_alloc > MAX_T:
        raise ValueError(f"gqa_decode_attention: the kernel takes hd {HEAD_DIMS}, Tq 1 to "
                         f"{MAX_TQ} and caches up to {MAX_T} positions, got hd {hd}, "
                         f"Tq {tq}, {t_alloc} positions")
    if any(t.data_ptr() % 16 for t in (k, ks, v, vs)):  # the kernel copies 16-byte pieces
        raise ValueError("gqa_decode_attention: codes and scales must start on 16-byte "
                         "boundaries")
    if not math.isfinite(scale):
        raise ValueError(f"gqa_decode_attention: scale {scale}")
    plan = _device_plan(q.device.index, b, n_kv, h // n_kv, tq, hd, bits, int(live))
    out = torch.empty((b, h, tq, hd), dtype=out_dtype, device=q.device)
    rc = _build.lib().wmt_gqa_decode_attention(
        q.data_ptr(), k.data_ptr(), ks.data_ptr(), v.data_ptr(), vs.data_ptr(), pos.data_ptr(),
        out.data_ptr(), b, n_kv, h // n_kv, tq, hd, t_alloc, int(live), bits, float(scale),
        int(out_dtype == torch.bfloat16), plan.blocks, plan.rows, plan.stages,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "wmt_gqa_decode_attention")
    global LAUNCHES
    LAUNCHES += 1
    return out
