"""The ASR serving configuration: the model's, and the batcher's knobs.

Counterpart of ``whisper_mlx_tpu/runtime/serving_config.py``. The
converter and ``init_params`` return the
parity configuration (fp32, plain attention, fp caches). Serving on CUDA
is bf16 with the encoder attention kernel, an int4 cross cache and an int8
self cache; on the CPU the parity configuration stays, as the JAX package
keeps it off-TPU.

Environment knobs (same names as the JAX package):
  WTPU_SERVE_PRECISION  bfloat16|float32 (default: bfloat16 on CUDA)
  WTPU_SERVE_FLASH      1|0             (default: 1 on CUDA)
  WTPU_SERVE_KV         4|8|0           (default: 4 on CUDA)
  WTPU_SERVE_SELF_KV    8|4|0           (default: 8 on CUDA)
  WTPU_TRANSCRIBE_BATCH the serving batcher's window-batch buckets, an int
                        or a comma list (default: "8,16,32,56" on CUDA, the
                        reference's accelerator default, which no
                        measurement on the card has chosen yet; 8 on the
                        CPU); a flush rides the smallest bucket that fits
  SERVE_WAIT_MS         the batcher's hard flush deadline (default 50)
  SERVE_IDLE_GAP_MS     its debounce for a lone request (default 25)
  WTPU_SERVE_DP         data-parallel width of the daemon's batcher: "auto"
                        (default: every card of a CUDA host, 1 on the CPU)
                        or an int; 1 or less serves on one device. On CUDA
                        a width above the host's cards raises; on the CPU a
                        width of n runs n processes on the host. The daemon
                        (serving/server.py) starts the follower ranks

TranscriptionBatcher (runtime/batcher.py) reads the three before it by
default.

On CUDA the hand-written kernels are the only attention path, so
float32, FLASH=0 and a KV width of 0 (fp caches with plain attention)
raise there. A value that does not parse raises on every device.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch


def _env_choice(name: str, default: str, allowed: tuple[str, ...]) -> str:
    value = os.environ.get(name, default)
    if value not in allowed:
        raise ValueError(f"{name}={value!r}: expected one of {allowed}")
    return value


def _env_float(name: str, default: float) -> float:
    value = os.environ.get(name, "")
    try:
        return float(value) if value else default
    except ValueError:
        raise ValueError(f"{name}={value!r}: expected a number") from None


def serving_flush_knobs() -> tuple[float, float]:
    """(max_wait_ms, idle_gap_ms) for the batcher's adaptive flush."""
    return _env_float("SERVE_WAIT_MS", 50.0), _env_float("SERVE_IDLE_GAP_MS", 25.0)


def serving_batch_buckets(device: torch.device | str) -> tuple[int, ...]:
    """Sorted window-batch buckets of the serving batcher on ``device``."""
    on_cuda = torch.device(device).type == "cuda"
    raw = os.environ.get("WTPU_TRANSCRIBE_BATCH", "") or ("8,16,32,56" if on_cuda else "8")
    try:
        buckets = tuple(sorted({int(p) for p in raw.split(",") if p.strip()}))
    except ValueError:
        raise ValueError(f"WTPU_TRANSCRIBE_BATCH={raw!r}: expected an int or a comma "
                         "list of ints") from None
    if not buckets or buckets[0] < 1:
        raise ValueError(f"WTPU_TRANSCRIBE_BATCH={raw!r}: buckets must be positive")
    return buckets


def serving_dp(device: torch.device | str) -> int:
    """The ASR serving's data-parallel width from ``WTPU_SERVE_DP``: "auto"
    takes every card of a CUDA host (1 on the CPU), an int pins it; 1 or
    less is 1. On CUDA a width above the host's cards raises ``ValueError``."""
    raw = os.environ.get("WTPU_SERVE_DP", "auto").strip().lower()
    on_cuda = torch.device(device).type == "cuda"
    n = torch.cuda.device_count() if on_cuda else 1
    if raw in ("", "auto"):
        dp = n
    else:
        try:
            dp = int(raw)
        except ValueError:
            raise ValueError(f"WTPU_SERVE_DP={raw!r}: expected 'auto' or an int") from None
    if on_cuda and dp > n:
        raise ValueError(f"WTPU_SERVE_DP={dp} exceeds {n} local devices")
    return max(dp, 1)


def serving_mesh(device: torch.device | str) -> Any:
    """The ASR serving mesh (dp x 1) over the job's ranks, or ``None`` when
    one device serves. A width of n needs a job of n ranks
    (``parallel/mesh.py:init_distributed``), which the daemon starts; rank
    r serves on ``cuda:r`` on a CUDA host."""
    dp = serving_dp(device)
    if dp == 1:
        return None
    from whisper_mlx_tpu_torch.parallel.mesh import make_mesh

    if torch.device(device).type == "cuda":
        return make_mesh(dp=dp, tp=1, devices=[f"cuda:{r}" for r in range(dp)])
    return make_mesh(dp=dp, tp=1, devices=["cpu"] * dp)


def apply_asr_serving_config(params: Any, config: Any,
                             device: torch.device | str) -> tuple[Any, Any]:
    """(params, config) -> serving-configured (params, config) for
    ``device``; float weights are cast to the serving dtype, quantized
    leaves stay as they are (their fp32 scales and biases are the fused
    kernels' accuracy contract)."""
    on_cuda = torch.device(device).type == "cuda"
    precision = _env_choice("WTPU_SERVE_PRECISION", "bfloat16" if on_cuda else "",
                            ("bfloat16", "float32", ""))
    flash = _env_choice("WTPU_SERVE_FLASH", "1" if on_cuda else "0", ("1", "0")) == "1"
    kv_bits = int(_env_choice("WTPU_SERVE_KV", "4" if on_cuda else "0", ("4", "8", "0")))
    self_kv = int(_env_choice("WTPU_SERVE_SELF_KV", "8" if on_cuda else "0",
                              ("8", "4", "0")))
    if on_cuda and (precision != "bfloat16" or not flash or not kv_bits or not self_kv):
        raise ValueError(
            "on CUDA the kernels take bf16 and quantized caches: "
            "WTPU_SERVE_PRECISION=bfloat16, WTPU_SERVE_FLASH=1, WTPU_SERVE_KV 4|8 and "
            f"WTPU_SERVE_SELF_KV 4|8 (got {precision!r}, flash={int(flash)}, "
            f"kv={kv_bits}, self_kv={self_kv})")

    new_cfg = dataclasses.replace(config, flash_attention=flash, kv_bits=kv_bits,
                                  self_kv_bits=self_kv)
    if precision == "bfloat16" and config.dtype != torch.bfloat16:
        new_cfg = dataclasses.replace(new_cfg, dtype=torch.bfloat16)

        def walk(node):
            if isinstance(node, dict):
                return {k: walk(v) for k, v in node.items()}
            if isinstance(node, list):
                return [walk(v) for v in node]
            if not isinstance(node, torch.Tensor):  # QuantTensor and its kin
                return node
            if node.dtype in (torch.float32, torch.float16):
                return node.to(torch.bfloat16)
            return node

        params = walk(params)
    return params, new_cfg
