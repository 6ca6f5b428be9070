"""Apply the ASR serving configuration to a loaded model.

Counterpart of ``whisper_mlx_tpu/runtime/serving_config.py:
apply_asr_serving_config``. The converter and ``init_params`` return the
parity configuration (fp32, plain attention, fp caches). Serving on CUDA
is bf16 with the encoder attention kernel, an int4 cross cache and an int8
self cache; on the CPU the parity configuration stays, as the JAX package
keeps it off-TPU.

Environment knobs (same names as the JAX package):
  WTPU_SERVE_PRECISION  bfloat16|float32 (default: bfloat16 on CUDA)
  WTPU_SERVE_FLASH      1|0             (default: 1 on CUDA)
  WTPU_SERVE_KV         4|8|0           (default: 4 on CUDA)
  WTPU_SERVE_SELF_KV    8|4|0           (default: 8 on CUDA)

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


def apply_asr_serving_config(params: Any, config: Any,
                             device: torch.device | str) -> tuple[Any, Any]:
    """(params, config) -> serving-configured (params, config) for
    ``device``; float weights are cast to the serving dtype."""
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
            if node.dtype in (torch.float32, torch.float16):
                return node.to(torch.bfloat16)
            return node

        params = walk(params)
    return params, new_cfg
