"""Microbenchmark: decode attention over an int8 KV cache, kernel K3 and the
batched time-minor variant K11 beside plain dequantize + attention.

    python -m whisper_mlx_tpu_torch.probes.bench_decode_attention [--device cpu]

Counterpart of ``scripts/bench_decode_attention.py``. Shapes are the
large-v3 decode-step attention calls at ``DB_BATCH`` rows (24): cross (Tk
1500 padded to 1536, no mask) and self (Tk 448 padded to 512, causal, pos
200). ``xla`` is the yardstick: the cache dequantized by plain PyTorch ops
and attended, used by nothing else. ``k3`` is the production kernel on the
same codes in its own position-major layout (it has no tile parameter);
``bat8`` / ``bat16`` / ``bat32`` are K11 at ``bh_tile`` 8, 16 and 32. Each
runs ``DB_ITERS`` (200) times; times are the device's per call
(``probes/timing.py``). A line flags K11 where it is further than 2e-2
(relative) from K3. Without ``--device cpu`` it needs the card.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from whisper_mlx_tpu_torch.ops.decode_attention import decode_attention
from whisper_mlx_tpu_torch.ops.kv_quant import quantize_kv
from whisper_mlx_tpu_torch.ops.probe_decode_attention import batched_attention
from whisper_mlx_tpu_torch.probes.timing import time_us
from whisper_mlx_tpu_torch.runtime.device import setup_device

ITERS = int(os.environ.get("DB_ITERS", "200"))
B = int(os.environ.get("DB_BATCH", "24"))
H, HD = 20, 64
CASES = [("cross", 1500, False, 0), ("self", 448, True, 200)]  # label, Tk, causal, pos


def xla_attention(q, k8t, ks, v8, vs, mask):
    """Dequantize-and-attend in plain PyTorch ops: the yardstick."""
    scores = torch.matmul(q.float(), k8t.float()) * ks[:, :, None, :] + mask
    w = torch.softmax(scores, dim=-1) * vs[:, :, None, :]
    return torch.matmul(w, v8.float()).to(q.dtype)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="torch device: cuda or cpu")
    device = setup_device(parser.parse_args(argv).device)
    rng = np.random.default_rng(0)
    print(f"# B={B} H={H} hd={HD} iters={ITERS} backend={device.type}")
    for label, tk_real, causal, pos in CASES:
        tk = -(-tk_real // 128) * 128
        k = torch.from_numpy(rng.standard_normal((B, H, tk, HD)).astype(np.float32)).to(device)
        v = torch.from_numpy(rng.standard_normal((B, H, tk, HD)).astype(np.float32)).to(device)
        k8, ks = quantize_kv(k)
        v8, vs = quantize_kv(v)
        k8t = k8.transpose(2, 3).contiguous()
        ks32, vs32 = ks.float(), vs.float()
        q0 = torch.from_numpy(rng.standard_normal((B, H, 1, HD)) * 0.2).to(device, torch.bfloat16)
        ki = torch.arange(tk, device=device)[None, :]
        live = ki <= pos if causal else ki < tk_real
        mask = torch.where(live, 0.0, float("-inf")).float()

        gb = (B * H * tk * HD * 2 + B * H * tk * 8) / 1e9  # int8 K+V + scales
        us_xla = time_us(lambda: xla_attention(q0, k8t, ks32, v8, vs32, mask), device, ITERS)
        line = [f"{label:>6} Tk={tk:<5} {gb*1e3:.0f}MB  "
                f"xla={us_xla:7.1f}us ({gb / (us_xla / 1e6):.0f}GB/s)"]
        kw = dict(pos=pos, causal=causal, valid_len=tk_real)
        variants = [("k3", lambda q: decode_attention(q, k8, ks, v8, vs, **kw))]
        for tile in (8, 16, 32):
            variants.append((f"bat{tile}", lambda q, tile=tile: batched_attention(
                q, k8t, ks32, v8, vs32, bh_tile=tile, **kw)))
        ref = variants[0][1](q0).float()
        for name, fn in variants[1:]:
            err = float((fn(q0).float() - ref).abs().max() / (ref.abs().max() + 1e-9))
            if err > 2e-2:
                print(f"  !! {label}/{name}: rel err {err:.3g} against k3")
        for name, fn in variants:
            us = time_us(lambda: fn(q0), device, ITERS)
            line.append(f"{name}={us:7.1f}us ({gb / (us / 1e6):.0f}GB/s, {us / us_xla:4.2f}x)")
        print("  ".join(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
