"""Microbenchmark: the dequant-matmul variants (K10a-g) beside a bf16 dense
matmul, at the whisper large-v3 decode-step shapes.

    python -m whisper_mlx_tpu_torch.probes.bench_quant_kernel [--device cpu]

Counterpart of ``scripts/bench_quant_kernel.py``. Shapes are the large-v3
decode-step matmuls on int4 weights (group 64) at ``QB_BATCH`` rows (24);
each variant runs ``QB_ITERS`` (100) times and the time is the device's per
call (``probes/timing.py``). The dense column is ``torch.matmul`` on the
same weights in bf16, a library call used as the yardstick only. Before the
timings every variant is checked against the production kernel K5 on the
same weights, and a line flags a relative error above 2e-2 (variant e7 is
expected to be flagged: the reference parks it as unsound in bf16).
Prints one line per shape: microseconds per call and the ratio to dense.
Without ``--device cpu`` it needs the card; a variant that fails raises.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from whisper_mlx_tpu_torch.ops import probe_quant_matmul as pq
from whisper_mlx_tpu_torch.ops.quant import quantize
from whisper_mlx_tpu_torch.ops.quant_matmul import quant_matmul_kernel
from whisper_mlx_tpu_torch.probes.timing import time_us
from whisper_mlx_tpu_torch.runtime.device import setup_device

ITERS = int(os.environ.get("QB_ITERS", "100"))
BATCH = int(os.environ.get("QB_BATCH", "24"))
BITS = 4
GROUP = 64
SHAPES = [  # (K, N, label): the large-v3 decode-step matmuls
    (1280, 3840, "qkv-fused"),
    (1280, 1280, "o-proj"),
    (1280, 5120, "fc1"),
    (5120, 1280, "fc2"),
    (1280, 51968, "logits"),
]


def make_variants(q) -> dict:
    """name -> function of x, each over its own operands made from ``q``."""
    sw, bw = pq.make_scale_words(q)
    q_str = pq.repack_strided(q)
    wqt = q.w_q.T.contiguous()
    return {
        "accum": lambda x: pq.quant_matmul_variant(x, q),
        "e1": lambda x: pq.quant_matmul_e1(x, q),
        "e2": lambda x: pq.quant_matmul_e2(x, q, sw, bw),
        "e3": lambda x: pq.quant_matmul_e3(x, q, sw),
        "e5": lambda x: pq.quant_matmul_e5(x, q_str),
        "e6-t256": lambda x: pq.quant_matmul_e6(x, q, 256),
        "e6-t512": lambda x: pq.quant_matmul_e6(x, q, 512),
        "e7-t256": lambda x: pq.quant_matmul_e7(x, wqt, q.scales, q.biases, BITS, GROUP, 256),
        "e7-t512": lambda x: pq.quant_matmul_e7(x, wqt, q.scales, q.biases, BITS, GROUP, 512),
    }


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="torch device: cuda or cpu")
    device = setup_device(parser.parse_args(argv).device)
    rng = np.random.default_rng(0)
    print(f"# batch={BATCH} iters={ITERS} backend={device.type}")
    for K, N, label in SHAPES:
        w = rng.standard_normal((N, K)).astype(np.float32) * 0.02
        q = quantize(torch.from_numpy(w).to(device), BITS, GROUP)
        w_bf = torch.from_numpy(w).to(device, torch.bfloat16)  # (N, K)
        x0 = torch.from_numpy(rng.standard_normal((BATCH, K))).to(device, torch.bfloat16)
        us_dense = time_us(lambda: torch.matmul(x0, w_bf.T), device, ITERS)
        variants = make_variants(q)
        # correctness: every variant against the production kernel's output
        x_chk = torch.from_numpy(rng.standard_normal((BATCH, K))).to(device, torch.bfloat16)
        ref = quant_matmul_kernel(x_chk, q.w_q, q.scales, q.biases, BITS, GROUP).float()
        for name, fn in variants.items():
            err = float((fn(x_chk).float() - ref).abs().max() / (ref.abs().max() + 1e-9))
            if err > 2e-2:
                print(f"  !! {label}/{name}: rel err {err:.3g}")
        line = [f"{label:>10} K={K:<5} N={N:<6} dense={us_dense:7.1f}us"]
        for name, fn in variants.items():
            us = time_us(lambda: fn(x0), device, ITERS)
            line.append(f"{name}={us:7.1f}us ({us / us_dense:4.2f}x)")
        print("  ".join(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
