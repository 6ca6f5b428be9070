"""Ablation: where does the decode-attention work spend its time?

    python -m whisper_mlx_tpu_torch.probes.bench_da_ablation [--device cpu]

Counterpart of ``scripts/bench_da_ablation.py``. Five cumulative stages of
kernel K12 at the cross shape (B 24, H 20, Tk 1536, hd 64, ``AB_BH`` pairs a
block, default 16), over int8 K and V both ``(bh, hd, Tk)``:

  dmak  - move the K block, use one element
  dma   - move the K and V blocks (no cast, no math)
  cast  - + int8 -> bf16 of both blocks, consumed through a max
  dots  - + the two dots (no softmax)
  full  - the whole attention (softmax)

Prints one line per stage: the device's microseconds per call
(``probes/timing.py``) and the cache bytes over that time. Without
``--device cpu`` it needs the card.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from whisper_mlx_tpu_torch.ops.probe_decode_attention import STAGES, ablation_stage
from whisper_mlx_tpu_torch.probes.timing import time_us
from whisper_mlx_tpu_torch.runtime.device import setup_device

B, H, HD, TK = 24, 20, 64, 1536
BH_TILE = int(os.environ.get("AB_BH", "16"))
ITERS = 200


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="torch device: cuda or cpu")
    device = setup_device(parser.parse_args(argv).device)
    rng = np.random.default_rng(0)
    kt = torch.from_numpy(rng.integers(-127, 128, (B * H, HD, TK)).astype(np.int8)).to(device)
    v = torch.from_numpy(rng.integers(-127, 128, (B * H, HD, TK)).astype(np.int8)).to(device)
    q0 = torch.from_numpy(rng.standard_normal((B * H, 1, HD)) * 0.1).to(device, torch.bfloat16)
    gb = (B * H * TK * HD * 2) / 1e9
    print(f"# bh_tile={BH_TILE} {gb*1e3:.0f}MB/step backend={device.type}")
    for stage in STAGES:
        us = time_us(lambda: ablation_stage(q0, kt, v, stage, BH_TILE), device, ITERS)
        print(f"{stage:>5}: {us:7.1f}us  ({gb / (us / 1e6):.0f}GB/s)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
