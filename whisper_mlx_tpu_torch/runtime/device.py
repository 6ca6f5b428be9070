"""Device resolution and numeric settings for the port.

The reference computes its fp32 GEMMs at full precision (the mel at
``Precision.HIGHEST``), so on CUDA the port turns off the three settings
that would silently reduce precision:

- ``torch.backends.cuda.matmul.allow_tf32 = False`` (fp32 matmuls in fp32);
- ``torch.backends.cudnn.allow_tf32 = False`` (the conv stem's fp32 conv1d,
  which cuDNN otherwise runs in TF32 by default);
- ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction =
  False`` (bf16 GEMMs accumulate in fp32).

These are process-wide PyTorch settings.
"""

from __future__ import annotations

import torch


def setup_device(device: str | torch.device) -> torch.device:
    """Resolve ``device``; raise if it is CUDA and no GPU is present."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() "
                               "is false")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device
