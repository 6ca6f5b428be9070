"""Fused log-mel (kernel K1) and its plain PyTorch version.

``log_mel_frames`` maps frames ``(n_frames, 400)`` fp32, already framed
and reflect-padded, to the unclamped ``log10`` mel spectrogram
``(n_frames, n_mels)`` fp32. On a CUDA tensor it launches the hand-written
kernel in ``csrc/mel.cu``; on a CPU tensor it runs
:func:`log_mel_frames_plain`. The global ``max - 8`` clamp and the
``(x + 4) / 4`` scale stay with the caller (``audio/mel.py``).

Counterpart of ``whisper_mlx_tpu/ops/mel_pallas.py:log_mel_pallas``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from whisper_mlx_tpu_torch.audio.mel import N_FFT, N_FREQS, _dft_bases, mel_filterbank
from whisper_mlx_tpu_torch.ops import _build

LAUNCHES = 0
N_BINS_PAD = 208  # 201 rfft bins padded to a multiple of 16 with zero columns


@functools.lru_cache(maxsize=8)
def _padded_tables(n_mels: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """cos/sin bases ``(400, 208)`` and the transposed filterbank
    ``(208, n_mels)``; the padded bins carry zero weight."""
    w_real, w_imag = _dft_bases(N_FFT)
    cos_b = np.zeros((N_FFT, N_BINS_PAD), np.float32)
    sin_b = np.zeros((N_FFT, N_BINS_PAD), np.float32)
    cos_b[:, :N_FREQS] = w_real
    sin_b[:, :N_FREQS] = w_imag
    fb_t = np.zeros((N_BINS_PAD, n_mels), np.float32)
    fb_t[:N_FREQS] = mel_filterbank(n_mels).T
    return cos_b, sin_b, fb_t


@functools.lru_cache(maxsize=8)
def _device_tables(device: torch.device, n_mels: int) -> tuple[torch.Tensor, ...]:
    return tuple(torch.from_numpy(a).to(device) for a in _padded_tables(n_mels))


def log_mel_frames_plain(frames: torch.Tensor, n_mels: int) -> torch.Tensor:
    """Plain version: two DFT GEMMs, power, the filterbank GEMM, log10."""
    w_real, w_imag = (torch.from_numpy(a).to(frames.device) for a in _dft_bases(N_FFT))
    fb = torch.from_numpy(mel_filterbank(n_mels)).to(frames.device)
    re = frames @ w_real
    im = frames @ w_imag
    mel = (re * re + im * im) @ fb.T
    return torch.log10(torch.clamp_min(mel, 1e-10))


def log_mel_frames(frames: torch.Tensor, n_mels: int) -> torch.Tensor:
    """Unclamped log10 mel of framed audio; kernel K1 on CUDA tensors."""
    if frames.dtype != torch.float32 or frames.dim() != 2 or frames.shape[1] != N_FFT:
        raise ValueError(f"log_mel_frames: want (n, {N_FFT}) float32, got "
                         f"{tuple(frames.shape)} {frames.dtype}")
    if not frames.is_contiguous():
        raise ValueError("log_mel_frames: frames must be contiguous")
    if frames.device.type == "cpu":
        return log_mel_frames_plain(frames, n_mels)
    if frames.device.type != "cuda":
        raise ValueError(f"log_mel_frames: unsupported device {frames.device}")
    n_frames = frames.shape[0]
    cos_b, sin_b, fb_t = _device_tables(frames.device, n_mels)
    out = torch.empty((n_frames, n_mels), dtype=torch.float32, device=frames.device)
    if n_frames == 0:
        return out
    rc = _build.lib().wmt_log_mel(
        frames.data_ptr(), cos_b.data_ptr(), sin_b.data_ptr(), fb_t.data_ptr(),
        out.data_ptr(), n_frames, N_BINS_PAD, n_mels,
        torch.cuda.current_stream(frames.device).cuda_stream,
    )
    _build.check(rc, "wmt_log_mel")
    global LAUNCHES
    LAUNCHES += 1
    return out
