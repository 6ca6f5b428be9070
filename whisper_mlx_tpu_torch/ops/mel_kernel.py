"""Fused log-mel (kernel K1) and its plain PyTorch version.

``log_mel_frames`` maps frames ``(n_frames, 400)`` fp32, already framed
and reflect-padded, to the unclamped ``log10`` mel spectrogram
``(n_frames, n_mels)`` fp32. On a CUDA tensor it launches the hand-written
kernel in ``csrc/mel.cu`` (clusters of blocks along the bins of a frame
tile, as :func:`mel_plan` says); on a CPU tensor it runs
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
# csrc/mel.cu's launch: a cluster of CLUSTER blocks takes FRAMES frames,
# block r of it the bins [r * BINS_A_BLOCK, (r + 1) * BINS_A_BLOCK) and
# then its share of the mels
CLUSTER = 4
BINS_A_BLOCK = N_BINS_PAD // CLUSTER
FRAMES = 32


@functools.lru_cache(maxsize=8)
def _padded_tables(n_mels: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The kernel's tables: the bases ``(CLUSTER, 400, 2 * BINS_A_BLOCK)``,
    block r's bins ``[r * BINS_A_BLOCK, (r + 1) * BINS_A_BLOCK)`` with each
    bin's cosine and sine side by side (column 2j, 2j + 1 for bin r *
    BINS_A_BLOCK + j), contiguous for the block; the transposed filterbank
    ``(208, n_mels)`` (the padded bins carry zero weight); and each mel's
    nonzero bins ``[lo, hi)`` ``(n_mels, 2)`` int32."""
    w_real, w_imag = _dft_bases(N_FFT)
    basis = np.zeros((N_FFT, 2 * N_BINS_PAD), np.float32)
    basis[:, 0:2 * N_FREQS:2] = w_real
    basis[:, 1:2 * N_FREQS:2] = w_imag
    blocks = np.ascontiguousarray(
        basis.reshape(N_FFT, CLUSTER, 2 * BINS_A_BLOCK).transpose(1, 0, 2))
    fb_t = np.zeros((N_BINS_PAD, n_mels), np.float32)
    fb_t[:N_FREQS] = mel_filterbank(n_mels).T
    return blocks, fb_t, mel_ranges(fb_t)


def mel_ranges(fb_t: np.ndarray) -> np.ndarray:
    """Each mel's ``[lo, hi)``: its first and one past its last nonzero
    filterbank bin (``[0, 0)`` for an empty filter), ``(n_mels, 2)`` int32.
    Summing only these bins in bin order gives the dense loop's sum bit for
    bit on finite inputs: the terms left out are products with +0."""
    out = np.zeros((fb_t.shape[1], 2), np.int32)
    for mel in range(fb_t.shape[1]):
        nz = np.flatnonzero(fb_t[:, mel])
        if nz.size:
            out[mel] = (nz[0], nz[-1] + 1)
    return out


def mel_plan(n_frames: int, n_mels: int) -> dict:
    """csrc/mel.cu's grid for ``n_frames``: ``clusters`` clusters of
    ``CLUSTER`` blocks, cluster c taking frames ``[FRAMES * c, FRAMES * (c +
    1))`` (those past ``n_frames`` zero and not stored), block r of it the
    bins ``[r * BINS_A_BLOCK, (r + 1) * BINS_A_BLOCK)`` of those frames and
    the mels ``[r * mels, (r + 1) * mels)`` (those past ``n_mels`` idle)."""
    return dict(clusters=-(-n_frames // FRAMES), blocks=CLUSTER, frames=FRAMES,
                bins=BINS_A_BLOCK, mels=-(-n_mels // CLUSTER))


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
    basis, fb_t, ranges = _device_tables(frames.device, n_mels)
    out = torch.empty((n_frames, n_mels), dtype=torch.float32, device=frames.device)
    if n_frames == 0:
        return out
    if frames.data_ptr() % 16:  # the kernel copies frames 16 bytes at a time
        frames = frames.clone()
    rc = _build.lib().wmt_log_mel(
        frames.data_ptr(), basis.data_ptr(), fb_t.data_ptr(), ranges.data_ptr(),
        out.data_ptr(), n_frames, N_BINS_PAD, n_mels,
        torch.cuda.current_stream(frames.device).cuda_stream,
    )
    _build.check(rc, "wmt_log_mel")
    global LAUNCHES
    LAUNCHES += 1
    return out
