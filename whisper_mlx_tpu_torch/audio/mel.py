"""Log-mel spectrogram frontend, Whisper-exact, in PyTorch.

Counterpart of ``whisper_mlx_tpu/audio/mel.py``. The STFT is a GEMM-native
DFT: Hann-windowed real/imaginary bases ``(400, 201)``, power, a Slaney
mel filterbank, ``log10(max(., 1e-10))``, a clamp to ``max - 8`` and
``(x + 4) / 4``. The filterbank and bases are numpy, copied verbatim so
both packages build bit-identical tables.

Framing (reflect pad of 200 on both sides, hop 160, last frame dropped)
is plain torch; the GEMMs and the log run in kernel K1
(``ops/mel_kernel.py``) on a CUDA tensor and in its plain version on a CPU
tensor. Products are fp32 throughout: the reference runs them at
``Precision.HIGHEST`` because the mel feeds token selection, so the
device setup turns TF32 off (``runtime/device.py``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16_000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH = 30  # seconds per window (reference seek-window size)
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE  # 480_000 samples per 30 s window
N_FRAMES = N_SAMPLES // HOP_LENGTH  # 3000 mel frames per window
N_FREQS = N_FFT // 2 + 1  # 201 rfft bins
FRAMES_PER_SECOND = SAMPLE_RATE // HOP_LENGTH  # 100
SAMPLES_PER_TOKEN = HOP_LENGTH * 2  # one decoder timestamp token = 20 ms
TOKENS_PER_SECOND = SAMPLE_RATE // SAMPLES_PER_TOKEN  # 50


def _hertz_to_mel_slaney(freq: np.ndarray) -> np.ndarray:
    """Slaney mel scale: linear below 1 kHz, logarithmic above."""
    freq = np.asarray(freq, dtype=np.float64)
    min_log_hertz = 1000.0
    min_log_mel = 15.0
    logstep = 27.0 / np.log(6.4)
    mels = 3.0 * freq / 200.0
    log_region = freq >= min_log_hertz
    mels = np.where(
        log_region,
        min_log_mel + np.log(np.maximum(freq, min_log_hertz) / min_log_hertz) * logstep,
        mels,
    )
    return mels


def _mel_to_hertz_slaney(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    min_log_hertz = 1000.0
    min_log_mel = 15.0
    logstep = np.log(6.4) / 27.0
    freq = 200.0 * mels / 3.0
    log_region = mels >= min_log_mel
    freq = np.where(log_region, min_log_hertz * np.exp(logstep * (mels - min_log_mel)), freq)
    return freq


@functools.lru_cache(maxsize=8)
def mel_filterbank(
    n_mels: int = 80,
    n_fft: int = N_FFT,
    sample_rate: int = SAMPLE_RATE,
) -> np.ndarray:
    """Slaney-scale, Slaney-normalized triangular mel filterbank.

    Returns float32 ``(n_mels, n_fft // 2 + 1)``, identical to
    ``librosa.filters.mel(sr=16000, n_fft=400, n_mels=n_mels)`` (80 bands
    for tiny..large-v2, 128 for large-v3).
    """
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)

    mel_min = _hertz_to_mel_slaney(np.array(0.0))
    mel_max = _hertz_to_mel_slaney(np.array(sample_rate / 2.0))
    mel_pts = np.linspace(mel_min, mel_max, n_mels + 2)
    hz_pts = _mel_to_hertz_slaney(mel_pts)

    # Triangular filters between successive center frequencies.
    fdiff = np.diff(hz_pts)  # (n_mels + 1,)
    ramps = hz_pts[:, None] - fft_freqs[None, :]  # (n_mels + 2, n_freqs)
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    fb = np.maximum(0.0, np.minimum(lower, upper))  # (n_mels, n_freqs)

    # Slaney normalization: each filter integrates to ~1 over Hz.
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    fb *= enorm[:, None]
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=4)
def _dft_bases(n_fft: int = N_FFT) -> tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT bases: ``(n_fft, n_freqs)`` cos / -sin matrices.

    The periodic Hann window is folded into the bases, so framing needs no
    separate multiply.
    """
    window = np.hanning(n_fft + 1)[:-1]  # periodic Hann, matches torch.hann_window
    n = np.arange(n_fft)[:, None]  # (n_fft, 1)
    k = np.arange(n_fft // 2 + 1)[None, :]  # (1, n_freqs)
    angle = 2.0 * np.pi * n * k / n_fft
    w_real = (np.cos(angle) * window[:, None]).astype(np.float32)
    w_imag = (-np.sin(angle) * window[:, None]).astype(np.float32)
    return w_real, w_imag


def _frame_signal(audio: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Reflect-pad by n_fft//2 and slice into overlapping ``(frames, n_fft)``
    rows, as ``torch.stft(center=True, pad_mode="reflect")`` does. The caller
    drops the last frame (Whisper discards it)."""
    pad = n_fft // 2
    padded = F.pad(audio[None, None], (pad, pad), mode="reflect")[0, 0]
    return padded.unfold(0, n_fft, hop)


def stft_power(audio: torch.Tensor, n_fft: int = N_FFT, hop: int = HOP_LENGTH) -> torch.Tensor:
    """Power spectrogram ``(num_frames, n_freqs)`` via the GEMM-native DFT."""
    w_real, w_imag = (torch.from_numpy(a).to(audio.device) for a in _dft_bases(n_fft))
    frames = _frame_signal(audio.float(), n_fft, hop)[:-1]
    re = frames @ w_real
    im = frames @ w_imag
    return re * re + im * im


def log_mel_spectrogram(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """Whisper log-mel spectrogram ``(num_frames, n_mels)`` fp32 on
    ``audio``'s device; ``audio`` is 1-D f32 PCM at 16 kHz."""
    from whisper_mlx_tpu_torch.ops.mel_kernel import log_mel_frames

    frames = _frame_signal(audio.float(), N_FFT, HOP_LENGTH)[:-1].contiguous()
    log_spec = log_mel_frames(frames, n_mels)
    log_spec = torch.maximum(log_spec, log_spec.max() - 8.0)
    return (log_spec + 4.0) / 4.0


def pad_or_trim(audio: torch.Tensor, length: int = N_SAMPLES) -> torch.Tensor:
    """Pad with zeros or trim to exactly ``length`` samples."""
    if audio.shape[-1] > length:
        return audio[..., :length]
    if audio.shape[-1] < length:
        return F.pad(audio, (0, length - audio.shape[-1]))
    return audio
