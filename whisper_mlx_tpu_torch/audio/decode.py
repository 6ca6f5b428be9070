"""Host-side WAV decode -> 16 kHz mono f32 PCM.

Copied from ``whisper_mlx_tpu/audio/decode.py``: the NumPy RIFF/WAVE
reader and the scipy polyphase resampler. The C++ reader (``native/``)
and the ffmpeg path for other containers are not ported (ROADMAP.md M7).
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

SAMPLE_RATE = 16_000


def _parse_wav_chunks(path: str | Path) -> tuple[tuple, bytes]:
    """RIFF walk: returns the unpacked ``fmt `` tuple and the ``data``
    chunk bytes."""
    raw = Path(path).read_bytes()
    if raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    data = None
    while pos + 8 <= len(raw):
        chunk_id = raw[pos : pos + 4]
        (size,) = struct.unpack_from("<I", raw, pos + 4)
        body = raw[pos + 8 : pos + 8 + size]
        if chunk_id == b"fmt ":
            try:
                fmt = struct.unpack_from("<HHIIHH", body, 0)
            except struct.error as e:  # truncated fmt chunk
                raise ValueError(f"{path}: corrupt WAV fmt chunk ({e})") from e
        elif chunk_id == b"data":
            data = body
        pos += 8 + size + (size & 1)  # chunks are word-aligned
    if fmt is None or data is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    return fmt, data


def _read_wav(path: str | Path) -> tuple[np.ndarray, int]:
    """Minimal RIFF/WAVE parser: PCM 8/16/24/32-bit int and 32/64-bit float."""
    fmt, data = _parse_wav_chunks(path)
    return _decode_wav_data(path, fmt, data)


def _decode_wav_data(path: str | Path, fmt: tuple, data: bytes) -> tuple[np.ndarray, int]:
    """Decode already-parsed WAV chunks -> (mono f32, rate)."""
    audio_format, channels, rate, _byte_rate, _block_align, bits = fmt
    if bits >= 8 and len(data) % (bits // 8):
        raise ValueError(f"{path}: data chunk is not a whole number of "
                         f"{bits}-bit samples (corrupt/truncated WAV)")
    if audio_format == 1:  # PCM int
        if bits == 8:
            x = (np.frombuffer(data, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 16:
            x = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            b = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
            x = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            x = (x - ((x & 0x800000) << 1)).astype(np.float32) / 8388608.0
        elif bits == 32:
            x = np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    elif audio_format == 3:  # IEEE float
        x = np.frombuffer(data, dtype="<f4" if bits == 32 else "<f8").astype(np.float32)
    else:
        raise ValueError(f"{path}: unsupported WAV format code {audio_format}")
    if channels > 1:
        x = x[: (len(x) // channels) * channels].reshape(-1, channels).mean(axis=1)
    return np.ascontiguousarray(x, dtype=np.float32), rate


def resample(audio: np.ndarray, src_rate: int, dst_rate: int = SAMPLE_RATE) -> np.ndarray:
    """Polyphase resample to ``dst_rate`` (host CPU; scipy kaiser-windowed)."""
    if src_rate == dst_rate:
        return audio
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(src_rate, dst_rate)
    return resample_poly(audio, dst_rate // g, src_rate // g).astype(np.float32)


def load_audio(path: str | Path, sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """Load a WAV file -> mono f32 PCM at ``sample_rate``."""
    path = Path(path)
    if path.suffix.lower() not in (".wav", ".wave"):
        raise RuntimeError(f"cannot decode {path}: only WAV is supported by this "
                           "package (other containers: ROADMAP.md M7)")
    audio, rate = _read_wav(path)
    return resample(audio, rate, sample_rate)
