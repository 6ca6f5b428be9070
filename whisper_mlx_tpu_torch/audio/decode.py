"""Host-side audio decode -> 16 kHz mono f32 PCM.

Counterpart of ``whisper_mlx_tpu/audio/decode.py``: WAV through the C++
reader (``native/``, built with ``g++`` at first use) or, where no ``g++``
exists, the NumPy RIFF/WAVE reader, with identical results; the scipy
polyphase resampler; other containers through an ``ffmpeg`` subprocess
when ``ffmpeg`` is on PATH. The serving loaders (:func:`load_audio_pcm16`,
:func:`load_audio_serving`) hand 16-bit mono 16 kHz files over as raw
``<i2`` samples, which the batcher converts on the device.
"""

from __future__ import annotations

import shutil
import struct
import subprocess
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
    """Minimal RIFF/WAVE parser: PCM 8/16/24/32-bit int and 32/64-bit float.
    The NumPy reader; ``native/audio.cc:wtpu_read_wav`` follows the same
    spec."""
    fmt, data = _parse_wav_chunks(path)
    return _decode_wav_data(path, fmt, data)


def _decode_wav_data(path: str | Path, fmt: tuple, data: bytes) -> tuple[np.ndarray, int]:
    """Decode already-parsed WAV chunks -> (mono f32, rate). Split from
    :func:`_read_wav` so that :func:`load_audio_serving` decodes the bytes
    of its one parse."""
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


def _pcm16_samples(fmt: tuple, data: bytes, sample_rate: int) -> np.ndarray | None:
    """The parsed chunk's raw ``<i2`` samples when it is 16-bit mono PCM at
    ``sample_rate``, else ``None`` (an odd data chunk is corrupt 16-bit PCM,
    left to the decoders' canonical error)."""
    audio_format, channels, rate, _byte_rate, _block_align, bits = fmt
    if ((audio_format, channels, bits) != (1, 1, 16) or rate != sample_rate
            or len(data) % 2):
        return None
    return np.frombuffer(data, dtype="<i2").copy()


def load_audio_pcm16(path: str | Path, sample_rate: int = SAMPLE_RATE) -> np.ndarray | None:
    """The mono ``<i2`` samples when ``path`` is a 16-bit mono PCM WAV at
    ``sample_rate`` (no host conversion needed), else ``None`` (callers fall
    back to :func:`load_audio`, which raises the canonical errors).

    The batcher uploads these at half the f32 bytes and converts on the
    device: int16 values and a division by 2^15 are exact in f32, so the
    result is bit-identical to the host conversion.
    """
    path = Path(path)
    if path.suffix.lower() not in (".wav", ".wave"):
        return None
    try:
        fmt, data = _parse_wav_chunks(path)
    except (ValueError, OSError):
        return None
    return _pcm16_samples(fmt, data, sample_rate)


def load_audio_serving(path: str | Path, sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """The serving loader: one file read a request.

    Raw ``<i2`` samples when the file is a 16-bit mono PCM WAV at
    ``sample_rate``, else f32 decoded from the same parsed bytes and
    resampled. Non-WAV containers and files that do not parse go to
    :func:`load_audio` for its ffmpeg path and canonical errors.
    """
    path = Path(path)
    if path.suffix.lower() not in (".wav", ".wave"):
        return load_audio(path, sample_rate)
    try:
        fmt, data = _parse_wav_chunks(path)
    except (ValueError, OSError):
        return load_audio(path, sample_rate)
    raw = _pcm16_samples(fmt, data, sample_rate)
    if raw is not None:
        return raw
    audio, rate = _decode_wav_data(path, fmt, data)
    return resample(audio, rate, sample_rate)


def resample(audio: np.ndarray, src_rate: int, dst_rate: int = SAMPLE_RATE) -> np.ndarray:
    """Polyphase resample to ``dst_rate`` (host CPU; scipy kaiser-windowed)."""
    if src_rate == dst_rate:
        return audio
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(src_rate, dst_rate)
    return resample_poly(audio, dst_rate // g, src_rate // g).astype(np.float32)


def _ffmpeg_decode(path: str | Path) -> np.ndarray:
    """Decode any container through ffmpeg -> 16 kHz mono f32 PCM."""
    cmd = [
        "ffmpeg", "-nostdin", "-threads", "0", "-i", str(path),
        "-f", "f32le", "-ac", "1", "-acodec", "pcm_f32le", "-ar", str(SAMPLE_RATE), "-",
    ]
    out = subprocess.run(cmd, capture_output=True, check=True).stdout
    return np.frombuffer(out, dtype=np.float32).copy()


def load_audio(path: str | Path, sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """Load an audio file -> mono f32 PCM at ``sample_rate``: WAV through
    the C++ reader (the NumPy one where no ``g++`` exists), other
    containers through ffmpeg, which must be on PATH."""
    from whisper_mlx_tpu_torch import native

    path = Path(path)
    if path.suffix.lower() in (".wav", ".wave"):
        lib = native.load()
        audio, rate = lib.read_wav(path) if lib is not None else _read_wav(path)
        return resample(audio, rate, sample_rate)
    if shutil.which("ffmpeg"):
        return _ffmpeg_decode(path)
    raise RuntimeError(
        f"cannot decode {path}: not a WAV file and ffmpeg is not installed"
    )
