"""Host-side C++ helpers (WAV reader, DTW), bound with ctypes.

Counterpart of ``whisper_mlx_tpu/native``: ``audio.cc`` is a copy of its
source less the resampler (``audio/decode.py:resample`` is scipy's, as the
reference's is). These are host code around the device path, not device kernels.
:func:`load` builds the library with ``g++`` at first use into
``build/native/`` at the repository root, named by a hash of the source and
flags; importing this module builds nothing. Where no ``g++`` exists,
:func:`load` returns ``None`` and the callers (``audio/decode.py:load_audio``,
``inference/word_timestamps.py:dtw``) take their NumPy paths, which give
identical results, as the reference does when its library is not built.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "audio.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
# no -march=native (the reference's flag): the library is found again by
# the hash of its source and flags, and a checkout's build/ may move to
# another machine
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]


class NativeLib:
    """ctypes binding of the library's C functions."""

    def __init__(self, so_path: Path):
        self._dll = ctypes.CDLL(str(so_path))
        self._dll.wtpu_read_wav.restype = ctypes.c_int
        self._dll.wtpu_read_wav.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_int),
        ]
        self._dll.wtpu_free.restype = None
        self._dll.wtpu_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        self._dll.wtpu_dtw.restype = ctypes.c_longlong
        self._dll.wtpu_dtw.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_longlong,
            ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]

    def dtw(self, cost: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Monotone min-cost alignment path (the contract of
        ``inference.word_timestamps.dtw``)."""
        cost = np.ascontiguousarray(cost, np.float32)
        n, m = cost.shape
        out_text = (ctypes.c_int * (n + m))()
        out_time = (ctypes.c_int * (n + m))()
        length = self._dll.wtpu_dtw(
            cost.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n, m, out_text, out_time,
        )
        if length < 0:
            raise ValueError("wtpu_dtw failed")
        return (np.ctypeslib.as_array(out_text)[:length].copy(),
                np.ctypeslib.as_array(out_time)[:length].copy())

    def read_wav(self, path) -> tuple[np.ndarray, int]:
        """-> (mono f32 samples, sample rate); raises ValueError naming the
        file when it is not a WAV the reader takes."""
        buf = ctypes.POINTER(ctypes.c_float)()
        n = ctypes.c_longlong()
        rate = ctypes.c_int()
        rc = self._dll.wtpu_read_wav(str(path).encode(), ctypes.byref(buf), ctypes.byref(n),
                                     ctypes.byref(rate))
        if rc != 0:
            raise ValueError(f"native WAV decode failed for {path} (code {rc})")
        try:
            out = np.ctypeslib.as_array(buf, shape=(n.value,)).copy()
        finally:
            self._dll.wtpu_free(buf)
        return out, rate.value


_lock = threading.Lock()
_lib: NativeLib | None = None
_loaded = False


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libwmt_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``audio.cc`` with ``g++`` into the hashed library unless it
    exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}) on {SRC}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> NativeLib | None:
    """The library, built on first call; ``None`` where no ``g++`` exists."""
    global _lib, _loaded
    with _lock:
        if not _loaded:
            if shutil.which("g++") is not None or library_path().exists():
                _lib = NativeLib(build())
            _loaded = True
    return _lib
