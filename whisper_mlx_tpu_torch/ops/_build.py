"""Build and bind the hand-written Hopper kernels in ``csrc/``.

The CUDA sources have a plain C interface (no PyTorch headers). Each one
is compiled by its own ``nvcc`` process, all started together, and one
more ``nvcc`` call links the objects into a shared library. The library
lands in ``build/kernels/`` at the repository root, named by a
hash of the sources and flags, and is built at first use: importing this
module builds nothing, so the package imports on machines without a GPU
or a CUDA toolkit.

Each exported C function takes raw device pointers, ints and the CUDA
stream, launches its kernel and returns ``cudaGetLastError()`` as an int.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of every exported launcher: (argtypes) -> int (cudaError_t)
SIGNATURES: dict[str, list] = {
    # frames, cos, sin, fbT, out, n_frames, n_bins, n_mels, stream
    "wmt_log_mel": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    # q, k, v, out, bh, tq, tk, stream
    "wmt_dense_attention": [_P, _P, _P, _P, _I, _I, _I, _P],
    # q, k, ks, v, vs, out, bq, h, tq, t_alloc, group, pos, causal,
    # valid_len, bits, stream
    "wmt_decode_attention": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _I, _I, _I, _I, _P],
    # x, w_q, scales, biases, out, m, n, k, bits, group_size, x_bf16, stream
    "wmt_quant_gemv": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # x, xg, w_q, scales, biases, out, m, n, k, bits, group_size, stream
    "wmt_quant_gemm": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # q, k, v, out, b, h, kv_heads, tq, tk, hd, causal, stream
    "wmt_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
BUILD_LOG: dict[str, object] = {}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: the Hopper kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libwmt_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` into the hashed library unless it exists: one
    ``nvcc -c`` per source in parallel, then one link."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in srcs]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)] for o, s in zip(objs, srcs)]
    cmds.append([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp),
                 *map(str, objs)])
    BUILD_LOG["cmd"], BUILD_LOG["stderr"] = cmds, ""
    try:
        for batch in (cmds[:-1], cmds[-1:]):  # every compile at once, then the link
            procs = [subprocess.Popen(c, stderr=subprocess.PIPE, text=True) for c in batch]
            errs = [p.communicate()[1] for p in procs]
            BUILD_LOG["stderr"] += "".join(errs)
            for cmd, proc, err in zip(batch, procs, errs):
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed ({proc.returncode}) on {cmd[-1]}:\n{err}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The kernel library, built on first call and bound with ctypes."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def check(rc: int, name: str) -> None:
    """Raise when a launcher returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
