"""Safetensors files read and written without the ``safetensors`` package.

Counterpart of ``whisper_mlx_tpu/checkpoint/io_util.py``, which goes
through ``safetensors``; the port reads and writes the format itself, so a
machine without that package loads and exports checkpoints too. The
format: an 8-byte little-endian header length, a JSON header mapping each
name to its ``dtype``, ``shape`` and ``data_offsets`` (relative to the end
of the header), then the raw little-endian bytes.

Results are the reference's values as numpy arrays in their stored dtype,
except bf16, which numpy lacks: it comes back as fp32 (the reference's
loaders cast every float to fp32 next, so the params are the same).
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np
import torch

_NUMPY = {"F64": np.float64, "F32": np.float32, "F16": np.float16, "I64": np.int64,
          "I32": np.int32, "I16": np.int16, "I8": np.int8, "U64": np.uint64,
          "U32": np.uint32, "U16": np.uint16, "U8": np.uint8, "BOOL": np.bool_}


_CODES = {np.dtype(v): k for k, v in _NUMPY.items()}


def save_safetensors_file(path: str | Path, tensors: dict) -> None:
    """Write numpy arrays or torch tensors (bf16 too, which numpy lacks) as
    one safetensors file, in the order given; the header is padded with
    spaces to a multiple of 8 bytes, as the format's own writer does."""
    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        if isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16:
            code, shape = "BF16", list(t.shape)
            raw = t.detach().cpu().contiguous().view(torch.int16).numpy().tobytes()
        else:
            arr = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
            if arr.dtype not in _CODES:
                raise ValueError(f"{path}: tensor {name} has unsupported dtype {arr.dtype}")
            code, shape = _CODES[arr.dtype], list(arr.shape)
            raw = np.ascontiguousarray(arr.astype(arr.dtype.newbyteorder("<"))).tobytes()
        header[name] = {"dtype": code, "shape": shape,
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)


def load_safetensors_dir(model_dir: str | Path) -> dict[str, np.ndarray]:
    """Merge all ``*.safetensors`` shards in a directory -> numpy dict."""
    model_dir = Path(model_dir)
    shards = sorted(model_dir.glob("*.safetensors"))
    if not shards:
        raise FileNotFoundError(f"no *.safetensors under {model_dir}")
    state: dict[str, np.ndarray] = {}
    for shard in shards:
        state.update(load_safetensors_file(shard))
    return state


def load_safetensors_file(path: str | Path) -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise ValueError(f"{path}: not a safetensors file")
        (n,) = struct.unpack("<Q", head)
        header = json.loads(f.read(n))
        header.pop("__metadata__", None)
        for name, meta in header.items():
            start, end = meta["data_offsets"]
            shape, dtype = meta["shape"], meta["dtype"]
            f.seek(8 + n + start)
            raw = bytearray(f.read(end - start))
            if len(raw) != end - start:
                raise ValueError(f"{path}: tensor {name} is truncated")
            if dtype == "BF16":
                t = torch.frombuffer(raw, dtype=torch.bfloat16) if raw else \
                    torch.zeros(0, dtype=torch.bfloat16)
                arr = t.float().numpy().reshape(shape)
            elif dtype in _NUMPY:
                arr = np.frombuffer(raw, dtype=np.dtype(_NUMPY[dtype]).newbyteorder("<"))
                arr = arr.reshape(shape)
            else:
                raise ValueError(f"{path}: tensor {name} has unsupported dtype {dtype}")
            out[name] = arr
    return out
