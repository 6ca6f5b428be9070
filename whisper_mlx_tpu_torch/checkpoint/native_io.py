"""Native checkpoint IO for the port's parameter trees (whisper and Qwen).

Counterpart of ``whisper_mlx_tpu/checkpoint/native_io.py``: one flat
safetensors file with ``/``-joined tree paths; a QuantTensor leaf is stored
as three tensors and a ``[bits, group_size]`` tensor. The file holds the
port's layouts (linears ``(out, in)``, convs ``(out, in, k)``): it is the
port's own format and is not exchanged with the JAX package's native files,
whose fp linears are ``(in, out)``. bf16 leaves are written as bf16 and come
back as fp32 unless ``dtype`` says otherwise.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np
import torch

from whisper_mlx_tpu_torch.checkpoint.io_util import load_safetensors_file, save_safetensors_file
from whisper_mlx_tpu_torch.ops.quant import QuantTensor

_TAGS = ("__wq__", "__scales__", "__biases__", "__qmeta__")


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    out: dict[str, Any] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif isinstance(tree, QuantTensor):
        key = prefix.rstrip("/")
        out[f"{key}.__wq__"] = tree.w_q.detach().cpu().numpy().view(np.uint32)
        out[f"{key}.__scales__"] = tree.scales
        out[f"{key}.__biases__"] = tree.biases
        out[f"{key}.__qmeta__"] = np.asarray([tree.bits, tree.group_size], np.int32)
    else:
        out[prefix.rstrip("/")] = tree
    return out


def save_params(params: Any, path: str | Path) -> Path:
    """Write a tree of tensors and QuantTensors to one safetensors file."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    save_safetensors_file(path, _flatten(params))
    return path


def load_params(path: str | Path, dtype: torch.dtype | None = None,
                device: torch.device | str = "cpu") -> Any:
    """Rebuild the tree (dicts, lists, QuantTensors) from the file; float
    leaves are cast to ``dtype`` when given (QuantTensor affines never)."""
    flat = load_safetensors_file(path)
    quants: dict[str, dict[str, np.ndarray]] = {}
    leaves: dict[str, Any] = {}
    for key, val in flat.items():
        for tag in _TAGS:
            if key.endswith(f".{tag}"):
                quants.setdefault(key[: -len(tag) - 1], {})[tag] = val
                break
        else:
            t = torch.from_numpy(np.array(val)).to(device)
            leaves[key] = t.to(dtype) if dtype is not None and t.is_floating_point() else t
    for key, parts in quants.items():
        bits, group = map(int, parts["__qmeta__"])
        words = np.ascontiguousarray(parts["__wq__"].astype(np.uint32)).view(np.int32)
        leaves[key] = QuantTensor(
            torch.from_numpy(words).to(device),
            torch.from_numpy(np.array(parts["__scales__"], np.float32)).to(device),
            torch.from_numpy(np.array(parts["__biases__"], np.float32)).to(device), bits, group)

    root: dict[str, Any] = {}
    for key, val in leaves.items():
        node = root
        *parents, last = key.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = val

    def listify(node):
        if isinstance(node, dict):
            if node and all(k.isdigit() for k in node):
                return [listify(node[str(i)]) for i in range(len(node))]
            return {k: listify(v) for k, v in node.items()}
        return node

    return listify(root)
