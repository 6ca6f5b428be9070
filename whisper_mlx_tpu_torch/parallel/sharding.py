"""Megatron sharding of whisper's parameter tree, and of the window batch.

Counterpart of ``whisper_mlx_tpu/parallel/sharding.py``. The specs are the
JAX package's, written against the logical weight ``(in, out)`` with the
axis names as plain tuples (``P(None, "tp")`` is ``(None, "tp")``):

- attention q/k/v: columns over "tp" (heads split), ``o``: rows (partial
  sums reduced over "tp", the bias added once); a fused quantized ``qkv``
  is replicated;
- MLP ``fc1`` columns, ``fc2`` rows;
- ``token_emb`` rows over "tp" (the vocabulary split: a masked lookup and
  a gather of the logits);
- LayerNorms, the conv stem and the positions: replicated.

The port's fp linear ``w`` is ``(out, in)`` (``F.linear``), so
:func:`port_spec` maps a logical spec onto it; that is the one place the
layouts meet. :func:`shard_params` returns this rank's local tree (a tree
with quantized leaves whole, as the JAX package replicates it), and
:func:`shard_model` the tree with the config the models need to run it:
a ``TPWhisperConfig`` carrying the mesh when the tree is tensor-parallel.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from whisper_mlx_tpu_torch.parallel.mesh import Mesh, local_shard

Params = dict[str, Any]
Spec = tuple


def _attn_spec(tp: str | None, blk: dict | None = None) -> dict[str, Any]:
    if blk is not None and "qkv" in blk:
        return {"qkv": {"w": (), "b": ()}, "o": {"w": (tp, None), "b": ()}}
    return {
        "q": {"w": (None, tp), "b": (tp,)},
        "k": {"w": (None, tp)},
        "v": {"w": (None, tp), "b": (tp,)},
        "o": {"w": (tp, None), "b": ()},
    }


def _mlp_spec(tp: str | None) -> dict[str, Any]:
    return {"fc1": {"w": (None, tp), "b": (tp,)}, "fc2": {"w": (tp, None), "b": ()}}


_LN = {"g": (), "b": ()}


def whisper_param_specs(params: Params, tp: str | None = "tp") -> Params:
    """Spec tree matching ``params``' structure, in the JAX package's
    logical orientation."""

    def enc_block(b):
        return {"attn_ln": _LN, "attn": _attn_spec(tp, b["attn"]),
                "mlp_ln": _LN, "mlp": _mlp_spec(tp)}

    def dec_block(b):
        return {"attn_ln": _LN, "attn": _attn_spec(tp, b["attn"]),
                "cross_attn_ln": _LN, "cross_attn": _attn_spec(tp, b["cross_attn"]),
                "mlp_ln": _LN, "mlp": _mlp_spec(tp)}

    return {
        "encoder": {
            "conv1": {"w": (), "b": ()},
            "conv2": {"w": (), "b": ()},
            "pos_emb": (),
            "blocks": [enc_block(b) for b in params["encoder"]["blocks"]],
            "ln_post": _LN,
        },
        "decoder": {
            "token_emb": (tp, None),
            "pos_emb": (),
            "blocks": [dec_block(b) for b in params["decoder"]["blocks"]],
            "ln": _LN,
        },
    }


def port_spec(key: str, leaf: torch.Tensor, spec: Spec) -> Spec:
    """A logical spec on the port's layout: an fp linear's ``w`` is stored
    ``(out, in)``, the transpose of the logical ``(in, out)``; every other
    leaf (embeddings, biases, norms, the packed MLX leaves) is stored as
    the JAX package stores it."""
    if key == "w" and leaf.dim() == 2 and spec:
        return tuple(reversed(spec))
    return spec


def _has_quant_leaves(node: Any) -> bool:
    """Whether any leaf is not a plain tensor (``QuantTensor`` and its kin)."""
    if isinstance(node, dict):
        return any(_has_quant_leaves(v) for v in node.values())
    if isinstance(node, list):
        return any(_has_quant_leaves(v) for v in node)
    return node is not None and not isinstance(node, torch.Tensor)


def _apply(params: Any, specs: Any, mesh: Mesh, key: str = "") -> Any:
    if isinstance(params, dict):
        return {k: _apply(v, specs[k], mesh, k) for k, v in params.items()}
    if isinstance(params, list):
        return [_apply(v, s, mesh) for v, s in zip(params, specs)]
    return local_shard(params, port_spec(key, params, specs), mesh)


def shard_params(params: Params, mesh: Mesh, tp: str | None = "tp") -> Params:
    """This rank's local tree under the Megatron specs. Trees with quantized
    leaves are replicated: packed groups are not split, as in the JAX
    package (whisper fits one card; the mesh buys DP over windows)."""
    if _has_quant_leaves(params):
        return params  # whole on every rank (it already lives on this rank's device)
    use_tp = tp if tp in mesh.axis_names and mesh.size(tp) > 1 else None
    return _apply(params, whisper_param_specs(params, tp=use_tp), mesh)


def with_mesh(config: Any, cls: type, mesh: Mesh) -> Any:
    """``config`` as ``cls`` (its subclass with a ``mesh`` field) carrying
    ``mesh``."""
    fields = {f.name: getattr(config, f.name) for f in dataclasses.fields(config)}
    return cls(**{**fields, "mesh": mesh})


def shard_model(params: Params, config: Any, mesh: Mesh | None) -> tuple[Params, Any]:
    """(params, config) -> this rank's (local tree, config): a
    ``TPWhisperConfig`` carrying the mesh when the tree came out
    tensor-parallel (an fp tree and tp > 1), which is what tells the models
    to reduce and gather over "tp"."""
    from whisper_mlx_tpu_torch.models.whisper import TPWhisperConfig

    if mesh is None:
        return params, config
    local = shard_params(params, mesh)
    if mesh.tp > 1 and local is not params:
        config = with_mesh(config, TPWhisperConfig, mesh)
    return local, config


def shard_batch(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """This rank's contiguous slice of a batch-leading tensor over "dp"."""
    if mesh is None or mesh.dp == 1:
        return x
    if x.shape[0] % mesh.dp:
        raise ValueError(f"shard_batch: batch {x.shape[0]} does not divide over dp={mesh.dp}")
    n = x.shape[0] // mesh.dp
    return x[mesh.index("dp") * n:(mesh.index("dp") + 1) * n]


def dp_round(n: int, mesh: Mesh | None) -> int:
    """``n`` rounded up to a multiple of the mesh's dp width."""
    dp = mesh.dp if mesh is not None else 1
    return -(-n // dp) * dp
