"""Megatron sharding of the Qwen parameter tree.

Counterpart of ``whisper_mlx_tpu/parallel/sharding_llm.py``; the specs are
the JAX package's, against the logical weight ``(in, out)``:

- q/k/v, gate/up: columns over "tp" (heads split, ``hd`` whole);
- o, down: rows (partials summed over "tp");
- ``embed`` rows (the vocabulary), ``lm_head`` columns;
- RMSNorm gains and the per-head q/k norms replicated.

A ``QuantTensor`` is MLX's ``(out, in)`` in both packages: a column split is
a dim-0 split of ``w_q``, scales and biases; a row split splits the packed
words along dim 1. The JAX package keeps the scales and biases of a row
split replicated (its global array computes with them); here each rank
takes those of its own groups, and a leaf whose ``K / tp`` is not a
multiple of the group size or of a word's codes stays whole on every rank
(the model then gathers x over "tp" before it, and adds no reduction).

The fused ``qkv`` and ``gate_up`` of a packed checkpoint (``ops/quant.py:
fuse_qwen_projections``) are split part by part and fused again, so that a
rank runs one product a fused linear. The residency forms (``QuantTensorT``,
``A8Tensor``, ``NativeQuantTensor``, ``DenseWeight``) are not sharded, as in
the JAX package: they are refused by name.
"""

from __future__ import annotations

from typing import Any

import torch

from whisper_mlx_tpu_torch.ops.quant import QuantTensor
from whisper_mlx_tpu_torch.parallel.mesh import Mesh, local_shard, local_slice
from whisper_mlx_tpu_torch.parallel.sharding import port_spec, with_mesh

Params = dict[str, Any]


def _dense_spec(split: str, tp) -> dict:
    if split == "col":
        return {"w": (None, tp), "b": (tp,)}
    return {"w": (tp, None), "b": ()}


def _quant_spec(split: str, tp) -> dict:
    # the JAX package's: a row split shards only the packed words
    if split == "col":
        return {"w_q": (tp, None), "scales": (tp, None), "biases": (tp, None)}
    return {"w_q": (None, tp), "scales": (), "biases": ()}


def _check_leaf(w: Any, where: str) -> None:
    if not isinstance(w, (torch.Tensor, QuantTensor)):
        raise TypeError(f"qwen sharding: {where} is a {type(w).__name__}; only fp and "
                        "QuantTensor trees are sharded (not the residency forms)")


def _leaf_spec(node: dict, split: str, tp, where: str) -> dict:
    _check_leaf(node["w"], where)
    if isinstance(node["w"], QuantTensor):
        spec = {"w": _quant_spec(split, tp)}
    else:
        spec = {"w": _dense_spec(split, tp)["w"]}
    if "b" in node:
        spec["b"] = _dense_spec(split, tp)["b"]
    return spec


def qwen_param_specs(params: Params, tp: str | None = "tp") -> Params:
    """Spec tree matching an unfused Qwen tree, in the JAX package's logical
    orientation; a ``QuantTensor``'s spec is ``{"w_q", "scales", "biases"}``."""

    def layer(i, blk):
        attn = {n: _leaf_spec(blk["attn"][n], "col", tp, f"layers.{i}.attn.{n}")
                for n in ("q", "k", "v")}
        attn["o"] = _leaf_spec(blk["attn"]["o"], "row", tp, f"layers.{i}.attn.o")
        if "q_norm" in blk["attn"]:
            attn["q_norm"] = ()
            attn["k_norm"] = ()
        mlp = {n: _leaf_spec(blk["mlp"][n], "col", tp, f"layers.{i}.mlp.{n}")
               for n in ("gate", "up")}
        mlp["down"] = _leaf_spec(blk["mlp"]["down"], "row", tp, f"layers.{i}.mlp.down")
        return {"input_ln": (), "attn": attn, "post_ln": (), "mlp": mlp}

    _check_leaf(params["embed"], "embed")
    specs = {
        "embed": (_quant_spec("col", tp) if isinstance(params["embed"], QuantTensor)
                  else (tp, None)),
        "layers": [layer(i, b) for i, b in enumerate(params["layers"])],
        "final_ln": (),
    }
    if "lm_head" in params:
        specs["lm_head"] = _leaf_spec(params["lm_head"], "col", tp, "lm_head")
    return specs


def _shard_quant(q: QuantTensor, spec: dict, mesh: Mesh, tp: str | None) -> QuantTensor:
    if tp is None or spec["w_q"][0] == tp:  # columns: every child's dim 0
        return QuantTensor(local_shard(q.w_q, spec["w_q"], mesh),
                           local_shard(q.scales, spec["scales"], mesh),
                           local_shard(q.biases, spec["biases"], mesh), q.bits, q.group_size)
    # rows: the words of this rank's K slice, and the affines of its groups
    k = q.shape[1]
    parts, index = mesh.size(tp), mesh.index(tp)
    per_word = 32 // q.bits
    if k % parts or (k // parts) % q.group_size or (k // parts) % per_word:
        return q  # whole on every rank
    words = local_slice(q.w_q.shape[1], parts, index)
    groups = local_slice(q.scales.shape[1], parts, index)
    return QuantTensor(q.w_q[:, words].contiguous(), q.scales[:, groups].contiguous(),
                       q.biases[:, groups].contiguous(), q.bits, q.group_size)


def _shard_node(node: Any, spec: Any, mesh: Mesh, tp: str | None, key: str = "") -> Any:
    if isinstance(node, dict):
        return {k: _shard_node(v, spec[k], mesh, tp, k) for k, v in node.items()}
    if isinstance(node, list):
        return [_shard_node(v, s, mesh, tp) for v, s in zip(node, spec)]
    if isinstance(node, QuantTensor):
        return _shard_quant(node, spec, mesh, tp)
    return local_shard(node, port_spec(key, node, spec), mesh)


def _split_rows(w: Any, sizes: list[int]) -> list:
    """A fused linear's leaf (``(out, in)`` tensor, ``QuantTensor`` or bias)
    cut along ``out`` into its parts."""
    if isinstance(w, QuantTensor):
        return [QuantTensor(a, s, b, w.bits, w.group_size) for a, s, b in
                zip(w.w_q.split(sizes), w.scales.split(sizes), w.biases.split(sizes))]
    return list(w.split(sizes))


def _cat_rows(parts: list) -> Any:
    if isinstance(parts[0], QuantTensor):
        return QuantTensor(*(torch.cat([getattr(p, n) for p in parts]).contiguous()
                             for n in ("w_q", "scales", "biases")),
                           parts[0].bits, parts[0].group_size)
    return torch.cat(parts).contiguous()


def _shard_fused(node: dict, sizes: list[int], mesh: Mesh, tp: str | None) -> dict:
    """Column-shard each part of a fused linear, then fuse the local parts."""
    out = {}
    for key, leaf in node.items():
        parts = _split_rows(leaf, sizes)
        if key == "w":
            spec = _leaf_spec({"w": leaf}, "col", tp, "fused")["w"]
            local = [_shard_node(p, spec, mesh, tp, "w") for p in parts]
        else:
            local = [local_shard(p, (tp,), mesh) for p in parts]
        out[key] = _cat_rows(local)
    return out


def shard_qwen_params(params: Params, mesh: Mesh, tp: str | None = "tp",
                      config: Any = None) -> Params:
    """This rank's local Qwen tree. A fused ``qkv`` needs ``config`` (its
    parts' widths)."""
    tp = tp if tp in mesh.axis_names and mesh.size(tp) > 1 else None
    layers = params["layers"]
    fused = [("qkv" in b["attn"], "gate_up" in b["mlp"]) for b in layers]
    plain = dict(params, layers=[_unfused_view(b) for b in layers])
    specs = qwen_param_specs(plain, tp=tp)
    out = {k: _shard_node(v, specs[k], mesh, tp, k) for k, v in params.items()
           if k != "layers"}
    out["layers"] = []
    for blk, spec, (qkv, gate_up) in zip(layers, specs["layers"], fused):
        local = {k: _shard_node(v, spec[k], mesh, tp, k) for k, v in blk.items()
                 if k not in ("attn", "mlp")}
        attn = {k: v for k, v in blk["attn"].items() if k != "qkv"}
        local["attn"] = {k: _shard_node(v, spec["attn"][k], mesh, tp, k)
                         for k, v in attn.items()}
        if qkv:
            if config is None:
                raise ValueError("shard_qwen_params: a fused qkv needs config")
            hd = config.hd
            sizes = [config.num_attention_heads * hd, config.num_key_value_heads * hd,
                     config.num_key_value_heads * hd]
            local["attn"]["qkv"] = _shard_fused(blk["attn"]["qkv"], sizes, mesh, tp)
        mlp = {k: v for k, v in blk["mlp"].items() if k != "gate_up"}
        local["mlp"] = {k: _shard_node(v, spec["mlp"][k], mesh, tp, k)
                        for k, v in mlp.items()}
        if gate_up:
            w = blk["mlp"]["gate_up"]["w"]
            half = w.shape[0] // 2
            local["mlp"]["gate_up"] = _shard_fused(blk["mlp"]["gate_up"], [half, half],
                                                   mesh, tp)
        out["layers"].append(local)
    return out


def _unfused_view(blk: dict) -> dict:
    """A block whose fused linears stand as their first part, so that the
    spec builder sees q/k/v and gate/up (the fused nodes are sharded by
    :func:`_shard_fused`)."""
    attn, mlp = dict(blk["attn"]), dict(blk["mlp"])
    if "qkv" in attn:
        for n in ("q", "k", "v"):
            attn[n] = attn["qkv"]
    if "gate_up" in mlp:
        mlp["gate"] = mlp["up"] = mlp["gate_up"]
    return dict(blk, attn=attn, mlp=mlp)


def shard_qwen_model(params: Params, config: Any, mesh: Mesh | None
                     ) -> tuple[Params, Any]:
    """(params, config) -> this rank's (local tree, config): a
    ``TPQwenConfig`` carrying the mesh when tp > 1."""
    from whisper_mlx_tpu_torch.models.qwen import TPQwenConfig

    if mesh is None or mesh.tp == 1:
        return params, config
    return (shard_qwen_params(params, mesh, config=config),
            with_mesh(config, TPQwenConfig, mesh))
