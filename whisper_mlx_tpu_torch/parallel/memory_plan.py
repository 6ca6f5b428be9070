"""Per-device memory of a sharded Qwen, planned without allocating it.

Counterpart of ``whisper_mlx_tpu/parallel/memory_plan.py``, with the same
arithmetic: the parameter tree is built from ``torch.empty(...,
device="meta")`` tensors (no bytes behind them), each leaf's bytes are
divided by the ways its spec (``parallel/sharding_llm.py``) splits it, and
the KV cache of the serving shape is added: layers x 2 x batch x KV heads
x positions x (hd x bytes a code, + 2 bytes of bf16 scale a position when
quantized). KV heads are counted whole, as the JAX package counts them.

The budget is the card's: ``torch.cuda.get_device_properties(d)
.total_memory`` when the call names a CUDA device, else the caller's
``budget_bytes`` (required). The JAX package's default, 16 GiB, is a TPU
v5e chip's and is not the port's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import torch

from whisper_mlx_tpu_torch.ops.quant import QuantTensor


def _leaf_bytes(leaf: torch.Tensor) -> int:
    return math.prod(leaf.shape) * leaf.element_size()


def _shard_factor(spec: tuple, axis_sizes: Mapping[str, int]) -> int:
    factor = 1
    for entry in spec:
        if entry is None:
            continue
        for name in entry if isinstance(entry, tuple) else (entry,):
            factor *= axis_sizes.get(name, 1)
    return factor


@dataclasses.dataclass(frozen=True)
class MemoryPlan:
    total_bytes: int  # unsharded param bytes
    per_device_bytes: int  # largest per-device param residency
    kv_cache_bytes: int  # per-device KV cache for the requested serving shape
    headroom_bytes: int  # budget - (params + kv)

    @property
    def per_device_gib(self) -> float:
        return self.per_device_bytes / 2**30

    @property
    def fits(self) -> bool:
        return self.headroom_bytes > 0


def _pairs(params: Any, specs: Any):
    """(leaf, spec) pairs of a tree and its spec tree (a ``QuantTensor``'s
    spec is ``{"w_q", "scales", "biases"}``)."""
    if isinstance(params, dict):
        for k, v in params.items():
            yield from _pairs(v, specs[k])
    elif isinstance(params, list):
        for v, s in zip(params, specs):
            yield from _pairs(v, s)
    elif isinstance(params, QuantTensor):
        for name in ("w_q", "scales", "biases"):
            yield getattr(params, name), specs[name]
    else:
        yield params, specs


def plan_param_memory(abstract_params: Any, specs: Any,
                      axis_sizes: Mapping[str, int]) -> tuple[int, int]:
    """-> (total_bytes, per_device_bytes) of a param tree and its spec tree."""
    total = per_dev = 0
    for leaf, spec in _pairs(abstract_params, specs):
        b = _leaf_bytes(leaf)
        total += b
        per_dev += -(-b // _shard_factor(spec, axis_sizes))
    return total, per_dev


def abstract_qwen_params(config, *, quant_bits: int | None = None, group_size: int = 64,
                         dtype: torch.dtype = torch.bfloat16) -> dict:
    """The tree of ``models/qwen.py:init_params`` (unfused) on the meta
    device, in the MLX packed layout for quantized leaves as a checkpoint
    holds them (uint32 words as int32, fp16 scales and biases)."""

    def arr(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device="meta")

    def dense(n_in, n_out, bias=False):
        if quant_bits and n_in % group_size == 0 and n_in % (32 // quant_bits) == 0:
            per_word = 32 // quant_bits
            p = {"w": QuantTensor(arr(n_out, n_in // per_word, dt=torch.int32),
                                  arr(n_out, n_in // group_size, dt=torch.float16),
                                  arr(n_out, n_in // group_size, dt=torch.float16),
                                  quant_bits, group_size)}
        else:
            p = {"w": arr(n_out, n_in)}
        if bias:
            p["b"] = arr(n_out)
        return p

    D, I = config.hidden_size, config.intermediate_size
    H, KV, hd = config.num_attention_heads, config.num_key_value_heads, config.hd

    def layer():
        attn = {"q": dense(D, H * hd, config.attention_bias),
                "k": dense(D, KV * hd, config.attention_bias),
                "v": dense(D, KV * hd, config.attention_bias),
                "o": dense(H * hd, D)}
        if config.qk_norm:
            attn["q_norm"] = arr(hd)
            attn["k_norm"] = arr(hd)
        return {"input_ln": arr(D), "attn": attn, "post_ln": arr(D),
                "mlp": {"gate": dense(D, I), "up": dense(D, I), "down": dense(I, D)}}

    embed = arr(config.vocab_size, D)
    if quant_bits:  # the embedding quantizes along D
        per_word = 32 // quant_bits
        embed = QuantTensor(arr(config.vocab_size, D // per_word, dt=torch.int32),
                            arr(config.vocab_size, D // group_size, dt=torch.float16),
                            arr(config.vocab_size, D // group_size, dt=torch.float16),
                            quant_bits, group_size)
    params = {"embed": embed, "layers": [layer() for _ in range(config.num_hidden_layers)],
              "final_ln": arr(D)}
    if not config.tie_word_embeddings:
        params["lm_head"] = dense(D, config.vocab_size)
    return params


def device_budget(device: torch.device | str | None, budget_bytes: int | None) -> int:
    """``budget_bytes``, else the CUDA ``device``'s total memory."""
    if budget_bytes is not None:
        return int(budget_bytes)
    if device is not None and torch.device(device).type == "cuda":
        return torch.cuda.get_device_properties(torch.device(device)).total_memory
    raise ValueError("memory plan: give budget_bytes, or a CUDA device to read it from")


def plan_qwen_serving(config, *, tp: int, batch_per_device: int = 1, max_len: int = 4096,
                      quant_bits: int | None = None, group_size: int = 64,
                      budget_bytes: int | None = None,
                      device: torch.device | str | None = None,
                      cache_dtype_bytes: float = 2, kv_bits: int | None = None) -> MemoryPlan:
    """Memory plan for serving ``config`` over a tp-way mesh: bf16 caches by
    default, ``kv_bits`` 8 / 4 for the quantized ones (it overrides
    ``cache_dtype_bytes``)."""
    from whisper_mlx_tpu_torch.parallel.sharding_llm import qwen_param_specs

    budget = device_budget(device, budget_bytes)
    abstract = abstract_qwen_params(config, quant_bits=quant_bits, group_size=group_size)
    total, per_dev = plan_param_memory(abstract, qwen_param_specs(abstract, tp="tp"),
                                       {"tp": tp})
    if kv_bits is not None:
        cache_dtype_bytes = kv_bits / 8
    kv = int(config.num_hidden_layers * 2 * batch_per_device * config.num_key_value_heads
             * max_len * (config.hd * cache_dtype_bytes + (2 if cache_dtype_bytes < 2 else 0)))
    return MemoryPlan(total_bytes=total, per_device_bytes=per_dev, kv_cache_bytes=kv,
                      headroom_bytes=budget - per_dev - kv)
