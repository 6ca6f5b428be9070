"""Qwen2/Qwen3-family decoder LLM as PyTorch functions over a state dict.

Counterpart of ``whisper_mlx_tpu/models/qwen.py``: RMSNorm pre-norm,
rotary embeddings, grouped-query attention, SwiGLU, optional per-head q/k
RMSNorm (Qwen3), tied or untied head. Parameters are a dict in the port's
layouts: linear ``w`` is ``(out, in)`` (a tensor or an MLX
:class:`~whisper_mlx_tpu_torch.ops.quant.QuantTensor`), ``embed`` is
``(vocab, d)``; ``fuse_qwen_projections`` gives fused ``qkv`` and
``gate_up`` linears.

The KV cache is position-major, ``{"k", "v"}`` of ``(b, kv, max_len, hd)``
per layer, written in place by :func:`decode_step` (the reference keeps it
time-minor for TPU lanes; the values each step returns are the same).

Kernels on the card: every quantized linear goes through ``quant_matmul``
(K5 at <= 512 rows), every prefill through ``flash_attention`` (K4). A
prefill starts at position 0, and on CUDA it needs ``flash_attention=True``.
Decode attention over the cache is plain torch, as the reference computes
it in XLA outside any kernel; it reads only positions below ``pos + t``,
which is exact because later positions carry weight exactly 0.

One difference from the reference: its flash prefill leaves the attention
output in fp32 (``models/qwen.py:281``), which promotes a bf16 prefill's
residual stream to fp32 from the first layer on. The port casts it to
``config.dtype`` as the reference's decode branch does, so a bf16 prefill
stays bf16 (at fp32 the two agree).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from whisper_mlx_tpu_torch.models.whisper import embed_logits
from whisper_mlx_tpu_torch.ops.flash_attention import flash_attention
from whisper_mlx_tpu_torch.ops.quant import (
    QuantTensor,
    quant_matmul,
    quant_rows,
    stack_quant,
)

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class QwenConfig:
    vocab_size: int = 151_936
    hidden_size: int = 2048
    intermediate_size: int = 11_008
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    num_key_value_heads: int = 2
    head_dim: int | None = None  # explicit for Qwen3; hidden/heads otherwise
    rope_theta: float = 1_000_000.0
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = True
    qk_norm: bool = False  # Qwen3: per-head RMSNorm on q and k
    max_position_embeddings: int = 32_768
    attention_bias: bool = True  # Qwen2: bias on q/k/v; Qwen3: False
    # prefill through kernel K4 (ops/flash_attention.py); prefill at pos 0
    flash_attention: bool = False
    # quantized LLM KV cache: not ported (ROADMAP.md M12); only 0 runs
    kv_bits: int = 0
    dtype: torch.dtype = torch.float32

    @property
    def hd(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads


QWEN_CONFIGS: dict[str, QwenConfig] = {
    "qwen2.5-0.5b": QwenConfig(hidden_size=896, intermediate_size=4864,
                               num_hidden_layers=24, num_attention_heads=14,
                               num_key_value_heads=2, rope_theta=1e6),
    "qwen2.5-7b": QwenConfig(hidden_size=3584, intermediate_size=18944,
                             num_hidden_layers=28, num_attention_heads=28,
                             num_key_value_heads=4, tie_word_embeddings=False),
    "qwen2.5-14b": QwenConfig(hidden_size=5120, intermediate_size=13824,
                              num_hidden_layers=48, num_attention_heads=40,
                              num_key_value_heads=8, tie_word_embeddings=False),
    "qwen3-8b": QwenConfig(hidden_size=4096, intermediate_size=12288,
                           num_hidden_layers=36, num_attention_heads=32,
                           num_key_value_heads=8, head_dim=128, qk_norm=True,
                           attention_bias=False, tie_word_embeddings=False),
    "qwen3-32b": QwenConfig(hidden_size=5120, intermediate_size=25600,
                            num_hidden_layers=64, num_attention_heads=64,
                            num_key_value_heads=8, head_dim=128, qk_norm=True,
                            attention_bias=False, tie_word_embeddings=False),
}

KV_BITS_ITEM = "the quantized LLM KV cache (kv_bits) is not ported: ROADMAP.md M12"


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float() if x.dtype != torch.float64 else x
    y = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (y * g.to(y.dtype)).to(x.dtype)


def _linear(x: torch.Tensor, p: Params) -> torch.Tensor:
    w = p["w"]
    y = quant_matmul(x, w) if not isinstance(w, torch.Tensor) else F.linear(x, w.to(x.dtype))
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def rope_cos_sin(positions: torch.Tensor, hd: int, theta: float,
                 dtype: torch.dtype = torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables ``(..., hd // 2)`` with ``inv_freq`` computed in fp32."""
    inv_freq = (1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float32) / np.float32(hd)))
                ).astype(np.float32)
    angles = positions[..., None].float() * torch.from_numpy(inv_freq).to(positions.device)
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x ``(b, h, t, hd)``; cos/sin ``(t, hd/2)`` shared or ``(b, t, hd/2)``
    per row. HF ``rotate_half`` convention."""
    hd = x.shape[-1]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    if cos.dim() == 3:
        c, s = cos[:, None], sin[:, None]
    else:
        c, s = cos[None, None], sin[None, None]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def init_kv_cache(config: QwenConfig, batch: int, max_len: int,
                  device: torch.device | str = "cpu",
                  dtype: torch.dtype | None = None) -> list[Params]:
    """Position-major fp cache: ``{"k", "v"}`` ``(batch, kv, max_len, hd)``."""
    if config.kv_bits:
        raise NotImplementedError(KV_BITS_ITEM)
    shape = (batch, config.num_key_value_heads, max_len, config.hd)
    dtype = dtype or config.dtype
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(config.num_hidden_layers)]


def _embed(params: Params, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    emb = params["embed"]
    if isinstance(emb, torch.Tensor):
        return emb.to(dtype)[tokens]
    return quant_rows(emb, tokens, dtype)


def decode_step(params: Params, tokens: torch.Tensor, pos: int | Sequence[int],
                kv_cache: list[Params], config: QwenConfig
                ) -> tuple[torch.Tensor, list[Params]]:
    """Prefill (t > 1) or incremental (t = 1) step; returns ``(logits
    (b, t, vocab) fp32, kv_cache)`` with the cache written in place.

    ``pos`` is a host int (first position of ``tokens``) or, for continuous
    batching, one host int per row. A write past the cache end is clamped
    to its last ``t`` positions, as the reference's update slice is.
    """
    if config.kv_bits:
        raise NotImplementedError(KV_BITS_ITEM + (" (also with per-row positions)"
                                                  if not isinstance(pos, int) else ""))
    b, t = tokens.shape
    dev = tokens.device
    max_len = kv_cache[0]["k"].shape[2]
    per_row = not isinstance(pos, int)
    H, KV, hd = config.num_attention_heads, config.num_key_value_heads, config.hd
    rep = H // KV
    prefill = t > 1 and not per_row
    if prefill and config.flash_attention and pos != 0:
        raise ValueError(f"qwen decode_step: a flash prefill starts at position 0, got {pos}")
    if prefill and not config.flash_attention and tokens.is_cuda:
        raise ValueError("qwen decode_step: on CUDA a prefill runs kernel K4; set "
                         "flash_attention=True")

    x = _embed(params, tokens, config.dtype)
    if per_row:
        starts = torch.tensor(list(pos), dtype=torch.int64)
        if starts.shape != (b,):
            raise ValueError(f"qwen decode_step: {b} rows, positions {list(pos)}")
        positions = (starts[:, None] + torch.arange(t)[None, :]).to(dev)  # (b, t)
        limit = min(max_len, int(starts.max()) + t)
        write = (starts.clamp(max=max_len - t)[:, None] + torch.arange(t)[None, :]).to(dev)
        rows = torch.arange(b, device=dev)[:, None]
        k_idx = torch.arange(limit, device=dev)
        mask = torch.where(k_idx[None, None, :] <= positions[:, :, None], 0.0, float("-inf"))
        mask = mask[:, None, None]  # (b, 1, 1, t, limit) over (b, kv, rep, t, k)
    else:
        positions = torch.arange(pos, pos + t, device=dev)
        limit = min(max_len, pos + t)
        start = min(pos, max_len - t)
        k_idx = torch.arange(limit, device=dev)
        mask = torch.where(k_idx[None, :] <= positions[:, None], 0.0, float("-inf"))
    cos, sin = rope_cos_sin(positions, hd, config.rope_theta, torch.float32)
    scale = 1.0 / math.sqrt(hd)

    for i, blk in enumerate(params["layers"]):
        h = rms_norm(x, blk["input_ln"], config.rms_norm_eps)
        if "qkv" in blk["attn"]:
            fused = _linear(h, blk["attn"]["qkv"])
            qf, kf, vf = fused.split([H * hd, KV * hd, KV * hd], dim=-1)
        else:
            qf, kf, vf = (_linear(h, blk["attn"][n]) for n in ("q", "k", "v"))
        q = qf.reshape(b, t, H, hd).transpose(1, 2)
        k = kf.reshape(b, t, KV, hd).transpose(1, 2)
        v = vf.reshape(b, t, KV, hd).transpose(1, 2)
        if config.qk_norm:
            q = rms_norm(q, blk["attn"]["q_norm"], config.rms_norm_eps)
            k = rms_norm(k, blk["attn"]["k_norm"], config.rms_norm_eps)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

        c = kv_cache[i]
        if per_row:
            c["k"][rows, :, write] = k.transpose(1, 2).to(c["k"].dtype)
            c["v"][rows, :, write] = v.transpose(1, 2).to(c["v"].dtype)
        else:
            c["k"][:, :, start:start + t] = k.to(c["k"].dtype)
            c["v"][:, :, start:start + t] = v.to(c["v"].dtype)

        if prefill and config.flash_attention:
            s4 = hd ** -0.25
            attn = flash_attention((q * s4).to(config.dtype).contiguous(),
                                   (k * s4).to(config.dtype).contiguous(),
                                   v.to(config.dtype).contiguous(), causal=True)
        else:
            kc, vc = c["k"][:, :, :limit], c["v"][:, :, :limit]
            q5 = q.reshape(b, KV, rep, t, hd)
            cdt = torch.promote_types(q5.dtype, kc.dtype)
            scores = torch.einsum("bgrqd,bgkd->bgrqk", q5.to(cdt), kc.to(cdt)) * scale
            scores = scores.to(torch.promote_types(scores.dtype, torch.float32)) + mask
            w = torch.softmax(scores, dim=-1).to(vc.dtype)
            attn = torch.einsum("bgrqk,bgkd->bgrqd", w, vc)
        attn = attn.to(config.dtype).reshape(b, H, t, hd).transpose(1, 2).reshape(b, t, H * hd)
        x = x + _linear(attn, blk["attn"]["o"])

        h = rms_norm(x, blk["post_ln"], config.rms_norm_eps)
        if "gate_up" in blk["mlp"]:
            gu = _linear(h, blk["mlp"]["gate_up"])
            gate, up = gu.chunk(2, dim=-1)
            gate = F.silu(gate)
        else:
            gate = F.silu(_linear(h, blk["mlp"]["gate"]))
            up = _linear(h, blk["mlp"]["up"])
        x = x + _linear(gate * up, blk["mlp"]["down"])

    x = rms_norm(x, params["final_ln"], config.rms_norm_eps)
    if config.tie_word_embeddings:
        logits = embed_logits(params["embed"], x, config.dtype)
    else:
        logits = _linear(x, params["lm_head"])
    return logits.to(torch.promote_types(logits.dtype, torch.float32)), kv_cache


def init_params(config: QwenConfig, seed: int = 0) -> Params:
    """The reference's random init (same numpy draws) in the port's layout,
    fp32 on the CPU: for the parity tests and the tiny offline model."""
    rng = np.random.default_rng(seed)
    D, I = config.hidden_size, config.intermediate_size
    H, KV, hd = config.num_attention_heads, config.num_key_value_heads, config.hd

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))

    def dense(n_in, n_out, bias=False):
        p = {"w": t((rng.standard_normal((n_in, n_out)) / math.sqrt(n_in)).astype(np.float32).T)}
        if bias:
            p["b"] = torch.zeros(n_out)
        return p

    def layer():
        attn = {"q": dense(D, H * hd, config.attention_bias),
                "k": dense(D, KV * hd, config.attention_bias),
                "v": dense(D, KV * hd, config.attention_bias),
                "o": dense(H * hd, D)}
        if config.qk_norm:
            attn["q_norm"] = torch.ones(hd)
            attn["k_norm"] = torch.ones(hd)
        return {"input_ln": torch.ones(D), "attn": attn, "post_ln": torch.ones(D),
                "mlp": {"gate": dense(D, I), "up": dense(D, I), "down": dense(I, D)}}

    params: Params = {
        "embed": t(rng.standard_normal((config.vocab_size, D)) * 0.02),
        "layers": [layer() for _ in range(config.num_hidden_layers)],
        "final_ln": torch.ones(D),
    }
    if not config.tie_word_embeddings:
        params["lm_head"] = dense(D, config.vocab_size)
    return params


def random_quant(n_out: int, n_in: int, std: float, generator: torch.Generator,
                 bits: int = 4, group_size: int = 64) -> QuantTensor:
    """Uniform random codes on the generator's device, with one scale and
    bias per group chosen so the dequantized weights have mean 0 and
    standard deviation ``std``."""
    device = generator.device
    levels = (1 << bits) - 1
    code_std = math.sqrt(((levels + 1) ** 2 - 1) / 12.0)
    words = torch.randint(-2**31, 2**31, (n_out, n_in * bits // 32), generator=generator,
                          device=device, dtype=torch.int64).to(torch.int32)
    scale = torch.full((n_out, n_in // group_size), std / code_std, device=device)
    return QuantTensor(words, scale, -scale * (levels / 2.0), bits, group_size)


def init_random_quant_params(config: QwenConfig, seed: int = 0,
                             device: torch.device | str = "cuda") -> Params:
    """Random MLX 4-bit (group 64) weights at any width, built one linear at
    a time on ``device`` with :func:`random_quant` from a seeded
    ``torch.Generator`` (weights of std ``1/sqrt(in)``, embedding std 1),
    fused with :func:`stack_quant` as ``fuse_qwen_projections`` fuses a
    checkpoint. Norm weights are ones and biases (Qwen2) zeros, in
    ``config.dtype``. The reference's ``init_params`` would build Qwen3-32B
    in fp32 on the host: 131 GB.
    """
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    D, I = config.hidden_size, config.intermediate_size
    H, KV, hd = config.num_attention_heads, config.num_key_value_heads, config.hd

    def quant(n_out, n_in, std):
        return random_quant(n_out, n_in, std, gen)

    def ones(n):
        return torch.ones(n, device=device, dtype=config.dtype)

    def linear(n_out, n_in, bias):
        p = {"w": quant(n_out, n_in, 1.0 / math.sqrt(n_in))}
        if bias:
            p["b"] = torch.zeros(n_out, device=device, dtype=config.dtype)
        return p

    def layer():
        ab = config.attention_bias
        q, k, v = (linear(n, D, ab) for n in (H * hd, KV * hd, KV * hd))
        attn = {"qkv": {"w": stack_quant([q["w"], k["w"], v["w"]])},
                "o": linear(D, H * hd, False)}
        if ab:
            attn["qkv"]["b"] = torch.cat([q["b"], k["b"], v["b"]])
        if config.qk_norm:
            attn["q_norm"], attn["k_norm"] = ones(hd), ones(hd)
        gate, up = linear(I, D, False), linear(I, D, False)
        return {"input_ln": ones(D), "attn": attn, "post_ln": ones(D),
                "mlp": {"gate_up": {"w": stack_quant([gate["w"], up["w"]])},
                        "down": linear(D, I, False)}}

    params: Params = {"embed": quant(config.vocab_size, D, 1.0),
                      "layers": [layer() for _ in range(config.num_hidden_layers)],
                      "final_ln": ones(D)}
    if not config.tie_word_embeddings:
        params["lm_head"] = linear(config.vocab_size, D, False)
    return params
