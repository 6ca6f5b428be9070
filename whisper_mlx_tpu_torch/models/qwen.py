"""Qwen2/Qwen3-family decoder LLM as PyTorch functions over a state dict.

Counterpart of ``whisper_mlx_tpu/models/qwen.py``: RMSNorm pre-norm,
rotary embeddings, grouped-query attention, SwiGLU, optional per-head q/k
RMSNorm (Qwen3), tied or untied head. Parameters are a dict in the port's
layouts: linear ``w`` is ``(out, in)`` (a tensor, an MLX
:class:`~whisper_mlx_tpu_torch.ops.quant.QuantTensor`, or one of its
converted residency forms), ``embed`` is
``(vocab, d)``; ``fuse_qwen_projections`` gives fused ``qkv`` and
``gate_up`` linears.

The KV cache is position-major, ``{"k", "v"}`` of ``(b, kv, max_len, hd)``
per layer, written in place by :func:`decode_step` (the reference keeps it
time-minor for TPU lanes; the values each step returns are the same). With
``config.kv_bits`` 8 or 4 (``WTPU_LLM_KV_BITS``) each layer holds codes
``{"k8", "v8"}`` ``(b, kv, max_len, hd)`` int8 or ``(b, kv, max_len,
hd / 2)`` uint8 (two int4 nibbles a byte) and bf16 scales ``{"ks", "vs"}``
``(b, kv, max_len)``: ``quantize_kv`` of the rotated, normed, unscaled k
and v, as the reference's ``k8t``/``v8t`` and ``(b, kv, T, 1)`` scales hold
them (``checkpoint/convert.py:qwen_cache_from_jax`` converts).

Kernels on the card: every quantized linear goes through ``quant_matmul``
(at <= 512 rows K5 for a packed ``QuantTensor``, K6 for a ``QuantTensorT``,
K7 for an ``A8Tensor``: ``ops/quant.py``), every prefill through
``flash_attention`` (K4), over the block's unquantized k and v under any
``kv_bits``. A
prefill starts at position 0, and on CUDA it needs ``flash_attention=True``.
Decode attention over an fp cache is plain torch, as the reference computes
it in XLA outside any kernel; over a quantized cache it is
``ops/gqa_decode_attention.py`` (K3's GQA mode on the card, its plain
version on the CPU), with the positions a ``(b,)`` int32 tensor on the
device. Both read only positions below ``pos + t``,
which is exact because later positions carry weight exactly 0. A block of
several tokens past position 0 (speculative decoding's verify and draft
sync) takes that path too, causal over the cache. The reference's flash
branch takes any block of several tokens and attends within the block
only, which at a position past 0 would leave out the cache; it never meets
one, since its ``load_qwen`` leaves flash off.

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

from whisper_mlx_tpu_torch.models.whisper import embed_logits, embed_tokens, row_linear, tp_mesh
from whisper_mlx_tpu_torch.ops.flash_attention import flash_attention
from whisper_mlx_tpu_torch.ops.gqa_decode_attention import (
    causal_mask,
    gqa_decode_attention,
    grouped_attention,
)
from whisper_mlx_tpu_torch.ops.kv_quant import quantize_kv
from whisper_mlx_tpu_torch.ops.quant import (
    QuantTensor,
    quant_matmul,
    stack_quant,
)
from whisper_mlx_tpu_torch.parallel.mesh import all_gather_cat

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
    # quantized LLM KV cache: 8 (int8) or 4 (packed int4) codes with bf16
    # per-position scales; any other value keeps the fp cache
    kv_bits: int = 0
    dtype: torch.dtype = torch.float32

    @property
    def hd(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    def local_heads(self) -> tuple[int, int]:
        """(query heads, KV heads) of this rank: the whole counts, or their
        shares under tensor parallelism."""
        mesh = tp_mesh(self)
        tp = mesh.tp if mesh is not None else 1
        if self.num_attention_heads % tp or self.num_key_value_heads % tp:
            raise ValueError(f"qwen: heads ({self.num_attention_heads}, "
                             f"{self.num_key_value_heads}) do not divide over tp={tp}")
        return self.num_attention_heads // tp, self.num_key_value_heads // tp


@dataclasses.dataclass(frozen=True)
class TPQwenConfig(QwenConfig):
    """A rank's config under tensor parallelism
    (``parallel/sharding_llm.py:shard_qwen_model``): its tree holds this
    rank's heads, MLP widths and vocabulary rows of ``mesh``'s "tp" axis;
    the head counts and widths above stay the model's full ones."""

    mesh: Any = dataclasses.field(default=None, compare=False, repr=False)


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


def quantized_cache(config: QwenConfig) -> bool:
    """Whether ``config`` keeps the quantized cache (``kv_bits`` 8 or 4)."""
    return config.kv_bits in (4, 8)


def init_kv_cache(config: QwenConfig, batch: int, max_len: int,
                  device: torch.device | str = "cpu",
                  dtype: torch.dtype | None = None) -> list[Params]:
    """Position-major cache: fp ``{"k", "v"}`` ``(batch, kv, max_len, hd)``,
    or under ``kv_bits`` 8 / 4 codes ``{"k8", "v8"}`` (int8 ``hd`` wide, or
    uint8 ``hd / 2`` wide holding int4 pairs) and bf16 scales ``{"ks",
    "vs"}`` ``(batch, kv, max_len)``; a tensor-parallel rank holds its own
    KV heads."""
    KV, hd = config.local_heads()[1], config.hd
    if quantized_cache(config):
        width, cdt = (hd, torch.int8) if config.kv_bits == 8 else (hd // 2, torch.uint8)
        return [{"k8": torch.zeros((batch, KV, max_len, width), dtype=cdt, device=device),
                 "ks": torch.zeros((batch, KV, max_len), dtype=torch.bfloat16, device=device),
                 "v8": torch.zeros((batch, KV, max_len, width), dtype=cdt, device=device),
                 "vs": torch.zeros((batch, KV, max_len), dtype=torch.bfloat16, device=device)}
                for _ in range(config.num_hidden_layers)]
    shape = (batch, KV, max_len, hd)
    dtype = dtype or config.dtype
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(config.num_hidden_layers)]


def _embed(params: Params, tokens: torch.Tensor, config: QwenConfig) -> torch.Tensor:
    return embed_tokens(params["embed"], tokens, config.dtype, tp_mesh(config),
                        config.vocab_size)


def decode_step(params: Params, tokens: torch.Tensor, pos: int | Sequence[int],
                kv_cache: list[Params], config: QwenConfig
                ) -> tuple[torch.Tensor, list[Params]]:
    """Prefill (t > 1) or incremental (t = 1) step; returns ``(logits
    (b, t, vocab) fp32, kv_cache)`` with the cache written in place.

    ``pos`` is a host int (first position of ``tokens``) or, for continuous
    batching, one host int per row. A write past the cache end is clamped
    to its last ``t`` positions, as the reference's update slice is. Under
    ``kv_bits`` 8 / 4 the new k and v are quantized into the cache and every
    block but a flash prefill attends over the quantized cache, its own new
    entries included.
    """
    b, t = tokens.shape
    dev = tokens.device
    quant_kv = quantized_cache(config)
    max_len = kv_cache[0]["k8" if quant_kv else "k"].shape[2]
    per_row = not isinstance(pos, int)
    mesh = tp_mesh(config)
    (H, KV), hd = config.local_heads(), config.hd
    # a prefill (a block at position 0) runs K4; a block past position 0
    # (speculative decoding's verify and draft sync) attends over the cache
    # on the grouped path, as a one-token step does
    prefill = t > 1 and not per_row and pos == 0
    if prefill and not config.flash_attention and tokens.is_cuda:
        raise ValueError("qwen decode_step: on CUDA a prefill runs kernel K4; set "
                         "flash_attention=True")

    x = _embed(params, tokens, config)
    if per_row:
        starts = torch.tensor(list(pos), dtype=torch.int64)
        if starts.shape != (b,):
            raise ValueError(f"qwen decode_step: {b} rows, positions {list(pos)}")
        positions = (starts[:, None] + torch.arange(t)[None, :]).to(dev)  # (b, t)
        limit = min(max_len, int(starts.max()) + t)
        write = (starts.clamp(max=max_len - t)[:, None] + torch.arange(t)[None, :]).to(dev)
        rows = torch.arange(b, device=dev)[:, None]
    else:
        starts = torch.full((b,), pos, dtype=torch.int64)
        positions = torch.arange(pos, pos + t, device=dev)
        limit = min(max_len, pos + t)
        start = min(pos, max_len - t)
    cos, sin = rope_cos_sin(positions, hd, config.rope_theta, torch.float32)
    scale = 1.0 / math.sqrt(hd)
    if quant_kv:
        # the rows' first positions, on the device once a step for the
        # kernel; a row at or past the cache end reads every key, as its
        # unclamped causal mask would (an idle slot of the continuous engine
        # keeps advancing)
        pos_dev = starts.clamp(max=max_len - 1).to(dev, torch.int32)
    else:  # the fp cache's causal mask over the keys read, once a step
        mask = causal_mask(starts.to(dev), t, limit)

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
        if quant_kv:  # codes and scales of the rotated, normed, unscaled k and v
            new = dict(zip(("k8", "ks"), quantize_kv(k, config.kv_bits)))
            new.update(zip(("v8", "vs"), quantize_kv(v, config.kv_bits)))
        else:
            new = {"k": k, "v": v}
        for key, val in new.items():
            if per_row:
                c[key][rows, :, write] = val.transpose(1, 2).to(c[key].dtype)
            else:
                c[key][:, :, start:start + t] = val.to(c[key].dtype)

        if prefill and config.flash_attention:
            s4 = hd ** -0.25
            attn = flash_attention((q * s4).to(config.dtype).contiguous(),
                                   (k * s4).to(config.dtype).contiguous(),
                                   v.to(config.dtype).contiguous(), causal=True)
        elif quant_kv:
            attn = gqa_decode_attention(q.float().contiguous(), c["k8"], c["ks"], c["v8"],
                                        c["vs"], pos_dev, scale=scale, live=limit,
                                        out_dtype=config.dtype)
        else:
            attn = grouped_attention(q, c["k"][:, :, :limit], c["v"][:, :, :limit], mask, scale)
        attn = attn.to(config.dtype).reshape(b, H, t, hd).transpose(1, 2).reshape(b, t, H * hd)
        x = x + row_linear(attn, blk["attn"]["o"], mesh, _linear)

        h = rms_norm(x, blk["post_ln"], config.rms_norm_eps)
        if "gate_up" in blk["mlp"]:
            gu = _linear(h, blk["mlp"]["gate_up"])
            gate, up = gu.chunk(2, dim=-1)
            gate = F.silu(gate)
        else:
            gate = F.silu(_linear(h, blk["mlp"]["gate"]))
            up = _linear(h, blk["mlp"]["up"])
        x = x + row_linear(gate * up, blk["mlp"]["down"], mesh, _linear)

    x = rms_norm(x, params["final_ln"], config.rms_norm_eps)
    if config.tie_word_embeddings:
        logits = embed_logits(params["embed"], x, config.dtype, mesh, config.vocab_size)
    else:
        logits = _linear(x, params["lm_head"])
        if mesh is not None:
            logits = all_gather_cat(logits, mesh, "tp", dim=-1, total=config.vocab_size)
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
