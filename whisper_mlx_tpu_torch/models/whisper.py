"""Whisper encoder/decoder as PyTorch functions over a parameter dict.

Counterpart of ``whisper_mlx_tpu/models/whisper.py`` for the greedy slice.
Parameters are a nested dict of tensors with the JAX package's tree
structure (``checkpoint/convert.py`` builds it from the JAX tree) in
PyTorch's layouts: linear ``w`` is ``(n_out, n_in)``, conv ``w`` is
``(out, in, k)``. Public boundaries keep the JAX package's tensor layouts:
mel ``(B, 3000, n_mels)``, encoder states ``(B, 1500, d)``, q/k/v
``(B, H, T, hd)``.

Compute follows ``config.dtype`` (bf16 serving, fp32 parity); LayerNorm
and softmax run in fp32. Attention goes to the hand-written kernels on
CUDA (``ops/dense_attention.py`` for the encoder when
``flash_attention``, ``ops/flash_attention.py`` above 2048 keys,
``ops/decode_attention.py`` for quantized decoder
caches, the JAX package's ``attention_int8_auto`` and
``attention_int8_grouped``); GEMMs and the conv stem are plain torch. The
plain attention of the parity configuration (flash off, fp caches) runs on
CPU tensors only: on CUDA tensors it raises.

Caches are position-major and updated in place by :func:`decode_step`:
fp ``{"k", "v"}`` ``(B, H, T, hd)``; quantized ``{"k8", "ks", "v8", "vs"}``
with codes ``(B, H, T, hd)`` int8 or ``(B, H, T, hd/2)`` packed int4 and
scales ``(B, H, T)`` bf16 (``ops/kv_quant.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from whisper_mlx_tpu_torch.ops.decode_attention import decode_attention
from whisper_mlx_tpu_torch.ops.dense_attention import dense_attention
from whisper_mlx_tpu_torch.ops.flash_attention import flash_attention
from whisper_mlx_tpu_torch.ops.kv_quant import quantize_kv
from whisper_mlx_tpu_torch.ops.quant import quant_matmul

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    n_mels: int = 80
    n_vocab: int = 51865
    n_audio_ctx: int = 1500
    n_audio_state: int = 384
    n_audio_head: int = 6
    n_audio_layer: int = 4
    n_text_ctx: int = 448
    n_text_state: int = 384
    n_text_head: int = 6
    n_text_layer: int = 4
    # compute dtype: bf16 serving, fp32 parity
    dtype: torch.dtype = torch.float32
    # encoder self-attention through kernel K2 (ops/dense_attention.py)
    flash_attention: bool = False
    # quantized cross / self KV caches: 8 = int8, 4 = packed int4, 0 = fp
    kv_bits: int = 0
    self_kv_bits: int = 0

    @property
    def head_dim(self) -> int:
        return self.n_audio_state // self.n_audio_head


WHISPER_CONFIGS: dict[str, WhisperConfig] = {
    "tiny": WhisperConfig(),
    "base": WhisperConfig(n_audio_state=512, n_audio_head=8, n_audio_layer=6,
                          n_text_state=512, n_text_head=8, n_text_layer=6),
    "small": WhisperConfig(n_audio_state=768, n_audio_head=12, n_audio_layer=12,
                           n_text_state=768, n_text_head=12, n_text_layer=12),
    "medium": WhisperConfig(n_audio_state=1024, n_audio_head=16, n_audio_layer=24,
                            n_text_state=1024, n_text_head=16, n_text_layer=24),
    "large-v1": WhisperConfig(n_audio_state=1280, n_audio_head=20, n_audio_layer=32,
                              n_text_state=1280, n_text_head=20, n_text_layer=32),
    "large-v2": WhisperConfig(n_audio_state=1280, n_audio_head=20, n_audio_layer=32,
                              n_text_state=1280, n_text_head=20, n_text_layer=32),
    "large-v3": WhisperConfig(n_mels=128, n_vocab=51866,
                              n_audio_state=1280, n_audio_head=20, n_audio_layer=32,
                              n_text_state=1280, n_text_head=20, n_text_layer=32),
    "large-v3-turbo": WhisperConfig(n_mels=128, n_vocab=51866,
                                    n_audio_state=1280, n_audio_head=20, n_audio_layer=32,
                                    n_text_state=1280, n_text_head=20, n_text_layer=4),
}


def sinusoids(length: int, channels: int, max_timescale: float = 10_000.0) -> np.ndarray:
    """Sinusoidal position embedding for the encoder (sin ‖ cos halves)."""
    if channels % 2:
        raise ValueError(f"sinusoids: channels must be even, got {channels}")
    log_inc = math.log(max_timescale) / (channels // 2 - 1)
    inv = np.exp(-log_inc * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# primitive layers
# ---------------------------------------------------------------------------


def layer_norm(x: torch.Tensor, p: Params, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm computed in fp32 whatever the compute dtype."""
    y = F.layer_norm(x.float(), x.shape[-1:], p["g"].float(), p["b"].float(), eps)
    return y.to(x.dtype)


def linear(x: torch.Tensor, p: Params) -> torch.Tensor:
    b = p.get("b")
    return F.linear(x, p["w"].to(x.dtype), None if b is None else b.to(x.dtype))


def embed_tokens(emb: torch.Tensor, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return emb.to(dtype)[tokens]


def embed_logits(emb, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Tied-embedding output head: x (b, t, d) -> logits (b, t, vocab); a
    quantized table goes through ``quant_matmul`` (kernel K5)."""
    if not isinstance(emb, torch.Tensor):
        return quant_matmul(x, emb)
    return torch.matmul(x, emb.to(dtype).T)


def conv1d_nwc(x: torch.Tensor, p: Params, stride: int) -> torch.Tensor:
    """1-D conv, k=3, padding 1, on (batch, time, channels) activations."""
    y = F.conv1d(x.transpose(1, 2), p["w"].to(x.dtype), p["b"].to(x.dtype),
                 stride=stride, padding=1)
    return y.transpose(1, 2)


def _split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.view(b, t, n_head, d // n_head).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, hd = x.shape
    return x.transpose(1, 2).reshape(b, t, h * hd)


def _plain_on_cpu_only(x: torch.Tensor, what: str) -> None:
    if x.is_cuda:
        raise ValueError(f"{what} runs on CPU tensors only; on CUDA the kernels are the "
                         "only path (flash_attention=True, kv_bits and self_kv_bits 4|8)")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: torch.Tensor | None = None) -> torch.Tensor:
    """Multi-head attention over (batch, heads, time, head_dim); q and k
    each scaled by ``head_dim**-0.25``; softmax in fp32. CPU tensors only."""
    _plain_on_cpu_only(q, "plain attention")
    scale = q.shape[-1] ** -0.25
    scores = torch.matmul(q * scale, (k * scale).transpose(-1, -2)).float()
    if mask is not None:
        scores = scores + mask
    w = torch.softmax(scores, dim=-1)
    return torch.matmul(w.to(v.dtype), v)


def _qkv_proj(h: torch.Tensor, attn: Params, n_head: int):
    return (_split_heads(linear(h, attn["q"]), n_head),
            _split_heads(linear(h, attn["k"]), n_head),
            _split_heads(linear(h, attn["v"]), n_head))


def mha(x: torch.Tensor, p: Params, n_head: int, use_flash: bool = False) -> torch.Tensor:
    """Encoder self-attention when ``use_flash``: kernel K2 up to 2048 keys,
    kernel K4 (non-causal) above, as the reference splits it."""
    q, k, v = _qkv_proj(x, p, n_head)
    if use_flash:
        scale = q.shape[-1] ** -0.25
        attend = dense_attention if k.shape[2] <= 2048 else flash_attention
        out = attend((q * scale).contiguous(), (k * scale).contiguous(), v.contiguous())
    else:
        out = attention(q, k, v)
    return linear(_merge_heads(out), p["o"])


def mlp(x: torch.Tensor, p: Params) -> torch.Tensor:
    return linear(F.gelu(linear(x, p["fc1"])), p["fc2"])


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------


def encode(params: Params, mel: torch.Tensor, config: WhisperConfig) -> torch.Tensor:
    """mel (batch, 3000, n_mels) -> encoder states (batch, 1500, d)."""
    p = params["encoder"]
    x = mel.to(config.dtype)
    x = F.gelu(conv1d_nwc(x, p["conv1"], stride=1))
    x = F.gelu(conv1d_nwc(x, p["conv2"], stride=2))
    x = x + p["pos_emb"].to(x.dtype)
    for blk in p["blocks"]:
        h = layer_norm(x, blk["attn_ln"])
        x = x + mha(h, blk["attn"], config.n_audio_head, use_flash=config.flash_attention)
        x = x + mlp(layer_norm(x, blk["mlp_ln"]), blk["mlp"])
    return layer_norm(x, p["ln_post"])


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------


def cross_kv(params: Params, audio_states: torch.Tensor, config: WhisperConfig) -> list[Params]:
    """Per-layer cross-attention K/V, computed once per window. With
    ``config.kv_bits`` 8 or 4 the keys (pre-scaled by head_dim**-0.25) and
    values are stored quantized with per-position scales."""
    out = []
    scale = (config.n_text_state // config.n_text_head) ** -0.25
    for blk in params["decoder"]["blocks"]:
        k = _split_heads(linear(audio_states, blk["cross_attn"]["k"]), config.n_text_head)
        v = _split_heads(linear(audio_states, blk["cross_attn"]["v"]), config.n_text_head)
        if config.kv_bits in (4, 8):
            k8, ks = quantize_kv(k * scale, bits=config.kv_bits)
            v8, vs = quantize_kv(v, bits=config.kv_bits)
            out.append({"k8": k8, "ks": ks, "v8": v8, "vs": vs})
        else:
            out.append({"k": k, "v": v})
    return out


def init_kv_cache(config: WhisperConfig, batch: int, device: torch.device | str,
                  max_len: int | None = None) -> list[Params]:
    """Self-attention KV cache, right-sized to ``max_len`` (the decode's
    horizon, rounded up to 128) when given."""
    hd = config.n_text_state // config.n_text_head
    t_alloc = config.n_text_ctx if max_len is None else min(
        -(-max_len // 128) * 128, config.n_text_ctx)
    shape = (batch, config.n_text_head, t_alloc, hd)
    if config.self_kv_bits in (4, 8):
        if config.self_kv_bits == 8:
            cshape, cdtype = shape, torch.int8
        else:
            cshape, cdtype = (*shape[:3], hd // 2), torch.uint8
        sshape = shape[:3]
        return [
            {"k8": torch.zeros(cshape, dtype=cdtype, device=device),
             "ks": torch.zeros(sshape, dtype=torch.bfloat16, device=device),
             "v8": torch.zeros(cshape, dtype=cdtype, device=device),
             "vs": torch.zeros(sshape, dtype=torch.bfloat16, device=device)}
            for _ in range(config.n_text_layer)
        ]
    return [
        {"k": torch.zeros(shape, dtype=config.dtype, device=device),
         "v": torch.zeros(shape, dtype=config.dtype, device=device)}
        for _ in range(config.n_text_layer)
    ]


def decode_step(
    params: Params,
    tokens: torch.Tensor,  # (batch, t) token ids for these positions
    pos: int,  # host int: first position index of ``tokens``
    kv_cache: list[Params],
    xkv: list[Params],
    config: WhisperConfig,
    collect_cross_attn: bool = False,
    share_xkv_groups: int = 1,
) -> tuple[torch.Tensor, list[Params]]:
    """Run the decoder on ``tokens`` at positions ``[pos, pos + t)``.

    Serves the prompt prefill (t = prompt length) and the incremental step
    (t = 1). Writes the new K/V into ``kv_cache`` IN PLACE and returns
    ``(logits (batch, t, vocab) fp32, kv_cache)``. ``share_xkv_groups=g``:
    ``xkv`` holds batch/g windows whose cross K/V are shared by g
    consecutive rows (best_of candidates).
    """
    if collect_cross_attn:
        raise NotImplementedError("cross-attention weights for word timestamps: "
                                  "ROADMAP.md M8")
    p = params["decoder"]
    b, t = tokens.shape
    end = pos + t
    x = embed_tokens(p["token_emb"], tokens, config.dtype)
    x = x + p["pos_emb"][pos:end].to(config.dtype)

    quant_self = "k8" in kv_cache[0]
    if not quant_self:
        q_idx = torch.arange(t, device=x.device)[:, None] + pos
        k_idx = torch.arange(end, device=x.device)[None, :]
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        mask = torch.where(k_idx <= q_idx, zero, float("-inf"))

    for i, blk in enumerate(p["blocks"]):
        h = layer_norm(x, blk["attn_ln"])
        q, k_new, v_new = _qkv_proj(h, blk["attn"], config.n_text_head)
        c = kv_cache[i]
        scale = q.shape[-1] ** -0.25
        if quant_self:
            k8n, ksn = quantize_kv(k_new * scale, bits=config.self_kv_bits)
            v8n, vsn = quantize_kv(v_new, bits=config.self_kv_bits)
            c["k8"][:, :, pos:end] = k8n
            c["ks"][:, :, pos:end] = ksn
            c["v8"][:, :, pos:end] = v8n
            c["vs"][:, :, pos:end] = vsn
            attn_out = decode_attention((q * scale).contiguous(), c["k8"], c["ks"],
                                        c["v8"], c["vs"], pos=pos, causal=True)
        else:
            c["k"][:, :, pos:end] = k_new
            c["v"][:, :, pos:end] = v_new
            attn_out = attention(q, c["k"][:, :, :end], c["v"][:, :, :end], mask)
        x = x + linear(_merge_heads(attn_out), blk["attn"]["o"])

        h = layer_norm(x, blk["cross_attn_ln"])
        qx = _split_heads(linear(h, blk["cross_attn"]["q"]), config.n_text_head)
        xc = xkv[i]
        g = share_xkv_groups
        if "k8" in xc:
            qs = (qx * scale).contiguous()
            cross_out = decode_attention(qs, xc["k8"], xc["ks"], xc["v8"], xc["vs"],
                                         valid_len=config.n_audio_ctx, group=g)
        elif g > 1:
            _plain_on_cpu_only(qx, "plain grouped cross attention")
            n = b // g
            qx5 = (qx * scale).float().reshape(n, g, *qx.shape[1:])
            s5 = torch.einsum("nghqd,nhkd->nghqk", qx5, (xc["k"] * scale).float())
            w5 = torch.softmax(s5, dim=-1).to(xc["v"].dtype)
            cross_out = torch.einsum("nghqk,nhkd->nghqd", w5, xc["v"])
            cross_out = cross_out.reshape(qx.shape).to(qx.dtype)
        else:
            cross_out = attention(qx, xc["k"], xc["v"])
        x = x + linear(_merge_heads(cross_out), blk["cross_attn"]["o"])
        x = x + mlp(layer_norm(x, blk["mlp_ln"]), blk["mlp"])

    x = layer_norm(x, p["ln"])
    logits = embed_logits(p["token_emb"], x, config.dtype).float()
    return logits, kv_cache


# ---------------------------------------------------------------------------
# initialization (random weights for smoke runs; real ones via checkpoint/)
# ---------------------------------------------------------------------------


def init_params(config: WhisperConfig, seed: int = 0,
                device: torch.device | str = "cpu",
                dtype: torch.dtype = torch.float32) -> Params:
    """Random params drawn on ``device`` from a seeded ``torch.Generator``,
    in the layout ``checkpoint/convert.py:params_from_jax`` produces."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, std):
        x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return (x * std).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, device=device, dtype=dtype)

    def dense(n_in, n_out, bias=True):
        p = {"w": randn(n_out, n_in, std=1.0 / math.sqrt(n_in))}
        if bias:
            p["b"] = zeros(n_out)
        return p

    def ln(d):
        return {"g": torch.ones(d, device=device, dtype=dtype), "b": zeros(d)}

    def attn_block(d):
        return {"q": dense(d, d), "k": dense(d, d, bias=False), "v": dense(d, d),
                "o": dense(d, d)}

    def enc_block(d):
        return {"attn_ln": ln(d), "attn": attn_block(d), "mlp_ln": ln(d),
                "mlp": {"fc1": dense(d, 4 * d), "fc2": dense(4 * d, d)}}

    def dec_block(d):
        blk = enc_block(d)
        blk["cross_attn_ln"] = ln(d)
        blk["cross_attn"] = attn_block(d)
        return blk

    d_a, d_t = config.n_audio_state, config.n_text_state
    return {
        "encoder": {
            "conv1": {"w": randn(d_a, config.n_mels, 3, std=1.0 / math.sqrt(3 * config.n_mels)),
                      "b": zeros(d_a)},
            "conv2": {"w": randn(d_a, d_a, 3, std=1.0 / math.sqrt(3 * d_a)),
                      "b": zeros(d_a)},
            "pos_emb": torch.from_numpy(sinusoids(config.n_audio_ctx, d_a)).to(device, dtype),
            "blocks": [enc_block(d_a) for _ in range(config.n_audio_layer)],
            "ln_post": ln(d_a),
        },
        "decoder": {
            "token_emb": randn(config.n_vocab, d_t, std=0.02),
            "pos_emb": randn(config.n_text_ctx, d_t, std=0.02),
            "blocks": [dec_block(d_t) for _ in range(config.n_text_layer)],
            "ln": ln(d_t),
        },
    }
