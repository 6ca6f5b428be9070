"""Whisper encoder/decoder as PyTorch functions over a parameter dict.

Counterpart of ``whisper_mlx_tpu/models/whisper.py`` for the greedy and
beam paths and the word-timestamp alignment pass.
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
caches, the JAX package's ``attention_int8_auto`` /
``attention_int8_grouped`` and, with ``attn_mxu``, their integer-dot forms;
``ops/beamflat_attention.py`` for beam self-attention over the flat cache,
its split mode for the shared-prefix scheme and its per-lane layout for
``beam_ancestry`` over a per-lane cache);
GEMMs and the conv stem are plain torch. The plain attention of the parity
configuration (flash off, fp caches) runs on CPU tensors only: on CUDA
tensors it raises, except in the word-timestamp alignment pass
(``decode_step(collect_cross_attn=True)``, :func:`attention_for_alignment`).

Caches are position-major and updated in place by :func:`decode_step`:
fp ``{"k", "v"}`` ``(B, H, T, hd)``; quantized ``{"k8", "ks", "v8", "vs"}``
with codes ``(B, H, T, hd)`` int8 or ``(B, H, T, hd/2)`` packed int4 and
scales ``(B, H, T)`` bf16 (``ops/kv_quant.py``). Beam search's flat cache
(:func:`beam_flat_cache`) interleaves a window's g lanes along the time
axis: ``{"k8f", "ksf", "v8f", "vsf"}`` codes ``(n, H, T*g, ...)`` and
scales ``(n, H, T*g)``, or fp ``{"kf", "vf"}``; row ``t*g + k`` is lane k's
position t.

The reference's time-major layouts (``WTPU_SELF_KV_LAYOUT`` /
``WTPU_KV_LAYOUT`` = ``tmajor``, the config's ``self_kv_layout`` /
``kv_layout``) compute ``attention_int8_auto``'s function over another
layout, and the reference takes their branch before its integer-dot one:
here the caches stay position-major and a time-major field runs that
attention (self, cross) on kernel K3's fp mode whatever ``attn_mxu`` says.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from whisper_mlx_tpu_torch.ops.beamflat_attention import (
    ancestry_attention,
    attention_fp_ancestry,
    attention_fp_beamflat,
    attention_fp_shared,
    beamflat_attention,
)
from whisper_mlx_tpu_torch.ops.decode_attention import decode_attention
from whisper_mlx_tpu_torch.ops.dense_attention import dense_attention
from whisper_mlx_tpu_torch.ops.flash_attention import flash_attention
from whisper_mlx_tpu_torch.ops.kv_quant import quantize_kv
from whisper_mlx_tpu_torch.ops.quant import quant_matmul, quant_rows
from whisper_mlx_tpu_torch.parallel.mesh import all_gather_cat, all_sum, local_slice

Params = dict[str, Any]

# integer-dot decode attention (attn_mxu) for greedy; read once at import,
# as the reference does (beam turns it on for quantized caches itself)
_ATTN_MXU_DEFAULT = os.environ.get("WTPU_ATTN_MXU") == "1"
# the reference's cache layouts, "tminor" or "tmajor", read once at import
_SELF_KV_LAYOUT_DEFAULT = os.environ.get("WTPU_SELF_KV_LAYOUT", "tminor")
_KV_LAYOUT_DEFAULT = os.environ.get("WTPU_KV_LAYOUT", "tminor")


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
    # integer-dot attention over the quantized caches (kernel K3's and K8's
    # int_dot mode): q and w * vs re-quantized per row, s8 x s8 -> s32 dots
    attn_mxu: bool = _ATTN_MXU_DEFAULT
    # the reference's self / cross cache layouts: "tmajor" keeps the caches
    # position-major here and runs their attention in K3's fp mode
    self_kv_layout: str = _SELF_KV_LAYOUT_DEFAULT
    kv_layout: str = _KV_LAYOUT_DEFAULT
    # (layer, head) pairs for word-timestamp alignment, carried through an
    # mlx-format checkpoint's config.json
    alignment_heads: tuple[tuple[int, int], ...] | None = None

    @property
    def head_dim(self) -> int:
        return self.n_audio_state // self.n_audio_head


@dataclasses.dataclass(frozen=True)
class TPWhisperConfig(WhisperConfig):
    """A rank's config under tensor parallelism
    (``parallel/sharding.py:shard_model``): its tree holds this rank's
    heads, MLP widths and vocabulary rows of ``mesh``'s "tp" axis; the
    widths above stay the model's full ones."""

    mesh: Any = dataclasses.field(default=None, compare=False, repr=False)


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
    """``x @ w.T + b``; a quantized ``w`` (``QuantTensor``, ``QuantTensorT``)
    goes through ``quant_matmul``: kernels K5 / K6 up to 512 rows,
    dequantize + matmul above (the encoder's 1500 rows a window)."""
    w, b = p["w"], p.get("b")
    if not isinstance(w, torch.Tensor):
        y = quant_matmul(x, w)
        return y if b is None else y + b.to(x.dtype)
    return F.linear(x, w.to(x.dtype), None if b is None else b.to(x.dtype))


def tp_mesh(config) -> Any:
    """The config's mesh when its tree is tensor-parallel (tp > 1), else None."""
    mesh = getattr(config, "mesh", None)
    return mesh if mesh is not None and mesh.tp > 1 else None


def row_linear(x: torch.Tensor, p: Params, mesh: Any, lin=None) -> torch.Tensor:
    """A row-parallel linear (``lin``, :func:`linear` by default) under
    tensor parallelism: this rank's partial product over its slice of the
    input features, summed over "tp" (in fp32, ``parallel/mesh.py``), then
    the bias once. A leaf kept whole on every rank
    (``parallel/sharding_llm.py``) gathers x over "tp" first and needs no
    sum."""
    lin = lin or linear
    if mesh is None:
        return lin(x, p)
    w = p["w"]
    if w.shape[1] != x.shape[-1]:
        return lin(all_gather_cat(x, mesh, "tp", dim=-1), p)
    y = all_sum(lin(x, {"w": w}), mesh)
    return y if "b" not in p else y + p["b"].to(y.dtype)


def embed_tokens(emb, tokens: torch.Tensor, dtype: torch.dtype, mesh: Any = None,
                 n_vocab: int | None = None) -> torch.Tensor:
    """Token embedding lookup; a quantized table dequantizes the rows it
    gathers only. Under tensor parallelism ``emb`` holds this rank's
    ceil-split slice of the ``n_vocab`` rows: a masked lookup, summed over
    "tp" (one rank contributes each row, the others zeros)."""
    if mesh is None:
        if not isinstance(emb, torch.Tensor):
            return quant_rows(emb, tokens, dtype=dtype)
        return emb.to(dtype)[tokens]
    own = local_slice(n_vocab, mesh.tp, mesh.index("tp"))
    local = tokens - own.start
    hit = (local >= 0) & (local < own.stop - own.start)
    x = embed_tokens(emb, local.clamp(0, own.stop - own.start - 1), dtype)
    return all_sum(x * hit[..., None].to(dtype), mesh)


def embed_logits(emb, x: torch.Tensor, dtype: torch.dtype, mesh: Any = None,
                 n_vocab: int | None = None) -> torch.Tensor:
    """Tied-embedding output head: x (b, t, d) -> logits (b, t, vocab); a
    quantized table goes through ``quant_matmul`` (kernel K5). Under tensor
    parallelism each rank computes its vocabulary slice's logits, gathered
    over "tp"."""
    if not isinstance(emb, torch.Tensor):
        out = quant_matmul(x, emb)
    else:
        out = torch.matmul(x, emb.to(dtype).T)
    return out if mesh is None else all_gather_cat(out, mesh, "tp", dim=-1, total=n_vocab)


def conv1d_nwc(x: torch.Tensor, p: Params, stride: int) -> torch.Tensor:
    """1-D conv, k=3, padding 1, on (batch, time, channels) activations."""
    y = F.conv1d(x.transpose(1, 2), p["w"].to(x.dtype), p["b"].to(x.dtype),
                 stride=stride, padding=1)
    return y.transpose(1, 2)


def _split_heads(x: torch.Tensor, hd: int) -> torch.Tensor:
    """(b, t, heads * hd) -> (b, heads, t, hd): the heads are counted from
    the width, so a tensor-parallel rank splits its own share."""
    b, t, d = x.shape
    return x.view(b, t, d // hd, hd).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, hd = x.shape
    return x.transpose(1, 2).reshape(b, t, h * hd)


def _plain_on_cpu_only(x: torch.Tensor, what: str) -> None:
    if x.is_cuda:
        raise ValueError(f"{what} runs on CPU tensors only; on CUDA the kernels are the "
                         "only path (flash_attention=True, kv_bits and self_kv_bits 4|8)")


def attention_for_alignment(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            mask: torch.Tensor | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Multi-head attention over (batch, heads, time, head_dim) that also
    returns its fp32 softmax weights; q and k each scaled by
    ``head_dim**-0.25``. On CUDA tensors it is the route of the
    word-timestamp alignment pass (ROADMAP.md R1), reached only through
    ``decode_step(collect_cross_attn=True)``: the reference computes that
    one teacher-forced pass, fp caches and all, in XLA outside its Pallas
    kernels (``whisper_mlx_tpu/models/whisper.py:205-229``), so on the card
    it is plain tensor ops: scores by ``torch.matmul``, the mask, softmax in
    fp32, then PV."""
    scale = q.shape[-1] ** -0.25
    scores = torch.matmul(q * scale, (k * scale).transpose(-1, -2)).float()
    if mask is not None:
        scores = scores + mask
    w = torch.softmax(scores, dim=-1)
    return torch.matmul(w.to(v.dtype), v), w


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: torch.Tensor | None = None) -> torch.Tensor:
    """The parity configuration's attention (:func:`attention_for_alignment`
    without the weights). CPU tensors only."""
    _plain_on_cpu_only(q, "plain attention")
    return attention_for_alignment(q, k, v, mask)[0]


def _qkv_proj(h: torch.Tensor, attn: Params, n_head: int):
    """Self-attention q/k/v -> (b, h, t, hd) each, ``hd`` from the full
    width ``h`` carries and the model's ``n_head`` (a tensor-parallel rank
    gets its own heads). A quantized checkpoint may carry one stacked
    ``qkv`` (``ops/quant.py:fuse_whisper_qkv``): one dequant-matmul instead
    of three."""
    hd = h.shape[-1] // n_head
    if "qkv" in attn:
        q, k, v = linear(h, attn["qkv"]).chunk(3, dim=-1)
    else:
        q, k, v = (linear(h, attn[name]) for name in ("q", "k", "v"))
    return _split_heads(q, hd), _split_heads(k, hd), _split_heads(v, hd)


def mha(x: torch.Tensor, p: Params, n_head: int, use_flash: bool = False,
        mesh: Any = None) -> torch.Tensor:
    """Encoder self-attention when ``use_flash``: kernel K2 up to 2048 keys,
    kernel K4 (non-causal) above, as the reference splits it. ``mesh``: a
    tensor-parallel tree (:func:`tp_mesh`)."""
    q, k, v = _qkv_proj(x, p, n_head)
    if use_flash:
        scale = q.shape[-1] ** -0.25
        attend = dense_attention if k.shape[2] <= 2048 else flash_attention
        out = attend((q * scale).contiguous(), (k * scale).contiguous(), v.contiguous())
    else:
        out = attention(q, k, v)
    return row_linear(_merge_heads(out), p["o"], mesh)


def mlp(x: torch.Tensor, p: Params, mesh: Any = None) -> torch.Tensor:
    return row_linear(F.gelu(linear(x, p["fc1"])), p["fc2"], mesh)


def _check_tp(params: Params, config: WhisperConfig) -> Any:
    """The config's tensor-parallel mesh, checked against the tree: a
    sharded tree holds a slice of the vocabulary, and every head count
    divides over "tp"."""
    mesh = tp_mesh(config)
    emb = params.get("decoder", {}).get("token_emb")
    rows = emb.shape[0] if emb is not None else config.n_vocab
    if (mesh is not None) != (rows < config.n_vocab):
        raise ValueError(f"whisper: config.mesh {'set' if mesh else 'unset'} but the "
                         f"tree holds {rows} of {config.n_vocab} vocabulary rows "
                         "(parallel/sharding.py:shard_model pairs them)")
    if mesh is not None and (config.n_audio_head % mesh.tp or config.n_text_head % mesh.tp):
        raise ValueError(f"whisper: heads ({config.n_audio_head}, {config.n_text_head}) "
                         f"do not divide over tp={mesh.tp}")
    return mesh


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------


def encode(params: Params, mel: torch.Tensor, config: WhisperConfig) -> torch.Tensor:
    """mel (batch, 3000, n_mels) -> encoder states (batch, 1500, d)."""
    p = params["encoder"]
    mesh = _check_tp(params, config)
    x = mel.to(config.dtype)
    x = F.gelu(conv1d_nwc(x, p["conv1"], stride=1))
    x = F.gelu(conv1d_nwc(x, p["conv2"], stride=2))
    x = x + p["pos_emb"].to(x.dtype)
    for blk in p["blocks"]:
        h = layer_norm(x, blk["attn_ln"])
        x = x + mha(h, blk["attn"], config.n_audio_head, use_flash=config.flash_attention,
                    mesh=mesh)
        x = x + mlp(layer_norm(x, blk["mlp_ln"]), blk["mlp"], mesh)
    return layer_norm(x, p["ln_post"])


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------


def cross_kv(params: Params, audio_states: torch.Tensor, config: WhisperConfig) -> list[Params]:
    """Per-layer cross-attention K/V, computed once per window. With
    ``config.kv_bits`` 8 or 4 the keys (pre-scaled by head_dim**-0.25) and
    values are stored quantized with per-position scales."""
    out = []
    hd = config.n_text_state // config.n_text_head
    scale = hd ** -0.25
    for blk in params["decoder"]["blocks"]:
        k = _split_heads(linear(audio_states, blk["cross_attn"]["k"]), hd)
        v = _split_heads(linear(audio_states, blk["cross_attn"]["v"]), hd)
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
    horizon, rounded up to 128) when given; a tensor-parallel rank holds
    its own heads."""
    hd = config.n_text_state // config.n_text_head
    mesh = tp_mesh(config)
    t_alloc = config.n_text_ctx if max_len is None else min(
        -(-max_len // 128) * 128, config.n_text_ctx)
    shape = (batch, config.n_text_head // (mesh.tp if mesh else 1), t_alloc, hd)
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


def beam_flat_cache(cache: list[Params], group: int) -> list[Params]:
    """Per-lane prefilled self cache ``(n*g, H, T, ...)`` -> beam flat
    layout ``(n, H, T*g, ...)`` with row ``t*g + k`` = lane k's position t
    (``whisper_mlx_tpu/decoding/beam.py:_to_flat``). A copy; done once per
    beam decode, after the prefill."""
    names = {"k8": "k8f", "ks": "ksf", "v8": "v8f", "vs": "vsf", "k": "kf", "v": "vf"}

    def flat(a):
        nb, h, t = a.shape[:3]
        x = a.reshape(nb // group, group, h, t, *a.shape[3:]).movedim(1, 3)
        return x.reshape(nb // group, h, t * group, *a.shape[3:]).contiguous()

    return [{names[k]: flat(a) for k, a in entry.items()} for entry in cache]


def _write_beam_rows(buf: torch.Tensor, new: torch.Tensor, pos: int, group: int) -> None:
    """Write a step's ``(n*g, H, 1, ...)`` K/V (or ``(n*g, H, 1)`` scales)
    into rows ``[pos*g, pos*g + g)`` of the flat ``(n, H, T*g, ...)``."""
    nb, h = new.shape[:2]
    blk = new[:, :, 0].reshape(nb // group, group, h, *new.shape[3:]).transpose(1, 2)
    buf[:, :, pos * group:(pos + 1) * group] = blk


def _beam_self_attention(c: Params, q, k_new, v_new, pos: int, ancestry, group: int,
                         config: WhisperConfig, s_fill=None, overflow=None) -> torch.Tensor:
    """Beam self-attention of one step over the flat cache ``c`` (updated
    in place): kernel K8 for quantized caches (its split mode with
    ``s_fill``), the fp forms on the CPU."""
    if "k8f" not in c:
        _write_beam_rows(c["kf"], k_new, pos, group)
        _write_beam_rows(c["vf"], v_new, pos, group)
        if s_fill is not None:
            return attention_fp_shared(q, c["kf"], c["vf"], ancestry, s_fill, pos, group,
                                       overflow)
        return attention_fp_beamflat(q, c["kf"], c["vf"], ancestry, pos, group)
    scale = q.shape[-1] ** -0.25
    k8n, ksn = quantize_kv(k_new * scale, bits=config.self_kv_bits)
    v8n, vsn = quantize_kv(v_new, bits=config.self_kv_bits)
    for name, new in (("k8f", k8n), ("ksf", ksn), ("v8f", v8n), ("vsf", vsn)):
        _write_beam_rows(c[name], new, pos, group)
    return beamflat_attention((q * scale).contiguous(), c["k8f"], c["ksf"], c["v8f"],
                              c["vsf"], ancestry, pos, group, int_dot=config.attn_mxu,
                              s_fill=s_fill, overflow=overflow)


def decode_step(
    params: Params,
    tokens: torch.Tensor,  # (batch, t) token ids for these positions
    pos: int,  # host int: first position index of ``tokens``
    kv_cache: list[Params],
    xkv: list[Params],
    config: WhisperConfig,
    collect_cross_attn: bool = False,
    share_xkv_groups: int = 1,
    beam_ancestry: torch.Tensor | None = None,
    beam_s_fill: torch.Tensor | None = None,
    beam_window: int = 0,
    beam_overflow: torch.Tensor | None = None,
) -> tuple[torch.Tensor, list[Params]] | tuple[torch.Tensor, list[Params], torch.Tensor]:
    """Run the decoder on ``tokens`` at positions ``[pos, pos + t)``.

    Serves the prompt prefill (t = prompt length) and the incremental step
    (t = 1). Writes the new K/V into ``kv_cache`` IN PLACE and returns
    ``(logits (batch, t, vocab) fp32, kv_cache)``. ``share_xkv_groups=g``:
    ``xkv`` holds batch/g windows whose cross K/V are shared by g
    consecutive rows (best_of candidates, beam lanes). A beam flat cache
    (:func:`beam_flat_cache`) needs ``beam_ancestry (batch, T)`` int32, the
    lane owning each position of each row's hypothesis, and t = 1. Over a
    per-lane cache, ``beam_ancestry`` (t = 1) reads each position from the
    lane it names (``kv_quant.py:attention_*_ancestry``: K8's per-lane
    layout for quantized caches).

    ``beam_s_fill`` ``(batch/g,)`` int32 on the device (flat cache): the
    shared-prefix scheme's split (K8's split mode, or its fp form on the
    CPU); with the one-bool device tensor ``beam_overflow`` set it computes
    the flat function. ``beam_window``, the reference's read width of the
    divergent tail, is taken for its signature: the beam loop's overflow
    rule keeps ``[s_fill, pos]`` inside it, and the split reads exactly
    those positions, so the function does not depend on it.

    ``collect_cross_attn=True`` (the word-timestamp alignment pass) returns
    ``(logits, kv_cache, cross)`` with the cross-attention weights ``cross``
    ``(layers, batch, heads, t, n_audio_ctx)`` fp32. It takes fp caches
    only (``kv_bits=0``, ``self_kv_bits=0``, as ``find_alignment`` sets),
    one row a window, and runs both attentions through
    :func:`attention_for_alignment` on any device. Under tensor parallelism
    the weights of every rank's heads are gathered over "tp".
    """
    p = params["decoder"]
    mesh = _check_tp(params, config)
    b, t = tokens.shape
    end = pos + t
    g = share_xkv_groups
    hd = config.n_text_state // config.n_text_head
    x = embed_tokens(p["token_emb"], tokens, config.dtype, mesh, config.n_vocab)
    x = x + p["pos_emb"][pos:end].to(config.dtype)

    beam_flat = "k8f" in kv_cache[0] or "kf" in kv_cache[0]
    if beam_flat and (beam_ancestry is None or t != 1):
        raise ValueError("decode_step: the beam flat cache takes one position and "
                         "beam_ancestry")
    quant_self = "k8" in kv_cache[0]
    if beam_ancestry is not None and t != 1:
        raise ValueError("decode_step: beam_ancestry takes one position")
    if (beam_s_fill is not None or beam_overflow is not None) and not beam_flat:
        raise ValueError("decode_step: beam_s_fill takes the beam flat cache")
    # the reference's time-major layouts take its fp32 branches
    self_tmajor = quant_self and config.self_kv_layout == "tmajor"
    if self_tmajor and beam_ancestry is not None:
        raise ValueError("decode_step: the time-major self cache has no ancestry mode")
    self_int_dot = config.attn_mxu and not self_tmajor
    cross_int_dot = config.attn_mxu and config.kv_layout != "tmajor"
    if collect_cross_attn and (quant_self or beam_flat or g > 1
                               or any("k8" in xc for xc in xkv)):
        raise ValueError("decode_step(collect_cross_attn=True) takes fp self and cross "
                         "caches (kv_bits=0, self_kv_bits=0) and one row a window")
    cross_weights = []
    if not quant_self and not beam_flat:
        q_idx = torch.arange(t, device=x.device)[:, None] + pos
        k_idx = torch.arange(end, device=x.device)[None, :]
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        mask = torch.where(k_idx <= q_idx, zero, float("-inf"))

    for i, blk in enumerate(p["blocks"]):
        h = layer_norm(x, blk["attn_ln"])
        q, k_new, v_new = _qkv_proj(h, blk["attn"], config.n_text_head)
        c = kv_cache[i]
        scale = q.shape[-1] ** -0.25
        if beam_flat:
            attn_out = _beam_self_attention(c, q, k_new, v_new, pos, beam_ancestry, g, config,
                                            beam_s_fill, beam_overflow)
        elif quant_self:
            k8n, ksn = quantize_kv(k_new * scale, bits=config.self_kv_bits)
            v8n, vsn = quantize_kv(v_new, bits=config.self_kv_bits)
            c["k8"][:, :, pos:end] = k8n
            c["ks"][:, :, pos:end] = ksn
            c["v8"][:, :, pos:end] = v8n
            c["vs"][:, :, pos:end] = vsn
            if beam_ancestry is not None:
                attn_out = ancestry_attention((q * scale).contiguous(), c["k8"], c["ks"],
                                              c["v8"], c["vs"], beam_ancestry, pos, g)
            else:
                attn_out = decode_attention((q * scale).contiguous(), c["k8"], c["ks"],
                                            c["v8"], c["vs"], pos=pos, causal=True,
                                            int_dot=self_int_dot)
        else:
            c["k"][:, :, pos:end] = k_new
            c["v"][:, :, pos:end] = v_new
            k_live, v_live = c["k"][:, :, :end], c["v"][:, :, :end]
            if beam_ancestry is not None:
                attn_out = attention_fp_ancestry(q, c["k"], c["v"], beam_ancestry, pos, g)
            elif collect_cross_attn:
                attn_out, _ = attention_for_alignment(q, k_live, v_live, mask)
            else:
                attn_out = attention(q, k_live, v_live, mask)
        x = x + row_linear(_merge_heads(attn_out), blk["attn"]["o"], mesh)

        h = layer_norm(x, blk["cross_attn_ln"])
        qx = _split_heads(linear(h, blk["cross_attn"]["q"]), hd)
        xc = xkv[i]
        if "k8" in xc:
            qs = (qx * scale).contiguous()
            cross_out = decode_attention(qs, xc["k8"], xc["ks"], xc["v8"], xc["vs"],
                                         valid_len=config.n_audio_ctx, group=g,
                                         int_dot=cross_int_dot)
        elif g > 1:
            _plain_on_cpu_only(qx, "plain grouped cross attention")
            n = b // g
            qx5 = (qx * scale).float().reshape(n, g, *qx.shape[1:])
            s5 = torch.einsum("nghqd,nhkd->nghqk", qx5, (xc["k"] * scale).float())
            w5 = torch.softmax(s5, dim=-1).to(xc["v"].dtype)
            cross_out = torch.einsum("nghqk,nhkd->nghqd", w5, xc["v"])
            cross_out = cross_out.reshape(qx.shape).to(qx.dtype)
        elif collect_cross_attn:
            cross_out, cw = attention_for_alignment(qx, xc["k"], xc["v"])
            cross_weights.append(all_gather_cat(cw, mesh, "tp", dim=1) if mesh else cw)
        else:
            cross_out = attention(qx, xc["k"], xc["v"])
        x = x + row_linear(_merge_heads(cross_out), blk["cross_attn"]["o"], mesh)
        x = x + mlp(layer_norm(x, blk["mlp_ln"]), blk["mlp"], mesh)

    x = layer_norm(x, p["ln"])
    logits = embed_logits(p["token_emb"], x, config.dtype, mesh, config.n_vocab).float()
    if collect_cross_attn:
        return logits, kv_cache, torch.stack(cross_weights)
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
