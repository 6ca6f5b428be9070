"""The reference's whisper opt-ins: the time-major KV layouts
(``WTPU_SELF_KV_LAYOUT`` / ``WTPU_KV_LAYOUT`` = ``tmajor``, ROADMAP M15,
which the port takes as a config field each) and the schedule and lowering
knobs the port drops on purpose leave the tokens unchanged: each case
decodes the tiny config with the JAX package with the knob off and on,
shows that the knob reached the code it steers, and holds both token lists
against the port's on the same weights with the knob set.

Tiny config, random weights from a seed, CPU; the reference's Pallas
decode-attention kernel runs in interpret mode.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import torch  # noqa: F401  (torch before jax: the reverse order has deadlocked)
import jax
import jax.numpy as jnp

from whisper_mlx_tpu.decoding import task as j_task
from whisper_mlx_tpu.decoding import tokenizer as j_tokenizer
from whisper_mlx_tpu.models import whisper as jw
from whisper_mlx_tpu.ops import decode_attention as jda
from whisper_mlx_tpu.ops import kv_quant as jkv
from whisper_mlx_tpu.ops import quant as jq
from whisper_mlx_tpu_torch.checkpoint.convert import params_from_jax
from whisper_mlx_tpu_torch.decoding import task as t_task
from whisper_mlx_tpu_torch.decoding import tokenizer as t_tokenizer
from whisper_mlx_tpu_torch.models import whisper as tw

DIMS = dict(n_mels=80, n_audio_state=64, n_audio_head=4, n_audio_layer=2,
            n_text_state=64, n_text_head=4, n_text_layer=2, kv_bits=8, self_kv_bits=8)
# a horizon of 3 + 64 tokens: the ladder 8, 16, 32 grows the cache three times
SAMPLE_LEN = 64


@pytest.fixture(scope="module")
def tiny():
    """(numpy weights, JAX config, port config, mel)."""
    tok = j_tokenizer.make_synthetic_tokenizer()
    jcfg = jw.WhisperConfig(n_vocab=tok.n_vocab, **DIMS)
    tcfg = tw.WhisperConfig(n_vocab=tok.n_vocab, **DIMS)
    tree = jax.tree.map(np.asarray, jw.init_params(jcfg, seed=0))
    mel = np.random.default_rng(0).standard_normal((1, 3000, 80)).astype(np.float32)
    return tree, jcfg, tcfg, mel


def _jax_tokens(params, cfg, mel):
    jax.clear_caches()  # the knobs are read when the decode is traced
    out = j_task.decode(params, jnp.asarray(mel), j_tokenizer.make_synthetic_tokenizer(), cfg,
                        j_task.DecodingOptions(sample_len=SAMPLE_LEN))
    jax.clear_caches()
    return out[0].tokens


def _port_tokens(params, cfg, mel):
    return t_task.decode(params, torch.from_numpy(mel), t_tokenizer.make_synthetic_tokenizer(),
                         cfg, t_task.DecodingOptions(sample_len=SAMPLE_LEN))[0].tokens


def _spy_greedy(monkeypatch, key):
    """Record the static argument ``key`` the reference's decode passes on."""
    seen = []
    greedy = j_task.greedy_decode
    monkeypatch.setattr(j_task, "greedy_decode",
                        lambda *a, **kw: seen.append(kw[key]) or greedy(*a, **kw))
    return seen


def _decode_attn_kernel(monkeypatch):
    """The Pallas decode-attention kernel (interpreted) wherever the
    reference's config asks for it: its TPU branch, taken on the CPU."""
    calls = []
    auto = jkv.attention_int8_auto

    def attention(q, k8t, ks, v8t, vs, pos=0, causal=False, valid_len=None, kernel=False):
        if not kernel:
            return auto(q, k8t, ks, v8t, vs, pos=pos, causal=causal, valid_len=valid_len)
        calls.append(k8t.shape)
        return jda.decode_attention_int8(q, k8t, ks, v8t, vs, pos=pos, causal=causal,
                                         valid_len=valid_len, interpret=True)

    monkeypatch.setattr(jkv, "attention_int8_auto", attention)
    return calls


def _tmajor_calls(monkeypatch, field):
    """Count the reference's time-major attentions of ``field``'s cache."""
    calls = []
    name = "attention_int8_tmajor" + ("" if field == "self_kv_layout" else "_cross")
    real = getattr(jkv, name)
    monkeypatch.setattr(jkv, name, lambda q, *a, **kw: calls.append(q.shape) or real(q, *a, **kw))
    return calls


def _native_matmuls(monkeypatch):
    """Count the reference's native-code matmuls (where WTPU_QMM is read)."""
    calls = []
    native = jq.native_group_matmul
    monkeypatch.setattr(jq, "native_group_matmul",
                        lambda x, q: calls.append(x.shape) or native(x, q))
    return calls


def _prepared_native(jtree):
    return jax.jit(lambda p: jq.prepare_native_params(p, embed_dtype=jnp.float32))(jtree)


@pytest.mark.parametrize("name,value", [
    ("WTPU_SELF_KV_LAYOUT", "tmajor"), ("WTPU_KV_LAYOUT", "tmajor"),
    # the growing-cache phase ladder, and one exact-horizon allocation
    ("WTPU_SELF_PHASES", "8,16,32"), ("WTPU_SELF_PHASES", ""),
    # the greedy loop's unroll
    ("WTPU_DECODE_UNROLL", "4"),
    # the decode-attention kernel switch (K3 is the port's only route)
    ("WTPU_DECODE_ATTN_KERNEL", "1"),
    # the epilogue of the matmul over native 4-bit codes
    ("WTPU_QMM", "reduce"),
])
def test_reference_opt_ins(monkeypatch, tiny, name, value):
    tree, jcfg, tcfg, mel = tiny
    jparams = jax.tree.map(jnp.asarray, tree)
    if name == "WTPU_QMM":
        # the knob steers native_group_matmul alone, which only a tree made
        # by prepare_native_params reaches (a layout the port does not have,
        # M15): the reference decodes that tree, the port the 4-bit tree it
        # comes from, whose codes it re-encodes exactly
        qtree = jq.quantize_params(jparams, bits=4, group_size=64)
        tparams = params_from_jax(jax.tree.map(np.asarray, qtree), tcfg)
        jparams = _prepared_native(qtree)
    else:
        tparams = params_from_jax(tree, tcfg)
    off = _jax_tokens(jparams, jcfg, mel)
    monkeypatch.setenv(name, value)
    if name == "WTPU_SELF_PHASES":
        seen = _spy_greedy(monkeypatch, "phases")
        want = tuple(int(x) for x in value.split(",") if x)
    elif name == "WTPU_DECODE_UNROLL":
        seen, want = _spy_greedy(monkeypatch, "unroll"), int(value)
    elif name == "WTPU_DECODE_ATTN_KERNEL":
        # read once when the reference's model module is imported, as the
        # default of this field: set the field the knob sets
        jcfg = dataclasses.replace(jcfg, decode_attn_kernel=True)
        seen = _decode_attn_kernel(monkeypatch)
    elif value == "tmajor":
        # read at each package's import as its field's default: set the
        # field in both; the port's caches stay position-major (K3's fp mode)
        field = name.lower().removeprefix("wtpu_")
        jcfg = dataclasses.replace(jcfg, **{field: value})
        tcfg = dataclasses.replace(tcfg, **{field: value})
        seen = _tmajor_calls(monkeypatch, field)
    else:
        seen = _native_matmuls(monkeypatch)
    on = _jax_tokens(jparams, jcfg, mel)
    assert seen
    if name in ("WTPU_SELF_PHASES", "WTPU_DECODE_UNROLL"):
        assert seen == [want]
    elif name == "WTPU_DECODE_ATTN_KERNEL":
        # self and cross caches padded to the 128 lane tile (1500 -> 1536 keys)
        assert {s[-1] for s in seen} == {128, 1536}
    got = _port_tokens(tparams, tcfg, mel)
    assert len(off) > 32 and on == off == got  # the decode ran past the ladder's last rung
