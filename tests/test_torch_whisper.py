"""Port parity: the whisper model of whisper_mlx_tpu_torch against the JAX
package at fp32 on the CPU (converter, encoder, prefill and incremental
decode steps), on a 64-wide, 2-layer config with randomized biases and
LayerNorm parameters so every tensor's layout is exercised."""

from __future__ import annotations

import dataclasses
from unittest import mock

import numpy as np
import pytest

import torch  # noqa: F401  (torch before jax: see CLAUDE.md)
import jax
import jax.numpy as jnp

from whisper_mlx_tpu.models import whisper as jw
from whisper_mlx_tpu.ops import dense_attention as j_da
from whisper_mlx_tpu_torch.checkpoint.convert import params_from_jax
from whisper_mlx_tpu_torch.models import whisper as tw

DIMS = dict(n_mels=80, n_vocab=300, n_audio_state=64, n_audio_head=4, n_audio_layer=2,
            n_text_state=64, n_text_head=4, n_text_layer=2)
TOL = 1e-4


def _perturb(tree, rng):
    """Randomize biases and LayerNorm gains so a wrong layout shows."""
    if isinstance(tree, dict):
        return {k: (_perturb(v, rng) if isinstance(v, (dict, list))
                    else (1.0 + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
                    if k == "g"
                    else (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
                    if k == "b" else np.asarray(v))
                for k, v in tree.items()}
    return [_perturb(v, rng) for v in tree]


@pytest.fixture(scope="module")
def pair():
    jcfg = jw.WhisperConfig(**DIMS)
    tree = _perturb(jax.tree.map(np.asarray, jw.init_params(jcfg, seed=1)),
                    np.random.default_rng(1))
    jparams = jax.tree.map(jnp.asarray, tree)
    tcfg = tw.WhisperConfig(**DIMS)
    return tree, jparams, jcfg, params_from_jax(tree, tcfg), tcfg


def test_converter_layouts(pair):
    tree, _, _, tparams, _ = pair
    enc, tenc = tree["encoder"], tparams["encoder"]
    np.testing.assert_array_equal(tenc["conv1"]["w"].numpy(),
                                  enc["conv1"]["w"].transpose(2, 1, 0))
    np.testing.assert_array_equal(tenc["blocks"][1]["mlp"]["fc1"]["w"].numpy(),
                                  enc["blocks"][1]["mlp"]["fc1"]["w"].T)
    np.testing.assert_array_equal(tenc["blocks"][0]["attn_ln"]["g"].numpy(),
                                  enc["blocks"][0]["attn_ln"]["g"])
    dec, tdec = tree["decoder"], tparams["decoder"]
    np.testing.assert_array_equal(tdec["token_emb"].numpy(), dec["token_emb"])
    np.testing.assert_array_equal(tdec["blocks"][0]["cross_attn"]["k"]["w"].numpy(),
                                  dec["blocks"][0]["cross_attn"]["k"]["w"].T)
    assert "b" not in tdec["blocks"][0]["cross_attn"]["k"]


@pytest.mark.parametrize("mutate,error", [
    ("unknown_key", ValueError), ("missing", ValueError),
    ("fused_qkv", ValueError), ("int_leaf", NotImplementedError),
])
def test_converter_rejects_unknown(pair, mutate, error):
    tree, _, _, _, tcfg = pair
    bad = jax.tree.map(lambda a: a, tree)
    attn = bad["decoder"]["blocks"][0]["attn"]
    if mutate == "unknown_key":
        bad["encoder"]["extra"] = np.zeros(3, np.float32)
    elif mutate == "fused_qkv":  # a fused projection beside the three it replaces
        attn["qkv"] = {"w": np.zeros((64, 192), np.float32)}
    elif mutate == "int_leaf":
        attn["q"]["w"] = np.zeros((64, 64), np.int8)
    else:
        del attn["o"]
    with pytest.raises(error, match="params_from_jax"):
        params_from_jax(bad, tcfg)


def test_configs_and_sinusoids_match_jax():
    dims = [f.name for f in dataclasses.fields(tw.WhisperConfig) if f.name.startswith("n_")]
    assert sorted(tw.WHISPER_CONFIGS) == sorted(jw.WHISPER_CONFIGS)
    for name, tcfg in tw.WHISPER_CONFIGS.items():
        jcfg = jw.WHISPER_CONFIGS[name]
        assert {d: getattr(tcfg, d) for d in dims} == {d: getattr(jcfg, d) for d in dims}, name
    np.testing.assert_array_equal(tw.sinusoids(1500, 64), np.asarray(jw.sinusoids(1500, 64)))


def test_init_params_matches_converter_layout(pair):
    _, _, _, tparams, tcfg = pair
    fresh = tw.init_params(tcfg, seed=0)
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)  # noqa: E731
    assert shapes(fresh) == shapes(tparams)


@pytest.mark.parametrize("flash", [False, True])
def test_encode_matches_jax(pair, flash):
    _, jparams, jcfg, tparams, tcfg = pair
    mel = np.random.default_rng(0).standard_normal((1, 3000, 80)).astype(np.float32)
    jcfg = dataclasses.replace(jcfg, flash_attention=flash)
    tcfg = dataclasses.replace(tcfg, flash_attention=flash)
    orig = j_da.dense_attention

    def interp(q, k, v, **kw):  # the Pallas kernel in interpret mode on the CPU
        return orig(q, k, v, **{**kw, "interpret": True})

    with mock.patch.object(j_da, "dense_attention", interp):
        ref = np.asarray(jw.encode(jparams, jnp.asarray(mel), jcfg))
    got = tw.encode(tparams, torch.from_numpy(mel), tcfg).numpy()
    assert got.shape == (1, 1500, 64)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("kv_bits,self_kv_bits", [(0, 0), (4, 8), (8, 4)])
def test_decode_steps_match_jax(pair, kv_bits, self_kv_bits):
    """Prefill of 3 tokens, then 6 incremental steps; logits each step."""
    _, jparams, jcfg, tparams, tcfg = pair
    jcfg = dataclasses.replace(jcfg, kv_bits=kv_bits, self_kv_bits=self_kv_bits)
    tcfg = dataclasses.replace(tcfg, kv_bits=kv_bits, self_kv_bits=self_kv_bits)
    rng = np.random.default_rng(4)
    states = rng.standard_normal((2, 1500, 64)).astype(np.float32)
    toks = rng.integers(0, DIMS["n_vocab"], size=(2, 9)).astype(np.int32)

    jx = jw.cross_kv(jparams, jnp.asarray(states), jcfg)
    jc = jw.init_kv_cache(jcfg, 2, max_len=20)
    tx = tw.cross_kv(tparams, torch.from_numpy(states), tcfg)
    tc = tw.init_kv_cache(tcfg, 2, "cpu", max_len=20)
    # fp caches: 1e-4. Quantized caches: the two frameworks' K/V differ by
    # ~1e-7, and a value that close to a rounding tie flips one code by one
    # grid step (observed: 1 of ~2000 self-cache codes by step 5), which
    # moves these logits by up to ~1e-3; quantize_kv itself is bit-exact
    # (tests/test_torch_attention.py).
    tol = TOL if self_kv_bits == 0 else 2e-3
    steps = [(0, 3)] + [(p, p + 1) for p in range(3, 9)]
    for a, b in steps:
        jl, jc, _ = jw.decode_step(jparams, jnp.asarray(toks[:, a:b]), jnp.int32(a), jc, jx, jcfg)
        tl, tc = tw.decode_step(tparams, torch.from_numpy(toks[:, a:b]).long(), a, tc, tx, tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL if a == 0 else tol,
                                   rtol=TOL, err_msg=f"positions [{a}, {b})")
    # the kernels take contiguous caches only (checked on the card)
    if kv_bits:
        assert all(t.is_contiguous() for layer in tx for t in layer.values())
    if self_kv_bits:
        assert all(t.is_contiguous() for layer in tc for t in layer.values())


def test_decode_step_grouped_cross_matches_jax(pair):
    """best_of: 3 rows share each window's int4 cross cache (g = 3)."""
    _, jparams, jcfg, tparams, tcfg = pair
    jcfg = dataclasses.replace(jcfg, kv_bits=4, self_kv_bits=8)
    tcfg = dataclasses.replace(tcfg, kv_bits=4, self_kv_bits=8)
    rng = np.random.default_rng(5)
    states = rng.standard_normal((2, 1500, 64)).astype(np.float32)
    toks = rng.integers(0, DIMS["n_vocab"], size=(6, 3)).astype(np.int32)
    jl, _, _ = jw.decode_step(jparams, jnp.asarray(toks), jnp.int32(0),
                              jw.init_kv_cache(jcfg, 6, max_len=8),
                              jw.cross_kv(jparams, jnp.asarray(states), jcfg), jcfg,
                              share_xkv_groups=3)
    tl, _ = tw.decode_step(tparams, torch.from_numpy(toks).long(), 0,
                           tw.init_kv_cache(tcfg, 6, "cpu", max_len=8),
                           tw.cross_kv(tparams, torch.from_numpy(states), tcfg), tcfg,
                           share_xkv_groups=3)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)


def test_decode_step_collect_cross_attn_raises(pair):
    """The alignment pass takes fp caches: with a quantized self cache the
    weights are refused (tests/test_torch_word_timestamps.py holds the fp
    pass against JAX's)."""
    _, _, _, tparams, tcfg = pair
    qcfg = dataclasses.replace(tcfg, self_kv_bits=8)
    with pytest.raises(ValueError, match="collect_cross_attn"):
        tw.decode_step(tparams, torch.zeros((1, 1), dtype=torch.long), 0,
                       tw.init_kv_cache(qcfg, 1, "cpu"), [], qcfg, collect_cross_attn=True)
