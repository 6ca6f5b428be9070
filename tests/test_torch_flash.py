"""Port parity: the flash attention (kernel K4's plain version) of
whisper_mlx_tpu_torch against the JAX package's Pallas kernel in interpret
mode on the CPU, and the whisper encoder attention over more than 2048 keys,
which both packages send to that kernel. The Hopper kernel itself is tested
against the plain version in tests/test_torch_kernels.py."""

from __future__ import annotations

from unittest import mock

import numpy as np
import pytest

import torch  # noqa: F401  (torch before jax, as in the other test files)
import jax
import jax.numpy as jnp

from whisper_mlx_tpu.models import whisper as jw
from whisper_mlx_tpu.ops import flash_attention as j_fa
from whisper_mlx_tpu_torch.checkpoint.convert import params_from_jax
from whisper_mlx_tpu_torch.models import whisper as tw
from whisper_mlx_tpu_torch.ops import flash_attention as fa

# fp32 on both sides; the online softmax and the one-pass softmax round
# differently at ~1e-7 relative
TOL = 2e-5


def _jax_flash(q, k, v, causal):
    return np.asarray(j_fa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           causal=causal, interpret=True, tile_q=8,
                                           tile_k=128))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("tq,tk", [(37, 37), (130, 130), (37, 130)])
def test_flash_plain_matches_pallas(causal, tq, tk):
    rng = np.random.default_rng(tq + tk)
    s = 32 ** -0.25
    q = (rng.standard_normal((2, 3, tq, 32)) * s).astype(np.float32)
    k = (rng.standard_normal((2, 3, tk, 32)) * s).astype(np.float32)
    v = rng.standard_normal((2, 3, tk, 32)).astype(np.float32)
    ref = _jax_flash(q, k, v, causal)
    got = fa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_gqa_matches_repeated_heads(causal):
    """KV heads given once; the reference kernel sees them repeated."""
    rng = np.random.default_rng(7)
    h, kvh, t, hd = 8, 2, 130, 16
    s = hd ** -0.25
    q = (rng.standard_normal((1, h, t, hd)) * s).astype(np.float32)
    k = (rng.standard_normal((1, kvh, t, hd)) * s).astype(np.float32)
    v = rng.standard_normal((1, kvh, t, hd)).astype(np.float32)
    ref = _jax_flash(q, np.repeat(k, h // kvh, axis=1), np.repeat(v, h // kvh, axis=1), causal)
    got = fa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=TOL)


def test_flash_rejects_mismatched_heads():
    q = torch.zeros(1, 6, 4, 16)
    kv = torch.zeros(1, 4, 4, 16)  # 6 query heads over 4 KV heads
    with pytest.raises(ValueError, match="do not match"):
        fa.flash_attention(q, kv, kv)


def test_cpu_wrapper_uses_plain_version():
    q = torch.randn(1, 4, 9, 16, dtype=torch.bfloat16)
    kv = torch.randn(1, 2, 9, 16, dtype=torch.bfloat16)
    before = fa.LAUNCHES
    got = fa.flash_attention(q, kv, kv, causal=True)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, fa.flash_attention_plain(q, kv, kv, causal=True))
    assert fa.LAUNCHES == before


def test_whisper_mha_over_2048_keys_matches_jax_flash():
    """Encoder attention over 2100 keys: the port's mha takes K4's function
    (it raised before), the reference's the Pallas flash kernel."""
    dims = dict(n_mels=80, n_vocab=300, n_audio_state=64, n_audio_head=4, n_audio_layer=1,
                n_text_state=64, n_text_head=4, n_text_layer=1)
    tree = jax.tree.map(np.asarray, jw.init_params(jw.WhisperConfig(**dims), seed=3))
    tparams = params_from_jax(tree, tw.WhisperConfig(**dims))
    attn_j = jax.tree.map(jnp.asarray, tree["encoder"]["blocks"][0]["attn"])
    x = np.random.default_rng(8).standard_normal((1, 2100, 64)).astype(np.float32)
    orig = j_fa.flash_attention

    def interp(q, k, v, **kw):  # the Pallas kernel in interpret mode on the CPU
        return orig(q, k, v, **{**kw, "interpret": True, "tile_q": 256, "tile_k": 512})

    with mock.patch.object(j_fa, "flash_attention", interp):
        ref, _ = jw.mha(jnp.asarray(x), jnp.asarray(x), attn_j, 4, use_flash=True)
    before = fa.LAUNCHES
    got = tw.mha(torch.from_numpy(x), tparams["encoder"]["blocks"][0]["attn"], 4,
                 use_flash=True)
    assert fa.LAUNCHES == before  # CPU tensors: the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
