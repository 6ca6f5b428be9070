"""Port parity: attention kernels' plain versions and the quantized KV cache
of whisper_mlx_tpu_torch against the JAX package (Pallas kernels in
interpret mode, XLA paths) on the CPU. The Hopper kernels themselves are
tested against these plain versions in tests/test_torch_kernels.py."""

from __future__ import annotations

import numpy as np
import pytest

import torch  # noqa: F401  (torch before jax: see CLAUDE.md)
import jax.numpy as jnp

from whisper_mlx_tpu.ops.decode_attention import decode_attention_int8
from whisper_mlx_tpu.ops.dense_attention import dense_attention as j_dense
from whisper_mlx_tpu.ops.kv_quant import attention_int8_auto as j_auto
from whisper_mlx_tpu.ops.kv_quant import attention_int8_grouped as j_grouped
from whisper_mlx_tpu.ops.kv_quant import quantize_kv as j_quantize
from whisper_mlx_tpu_torch.ops import decode_attention as da
from whisper_mlx_tpu_torch.ops import dense_attention as dn
from whisper_mlx_tpu_torch.ops import kv_quant as kq


def _attn_tol(ref) -> float:
    # kernels round the softmax weights to bf16 before the PV product
    return 2e-2 * max(1.0, float(np.abs(np.asarray(ref, np.float32)).max()))


# ---------------------------------------------------------------------------
# K2 dense attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 3e-2)])
def test_dense_plain_matches_pallas(dtype, tol):
    rng = np.random.default_rng(6)
    b, h, tq, tk, hd = 1, 3, 130, 200, 64
    q = rng.standard_normal((b, h, tq, hd)).astype(np.float32) * 0.35
    k = rng.standard_normal((b, h, tk, hd)).astype(np.float32) * 0.35
    v = rng.standard_normal((b, h, tk, hd)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    ref = np.asarray(j_dense(jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                             interpret=True).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = dn.dense_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), ref, atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# quantize_kv and the int4 packing
# ---------------------------------------------------------------------------


def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_kv_bit_identical_with_ties(bits):
    """Codes and bf16 scales equal JAX's, including exact .5 ties, which both
    round half to even."""
    rng = np.random.default_rng(bits)
    qmax = 127 if bits == 8 else 7
    x = rng.standard_normal((2, 3, 40, 64)).astype(np.float32)
    # rows 0..19: every non-max element sits exactly on a .5 tie of the grid
    absmax = np.abs(x[:, :, :20]).max(-1, keepdims=True) + 1.0
    scale = _bf16(np.maximum(absmax / qmax, 1e-8) * np.float32(1.0 + 2.0 ** -8))
    k = rng.integers(-qmax, qmax - 1, size=x[:, :, :20].shape)
    tie = ((k + 0.5) * scale).astype(np.float32)
    tie[..., 0] = absmax[..., 0]
    x[:, :, :20] = tie
    assert np.all((tie[..., 1:] / scale) % 1 == 0.5)

    jc, js = j_quantize(jnp.asarray(x), bits=bits)
    jc = np.asarray(jc.astype(jnp.int8))
    js = np.asarray(js.astype(jnp.float32))[..., 0]
    tc, ts = kq.quantize_kv(torch.from_numpy(x), bits=bits)
    assert ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(ts.float().numpy(), js)
    codes = kq.unpack_int4(tc) if bits == 4 else tc
    assert tc.dtype == (torch.uint8 if bits == 4 else torch.int8)
    np.testing.assert_array_equal(codes.numpy(), jc)
    # half-to-even really happened on the tie rows
    np.testing.assert_array_equal(jc[:, :, :20, 1:], np.round(k[..., 1:] + 0.5))


def test_int4_pack_roundtrip():
    codes = torch.from_numpy(
        np.random.default_rng(0).integers(-8, 8, size=(2, 3, 5, 64)).astype(np.int8))
    packed = kq.pack_int4(codes)
    assert packed.shape == (2, 3, 5, 32) and packed.dtype == torch.uint8
    # low nibble = even d, high nibble = odd d
    assert int(packed[0, 0, 0, 0]) == (int(codes[0, 0, 0, 0]) & 0xF) | (
        (int(codes[0, 0, 0, 1]) & 0xF) << 4)
    assert torch.equal(kq.unpack_int4(packed), codes)


# ---------------------------------------------------------------------------
# K3 decode attention: plain version against the JAX package
# ---------------------------------------------------------------------------


def _cache(rng, b, h, tk_real, tk, bits=8, hd=64):
    """JAX time-minor cache and the port's position-major one, same codes."""
    k = np.zeros((b, h, tk, hd), np.float32)
    v = np.zeros((b, h, tk, hd), np.float32)
    k[:, :, :tk_real] = rng.standard_normal((b, h, tk_real, hd))
    v[:, :, :tk_real] = rng.standard_normal((b, h, tk_real, hd))
    k8, ks = j_quantize(jnp.asarray(k), bits=bits)
    v8, vs = j_quantize(jnp.asarray(v), bits=bits)
    jax_cache = (jnp.swapaxes(k8, 2, 3), ks, jnp.swapaxes(v8, 2, 3), vs)

    def port(codes, scale):
        c = torch.from_numpy(np.array(codes.astype(jnp.int8)))
        if bits == 4:
            c = kq.pack_int4(c)
        return c, torch.from_numpy(np.array(scale.astype(jnp.float32))[..., 0]).to(
            torch.bfloat16)

    return jax_cache, (*port(k8, ks), *port(v8, vs))


@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "tq,causal,pos,tk_real,tk",
    [
        (1, False, 0, 333, 384),   # cross-attention, padded Tk
        (1, True, 17, 448, 512),   # self-attention mid-decode
        (1, True, 0, 448, 512),    # first step
        (7, True, 4, 448, 512),    # prefill chunk
        (12, False, 0, 120, 128),  # prefill-sized cross
    ],
)
def test_decode_plain_matches_pallas(tq, causal, pos, tk_real, tk, qdtype):
    rng = np.random.default_rng(0)
    b, h = 2, 3
    jc, tc = _cache(rng, b, h, tk_real, tk)
    q = (rng.standard_normal((b, h, tq, 64)) * 0.3).astype(np.float32)
    qd = jnp.dtype(qdtype)
    ref = np.asarray(decode_attention_int8(
        jnp.asarray(q, qd), *jc, pos=pos, causal=causal, valid_len=tk_real, bh_tile=2,
        interpret=True).astype(jnp.float32))
    got = da.decode_attention(torch.from_numpy(q).to(getattr(torch, qdtype)), *tc,
                              pos=pos, causal=causal, valid_len=tk_real)
    np.testing.assert_allclose(got.float().numpy(), ref, atol=_attn_tol(ref))


def test_decode_plain_int4_matches_auto():
    rng = np.random.default_rng(2)
    jc, tc = _cache(rng, 2, 3, 1500, 1500, bits=4)
    q = (rng.standard_normal((2, 3, 3, 64)) * 0.3).astype(np.float32)
    ref = np.asarray(j_auto(jnp.asarray(q), *jc, valid_len=1500))
    got = kq.attention_int8_auto(torch.from_numpy(q), *tc, valid_len=1500)
    np.testing.assert_allclose(got.numpy(), ref, atol=_attn_tol(ref))


def test_decode_plain_grouped_int4_matches_jax():
    """best_of: 5 query rows per window share one int4 cross cache."""
    rng = np.random.default_rng(3)
    n, g = 2, 5
    jc, tc = _cache(rng, n, 3, 1500, 1500, bits=4)
    q = (rng.standard_normal((n, g, 3, 1, 64)) * 0.3).astype(np.float32)
    ref = np.asarray(j_grouped(jnp.asarray(q), *jc, valid_len=1500)).reshape(n * g, 3, 1, 64)
    got = kq.attention_int8_grouped(torch.from_numpy(q.reshape(n * g, 3, 1, 64)), *tc,
                                    group=g, valid_len=1500)
    np.testing.assert_allclose(got.numpy(), ref, atol=_attn_tol(ref))


def test_cpu_wrappers_use_plain_versions():
    """On CPU tensors the wrappers run the plain versions: no launch."""
    before = (dn.LAUNCHES, da.LAUNCHES)
    q = torch.randn(1, 2, 4, 64, dtype=torch.bfloat16)
    assert torch.equal(dn.dense_attention(q, q, q), dn.dense_attention_plain(q, q, q))
    c8, s = kq.quantize_kv(torch.randn(1, 2, 8, 64))
    assert torch.equal(da.decode_attention(q, c8, s, c8, s, pos=4, causal=True),
                       da.decode_attention_plain(q, c8, s, c8, s, pos=4, causal=True))
    assert (dn.LAUNCHES, da.LAUNCHES) == before
