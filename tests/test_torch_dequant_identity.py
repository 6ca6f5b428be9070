"""The arithmetic that the few-row dequant-matmuls K5 (csrc/quant_matmul.cu)
and K6 (csrc/quant_matmul_mb.cu) rest on, checked on the CPU: no GPU runs
these kernels here, so their two identities are held in numpy and torch.

1. Dequantization in one bf16x2 FMA: a mask-and-or makes the bf16 bit
   pattern 0x4300 | c, which is 128 + c, and one FMA with (s, -128 s) gives
   round_bf16((128 + c) * s - 128 * s) = round_bf16(c * s), the reference's
   rounding, for every 4-bit code c and every finite bf16 scale s with
   128 s in range. The FMA is exact before its one rounding, so it is
   computed in float64 and rounded once.
2. The permuted k order of the mma tiles: a lane's pairs of k are the
   nibbles (i, i + 4) of a word, and x is laid out the same way, so the
   tiles' products equal the natural-order dot product. Checked with values
   whose float64 sums are exact, for K5's tile (the weights as the mma's A,
   x as B, over a 128-k block) and K6's (x as A, the weights as B, 16 k).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch


def _bf16_values() -> np.ndarray:
    """Every finite bf16 value, as float64."""
    vals = (np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)
    return vals[np.isfinite(vals)].astype(np.float64)


def _round_bf16(x: np.ndarray) -> np.ndarray:
    """float64 -> the nearest bf16 (ties to even), once, as float64;
    subnormals on bf16's grid of 2^-133."""
    x = np.asarray(x, dtype=np.float64)
    _, exp = np.frexp(x)  # x = m * 2^exp, 0.5 <= |m| < 1
    exp = np.maximum(exp, -125)  # below bf16's smallest normal: the subnormal grid
    return np.ldexp(np.rint(np.ldexp(x, 8 - exp)), exp - 8)


def _fp32_bits_hi(x: np.ndarray) -> np.ndarray:
    """The high 16 bits of fp32 x: its bf16 pattern when x is a bf16 value."""
    return np.asarray(x, dtype=np.float32).view(np.uint32) >> 16


def _bf16_from_bits(bits: np.ndarray) -> np.ndarray:
    return (np.asarray(bits, dtype=np.uint32) << 16).view(np.float32).astype(np.float64)


def test_round_bf16_matches_torch_on_fp32_values():
    """The float64 rounding above is torch's fp32 -> bf16 cast on values
    that fp32 holds exactly (the plain versions round that way)."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(20000) * 10.0 ** rng.integers(-40, 38, 20000),
                        _bf16_values()[::97] * 1.00390625]).astype(np.float32)
    x = x[np.isfinite(x) & (np.abs(x) < 3.0e38)]
    want = torch.from_numpy(x).to(torch.bfloat16).float().double().numpy()
    np.testing.assert_array_equal(_round_bf16(x.astype(np.float64)), want)


@pytest.mark.parametrize("code", range(16))
def test_pair_bits_are_128_plus_code(code):
    """(v & 0x000F000F) | 0x43004300 puts bf16 128 + c in both halves."""
    v = np.uint32(code | (code << 16)) | np.uint32(0xABC0ABC0)  # other nibbles set
    pair = (v & np.uint32(0x000F000F)) | np.uint32(0x43004300)
    lo, hi = int(pair) & 0xFFFF, int(pair) >> 16
    assert _bf16_from_bits(lo) == _bf16_from_bits(hi) == 128.0 + code


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_dequant_identity_every_code_every_scale(sign):
    """round_bf16((128 + c) s - 128 s) == round_bf16(c s) for c in 0..15 and
    every finite bf16 s (of one sign) with 128 s in bf16's range; -128 s as
    the kernels build it (fp32 bits of -128 * s, high half) is exact; and the
    result is the plain version's round_bf16(c * s) from fp32."""
    s = _bf16_values()
    s = s[(np.sign(s) == sign) | (s == 0.0)]
    s = s[np.abs(128.0 * s) <= float(torch.finfo(torch.bfloat16).max)]
    ns = _bf16_from_bits(_fp32_bits_hi(-128.0 * s))
    np.testing.assert_array_equal(ns, -128.0 * s)
    c = np.arange(16, dtype=np.float64)[:, None]
    fma = _round_bf16((128.0 + c) * s[None, :] + ns[None, :])
    np.testing.assert_array_equal(fma, _round_bf16(c * s[None, :]))
    plain = (torch.from_numpy((c * s[None, :]).astype(np.float32))
             .to(torch.bfloat16).double().numpy())
    np.testing.assert_array_equal(fma, plain)


def _words(codes: np.ndarray) -> np.ndarray:
    """codes (cols, k) in 0..15 -> 32-bit words, MLX order (nibble e of word
    w is k = 8 w + e)."""
    shifts = (4 * np.arange(8, dtype=np.uint64))
    cols = codes.shape[0]
    return (codes.reshape(cols, -1, 8).astype(np.uint64) << shifts).sum(-1).astype(np.uint32)


def _pair(word: int, shift: int) -> tuple[int, int]:
    """The kernels' (word >> shift) & 0x000F000F: nibbles shift / 4 and
    shift / 4 + 4."""
    v = (int(word) >> shift) & 0x000F000F
    return v & 0xF, v >> 16


def _k5_x_layout(x: np.ndarray) -> np.ndarray:
    """K5's shared-memory x (csrc/quant_matmul.cu, qv_xw): the 8 k's with
    index q8 at q8 // 16 * 128 + q8 % 4 * 32 + q8 // 4 % 4 * 8, each 8
    permuted to (0, 4, 1, 5, 2, 6, 3, 7)."""
    out = np.zeros_like(x)
    for q8 in range(x.shape[-1] // 8):
        pos = q8 // 16 * 128 + q8 % 4 * 32 + q8 // 4 % 4 * 8
        out[..., pos:pos + 8] = x[..., 8 * q8 + np.array([0, 4, 1, 5, 2, 6, 3, 7])]
    return out


def _tile_inputs(seed: int, k: int = 16, cols: int = 16):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 16, (cols, k))
    s = rng.integers(1, 33, (cols, 1)) / 16.0         # bf16 scales, one a column
    x = rng.integers(-64, 65, (8, k)) / 64.0          # bf16 x, 8 rows
    return codes, s, x


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k5_tile_permuted_k_order_gives_the_dot(seed):
    """K5 over one 128-k block: A = 16 weight columns, B = x's 8 rows. Lane
    (g, t) takes words 4 t .. 4 t + 3 of columns g and g + 8 (one 16-byte
    load each); in k-steps 2 j and 2 j + 1 its A pairs are the nibbles
    (0, 4), (1, 5) and (2, 6), (3, 7) of word 4 t + j, and its B pairs come
    from one 16-byte load of the laid-out x at 32 j + 8 t. The eight mma
    k-steps sum to (s * codes) @ x^T."""
    codes, s, x = _tile_inputs(seed, k=128)
    words = _words(codes)
    xs = _k5_x_layout(x)
    total = np.zeros((16, 8))
    for ks in range(8):
        jw, h = ks // 2, ks % 2
        a = np.zeros((16, 16))
        b = np.zeros((16, 8))
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for row in (g, g + 8):  # A's rows are weight columns
                lo, hi = _pair(words[row, 4 * t + jw], 8 * h)
                a[row, 2 * t], a[row, 2 * t + 1] = lo * s[row, 0], hi * s[row, 0]
                lo, hi = _pair(words[row, 4 * t + jw], 8 * h + 4)
                a[row, 2 * t + 8], a[row, 2 * t + 9] = lo * s[row, 0], hi * s[row, 0]
            xv = xs[g, 32 * jw + 8 * t:32 * jw + 8 * t + 8]  # one 16-byte load
            b[2 * t, g], b[2 * t + 1, g] = xv[4 * h], xv[4 * h + 1]
            b[2 * t + 8, g], b[2 * t + 9, g] = xv[4 * h + 2], xv[4 * h + 3]
        total += a @ b
    np.testing.assert_array_equal(total, (s * codes) @ x.T)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k6_tile_permuted_k_order_gives_the_dot(seed):
    """K6: A = x's 8 rows (rows 8-15 zero; lane (g, t) holds x[g] at k = t,
    t + 4 and 8 + t, 12 + t), B = 8 weight columns (the nibbles (t, t + 4)
    of column g's words). Rows 0-7 of A @ B equal x @ (s * codes)^T."""
    codes, s, x = _tile_inputs(seed, cols=8)
    words = _words(codes)
    a = np.zeros((16, 16))
    b = np.zeros((16, 8))
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        a[g, 2 * t], a[g, 2 * t + 1] = x[g, t], x[g, t + 4]
        a[g, 2 * t + 8], a[g, 2 * t + 9] = x[g, t + 8], x[g, t + 12]
        for half, word in enumerate(words[g]):
            lo, hi = _pair(word, 4 * t)
            b[2 * t + 8 * half, g] = lo * s[g, 0]
            b[2 * t + 8 * half + 1, g] = hi * s[g, 0]
    prod = a @ b
    np.testing.assert_array_equal(prod[:8], x @ (s * codes).T)
    assert not prod[8:].any()
