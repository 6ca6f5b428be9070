"""The dequant-matmul probe variants (kernels K10a-g) and their plain
PyTorch versions.

Counterpart of the seven Pallas functions of
``scripts/bench_quant_kernel.py``. All compute ``x @ dequant(W).T`` for x
``(..., K)`` over MLX group-affine int4/int8 weights, as kernel K5 does
(``ops/quant_matmul.py``); they differ in which operands the kernel is
handed and where its roundings fall, which is what the probe varies:

========  ======================  =============================================
variant   function                operands beside x
========  ======================  =============================================
a accum   ``quant_matmul_variant``  packed ``q``; scale and bias cast per word,
                                    one fp32 sum per bit plane, bias in the weight
b e1      ``quant_matmul_e1``       packed ``q``; cast per group, one sum
c e2      ``quant_matmul_e2``       + bf16 per-word tables ``(N, K/per_word)`` of
                                    scales and biases (:func:`make_scale_words`)
d e3      ``quant_matmul_e3``       + the bf16 scale table; bias as ``xg @ b.T``,
                                    ``xg`` = group sums of x in x's dtype
e e5      ``quant_matmul_e5``       ``q`` re-packed by :func:`repack_strided`
                                    (word c holds columns ``c + i * K/per_word``)
f e6      ``quant_matmul_e6``       packed ``q``; bias as ``xg @ b.T``
g e7      ``quant_matmul_e7``       transposed words ``(K/8, N)``, int4 only;
                                    ``128 + code`` built exact in bf16 by
                                    mask-and-or, ``-128 s`` folded into the bias
========  ======================  =============================================

With bf16 x every scale and bias is a bf16 value, ``code * scale`` is rounded
to bf16 (and again after the bias where it sits in the weight), and products
accumulate in fp32; with fp32 x everything is fp32, except that the tables
of c and d stay bf16. Variant g rounds ``(128 + code) * s``, eight times
coarser than ``code * s``: the reference parks it as unsound in bf16, and it
is ported as it is so the error shows.

``tile_n`` is the reference functions' column tile; here it is the launch
width in threads (256 or 512; a multiple of 32 up to 512). The TPU
kernels' planar x order is a Mosaic device: every wrapper takes x in natural
order and the kernels index it; :func:`_planar_perm_pair`, variant g's order,
remains for its plain version.

On a CUDA tensor each wrapper launches ``csrc/probe_quant_matmul.cu`` or
raises; on a CPU tensor it runs :func:`variant_plain`. ``LAUNCHES`` counts
by variant.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from whisper_mlx_tpu_torch.ops import _build
from whisper_mlx_tpu_torch.ops.quant import QuantTensor, _to_int32_bits, unpack

VARIANTS = ("accum", "e1", "e2", "e3", "e5", "e6", "e7")
LAUNCHES = {name: 0 for name in VARIANTS}


def make_scale_words(q: QuantTensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(N, K/per_word)`` bf16 per-word scale and bias tables (c, d)."""
    idx = torch.arange(q.w_q.shape[1], device=q.w_q.device) // (q.group_size // (32 // q.bits))
    return (q.scales[:, idx].to(torch.bfloat16).contiguous(),
            q.biases[:, idx].to(torch.bfloat16).contiguous())


def repack_strided(q: QuantTensor) -> QuantTensor:
    """Re-pack so that word c holds the original columns ``c + i * K/per_word``:
    the planes of a row, side by side, are then in x's natural order."""
    per_word = 32 // q.bits
    n, kp = q.w_q.shape
    vals = unpack(q.w_q, q.bits).to(torch.int64)  # (N, K), natural order
    shifts = torch.arange(per_word, device=vals.device, dtype=torch.int64) * q.bits
    words = (vals.reshape(n, per_word, kp) << shifts[None, :, None]).sum(dim=1)
    return QuantTensor(_to_int32_bits(words), q.scales, q.biases, q.bits, q.group_size)


def unpack_strided(w_q: torch.Tensor, bits: int) -> torch.Tensor:
    """Codes ``(N, K)`` in natural order from strided-packed words."""
    per_word = 32 // bits
    shifts = torch.arange(per_word, device=w_q.device, dtype=torch.int32) * bits
    planes = (w_q[:, None, :] >> shifts[None, :, None]) & ((1 << bits) - 1)
    return planes.reshape(w_q.shape[0], -1)


@functools.lru_cache(maxsize=32)
def _planar_perm_pair(k: int, per_word: int) -> np.ndarray:
    """Variant g's x order: position ``p = i * 2Kp + 2c + r`` holds original
    column ``c * per_word + i + r * per_word / 2`` (block i is the pair of
    planes i and i + per_word/2, interleaved as the halves of a word)."""
    kp = k // per_word
    p = np.arange(k)
    i, w = p // (2 * kp), p % (2 * kp)
    return np.asarray((w // 2) * per_word + i + (w % 2) * (per_word // 2), np.int32)


def group_sums(x2: torch.Tensor, group_size: int, in_fp32: bool) -> torch.Tensor:
    """x's per-group sums in x's dtype, taken in x's dtype (d) or in fp32
    and then cast (f, g), as the reference functions make them."""
    m, k = x2.shape
    src = x2.float() if in_fp32 else x2
    return src.reshape(m, k // group_size, group_size).sum(-1).to(x2.dtype).contiguous()


def variant_plain(name: str, x: torch.Tensor, w: torch.Tensor, scales: torch.Tensor,
                  biases: torch.Tensor, bits: int, group_size: int, *,
                  scale_w: torch.Tensor | None = None, bias_w: torch.Tensor | None = None,
                  xg: torch.Tensor | None = None) -> torch.Tensor:
    """One variant's function in plain PyTorch, with its rounding points.
    ``w`` is the variant's weight layout; x ``(M, K)``."""
    compute = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    per_word = 32 // bits
    xf = x.float()

    def c(t):  # a value of the compute dtype, held in fp32
        return t.to(compute).float()

    def per_col(t):  # (N, G) -> (N, K)
        return t.repeat_interleave(group_size, dim=1)

    if name == "e7":
        n, k = scales.shape[0], x.shape[1]
        kp, half = k // per_word, per_word // 2
        s, b = c(scales), c(biases)
        acc = torch.matmul(c(xg), c(b - 128.0 * s).T)
        x_pl = xf[:, torch.from_numpy(_planar_perm_pair(k, per_word)).to(x.device).long()]
        scale_slab = s.repeat_interleave(2 * group_size // per_word, dim=1)  # (N, 2Kp)
        field = ((1 << bits) - 1) | (((1 << bits) - 1) << 16)
        for i in range(half):
            t = ((w.T.contiguous() >> (bits * i)) & field) | 0x43004300
            pair = t.view(torch.bfloat16).float()  # (N, 2Kp): 128 + code, exact
            acc = acc + torch.matmul(x_pl[:, i * 2 * kp:(i + 1) * 2 * kp], c(pair * scale_slab).T)
        return acc.to(x.dtype)

    codes = (unpack_strided(w, bits) if name == "e5" else unpack(w, bits)).float()
    if name in ("e2", "e3"):
        s_col = scale_w.float().repeat_interleave(per_word, dim=1)
    else:
        s_col = per_col(c(scales))
    wv = c(codes * s_col)
    if name in ("e3", "e6"):
        return (torch.matmul(xf, wv.T) + torch.matmul(c(xg), c(biases).T)).to(x.dtype)
    b_col = bias_w.float().repeat_interleave(per_word, dim=1) if name == "e2" else per_col(c(biases))
    wv = c(wv + b_col)
    if name == "accum":  # one product per bit plane, summed in fp32
        acc = sum(torch.matmul(xf[:, i::per_word], wv[:, i::per_word].T) for i in range(per_word))
        return acc.to(x.dtype)
    return torch.matmul(xf, wv.T).to(x.dtype)


def _run(name: str, x: torch.Tensor, w: torch.Tensor, scales: torch.Tensor,
         biases: torch.Tensor, bits: int, group_size: int, tile_n: int, *,
         scale_w=None, bias_w=None, xg_fp32: bool | None = None) -> torch.Tensor:
    """Check the operands, make xg where the variant takes it, and run the
    kernel (CUDA tensors) or the plain version (CPU tensors)."""
    *lead, k = x.shape
    per_word = 32 // bits if bits in (4, 8) else 0
    if not per_word or group_size % (128 // bits) or k % group_size or (name == "e7" and bits != 4):
        raise ValueError(f"probe {name}: bits {bits}, group_size {group_size}, K {k}")
    n = scales.shape[0]
    w_shape = (k // per_word, n) if name == "e7" else (n, k // per_word)
    tables = [t for t in (scale_w, bias_w) if t is not None]
    if (w.dtype != torch.int32 or tuple(w.shape) != w_shape
            or tuple(scales.shape) != (n, k // group_size) or scales.shape != biases.shape
            or scales.dtype != torch.float32 or biases.dtype != torch.float32
            or any(t.dtype != torch.bfloat16 or tuple(t.shape) != (n, k // per_word)
                   for t in tables)):
        raise ValueError(f"probe {name}: x {tuple(x.shape)}, w {tuple(w.shape)} {w.dtype}, "
                         f"scales {tuple(scales.shape)} {scales.dtype}, biases "
                         f"{tuple(biases.shape)} {biases.dtype}, tables "
                         f"{[(tuple(t.shape), t.dtype) for t in tables]}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"probe {name}: x must be bfloat16 or float32, got {x.dtype}")
    if tile_n % 32 or not 32 <= tile_n <= 512:
        raise ValueError(f"probe {name}: tile_n {tile_n} must be a multiple of 32 up to 512")
    operands = [w, scales, biases, *tables]
    if any(t.device != x.device for t in operands):
        raise ValueError(f"probe {name}: every operand must be on x's device {x.device}")
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    xg = None if xg_fp32 is None else group_sums(x2, group_size, xg_fp32)
    if x.device.type == "cpu":
        out = variant_plain(name, x2, w, scales, biases, bits, group_size,
                            scale_w=scale_w, bias_w=bias_w, xg=xg)
        return out.reshape(*lead, n)
    if x.device.type != "cuda":
        raise ValueError(f"probe {name}: unsupported device {x.device}")
    if m > 512 or any(not t.is_contiguous() for t in operands):
        raise ValueError(f"probe {name}: the kernel takes at most 512 rows (got {m}) and "
                         "contiguous operands")
    if x2.data_ptr() % 16:  # the kernels load x 16 bytes at a time
        x2 = x2.clone()
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return out.reshape(*lead, n)

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = _build.lib().wmt_probe_qmm(
        x2.data_ptr(), ptr(xg), w.data_ptr(), scales.data_ptr(), biases.data_ptr(),
        ptr(scale_w), ptr(bias_w), out.data_ptr(), m, n, k, bits, group_size,
        VARIANTS.index(name), tile_n, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, f"wmt_probe_qmm[{name}]")
    LAUNCHES[name] += 1
    return out.reshape(*lead, n)


def quant_matmul_variant(x: torch.Tensor, q: QuantTensor, tile_n: int = 256,
                         kernel: str = "accum") -> torch.Tensor:
    """Variants a (``kernel="accum"``) and b (``"e1"``): kernel K10a / K10b."""
    if kernel not in ("accum", "e1"):
        raise ValueError(f"quant_matmul_variant: kernel {kernel!r} is not 'accum' or 'e1'")
    return _run(kernel, x, q.w_q, q.scales, q.biases, q.bits, q.group_size, tile_n)


def quant_matmul_e1(x: torch.Tensor, q: QuantTensor, tile_n: int = 256) -> torch.Tensor:
    return quant_matmul_variant(x, q, tile_n, "e1")


def quant_matmul_e2(x: torch.Tensor, q: QuantTensor, scale_w: torch.Tensor,
                    bias_w: torch.Tensor, tile_n: int = 256) -> torch.Tensor:
    """Variant c (K10c): per-word bf16 scale and bias tables made outside."""
    return _run("e2", x, q.w_q, q.scales, q.biases, q.bits, q.group_size, tile_n,
                scale_w=scale_w, bias_w=bias_w)


def quant_matmul_e3(x: torch.Tensor, q: QuantTensor, scale_w: torch.Tensor,
                    tile_n: int = 256) -> torch.Tensor:
    """Variant d (K10d): the bias folded out through x's group sums."""
    return _run("e3", x, q.w_q, q.scales, q.biases, q.bits, q.group_size, tile_n,
                scale_w=scale_w, xg_fp32=False)


def quant_matmul_e5(x: torch.Tensor, q: QuantTensor, tile_n: int = 256) -> torch.Tensor:
    """Variant e (K10e): ``q`` strided-packed by :func:`repack_strided`."""
    return _run("e5", x, q.w_q, q.scales, q.biases, q.bits, q.group_size, tile_n)


def quant_matmul_e6(x: torch.Tensor, q: QuantTensor, tile_n: int = 256) -> torch.Tensor:
    """Variant f (K10f): raw scales cast in the kernel, bias folded out."""
    return _run("e6", x, q.w_q, q.scales, q.biases, q.bits, q.group_size, tile_n, xg_fp32=True)


def quant_matmul_e7(x: torch.Tensor, wqt: torch.Tensor, scales: torch.Tensor,
                    biases: torch.Tensor, bits: int, group_size: int,
                    tile_n: int = 256) -> torch.Tensor:
    """Variant g (K10g): transposed words ``(K/8, N)``, the bf16 bit trick."""
    return _run("e7", x, wqt, scales, biases, bits, group_size, tile_n, xg_fp32=True)
