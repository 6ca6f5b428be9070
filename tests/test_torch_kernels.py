"""The Hopper kernels of whisper_mlx_tpu_torch against their plain PyTorch
versions, on a GPU, the beam path's kernels (K8, K3's integer-dot mode, K9)
and the LLM's weight-residency kernels (K6, K7) on tiny models card
against CPU, the probe kernels (K10a-g, K11, K12) and the 4-bit whisper
path card against CPU.

Tests marked ``cuda`` skip without a GPU: a CUDA kernel has no CPU mode.
This file imports neither jax nor the JAX package, so on a machine with a
GPU and without jax it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tolerances: 2e-4 absolute for the mel (fp32 FMA in another order);
``2e-2 * max(1, |ref|max)`` for the attention kernels, which round the
softmax weights to bf16 (K2, K3 as the TPU kernels did; K4 where the TPU
kernel kept fp32), and for K2 and K4 ``2e-2`` times each query row's own
``|ref|max`` (a row that averages many keys has small values); for the
quantized matmul ``1e-2 * max(1, |ref|max)`` in
bf16 (sums in another order can move a result by one bf16 ulp) and
``1e-4 * max(1, |ref|max)`` in fp32, the same for the transposed
dequant-matmul (K6); the W8A8 matmul (K7) computes the same int32 sums and
fp32 products as its plain version on both routes: bit-equal. The
integer-dot modes (K3, K8) take
the attention tolerance too: the card's expf and the CPU's exp may differ
in an ulp, which can move one dynamic w * vs code by one step, at most
max(w * vs) on the output. The lane kernel (K9) moves bytes: exact. The
probe matmuls (K10) take the quantized matmul's tolerances, the probe
attention kernels (K11, K12) the attention tolerance.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from whisper_mlx_tpu_torch.audio import mel as t_mel
from whisper_mlx_tpu_torch.ops import _build
from whisper_mlx_tpu_torch.ops import beamflat_attention as bf
from whisper_mlx_tpu_torch.ops import decode_attention as da
from whisper_mlx_tpu_torch.ops import dense_attention as dn
from whisper_mlx_tpu_torch.ops import flash_attention as fa
from whisper_mlx_tpu_torch.ops import gqa_decode_attention as gq
from whisper_mlx_tpu_torch.ops import kv_quant as kq
from whisper_mlx_tpu_torch.ops import lane_permute as lp
from whisper_mlx_tpu_torch.ops import mel_kernel as mk
from whisper_mlx_tpu_torch.ops import probe_decode_attention as pda
from whisper_mlx_tpu_torch.ops import probe_quant_matmul as pqm
from whisper_mlx_tpu_torch.ops import quant as tq
from whisper_mlx_tpu_torch.ops import quant_a8 as a8
from whisper_mlx_tpu_torch.ops import quant_matmul as qm
from whisper_mlx_tpu_torch.ops import quant_matmul_mb as mb


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernels have no CPU mode")
    from whisper_mlx_tpu_torch.runtime.device import setup_device

    return setup_device("cuda")


def _max_err(got, ref) -> float:
    return (got.float() - ref.float()).abs().max().item()


def _attn_tol(ref) -> float:
    return 2e-2 * max(1.0, ref.float().abs().max().item())


def _assert_rows_close(got, ref, tol: float = 2e-2):
    """K2, K3 and K4: each query row's largest error within ``tol`` (2e-2)
    times that row's largest |ref|. Rows that average many keys have small values, so
    a limit over the whole output would leave them unchecked (a key dropped
    or counted twice at each edge of K3's key slices over 1500 keys moves
    the worst row by about 0.1 of its max|ref|, the whole output by about
    1e-2); this one is also within ``_attn_tol``."""
    err = (got.float() - ref.float()).abs().amax(-1)
    row_ref = ref.float().abs().amax(-1).clamp_min(torch.finfo(torch.float32).tiny)
    assert (err / row_ref).max().item() <= tol


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """The build names the missing toolkit instead of failing obscurely;
    the library is named by a hash of the sources under build/kernels."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    path = _build.library_path()
    assert path.parent == tmp_path / "kernels" and path.suffix == ".so"
    assert sorted(p.name for p in _build.CSRC.glob("*.cu")) == [
        "a8_matmul.cu", "beamflat_attention.cu", "decode_attention.cu", "dense_attention.cu",
        "flash_attention.cu", "gqa_decode_attention.cu", "lane_permute.cu", "mel.cu",
        "probe_decode_attention.cu",
        "probe_quant_matmul.cu", "quant_matmul.cu", "quant_matmul_mb.cu"]
    assert sorted(p.name for p in _build.CSRC.glob("*.cuh")) == ["attn_tile.cuh",
                                                                 "quant_tile.cuh",
                                                                 "sm90_async.cuh"]


@pytest.mark.cuda
@pytest.mark.parametrize("n_mels,seconds", [(128, 30.0), (80, 95.0)])
def test_mel_kernel_matches_plain(cuda, n_mels, seconds):
    rng = np.random.default_rng(int(seconds))
    audio = torch.from_numpy(
        (rng.standard_normal(int(seconds * 16000)) * 0.1).astype(np.float32)).to(cuda)
    frames = t_mel._frame_signal(audio, 400, 160)[:-1].contiguous()
    before = mk.LAUNCHES
    got = mk.log_mel_frames(frames, n_mels)
    torch.cuda.synchronize()
    assert mk.LAUNCHES == before + 1
    assert _max_err(got, mk.log_mel_frames_plain(frames, n_mels)) <= 2e-4


@pytest.mark.cuda
@pytest.mark.parametrize("n_mels", [80, 128])
@pytest.mark.parametrize("n_frames", [1, 15, 16, 17, 3000, 9500, 24000])
def test_mel_kernel_frame_tiles_match_plain(cuda, n_mels, n_frames):
    """K1 at the edges of its 32-frame cluster tile, a 30 s window, the 65
    s file and 4 minutes: within 2e-4 of the plain version, bit-equal on a
    repeat."""
    gen = torch.Generator(device=cuda).manual_seed(n_frames + n_mels)
    frames = torch.randn((n_frames, 400), generator=gen, device=cuda) * 0.1
    got = mk.log_mel_frames(frames, n_mels)
    torch.cuda.synchronize()
    assert got.shape == (n_frames, n_mels)
    assert _max_err(got, mk.log_mel_frames_plain(frames, n_mels)) <= 2e-4
    assert torch.equal(got, mk.log_mel_frames(frames, n_mels))


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,tq,tk", [
    (2, 20, 1500, 1500), (1, 3, 200, 200), (1, 3, 130, 333),
    # ragged edges of the 128-row q-tile and the 128-key tile
    (1, 2, 1, 1), (1, 2, 63, 1500), (1, 2, 64, 1500), (1, 2, 65, 1500), (1, 20, 1500, 1500),
    (1, 3, 1, 65), (1, 3, 63, 64), (1, 3, 64, 63), (1, 3, 65, 1), (1, 2, 129, 128),
])
def test_dense_kernel_matches_plain(cuda, b, h, tq, tk):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((b, h, t, 64), generator=g, device=cuda) * s
               for t, s in ((tq, 0.35), (tk, 0.35), (tk, 1.0)))
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    before = dn.LAUNCHES
    got = dn.dense_attention(q, k, v)
    torch.cuda.synchronize()
    assert dn.LAUNCHES == before + 1
    _assert_rows_close(got, dn.dense_attention_plain(q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("bits,n,g,tq,t,kw", [
    (8, 4, 1, 1, 256, dict(pos=100, causal=True)),
    (8, 4, 1, 3, 256, dict(pos=0, causal=True)),
    (4, 4, 1, 1, 1500, dict(valid_len=1500)),
    (4, 2, 5, 1, 1500, dict(valid_len=1500)),
    (4, 2, 1, 3, 384, dict(valid_len=333)),
    # the largest default serving bucket's cross call: 1,120 clusters of 6
    # blocks, where a block writing into another before it had started faulted
    (4, 56, 1, 1, 1500, dict(valid_len=1500)),
])
def test_decode_kernel_matches_plain(cuda, bits, n, g, tq, t, kw):
    gen = torch.Generator(device=cuda).manual_seed(1)
    kx, vx = (torch.randn((n, 20, t, 64), generator=gen, device=cuda) for _ in range(2))
    k8, ks = kq.quantize_kv(kx * 0.35, bits)
    v8, vs = kq.quantize_kv(vx, bits)
    q = (torch.randn((n * g, 20, tq, 64), generator=gen, device=cuda) * 0.35).to(torch.bfloat16)
    before = da.LAUNCHES
    got = da.decode_attention(q, k8, ks, v8, vs, group=g, **kw)
    torch.cuda.synchronize()
    assert da.LAUNCHES == before + 1
    ref = da.decode_attention_plain(q, k8, ks, v8, vs, group=g, **kw)
    _assert_rows_close(got, ref)


@pytest.mark.cuda
def test_plain_row_quantizer_matches_cpu(cuda):
    """The integer-dot plain version's row quantizer gives the same scales
    and codes on the card as on the CPU: true division, where PyTorch on
    CUDA divides by a Python number through its reciprocal."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((4096, 64), generator=gen, device=cuda) * 0.35
    codes, scale = da.quantize_rows(x)
    codes_cpu, scale_cpu = da.quantize_rows(x.cpu())
    assert torch.equal(scale.cpu(), scale_cpu) and torch.equal(codes.cpu(), codes_cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["quantize_kv8", "quantize_kv4", "a8_matmul_plain",
                                  "requant_a8"])
def test_plain_quantizers_match_cpu(cuda, what):
    """The KV-cache quantizer, K7's plain version and the A8 weight
    conversion give the same codes, scales and outputs on the card as on
    the CPU: every quotient is a true division by a tensor."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    if what.startswith("quantize_kv"):
        x = torch.randn((2, 20, 512, 64), generator=gen, device=cuda) * 0.35
        bits = int(what[-1])
        got, ref = kq.quantize_kv(x, bits), kq.quantize_kv(x.cpu(), bits)
    elif what == "requant_a8":
        w = torch.randn((3000, 512), generator=gen, device=cuda) / 512 ** 0.5
        got = a8.requant_a8(w)
        ref = a8.requant_a8(w.cpu())
        got, ref = (got.codes, got.scale), (ref.codes, ref.scale)
    else:
        at = a8.requant_a8(torch.randn((700, 512), generator=gen, device=cuda) / 512 ** 0.5)
        x = torch.randn((64, 512), generator=gen, device=cuda)
        at_cpu = a8.A8Tensor(at.codes.cpu(), at.scale.cpu(), at.tile_n, at.depth)
        got = (a8.a8_matmul_plain(x, at), a8.a8_matmul_plain(x.bfloat16(), at))
        ref = (a8.a8_matmul_plain(x.cpu(), at_cpu), a8.a8_matmul_plain(x.cpu().bfloat16(), at_cpu))
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("int_dot", [False, True])
@pytest.mark.parametrize("n,g,tq,t,kw", [
    # live lengths at the edges of the cluster's blocks (one per 256 keys)
    # and of their slices and 16-key tiles
    (2, 1, 1, 2048, dict(valid_len=1)), (2, 1, 1, 2048, dict(valid_len=187)),
    (2, 1, 1, 2048, dict(valid_len=188)), (2, 1, 1, 2048, dict(valid_len=189)),
    (2, 1, 1, 2048, dict(valid_len=256)), (2, 1, 1, 2048, dict(valid_len=257)),
    (2, 5, 1, 1500, dict(valid_len=1500)), (2, 1, 1, 2048, dict(valid_len=2048)),
    # causal: pos 0 (one live key for the first row), pos 447, Tq 3
    (2, 1, 3, 512, dict(pos=0, causal=True)), (2, 1, 1, 512, dict(pos=447, causal=True)),
    (2, 1, 3, 512, dict(pos=447, causal=True, valid_len=449)),
    # g 5 x Tq 3 = 15 rows a KV row, and 18: more than one pass of 8 rows
    (2, 5, 3, 1500, dict(valid_len=1500)), (1, 3, 6, 256, dict(pos=100, causal=True)),
])
def test_decode_kernel_cluster_edges_match_plain(cuda, bits, int_dot, n, g, tq, t, kw):
    """K3's cluster design at the edges of its key slices, live lengths 1
    to 2048, both code widths, both modes."""
    gen = torch.Generator(device=cuda).manual_seed(tq * 13 + t + kw.get("pos", 0))
    kx, vx = (torch.randn((n, 20, t, 64), generator=gen, device=cuda) for _ in range(2))
    k8, ks = kq.quantize_kv(kx * 0.35, bits)
    v8, vs = kq.quantize_kv(vx, bits)
    q = (torch.randn((n * g, 20, tq, 64), generator=gen, device=cuda) * 0.35).to(torch.bfloat16)
    before = (da.LAUNCHES, da.INT_DOT_LAUNCHES)
    got = da.decode_attention(q, k8, ks, v8, vs, group=g, int_dot=int_dot, **kw)
    torch.cuda.synchronize()
    assert (da.LAUNCHES, da.INT_DOT_LAUNCHES) == (before[0] + (not int_dot),
                                                  before[1] + int_dot)
    ref = da.decode_attention_plain(q, k8, ks, v8, vs, group=g, int_dot=int_dot, **kw)
    _assert_rows_close(got, ref)


# K3 in speculative decoding's modes (ROADMAP R3): the draft's 2-token sync
# and the verify of k + 1 = 5 rows, causal over an int8 self cache of 256
# positions (large-v3's horizon, 224 + 5 rounded up) past position 0 and
# where pos + Tq meets the cache end, and the verify's cross call over the
# int4 cache
SPEC_K3 = [(8, tq, 256, dict(pos=pos, causal=True))
           for tq in (2, 5) for pos in (100, 226, 256 - tq)] + [(4, 5, 1500, dict(valid_len=1500))]


@pytest.mark.cuda
@pytest.mark.parametrize("int_dot", [False, True])
@pytest.mark.parametrize("n", [1, 8], ids=["1win", "8win"])
@pytest.mark.parametrize("bits,tq,t,kw", SPEC_K3)
def test_decode_kernel_spec_modes_match_plain(cuda, bits, tq, t, kw, n, int_dot):
    """K3 at the speculative loop's query rows, one window a call (the loop's
    grid) and eight, both modes: row by row within 2e-2 of each row's
    max|ref|, and bit-equal on a repeat."""
    gen = torch.Generator(device=cuda).manual_seed(tq * 7 + kw.get("pos", 0) + n)
    kx, vx = (torch.randn((n, 20, t, 64), generator=gen, device=cuda) for _ in range(2))
    k8, ks = kq.quantize_kv(kx * 0.35, bits)
    v8, vs = kq.quantize_kv(vx, bits)
    q = (torch.randn((n, 20, tq, 64), generator=gen, device=cuda) * 0.35).to(torch.bfloat16)
    before = (da.LAUNCHES, da.INT_DOT_LAUNCHES)
    got = da.decode_attention(q, k8, ks, v8, vs, int_dot=int_dot, **kw)
    torch.cuda.synchronize()
    assert (da.LAUNCHES, da.INT_DOT_LAUNCHES) == (before[0] + (not int_dot),
                                                  before[1] + int_dot)
    _assert_rows_close(got, da.decode_attention_plain(q, k8, ks, v8, vs, int_dot=int_dot, **kw))
    assert torch.equal(got, da.decode_attention(q, k8, ks, v8, vs, int_dot=int_dot, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("int_dot", [False, True])
def test_decode_kernel_v_scales_after_their_copy(cuda, int_dot):
    """K3 reads the V scales only after their bulk copy has landed: before
    the fix the weights w * vs read them while the copy could still be in
    flight, and a row now and then took stale scales (0.35 of its max|ref|
    off in an integer-dot self call of 40 rows at pos 226). Many launches on
    fresh caches, each held row by row."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    for rep in range(48):
        kx, vx = (torch.randn((40, 20, 256, 64), generator=gen, device=cuda) for _ in range(2))
        k8, ks = kq.quantize_kv(kx * 0.35, 8)
        v8, vs = kq.quantize_kv(vx, 8)
        q = (torch.randn((40, 20, 1, 64), generator=gen, device=cuda) * 0.35).bfloat16()
        kw = dict(pos=226 - rep % 3, causal=True, int_dot=int_dot)
        got = da.decode_attention(q, k8, ks, v8, vs, **kw)
        _assert_rows_close(got, da.decode_attention_plain(q, k8, ks, v8, vs, **kw))


# K3's GQA mode (the quantized Qwen cache, ROADMAP R2): (rows, KV heads, rep,
# Tq, hd, cache length, first positions). Qwen3-32B's layer (8 KV heads of 128,
# rep 8) at a decode step early, at 4,095 and 8,191, 4 slots at ragged
# positions, the verify's Tq 5 at 4,095; hd 64 at rep 7 (Qwen2.5-0.5B) and hd
# 128 at rep 5 (Qwen2.5-14B); the edges: one live key, the cluster's 256-key
# blocks, Tq 16 at rep 8 (16 passes of 8 rows), the longest cache; then the
# edges of gqa_plan on the H100: 1 live key, 64/65 (1 block a head to 2),
# 255/256/257, 960/961 at 2 KV heads (a held cluster of 8 to 16),
# 2,047/2,048/2,049, 3,840/3,841 and 4,095/4,096/4,097 live keys (8 KV
# heads: clusters of 8, 16 not held), rep 7 padded to 8 rows at Tq 1 and 5,
# a first position past the cache end (every key read)
# K3 GQA's fp32 outputs, row by row: the sound kernel's worst row sits far
# below this, a copy keeping only the hi fp16 part of the split query or
# weights far above it (chip_smoke.py --only gqa_split)
GQA_FP32_TOL = 2e-5
GQA_SHAPES = [
    (1, 8, 8, 1, 128, 4096, [226]), (1, 8, 8, 1, 128, 4096, [4095]),
    (1, 8, 8, 1, 128, 8192, [8191]), (4, 8, 8, 1, 128, 4096, [37, 700, 2500, 4000]),
    (1, 8, 8, 5, 128, 8192, [4095]), (1, 2, 7, 1, 64, 1024, [600]),
    (2, 8, 5, 1, 128, 2048, [1500, 3]), (2, 2, 8, 1, 128, 512, [0, 255]),
    (1, 2, 8, 3, 64, 600, [254]), (1, 2, 8, 16, 128, 4096, [3000]),
    (3, 1, 4, 2, 64, 32768, [32766, 9, 16000]),
    (1, 8, 8, 1, 128, 4096, [0]), (1, 2, 8, 1, 128, 512, [254]),
    (1, 2, 8, 1, 64, 512, [255]), (1, 2, 8, 1, 128, 512, [256]),
    (1, 2, 8, 1, 128, 4096, [2046]), (1, 2, 8, 1, 64, 4096, [2047]),
    (1, 2, 8, 1, 128, 4096, [2048]), (1, 8, 8, 1, 128, 4096, [4094]),
    (1, 8, 8, 1, 128, 8192, [4096]), (1, 2, 8, 1, 128, 4096, [3839]),
    (1, 2, 8, 1, 64, 4096, [3840]), (1, 2, 7, 5, 128, 2048, [1999]),
    (2, 2, 8, 1, 128, 600, [700, 599]), (1, 2, 8, 1, 128, 512, [63]),
    (1, 2, 8, 1, 64, 512, [64]), (1, 2, 8, 1, 128, 1024, [959]), (1, 2, 8, 1, 128, 1024, [960]),
]


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("b,n_kv,rep,tq,hd,t,pos", GQA_SHAPES)
def test_gqa_kernel_matches_plain(cuda, bits, b, n_kv, rep, tq, hd, t, pos):
    """K3's GQA mode against its plain version on the card, row by row
    within 2e-2 of each row's max|ref| in bf16 and GQA_FP32_TOL in fp32, one
    launch a call, bit-equal on a repeat."""
    gen = torch.Generator(device=cuda).manual_seed(b * 31 + tq + t + pos[0])
    kx, vx = (torch.randn((b, n_kv, t, hd), generator=gen, device=cuda) for _ in range(2))
    k8, ks = kq.quantize_kv(kx, bits)
    v8, vs = kq.quantize_kv(vx, bits)
    q = torch.randn((b, n_kv * rep, tq, hd), generator=gen, device=cuda)
    p = torch.tensor(pos, dtype=torch.int32, device=cuda)
    kw = dict(scale=hd ** -0.5, live=min(t, max(pos) + tq))
    for out_dtype in (torch.bfloat16, torch.float32):
        before = gq.LAUNCHES
        got = gq.gqa_decode_attention(q, k8, ks, v8, vs, p, out_dtype=out_dtype, **kw)
        torch.cuda.synchronize()
        assert gq.LAUNCHES == before + 1 and got.dtype == out_dtype
        _assert_rows_close(got, gq.gqa_decode_attention_plain(q, k8, ks, v8, vs, p, **kw),
                           2e-2 if out_dtype == torch.bfloat16 else GQA_FP32_TOL)
        assert torch.equal(got, gq.gqa_decode_attention(q, k8, ks, v8, vs, p,
                                                        out_dtype=out_dtype, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("q_scale,v_scale", [(1e-6, 1.0), (1e4, 1.0), (1.0, 1e-6), (1.0, 1e4),
                                             (30.0, 1e-5)])
def test_gqa_kernel_value_ranges(cuda, bits, q_scale, v_scale):
    """K3's GQA mode with queries and values far from unit scale (the
    kernel's fp16 and bf16 operands must neither overflow nor lose them),
    row by row within 2e-2 of each row's max|ref| against its plain
    version."""
    gen = torch.Generator(device=cuda).manual_seed(bits)
    kx, vx = (torch.randn((2, 2, 1024, 128), generator=gen, device=cuda) for _ in range(2))
    k8, ks = kq.quantize_kv(kx, bits)
    v8, vs = kq.quantize_kv(vx * v_scale, bits)
    q = torch.randn((2, 16, 2, 128), generator=gen, device=cuda) * q_scale
    p = torch.tensor([1000, 500], dtype=torch.int32, device=cuda)
    kw = dict(scale=128 ** -0.5, live=1002)
    got = gq.gqa_decode_attention(q, k8, ks, v8, vs, p, **kw)
    _assert_rows_close(got, gq.gqa_decode_attention_plain(q, k8, ks, v8, vs, p, **kw))


@pytest.mark.cuda
def test_gqa_kernel_rejects_what_it_does_not_take(cuda):
    k8, ks = kq.quantize_kv(torch.zeros((1, 2, 64, 32), device=cuda))
    q = torch.zeros((1, 4, 1, 32), device=cuda)
    p = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="hd"):  # hd 32: the CPU's tiny configs only
        gq.gqa_decode_attention(q, k8, ks, k8, ks, p, scale=0.1, live=8)
    k8, ks = kq.quantize_kv(torch.zeros((1, 2, 64, 64), device=cuda))
    q = torch.zeros((1, 4, 17, 64), device=cuda)
    with pytest.raises(ValueError, match="Tq"):
        gq.gqa_decode_attention(q, k8, ks, k8, ks, p, scale=0.1, live=20)
    q = torch.zeros((1, 4, 1, 64), device=cuda)
    # contiguous codes and scales one element past a 16-byte boundary
    k_off = torch.zeros(k8.numel() + 16, dtype=torch.int8, device=cuda)[1:k8.numel() + 1]
    s_off = torch.zeros(ks.numel() + 8, dtype=torch.bfloat16, device=cuda)[1:ks.numel() + 1]
    k_off, s_off = k_off.view(k8.shape), s_off.view(ks.shape)
    with pytest.raises(ValueError, match="16-byte"):
        gq.gqa_decode_attention(q, k_off, s_off, k_off, s_off, p, scale=0.1, live=8)


@pytest.mark.cuda
def test_qwen_tiny_quantized_cache_card_vs_cpu(cuda):
    """A tiny Qwen3-shaped model (hd 128, 4 KV heads, rep 2) under kv_bits 8
    and 4, bf16 with the flash prefill on both devices: the card's decode
    (K4 prefill, K3's GQA mode on every step, per row too) against the
    CPU's plain versions, logits within 5e-2 * max(1, |ref|), the GQA mode
    launched on every layer of every step."""
    import dataclasses

    from whisper_mlx_tpu_torch.models import qwen as tqw

    cfg = tqw.QwenConfig(vocab_size=256, hidden_size=256, intermediate_size=512,
                         num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=4,
                         head_dim=128, qk_norm=True, attention_bias=False,
                         tie_word_embeddings=False)
    params = _to_device(tqw.init_params(cfg, seed=0), torch.bfloat16)
    dev_params = _to_device(params, cuda)
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(0, 256, (2, 11)))
    for bits in (8, 4):
        cpu_cfg = dev_cfg = dataclasses.replace(cfg, kv_bits=bits, flash_attention=True,
                                                dtype=torch.bfloat16)
        caches = [tqw.init_kv_cache(cpu_cfg, 2, 64), tqw.init_kv_cache(dev_cfg, 2, 64, cuda)]
        before = gq.LAUNCHES
        for tokens, pos in ((prompt, 0), (prompt[:, :1], 11), (prompt[:, 1:2], [12, 12]),
                            (prompt[:, :5], 13), (prompt[:, 2:3], [18, 18])):
            ref, caches[0] = tqw.decode_step(params, tokens, pos, caches[0], cpu_cfg)
            got, caches[1] = tqw.decode_step(dev_params, tokens.to(cuda), pos, caches[1],
                                             dev_cfg)
            tol = 5e-2 * max(1.0, ref.abs().max().item())
            assert (got.cpu() - ref).abs().max().item() <= tol, (bits, pos)
        assert gq.LAUNCHES == before + 4 * cfg.num_hidden_layers


@pytest.mark.cuda
def test_kernel_wrappers_reject_bad_inputs(cuda):
    q = torch.zeros((1, 2, 4, 64), device=cuda)  # float32: the kernels take bf16
    with pytest.raises(ValueError, match="bfloat16"):
        dn.dense_attention(q, q, q)
    c8, s = kq.quantize_kv(torch.zeros((1, 2, 8, 64), device=cuda))
    with pytest.raises(ValueError, match="bfloat16"):
        da.decode_attention(q, c8, s, c8, s)
    with pytest.raises(ValueError, match="contiguous"):
        mk.log_mel_frames(torch.zeros((400, 10), device=cuda).T, 80)


@pytest.mark.cuda
def test_plain_model_attention_raises_on_cuda(cuda):
    """The parity configuration's plain attention never runs on the card."""
    from whisper_mlx_tpu_torch.models import whisper as tw

    q = torch.zeros((1, 2, 4, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CPU tensors only"):
        tw.attention(q, q, q)
    cfg = tw.WhisperConfig(n_audio_state=128, n_audio_head=2, n_audio_layer=1,
                           n_text_state=128, n_text_head=2, n_text_layer=1, n_vocab=64)
    params = tw.init_params(cfg, seed=0, device=cuda)
    with pytest.raises(ValueError, match="CPU tensors only"):
        tw.encode(params, torch.zeros((1, 3000, cfg.n_mels), device=cuda), cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k,bits,dtype,gs", [
    (1, 200, 512, 4, torch.bfloat16, 64),
    (3, 200, 512, 8, torch.bfloat16, 64),
    (8, 1000, 1024, 4, torch.bfloat16, 64),
    (17, 200, 512, 4, torch.bfloat16, 64),
    (128, 1000, 1024, 4, torch.bfloat16, 64),
    (300, 130, 5120, 8, torch.bfloat16, 64),
    (512, 10240, 5120, 4, torch.bfloat16, 64),
    (1, 10240, 5120, 4, torch.bfloat16, 64),
    (5, 130, 256, 4, torch.float32, 64),
    (40, 130, 256, 8, torch.float32, 64),
    # the tiled core at the edges of its row blocks (16, 32, 64 rows; 128
    # rows a block past 64), ragged N, group sizes 16-128, 8 bits, K whose
    # groups are not a multiple of 4 (K5's affines then by cp.async)
    (9, 200, 512, 4, torch.bfloat16, 32),
    (16, 1280, 1280, 4, torch.bfloat16, 64),
    (24, 51866, 1280, 4, torch.bfloat16, 64),
    (24, 1000, 1344, 4, torch.bfloat16, 64),
    (33, 3840, 1280, 8, torch.bfloat16, 64),
    (64, 1280, 5120, 4, torch.bfloat16, 128),
    (65, 700, 2048, 4, torch.bfloat16, 32),
    (127, 300, 2048, 8, torch.bfloat16, 16),
    (129, 1000, 1024, 4, torch.bfloat16, 128),
    (255, 200, 512, 8, torch.bfloat16, 64),
    (256, 5120, 1280, 4, torch.bfloat16, 64),
    (257, 130, 5120, 4, torch.bfloat16, 64),
    (384, 5120, 8192, 4, torch.bfloat16, 64),
    (511, 1000, 1024, 4, torch.bfloat16, 32),
    (24, 151936, 5120, 4, torch.bfloat16, 64),
])
def test_quant_matmul_kernel_matches_plain(cuda, m, n, k, bits, dtype, gs):
    gen = torch.Generator(device=cuda).manual_seed(m + n)
    w = torch.randn((n, k), generator=gen, device=cuda) / k ** 0.5
    q = tq.quantize(w, bits=bits, group_size=gs)
    del w
    x = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
    before = (qm.LAUNCHES, qm.TILED_LAUNCHES)
    got = tq.quant_matmul(x, q)
    torch.cuda.synchronize()
    tiled = dtype == torch.bfloat16 and m > qm.GEMV_ROWS
    assert (qm.LAUNCHES, qm.TILED_LAUNCHES) == (before[0] + 1, before[1] + tiled)
    assert got.dtype == dtype
    ref = qm.quant_matmul_plain(x, q.w_q, q.scales, q.biases, bits, gs)
    rel = 1e-2 if dtype == torch.bfloat16 else 1e-4
    assert _max_err(got, ref) <= rel * max(1.0, ref.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("n,k,gs", [
    # whisper large-v3's decode linears and logits; Qwen3-32B's down
    (1280, 1280, 64), (3840, 1280, 64), (5120, 1280, 64), (1280, 5120, 64),
    (51866, 1280, 64), (5120, 25600, 64),
    # K splits that leave the cluster's blocks ragged (21 and 15 groups), other
    # group sizes, one group
    (3840, 1344, 64), (200, 960, 64), (1000, 1024, 32), (600, 2048, 128), (70, 64, 64),
])
def test_quant_matmul_gemv_matches_plain(cuda, m, n, k, gs):
    """K5's tensor-core GEMV (int4, bf16 x, M <= 8) at the main paths'
    widths and ragged splits of K across the cluster."""
    gen = torch.Generator(device=cuda).manual_seed(m * 7 + n + k)
    w = torch.randn((n, k), generator=gen, device=cuda) / k ** 0.5
    q = tq.quantize(w, bits=4, group_size=gs)
    del w
    x = torch.randn((m, k), generator=gen, device=cuda).to(torch.bfloat16)
    before = qm.LAUNCHES
    got = tq.quant_matmul(x, q)
    torch.cuda.synchronize()
    assert qm.LAUNCHES == before + 1
    ref = qm.quant_matmul_plain(x, q.w_q, q.scales, q.biases, 4, gs)
    assert _max_err(got, ref) <= 1e-2 * max(1.0, ref.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kvh,tq_,tk,hd,causal", [
    (1, 8, 2, 130, 130, 128, True),
    (1, 64, 8, 256, 256, 128, True),
    (2, 4, 4, 37, 37, 64, True),
    (1, 3, 3, 100, 2100, 64, False),
    (1, 4, 2, 70, 70, 16, True),
    (1, 4, 2, 70, 90, 32, False),
    # the LLM phase's prefill lengths (not multiples of the tile), GQA rep 8 and 1
    (1, 64, 8, 295, 295, 128, True), (1, 8, 8, 384, 384, 128, True),
    (1, 16, 2, 1536, 1536, 128, True),
    # tq and tk in {1, 63, 64, 65}, hd 16-128, rep 1 and 8, causal and not
    (1, 8, 1, 1, 1, 128, True), (1, 8, 1, 63, 63, 64, True), (1, 8, 8, 64, 64, 32, True),
    (1, 8, 1, 65, 65, 16, True), (1, 8, 8, 1, 65, 128, False), (1, 8, 1, 63, 64, 64, False),
    (1, 8, 8, 64, 1, 16, False), (1, 8, 1, 65, 63, 32, False), (2, 16, 2, 65, 65, 128, False),
])
def test_flash_kernel_matches_plain(cuda, b, h, kvh, tq_, tk, hd, causal):
    gen = torch.Generator(device=cuda).manual_seed(tq_ + tk)
    s = hd ** -0.25
    q = (torch.randn((b, h, tq_, hd), generator=gen, device=cuda) * s).to(torch.bfloat16)
    k = (torch.randn((b, kvh, tk, hd), generator=gen, device=cuda) * s).to(torch.bfloat16)
    v = torch.randn((b, kvh, tk, hd), generator=gen, device=cuda).to(torch.bfloat16)
    before = fa.LAUNCHES
    got = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    _assert_rows_close(got, fa.flash_attention_plain(q, k, v, causal=causal))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["dense", "dense_bf16_softmax", "flash_causal", "flash",
                                    "decode_self", "decode_cross", "decode_int_dot",
                                    "quant_gemv", "quant_gemv_8rows", "mbt_gemv",
                                    "mbt_gemv_8rows", "mbt_gemv_cluster8", "a8_gemv",
                                    "quant_tiled", "quant_tiled_cluster", "quant_tiled_384",
                                    "mbt_tiled", "mbt_tiled_codes",
                                    "a8_gemv_8rows", "beamflat", "beamflat_int_dot",
                                    "beamflat_int4_distinct", "lane_move"])
def test_attention_kernels_repeat_bit_equal(cuda, kernel):
    """Two launches of K2 (either mode), K4, K3 (either mode, its cluster
    reduction across 2 and 8 blocks), K5's or K6's GEMV (a cluster split of
    K; K6 also across 8 blocks), K7's fused GEMV, K8 (either mode, one
    block and a cluster of 2; three chunks of rows when every history is
    distinct), K9's move or the tiled core of K5 and K6 (24 rows unsplit
    and split across a cluster, 384 rows; packed words and codes) on the
    same inputs agree bit for bit: no atomics, one fixed order of sums."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    if kernel.startswith("beamflat"):
        bits, kind = (4, "distinct") if kernel.endswith("distinct") else (8, "beam")
        inputs = _beamflat_case(cuda, bits, 4, 5, 448, kind, 7)
        for pos, cluster in ((226, 1), (400, 2)):
            assert bf.beamflat_plan(pos + 1, 5)[0] == cluster

            def run():
                return bf.beamflat_attention(*inputs, pos, 5, int_dot=kernel != "beamflat")
            first = run()
            _assert_rows_close(first, bf.beamflat_attention_plain(
                *inputs, pos, 5, int_dot=kernel != "beamflat"))
            torch.cuda.synchronize()
            assert torch.equal(first, run())
        return
    if kernel == "lane_move":
        base = _lane_tensors(gen, 40, cuda)
        src = _lane_move_map(40, 8, cuda)
        first, second = ([t.clone() for t in base] for _ in range(2))
        lp.lane_move_inplace(first, src)
        lp.lane_move_inplace(second, src)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, second))
        return
    if kernel.startswith(("decode", "quant", "mbt", "a8")):
        first, run = _repeat_case(cuda, gen, kernel)
        torch.cuda.synchronize()
        assert torch.equal(first, run())
        return
    hd, t, kvh = (64, 1500, 4) if kernel.startswith("dense") else (128, 640, 2)
    q, k, v = (torch.randn((2, 4 if i == 0 else kvh, t, hd), generator=gen, device=cuda)
               .mul(0.35 if i < 2 else 1.0).bfloat16() for i in range(3))
    if kernel.startswith("dense"):
        def run():
            return dn.dense_attention(q, k, v, fast_softmax=kernel == "dense_bf16_softmax")
    else:
        def run():
            return fa.flash_attention(q, k, v, causal=kernel == "flash_causal")
    first = run()
    torch.cuda.synchronize()
    assert torch.equal(first, run())


def _repeat_case(cuda, gen, kernel):
    """K3's or K5's inputs for the repeat test: (first output, rerun); K3's
    first output is also held to its plain version row by row."""
    if kernel.startswith(("quant", "mbt", "a8")):
        m = 8 if kernel.endswith("8rows") else 1
        n, k = (200, 4096) if kernel.endswith("cluster8") else (1280, 5120)
        if "tiled" in kernel:  # 24 rows (the 1280-wide linear split 8 ways), or 384
            m, n = (384, 10240) if kernel.endswith("384") else (24, 1280 if "cluster" in kernel else 51866)
            k = 1280 if m == 24 else 5120
        w = torch.randn((n, k), generator=gen, device=cuda) * 0.02
        q = tq.quantize(w, 4, 64)
        if kernel.startswith("mbt"):
            q = mb.transpose_quant(q, tile_n=512, depth=2, codes=kernel.endswith("codes"))
            if kernel.endswith("cluster8"):
                assert mb.mbt_gemv_plan(m, n, k, False, 64, 2, _sms())[0] == 8
        elif kernel.startswith("a8"):
            q = a8.requant_a8(w)
        x = torch.randn((m, k), generator=gen, device=cuda).to(torch.bfloat16)

        def run():
            return tq.quant_matmul(x, q)
        return run(), run
    bits, t, kw = ((8, 448, dict(pos=300, causal=True)) if kernel == "decode_self"
                   else (4, 1500, dict(valid_len=1500)))
    g = 5 if kernel == "decode_int_dot" else 1
    kx, vx = (torch.randn((2, 20, t, 64), generator=gen, device=cuda) for _ in range(2))
    k8, ks = kq.quantize_kv(kx * 0.35, bits)
    v8, vs = kq.quantize_kv(vx, bits)
    q = (torch.randn((2 * g, 20, 1, 64), generator=gen, device=cuda) * 0.35).to(torch.bfloat16)

    def run():
        return da.decode_attention(q, k8, ks, v8, vs, group=g,
                                   int_dot=kernel == "decode_int_dot", **kw)
    first = run()
    _assert_rows_close(first, da.decode_attention_plain(q, k8, ks, v8, vs, group=g,
                                                        int_dot=kernel == "decode_int_dot", **kw))
    return first, run


@pytest.mark.cuda
def test_llm_kernel_wrappers_reject_bad_inputs(cuda):
    q = torch.zeros((1, 2, 4, 64), device=cuda)  # float32: K4 takes bf16
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_attention(q, q, q)
    w = tq.quantize(torch.zeros((8, 64), device=cuda))
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        tq.quant_matmul(torch.zeros((1, 64), device=cuda, dtype=torch.float16), w)


@pytest.mark.cuda
@pytest.mark.parametrize("bound", ["0", "511"])
def test_quant_matmul_row_bound_below_512_raises_on_cuda(cuda, monkeypatch, bound):
    """A lower WTPU_QMM_PALLAS_MAX_ROWS would send K5's calls to a library
    matmul on the card: it raises there instead."""
    monkeypatch.setenv("WTPU_QMM_PALLAS_MAX_ROWS", bound)
    w = tq.quantize(torch.zeros((8, 64), device=cuda))
    before = qm.LAUNCHES
    with pytest.raises(ValueError, match="WTPU_QMM_PALLAS_MAX_ROWS"):
        tq.quant_matmul(torch.zeros((1, 64), device=cuda, dtype=torch.bfloat16), w)
    assert qm.LAUNCHES == before


@pytest.mark.cuda
def test_qwen_tiny_card_matches_cpu_and_needs_flash(cuda):
    """A tiny Qwen3 with random 4-bit weights: prefill (K4, K5 tiled) and
    decode steps (K5 GEMV) on the card against the plain versions on the
    CPU, same weights, bf16; a prefill with flash off raises on the card."""
    import dataclasses

    from whisper_mlx_tpu_torch.models import qwen as qw

    cfg = dataclasses.replace(qw.QWEN_CONFIGS["qwen3-8b"], hidden_size=256,
                              intermediate_size=512, num_hidden_layers=2, num_attention_heads=4,
                              num_key_value_heads=2, head_dim=64, vocab_size=300,
                              dtype=torch.bfloat16, flash_attention=True)
    params = qw.init_random_quant_params(cfg, seed=0, device=cuda)
    params_cpu = _to_cpu(params)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 300, (2, 40)))
    logits = {}
    for label, dev, p in (("cuda", cuda, params), ("cpu", torch.device("cpu"), params_cpu)):
        cache = qw.init_kv_cache(cfg, 2, 64, dev)
        out = [qw.decode_step(p, toks.to(dev), 0, cache, cfg)[0]]
        for i in range(3):
            out.append(qw.decode_step(p, toks[:, i:i + 1].to(dev), [40 + i, 40 + i], cache,
                                      cfg)[0])
        logits[label] = torch.cat(out, dim=1).cpu()
    ref = logits["cpu"]
    assert torch.isfinite(logits["cuda"]).all()
    assert _max_err(logits["cuda"], ref) <= 5e-2 * max(1.0, ref.abs().max().item())
    with pytest.raises(ValueError, match="flash_attention=True"):
        qw.decode_step(params, toks.to(cuda), 0, qw.init_kv_cache(cfg, 2, 64, cuda),
                       dataclasses.replace(cfg, flash_attention=False))


def _to_cpu(node):
    from whisper_mlx_tpu_torch.ops.quant import QuantTensor

    if isinstance(node, dict):
        return {k: _to_cpu(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_to_cpu(v) for v in node]
    if isinstance(node, QuantTensor):
        return QuantTensor(node.w_q.cpu(), node.scales.cpu(), node.biases.cpu(), node.bits,
                           node.group_size)
    return node.cpu()


# ---------------------------------------------------------------------------
# the LLM's weight residency: K6 (transposed dequant-matmul), K7 (W8A8)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k,bits,codes,contig,depth,dtype,gs", [
    (1, 200, 512, 4, False, False, 2, torch.bfloat16, 64),
    (3, 200, 512, 8, False, True, 3, torch.bfloat16, 64),
    (8, 1000, 1024, 4, True, False, 4, torch.bfloat16, 64),
    (2, 700, 2048, 4, False, False, 2, torch.bfloat16, 32),  # two groups in a ring slot
    (1, 300, 4096, 4, True, True, 3, torch.bfloat16, 128),  # a group over four slots
    (17, 200, 512, 4, False, False, 2, torch.bfloat16, 64),
    (128, 1000, 1024, 4, True, True, 2, torch.bfloat16, 64),
    (300, 130, 512, 8, False, True, 2, torch.bfloat16, 64),
    (5, 130, 256, 4, False, False, 1, torch.float32, 64),
    (40, 130, 256, 8, False, False, 8, torch.float32, 64),
    (1, 10240, 5120, 4, False, False, 2, torch.bfloat16, 64),  # Qwen3-32B qkv
    (4, 51200, 5120, 4, False, False, 8, torch.bfloat16, 64),  # gate_up
    (1, 5120, 25600, 4, False, False, 2, torch.bfloat16, 64),  # down
    (1, 5120, 8192, 4, True, False, 2, torch.bfloat16, 64),  # o, codes-resident
    (384, 10240, 5120, 4, False, False, 2, torch.bfloat16, 64),  # the 384-row prefill
    # the tiled core at its row blocks' edges, ragged N, group sizes 16-128,
    # 8 bits and codes-resident
    (9, 200, 512, 4, True, False, 2, torch.bfloat16, 32),
    (24, 1280, 1280, 4, False, False, 2, torch.bfloat16, 64),
    (24, 3840, 1280, 4, True, False, 2, torch.bfloat16, 64),
    (33, 130, 1024, 8, False, False, 2, torch.bfloat16, 16),
    (64, 1280, 5120, 4, False, False, 2, torch.bfloat16, 128),
    (65, 700, 2048, 4, True, False, 2, torch.bfloat16, 32),
    (128, 5120, 8192, 4, True, False, 2, torch.bfloat16, 64),
    (255, 300, 2048, 8, False, False, 2, torch.bfloat16, 64),
    (256, 5120, 1280, 4, False, False, 2, torch.bfloat16, 128),
    (257, 130, 5120, 4, True, False, 2, torch.bfloat16, 64),
    (511, 1000, 1024, 8, False, False, 2, torch.bfloat16, 32),
    (512, 5120, 25600, 4, False, False, 8, torch.bfloat16, 64),
])
def test_mbt_kernel_matches_plain(cuda, m, n, k, bits, codes, contig, depth, dtype, gs):
    gen = torch.Generator(device=cuda).manual_seed(m + n + k)
    w = torch.randn((n, k), generator=gen, device=cuda) / k ** 0.5
    qt = mb.transpose_quant(tq.quantize(w, bits=bits, group_size=gs), tile_n=512, depth=depth,
                            codes=codes, contig=contig)
    x = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
    before = (mb.LAUNCHES, mb.TILED_LAUNCHES)
    got = tq.quant_matmul(x, qt)
    torch.cuda.synchronize()
    tiled = dtype == torch.bfloat16 and m > qm.GEMV_ROWS
    assert (mb.LAUNCHES, mb.TILED_LAUNCHES) == (before[0] + 1, before[1] + tiled)
    assert got.dtype == dtype and got.shape == (m, n)
    ref = mb.quant_matmul_mbt_plain(x, qt)
    rel = 1e-2 if dtype == torch.bfloat16 else 1e-4
    assert _max_err(got, ref) <= rel * max(1.0, ref.float().abs().max().item())


# (rows, N, K, group size, blocks of the cluster): K's stages split into 1,
# 2, 4 and 8 blocks at 16, 24 and 40 rows; groups of 128 k (two stages, one
# unit a block) over a number of units the cluster does not divide, so a
# naive split by stages would cut a group
TILED_CLUSTER_EDGES = [
    (16, 10240, 512, 128, 1), (24, 10240, 512, 32, 2), (24, 200, 512, 128, 4),
    (24, 5120, 1280, 128, 4), (40, 200, 512, 32, 8), (40, 200, 1280, 128, 8),
    (16, 200, 1280, 128, 8), (24, 1000, 1344, 64, 8), (128, 10240, 5120, 64, 2),
    (128, 5120, 8192, 64, 4),
]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["k5", "k6", "k6_codes"])
@pytest.mark.parametrize("m,n,k,gs,cluster", TILED_CLUSTER_EDGES)
def test_tiled_cluster_edges_match_plain(cuda, layout, m, n, k, gs, cluster):
    """The tiled core (K5's words, K6's packed words and codes) at the
    edges of its cluster split of K, one launch a call, bit-equal on a
    repeat."""
    wbytes = 32 if layout != "k6_codes" else 64
    assert qm.tiled_plan(m, n, k, gs, wbytes, _sms(), layout == "k5").cluster == cluster
    gen = torch.Generator(device=cuda).manual_seed(m + n + k + gs)
    q = tq.quantize(torch.randn((n, k), generator=gen, device=cuda) / k ** 0.5, bits=4,
                    group_size=gs)
    x = torch.randn((m, k), generator=gen, device=cuda).to(torch.bfloat16)
    if layout == "k5":
        leaf, module = q, qm
        ref = qm.quant_matmul_plain(x, q.w_q, q.scales, q.biases, 4, gs)
    else:
        leaf, module = mb.transpose_quant(q, tile_n=16, depth=2, codes=layout == "k6_codes"), mb
        ref = mb.quant_matmul_mbt_plain(x, leaf)
    before = (module.LAUNCHES, module.TILED_LAUNCHES)
    got = tq.quant_matmul(x, leaf)
    torch.cuda.synchronize()
    assert (module.LAUNCHES, module.TILED_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert _max_err(got, ref) <= 1e-2 * max(1.0, ref.float().abs().max().item())
    assert torch.equal(got, tq.quant_matmul(x, leaf))


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k,depth,dtype", [
    (1, 200, 512, 4, torch.bfloat16),
    (3, 200, 512, 4, torch.bfloat16),
    (8, 1000, 1024, 4, torch.bfloat16),
    (9, 130, 256, 4, torch.bfloat16),
    (128, 1000, 1024, 4, torch.bfloat16),
    (300, 130, 512, 4, torch.bfloat16),
    (17, 200, 96, 4, torch.bfloat16),  # K not a multiple of 64: the GEMV in row groups
    (5, 130, 256, 4, torch.float32),
    (40, 130, 256, 4, torch.float32),
    (1, 10240, 5120, 4, torch.bfloat16),  # Qwen3-32B qkv
    (4, 51200, 5120, 4, torch.bfloat16),  # gate_up
    (1, 5120, 25600, 1, torch.bfloat16),  # down (depth 1 keeps it under the VMEM rule)
    (4, 5120, 8192, 4, torch.bfloat16),  # o
    (8, 5120, 25600, 1, torch.float32),  # down, fp32 x, 8 rows
    (384, 10240, 5120, 4, torch.bfloat16),  # the 384-row prefill
])
def test_a8_kernel_matches_plain(cuda, m, n, k, depth, dtype):
    gen = torch.Generator(device=cuda).manual_seed(m + n + k)
    w = torch.randn((n, k), generator=gen, device=cuda) / k ** 0.5
    at = a8.requant_a8(w, tile_n=512, depth=depth)
    assert a8.a8_fits(at, m)
    x = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
    before = a8.LAUNCHES
    got = tq.quant_matmul(x, at)
    torch.cuda.synchronize()
    assert a8.LAUNCHES == before + 1 and got.dtype == dtype and got.shape == (m, n)
    # both routes (the fused GEMV, the tiled GEMM) take exact int32 sums and
    # the plain version's roundings: bit-equal
    assert torch.equal(got, a8.a8_matmul_plain(x, at))


# row counts at each edge of the tiled GEMM's 16-, 32-, 64- and 128-row
# blocks, past 512 rows, and the Qwen3-32B shapes a prefill gives it
A8_TILED_M = [9, 16, 17, 63, 64, 65, 127, 128, 129, 384, 511, 512, 1000]


@pytest.mark.cuda
@pytest.mark.parametrize("m", A8_TILED_M)
@pytest.mark.parametrize("n,k", [(200, 320), (1000, 1024), (130, 2112), (5120, 8192)])
def test_a8_tiled_bit_equal(cuda, m, n, k):
    """K7's tiled route (x quantized, then wgmma s8 from a TMA ring, K split
    across a cluster as a8_tiled_plan says) at its row-block edges, ragged
    N, K an odd multiple of 64: bit-equal to the plain version with bf16
    and fp32 x, and on a repeat."""
    gen = torch.Generator(device=cuda).manual_seed(m + n + k)
    at = a8.requant_a8(torch.randn((n, k), generator=gen, device=cuda) / k ** 0.5)
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
        before = (a8.LAUNCHES, a8.TILED_LAUNCHES)
        got = a8.a8_matmul_kernel(x, at)
        torch.cuda.synchronize()
        assert (a8.LAUNCHES, a8.TILED_LAUNCHES) == (before[0] + 1, before[1] + 1)
        assert got.dtype == dtype and got.shape == (m, n)
        assert torch.equal(got, a8.a8_matmul_plain(x, at))
        assert torch.equal(got, a8.a8_matmul_kernel(x, at))


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k,cluster", [
    (24, 10240, 5120, 1), (64, 5120, 25600, 2), (24, 3000, 16384, 4), (16, 1000, 8192, 8),
    (128, 5120, 25600, 1), (384, 10240, 5120, 1)])
def test_a8_tiled_cluster_edges_bit_equal(cuda, m, n, k, cluster):
    """The tiled GEMM as its plan splits K over 1, 2, 4 and 8 blocks a
    cluster (Qwen3-32B's qkv and down among them): the int32 partials
    summed in block order are the plain version's sums, bit for bit."""
    assert a8.a8_tiled_plan(m, n, k, _sms()).cluster == cluster
    gen = torch.Generator(device=cuda).manual_seed(m + n + k)
    at = a8.requant_a8(torch.randn((n, k), generator=gen, device=cuda) / k ** 0.5)
    x = torch.randn((m, k), generator=gen, device=cuda).to(torch.bfloat16)
    got = a8.a8_matmul_kernel(x, at)
    torch.cuda.synchronize()
    assert torch.equal(got, a8.a8_matmul_plain(x, at))


@pytest.mark.cuda
@pytest.mark.parametrize("nt", [16, 32, 64, 128])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_a8_tiled_forced_splits_bit_equal(cuda, nt, cluster):
    """The tiled GEMM's entry at every block height and cluster size, past
    what the plan would choose (a cluster's sum of chunks of one value a
    thread at 16 rows and 8 blocks): bit-equal to the plain version, ragged
    rows, channels and K."""
    m, n, k = nt + 3, 300, 1088
    gen = torch.Generator(device=cuda).manual_seed(nt * cluster)
    at = a8.requant_a8(torch.randn((n, k), generator=gen, device=cuda) / k ** 0.5)
    x = torch.randn((m, k), generator=gen, device=cuda).to(torch.bfloat16)
    xq = torch.empty((m, k), dtype=torch.int8, device=cuda)
    sx = torch.empty((m,), dtype=torch.float32, device=cuda)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    lib = _build.lib()
    _build.check(lib.wmt_a8_quantize(x.data_ptr(), xq.data_ptr(), sx.data_ptr(), m, k, 1, stream),
                 "wmt_a8_quantize")
    _build.check(lib.wmt_a8_gemm(xq.data_ptr(), sx.data_ptr(), at.codes.data_ptr(),
                                 at.scale.data_ptr(), out.data_ptr(), m, n, k, 1, nt, cluster,
                                 4 if nt == 128 else 2, stream), "wmt_a8_gemm")
    torch.cuda.synchronize()
    assert torch.equal(out, a8.a8_matmul_plain(x, at))


def _sms() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 24])
@pytest.mark.parametrize("bits,codes,gs", [
    (4, False, 16), (4, False, 48), (4, False, 80), (4, False, 96), (4, True, 16),
    (4, True, 48), (4, True, 80), (4, True, 96), (8, False, 8), (8, False, 48), (4, False, 8)])
def test_mbt_group_sizes_match_plain(cuda, m, bits, codes, gs):
    """K6 at group sizes the reference takes that neither the tensor-core
    GEMV nor the tiled core does (F4): the SIMT GEMV's slot carries every
    group its codes touch. Packed and codes-resident, 1, 8 and 24 rows."""
    k, n = 1920 if gs in (48, 80, 96) else 2048, 300
    gen = torch.Generator(device=cuda).manual_seed(m + gs + bits)
    qt = mb.transpose_quant(tq.quantize(torch.randn((n, k), generator=gen, device=cuda)
                                        / k ** 0.5, bits=bits, group_size=gs),
                            tile_n=16, depth=2, codes=codes)
    assert qt.codes_resident == codes
    x = torch.randn((m, k), generator=gen, device=cuda).to(torch.bfloat16)
    before = mb.LAUNCHES
    got = tq.quant_matmul(x, qt)
    torch.cuda.synchronize()
    assert mb.LAUNCHES == before + 1
    ref = mb.quant_matmul_mbt_plain(x, qt)
    assert _max_err(got, ref) <= 1e-2 * max(1.0, ref.float().abs().max().item())
    assert torch.equal(got, tq.quant_matmul(x, qt))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("codes,n,k,gs,cluster", [
    # K split into 1, 2, 7 and 8 blocks (stages of 256 k packed, 128 k
    # codes-resident); N not a multiple of the block's 128 columns
    (False, 200, 256, 64, 1), (False, 33800, 512, 64, 1), (False, 130, 512, 64, 2),
    (False, 200, 1792, 64, 7), (False, 1000, 4096, 64, 8), (True, 200, 128, 64, 1),
    (True, 200, 256, 64, 2), (True, 130, 896, 64, 7), (True, 1000, 2048, 32, 8),
    # a group spanning a whole stage: both halves of a block's warps take
    # parts of it, one adds its bias (a cluster's blocks split K on stage
    # boundaries, which are group boundaries, so no group straddles them);
    # groups of 32 and 128
    (False, 200, 1792, 256, 7), (True, 200, 1024, 128, 8), (False, 300, 2048, 32, 8),
])
def test_mbt_gemv_cluster_edges_match_plain(cuda, m, codes, n, k, gs, cluster):
    """K6's tensor-core GEMV (bf16 x, 4-bit codes) at the edges of its
    cluster split of K, one launch a call."""
    assert mb.mbt_gemv_plan(m, n, k, codes, gs, 2, _sms())[0] == cluster
    gen = torch.Generator(device=cuda).manual_seed(m + n + k + gs)
    w = torch.randn((n, k), generator=gen, device=cuda) / k ** 0.5
    qt = mb.transpose_quant(tq.quantize(w, bits=4, group_size=gs), tile_n=16, depth=2,
                            codes=codes)
    x = torch.randn((m, k), generator=gen, device=cuda).to(torch.bfloat16)
    before = mb.LAUNCHES
    got = tq.quant_matmul(x, qt)
    torch.cuda.synchronize()
    assert mb.LAUNCHES == before + 1
    ref = mb.quant_matmul_mbt_plain(x, qt)
    assert _max_err(got, ref) <= 1e-2 * max(1.0, ref.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("n,k,cluster", [
    # K in 256-k chunks split into 1, 2, 7 and 8 blocks; N not a multiple of
    # the block's 128 channels; K not a multiple of the chunk or of a box
    (200, 256, 1), (33800, 512, 1), (130, 512, 2), (200, 1792, 7), (1000, 4096, 8),
    (200, 1824, 8), (300, 80, 1), (300, 384, 2),
])
def test_a8_gemv_cluster_edges_bit_equal(cuda, m, n, k, cluster):
    """K7's fused GEMV at the edges of its cluster split of K: bit-equal to
    the plain version, bf16 and fp32 x."""
    assert a8.a8_gemv_plan(m, n, k, _sms())[0] == cluster
    gen = torch.Generator(device=cuda).manual_seed(m + n + k)
    at = a8.requant_a8(torch.randn((n, k), generator=gen, device=cuda) / k ** 0.5)
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
        before = a8.LAUNCHES
        got = a8.a8_matmul_kernel(x, at)
        torch.cuda.synchronize()
        assert a8.LAUNCHES == before + 1
        assert torch.equal(got, a8.a8_matmul_plain(x, at))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,stages,cluster", [
    ("a8", 2, 1), ("a8", 2, 2), ("a8", 5, 4), ("mbt", 1, None), ("mbt", 2, None)])
def test_gemv_ring_reuse_matches_plain(cuda, kernel, stages, cluster):
    """K7's and K6's rings recycled many times over a grid of thousands of
    blocks, 8 rows (a TMA box must not land over a stage before every
    consumer has read it): K7 bit-equal to its plain version and K6 within
    the quantized matmul's tolerance, twice over."""
    gen = torch.Generator(device=cuda).manual_seed(21)
    n, k, m = 65536, 5120, 8
    w = torch.randn((n, k), generator=gen, device=cuda) / k ** 0.5
    x = torch.randn((m, k), generator=gen, device=cuda).to(torch.bfloat16)
    if kernel == "a8":
        at = a8.requant_a8(w)
        ref = a8.a8_matmul_plain(x, at)
        for _ in range(2):
            out = torch.empty((m, n), dtype=torch.bfloat16, device=cuda)
            _build.check(_build.lib().wmt_a8_gemv(
                x.data_ptr(), at.codes.data_ptr(), at.scale.data_ptr(), out.data_ptr(), m, n, k, 1,
                cluster, stages, torch.cuda.current_stream().cuda_stream), "wmt_a8_gemv")
            torch.cuda.synchronize()
            assert torch.equal(out, ref)
        return
    qt = mb.transpose_quant(tq.quantize(w, bits=4, group_size=64), depth=stages, codes=False)
    ref = mb.quant_matmul_mbt_plain(x, qt)
    first = tq.quant_matmul(x, qt)
    torch.cuda.synchronize()
    assert _max_err(first, ref) <= 1e-2 * max(1.0, ref.float().abs().max().item())
    assert torch.equal(first, tq.quant_matmul(x, qt))


@pytest.mark.cuda
def test_qmm_mb_routes_packed_weights_through_k6(cuda, monkeypatch):
    gen = torch.Generator(device=cuda).manual_seed(2)
    q = tq.quantize(torch.randn((300, 512), generator=gen, device=cuda) / 16, bits=4)
    x = torch.randn((2, 512), generator=gen, device=cuda).to(torch.bfloat16)
    monkeypatch.setenv("WTPU_QMM_MB", "3,128")
    before = (mb.LAUNCHES, qm.LAUNCHES)
    got = tq.quant_matmul(x, q)
    torch.cuda.synchronize()
    assert (mb.LAUNCHES, qm.LAUNCHES) == (before[0] + 1, before[1])
    ref = qm.quant_matmul_plain(x, q.w_q, q.scales, q.biases, 4, 64)
    assert _max_err(got, ref) <= 1e-2 * max(1.0, ref.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("leaf", ["mbt", "a8"])
@pytest.mark.parametrize("bound", ["0", "511"])
def test_residency_row_bound_below_512_raises_on_cuda(cuda, monkeypatch, leaf, bound):
    q = tq.quantize(torch.zeros((8, 64), device=cuda))
    w = mb.transpose_quant(q) if leaf == "mbt" else a8.requant_a8(q)
    monkeypatch.setenv("WTPU_QMM_PALLAS_MAX_ROWS", bound)
    before = (mb.LAUNCHES, a8.LAUNCHES)
    with pytest.raises(ValueError, match="WTPU_QMM_PALLAS_MAX_ROWS"):
        tq.quant_matmul(torch.zeros((1, 64), device=cuda, dtype=torch.bfloat16), w)
    assert (mb.LAUNCHES, a8.LAUNCHES) == before


@pytest.mark.cuda
@pytest.mark.parametrize("env,leaf,module", [("WTPU_MBT_RESIDENT", "QuantTensorT", mb),
                                             ("WTPU_QWEN_A8", "A8Tensor", a8),
                                             ("WTPU_NATIVE_RESIDENT", "NativeQuantTensor", qm)])
def test_qwen_tiny_residency_card_matches_cpu(cuda, monkeypatch, env, leaf, module):
    """A tiny Qwen3 with random 4-bit weights through LLMEngine under each
    residency opt-in: prefill and decode steps on the card (K6, K7, or for
    native residency K5 at the decode steps' rows and dequantize + matmul
    at the prefill's 80) against the plain versions on the CPU, same
    weights, bf16."""
    import dataclasses

    from whisper_mlx_tpu_torch.decoding.llm_tokenizer import ByteFallbackTokenizer
    from whisper_mlx_tpu_torch.inference.generate import LLMEngine
    from whisper_mlx_tpu_torch.models import qwen as qw

    cfg = dataclasses.replace(qw.QWEN_CONFIGS["qwen3-8b"], hidden_size=256,
                              intermediate_size=512, num_hidden_layers=2, num_attention_heads=4,
                              num_key_value_heads=2, head_dim=64, vocab_size=300,
                              dtype=torch.bfloat16, flash_attention=True)
    params = qw.init_random_quant_params(cfg, seed=0, device=cuda)
    params_cpu = _to_cpu(params)
    monkeypatch.setenv(env, "1")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 300, (2, 40)))
    logits = {}
    before = module.LAUNCHES
    for label, dev, p in (("cuda", cuda, params), ("cpu", torch.device("cpu"), params_cpu)):
        eng = LLMEngine(p, cfg, ByteFallbackTokenizer())
        assert type(eng.params["layers"][0]["mlp"]["down"]["w"]).__name__ == leaf
        cache = qw.init_kv_cache(cfg, 2, 64, dev)
        out = [qw.decode_step(eng.params, toks.to(dev), 0, cache, cfg)[0]]
        for i in range(3):
            out.append(qw.decode_step(eng.params, toks[:, i:i + 1].to(dev), [40 + i, 40 + i],
                                      cache, cfg)[0])
        logits[label] = torch.cat(out, dim=1).cpu()
    assert module.LAUNCHES > before
    ref = logits["cpu"]
    assert torch.isfinite(logits["cuda"]).all()
    assert _max_err(logits["cuda"], ref) <= 5e-2 * max(1.0, ref.abs().max().item())


# ---------------------------------------------------------------------------
# the beam path: K3's integer-dot mode, K8, K9
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("bits,n,g,tq,t,kw", [
    (8, 8, 1, 1, 256, dict(pos=226, causal=True)),
    (8, 40, 1, 3, 256, dict(pos=0, causal=True)),
    (4, 8, 5, 1, 1500, dict(valid_len=1500)),
    (4, 8, 5, 3, 1500, dict(valid_len=1500)),
    (8, 2, 1, 1, 384, dict(valid_len=333)),
])
def test_decode_kernel_int_dot_matches_plain(cuda, bits, n, g, tq, t, kw):
    gen = torch.Generator(device=cuda).manual_seed(2)
    kx, vx = (torch.randn((n, 20, t, 64), generator=gen, device=cuda) for _ in range(2))
    k8, ks = kq.quantize_kv(kx * 0.35, bits)
    v8, vs = kq.quantize_kv(vx, bits)
    q = (torch.randn((n * g, 20, tq, 64), generator=gen, device=cuda) * 0.35).to(torch.bfloat16)
    before = (da.LAUNCHES, da.INT_DOT_LAUNCHES)
    got = kq.attention_int8_mxu(q, k8, ks, v8, vs, group=g, **kw)
    torch.cuda.synchronize()
    assert (da.LAUNCHES, da.INT_DOT_LAUNCHES) == (before[0], before[1] + 1)
    ref = da.decode_attention_plain(q, k8, ks, v8, vs, group=g, int_dot=True, **kw)
    _assert_rows_close(got, ref)


def _beam_ancestry(gen, n, g, t_pos, device):
    anc = torch.arange(g, dtype=torch.int32, device=device)[None, :, None].repeat(n, 1, t_pos)
    for t in range(1, t_pos):
        parent = torch.randint(0, g, (n, g, 1), generator=gen, device=device)
        anc[:, :, :t] = anc[:, :, :t].gather(1, parent.expand(-1, -1, t))
    return anc.reshape(n * g, t_pos).contiguous()


def _ancestry(kind, gen, n, g, t_pos, device):
    """K8's ancestry: as a beam builds it ("beam": lanes share most of their
    history), every lane's history its own ("distinct": g rows a
    position), one history for all ("shared": one row a position), or one
    random history for all up to position N and every lane's own from N
    ("runN": an agreed run of N positions; "rejoinN": the lanes apart at N,
    N + 1 and N + 2 only, agreeing again after)."""
    if kind == "beam":
        return _beam_ancestry(gen, n, g, t_pos, device)
    rejoin = kind.startswith("rejoin")
    if rejoin or kind.startswith("run"):
        start = int(kind.removeprefix("rejoin" if rejoin else "run"))
        anc = torch.randint(0, g, (n, 1, t_pos), generator=gen, device=device,
                            dtype=torch.int32).repeat(1, g, 1)
        t = torch.arange(t_pos, device=device)
        apart = (t >= start) & ((t < start + 3) if rejoin else True)
        own = torch.arange(g, dtype=torch.int32, device=device)[None, :, None]
        anc = torch.where(apart[None, None], own, anc)
        return anc.reshape(n * g, t_pos).contiguous()
    lanes = torch.arange(n * g, dtype=torch.int32, device=device) % g
    if kind == "shared":
        lanes = torch.zeros_like(lanes)
    return lanes[:, None].repeat(1, t_pos).contiguous()


def _beamflat_case(cuda, bits, n, g, t_pos, kind, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    kx, vx = (torch.randn((n, 20, t_pos * g, 64), generator=gen, device=cuda)
              for _ in range(2))
    k8, ks = kq.quantize_kv(kx * 0.35, bits)
    v8, vs = kq.quantize_kv(vx, bits)
    anc = _ancestry(kind, gen, n, g, t_pos, cuda)
    q = (torch.randn((n * g, 20, 1, 64), generator=gen, device=cuda) * 0.35).to(torch.bfloat16)
    return q, k8, ks, v8, vs, anc


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("int_dot", [False, True])
@pytest.mark.parametrize("n,g,t_pos,pos,kind", [
    (8, 5, 256, 226, "beam"), (8, 5, 256, 226, "distinct"), (8, 5, 256, 226, "shared"),
    (2, 3, 128, 0, "beam"), (1, 2, 448, 447, "beam"), (3, 1, 64, 63, "beam"),
    (2, 8, 128, 127, "beam"), (2, 8, 128, 100, "distinct"), (1, 11, 96, 95, "beam"),
    (1, 11, 96, 95, "distinct"), (2, 5, 448, 255, "beam"), (2, 5, 448, 256, "distinct"),
    (1, 5, 448, 447, "beam"), (1, 5, 2048, 2047, "beam"), (1, 11, 448, 300, "beam"),
    (1, 11, 448, 300, "distinct"), (8, 5, 256, 226, "run0"), (8, 5, 256, 226, "run17"),
    (2, 5, 448, 447, "rejoin230"), (1, 11, 448, 300, "run160")])
def test_beamflat_kernel_matches_plain(cuda, bits, int_dot, n, g, t_pos, pos, kind):
    """K8 against its plain version, query row by query row: beam-built,
    all-distinct and shared ancestries; g 1, 8 (one full mma tile of lanes)
    and 11 (two passes, also in a cluster of two); pos 0, at the plan's span
    edges (255: one block a cluster, 256: two), at T - 1 (447: two blocks;
    2047: eight of 256 positions); more distinct rows than a chunk holds
    (distinct); agreed runs (the flat mode's run route) of 0 and 17
    positions, ending inside the second block of a cluster, and lanes
    agreeing again after parting."""
    q, k8, ks, v8, vs, anc = _beamflat_case(cuda, bits, n, g, t_pos, kind, pos + g)
    before = bf.LAUNCHES
    got = bf.beamflat_attention(q, k8, ks, v8, vs, anc, pos, g, int_dot=int_dot)
    torch.cuda.synchronize()
    assert bf.LAUNCHES == before + 1
    ref = bf.beamflat_attention_plain(q, k8, ks, v8, vs, anc, pos, g, int_dot=int_dot)
    _assert_rows_close(got, ref)


def _split_case(cuda, n, g, t_pos, pos, fills, seed):
    """The split mode's inputs: an int8 flat cache, queries, an ancestry
    as a beam builds it whose lanes agree below each window's s_fill (as
    the shared scheme's commits keep it), and s_fill (n,) int32."""
    q, k8, ks, v8, vs, anc = _beamflat_case(cuda, 8, n, g, t_pos, "beam", seed)
    anc = anc.reshape(n, g, t_pos)
    s_fill = torch.tensor([min(f, pos) if f >= 0 else pos // 2 + w for w, f in enumerate(fills)],
                          dtype=torch.int32, device=cuda)
    for w in range(n):
        f = int(s_fill[w])
        anc[w, :, :f] = anc[w, :1, :f]
    return q, k8, ks, v8, vs, anc.reshape(n * g, t_pos).contiguous(), s_fill


@pytest.mark.cuda
@pytest.mark.parametrize("int_dot", [False, True])
@pytest.mark.parametrize("n,g,t_pos,pos,fills", [
    # s_fill 0, mid (-1: pos // 2 + window), pos; one block, then clusters
    (8, 5, 256, 226, (0, -1, 226, 100, 200, 0, -1, 226)), (2, 3, 128, 0, (0, 0)),
    (2, 5, 448, 255, (0, -1)), (2, 5, 448, 256, (256, -1)), (1, 5, 448, 447, (300,)),
    (1, 11, 448, 300, (-1,)), (1, 5, 2048, 2047, (1000,)), (2, 8, 128, 127, (127, 3)),
    # s_fill at a 16-row tile's edges, and at 255 and 256 and a block's
    # edge (224 of 448, 256 of 2048) in clusters
    (8, 5, 256, 226, (1, 15, 16, 17, 1, 15, 16, 17)), (2, 5, 448, 447, (255, 256)),
    (2, 5, 448, 447, (224, 223)), (1, 5, 2048, 2047, (256,)), (1, 11, 600, 599, (255,))])
def test_beamflat_split_matches_plain(cuda, int_dot, n, g, t_pos, pos, fills):
    """K8's split mode (the shared-prefix scheme, int8) against its plain
    version query row by query row, at s_fill 0, mid and pos, at a 16-row
    tile's edges (1, 15, 16, 17), in one block and in clusters of 2 to 8 (a
    block holding positions on both sides of the split, s_fill at 255, 256
    and a block's edge); a repeat bit-equal; with the overflow flag set it
    equals the flat mode bit for bit; one launch a call, counted as a
    split."""
    q, k8, ks, v8, vs, anc, s_fill = _split_case(cuda, n, g, t_pos, pos, fills, pos + g)
    before = (bf.LAUNCHES, bf.SPLIT_LAUNCHES)
    off = torch.zeros((), dtype=torch.bool, device=cuda)
    got = bf.beamflat_attention(q, k8, ks, v8, vs, anc, pos, g, int_dot=int_dot, s_fill=s_fill,
                                overflow=off)
    torch.cuda.synchronize()
    assert (bf.LAUNCHES, bf.SPLIT_LAUNCHES) == (before[0] + 1, before[1] + 1)
    ref = bf.beamflat_attention_plain(q, k8, ks, v8, vs, anc, pos, g, int_dot, s_fill)
    _assert_rows_close(got, ref)
    assert torch.equal(got, bf.beamflat_attention(q, k8, ks, v8, vs, anc, pos, g,
                                                  int_dot=int_dot, s_fill=s_fill))
    flat = bf.beamflat_attention(q, k8, ks, v8, vs, anc, pos, g, int_dot=int_dot)
    over = bf.beamflat_attention(q, k8, ks, v8, vs, anc, pos, g, int_dot=int_dot,
                                 s_fill=s_fill, overflow=torch.ones_like(off))
    assert torch.equal(over, flat)


@pytest.mark.cuda
@pytest.mark.parametrize("int_dot", [False, True])
@pytest.mark.parametrize("n,g,t_pos,pos,kind,fills", [
    (8, 5, 256, 226, "distinct", (0, 100, 200, 226, 1, 17, 50, 226)),
    (1, 5, 448, 447, "distinct", (300,)), (1, 11, 448, 300, "distinct", (200,)),
    # W's agreed run goes on past s_fill (to 40, 200, 300), ending at and
    # inside a 16-row tile, in a cluster's later block; lanes agreeing again
    # after parting at 50
    (8, 5, 256, 226, "run40", (0, 17, 39, 40, 41, 100, 226, 16)),
    (8, 5, 256, 226, "run200", (100, 190, 199, 200, 201, 0, 17, 226)),
    (8, 5, 256, 226, "rejoin50", (0, 49, 50, 51, 52, 53, 60, 226)),
    (2, 5, 448, 447, "run300", (100, 250)), (1, 11, 448, 300, "run200", (150,))])
def test_beamflat_split_reads_the_first_lane_below_s_fill(cuda, int_dot, n, g, t_pos, pos, kind,
                                                         fills):
    """Lanes that disagree below s_fill (every lane's history its own, or
    its own from the end of an agreed run on): block S reads the window's
    first lane's row for every lane, as the reference's single copy S
    holds it, and block W's agreed run may go on past s_fill. Row by row
    against the plain version, in one block and in clusters; a repeat
    bit-equal; the overflow flag gives the flat mode bit for bit."""
    q, k8, ks, v8, vs, anc = _beamflat_case(cuda, 8, n, g, t_pos, kind, pos + 1)
    s_fill = torch.tensor([min(f, pos) for f in fills], dtype=torch.int32, device=cuda)
    got = bf.beamflat_attention(q, k8, ks, v8, vs, anc, pos, g, int_dot=int_dot, s_fill=s_fill)
    torch.cuda.synchronize()
    _assert_rows_close(got, bf.beamflat_attention_plain(q, k8, ks, v8, vs, anc, pos, g, int_dot,
                                                        s_fill))
    assert torch.equal(got, bf.beamflat_attention(q, k8, ks, v8, vs, anc, pos, g,
                                                  int_dot=int_dot, s_fill=s_fill))
    over = bf.beamflat_attention(q, k8, ks, v8, vs, anc, pos, g, int_dot=int_dot, s_fill=s_fill,
                                 overflow=torch.ones((), dtype=torch.bool, device=cuda))
    assert torch.equal(over, bf.beamflat_attention(q, k8, ks, v8, vs, anc, pos, g,
                                                   int_dot=int_dot))


@pytest.mark.cuda
def test_beamflat_split_rejects_what_it_does_not_take(cuda):
    """The split mode takes int8 codes and an (n,) int32 s_fill; the
    per-lane mode a per-lane cache: each raises before any launch."""
    q, k8, ks, v8, vs, anc = _beamflat_case(cuda, 4, 2, 3, 64, "beam", 1)
    before = bf.LAUNCHES
    fill = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int8"):
        bf.beamflat_attention(q, k8, ks, v8, vs, anc, 10, 3, s_fill=fill)
    q, k8, ks, v8, vs, anc = _beamflat_case(cuda, 8, 2, 3, 64, "beam", 1)
    with pytest.raises(ValueError, match="s_fill"):
        bf.beamflat_attention(q, k8, ks, v8, vs, anc, 10, 3, s_fill=fill.long())
    with pytest.raises(ValueError, match="overflow without s_fill"):
        bf.beamflat_attention(q, k8, ks, v8, vs, anc, 10, 3,
                              overflow=torch.zeros((), dtype=torch.bool, device=cuda))
    with pytest.raises(ValueError, match="per-lane cache"):
        bf.ancestry_attention(q, k8, ks, v8, vs, anc, 10, 3)
    assert bf.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("n,g,t_pos,pos,kind", [
    (8, 5, 256, 226, "beam"), (8, 5, 256, 226, "distinct"), (2, 3, 128, 0, "beam"),
    (2, 8, 128, 127, "distinct"), (1, 11, 96, 95, "beam"), (2, 5, 448, 256, "beam"),
    (1, 5, 448, 447, "distinct"), (1, 11, 448, 300, "beam"),
    # agreed runs of 0, 1, 16, 17, pos and pos + 1 positions, agreement
    # returning after the lanes part, runs ending in a cluster's later block
    (8, 5, 256, 226, "run0"), (8, 5, 256, 226, "run1"), (8, 5, 256, 226, "run16"),
    (8, 5, 256, 226, "run17"), (8, 5, 256, 226, "run226"), (8, 5, 256, 226, "run227"),
    (8, 5, 256, 226, "rejoin40"), (2, 5, 448, 447, "run230"), (2, 5, 448, 447, "rejoin100"),
    (1, 11, 448, 300, "run150")])
def test_beamflat_lane_layout_matches_plain(cuda, bits, n, g, t_pos, pos, kind):
    """K8's per-lane layout (``decode_step(beam_ancestry=)`` over a
    per-lane cache, fp mode) against ``attention_int8_ancestry``'s plain
    version query row by query row, on beam-built and all-distinct
    ancestries and agreed runs of every edge length, one block and
    clusters; a repeat bit-equal; one launch a call, counted as a per-lane
    one."""
    gen = torch.Generator(device=cuda).manual_seed(pos + g)
    kx, vx = (torch.randn((n * g, 20, t_pos, 64), generator=gen, device=cuda)
              for _ in range(2))
    k8, ks = kq.quantize_kv(kx * 0.35, bits)
    v8, vs = kq.quantize_kv(vx, bits)
    anc = _ancestry(kind, gen, n, g, t_pos, cuda)
    q = (torch.randn((n * g, 20, 1, 64), generator=gen, device=cuda) * 0.35).to(torch.bfloat16)
    before = (bf.LAUNCHES, bf.LANE_LAUNCHES)
    got = bf.ancestry_attention(q, k8, ks, v8, vs, anc, pos, g)
    torch.cuda.synchronize()
    assert (bf.LAUNCHES, bf.LANE_LAUNCHES) == (before[0] + 1, before[1] + 1)
    _assert_rows_close(got, bf.attention_int8_ancestry_plain(q, k8, ks, v8, vs, anc, pos, g))
    assert torch.equal(got, bf.ancestry_attention(q, k8, ks, v8, vs, anc, pos, g))


@pytest.mark.cuda
def test_decode_step_lane_ancestry_runs_k8_not_k3(cuda):
    """F9 on the card: decode_step with beam_ancestry over a per-lane int8
    self cache runs K8's per-lane layout for self-attention (K3 only for
    the cross cache, once a layer) and gives the CPU's logits."""
    from whisper_mlx_tpu_torch.decoding.tokenizer import make_synthetic_tokenizer
    from whisper_mlx_tpu_torch.models import whisper as tw

    tok = make_synthetic_tokenizer()
    cfg = tw.WhisperConfig(n_vocab=tok.n_vocab, n_audio_state=128, n_audio_head=2,
                           n_audio_layer=2, n_text_state=128, n_text_head=2, n_text_layer=2,
                           dtype=torch.bfloat16, flash_attention=True, kv_bits=8,
                           self_kv_bits=8)
    params = tw.init_params(cfg, seed=0, device=cuda, dtype=torch.bfloat16)
    states = torch.randn((2, 1500, 128), generator=torch.Generator().manual_seed(0)) \
        .to(torch.bfloat16)
    init = torch.tensor([tok.sot_sequence] * 6)
    anc = torch.tensor([[0, 0, 0, 1], [1, 1, 0, 1], [2, 0, 0, 2]] * 2, dtype=torch.int32)
    anc = torch.cat([anc, anc[:, :1].expand(-1, 124)], dim=1).contiguous()
    logits = {}
    for label, dev, p in (("cuda", cuda, params), ("cpu", torch.device("cpu"), _to_cpu(params))):
        cache = tw.init_kv_cache(cfg, 6, dev, max_len=16)
        xkv = tw.cross_kv(p, states.to(dev), cfg)
        tw.decode_step(p, init.to(dev), 0, cache, xkv, cfg, share_xkv_groups=3)
        before = (bf.LANE_LAUNCHES, da.LAUNCHES)
        logits[label] = tw.decode_step(p, init[:, :1].to(dev), 3, cache, xkv, cfg,
                                       share_xkv_groups=3, beam_ancestry=anc.to(dev))[0]
        if label == "cuda":
            torch.cuda.synchronize()
            assert bf.LANE_LAUNCHES - before[0] == cfg.n_text_layer
            assert da.LAUNCHES - before[1] == cfg.n_text_layer  # the cross attention only
    ref = logits["cpu"].float()
    assert _max_err(logits["cuda"].float().cpu(), ref) <= 5e-2 * max(1.0, ref.abs().max().item())


@pytest.mark.cuda
def test_beam_shared_tiny_card_matches_cpu(cuda, monkeypatch):
    """The shared-prefix scheme on a tiny model (bf16, int4 cross, int8
    self, integer dots): one decode step over the flat cache with s_fill on
    the card (K8's split mode) against the CPU's plain versions, then
    WTPU_BEAM_KV=shared through decode at a roomy read window and at one the
    overflow takes over, the split launched in both."""
    from whisper_mlx_tpu_torch.decoding.task import DecodingOptions, decode
    from whisper_mlx_tpu_torch.decoding.tokenizer import make_synthetic_tokenizer
    from whisper_mlx_tpu_torch.models import whisper as tw

    tok = make_synthetic_tokenizer()
    cfg = tw.WhisperConfig(n_vocab=tok.n_vocab, n_audio_state=128, n_audio_head=2,
                           n_audio_layer=2, n_text_state=128, n_text_head=2, n_text_layer=2,
                           dtype=torch.bfloat16, flash_attention=True, kv_bits=4,
                           self_kv_bits=8, attn_mxu=True)
    params = tw.init_params(cfg, seed=0, device=cuda, dtype=torch.bfloat16)
    states = torch.randn((2, 1500, 128), generator=torch.Generator().manual_seed(0)) \
        .to(torch.bfloat16)
    init = torch.tensor([tok.sot_sequence] * 6)
    anc = torch.tensor([[0, 0, 0, 1], [0, 0, 1, 1], [0, 0, 2, 2]] * 2, dtype=torch.int32)
    anc = torch.cat([anc, anc[:, :1].expand(-1, 124)], dim=1).contiguous()
    logits = {}
    for label, dev, p in (("cuda", cuda, params), ("cpu", torch.device("cpu"), _to_cpu(params))):
        cache = tw.init_kv_cache(cfg, 6, dev, max_len=16)
        xkv = tw.cross_kv(p, states.to(dev), cfg)
        tw.decode_step(p, init.to(dev), 0, cache, xkv, cfg, share_xkv_groups=3)
        before = bf.SPLIT_LAUNCHES
        logits[label] = tw.decode_step(
            p, init[:, :1].to(dev), 3, tw.beam_flat_cache(cache, 3), xkv, cfg,
            share_xkv_groups=3, beam_ancestry=anc.to(dev),
            beam_s_fill=torch.tensor([2, 1], dtype=torch.int32, device=dev),
            beam_overflow=torch.zeros((), dtype=torch.bool, device=dev))[0]
        if label == "cuda":
            torch.cuda.synchronize()
            assert bf.SPLIT_LAUNCHES - before == cfg.n_text_layer
    ref = logits["cpu"].float()
    assert _max_err(logits["cuda"].float().cpu(), ref) <= 5e-2 * max(1.0, ref.abs().max().item())
    monkeypatch.setenv("WTPU_BEAM_KV", "shared")
    for window in ("64", "4"):
        monkeypatch.setenv("WTPU_BEAM_WIN", window)
        before = bf.SPLIT_LAUNCHES
        res = decode(params, states.to(cuda), tok, cfg,
                     DecodingOptions(sample_len=24, beam_size=3), states_precomputed=True)
        assert bf.SPLIT_LAUNCHES > before
        assert all(len(r.tokens) > 0 for r in res), window


def _lane_tensors(gen, nb, cuda):
    """One layer's int8 codes, packed int4 codes, bf16 scales and rows of an
    odd length (21 bytes: the byte path)."""
    return [torch.randint(-127, 128, (nb, 20, 256, 64), generator=gen, device=cuda,
                          dtype=torch.int8),
            torch.randint(0, 256, (nb, 20, 256, 32), generator=gen, device=cuda,
                          dtype=torch.uint8),
            torch.randn((nb, 20, 256), generator=gen, device=cuda).to(torch.bfloat16),
            torch.randint(0, 256, (nb, 3, 7), generator=gen, device=cuda, dtype=torch.uint8)]


def _lane_move_map(nb, moved, cuda):
    """A move map of ``moved`` of nb lanes, each from a fixed lane: 1 (lane 7
    from 3), 8 (lane 5k + 1 from 5k), 32 (every lane of a window of 5 from
    its first) or nb - 1 (every lane from lane 0)."""
    src = torch.arange(nb, device=cuda)
    if moved == 1:
        src[7] = 3
    elif moved == 8:
        src[1::5] = src[0::5]
    elif moved == 32:
        src = src - src % 5
    else:
        src[1:] = 0
    assert int((src != torch.arange(nb, device=cuda)).sum()) == moved
    return src


@pytest.mark.cuda
@pytest.mark.parametrize("moved", [1, 8, 32, 39])
def test_lane_kernels_match_plain(cuda, moved):
    """Permute and in-place move (1, 8, 32 and 39 of 40 lanes moved) of one
    layer's int8, packed int4, bf16 and odd-length rows: byte-exact."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    nb = 40
    tensors = _lane_tensors(gen, nb, cuda)
    parent = torch.tensor([0, 0, 1, 3, 3, 3] * 6 + [36, 36, 39, 38], device=cuda)
    before = (lp.PERMUTE_LAUNCHES, lp.MOVE_LAUNCHES)
    got = lp.permute_lanes(tensors, parent)
    for a, b in zip(got, lp.permute_lanes_plain(tensors, parent)):
        assert torch.equal(a, b)
    src = _lane_move_map(nb, moved, cuda)
    want = lp.lane_move_inplace_plain([t.clone() for t in tensors], src)
    moved = lp.lane_move_inplace(tensors, src)
    torch.cuda.synchronize()
    assert all(a is b for a, b in zip(moved, tensors))
    for a, b in zip(moved, want):
        assert torch.equal(a, b)
    assert (lp.PERMUTE_LAUNCHES, lp.MOVE_LAUNCHES) == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_beam_tiny_card_matches_cpu_and_fp_caches_raise(cuda, monkeypatch):
    """Beam 3 on a tiny model: the card (K3 integer mode, K8, K9) against
    the CPU's plain versions, bf16 kv4/self8; fp caches raise on the card."""
    import dataclasses

    from whisper_mlx_tpu_torch.decoding import beam as tb
    from whisper_mlx_tpu_torch.decoding.task import DecodingOptions, decode
    from whisper_mlx_tpu_torch.decoding.tokenizer import make_synthetic_tokenizer
    from whisper_mlx_tpu_torch.models import whisper as tw

    tok = make_synthetic_tokenizer()
    cfg = tw.WhisperConfig(n_vocab=tok.n_vocab, n_audio_state=128, n_audio_head=2,
                           n_audio_layer=2, n_text_state=128, n_text_head=2, n_text_layer=2,
                           dtype=torch.bfloat16, flash_attention=True, kv_bits=4,
                           self_kv_bits=8, attn_mxu=True)
    params = tw.init_params(cfg, seed=0, device=cuda, dtype=torch.bfloat16)
    params_cpu = _to_cpu(params)
    states = torch.randn((2, 1500, 128), generator=torch.Generator().manual_seed(0)) \
        .to(torch.bfloat16)
    init = torch.tensor([tok.sot_sequence] * 6)
    logits = {}
    for label, dev, p in (("cuda", cuda, params), ("cpu", torch.device("cpu"), params_cpu)):
        cache = tw.init_kv_cache(cfg, 6, dev, max_len=16)
        xkv = tw.cross_kv(p, states.to(dev), cfg)
        out = [tw.decode_step(p, init.to(dev), 0, cache, xkv, cfg, share_xkv_groups=3)[0]]
        flat = tw.beam_flat_cache(cache, 3)
        anc = torch.tensor([[0, 0, 0, 1], [1, 1, 0, 1], [2, 0, 0, 2]] * 2, dtype=torch.int32)
        anc = torch.cat([anc, anc[:, :1].expand(-1, 124)], dim=1).contiguous().to(dev)
        step = tw.decode_step(p, init[:, :1].to(dev), 3, flat, xkv, cfg, share_xkv_groups=3,
                              beam_ancestry=anc)[0]
        logits[label] = torch.cat([out[0], step], dim=1).float().cpu()
    ref = logits["cpu"]
    assert torch.isfinite(logits["cuda"]).all()
    assert _max_err(logits["cuda"], ref) <= 5e-2 * max(1.0, ref.abs().max().item())
    res = {}
    for scheme in ("flat", "permp", "permi"):
        before = (bf.LAUNCHES, lp.PERMUTE_LAUNCHES, lp.MOVE_LAUNCHES)
        monkeypatch.setenv("WTPU_BEAM_KV", scheme)
        res[scheme] = [r.tokens for r in decode(params, states.to(cuda), tok, cfg,
                                                 DecodingOptions(sample_len=12, beam_size=3),
                                                 states_precomputed=True)]
        after = (bf.LAUNCHES, lp.PERMUTE_LAUNCHES, lp.MOVE_LAUNCHES)
        launched = [a > b for a, b in zip(after, before)]
        assert launched == [scheme == "flat", scheme == "permp", scheme == "permi"], scheme
    assert all(len(t) > 0 for t in res["flat"])
    fp = dataclasses.replace(cfg, kv_bits=0, self_kv_bits=0)
    with pytest.raises(ValueError, match="CPU tensors only"):
        tb.beam_decode(params, states.to(cuda), init[:2].to(cuda),
                       torch.zeros(cfg.n_vocab, dtype=torch.bool, device=cuda),
                       torch.zeros(cfg.n_vocab, dtype=torch.bool, device=cuda), fp,
                       _filter_cfg(tok), 4, 0, tok.no_speech, 3, 3)
    q = torch.zeros((3, 2, 1, 64), device=cuda)
    kf = torch.zeros((1, 2, 12, 64), device=cuda)
    with pytest.raises(ValueError, match="CPU tensors only"):
        bf.attention_fp_beamflat(q, kf, kf, torch.zeros((3, 4), dtype=torch.int32,
                                                        device=cuda), 1, 3)


def _filter_cfg(tok):
    from whisper_mlx_tpu_torch.decoding.filters import FilterConfig

    return FilterConfig(eot=tok.eot, no_timestamps=tok.no_timestamps,
                        timestamp_begin=tok.timestamp_begin, sample_begin=3)


# ---------------------------------------------------------------------------
# K2's bf16-softmax mode, the probe kernels, the 4-bit whisper path
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,tq,tk", [(2, 20, 1500, 1500), (1, 3, 130, 333),
                                       (1, 2, 65, 1500), (1, 3, 63, 129), (1, 3, 64, 65)])
def test_dense_kernel_fast_softmax_matches_plain(cuda, monkeypatch, b, h, tq, tk):
    """K2 in its bf16-softmax mode against the plain version in that mode;
    the mode is read from WTPU_DENSE_SOFTMAX when not given."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((b, h, t, 64), generator=gen, device=cuda).mul(s).bfloat16()
               for t, s in ((tq, 0.35), (tk, 0.35), (tk, 1.0)))
    got = dn.dense_attention(q, k, v, fast_softmax=True)
    torch.cuda.synchronize()
    _assert_rows_close(got, dn.dense_attention_plain(q, k, v, fast_softmax=True))
    assert not torch.equal(got, dn.dense_attention(q, k, v, fast_softmax=False))
    monkeypatch.setenv("WTPU_DENSE_SOFTMAX", "bf16")
    assert torch.equal(dn.dense_attention(q, k, v), got)


PROBE_VARIANTS = ("accum", "e1", "e2", "e3", "e5", "e6-t256", "e6-t512", "e7-t256", "e7-t512")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", PROBE_VARIANTS)
@pytest.mark.parametrize("m,n,k,dtype", [
    (24, 3840, 1280, torch.bfloat16),   # the probe's qkv-fused
    (24, 1280, 5120, torch.bfloat16),   # fc2
    (24, 51968, 1280, torch.bfloat16),  # logits
    (3, 100, 128, torch.bfloat16),      # ragged: N not a multiple of a block's columns
    (9, 72, 256, torch.float32),
])
def test_probe_quant_kernels_match_plain(cuda, variant, m, n, k, dtype):
    """K10a-g, as the probe's entry point calls them (int4, group 64),
    against their plain versions on the same operands."""
    from whisper_mlx_tpu_torch.probes.bench_quant_kernel import make_variants

    gen = torch.Generator(device=cuda).manual_seed(n + k + m)
    q = tq.quantize(torch.randn((n, k), generator=gen, device=cuda) * k ** -0.5, 4)
    x = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
    before = sum(pqm.LAUNCHES.values())
    got = make_variants(q)[variant](x)
    torch.cuda.synchronize()
    assert sum(pqm.LAUNCHES.values()) == before + 1
    cpu_q = tq.QuantTensor(q.w_q.cpu(), q.scales.cpu(), q.biases.cpu(), 4, 64)
    ref = make_variants(cpu_q)[variant](x.cpu())
    tol = (1e-2 if dtype == torch.bfloat16 else 1e-4) * max(1.0, ref.float().abs().max().item())
    assert got.dtype == dtype and _max_err(got.cpu(), ref) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["accum", "e1", "e2", "e3", "e5", "e6"])
def test_probe_quant_kernels_int8_match_plain(cuda, variant):
    """The variants that take 8-bit codes (e7 is an int4 function)."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    q = tq.quantize(torch.randn((40, 128), generator=gen, device=cuda) * 0.1, 8)
    x = torch.randn((5, 128), generator=gen, device=cuda).bfloat16()
    sw, bw = pqm.make_scale_words(q)
    calls = {"accum": lambda x, q, sw, bw: pqm.quant_matmul_variant(x, q, 128),
             "e1": lambda x, q, sw, bw: pqm.quant_matmul_e1(x, q, 128),
             "e2": lambda x, q, sw, bw: pqm.quant_matmul_e2(x, q, sw, bw, 128),
             "e3": lambda x, q, sw, bw: pqm.quant_matmul_e3(x, q, sw, 128),
             "e5": lambda x, q, sw, bw: pqm.quant_matmul_e5(x, pqm.repack_strided(q), 128),
             "e6": lambda x, q, sw, bw: pqm.quant_matmul_e6(x, q, 128)}
    got = calls[variant](x, q, sw, bw)
    torch.cuda.synchronize()
    cpu_q = tq.QuantTensor(q.w_q.cpu(), q.scales.cpu(), q.biases.cpu(), 8, 64)
    ref = calls[variant](x.cpu(), cpu_q, sw.cpu(), bw.cpu())
    assert _max_err(got.cpu(), ref) <= 1e-2 * max(1.0, ref.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("b,tk,tq,kw,bh_tile", [
    (24, 1536, 1, dict(valid_len=1500), 16),
    (24, 512, 1, dict(valid_len=448, causal=True, pos=200), 8),
    (24, 512, 1, dict(valid_len=448, causal=True, pos=200), 32),
    (1, 132, 3, dict(valid_len=131, causal=True, pos=7), 7),  # ragged: 20 pairs, 7 a block
])
def test_batched_attention_kernel_matches_plain_and_k3(cuda, b, tk, tq, kw, bh_tile):
    """K11 against its plain version and, for one query row, against K3 on
    the same codes in K3's position-major layout."""
    gen = torch.Generator(device=cuda).manual_seed(tk)
    k = torch.randn((b, 20, tk, 64), generator=gen, device=cuda)
    v = torch.randn((b, 20, tk, 64), generator=gen, device=cuda)
    k8, ks = kq.quantize_kv(k)
    v8, vs = kq.quantize_kv(v)
    k8t = k8.transpose(2, 3).contiguous()
    q = (torch.randn((b, 20, tq, 64), generator=gen, device=cuda) * 0.2).bfloat16()
    before = pda.LAUNCHES
    got = pda.batched_attention(q, k8t, ks.float(), v8, vs.float(), bh_tile=bh_tile, **kw)
    torch.cuda.synchronize()
    assert pda.LAUNCHES == before + 1
    ref = pda.batched_attention_plain(q, k8t, ks.float(), v8, vs.float(), **kw)
    assert _max_err(got, ref) <= _attn_tol(ref)
    k3 = da.decode_attention(q, k8, ks, v8, vs, **kw)
    assert _max_err(got, k3) <= _attn_tol(ref)


@pytest.mark.cuda
@pytest.mark.parametrize("stage", pda.STAGES)
@pytest.mark.parametrize("bh,tk,bh_tile", [(480, 1536, 16), (10, 272, 4)])
def test_ablation_kernel_matches_plain(cuda, stage, bh, tk, bh_tile):
    """K12's five stages against their plain versions."""
    gen = torch.Generator(device=cuda).manual_seed(tk)
    kt = torch.randint(-127, 128, (bh, 64, tk), generator=gen, device=cuda, dtype=torch.int8)
    vt = torch.randint(-127, 128, (bh, 64, tk), generator=gen, device=cuda, dtype=torch.int8)
    q = (torch.randn((bh, 1, 64), generator=gen, device=cuda) * 0.1).bfloat16()
    before = pda.STAGE_LAUNCHES[stage]
    got = pda.ablation_stage(q, kt, vt, stage, bh_tile)
    torch.cuda.synchronize()
    assert pda.STAGE_LAUNCHES[stage] == before + 1
    ref = pda.ablation_stage_plain(q, kt, vt, stage)
    assert _max_err(got, ref) <= _attn_tol(ref)


@pytest.mark.cuda
def test_probe_wrappers_raise_on_cuda_tensors_they_do_not_take(cuda):
    """A wrapper launches its kernel or raises: no plain version on the card."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = tq.quantize(torch.randn((64, 128), generator=gen, device=cuda), 4)
    x = torch.randn((4, 128), generator=gen, device=cuda).bfloat16()
    with pytest.raises(ValueError, match="x must be"):
        pqm.quant_matmul_e6(x.half(), q)
    with pytest.raises(ValueError, match="512 rows"):
        pqm.quant_matmul_e1(x.repeat(200, 1), q)
    with pytest.raises(ValueError, match="device"):
        pqm.quant_matmul_e6(x, tq.QuantTensor(q.w_q.cpu(), q.scales.cpu(), q.biases.cpu(), 4, 64))
    with pytest.raises(ValueError, match="contiguous"):
        pqm.quant_matmul_e7(x, q.w_q.T, q.scales, q.biases, 4, 64)  # a transposed view
    k8t = torch.zeros((1, 2, 64, 130), dtype=torch.int8, device=cuda)
    v8 = torch.zeros((1, 2, 130, 64), dtype=torch.int8, device=cuda)
    s = torch.ones((1, 2, 130), device=cuda)
    aq = torch.zeros((1, 2, 1, 64), device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        pda.batched_attention(aq, k8t, s, v8, s)  # fp32 queries
    with pytest.raises(ValueError, match="multiple of 4"):
        pda.batched_attention(aq.bfloat16(), k8t, s, v8, s)  # Tk 130
    k8t, v8, s = k8t[..., :128].contiguous(), v8[:, :, :128].contiguous(), s[..., :128].contiguous()
    with pytest.raises(ValueError, match="shared memory"):
        pda.batched_attention(aq.bfloat16(), k8t.repeat(1, 1, 1, 16),
                              s.repeat(1, 1, 16), v8.repeat(1, 1, 16, 1), s.repeat(1, 1, 16),
                              bh_tile=32)  # 32 x 2048 scores
    kt = torch.zeros((2, 64, 136), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        pda.ablation_stage(aq.bfloat16().reshape(2, 1, 64), kt, kt, "full")
    kt = torch.zeros((2, 64, 1536), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        pda.ablation_stage(aq.bfloat16().reshape(2, 1, 64), kt, kt, "full", bh_tile=32)


@pytest.mark.cuda
def test_whisper_tiny_4bit_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """The tiny config quantized, exported as an mlx-format directory and
    loaded on both devices: prefill logits card vs CPU, K5 on the decode
    linears, K6 under WTPU_FEWROW_MBT=1, no K5/K6 on the 20-row dense route."""
    import dataclasses

    from whisper_mlx_tpu_torch.checkpoint.quant_loader import export_mlx_whisper, load_mlx_whisper
    from whisper_mlx_tpu_torch.decoding.task import DecodingOptions, decode
    from whisper_mlx_tpu_torch.decoding.tokenizer import make_synthetic_tokenizer
    from whisper_mlx_tpu_torch.models import whisper as tw
    from whisper_mlx_tpu_torch.runtime.serving_config import apply_asr_serving_config

    tok = make_synthetic_tokenizer()
    base = dataclasses.replace(tw.WHISPER_CONFIGS["tiny"], n_vocab=tok.n_vocab)
    quant = {"bits": 4, "group_size": 64}
    export_mlx_whisper(tq.quantize_params(tw.init_params(base, seed=0), **quant), base, tmp_path,
                       quantization=quant)
    mel = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 3000, 80))
                           .astype(np.float32))
    logits, trees = {}, {}
    for dev in ("cpu", "cuda"):
        params, config = load_mlx_whisper(tmp_path, device=dev)
        params, config = apply_asr_serving_config(params, config, "cuda")
        assert isinstance(params["decoder"]["blocks"][0]["attn"]["qkv"]["w"], tq.QuantTensor)
        trees[dev] = params
        with torch.inference_mode():
            states = tw.encode(params, mel.to(dev), config)
            init = torch.tensor([tok.sot_sequence] * 2, device=dev)
            out, _ = tw.decode_step(params, init, 0, tw.init_kv_cache(config, 2, dev, 8),
                                    tw.cross_kv(params, states, config), config)
        logits[dev] = out.float().cpu()
    ref = logits["cpu"]
    assert torch.isfinite(logits["cuda"]).all()
    assert _max_err(logits["cuda"], ref) <= 5e-2 * max(1.0, ref.abs().max().item())
    opts = DecodingOptions(sample_len=12)
    qm.LAUNCHES = mb.LAUNCHES = 0
    res = decode(trees["cuda"], mel.to(cuda), tok, config, opts)
    assert qm.LAUNCHES > 0 and mb.LAUNCHES == 0 and all(r.tokens for r in res)
    monkeypatch.setenv("WTPU_FEWROW_MBT", "1")
    qm.LAUNCHES = 0
    decode(trees["cuda"], mel.to(cuda), tok, config, opts)
    assert mb.LAUNCHES > 0
    monkeypatch.delenv("WTPU_FEWROW_MBT")
    with torch.inference_mode():
        states = tw.encode(trees["cuda"], mel.to(cuda).repeat(2, 1, 1), config)
    qm.LAUNCHES = mb.LAUNCHES = 0
    dense = decode(trees["cuda"], states, tok, config, DecodingOptions(sample_len=8, beam_size=5),
                   states_precomputed=True)  # 4 windows x beam 5 = 20 rows
    assert qm.LAUNCHES == 0 and mb.LAUNCHES == 0 and len(dense) == 4
    tq._DENSE_DECODE_CACHE.clear()


def _tiny_serving(cuda):
    """The tiny config in the card's serving config (bf16, K2, int4 cross,
    int8 self), its params on the CPU and on the card, the synthetic tokenizer."""
    import dataclasses

    from whisper_mlx_tpu_torch.decoding.tokenizer import make_synthetic_tokenizer
    from whisper_mlx_tpu_torch.models import whisper as tw
    from whisper_mlx_tpu_torch.runtime.serving_config import apply_asr_serving_config

    tok = make_synthetic_tokenizer()
    base = dataclasses.replace(tw.WHISPER_CONFIGS["tiny"], n_vocab=tok.n_vocab)
    params, config = apply_asr_serving_config(tw.init_params(base, seed=0), base, cuda)
    return params, _to_device(params, cuda), config, tok


def _to_device(node, device):
    if isinstance(node, dict):
        return {k: _to_device(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [_to_device(v, device) for v in node]
    return node.to(device)


def _speechy(seconds, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000.0
    x = (0.3 * np.sin(2 * np.pi * (180 + 40 * np.sin(2 * np.pi * 0.3 * t)) * t)
         * (0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t)) + 0.02 * rng.standard_normal(t.size))
    return x.astype(np.float32)


@pytest.mark.cuda
def test_batcher_tiny_card_matches_cpu(cuda):
    """The batcher on the card: each request's mel windows (K1) within the
    mel tolerance of the CPU's, K1, K2 and K3 launched, and its tokens
    equal to the card's own batched transcribe on the same windows."""
    import asyncio

    from whisper_mlx_tpu_torch.decoding.task import DecodingOptions
    from whisper_mlx_tpu_torch.inference.transcribe import transcribe
    from whisper_mlx_tpu_torch.runtime.batcher import TranscriptionBatcher

    params_cpu, params_dev, config, tok = _tiny_serving(cuda)
    audios = [_speechy(65.0), _speechy(20.0, 1), _speechy(40.0, 2)]
    opts = DecodingOptions(sample_len=24)
    card = TranscriptionBatcher(params_dev, config, tok, device=cuda, batch_size=[2, 8],
                                max_wait_ms=100, decoding=opts)
    host = TranscriptionBatcher(params_cpu, config, tok, device="cpu")
    for a in audios:
        got, ref = card._windows(a), host._windows(a)
        assert got.is_cuda and got.shape == ref.shape
        assert _max_err(got.cpu(), ref) <= 2e-4

    async def run():
        out = await asyncio.gather(*(card.transcribe(a) for a in audios))
        card.shutdown()
        return out

    mk.LAUNCHES = dn.LAUNCHES = da.LAUNCHES = 0
    results = asyncio.run(run())
    assert mk.LAUNCHES >= 3 and dn.LAUNCHES > 0 and da.LAUNCHES > 0
    assert card.stats["windows"] == 6
    for a, r in zip(audios, results):
        want = transcribe(a, params=params_dev, config=config, tokenizer=tok, device=cuda,
                          temperature=0.0, batch_windows=True, window_batch_size=8,
                          sample_len=24, no_speech_threshold=None, verbose=False)
        assert [s["tokens"] for s in r["segments"]] == [s["tokens"] for s in want["segments"]]
        for s in r["segments"]:
            assert 0.0 <= s["start"] <= s["end"] <= len(a) / 16000 + 30.0


@pytest.mark.cuda
def test_alignment_weights_card_match_cpu(cuda):
    """The alignment pass (route R1, plain tensor ops on the card) card vs
    CPU: at fp32 on the same encoder states the weights agree within 1e-5;
    end to end in the bf16 serving config (the card's encoder on K2) within
    2e-4 (bf16 activations), finite and each row summing to 1, while the
    weights of another input (1.5e-3 from these on the CPU) fall outside."""
    import dataclasses

    from whisper_mlx_tpu_torch.inference.word_timestamps import find_alignment
    from whisper_mlx_tpu_torch.models import whisper as tw

    params_cpu, params_dev, config, tok = _tiny_serving(cuda)
    tokens = list(tok.sot_sequence) + [tok.no_timestamps] + tok.encode(" hello world") \
        + [tok.eot]
    mel = torch.from_numpy(np.random.default_rng(4).standard_normal((1, 3000, 80))
                           .astype(np.float32) * 0.5)
    fp = dataclasses.replace(config, kv_bits=0, self_kv_bits=0)
    weights = {}
    with torch.inference_mode():
        states = tw.encode(params_dev, mel.to(cuda), fp).float()
        f32 = dataclasses.replace(fp, dtype=torch.float32)
        for dev, params in (("cpu", params_cpu), ("cuda", params_dev)):
            p32 = _to_device(tw.init_params(f32, seed=0), dev)
            out = tw.decode_step(p32, torch.tensor([tokens], device=dev), 0,
                                 tw.init_kv_cache(f32, 1, dev),
                                 tw.cross_kv(p32, states.to(dev), f32), f32,
                                 collect_cross_attn=True)
            weights[f"fp32_{dev}"] = out[2].cpu()
            st = tw.encode(params, mel.to(dev), fp)
            out = tw.decode_step(params, torch.tensor([tokens], device=dev), 0,
                                 tw.init_kv_cache(fp, 1, dev), tw.cross_kv(params, st, fp), fp,
                                 collect_cross_attn=True)
            weights[f"bf16_{dev}"] = out[2].cpu()
    assert _max_err(weights["fp32_cuda"], weights["fp32_cpu"]) <= 1e-5
    got = weights["bf16_cuda"]
    assert torch.isfinite(got).all() and got.shape == (4, 1, 6, len(tokens), 1500)
    assert _max_err(got.sum(-1), torch.ones(got.shape[:-1])) <= 1e-4
    assert _max_err(got, weights["bf16_cpu"]) <= 2e-4
    other = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 3000, 80))
                             .astype(np.float32) * 0.5)
    with torch.inference_mode():
        st = tw.encode(params_cpu, other, fp)
        control = tw.decode_step(params_cpu, torch.tensor([tokens]), 0,
                                 tw.init_kv_cache(fp, 1, "cpu"), tw.cross_kv(params_cpu, st, fp),
                                 fp, collect_cross_attn=True)[2]
    assert _max_err(control, weights["bf16_cpu"]) > 2e-4
    text = tok.encode(" hello world again")
    words = find_alignment(params_dev, config, tok, text, mel[0].to(cuda), num_frames=3000)
    assert [t for w in words for t in w.tokens] == text
    assert all(0.0 <= w.start <= w.end <= 30.0 for w in words)


@pytest.mark.cuda
def test_int16_upload_on_card_bit_equal_to_host(cuda):
    """int16 audio divided by 2^15 on the card (a reciprocal multiply, exact
    for a power of two) equals the host's conversion bit for bit, and so
    do the batcher's mel windows."""
    from whisper_mlx_tpu_torch.runtime.batcher import TranscriptionBatcher

    pcm = (np.clip(_speechy(40.0), -1, 1) * 32767).astype(np.int16)
    pcm[:4] = (-32768, 32767, 1, -1)
    host = pcm.astype(np.float32) / 32768.0
    card = torch.from_numpy(pcm).to(cuda).float() / 32768.0
    assert torch.equal(card.cpu(), torch.from_numpy(host))
    _, params_dev, config, tok = _tiny_serving(cuda)
    batcher = TranscriptionBatcher(params_dev, config, tok, device=cuda)
    assert torch.equal(batcher._windows(pcm), batcher._windows(host))


@pytest.mark.cuda
def test_plain_decoder_attention_still_raises_on_cuda(cuda):
    """Outside the alignment pass (collect_cross_attn=False) fp caches on
    the card still raise: the plain attention is no way around K3."""
    from whisper_mlx_tpu_torch.models import whisper as tw

    cfg = tw.WhisperConfig(n_audio_state=128, n_audio_head=2, n_audio_layer=1,
                           n_text_state=128, n_text_head=2, n_text_layer=1, n_vocab=64)
    params = tw.init_params(cfg, seed=0, device=cuda)
    states = torch.zeros((1, 1500, 128), device=cuda)
    with pytest.raises(ValueError, match="CPU tensors only"):
        tw.decode_step(params, torch.zeros((1, 2), dtype=torch.long, device=cuda), 0,
                       tw.init_kv_cache(cfg, 1, cuda), tw.cross_kv(params, states, cfg), cfg)
    out = tw.decode_step(params, torch.zeros((1, 2), dtype=torch.long, device=cuda), 0,
                         tw.init_kv_cache(cfg, 1, cuda), tw.cross_kv(params, states, cfg), cfg,
                         collect_cross_attn=True)
    assert out[2].shape == (1, 1, 2, 2, 1500) and torch.isfinite(out[2]).all()
