"""The Hopper kernels of whisper_mlx_tpu_torch against their plain PyTorch
versions, on a GPU.

Tests marked ``cuda`` skip without a GPU: a CUDA kernel has no CPU mode.
This file imports neither jax nor the JAX package, so on a machine with a
GPU and without jax it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tolerances: 2e-4 absolute for the mel (fp32 FMA in another order);
``2e-2 * max(1, |ref|max)`` for the attention kernels, which round the
softmax weights to bf16 (K2, K3 as the TPU kernels did; K4 where the TPU
kernel kept fp32); for the quantized matmul ``1e-2 * max(1, |ref|max)`` in
bf16 (sums in another order can move a result by one bf16 ulp) and
``1e-4 * max(1, |ref|max)`` in fp32.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from whisper_mlx_tpu_torch.audio import mel as t_mel
from whisper_mlx_tpu_torch.ops import _build
from whisper_mlx_tpu_torch.ops import decode_attention as da
from whisper_mlx_tpu_torch.ops import dense_attention as dn
from whisper_mlx_tpu_torch.ops import flash_attention as fa
from whisper_mlx_tpu_torch.ops import kv_quant as kq
from whisper_mlx_tpu_torch.ops import mel_kernel as mk
from whisper_mlx_tpu_torch.ops import quant as tq
from whisper_mlx_tpu_torch.ops import quant_matmul as qm


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
        "decode_attention.cu", "dense_attention.cu", "flash_attention.cu", "mel.cu",
        "quant_matmul.cu"]


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
@pytest.mark.parametrize("b,h,tq,tk", [(2, 20, 1500, 1500), (1, 3, 200, 200), (1, 3, 130, 333)])
def test_dense_kernel_matches_plain(cuda, b, h, tq, tk):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((b, h, t, 64), generator=g, device=cuda) * s
               for t, s in ((tq, 0.35), (tk, 0.35), (tk, 1.0)))
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    before = dn.LAUNCHES
    got = dn.dense_attention(q, k, v)
    torch.cuda.synchronize()
    assert dn.LAUNCHES == before + 1
    ref = dn.dense_attention_plain(q, k, v)
    assert _max_err(got, ref) <= _attn_tol(ref)


@pytest.mark.cuda
@pytest.mark.parametrize("bits,n,g,tq,t,kw", [
    (8, 4, 1, 1, 256, dict(pos=100, causal=True)),
    (8, 4, 1, 3, 256, dict(pos=0, causal=True)),
    (4, 4, 1, 1, 1500, dict(valid_len=1500)),
    (4, 2, 5, 1, 1500, dict(valid_len=1500)),
    (4, 2, 1, 3, 384, dict(valid_len=333)),
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
    assert _max_err(got, ref) <= _attn_tol(ref)


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
@pytest.mark.parametrize("m,n,k,bits,dtype", [
    (1, 200, 512, 4, torch.bfloat16),
    (3, 200, 512, 8, torch.bfloat16),
    (8, 1000, 1024, 4, torch.bfloat16),
    (17, 200, 512, 4, torch.bfloat16),
    (128, 1000, 1024, 4, torch.bfloat16),
    (300, 130, 5120, 8, torch.bfloat16),
    (512, 10240, 5120, 4, torch.bfloat16),
    (1, 10240, 5120, 4, torch.bfloat16),
    (5, 130, 256, 4, torch.float32),
    (40, 130, 256, 8, torch.float32),
])
def test_quant_matmul_kernel_matches_plain(cuda, m, n, k, bits, dtype):
    gen = torch.Generator(device=cuda).manual_seed(m + n)
    w = torch.randn((n, k), generator=gen, device=cuda) / k ** 0.5
    q = tq.quantize(w, bits=bits, group_size=64)
    x = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
    before = qm.LAUNCHES
    got = tq.quant_matmul(x, q)
    torch.cuda.synchronize()
    assert qm.LAUNCHES == before + 1 and got.dtype == dtype
    ref = qm.quant_matmul_plain(x, q.w_q, q.scales, q.biases, bits, 64)
    rel = 1e-2 if dtype == torch.bfloat16 else 1e-4
    assert _max_err(got, ref) <= rel * max(1.0, ref.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kvh,tq_,tk,hd,causal", [
    (1, 8, 2, 130, 130, 128, True),
    (1, 64, 8, 256, 256, 128, True),
    (2, 4, 4, 37, 37, 64, True),
    (1, 3, 3, 100, 2100, 64, False),
    (1, 4, 2, 70, 70, 16, True),
    (1, 4, 2, 70, 90, 32, False),
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
    ref = fa.flash_attention_plain(q, k, v, causal=causal)
    assert _max_err(got, ref) <= _attn_tol(ref)


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
