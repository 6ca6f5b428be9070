"""The Hopper kernels of whisper_mlx_tpu_torch against their plain PyTorch
versions, on a GPU.

Tests marked ``cuda`` skip without a GPU: a CUDA kernel has no CPU mode.
This file imports neither jax nor the JAX package, so on a machine with a
GPU and without jax it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tolerances: 2e-4 absolute for the mel (fp32 FMA in another order), and
``2e-2 * max(1, |ref|max)`` for the attention kernels, which round the
softmax weights to bf16 as the TPU kernels did.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from whisper_mlx_tpu_torch.audio import mel as t_mel
from whisper_mlx_tpu_torch.ops import _build
from whisper_mlx_tpu_torch.ops import decode_attention as da
from whisper_mlx_tpu_torch.ops import dense_attention as dn
from whisper_mlx_tpu_torch.ops import kv_quant as kq
from whisper_mlx_tpu_torch.ops import mel_kernel as mk


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
        "decode_attention.cu", "dense_attention.cu", "mel.cu"]


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
