"""Port parity: the log-mel frontend and WAV reader of whisper_mlx_tpu_torch
against the JAX package on the CPU (XLA path and the Pallas kernel in
interpret mode, atol 2e-4 as tests/test_pallas_kernels.py holds the Pallas
kernel). Kernel K1 itself is tested in tests/test_torch_kernels.py."""

from __future__ import annotations

import struct

import numpy as np
import pytest

import torch  # noqa: F401  (torch before jax: see CLAUDE.md)
import jax.numpy as jnp

from tests.conftest import make_speechy_audio
from whisper_mlx_tpu.audio import decode as j_decode
from whisper_mlx_tpu.audio import mel as j_mel
from whisper_mlx_tpu.ops.mel_pallas import log_mel_pallas
from whisper_mlx_tpu_torch.audio import decode as t_decode
from whisper_mlx_tpu_torch.audio import mel as t_mel
from whisper_mlx_tpu_torch.ops import mel_kernel as mk

TOL = 2e-4


@pytest.fixture(scope="module")
def window():
    return np.array(j_mel.pad_or_trim(jnp.asarray(make_speechy_audio(4.0)), j_mel.N_SAMPLES))


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_matches_xla(window, n_mels):
    ref = np.asarray(j_mel.log_mel_spectrogram(jnp.asarray(window), n_mels=n_mels))
    got = t_mel.log_mel_spectrogram(torch.from_numpy(window), n_mels=n_mels).numpy()
    assert got.shape == ref.shape == (3000, n_mels)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_matches_pallas(window, n_mels):
    ref = np.asarray(log_mel_pallas(jnp.asarray(window), n_mels=n_mels, interpret=True))
    got = t_mel.log_mel_spectrogram(torch.from_numpy(window), n_mels=n_mels).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)


def test_tables_bit_identical():
    for n_mels in (80, 128):
        np.testing.assert_array_equal(t_mel.mel_filterbank(n_mels), j_mel.mel_filterbank(n_mels))
    for a, b in zip(t_mel._dft_bases(), j_mel._dft_bases()):
        np.testing.assert_array_equal(a, b)
    assert (t_mel.N_FRAMES, t_mel.N_SAMPLES, t_mel.HOP_LENGTH) == \
        (j_mel.N_FRAMES, j_mel.N_SAMPLES, j_mel.HOP_LENGTH)


@pytest.mark.parametrize("n", [1000, 16_000 + 37])
def test_framing_and_power_match(n):
    audio = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    ref = np.asarray(j_mel._frame_signal(jnp.asarray(audio), 400, 160))
    got = t_mel._frame_signal(torch.from_numpy(audio), 400, 160).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(t_mel.stft_power(torch.from_numpy(audio)).numpy(),
                               np.asarray(j_mel.stft_power(jnp.asarray(audio))),
                               rtol=1e-4, atol=1e-4)


def test_pad_or_trim():
    x = torch.arange(10, dtype=torch.float32)
    assert torch.equal(t_mel.pad_or_trim(x, 4), x[:4])
    padded = t_mel.pad_or_trim(x, 16)
    assert padded.shape == (16,) and torch.equal(padded[10:], torch.zeros(6))
    assert t_mel.pad_or_trim(x, 10) is x


def test_silence_is_finite():
    out = t_mel.log_mel_spectrogram(torch.zeros(t_mel.N_SAMPLES), 80)
    assert out.shape == (3000, 80) and torch.isfinite(out).all()


def test_cpu_wrapper_uses_plain_version(window):
    before = mk.LAUNCHES
    frames = t_mel._frame_signal(torch.from_numpy(window), 400, 160)[:-1].contiguous()
    assert torch.equal(mk.log_mel_frames(frames, 80), mk.log_mel_frames_plain(frames, 80))
    assert mk.LAUNCHES == before


def _wav(path, fmt_code, bits, channels, rate, payload: bytes):
    block = channels * bits // 8
    hdr = (b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVEfmt "
           + struct.pack("<IHHIIHH", 16, fmt_code, channels, rate, rate * block, block, bits)
           + b"data" + struct.pack("<I", len(payload)))
    path.write_bytes(hdr + payload)


@pytest.mark.parametrize("kind", ["pcm16_mono_16k", "pcm24_stereo_16k", "f32_mono_8k",
                                  "pcm16_stereo_44k"])
def test_wav_reader_matches_jax(tmp_path, kind):
    rng = np.random.default_rng(7)
    x = (rng.standard_normal(4000) * 0.2).clip(-1, 1).astype(np.float32)
    path = tmp_path / f"{kind}.wav"
    if kind == "pcm16_mono_16k":
        _wav(path, 1, 16, 1, 16000, (x * 32767).astype("<i2").tobytes())
    elif kind == "pcm24_stereo_16k":
        v = (np.repeat(x, 2) * 8388607).astype("<i4")
        b = v.view(np.uint8).reshape(-1, 4)[:, :3].tobytes()
        _wav(path, 1, 24, 2, 16000, b)
    elif kind == "f32_mono_8k":
        _wav(path, 3, 32, 1, 8000, x.astype("<f4").tobytes())
    else:
        _wav(path, 1, 16, 2, 44100, (np.repeat(x, 2) * 32767).astype("<i2").tobytes())
    ref, ref_rate = j_decode._read_wav(path)
    got, got_rate = t_decode._read_wav(path)
    assert got_rate == ref_rate
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(t_decode.load_audio(path),
                                  j_decode.resample(ref, ref_rate, 16000))


def test_load_audio_rejects_non_wav(tmp_path):
    p = tmp_path / "a.mp3"
    p.write_bytes(b"ID3")
    with pytest.raises(RuntimeError, match="M7"):
        t_decode.load_audio(p)
