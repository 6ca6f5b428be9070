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


def test_load_audio_rejects_non_wav(tmp_path, monkeypatch):
    """Without ffmpeg on PATH a non-WAV file raises the reference's error
    (with ffmpeg it decodes: tests/test_torch_audio_serving.py)."""
    p = tmp_path / "a.mp3"
    p.write_bytes(b"ID3")
    monkeypatch.setattr(t_decode.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="not a WAV file and ffmpeg is not installed"):
        t_decode.load_audio(p)


@pytest.mark.parametrize("n_frames", [1, 31, 32, 33, 3000, 9500, 24000])
@pytest.mark.parametrize("n_mels", [80, 128])
def test_mel_kernel_plan_covers_every_bin_and_frame_once(n_frames, n_mels):
    """csrc/mel.cu's grid: every frame in one cluster, the cluster's blocks
    taking the 208 padded bins and then the mels, each exactly once."""
    p = mk.mel_plan(n_frames, n_mels)
    frames = np.zeros(p["clusters"] * p["frames"], np.int64)
    bins = np.zeros(mk.N_BINS_PAD, np.int64)
    mels = np.zeros(p["blocks"] * p["mels"], np.int64)
    for c in range(p["clusters"]):
        frames[c * p["frames"]:(c + 1) * p["frames"]] += 1
    for r in range(p["blocks"]):
        bins[r * p["bins"]:(r + 1) * p["bins"]] += 1
        mels[r * p["mels"]:(r + 1) * p["mels"]] += 1
    assert (frames[:n_frames] == 1).all() and frames.size - n_frames < p["frames"]
    assert (bins == 1).all() and p["blocks"] * p["bins"] == mk.N_BINS_PAD
    assert (mels[:n_mels] == 1).all() and mels.size - n_mels < p["blocks"]


@pytest.mark.parametrize("n_mels", [80, 128])
def test_mel_kernel_tables(n_mels):
    """The bases hold each bin's cosine and sine side by side, a block's 52
    bins (104 columns) contiguous, the padded bins zero; every
    filter is zero outside its [lo, hi), so the kernel's sum over that range
    in bin order is the dense loop's, bit for bit (float32, emulated)."""
    blocks, fb_t, ranges = mk._padded_tables(n_mels)
    assert blocks.shape == (mk.CLUSTER, 400, 2 * mk.BINS_A_BLOCK)
    basis = np.concatenate(list(blocks), axis=1)  # block r's columns side by side
    w_real, w_imag = t_mel._dft_bases()
    np.testing.assert_array_equal(basis[:, 0:402:2], w_real)
    np.testing.assert_array_equal(basis[:, 1:402:2], w_imag)
    assert not basis[:, 402:].any()
    np.testing.assert_array_equal(fb_t[:201], t_mel.mel_filterbank(n_mels).T)
    assert not fb_t[201:].any()
    for mel, (lo, hi) in enumerate(ranges):
        assert not fb_t[:lo, mel].any() and not fb_t[hi:, mel].any()
        assert lo < hi and fb_t[lo, mel] != 0 and fb_t[hi - 1, mel] != 0
    power = np.random.default_rng(n_mels).random((4, mk.N_BINS_PAD)).astype(np.float32)
    for f in range(power.shape[0]):
        for mel, (lo, hi) in enumerate(ranges):
            dense = np.float32(0)
            for b in range(mk.N_BINS_PAD):
                dense = np.float32(dense + np.float32(power[f, b] * fb_t[b, mel]))
            sparse = np.float32(0)
            for b in range(lo, hi):
                sparse = np.float32(sparse + np.float32(power[f, b] * fb_t[b, mel]))
            assert dense == sparse


@pytest.mark.parametrize("n_frames", [1, 33, 3000])
def test_mel_kernel_dataflow_matches_plain(n_frames):
    """The kernel's data flow in plain PyTorch on the CPU: each block's
    interleaved columns give its bins' re and im, the cluster's spectra
    are gathered, each mel sums its [lo, hi): within 2e-4 of the plain
    version and of the JAX package's XLA mel."""
    n_mels = 128
    rng = np.random.default_rng(n_frames)
    frames = torch.from_numpy((rng.standard_normal((n_frames, 400)) * 0.1).astype(np.float32))
    basis, fb_t, ranges = (torch.from_numpy(a) for a in mk._padded_tables(n_mels))
    p = mk.mel_plan(n_frames, n_mels)
    out = torch.empty((n_frames, n_mels))
    for c in range(p["clusters"]):
        tile = frames[c * p["frames"]:(c + 1) * p["frames"]]
        spectra = []
        for r in range(p["blocks"]):
            cols = tile @ basis[r]
            spectra.append(cols[:, 0::2] ** 2 + cols[:, 1::2] ** 2)
        spec = torch.cat(spectra, dim=1)
        for r in range(p["blocks"]):
            for mel in range(r * p["mels"], min((r + 1) * p["mels"], n_mels)):
                lo, hi = ranges[mel].tolist()
                acc = spec[:, lo:hi] @ fb_t[lo:hi, mel]
                out[c * p["frames"]:c * p["frames"] + tile.shape[0], mel] = torch.log10(
                    torch.clamp_min(acc, 1e-10))
    np.testing.assert_allclose(out.numpy(), mk.log_mel_frames_plain(frames, n_mels).numpy(),
                               atol=TOL, rtol=0)
    j_frames = jnp.asarray(frames.numpy())
    wr, wi = (jnp.asarray(a) for a in j_mel._dft_bases())
    re, im = j_frames @ wr, j_frames @ wi
    mel = (re * re + im * im) @ jnp.asarray(j_mel.mel_filterbank(n_mels)).T
    ref = np.asarray(jnp.log10(jnp.maximum(mel, 1e-10)))
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=0)
