"""Port parity: the WER harness, the serving audio loaders, the C++ host
library (WAV reader, DTW) and the ffmpeg path of whisper_mlx_tpu_torch
against the JAX package on the CPU. Everything here is exact.
"""

from __future__ import annotations

import os
import stat
import struct
import sys

import numpy as np
import pytest

import torch  # noqa: F401  (torch before jax: the reverse order has deadlocked)
import jax  # noqa: F401

from whisper_mlx_tpu.audio import decode as j_decode
from whisper_mlx_tpu.inference import wer as j_wer
from whisper_mlx_tpu_torch import native as t_native
from whisper_mlx_tpu_torch.audio import decode as t_decode
from whisper_mlx_tpu_torch.inference import wer as t_wer
from whisper_mlx_tpu_torch.inference import word_timestamps as twt


# -- inference/wer.py ----------------------------------------------------------


def test_wer_copy_is_the_reference_text():
    """The copy's code is the reference's, line for line, past its docstring."""
    def body(mod):
        src = open(mod.__file__, encoding="utf-8").read()
        return src[src.index("from __future__ import annotations"):]

    assert body(t_wer) == body(j_wer)


@pytest.mark.parametrize("text,want", [("Hello, World!", "hello world"),
                                       ("I can't  go", "i cannot go"),
                                       ("they're won't", "they are will not"),
                                       ("  Tabs\tand\nlines ", "tabs and lines")])
def test_normalize_text(text, want):
    assert t_wer.normalize_text(text) == j_wer.normalize_text(text) == want


@pytest.mark.parametrize("ref,hyp,want", [
    (["a", "b", "c"], ["a", "b", "c"], (0, 0, 0, 0)),
    (["a", "b", "c"], ["a", "x", "c"], (1, 0, 0, 1)),
    (["a", "b", "c"], ["a", "c"], (0, 1, 0, 1)),
    (["a", "c"], ["a", "b", "c"], (0, 0, 1, 1)),
    ([], ["a"], (0, 0, 1, 1)),
])
def test_edit_distance(ref, hyp, want):
    assert t_wer.edit_distance(ref, hyp) == j_wer.edit_distance(ref, hyp) == want


@pytest.mark.parametrize("ref,hyp,want", [("the cat sat on the mat", "the cat sat on the mat", 0.0),
                                          ("the cat sat", "the dog sat", 1 / 3),
                                          ("Hello, world!", "hello world", 0.0)])
def test_wer_values(ref, hyp, want):
    got = t_wer.wer(ref, hyp)
    assert got == j_wer.wer(ref, hyp)
    assert abs(got["wer"] - want) < 1e-9


def test_corpus_wer_weighting():
    pairs = [("a b c d", "a b c d"), ("x y", "x z")]  # 1 error / 6 words
    stats = t_wer.corpus_wer(pairs)
    assert stats == j_wer.corpus_wer(pairs)
    assert abs(stats["wer"] - 1 / 6) < 1e-9 and stats["utterances"] == 2


# -- the serving loaders ---------------------------------------------------------


def _wav(path, rate=16_000, channels=1, bits=16, fmt=1, n=1600, seed=0):
    rng = np.random.default_rng(seed)
    if bits == 16:
        body = (np.clip(rng.standard_normal(n * channels) * 0.1, -1, 1)
                * 32767).astype("<i2").tobytes()
    elif bits == 24:
        v = (np.clip(rng.standard_normal(n * channels) * 0.1, -1, 1) * 8388607).astype("<i4")
        body = v.view(np.uint8).reshape(-1, 4)[:, :3].tobytes()
    elif bits == 8:
        body = rng.integers(0, 256, n * channels).astype(np.uint8).tobytes()
    elif fmt == 3:
        body = rng.standard_normal(n * channels).astype("<f4" if bits == 32 else "<f8").tobytes()
    else:
        body = (rng.standard_normal(n * channels) * 2e8).astype("<i4").tobytes()
    block = channels * bits // 8
    hdr = b"RIFF" + struct.pack("<I", 36 + len(body)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, fmt, channels, rate, rate * block, block, bits)
    hdr += b"data" + struct.pack("<I", len(body))
    path.write_bytes(hdr + body)
    return path


def test_load_audio_pcm16_gating(tmp_path):
    good = _wav(tmp_path / "good.wav")
    raw = t_decode.load_audio_pcm16(good)
    assert raw is not None and raw.dtype == np.int16
    np.testing.assert_array_equal(raw, j_decode.load_audio_pcm16(good))
    np.testing.assert_array_equal(raw.astype(np.float32) / 32768.0, t_decode.load_audio(good))

    for name, kw in (("sr", dict(rate=8_000)), ("st", dict(channels=2)),
                     ("f32", dict(bits=32, fmt=3))):
        path = _wav(tmp_path / f"{name}.wav", **kw)
        assert t_decode.load_audio_pcm16(path) is None
        assert j_decode.load_audio_pcm16(path) is None
    assert t_decode.load_audio_pcm16(tmp_path / "missing.wav") is None
    (tmp_path / "junk.wav").write_bytes(b"not a wav")
    assert t_decode.load_audio_pcm16(tmp_path / "junk.wav") is None
    (tmp_path / "a.mp3").write_bytes(b"ID3")
    assert t_decode.load_audio_pcm16(tmp_path / "a.mp3") is None
    # an odd data chunk is corrupt 16-bit PCM: refused here, raised by load_audio
    odd = _wav(tmp_path / "odd.wav")
    odd.write_bytes(odd.read_bytes()[:-1])
    assert t_decode.load_audio_pcm16(odd) is None
    with pytest.raises(ValueError):
        t_decode.load_audio(odd)


def test_load_audio_serving_single_parse(tmp_path, monkeypatch):
    reads = []
    real_read_bytes = t_decode.Path.read_bytes
    monkeypatch.setattr(t_decode.Path, "read_bytes",
                        lambda self: (reads.append(str(self)), real_read_bytes(self))[1])

    fast = _wav(tmp_path / "fast.wav")
    out = t_decode.load_audio_serving(fast)
    assert out.dtype == np.int16 and reads.count(str(fast)) == 1
    np.testing.assert_array_equal(out, j_decode.load_audio_serving(fast))

    for name, kw in (("stereo", dict(channels=2)), ("rate", dict(rate=22_050)),
                     ("f32", dict(bits=32, fmt=3))):
        reads.clear()
        path = _wav(tmp_path / f"{name}.wav", **kw)
        out = t_decode.load_audio_serving(path)
        assert out.dtype == np.float32
        assert reads.count(str(path)) == 1  # decoded from the one parse
        np.testing.assert_array_equal(out, j_decode.load_audio_serving(path))
        np.testing.assert_array_equal(out, t_decode.load_audio(path))

    with pytest.raises((ValueError, OSError)):  # load_audio's canonical error
        t_decode.load_audio_serving(tmp_path / "nope.wav")


# -- the C++ host library ----------------------------------------------------------


WAV_KINDS = [dict(), dict(channels=2), dict(channels=3, n=999), dict(bits=24, channels=2),
             dict(bits=8), dict(bits=32), dict(bits=32, fmt=3), dict(bits=64, fmt=3),
             dict(rate=44_100, channels=2)]


@pytest.mark.parametrize("kind", range(len(WAV_KINDS)))
def test_native_reader_matches_numpy(tmp_path, kind):
    """The C++ reader (built here with g++) gives the NumPy reader's samples
    and rate bit for bit, and load_audio (which takes it) the reference's."""
    lib = t_native.load()
    assert lib is not None, "g++ is on PATH here: the library must build"
    path = _wav(tmp_path / "x.wav", seed=kind, **WAV_KINDS[kind])
    got, rate = lib.read_wav(path)
    ref, ref_rate = j_decode._read_wav(path)
    assert rate == ref_rate and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, t_decode._read_wav(path)[0])
    np.testing.assert_array_equal(t_decode.load_audio(path), j_decode.resample(ref, ref_rate))


@pytest.mark.parametrize("content", [b"not a wav at all", b"RIFF\x00\x00\x00\x00WAVE", b""])
def test_native_reader_refuses_garbage(tmp_path, content):
    path = tmp_path / "bad.wav"
    path.write_bytes(content)
    with pytest.raises(ValueError, match="bad.wav"):
        t_native.load().read_wav(path)
    with pytest.raises(ValueError, match="bad.wav"):
        t_decode.load_audio(path)


def test_native_dtw_matches_numpy():
    lib = t_native.load()
    rng = np.random.default_rng(0)
    for n, m in ((5, 40), (20, 300), (1, 7), (64, 1500)):
        cost = rng.random((n, m)).astype(np.float32)
        for g, r in zip(lib.dtw(cost), twt.dtw_numpy(cost)):
            np.testing.assert_array_equal(g, r)


def test_native_builds_once_into_build_native(monkeypatch):
    path = t_native.library_path()
    assert path.parent.name == "native" and path.parent.parent.name == "build"
    assert t_native.build() == path and path.exists()
    monkeypatch.setattr(t_native, "_loaded", False)
    monkeypatch.setattr(t_native, "_lib", None)
    monkeypatch.setattr(t_native.shutil, "which", lambda name: None)
    monkeypatch.setattr(t_native, "library_path", lambda: path.with_name("absent.so"))
    assert t_native.load() is None  # no g++ and nothing built: the NumPy paths


def test_load_audio_without_native_uses_numpy(tmp_path, monkeypatch):
    path = _wav(tmp_path / "x.wav", channels=2, bits=24)
    want = t_decode.load_audio(path)
    monkeypatch.setattr(t_native, "load", lambda: None)
    np.testing.assert_array_equal(t_decode.load_audio(path), want)


# -- other containers through ffmpeg -------------------------------------------------


@pytest.fixture
def stub_ffmpeg(tmp_path, monkeypatch):
    """An ``ffmpeg`` on PATH that checks its arguments and writes known
    f32le samples to stdout."""
    samples = np.random.default_rng(5).standard_normal(4801).astype("<f4")
    (tmp_path / "pcm.f32").write_bytes(samples.tobytes())
    script = tmp_path / "bin" / "ffmpeg"
    script.parent.mkdir()
    script.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "a = sys.argv[1:]\n"
        "assert a[a.index('-f') + 1] == 'f32le' and a[a.index('-ar') + 1] == '16000', a\n"
        "assert a[a.index('-ac') + 1] == '1' and a[-1] == '-', a\n"
        f"sys.stdout.buffer.write(open({str(tmp_path / 'pcm.f32')!r}, 'rb').read())\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{script.parent}{os.pathsep}{os.environ['PATH']}")
    return samples


def test_ffmpeg_decode_matches_reference(tmp_path, stub_ffmpeg):
    src = tmp_path / "speech.mp3"
    src.write_bytes(b"ID3 not really")
    got = t_decode.load_audio(src)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, stub_ffmpeg)
    np.testing.assert_array_equal(got, j_decode._ffmpeg_decode(src))
    np.testing.assert_array_equal(t_decode._ffmpeg_decode(src), j_decode.load_audio(src))
    np.testing.assert_array_equal(t_decode.load_audio_serving(src), got)


def test_no_ffmpeg_error_matches_reference(tmp_path, monkeypatch):
    src = tmp_path / "speech.m4a"
    src.write_bytes(b"\x00")
    monkeypatch.setattr(t_decode.shutil, "which", lambda name: None)
    monkeypatch.setattr(j_decode.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError) as got:
        t_decode.load_audio(src)
    with pytest.raises(RuntimeError) as ref:
        j_decode.load_audio(src)
    assert str(got.value) == str(ref.value)
    assert "ffmpeg is not installed" in str(got.value)
