"""Port parity: decode(), transcribe() and the CLI of whisper_mlx_tpu_torch
against the JAX package on the CPU, plus the port's hygiene checks.

The same numpy weights (JAX ``init_params`` converted by
``checkpoint/convert.py``) and the same mel go through both packages.
At temperature 0 the port must be token-identical; at T > 0 the two draw
from different random streams, so the first step's filtered log-probs
are compared instead.
"""

from __future__ import annotations

import dataclasses
import io
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch  # noqa: F401  (torch before jax: see CLAUDE.md)
import jax
import jax.numpy as jnp

from tests.conftest import make_speechy_audio
from whisper_mlx_tpu.audio.mel import log_mel_spectrogram as j_log_mel
from whisper_mlx_tpu.audio.mel import N_SAMPLES, pad_or_trim
from whisper_mlx_tpu.decoding import filters as j_filters
from whisper_mlx_tpu.decoding import task as j_task
from whisper_mlx_tpu.decoding import tokenizer as j_tokenizer
from whisper_mlx_tpu.inference import writers as j_writers
from whisper_mlx_tpu.inference.transcribe import transcribe as j_transcribe
from whisper_mlx_tpu.models import whisper as jw
from whisper_mlx_tpu_torch import cli as t_cli
from whisper_mlx_tpu_torch.checkpoint.convert import params_from_jax
from whisper_mlx_tpu_torch.decoding import filters as t_filters
from whisper_mlx_tpu_torch.decoding import task as t_task
from whisper_mlx_tpu_torch.decoding import tokenizer as t_tokenizer
from whisper_mlx_tpu_torch.inference import writers as t_writers
from whisper_mlx_tpu_torch.inference.transcribe import transcribe as t_transcribe
from whisper_mlx_tpu_torch.models import whisper as tw
from whisper_mlx_tpu_torch.runtime.serving_config import apply_asr_serving_config

DIMS = dict(n_mels=80, n_audio_state=64, n_audio_head=4, n_audio_layer=2,
            n_text_state=64, n_text_head=4, n_text_layer=2)


@pytest.fixture(scope="module")
def pair():
    tok = j_tokenizer.make_synthetic_tokenizer()
    jcfg = jw.WhisperConfig(n_vocab=tok.n_vocab, **DIMS)
    jparams = jw.init_params(jcfg, seed=0)
    tcfg = tw.WhisperConfig(n_vocab=tok.n_vocab, **DIMS)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    audio = pad_or_trim(jnp.asarray(make_speechy_audio(6.0)), N_SAMPLES)
    mel = np.array(j_log_mel(audio, n_mels=80))[None]
    return jparams, jcfg, tparams, tcfg, mel


def _cfgs(pair, kv_bits, self_kv_bits):
    _, jcfg, _, tcfg, _ = pair
    return (dataclasses.replace(jcfg, kv_bits=kv_bits, self_kv_bits=self_kv_bits),
            dataclasses.replace(tcfg, kv_bits=kv_bits, self_kv_bits=self_kv_bits))


@pytest.mark.parametrize("kv_bits,self_kv_bits", [(0, 0), (4, 8)])
def test_decode_greedy_token_identical(pair, kv_bits, self_kv_bits):
    jparams, _, tparams, _, mel = pair
    jcfg, tcfg = _cfgs(pair, kv_bits, self_kv_bits)
    opts = j_task.DecodingOptions(sample_len=40)
    ref = j_task.decode(jparams, jnp.asarray(mel), j_tokenizer.make_synthetic_tokenizer(),
                        jcfg, opts)[0]
    got = t_task.decode(tparams, torch.from_numpy(mel), t_tokenizer.make_synthetic_tokenizer(),
                        tcfg, t_task.DecodingOptions(sample_len=40))[0]
    assert len(ref.tokens) > 0
    assert got.tokens == ref.tokens
    assert got.text == ref.text
    np.testing.assert_allclose(got.avg_logprob, ref.avg_logprob, atol=1e-4)
    np.testing.assert_allclose(got.no_speech_prob, ref.no_speech_prob, atol=1e-5)


def test_decode_sampling_first_step_logprobs(pair):
    """T > 0: the filtered, temperature-scaled log-probs of the first
    sampled step agree; the port's best_of decode runs and is seeded."""
    jparams, jcfg, tparams, tcfg, mel = pair
    temp = 0.6
    tok = j_tokenizer.make_synthetic_tokenizer()
    opts = j_task.DecodingOptions(temperature=temp, best_of=5, sample_len=8)
    init, _, sample_begin = j_task.build_initial_tokens(tok, opts, jcfg.n_text_ctx)
    suppress = j_task._resolve_suppress(opts, tok)
    blank = tuple(tok.encode(" ")) + (tok.eot,)
    always, begin = j_filters.make_suppress_mask(jcfg.n_vocab, suppress, blank)
    fcfg = dict(eot=tok.eot, no_timestamps=tok.no_timestamps,
                timestamp_begin=tok.timestamp_begin, sample_begin=sample_begin)
    buf = np.zeros((1, jcfg.n_text_ctx), np.int32)
    buf[0, :len(init)] = init

    states = jw.encode(jparams, jnp.asarray(mel), jcfg)
    logits, _, _ = jw.decode_step(jparams, jnp.asarray([init], jnp.int32), jnp.int32(0),
                                  jw.init_kv_cache(jcfg, 1), jw.cross_kv(jparams, states, jcfg),
                                  jcfg)
    jf = j_filters.apply_filters(logits[:, -1], jnp.asarray(buf), jnp.int32(len(init)),
                                 jnp.asarray(always), jnp.asarray(begin),
                                 j_filters.FilterConfig(**fcfg))
    ref = np.asarray(jax.nn.log_softmax(jf / temp, axis=-1))

    tstates = tw.encode(tparams, torch.from_numpy(mel), tcfg)
    tlogits, _ = tw.decode_step(tparams, torch.tensor([init]), 0,
                                tw.init_kv_cache(tcfg, 1, "cpu"),
                                tw.cross_kv(tparams, tstates, tcfg), tcfg)
    tf = t_filters.apply_filters(tlogits[:, -1], torch.from_numpy(buf).long(), len(init),
                                 torch.from_numpy(always), torch.from_numpy(begin),
                                 t_filters.FilterConfig(**fcfg))
    got = torch.log_softmax(tf / temp, dim=-1).numpy()
    finite = np.isfinite(ref)
    assert np.array_equal(finite, np.isfinite(got))
    np.testing.assert_allclose(got[finite], ref[finite], atol=1e-4)

    topts = t_task.DecodingOptions(temperature=temp, best_of=5, sample_len=8)
    runs = [t_task.decode(tparams, tstates, t_tokenizer.make_synthetic_tokenizer(), tcfg,
                          topts, states_precomputed=True,
                          generator=torch.Generator().manual_seed(3))[0].tokens
            for _ in range(2)]
    assert runs[0] == runs[1]


def _write_wav(path, audio):
    pcm = (np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes()
    sr = 16000
    hdr = (b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVEfmt "
           + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16)
           + b"data" + struct.pack("<I", len(pcm)))
    path.write_bytes(hdr + pcm)


def test_transcribe_matches_jax(pair, tmp_path):
    """Tiny-config transcribe of a 40 s WAV at temperature 0: same text and
    segments as the JAX package."""
    jparams, jcfg, tparams, tcfg, _ = pair
    wav = tmp_path / "in.wav"
    _write_wav(wav, make_speechy_audio(40.0, seed=2))
    kw = dict(temperature=0.0, verbose=False, condition_on_previous_text=False,
              sample_len=48)
    ref = j_transcribe(str(wav), params=jparams, config=jcfg,
                       tokenizer=j_tokenizer.make_synthetic_tokenizer(), **kw)
    got = t_transcribe(str(wav), params=tparams, config=tcfg,
                       tokenizer=t_tokenizer.make_synthetic_tokenizer(), device="cpu", **kw)
    assert got["text"] == ref["text"]
    assert got["language"] == ref["language"]
    assert len(got["segments"]) == len(ref["segments"]) > 0
    for g, r in zip(got["segments"], ref["segments"]):
        for key in ("id", "seek", "start", "end", "text", "tokens", "temperature"):
            assert g[key] == r[key], key
        np.testing.assert_allclose(g["avg_logprob"], r["avg_logprob"], atol=1e-4)


def test_cli_cpu_writes_txt(tmp_path):
    wav = tmp_path / "a.wav"
    _write_wav(wav, make_speechy_audio(3.0))
    rc = t_cli.main([str(wav), "-f", "txt", "--output-name", "out", "-o", str(tmp_path),
                     "--model", "test-tiny", "--device", "cpu", "--verbose", "False",
                     "--condition-on-previous-text", "False",
                     "--hallucination-silence-threshold", "1",
                     "--temperature-increment-on-fallback", "None"])
    assert rc == 0
    assert (tmp_path / "out.txt").exists()


def test_cli_cuda_without_gpu_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wav = tmp_path / "a.wav"
    _write_wav(wav, make_speechy_audio(1.0))
    with pytest.raises(RuntimeError, match="cuda"):
        t_cli.main([str(wav), "--model", "test-tiny"])


def test_serving_config_defaults():
    """CUDA serves bf16 with the kernels; the CPU keeps the parity mode."""
    cfg = tw.WHISPER_CONFIGS["tiny"]
    params = {"w": torch.zeros(2), "i": torch.zeros(2, dtype=torch.int8)}
    p, c = apply_asr_serving_config(params, cfg, "cuda")
    assert (c.dtype, c.flash_attention, c.kv_bits, c.self_kv_bits) == (
        torch.bfloat16, True, 4, 8)
    assert p["w"].dtype == torch.bfloat16 and p["i"].dtype == torch.int8
    p, c = apply_asr_serving_config(params, cfg, "cpu")
    assert (c.dtype, c.flash_attention, c.kv_bits, c.self_kv_bits) == (
        torch.float32, False, 0, 0)
    assert p["w"].dtype == torch.float32


@pytest.mark.parametrize("name,value,device", [
    ("WTPU_SERVE_FLASH", "0", "cuda"),
    ("WTPU_SERVE_KV", "0", "cuda"),
    ("WTPU_SERVE_SELF_KV", "0", "cuda"),
    ("WTPU_SERVE_PRECISION", "float32", "cuda"),
    ("WTPU_SERVE_KV", "x", "cpu"),
    ("WTPU_SERVE_SELF_KV", "16", "cpu"),
    ("WTPU_SERVE_FLASH", "yes", "cpu"),
])
def test_serving_config_rejects_skipping_kernels(monkeypatch, name, value, device):
    """No knob skips a kernel on CUDA, and no value that does not parse
    turns silently into the default."""
    monkeypatch.setenv(name, value)
    with pytest.raises(ValueError, match=name if device == "cpu" else "on CUDA"):
        apply_asr_serving_config({}, tw.WHISPER_CONFIGS["tiny"], device)


@pytest.mark.parametrize("kwargs,item", [
    (dict(mesh=object()), "Mesh"),
    (dict(batch_windows=True, mesh=object()), "Mesh"),
])
def test_features_out_of_slice_raise(pair, kwargs, item):
    """Every feature is ported (``mesh=`` since ROADMAP.md M14); a mesh that
    is not a ``parallel.mesh.Mesh`` raises naming the type it takes."""
    _, _, tparams, tcfg, _ = pair
    with pytest.raises(TypeError, match=item):
        t_transcribe(np.zeros(16000, np.float32), params=tparams, config=tcfg,
                     tokenizer=t_tokenizer.make_synthetic_tokenizer(), device="cpu",
                     temperature=0.0, sample_len=4, **kwargs)


@pytest.mark.parametrize("text", ["Hello world!", " naïve café — 123", "♪ (music) ♪",
                                  "日本語のテキスト", ""])
def test_tokenizer_copy_matches(text):
    for n_base, langs in ((256, 99), (50257, 100)):
        byte_vocab = {c: i for i, c in enumerate(j_tokenizer.bytes_to_unicode().values())}
        jt = j_tokenizer.WhisperTokenizer(j_tokenizer.ByteLevelBPE(byte_vocab, []),
                                          n_base=n_base, num_languages=langs)
        tt = t_tokenizer.WhisperTokenizer(t_tokenizer.ByteLevelBPE(byte_vocab, []),
                                          n_base=n_base, num_languages=langs)
        ids = jt.encode(text)
        assert tt.encode(text) == ids
        assert tt.decode(ids) == jt.decode(ids)
        assert tt.sot_sequence == jt.sot_sequence
        assert tt.non_speech_tokens == jt.non_speech_tokens
        assert (tt.n_vocab, tt.timestamp_begin, tt.no_speech) == \
            (jt.n_vocab, jt.timestamp_begin, jt.no_speech)


@pytest.mark.parametrize("fmt", ["txt", "json", "srt", "vtt", "tsv"])
def test_writers_copy_matches(fmt):
    result = {"text": " a b", "language": "en", "segments": [
        {"id": 0, "start": 0.0, "end": 1.5, "text": " hello --> there"},
        {"id": 1, "start": 3661.25, "end": 3662.0, "text": "\tworld "}]}
    outs = []
    for mod in (j_writers, t_writers):
        buf = io.StringIO()
        mod.WRITERS[fmt](result, buf)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]


def test_port_imports_without_jax():
    code = ("import sys, pkgutil, importlib, whisper_mlx_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, 'whisper_mlx_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [k for k in ('jax', 'triton', 'whisper_mlx_tpu') if k in sys.modules]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stderr
