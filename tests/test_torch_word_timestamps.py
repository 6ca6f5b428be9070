"""Port parity: word timestamps (cross-attention DTW alignment) and the
hallucination re-seek of whisper_mlx_tpu_torch against the JAX package on
the CPU, tiny config at fp32.

Tolerances: the alignment pass's cross-attention weights within 1e-5 of
JAX's (fp32 sums in another order); word start and end times within 1e-6 s
(the same DTW path); word probabilities within 1e-5. The end-to-end cases
run both packages' NumPy DTW (``same_dtw``): the C++ DTW casts its costs to
fp32, so whether each side built its library would otherwise decide near
ties; the C++ DTW is held path-equal to the NumPy one on its own.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

import torch  # (torch before jax: the reverse order has deadlocked)
import jax
import jax.numpy as jnp

import whisper_mlx_tpu.native as j_native
from tests.conftest import make_speechy_audio
from whisper_mlx_tpu import cli as j_cli
from whisper_mlx_tpu.decoding import tokenizer as j_tokenizer
from whisper_mlx_tpu.inference import transcribe as j_tr
from whisper_mlx_tpu.inference import word_timestamps as jwt
from whisper_mlx_tpu.models import whisper as jw
from whisper_mlx_tpu_torch import cli as t_cli
from whisper_mlx_tpu_torch import native as t_native
from whisper_mlx_tpu_torch.checkpoint.convert import params_from_jax
from whisper_mlx_tpu_torch.decoding import tokenizer as t_tokenizer
from whisper_mlx_tpu_torch.inference import transcribe as t_tr
from whisper_mlx_tpu_torch.inference import word_timestamps as twt
from whisper_mlx_tpu_torch.models import whisper as tw

DIMS = dict(n_mels=80, n_audio_state=64, n_audio_head=4, n_audio_layer=2,
            n_text_state=64, n_text_head=4, n_text_layer=2)
TOL_W = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Thousands of tiny torch ops: beside other test workers on the same
    cores, intra-op threads only contend. Restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    tok = j_tokenizer.make_synthetic_tokenizer()
    jcfg = jw.WhisperConfig(n_vocab=tok.n_vocab, **DIMS)
    jparams = jw.init_params(jcfg, seed=0)
    tcfg = tw.WhisperConfig(n_vocab=tok.n_vocab, **DIMS)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    return jparams, jcfg, tparams, tcfg


@pytest.fixture
def same_dtw(monkeypatch):
    """Both packages on their NumPy DTW."""
    monkeypatch.setattr(j_native, "lib", None)
    monkeypatch.setattr(t_native, "load", lambda: None)


def _mel(seed=0):
    return (np.random.default_rng(seed).standard_normal((3000, 80)) * 0.5).astype(np.float32)


# -- host pieces ---------------------------------------------------------------


@pytest.mark.parametrize("shape,width", [((4, 11, 97), 7), ((2, 5, 7), 7), ((3, 40), 5),
                                         ((1, 6, 20), 1), ((2, 3, 30), 4), ((5, 64), 3)])
def test_median_filter_matches_jax(shape, width):
    """Odd widths through torch.median (the median is one of the values),
    even ones through NumPy: the reference's values exactly."""
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    np.testing.assert_array_equal(twt.median_filter(x, width), jwt.median_filter(x, width))


def _costs():
    rng = np.random.default_rng(7)
    cases = [rng.random((n, m)) for n, m in ((5, 40), (12, 120), (1, 9), (20, 300))]
    # a /16 grid provokes exact ties, where the comparator's rule decides
    cases += [rng.integers(0, 8, size=(n, m)) / 16.0 for n, m in ((6, 50), (10, 10), (3, 200))]
    return cases


@pytest.mark.parametrize("case", range(7))
def test_dtw_numpy_matches_jax(case, monkeypatch):
    monkeypatch.setattr(j_native, "lib", None)
    cost = _costs()[case]
    for got, ref in zip(twt.dtw_numpy(cost), jwt.dtw(cost)):
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("case", range(7))
def test_dtw_native_matches_numpy(case):
    """The C++ DTW (built here with g++) gives the NumPy path exactly, on
    random costs and on exact ties (the /16 grid is exact in fp32)."""
    lib = t_native.load()
    assert lib is not None, "g++ is on PATH here: the library must build"
    cost = _costs()[case]
    got = twt.dtw(cost)
    for g, r, n in zip(got, twt.dtw_numpy(cost), lib.dtw(cost)):
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(n, r)


@pytest.mark.parametrize("num_frames", [3000, 2000, 611])
def test_alignment_path_matches_jax(num_frames, same_dtw):
    rng = np.random.default_rng(num_frames)
    w = rng.random((6, 14, 1500)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    got = twt.alignment_path(w, num_frames, n_skip_rows=3)
    ref = jwt.alignment_path(w, num_frames, n_skip_rows=3)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def test_merge_punctuations_matches_jax():
    words = [(" -", [1]), (" hello", [2]), (",", [3]), (" world", [4]), (".", [5]),
             (" (", [6]), (" x", [7]), (")", [8])]
    out = []
    for mod in (twt, jwt):
        timings = [mod.WordTiming(w, t, 0.1 * i, 0.1 * i + 0.1, 0.9)
                   for i, (w, t) in enumerate(words)]
        mod.merge_punctuations(timings, "\"'“¿([{-", "\"'.。,，!！?？:：”)]}、")
        out.append([(w.word, w.tokens) for w in timings])
    assert out[0] == out[1]
    assert [w for w, _ in out[0] if w] == [" - hello,", " world.", " ( x)"]


def test_default_alignment_heads_match_jax():
    for layers, heads in ((4, 6), (2, 4), (32, 20), (5, 3)):
        assert twt.default_alignment_heads(tw.WhisperConfig(n_text_layer=layers,
                                                            n_text_head=heads)) == \
            jwt.default_alignment_heads(jw.WhisperConfig(n_text_layer=layers,
                                                         n_text_head=heads))


# -- the alignment pass ----------------------------------------------------------


def test_decode_step_collect_cross_attn_matches_jax(pair):
    """The teacher-forced pass with weights: logits and the cross-attention
    weights (layers, batch, heads, T, 1500) against JAX's at fp32."""
    jparams, jcfg, tparams, tcfg = pair
    tok = j_tokenizer.make_synthetic_tokenizer()
    mel = _mel(5)
    tokens = list(tok.sot_sequence) + [tok.no_timestamps] + tok.encode(" hello world") \
        + [tok.eot]
    states = jw.encode(jparams, jnp.asarray(mel)[None], jcfg)
    ref_logits, _, ref = jw.decode_step(
        jparams, jnp.asarray([tokens], jnp.int32), jnp.int32(0), jw.init_kv_cache(jcfg, 1),
        jw.cross_kv(jparams, states, jcfg), jcfg, collect_cross_attn=True)
    tstates = tw.encode(tparams, torch.from_numpy(mel)[None], tcfg)
    logits, cache, got = tw.decode_step(
        tparams, torch.tensor([tokens]), 0, tw.init_kv_cache(tcfg, 1, "cpu"),
        tw.cross_kv(tparams, tstates, tcfg), tcfg, collect_cross_attn=True)
    assert got.shape == (2, 1, 4, len(tokens), 1500) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL_W, rtol=0)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=2e-4, rtol=0)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)
    # without the flag: the same logits, two outputs
    plain = tw.decode_step(tparams, torch.tensor([tokens]), 0,
                           tw.init_kv_cache(tcfg, 1, "cpu"),
                           tw.cross_kv(tparams, tstates, tcfg), tcfg)
    assert len(plain) == 2
    torch.testing.assert_close(plain[0], logits, atol=0, rtol=0)


@pytest.mark.parametrize("cfg", [dict(kv_bits=4), dict(self_kv_bits=8)])
def test_collect_cross_attn_refuses_quantized_caches(pair, cfg):
    _, _, tparams, tcfg = pair
    tcfg = dataclasses.replace(tcfg, **cfg)
    states = torch.zeros(1, 1500, 64)
    with pytest.raises(ValueError, match="fp self and cross"):
        tw.decode_step(tparams, torch.zeros((1, 2), dtype=torch.long), 0,
                       tw.init_kv_cache(tcfg, 1, "cpu"), tw.cross_kv(tparams, states, tcfg),
                       tcfg, collect_cross_attn=True)


@pytest.mark.parametrize("num_frames,heads", [(3000, None), (2000, None), (1234, ((0, 1), (1, 3))),
                                              (3000, "config")])
def test_find_alignment_matches_jax(pair, same_dtw, num_frames, heads):
    jparams, jcfg, tparams, tcfg = pair
    tok = j_tokenizer.make_synthetic_tokenizer()
    text = tok.encode(" hello world again and again")
    kw = {}
    if heads == "config":  # the checkpoint's heads beat the upper-half default
        jcfg = dataclasses.replace(jcfg, alignment_heads=((0, 0), (1, 2)))
        tcfg = dataclasses.replace(tcfg, alignment_heads=((0, 0), (1, 2)))
    elif heads is not None:
        kw["alignment_heads"] = list(heads)
    mel = _mel(9)
    ref = jwt.find_alignment(jparams, jcfg, tok, text, mel, num_frames=num_frames, **kw)
    got = twt.find_alignment(tparams, tcfg, t_tokenizer.make_synthetic_tokenizer(), text,
                             torch.from_numpy(mel), num_frames=num_frames, **kw)
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert (g.word, g.tokens) == (r.word, r.tokens)
        assert abs(g.start - r.start) < 1e-6 and abs(g.end - r.end) < 1e-6
        assert abs(g.probability - r.probability) < 1e-5
    assert [t for w in got for t in w.tokens] == text


def test_find_alignment_forces_fp_caches(pair, monkeypatch):
    """Under the serving config's quantized caches the pass still runs on
    fp caches, with the same result as the parity config."""
    _, _, tparams, tcfg = pair
    tok = t_tokenizer.make_synthetic_tokenizer()
    text = tok.encode(" one two three")
    mel = torch.from_numpy(_mel(2))
    want = twt.find_alignment(tparams, tcfg, tok, text, mel, num_frames=3000)
    got = twt.find_alignment(tparams, dataclasses.replace(tcfg, kv_bits=4, self_kv_bits=8),
                             tok, text, mel, num_frames=3000)
    assert [(w.word, w.start, w.end, w.probability) for w in got] == \
        [(w.word, w.start, w.end, w.probability) for w in want]
    assert twt.find_alignment(tparams, tcfg, tok, [], mel, num_frames=3000) == []


def test_add_word_timestamps_distribution(monkeypatch):
    """Aligned words distributed back onto segments, isolated from the
    model: find_alignment stubbed with a known alignment (the JAX
    package's case, on both packages)."""
    tok = t_tokenizer.make_synthetic_tokenizer()
    t_hello, t_world = tok.encode(" hello"), tok.encode(" world")
    out = []
    for mod, tr in ((twt, t_tr), (jwt, j_tr)):
        segs = [tr.Segment(id=i, seek=0, start=2.0 * i, end=2.0 * i + 2, text=text,
                           tokens=list(toks), temperature=0.0, avg_logprob=-0.5,
                           compression_ratio=1.0, no_speech_prob=0.1)
                for i, (text, toks) in enumerate(((" hello", t_hello), (" world", t_world)))]
        fake = [mod.WordTiming(" hello", list(t_hello), 0.4, 1.6, 0.9),
                mod.WordTiming(" world", list(t_world), 2.1, 3.5, 0.8)]
        monkeypatch.setattr(mod, "find_alignment", lambda *a, fake=fake, **k: list(fake))
        mod.add_word_timestamps(segs, None, tw.WhisperConfig(), tok,
                                np.zeros((3000, 80), np.float32), time_offset=10.0)
        out.append([s.to_dict() for s in segs])
    assert out[0] == out[1]
    assert out[0][0]["words"] == [{"word": " hello", "start": 10.4, "end": 11.6,
                                   "probability": 0.9}]
    assert (out[0][0]["start"], out[0][0]["end"]) == (10.4, 11.6)


# -- transcribe, both modes ------------------------------------------------------


def _assert_same_words(got, ref):
    assert got["text"] == ref["text"]
    assert len(got["segments"]) == len(ref["segments"]) > 0
    n_words = 0
    for g, r in zip(got["segments"], ref["segments"]):
        assert (g["seek"], g["tokens"]) == (r["seek"], r["tokens"])
        assert abs(g["start"] - r["start"]) < 1e-6 and abs(g["end"] - r["end"]) < 1e-6
        assert ("words" in g) == ("words" in r)
        gw, rw = g.get("words") or [], r.get("words") or []
        assert [w["word"] for w in gw] == [w["word"] for w in rw]
        for a, b in zip(gw, rw):
            assert abs(a["start"] - b["start"]) < 1e-6 and abs(a["end"] - b["end"]) < 1e-6
            assert a["start"] <= a["end"]
            assert abs(a["probability"] - b["probability"]) < 1e-5
        n_words += len(gw)
    assert n_words > 0


def _both(pair, audio, **kw):
    jparams, jcfg, tparams, tcfg = pair
    ref = j_tr.transcribe(audio, params=jparams, config=jcfg,
                          tokenizer=j_tokenizer.make_synthetic_tokenizer(), **kw)
    got = t_tr.transcribe(audio, params=tparams, config=tcfg,
                          tokenizer=t_tokenizer.make_synthetic_tokenizer(), device="cpu", **kw)
    return ref, got


def test_sequential_word_timestamps_match_jax(pair, same_dtw):
    """The sequential loop aligns each window and re-seeks to the last
    aligned word where the window did not end on a timestamp pair."""
    ref, got = _both(pair, make_speechy_audio(40.0, seed=3), temperature=0.0,
                     word_timestamps=True, condition_on_previous_text=False,
                     no_speech_threshold=None, sample_len=24, verbose=False)
    _assert_same_words(got, ref)
    assert len({s["seek"] for s in got["segments"]}) >= 3  # re-seeked windows
    assert "align" in got["stages"]


@pytest.mark.parametrize("seconds,batch", [(35.0, 2), (65.0, 2)])
def test_batched_word_timestamps_match_jax(pair, same_dtw, seconds, batch):
    ref, got = _both(pair, make_speechy_audio(seconds, seed=1), temperature=0.0,
                     batch_windows=True, window_batch_size=batch, word_timestamps=True,
                     no_speech_threshold=None, sample_len=24, verbose=False)
    _assert_same_words(got, ref)


def test_hallucination_reseek_same_seeks(pair, same_dtw, monkeypatch):
    """With hallucination_silence_threshold both packages take the same
    re-seek decisions window by window, and emit the same segments."""
    records = {}
    for name, mod in (("jax", j_tr), ("torch", t_tr)):
        real = mod._hallucination_reseek
        calls = records.setdefault(name, [])

        def spy(segments, real=real, calls=calls, **kw):
            before = len(segments)
            out = real(segments, **kw)
            calls.append((kw["previous_seek"], kw["seek"], *out, before, len(segments)))
            return out

        monkeypatch.setattr(mod, "_hallucination_reseek", spy)
    ref, got = _both(pair, make_speechy_audio(40.0, seed=3), temperature=0.0,
                     word_timestamps=True, hallucination_silence_threshold=1.0,
                     condition_on_previous_text=False, no_speech_threshold=None,
                     sample_len=24, verbose=False)
    assert records["torch"] == records["jax"]
    assert len(records["torch"]) >= 2
    # random weights make every aligned word implausible: rule 3 cuts the
    # windows' segments and re-seeks just past them
    assert any(after < before for *_, before, after in records["torch"])
    assert any(new != old for _, old, new, *_ in records["torch"])
    assert [s["tokens"] for s in got["segments"]] == [s["tokens"] for s in ref["segments"]]


def _seg(mod, start, end, words):
    return mod.Segment(id=0, seek=0, start=start, end=end, text="x", tokens=[1],
                       temperature=0.0, avg_logprob=-0.1, compression_ratio=1.0,
                       no_speech_prob=0.0, words=words)


def _words(start, end, n=4, prob=0.9):
    step = (end - start) / n
    return [{"word": f" w{i}", "start": start + i * step, "end": start + (i + 1) * step,
             "probability": prob} for i in range(n)]


def _bad(start, end):
    return [dict(w, probability=0.01) for w in _words(start, end)]


# (segments as (start, end, words), reseek keywords): the JAX package's four
# cases (leading gap, mid-window, silent tail, near EOF) and two more
RESEEK_CASES = [
    ([(10.0, 12.0, _bad(10, 12))],
     dict(seek=3000, segment_size=3000, segment_duration=30.0, content_frames=6000,
          content_duration=60.0, single_timestamp_ending=True)),
    ([(0.5, 4.0, _words(0.5, 4.0)), (10.0, 11.0, _bad(10, 11))],
     dict(seek=3000, segment_size=3000, segment_duration=30.0, content_frames=20000,
          content_duration=200.0, single_timestamp_ending=True)),
    ([(0.0, 5.0, _words(0.0, 5.0))],
     dict(seek=3000, segment_size=3000, segment_duration=30.0, content_frames=20000,
          content_duration=200.0, single_timestamp_ending=False)),
    ([(0.0, 2.5, _words(0.0, 2.5)), (4.0, 5.0, _bad(4, 5))],
     dict(seek=550, segment_size=550, segment_duration=5.5, content_frames=550,
          content_duration=5.5, single_timestamp_ending=True)),
    ([(0.0, 28.5, _words(0.0, 28.5))],
     dict(seek=3000, segment_size=3000, segment_duration=30.0, content_frames=20000,
          content_duration=200.0, single_timestamp_ending=False)),
    ([(0.5, 1.0, _bad(0.5, 1.0)), (1.0, 9.0, _words(1.0, 9.0, n=8))],
     dict(seek=3000, segment_size=3000, segment_duration=30.0, content_frames=20000,
          content_duration=200.0, single_timestamp_ending=True)),
]


@pytest.mark.parametrize("case", range(len(RESEEK_CASES)))
def test_hallucination_reseek_cases_match_jax(case):
    specs, kw = RESEEK_CASES[case]
    out = []
    for mod in (t_tr, j_tr):
        segs = [_seg(mod, s, e, [dict(w) for w in words]) for s, e, words in specs]
        seek, drop = mod._hallucination_reseek(
            segs, previous_seek=0, time_offset=0.0, threshold=1.0,
            last_speech_timestamp=0.0, **kw)
        out.append((seek, drop, [s.to_dict() for s in segs]))
    assert out[0] == out[1]


def test_anomaly_helpers_match_jax():
    words = [_words(0, 2)[0], _bad(0, 0.05)[0], dict(_words(0, 3.5, n=1)[0]),
             {"word": " x", "start": 0.0, "end": 0.4}]
    for w in words:
        assert t_tr._word_anomaly_score(w) == j_tr._word_anomaly_score(w)
    for spec in ((0, 2, _words(0, 2)), (0, 2, _bad(0, 2)), (0, 1, []),
                 (0, 1, [{"word": " ,", "start": 0, "end": 0.01, "probability": 0.0}])):
        assert t_tr._is_segment_anomaly(_seg(t_tr, *spec)) == \
            j_tr._is_segment_anomaly(_seg(j_tr, *spec))
    assert not t_tr._is_segment_anomaly(None)
    segs = [_seg(t_tr, 0, 2, _words(0, 2)), _seg(t_tr, 2, 3, []), _seg(t_tr, 3, 4, None)]
    assert t_tr._get_end(segs) == 2.0 and t_tr._get_end([]) is None
    assert t_tr._next_words_segment(segs) is segs[0]


# -- the CLI ---------------------------------------------------------------------


@pytest.mark.parametrize("batch", ["False", "True"])
def test_cli_word_timestamps_match_jax(pair, same_dtw, tmp_path, monkeypatch, batch):
    """--word-timestamps True (and --batch-windows True) through both CLIs
    on the same weights: the JSON outputs carry the same words."""
    from tests.test_torch_transcribe import _write_wav

    jparams, jcfg, tparams, tcfg = pair
    wav = tmp_path / "in.wav"
    _write_wav(wav, make_speechy_audio(35.0, seed=1))
    monkeypatch.setattr(j_cli, "load_model", lambda m, d: (
        jparams, jcfg, j_tokenizer.make_synthetic_tokenizer()))
    monkeypatch.setattr(t_cli, "load_model", lambda m, d, dev: (
        tparams, tcfg, t_tokenizer.make_synthetic_tokenizer()))
    args = [str(wav), "-f", "json", "--condition-on-previous-text", "False",
            "--word-timestamps", "True", "--batch-windows", batch,
            "--temperature-increment-on-fallback", "None", "--no-speech-threshold", "None",
            "--verbose", "False"]
    assert j_cli.main(args + ["--output-name", "ref", "-o", str(tmp_path)]) == 0
    assert t_cli.main(args + ["--output-name", "got", "-o", str(tmp_path),
                              "--device", "cpu"]) == 0
    ref = json.loads((tmp_path / "ref.json").read_text())
    got = json.loads((tmp_path / "got.json").read_text())
    _assert_same_words(got, ref)
