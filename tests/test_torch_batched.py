"""Port parity: transcribe(batch_windows=True) of whisper_mlx_tpu_torch against the JAX package on the CPU, tiny config.

The same numpy weights go through both packages. At temperature 0 the
batched mode must be token-identical to the JAX package's, with segment
times within 1e-6 s; the retry rungs decode only the pending windows,
gathered to power-of-two buckets capped at the batch.
"""

from __future__ import annotations

import numpy as np
import pytest

import torch  # (torch before jax: the reverse order has deadlocked)
import jax

from tests.conftest import make_speechy_audio
from whisper_mlx_tpu.decoding import tokenizer as j_tokenizer
from whisper_mlx_tpu.inference.transcribe import transcribe as j_transcribe
from whisper_mlx_tpu.models import whisper as jw
from whisper_mlx_tpu.ops import quant as jq
from whisper_mlx_tpu_torch.checkpoint.convert import params_from_jax
from whisper_mlx_tpu_torch.decoding import task as t_task
from whisper_mlx_tpu_torch.decoding import tokenizer as t_tokenizer
from whisper_mlx_tpu_torch.inference import transcribe as t_tr
from whisper_mlx_tpu_torch.models import whisper as tw
from whisper_mlx_tpu_torch.ops import quant as tq

DIMS = dict(n_mels=80, n_audio_state=64, n_audio_head=4, n_audio_layer=2,
            n_text_state=64, n_text_head=4, n_text_layer=2)


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


@pytest.fixture(autouse=True)
def fresh_policy_cache():
    tq._DENSE_DECODE_CACHE.clear()
    jq._DENSE_DECODE_CACHE.clear()
    yield
    tq._DENSE_DECODE_CACHE.clear()
    jq._DENSE_DECODE_CACHE.clear()


def _both(pair, audio, **kw):
    jparams, jcfg, tparams, tcfg = pair
    ref = j_transcribe(audio, params=jparams, config=jcfg,
                       tokenizer=j_tokenizer.make_synthetic_tokenizer(), **kw)
    got = t_tr.transcribe(audio, params=tparams, config=tcfg,
                          tokenizer=t_tokenizer.make_synthetic_tokenizer(), device="cpu", **kw)
    return ref, got


def _assert_same_segments(got, ref):
    assert got["text"] == ref["text"]
    assert got["language"] == ref["language"]
    assert len(got["segments"]) == len(ref["segments"]) > 0
    for g, r in zip(got["segments"], ref["segments"]):
        for key in ("id", "seek", "text", "tokens", "temperature"):
            assert g[key] == r[key], key
        assert abs(g["start"] - r["start"]) < 1e-6 and abs(g["end"] - r["end"]) < 1e-6
        np.testing.assert_allclose(g["avg_logprob"], r["avg_logprob"], atol=1e-4)
        np.testing.assert_allclose(g["no_speech_prob"], r["no_speech_prob"], atol=1e-5)


# 1, 2 and 3 windows; (65, 2) ends on a partial chunk of one window, (65, 4)
# pads its one chunk from 3 windows to 4
@pytest.mark.parametrize("seconds,batch", [(20.0, 2), (40.0, 2), (65.0, 2), (65.0, 4)])
def test_batched_matches_jax(pair, seconds, batch):
    ref, got = _both(pair, make_speechy_audio(seconds, seed=1), temperature=0.0,
                     batch_windows=True, window_batch_size=batch, sample_len=24,
                     no_speech_threshold=None, verbose=False)
    _assert_same_segments(got, ref)
    assert {s["seek"] for s in got["segments"]} <= {w * 3000 for w in range(3)}
    assert {"encode", "decode"} <= set(got["stages"])


def test_batched_with_no_speech_skip_matches_jax(pair):
    """The no-speech skip at assembly: a threshold between the windows'
    no-speech probabilities skips some windows and keeps the others, the
    same ones as the JAX package."""
    audio = make_speechy_audio(95.0, seed=2)
    kw = dict(temperature=0.0, batch_windows=True, window_batch_size=4, sample_len=16,
              verbose=False)
    ref, _ = _both(pair, audio, no_speech_threshold=None, **kw)
    by_window = {s["seek"]: s["no_speech_prob"] for s in ref["segments"]}
    probs = sorted(by_window.values())
    assert len(probs) >= 2 and probs[0] < probs[-1]
    threshold = (probs[0] + probs[-1]) / 2
    # every avg_logprob is below 0, so the threshold alone decides
    ref, got = _both(pair, audio, no_speech_threshold=threshold, logprob_threshold=0.0, **kw)
    _assert_same_segments(got, ref)
    kept = {s["seek"] for s in got["segments"]}
    assert kept == {w for w, p in by_window.items() if p <= threshold}
    assert 0 < len(kept) < len(by_window)


@pytest.mark.parametrize("failing,batches", [
    ({1}, [4, 1]),  # the JAX package's own case
    ({0, 2}, [4, 2]),
    ({0, 1, 3}, [4, 4]),  # three pending, gathered to four
])
def test_batched_ladder_redecodes_only_pending(pair, monkeypatch, failing, batches):
    """Rung 0 decodes the whole chunk; a retry rung decodes only the
    windows still pending, the gather padded to the next power of two
    (with the last pending window) and capped at the batch, and windows that
    passed keep their rung-0 results."""
    _, _, tparams, tcfg = pair
    calls: list[dict] = []
    real_decode = t_tr.decode

    def spy(params_, states, tokenizer_, config_, options, **kw):
        results = real_decode(params_, states, tokenizer_, config_, options, **kw)
        calls.append({"batch": states.shape[0], "t": options.temperature,
                      "fp": states[:, 0, :2].clone().numpy()})
        if options.temperature == 0.0 and states.shape[0] == 4:
            for i in failing:
                results[i].avg_logprob = -2e6  # forced onto the ladder
        return results

    monkeypatch.setattr(t_tr, "decode", spy)
    result = t_tr.transcribe(
        make_speechy_audio(95.0), params=tparams, config=tcfg,
        tokenizer=t_tokenizer.make_synthetic_tokenizer(), device="cpu",
        temperature=(0.0, 0.2), logprob_threshold=-1e6, compression_ratio_threshold=None,
        no_speech_threshold=None, batch_windows=True, window_batch_size=4, verbose=False)
    assert [c["batch"] for c in calls] == batches
    assert calls[1]["t"] == 0.2
    pending = sorted(failing)
    sel = (pending + [pending[-1]] * batches[1])[:batches[1]]
    np.testing.assert_array_equal(calls[1]["fp"], calls[0]["fp"][sel])
    temps = {seg["seek"] // 3000: seg["temperature"] for seg in result["segments"]}
    assert temps
    for w, t in temps.items():
        assert t == (0.2 if w in failing else 0.0)


def test_batched_retry_bucket_capped_at_batch(pair, monkeypatch):
    """Three pending windows of a 3-window batch gather to 3, not 4."""
    _, _, tparams, tcfg = pair
    sizes = []
    real_decode = t_tr.decode

    def spy(params_, states, tokenizer_, config_, options, **kw):
        results = real_decode(params_, states, tokenizer_, config_, options, **kw)
        sizes.append(states.shape[0])
        if options.temperature == 0.0:
            for r in results:
                r.avg_logprob = -2e6
        return results

    monkeypatch.setattr(t_tr, "decode", spy)
    t_tr.transcribe(make_speechy_audio(65.0), params=tparams, config=tcfg,
                    tokenizer=t_tokenizer.make_synthetic_tokenizer(), device="cpu",
                    temperature=(0.0, 0.5), logprob_threshold=-1e6, sample_len=8,
                    compression_ratio_threshold=None, no_speech_threshold=None,
                    batch_windows=True, window_batch_size=3, verbose=False)
    assert sizes == [3, 3]


def test_batched_quantized_matches_jax(pair):
    """Packed 4-bit params: the tree goes through the policy once before the
    encoder, as the JAX package's batched mode does."""
    jparams, jcfg, _, tcfg = pair
    jq_tree = jq.fuse_whisper_qkv(jq.quantize_params(jparams, bits=4, group_size=32))
    tparams = params_from_jax(jax.tree.map(np.asarray, jq_tree), tcfg)
    kw = dict(temperature=0.0, batch_windows=True, window_batch_size=2, sample_len=16,
              no_speech_threshold=None, verbose=False)
    audio = make_speechy_audio(40.0, seed=3)
    ref = j_transcribe(audio, params=jq_tree, config=jcfg,
                       tokenizer=j_tokenizer.make_synthetic_tokenizer(), **kw)
    got = t_tr.transcribe(audio, params=tparams, config=tcfg,
                          tokenizer=t_tokenizer.make_synthetic_tokenizer(), device="cpu", **kw)
    _assert_same_segments(got, ref)


@pytest.mark.parametrize("batch_windows", [True, False])
def test_mesh_raises_m14(pair, batch_windows):
    """``mesh=`` is ported (ROADMAP.md M14): a mesh of one rank, which needs
    no process group, gives the meshless result in both modes, the retry
    rung included (the ranks of wider meshes: tests/test_torch_parallel_mp.py)."""
    from whisper_mlx_tpu_torch.parallel.mesh import make_mesh

    _, _, tparams, tcfg = pair
    kw = dict(params=tparams, config=tcfg, device="cpu", temperature=(0.0, 1.0),
              batch_windows=batch_windows, window_batch_size=3, sample_len=8,
              no_speech_threshold=None, verbose=False)
    audio = make_speechy_audio(40.0, seed=3)
    ref = t_tr.transcribe(audio, tokenizer=t_tokenizer.make_synthetic_tokenizer(), **kw)
    got = t_tr.transcribe(audio, tokenizer=t_tokenizer.make_synthetic_tokenizer(),
                          mesh=make_mesh(dp=1, tp=1), **kw)
    assert got["segments"] == ref["segments"] and got["text"] == ref["text"]


def test_batched_equals_sequential_on_full_stride(pair, monkeypatch):
    """When every window decodes to a full-stride advance, the sequential
    seek loop and the fixed-stride batched mode see the same windows and
    emit the same segments (decode stubbed with a fixed token pattern
    ending in the full-window timestamp pair), as the JAX package's test
    holds."""
    _, _, tparams, tcfg = pair
    tok = t_tokenizer.make_synthetic_tokenizer()
    tsb = tok.timestamp_begin
    window_tokens = [tsb + 0, *tok.encode(" hello world"), tsb + 1500, tsb + 1500]

    def fake_decode(params_, states, tokenizer, config_, options, **kw):
        return [t_task.DecodingResult(
            tokens=list(window_tokens), text=" hello world", language="en",
            avg_logprob=-0.1, no_speech_prob=0.0, temperature=options.temperature,
            compression_ratio=1.0) for _ in range(states.shape[0])]

    monkeypatch.setattr(t_tr, "decode", fake_decode)
    common = dict(params=tparams, config=tcfg, tokenizer=tok, device="cpu", verbose=False,
                  temperature=0.0, compression_ratio_threshold=None, logprob_threshold=None,
                  no_speech_threshold=None, condition_on_previous_text=False, language="en")
    audio = make_speechy_audio(75.0)
    seq = t_tr.transcribe(audio, **common)
    bat = t_tr.transcribe(audio, batch_windows=True, **common)
    sa = [s for s in seq["segments"] if s["text"].strip()]
    sb = [s for s in bat["segments"] if s["text"].strip()]
    assert len(sa) == len(sb) >= 3
    for x, y in zip(sa, sb):
        assert x["text"] == y["text"]
        assert [t for t in x["tokens"] if t < tok.eot] == [t for t in y["tokens"] if t < tok.eot]
        assert abs(x["start"] - y["start"]) < 1e-6 and abs(x["end"] - y["end"]) < 1e-6


@pytest.mark.parametrize("temperatures", [(0.0, 0.2), (0.0, 0.5, 1.0), (0.4, 0.8)])
def test_batched_rungs_seed_their_generators(pair, monkeypatch, temperatures):
    """Each rung draws from a generator seeded with int(t * 1000), the
    port's counterpart of the JAX package's PRNGKey(int(t * 1000)), and a
    rung that fails every window hands all of them to the next."""
    _, _, tparams, tcfg = pair
    seeds = []
    real_decode = t_tr.decode

    def spy(params_, states, tokenizer_, config_, options, generator=None, **kw):
        seeds.append((options.temperature, generator.initial_seed()))
        results = real_decode(params_, states, tokenizer_, config_, options,
                              generator=generator, **kw)
        for r in results:
            r.avg_logprob = -2e6  # every rung fails
        return results

    monkeypatch.setattr(t_tr, "decode", spy)
    t_tr.transcribe(make_speechy_audio(20.0), params=tparams, config=tcfg,
                    tokenizer=t_tokenizer.make_synthetic_tokenizer(), device="cpu",
                    temperature=temperatures, logprob_threshold=-1e6, sample_len=4,
                    compression_ratio_threshold=None, no_speech_threshold=None,
                    batch_windows=True, window_batch_size=2, verbose=False)
    assert seeds == [(t, int(t * 1000)) for t in temperatures]
