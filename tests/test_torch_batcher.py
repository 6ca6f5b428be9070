"""Port parity: the cross-request TranscriptionBatcher and the serving
knobs of whisper_mlx_tpu_torch against the JAX package on the CPU.

Mirrors tests/test_batcher.py on the port (the mesh cases over several
ranks are in tests/test_torch_parallel_mp.py), and holds the port's batcher
token for token to the JAX package's on the same requests and to the
port's own batched transcribe.
"""

from __future__ import annotations

import asyncio
import time

import numpy as np
import pytest

import torch  # (torch before jax: the reverse order has deadlocked)
import jax

from tests.conftest import make_speechy_audio
from whisper_mlx_tpu.decoding import tokenizer as j_tokenizer
from whisper_mlx_tpu.decoding.task import DecodingOptions as JOptions
from whisper_mlx_tpu.models import whisper as jw
from whisper_mlx_tpu.ops import quant as jq
from whisper_mlx_tpu.runtime.batcher import TranscriptionBatcher as JBatcher
from whisper_mlx_tpu_torch.checkpoint.convert import params_from_jax
from whisper_mlx_tpu_torch.decoding import tokenizer as t_tokenizer
from whisper_mlx_tpu_torch.decoding.task import DecodingOptions
from whisper_mlx_tpu_torch.inference.transcribe import transcribe
from whisper_mlx_tpu_torch.models import whisper as tw
from whisper_mlx_tpu_torch.ops import quant as tq
from whisper_mlx_tpu_torch.runtime import serving_config as sc
from whisper_mlx_tpu_torch.runtime.batcher import TranscriptionBatcher

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


@pytest.fixture(scope="module")
def tiny(pair):
    _, _, tparams, tcfg = pair
    return tparams, tcfg, t_tokenizer.make_synthetic_tokenizer()


@pytest.fixture(autouse=True)
def fresh_policy_cache():
    tq._DENSE_DECODE_CACHE.clear()
    jq._DENSE_DECODE_CACHE.clear()
    yield
    tq._DENSE_DECODE_CACHE.clear()
    jq._DENSE_DECODE_CACHE.clear()


def _batcher(tiny, **kw):
    params, config, tok = tiny
    return TranscriptionBatcher(params, config, tok, device="cpu", **kw)


def _tokens(result):
    return [s["tokens"] for s in result["segments"]]


def test_concurrent_requests_share_batches(tiny):
    batcher = _batcher(tiny, batch_size=4, max_wait_ms=200,
                       decoding=DecodingOptions(sample_len=8))

    async def run():
        r_a, r_b = await asyncio.gather(
            batcher.transcribe(make_speechy_audio(seconds=65.0)),  # 3 windows
            batcher.transcribe(make_speechy_audio(seconds=20.0, seed=1)))  # 1 window
        batcher.shutdown()
        return r_a, r_b

    r_a, r_b = asyncio.run(run())
    assert set(r_a) >= {"text", "segments", "language"}
    seeks = sorted({s["seek"] for s in r_a["segments"]})
    assert seeks and seeks[0] == 0
    assert batcher.stats["windows"] == 4
    assert batcher.stats["batches"] <= 2


def test_batcher_tokens_equal_jax_batcher(pair):
    """The same three concurrent requests through the JAX package's batcher
    and the port's: token for token, text for text."""
    jparams, jcfg, tparams, tcfg = pair
    audios = [make_speechy_audio(65.0), make_speechy_audio(20.0, seed=1),
              make_speechy_audio(40.0, seed=2)]

    async def run(batcher):
        out = await asyncio.gather(*(batcher.transcribe(a) for a in audios))
        batcher.shutdown()
        return out, dict(batcher.stats)

    ref, ref_stats = asyncio.run(run(JBatcher(
        jparams, jcfg, j_tokenizer.make_synthetic_tokenizer(), batch_size=[2, 8],
        max_wait_ms=200, decoding=JOptions(sample_len=12))))
    got, got_stats = asyncio.run(run(TranscriptionBatcher(
        tparams, tcfg, t_tokenizer.make_synthetic_tokenizer(), device="cpu",
        batch_size=[2, 8], max_wait_ms=200, decoding=DecodingOptions(sample_len=12))))
    assert got_stats["windows"] == ref_stats["windows"] == 6
    for g, r in zip(got, ref):
        assert _tokens(g) == _tokens(r) and len(g["segments"]) > 0
        assert g["text"] == r["text"] and g["language"] == r["language"]
        for a, b in zip(g["segments"], r["segments"]):
            assert (a["id"], a["seek"]) == (b["id"], b["seek"])
            assert abs(a["start"] - b["start"]) < 1e-6 and abs(a["end"] - b["end"]) < 1e-6


def test_batcher_matches_batched_transcribe(tiny):
    params, config, tok = tiny
    audio = make_speechy_audio(seconds=40.0)
    batcher = _batcher(tiny, batch_size=2, max_wait_ms=10,
                       decoding=DecodingOptions(sample_len=8))

    async def run():
        r = await batcher.transcribe(audio)
        batcher.shutdown()
        return r

    via_batcher = asyncio.run(run())
    via_transcribe = transcribe(
        audio, params=params, config=config, tokenizer=tok, device="cpu",
        temperature=0.0, batch_windows=True, window_batch_size=2,
        sample_len=8, no_speech_threshold=None, verbose=False)
    assert _tokens(via_batcher) == _tokens(via_transcribe)
    assert len(via_batcher["segments"]) > 0


def test_stream_transcribe_progressive(tiny):
    batcher = _batcher(tiny, batch_size=2, max_wait_ms=10,
                       decoding=DecodingOptions(sample_len=8))
    audio = make_speechy_audio(seconds=65.0)  # 3 windows

    async def run():
        events = [ev async for ev in batcher.stream_transcribe(audio)]
        whole = await batcher.transcribe(audio)
        batcher.shutdown()
        return events, whole

    events, whole = asyncio.run(run())
    assert len(events) == 3
    assert [e["window"] for e in events] == [0, 1, 2]  # batches of 2 then 1, in order
    assert all(e["of"] == 3 for e in events)
    streamed = [s["tokens"] for e in events for s in e["segments"]]
    assert streamed == _tokens(whole)


def test_worker_failure_fails_waiters_and_recovers(tiny):
    batcher = _batcher(tiny, batch_size=2, max_wait_ms=10,
                       decoding=DecodingOptions(sample_len=8))
    real_launch = batcher._launch

    def boom(jobs):
        raise RuntimeError("device exploded")

    async def run():
        audio = make_speechy_audio(seconds=20.0)  # 1 window
        batcher._launch = boom
        with pytest.raises(RuntimeError, match="device exploded"):
            await asyncio.wait_for(batcher.transcribe(audio), timeout=30)
        with pytest.raises(RuntimeError, match="device exploded"):
            agen = batcher.stream_transcribe(audio)
            await asyncio.wait_for(agen.__anext__(), timeout=30)
        assert not batcher._requests  # no leaked request entries
        batcher._launch = real_launch  # the next request restarts the worker
        r = await asyncio.wait_for(batcher.transcribe(audio), timeout=60)
        batcher.shutdown()
        return r

    r = asyncio.run(run())
    assert set(r) >= {"text", "segments", "language"}


def test_batch_buckets_pick_smallest_fit(tiny):
    batcher = _batcher(tiny, batch_size=[4, 2], max_wait_ms=10,
                       decoding=DecodingOptions(sample_len=8))
    assert batcher.buckets == (2, 4) and batcher.batch_size == 4
    shapes = []
    real_launch = batcher._launch

    def spy(jobs):
        shapes.append(len(jobs))
        return real_launch(jobs)

    batcher._launch = spy

    async def run():
        r1 = await batcher.transcribe(make_speechy_audio(seconds=20.0))  # 1 window
        fill_after_1 = batcher.stats["fill_sum"]
        r2 = await batcher.transcribe(make_speechy_audio(seconds=65.0))  # 3 windows
        batcher.shutdown()
        return r1, r2, fill_after_1

    r1, r2, fill_after_1 = asyncio.run(run())
    assert r1["segments"] and r2["segments"]
    assert shapes == [1, 3]
    assert fill_after_1 == pytest.approx(1 / 2)  # bucket 2, not 4
    assert batcher.stats["fill_sum"] == pytest.approx(1 / 2 + 3 / 4)


def test_batcher_quantized_params(pair):
    """Packed 4-bit params: the batcher dequantizes once by the encoder's
    rows (bucket x 3000) and equals the batched transcribe on the same
    tree, and the JAX package's batcher."""
    jparams, jcfg, _, tcfg = pair
    jq_tree = jq.quantize_params(jparams, bits=4, group_size=32)
    qparams = params_from_jax(jax.tree.map(np.asarray, jq_tree), tcfg)
    tok = t_tokenizer.make_synthetic_tokenizer()
    audio = make_speechy_audio(seconds=65.0)

    async def run(batcher):
        r = await batcher.transcribe(audio)
        batcher.shutdown()
        return r

    got = asyncio.run(run(TranscriptionBatcher(
        qparams, tcfg, tok, device="cpu", batch_size=4, max_wait_ms=10,
        decoding=DecodingOptions(sample_len=8))))
    assert len(tq._DENSE_DECODE_CACHE) == 1  # one conversion
    want = transcribe(audio, params=qparams, config=tcfg, tokenizer=tok, device="cpu",
                      temperature=0.0, batch_windows=True, window_batch_size=4,
                      sample_len=8, condition_on_previous_text=False)
    ref = asyncio.run(run(JBatcher(
        jq_tree, jcfg, j_tokenizer.make_synthetic_tokenizer(), batch_size=4, max_wait_ms=10,
        decoding=JOptions(sample_len=8))))
    assert _tokens(got) == _tokens(want) == _tokens(ref)
    assert len(got["segments"]) > 0


def test_int16_audio_bit_identical(tiny):
    """int16 audio converted on the device (/2^15) gives the f32 path's
    mel bit for bit, and so the same tokens."""
    pcm = (np.clip(make_speechy_audio(seconds=40.0), -1, 1) * 32767).astype(np.int16)
    f32 = pcm.astype(np.float32) / 32768.0
    batcher = _batcher(tiny, batch_size=4, max_wait_ms=20,
                       decoding=DecodingOptions(sample_len=8))
    assert torch.equal(batcher._windows(pcm), batcher._windows(f32))

    async def run(audio):
        b = _batcher(tiny, batch_size=4, max_wait_ms=20, decoding=DecodingOptions(sample_len=8))
        r = await b.transcribe(audio)
        b.shutdown()
        return r

    r_i16, r_f32 = asyncio.run(run(pcm)), asyncio.run(run(f32))
    assert _tokens(r_i16) == _tokens(r_f32)
    assert r_i16["text"] == r_f32["text"]


def test_windows_equal_offline_mel(tiny):
    """The batcher's device-padded mel windows equal the offline batched
    mode's slices of the host-padded mel."""
    from whisper_mlx_tpu_torch.audio.mel import N_SAMPLES, log_mel_spectrogram

    audio = make_speechy_audio(seconds=65.0)
    batcher = _batcher(tiny)
    got = batcher._windows(audio)
    mel = log_mel_spectrogram(torch.from_numpy(np.concatenate(
        [audio, np.zeros(N_SAMPLES, np.float32)])), n_mels=80)
    assert got.shape == (3, 3000, 80)
    assert torch.equal(got, mel[:9000].reshape(3, 3000, 80))


def test_adaptive_flush_fills_while_device_busy(tiny, monkeypatch):
    """While a batch is in flight, arrivals staggered far past max_wait_ms
    coalesce into one full batch instead of four partial ones."""
    batcher = _batcher(tiny, batch_size=4, max_wait_ms=10, idle_gap_ms=5,
                       decoding=DecodingOptions(sample_len=4))
    real_launch = batcher._launch

    def slow_launch(jobs):
        time.sleep(0.4)
        return real_launch(jobs)

    monkeypatch.setattr(batcher, "_launch", slow_launch)

    async def run():
        first = asyncio.create_task(batcher.transcribe(make_speechy_audio(seconds=5.0)))
        await asyncio.sleep(0.05)  # batch 1 (1 window) is now in flight
        late = []
        for i in range(4):
            late.append(asyncio.create_task(
                batcher.transcribe(make_speechy_audio(seconds=5.0, seed=i))))
            await asyncio.sleep(0.06)  # staggered past max_wait_ms
        results = await asyncio.gather(first, *late)
        batcher.shutdown()
        return results

    results = asyncio.run(run())
    assert len(results) == 5
    assert batcher.stats["windows"] == 5
    assert batcher.stats["batches"] == 2, batcher.stats
    assert batcher.stats["fill_sum"] >= 0.25 + 1.0 - 1e-6, batcher.stats


def test_batcher_mesh_raises_m14(tiny):
    """``mesh=`` is ported (ROADMAP.md M14): a mesh of one rank, which needs
    no process group, answers as the meshless batcher does, and anything
    but a ``parallel.mesh.Mesh`` raises naming it. Several ranks: 
    tests/test_torch_parallel_mp.py."""
    from whisper_mlx_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(TypeError, match="Mesh"):
        _batcher(tiny, batch_size=4, mesh=object())
    audios = [make_speechy_audio(seconds=s, seed=i) for i, s in enumerate((35.0, 5.0))]

    async def burst(b):
        out = await asyncio.gather(*(b.transcribe(a) for a in audios))
        b.shutdown()
        return out

    opts = DecodingOptions(sample_len=8)
    ref = asyncio.run(burst(_batcher(tiny, batch_size=(2, 6), decoding=opts)))
    b = _batcher(tiny, batch_size=(2, 6), decoding=opts, mesh=make_mesh(dp=1, tp=1))
    assert b.buckets == (2, 6)
    assert asyncio.run(burst(b)) == ref


def test_batcher_defaults_read_serving_knobs(tiny, monkeypatch):
    """Without explicit values the batcher takes WTPU_TRANSCRIBE_BATCH,
    SERVE_WAIT_MS and SERVE_IDLE_GAP_MS; explicit values win."""
    monkeypatch.setenv("WTPU_TRANSCRIBE_BATCH", "4,2")
    monkeypatch.setenv("SERVE_WAIT_MS", "120")
    monkeypatch.setenv("SERVE_IDLE_GAP_MS", "7.5")
    b = _batcher(tiny)
    assert (b.buckets, b.batch_size, b.max_wait_ms, b.idle_gap_ms) == ((2, 4), 4, 120.0, 7.5)
    b = _batcher(tiny, batch_size=3, max_wait_ms=10, idle_gap_ms=5)
    assert (b.buckets, b.batch_size, b.max_wait_ms, b.idle_gap_ms) == ((3,), 3, 10, 5)


@pytest.mark.parametrize("value", ["2", "4"])
def test_batcher_serve_dp_raises_m14(tiny, monkeypatch, value):
    """WTPU_SERVE_DP is the daemon's knob (it starts the ranks and passes
    the mesh); a batcher built without ``mesh=`` serves on its one device
    whatever it says, and serving_mesh in a job of one rank refuses a
    width it cannot build."""
    monkeypatch.setenv("WTPU_SERVE_DP", value)
    monkeypatch.delenv("WTPU_TRANSCRIBE_BATCH", raising=False)
    b = _batcher(tiny)
    assert b.mesh is None and b.buckets == (8,)
    assert sc.serving_dp("cpu") == int(value)
    with pytest.raises(ValueError, match=f"dp\\*tp = {value}\\*1 != 1 devices"):
        sc.serving_mesh("cpu")


def test_batcher_cuda_without_gpu_raises(tiny, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params, config, tok = tiny
    with pytest.raises(RuntimeError, match="cuda"):
        TranscriptionBatcher(params, config, tok, device="cuda")


# -- runtime/serving_config.py ------------------------------------------------


@pytest.mark.parametrize("device,env,want", [
    ("cuda", None, (8, 16, 32, 56)),
    ("cpu", None, (8,)),
    ("cuda", "56,8", (8, 56)),
    ("cpu", "4", (4,)),
    ("cpu", " 2, 6,2 ", (2, 6)),
])
def test_serving_batch_buckets(monkeypatch, device, env, want):
    if env is None:
        monkeypatch.delenv("WTPU_TRANSCRIBE_BATCH", raising=False)
    else:
        monkeypatch.setenv("WTPU_TRANSCRIBE_BATCH", env)
    assert sc.serving_batch_buckets(device) == want


@pytest.mark.parametrize("value", ["x", "8,a", "0", ","])
def test_serving_batch_buckets_reject_bad_values(monkeypatch, value):
    monkeypatch.setenv("WTPU_TRANSCRIBE_BATCH", value)
    with pytest.raises(ValueError, match="WTPU_TRANSCRIBE_BATCH"):
        sc.serving_batch_buckets("cpu")


def test_serving_flush_knobs(monkeypatch):
    monkeypatch.delenv("SERVE_WAIT_MS", raising=False)
    monkeypatch.delenv("SERVE_IDLE_GAP_MS", raising=False)
    assert sc.serving_flush_knobs() == (50.0, 25.0)
    monkeypatch.setenv("SERVE_WAIT_MS", "120")
    monkeypatch.setenv("SERVE_IDLE_GAP_MS", "7.5")
    assert sc.serving_flush_knobs() == (120.0, 7.5)
    monkeypatch.setenv("SERVE_WAIT_MS", "soon")
    with pytest.raises(ValueError, match="SERVE_WAIT_MS"):
        sc.serving_flush_knobs()


@pytest.mark.parametrize("value", ["auto", "", "1", "0"])
def test_serving_mesh_one_card_is_none(monkeypatch, value):
    monkeypatch.setenv("WTPU_SERVE_DP", value)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert sc.serving_mesh("cpu") is None
    assert sc.serving_mesh("cuda") is None


@pytest.mark.parametrize("value,cards", [("2", 1), ("4", 4), ("auto", 4)])
def test_serving_mesh_wider_raises_m14(monkeypatch, value, cards):
    """On CUDA "auto" takes every card and an int pins the width; a width
    above the host's cards raises, as in the JAX package."""
    monkeypatch.setenv("WTPU_SERVE_DP", value)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    if int(value if value != "auto" else cards) > cards:
        with pytest.raises(ValueError, match="exceeds 1 local devices"):
            sc.serving_dp("cuda")
    else:
        assert sc.serving_dp("cuda") == 4


def test_dense_policy_cache_one_thread_at_a_time(pair, monkeypatch):
    """The batcher's worker threads share maybe_dense_decode_params' cache:
    16 threads asking for the same packed tree at once get one conversion,
    the same object each."""
    import sys
    import threading

    jparams, _, _, tcfg = pair
    qparams = params_from_jax(jax.tree.map(
        np.asarray, jq.quantize_params(jparams, bits=4, group_size=32)), tcfg)
    conversions = []
    real = tq.unfuse_whisper_qkv  # called once a conversion

    def counted(*a, **kw):
        conversions.append(1)
        time.sleep(0.01)  # widen the window a second caller could enter
        return real(*a, **kw)

    monkeypatch.setattr(tq, "unfuse_whisper_qkv", counted)
    out, errors = [], []

    def worker():
        try:
            out.append(tq.maybe_dense_decode_params(qparams, rows=3000, dtype=torch.float32))
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(out) == 16 and all(o is out[0] for o in out)
    assert len(conversions) == 1
