"""Port parity over several ranks: gloo jobs of 2 and 4 processes on the CPU.

The counterpart of tests/test_parallel.py, tests/test_parallel_realshape.py,
tests/test_multihost.py and the mesh cases of tests/test_batcher.py and
tests/test_transcribe.py. Each job is started once a module by
``parallel/launch.py:run_ranks`` (tests/torch_parallel_ranks.py holds the
ranks' side, torch only) with a time limit, and every process is killed
when it ends; the JAX references run here. Checked:

- the bootstrap and every collective, over each axis of a dp 2 x tp 2 mesh
  and a tp 4 one (sums in fp32 whatever the dtype, uneven gathers);
- tiny whisper at dp 2, tp 2 and dp 2 x tp 2, fp32 and int8 KV caches,
  and beam 3 at dp 2 and tp 2: tokens equal to the JAX package's; at tp 4 with a vocabulary that does
  not divide over it, the logits within 2e-4 of JAX's;
- whisper at large-v3 width (2 layers, n_audio_ctx 256) at tp 2: tokens;
- Qwen at Qwen3-32B head geometry at tp 2, fp and int4, kv 0 and 8, and a
  tiny Qwen at tp 4 whose row-split int4 leaves stay whole: logits within
  2e-4 of JAX's;
- transcribe(mesh=) at dp 2 and tp 2, at T = 0 and with a T = 1.0 rung,
  and with word timestamps at tp 2: the segments and words of the meshless
  run;
- the batcher at dp 2 (rank 0's queue, rank 1 following): the requests'
  results of the meshless batcher;
- the daemon at WTPU_SERVE_DP=2 on the CPU (it starts its follower rank):
  /v1/transcribe answers as the batcher at dp 1 does.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import struct
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

import torch  # (torch before jax: the reverse order has deadlocked)
import jax
import jax.numpy as jnp

from tests.conftest import make_speechy_audio
from whisper_mlx_tpu.decoding.task import DecodingOptions as JOptions
from whisper_mlx_tpu.decoding.task import decode as j_decode
from whisper_mlx_tpu.decoding.tokenizer import make_synthetic_tokenizer as j_tok
from whisper_mlx_tpu.models import qwen as jqw
from whisper_mlx_tpu.models import whisper as jw
from whisper_mlx_tpu.ops import quant as jq
from whisper_mlx_tpu_torch.checkpoint.convert import params_from_jax, qwen_params_from_jax
from whisper_mlx_tpu_torch.decoding.task import DecodingOptions
from whisper_mlx_tpu_torch.decoding.tokenizer import make_synthetic_tokenizer
from whisper_mlx_tpu_torch.inference.transcribe import transcribe
from whisper_mlx_tpu_torch.models import qwen as tqw
from whisper_mlx_tpu_torch.models import whisper as tw
from whisper_mlx_tpu_torch.parallel.launch import free_port, run_ranks
from whisper_mlx_tpu_torch.runtime.batcher import TranscriptionBatcher

ROOT = Path(__file__).resolve().parents[1]
RANKS = "tests/torch_parallel_ranks.py"
TINY = dict(n_mels=80, n_audio_state=64, n_audio_head=4, n_audio_layer=2,
            n_text_state=64, n_text_head=4, n_text_layer=2)
QWEN_32B_HEADS = dict(vocab_size=2048, hidden_size=1024, intermediate_size=4096,
                      num_hidden_layers=2, num_attention_heads=64, num_key_value_heads=8,
                      head_dim=32, qk_norm=True, attention_bias=False,
                      tie_word_embeddings=False, rope_theta=1e6)
TOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    """Tiny whisper in both packages, 8 windows of mel, and JAX's tokens
    at fp32 and with int8 KV caches."""
    tok = j_tok()
    jcfg = jw.WhisperConfig(n_vocab=tok.n_vocab, **TINY)
    jparams = jw.init_params(jcfg, seed=0)
    tcfg = tw.WhisperConfig(n_vocab=tok.n_vocab, **TINY)
    tparams = params_from_jax(_np_tree(jparams), tcfg)
    mel = np.random.default_rng(7).standard_normal((8, 3000, 80)).astype(np.float32)
    ref = {}
    for kv in (0, 8):
        cfg = dataclasses.replace(jcfg, kv_bits=kv, self_kv_bits=kv)
        ref[kv] = [r.tokens for r in j_decode(jparams, jnp.asarray(mel), tok, cfg,
                                              JOptions(sample_len=16))]
    ref["beam"] = [r.tokens for r in j_decode(jparams, jnp.asarray(mel), tok, jcfg,
                                              JOptions(sample_len=8, beam_size=3))]
    return (tparams, tcfg, mel, DecodingOptions(sample_len=16)), ref


@pytest.fixture(scope="module")
def wide():
    """Whisper at large-v3 width, 2 layers, n_audio_ctx 256 (as
    tests/test_parallel_realshape.py runs it) and JAX's tokens."""
    tok = j_tok()
    dims = dict(n_mels=128, n_vocab=tok.n_vocab, n_audio_ctx=256, n_audio_state=1280,
                n_audio_head=20, n_audio_layer=2, n_text_state=1280, n_text_head=20,
                n_text_layer=2)
    jcfg, tcfg = jw.WhisperConfig(**dims), tw.WhisperConfig(**dims)
    jparams = jw.init_params(jcfg, seed=7)
    mel = (np.random.default_rng(5).standard_normal((2, 512, 128)) * 0.5).astype(np.float32)
    ref = [r.tokens for r in j_decode(jparams, jnp.asarray(mel), tok, jcfg,
                                      JOptions(sample_len=3))]
    return (params_from_jax(_np_tree(jparams), tcfg), tcfg, mel,
            DecodingOptions(sample_len=3)), ref


def _qwen_ref(jparams, jcfg, tokens):
    """JAX logits: prefill of tokens[:, :-1], then the step on the last."""
    cache = jqw.init_kv_cache(jcfg, 1, max_len=16)
    first, cache = jqw.decode_step(jparams, jnp.asarray(tokens[:, :-1]), jnp.int32(0),
                                   cache, jcfg)
    step, _ = jqw.decode_step(jparams, jnp.asarray(tokens[:, -1:]),
                              jnp.int32(tokens.shape[1] - 1), cache, jcfg)
    return [np.asarray(first, np.float32), np.asarray(step, np.float32)]


def _qwen_pairs(dims, seed, bits, kvs, tokens) -> dict:
    """kv -> ((port params, port config, tokens), JAX logits): one tree in
    both packages, its layers quantized to ``bits`` when given."""
    jparams = jqw.init_params(jqw.QwenConfig(**dims), seed=seed)
    if bits:
        layers = jq.quantize_params({"encoder": {"layers": jparams["layers"]}, "decoder": {}},
                                    bits=bits, group_size=64)["encoder"]["layers"]
        jparams = dict(jparams, layers=layers)
    tparams = qwen_params_from_jax(_np_tree(jparams), tqw.QwenConfig(**dims))
    return {kv: ((tparams, tqw.QwenConfig(kv_bits=kv, **dims), tokens),
                 _qwen_ref(jparams, jqw.QwenConfig(kv_bits=kv, **dims), tokens))
            for kv in kvs}


@pytest.fixture(scope="module")
def qwen():
    tokens = np.random.default_rng(2).integers(0, 2048, size=(1, 5)).astype(np.int64)
    cases, refs = {}, {}
    for bits in (0, 4):
        for kv, (case, ref) in _qwen_pairs(QWEN_32B_HEADS, 1, bits, (0, 8), tokens).items():
            key = f"{'int4' if bits else 'fp'}_kv{kv}"
            cases[key], refs[key] = case, ref
    return cases, refs


@pytest.fixture(scope="module")
def transcribe_case(tiny):
    """The batched transcribe over 4 windows: its arguments, and the
    meshless segments at the window batch each mesh uses (3 at tp 2, 3
    rounded up to 4 at dp 2), at T = 0 and with a T = 1.0 rung."""
    (tparams, tcfg, _, _), _ = tiny
    audio = make_speechy_audio(100.0, seed=3)
    kw = dict(batch_windows=True, window_batch_size=3, sample_len=8, logprob_threshold=0.0,
              no_speech_threshold=None, verbose=False)
    ref = {}
    for wbs in (3, 4):
        for temps in ((0.0,), (0.0, 1.0)):
            out = transcribe(audio, params=tparams, config=tcfg,
                             tokenizer=make_synthetic_tokenizer(), device="cpu",
                             temperature=temps, **dict(kw, window_batch_size=wbs))
            ref[wbs, len(temps)] = out["segments"]
    ref["words"] = transcribe(audio, params=tparams, config=tcfg,
                              tokenizer=make_synthetic_tokenizer(), device="cpu", temperature=0.0,
                              word_timestamps=True, **kw)["segments"]
    return (tparams, tcfg, audio, kw), ref


BATCHER_KW = dict(batch_size=3, max_wait_ms=3000.0, idle_gap_ms=1000.0)


@pytest.fixture(scope="module")
def batcher_case(tiny):
    import asyncio

    (tparams, tcfg, _, _), _ = tiny
    audios = [make_speechy_audio(35.0, seed=0), make_speechy_audio(5.0, seed=1)]
    kw = dict(BATCHER_KW, decoding=DecodingOptions(sample_len=8))
    ref_batcher = TranscriptionBatcher(tparams, tcfg, make_synthetic_tokenizer(),
                                       device="cpu", **dict(kw, batch_size=4))

    async def burst():
        res = await asyncio.gather(*(ref_batcher.transcribe(a) for a in audios))
        ref_batcher.shutdown()
        return res

    return (tparams, tcfg, audios, kw), asyncio.run(burst())


@pytest.fixture(scope="module")
def two(tiny, wide, qwen, transcribe_case, batcher_case):
    return run_ranks(f"{RANKS}:two_ranks", 2, dict(
        whisper_tiny=tiny[0], beam_opts=DecodingOptions(sample_len=8, beam_size=3),
        whisper_wide=wide[0], qwen_cases=qwen[0],
        transcribe_case=transcribe_case[0], batcher_case=batcher_case[0]), timeout_s=240)


@pytest.fixture(scope="module")
def four(tiny):
    """dp 2 x tp 2 and tp 4 jobs' inputs: tiny whisper, a tiny Qwen (8 heads
    over 4 KV heads, int4, hidden 64 and MLP 128: every row-split leaf's
    K / 4 is under the group of 64, so o and down stay whole) and tiny
    whisper with 1,867 vocabulary rows (no even split over 4)."""
    tokens = np.random.default_rng(3).integers(0, 256, size=(1, 4)).astype(np.int64)
    qdims = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                 num_attention_heads=8, num_key_value_heads=4, rope_theta=1e4,
                 tie_word_embeddings=True, attention_bias=True)
    qcase, qref = _qwen_pairs(qdims, 0, 4, (0,), tokens)[0]
    ucfg_j = jw.WhisperConfig(n_vocab=1867, **TINY)
    jparams = jw.init_params(ucfg_j, seed=2)
    ucfg = tw.WhisperConfig(n_vocab=1867, **TINY)
    mel = np.random.default_rng(4).standard_normal((2, 3000, 80)).astype(np.float32)
    toks = np.asarray([[1, 5, 1866, 933], [7, 1865, 2, 466]], np.int64)
    states = jw.encode(jparams, jnp.asarray(mel), ucfg_j)
    ulogits, _, _ = jw.decode_step(jparams, jnp.asarray(toks), jnp.int32(0),
                                   jw.init_kv_cache(ucfg_j, 2, max_len=8),
                                   jw.cross_kv(jparams, states, ucfg_j), ucfg_j)
    out = run_ranks(f"{RANKS}:four_ranks", 4, dict(
        whisper_tiny=tiny[0], qwen_tiny=qcase,
        whisper_uneven=(params_from_jax(_np_tree(jparams), ucfg), ucfg, mel, toks)),
        timeout_s=180)
    return out, qref, np.asarray(ulogits, np.float32)


# -- the bootstrap and the collectives ------------------------------------------


def test_two_process_bootstrap_and_sum(two):
    for r, out in enumerate(two):
        c = out["collectives"]
        assert c["rank"] == r and c["coords"] == (0, r)
        assert c["sum_tp"] == [3.0, 1.0] and c["sum_dp"] == [r + 1.0, 0.5]
        assert c["sum_dtype"] == "torch.bfloat16"
        assert c["gather_tp"] == [[0.0, 1.0]] and c["gather_uneven"] == [0, 1, 2, 10, 11]
        assert c["gather_dp"] == [r] and c["bcast"] == [0]
        assert c["objects_dp"] == [{"r": r}]


def test_four_process_mesh_axes(four):
    out, _, _ = four
    for r, o in enumerate(out):
        c = o["collectives"]
        d, t = divmod(r, 2)
        assert c["coords"] == (d, t)
        assert c["sum_tp"] == [float(2 * d + 1 + 2 * d + 2), 1.0]
        assert c["sum_dp"] == [float(t + 1 + t + 3), 1.0]
        assert c["gather_tp"] == [[2.0 * d, 2.0 * d + 1]]
        assert c["gather_dp"] == [t, t + 2] and c["bcast"] == [0]
        assert c["objects_dp"] == [{"r": t}, {"r": t + 2}]
        c4 = o["collectives_tp4"]
        assert c4["coords"] == (0, r) and c4["sum_tp"] == [10.0, 2.0]
        assert c4["gather_tp"] == [[0.0, 1.0, 2.0, 3.0]]
        assert c4["gather_uneven"] == [0, 1, 2, 10, 11, 12, 20, 21, 22, 30, 31]


# -- whisper -----------------------------------------------------------------------


@pytest.mark.parametrize("mesh", ["dp2", "tp2"])
@pytest.mark.parametrize("kv", [0, 8])
def test_whisper_sharded_decode_equals_jax(two, tiny, mesh, kv):
    _, ref = tiny
    for out in two:
        assert out[f"whisper_{mesh}_kv{kv}"] == ref[kv]


@pytest.mark.parametrize("mesh", ["dp2", "tp2"])
def test_whisper_sharded_beam_equals_jax(two, tiny, mesh):
    """Beam 3 over the flat fp cache (K8's plain version) on each rank's
    heads or windows: JAX's beam tokens."""
    _, ref = tiny
    for out in two:
        assert out[f"whisper_{mesh}_beam"] == ref["beam"]


def test_whisper_dp2_tp2_decode_equals_jax(four, tiny):
    out, _, _ = four
    for o in out:
        assert o["whisper_dp2_tp2"] == tiny[1][0]


def test_whisper_uneven_vocabulary_tp4(four):
    """1,867 rows over tp 4: ceil shares of 467, 467, 467 and 466 (JAX's
    device_put refuses the split; its unsharded logits are the reference)."""
    out, _, ref = four
    for o in out:
        np.testing.assert_allclose(o["whisper_uneven_tp4"], ref, atol=TOL, rtol=TOL)


def test_whisper_largev3_width_tp2(two, wide):
    for out in two:
        assert out["whisper_wide_tp2"] == wide[1]


# -- Qwen --------------------------------------------------------------------------


@pytest.mark.parametrize("key", ["fp_kv0", "fp_kv8", "int4_kv0", "int4_kv8"])
def test_qwen32b_heads_tp2_logits(two, qwen, key):
    for out in two:
        for got, want in zip(out[f"qwen_{key}"], qwen[1][key]):
            np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_qwen_tp4_whole_row_leaves(four):
    out, qref, _ = four
    for o in out:
        for got, want in zip(o["qwen_tp4"], qref):
            np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


# -- transcribe, the batcher and the daemon ----------------------------------------


def _assert_same_segments(got: list, want: list) -> None:
    """Texts, tokens, times and temperatures equal; the log-probabilities
    within the reduction order's rounding."""
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for key in ("id", "seek", "start", "end", "text", "tokens", "temperature"):
            assert g[key] == w[key], key
        np.testing.assert_allclose(g["avg_logprob"], w["avg_logprob"], atol=1e-4)
        np.testing.assert_allclose(g["no_speech_prob"], w["no_speech_prob"], atol=1e-5)


@pytest.mark.parametrize("mesh,wbs", [("dp2", 4), ("tp2", 3)])
@pytest.mark.parametrize("rungs", [1, 2])
def test_transcribe_mesh_equals_meshless(two, transcribe_case, mesh, wbs, rungs):
    """dp 2 rounds the window batch of 3 up to 4; the sampled rung draws the
    whole chunk's noise on each rank, so T = 1.0 matches too."""
    _, ref = transcribe_case
    want = ref[wbs, rungs]
    assert want and (rungs == 1 or any(s["temperature"] == 1.0 for s in want))
    for out in two:
        _assert_same_segments(out[f"transcribe_{mesh}_{rungs}"], want)


def test_transcribe_tp2_words_equal_meshless(two, transcribe_case):
    """The alignment pass under tp 2 gathers every rank's heads before the
    median filter: the words of the meshless run."""
    _, ref = transcribe_case
    assert any(s.get("words") for s in ref["words"])
    for out in two:
        got = out["transcribe_tp2_words"]
        _assert_same_segments(got, ref["words"])
        for g, w in zip(got, ref["words"]):
            assert [x["word"] for x in g["words"]] == [x["word"] for x in w["words"]]
            for gx, wx in zip(g["words"], w["words"]):
                assert abs(gx["start"] - wx["start"]) < 1e-6 and abs(gx["end"] - wx["end"]) < 1e-6


def test_batcher_dp2_equals_meshless(two, batcher_case):
    _, ref = batcher_case
    rank0, rank1 = two
    assert rank0["batcher_buckets"] == rank1["batcher_buckets"] == (4,)
    for got, want in zip(rank0["batcher"], ref, strict=True):
        assert got["text"] == want["text"]
        _assert_same_segments(got["segments"], want["segments"])
    assert rank0["batcher_stats"]["batches"] == rank1["batcher_followed"] == 2


def test_batcher_dp2_follower_failure_reaches_rank0(two, batcher_case):
    """A batch that raises on the follower fails its request on rank 0 (not
    a wait for the collective's timeout); both ranks go on to the next."""
    _, ref = batcher_case
    rank0, rank1 = two
    assert rank0["batcher_failed"] == ("RankFailure: the batch failed on rank 1: ValueError: "
                                       "a fault on the follower")
    assert rank0["batcher_again"]["text"] == ref[1]["text"]
    _assert_same_segments(rank0["batcher_again"]["segments"], ref[1]["segments"])


def _wav_bytes(audio: np.ndarray) -> bytes:
    data = (np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, 16_000, 32_000, 2, 16)
    return hdr + b"data" + struct.pack("<I", len(data)) + data


def test_daemon_serve_dp2_cpu(tmp_path):
    """WTPU_SERVE_DP=2 on the CPU: the daemon starts its follower rank, and
    /v1/transcribe answers as the dp 1 batcher on the same model does."""
    import asyncio

    from whisper_mlx_tpu.checkpoint.quant_loader import export_mlx_whisper
    from whisper_mlx_tpu_torch.audio.decode import load_audio_serving
    from whisper_mlx_tpu_torch.cli import load_model
    from whisper_mlx_tpu_torch.runtime.serving_config import apply_asr_serving_config

    tok = j_tok()
    jcfg = jw.WhisperConfig(n_vocab=tok.n_vocab, **TINY)
    export_mlx_whisper(jw.init_params(jcfg, seed=0), jcfg, tmp_path / "ckpt")
    wav = tmp_path / "speech.wav"
    wav.write_bytes(_wav_bytes(make_speechy_audio(40.0, seed=4)))

    params, config, ttok = load_model(str(tmp_path / "ckpt"), None, "cpu")
    params, config = apply_asr_serving_config(params, config, "cpu")
    ref_batcher = TranscriptionBatcher(params, config, ttok, device="cpu")

    async def one():
        res = await ref_batcher.transcribe(load_audio_serving(str(wav)))
        ref_batcher.shutdown()
        return res

    ref = asyncio.run(one())

    port = free_port()
    env = dict(os.environ, WTPU_SERVE_DP="2", QWEN_SESSIONS_DIR=str(tmp_path / "s"),
               QWEN_DATA_DIR=str(tmp_path / "d"), MIRROR_DATA_DIR=str(tmp_path / "m"),
               QWEN_HOME=str(tmp_path / "h"), CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    env.pop("QWEN_MODEL_PATH", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "whisper_mlx_tpu_torch.serving.server", "--device", "cpu",
         "--port", str(port), "--whisper-model", str(tmp_path / "ckpt")], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, start_new_session=True)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.time() + 90
        while True:
            try:
                with urllib.request.urlopen(base + "/health", timeout=2):
                    break
            except OSError:
                assert proc.poll() is None, proc.stdout.read().decode()[-3000:]
                assert time.time() < deadline, "the daemon never became healthy"
                time.sleep(0.3)
        req = urllib.request.Request(base + "/v1/transcribe", method="POST",
                                     data=json.dumps({"path": str(wav)}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            got = json.loads(r.read())
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)
        assert proc.returncode == 0, proc.stdout.read().decode()[-3000:]
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)  # the follower rank too, if left
        except ProcessLookupError:
            pass
        proc.wait()
    assert got["text"] == ref["text"]
    _assert_same_segments(got["segments"], ref["segments"])
