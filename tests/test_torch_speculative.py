"""Port parity: speculative decoding of whisper_mlx_tpu_torch (ROADMAP M11)
against the JAX package on the CPU, and against the port's own greedy loops.

Whisper: ``decoding/speculative.py:spec_decode_task`` on the same numpy
weights (JAX ``init_params`` converted by ``checkpoint/convert.py``) and the
same mel as the JAX function, under an identical draft (the upper bracket:
every proposal accepted), an independent 1-layer draft (the lower bracket)
and a perturbed one, timestamps on and off, fp and int8-self / int4-cross
caches, and cut short inside an accepted block: token-identical, with equal
``spec_stats``, and token-identical to the port's greedy ``decode``. Then
the n_ctx edge, ``transcribe(draft_params=...)``, the batched mode ignoring
the draft, and the CLI's ``--draft-model``.

LLM: a block of several tokens past position 0 with the port's flash on
(the verify, the draft sync) against JAX's grouped path and not its flash
branch; ``inference/speculative.py:speculative_generate`` against JAX's and
against greedy; ``LLMEngine(draft=...)`` packed and under the two residency
modes; ``QWEN_DRAFT_PATH``.

Tolerances: tokens exact; ``avg_logprob`` 1e-4 and ``no_speech_prob``
1e-5, as ``tests/test_torch_transcribe.py`` holds greedy; logits 1e-4 *
max(1, |ref|), as ``tests/test_torch_qwen.py`` holds decode_step.
"""

from __future__ import annotations

import dataclasses
import json
import math
import struct

import numpy as np
import pytest

import torch  # noqa: F401  (torch before jax, as in the other test files)
import jax
import jax.numpy as jnp

from tests.conftest import make_speechy_audio
from whisper_mlx_tpu.checkpoint import qwen_loader as j_loader
from whisper_mlx_tpu.decoding import speculative as j_spec
from whisper_mlx_tpu.decoding import task as j_task
from whisper_mlx_tpu.decoding import llm_tokenizer as j_tok
from whisper_mlx_tpu.decoding import tokenizer as j_tokenizer
from whisper_mlx_tpu.inference import speculative as j_lspec
from whisper_mlx_tpu.models import qwen as jqw
from whisper_mlx_tpu.models import whisper as jw
from whisper_mlx_tpu.ops import flash_attention as j_fa
from whisper_mlx_tpu.ops import quant as jq
from whisper_mlx_tpu.serving import chat as j_chat
from whisper_mlx_tpu_torch import cli as t_cli
from whisper_mlx_tpu_torch.checkpoint import qwen_loader as t_loader
from whisper_mlx_tpu_torch.checkpoint.convert import params_from_jax, qwen_params_from_jax
from whisper_mlx_tpu_torch.decoding import llm_tokenizer as t_tok
from whisper_mlx_tpu_torch.decoding import speculative as t_spec
from whisper_mlx_tpu_torch.decoding import task as t_task
from whisper_mlx_tpu_torch.decoding import tokenizer as t_tokenizer
from whisper_mlx_tpu_torch.inference import generate as tg
from whisper_mlx_tpu_torch.inference import speculative as t_lspec
from whisper_mlx_tpu_torch.inference import transcribe as t_tr
from whisper_mlx_tpu_torch.models import qwen as tqw
from whisper_mlx_tpu_torch.models import whisper as tw
from whisper_mlx_tpu_torch.serving import chat as t_chat

DIMS = dict(n_mels=80, n_audio_state=64, n_audio_head=4, n_audio_layer=2,
            n_text_state=64, n_text_head=4, n_text_layer=2)
K = 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Thousands of tiny torch ops: beside other test workers on the same
    cores, intra-op threads only contend. Restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# whisper
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def wsetup():
    """Target (2 decoder layers, seed 0) and its three drafts in both
    packages, and a 2-window mel (the reference test's)."""
    tok = j_tokenizer.make_synthetic_tokenizer()
    jcfg = jw.WhisperConfig(n_vocab=tok.n_vocab, **DIMS)
    jdcfg = dataclasses.replace(jcfg, n_text_layer=1)  # turbo-style: shallow
    jparams = jw.init_params(jcfg, seed=0)
    rng = np.random.default_rng(5)
    noisy = jax.tree.map(
        lambda a: np.asarray(a) + rng.standard_normal(a.shape).astype(np.float32) * 0.03,
        jparams)
    jdrafts = {"identical": (jparams, jcfg), "independent": (jw.init_params(jdcfg, seed=99), jdcfg),
               "perturbed": (jax.tree.map(jnp.asarray, noisy), jcfg)}
    tcfg = tw.WhisperConfig(n_vocab=tok.n_vocab, **DIMS)
    tdrafts = {}
    for name, (p, c) in jdrafts.items():
        dcfg = dataclasses.replace(tcfg, n_text_layer=c.n_text_layer)
        tdrafts[name] = (params_from_jax(jax.tree.map(np.asarray, p), dcfg), dcfg)
    mel = np.random.default_rng(0).standard_normal((2, 3000, 80)).astype(np.float32)
    return dict(jparams=jparams, jcfg=jcfg, jdrafts=jdrafts, tparams=tdrafts["identical"][0],
                tcfg=tcfg, tdrafts=tdrafts, mel=mel)


def _caches(cfg, caches: str):
    return cfg if caches == "fp" else dataclasses.replace(cfg, kv_bits=4, self_kv_bits=8)


def _spec_pair(w, draft: str, caches: str, k: int = K, **opts):
    """(JAX results, port results, port greedy results) on the same inputs."""
    jd, jdc = w["jdrafts"][draft]
    td, tdc = w["tdrafts"][draft]
    jcfg, jdc = _caches(w["jcfg"], caches), _caches(jdc, caches)
    tcfg, tdc = _caches(w["tcfg"], caches), _caches(tdc, caches)
    ref = j_spec.spec_decode_task(w["jparams"], jd, jnp.asarray(w["mel"]),
                                  j_tokenizer.make_synthetic_tokenizer(), jcfg, jdc,
                                  j_task.DecodingOptions(**opts), k=k)
    ttok = t_tokenizer.make_synthetic_tokenizer()
    mel = torch.from_numpy(w["mel"])
    got = t_spec.spec_decode_task(w["tparams"], td, mel, ttok, tcfg, tdc,
                                  t_task.DecodingOptions(**opts), k=k)
    greedy = t_task.decode(w["tparams"], mel, ttok, tcfg, t_task.DecodingOptions(**opts))
    return ref, got, greedy


def _assert_same(ref, got, greedy):
    assert len(got) == len(ref) == len(greedy) == 2
    for r, g, gr in zip(ref, got, greedy):
        assert len(r.tokens) > 0
        assert g.tokens == r.tokens == gr.tokens
        assert g.text == r.text
        assert g.spec_stats == r.spec_stats
        assert g.temperature == 0.0
        np.testing.assert_allclose(g.avg_logprob, r.avg_logprob, atol=1e-4)
        np.testing.assert_allclose(g.avg_logprob, gr.avg_logprob, atol=1e-4)
        np.testing.assert_allclose(g.no_speech_prob, r.no_speech_prob, atol=1e-5)


def _full_blocks(result, sample_len: int, k: int = K) -> bool:
    """Every verify but the last commits k + 1 tokens: the identical draft's
    acceptance is 1.0 (the 2-token sync keeps the draft cache whole)."""
    committed = min(len(result.tokens) + 1, sample_len)  # + EOT when it came
    return result.spec_stats["target_calls"] == math.ceil((committed - 1) / (k + 1))


@pytest.mark.parametrize("caches", ["fp", "kv4_self8"])
@pytest.mark.parametrize("without_timestamps", [False, True], ids=["ts", "nots"])
@pytest.mark.parametrize("draft", ["identical", "independent", "perturbed"])
def test_spec_decode_task_matches_jax(wsetup, draft, without_timestamps, caches):
    ref, got, greedy = _spec_pair(wsetup, draft, caches, sample_len=24,
                                  without_timestamps=without_timestamps)
    _assert_same(ref, got, greedy)
    stats = [g.spec_stats for g in got]
    assert all(0 <= s["accepted"] <= s["proposed"] for s in stats)
    if draft == "identical":
        assert all(_full_blocks(g, 24) for g in got), stats
        assert all(s["proposed"] - s["accepted"] < K for s in stats)
    if draft == "perturbed" and not without_timestamps:
        # partial acceptance, the realistic case (the reference's test holds
        # it with timestamps on; without them this draft's picks part at once)
        assert 0 < sum(s["accepted"] for s in stats) < sum(s["proposed"] for s in stats)


@pytest.mark.parametrize("sample_len", [3, 5, 7])
def test_spec_short_sample_len_cut(wsetup, sample_len):
    """max_len lands inside an accepted block: the committed tokens stop
    where sequential greedy stops."""
    ref, got, greedy = _spec_pair(wsetup, "identical", "fp", sample_len=sample_len)
    _assert_same(ref, got, greedy)
    assert all(len(g.tokens) <= sample_len for g in got)


@pytest.mark.parametrize("n_prompt", [219, 221])
def test_spec_n_ctx_edge(wsetup, n_prompt):
    """A long prompt and sample_len 224 bring max_len to n_text_ctx (448),
    and the identical draft's blocks of 5 leave s_len at 445 (219 prompt
    tokens) or 447 (221): the last block would run past 448. The port
    proposes 3 or 1 tokens there and stays the sequential greedy decode; the
    JAX function, whose dynamic_slice clamps such a block, is run on the
    same case beside its own greedy (ROADMAP.md, Queue 3)."""
    w = wsetup
    prompt = list(range(1, n_prompt + 1))
    opts = dict(sample_len=224, prompt=prompt, without_timestamps=True)
    ttok = t_tokenizer.make_synthetic_tokenizer()
    mel = torch.from_numpy(w["mel"][:1])
    init, _, sample_begin = t_task.build_initial_tokens(ttok, t_task.DecodingOptions(**opts),
                                                        448)
    assert len(init) + 224 >= 448 > len(init)
    got = t_spec.spec_decode_task(w["tparams"], w["tparams"], mel, ttok, w["tcfg"], w["tcfg"],
                                  t_task.DecodingOptions(**opts), k=K)[0]
    greedy = t_task.decode(w["tparams"], mel, ttok, w["tcfg"], t_task.DecodingOptions(**opts))[0]
    assert got.tokens == greedy.tokens
    np.testing.assert_allclose(got.avg_logprob, greedy.avg_logprob, atol=1e-4)
    assert sample_begin + len(got.tokens) == 448  # no EOT: the decode ran to the edge
    s_len = len(init) + 1
    while s_len + K + 1 < 448:  # full blocks of the identical draft
        s_len += K + 1
    assert s_len == (445 if n_prompt == 219 else 447)
    assert got.spec_stats["proposed"] == K * got.spec_stats["target_calls"] - (K - (448 - s_len))

    jtok = j_tokenizer.make_synthetic_tokenizer()
    jmel = jnp.asarray(w["mel"][:1])
    jref = j_spec.spec_decode_task(w["jparams"], w["jparams"], jmel, jtok, w["jcfg"], w["jcfg"],
                                   j_task.DecodingOptions(**opts), k=K)[0]
    jgreedy = j_task.decode(w["jparams"], jmel, jtok, w["jcfg"], j_task.DecodingOptions(**opts))[0]
    assert jgreedy.tokens == greedy.tokens
    # the JAX function at the edge: equal to its greedy on this case
    assert jref.tokens == jgreedy.tokens


def test_spec_decode_validates_inputs(wsetup):
    w = wsetup
    ttok = t_tokenizer.make_synthetic_tokenizer()
    mel = torch.from_numpy(w["mel"][:1])
    other = dataclasses.replace(w["tcfg"], n_vocab=w["tcfg"].n_vocab + 1)
    with pytest.raises(ValueError, match="vocabulary"):
        t_spec.spec_decode_task(w["tparams"], w["tparams"], mel, ttok, w["tcfg"], other,
                                t_task.DecodingOptions(sample_len=4))
    with pytest.raises(ValueError, match="k must be"):
        t_spec.spec_decode_task(w["tparams"], w["tparams"], mel, ttok, w["tcfg"], w["tcfg"],
                                t_task.DecodingOptions(sample_len=4), k=0)


def test_spec_draft_shares_encoder(wsetup, monkeypatch):
    """The draft takes the target's encoder states when the states are
    precomputed, or when the widths match and it has no encoder of its own;
    otherwise it encodes the mel itself."""
    w = wsetup
    ttok = t_tokenizer.make_synthetic_tokenizer()
    mel = torch.from_numpy(w["mel"][:1])
    draft, dcfg = w["tdrafts"]["independent"]
    calls = []
    real = t_spec.encode
    monkeypatch.setattr(t_spec, "encode", lambda p, m, c: calls.append(p) or real(p, m, c))
    opts = t_task.DecodingOptions(sample_len=6)
    with_encoder = t_spec.spec_decode_task(w["tparams"], draft, mel, ttok, w["tcfg"], dcfg, opts)
    assert [id(p) for p in calls] == [id(w["tparams"]), id(draft)]
    calls.clear()
    no_encoder = {"decoder": draft["decoder"]}
    shared = t_spec.spec_decode_task(w["tparams"], no_encoder, mel, ttok, w["tcfg"], dcfg, opts)
    assert [id(p) for p in calls] == [id(w["tparams"])]
    assert shared[0].tokens == with_encoder[0].tokens  # token-identical to greedy either way


def _write_wav(path, audio):
    pcm = (np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes()
    sr = 16000
    hdr = (b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVEfmt "
           + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16)
           + b"data" + struct.pack("<I", len(pcm)))
    path.write_bytes(hdr + pcm)


def test_transcribe_with_draft_matches_plain(wsetup, monkeypatch):
    """transcribe(draft_params=...): the T = 0 rung rides spec_decode_task
    and the transcript is the plain one; with a beam asked for, it does not."""
    w = wsetup
    audio = (np.random.default_rng(11).standard_normal(16000 * 45) * 0.05).astype(np.float32)
    kw = dict(params=w["tparams"], config=w["tcfg"], device="cpu", temperature=0.0,
              sample_len=24, verbose=False)
    ref = t_tr.transcribe(audio, tokenizer=t_tokenizer.make_synthetic_tokenizer(), **kw)
    calls = []
    real = t_tr.spec_decode_task
    monkeypatch.setattr(t_tr, "spec_decode_task",
                        lambda *a, **k: calls.append(k["k"]) or real(*a, **k))
    draft, dcfg = w["tdrafts"]["independent"]
    out = t_tr.transcribe(audio, tokenizer=t_tokenizer.make_synthetic_tokenizer(),
                          draft_params=draft, draft_config=dcfg, spec_k=3, **kw)
    assert calls and set(calls) == {3}
    assert out["text"] == ref["text"]
    assert [s["tokens"] for s in out["segments"]] == [s["tokens"] for s in ref["segments"]]
    assert [s["text"] for s in out["segments"]] == [s["text"] for s in ref["segments"]]
    calls.clear()
    t_tr.transcribe(audio[:16000 * 5], tokenizer=t_tokenizer.make_synthetic_tokenizer(),
                    draft_params=draft, draft_config=dcfg, beam_size=2,
                    **dict(kw, sample_len=4))
    assert calls == []


def test_batched_transcribe_ignores_draft(wsetup, monkeypatch):
    """batch_windows=True decodes without the draft, as the reference does."""
    w = wsetup
    audio = make_speechy_audio(35.0, seed=3)
    kw = dict(params=w["tparams"], config=w["tcfg"], device="cpu", temperature=0.0,
              sample_len=12, verbose=False, batch_windows=True, window_batch_size=2)
    ref = t_tr.transcribe(audio, tokenizer=t_tokenizer.make_synthetic_tokenizer(), **kw)

    def refuse(*a, **k):
        raise AssertionError("the batched mode ran the draft")

    monkeypatch.setattr(t_tr, "spec_decode_task", refuse)
    out = t_tr.transcribe(audio, tokenizer=t_tokenizer.make_synthetic_tokenizer(),
                          draft_params=w["tdrafts"]["independent"][0],
                          draft_config=w["tdrafts"]["independent"][1], **kw)
    assert out["text"] == ref["text"]
    assert [s["tokens"] for s in out["segments"]] == [s["tokens"] for s in ref["segments"]]


def test_cli_draft_model(tmp_path, monkeypatch):
    """--draft-model test-tiny (the target itself) and --spec-k 2: the T = 0
    rung runs spec_decode_task and the text is the plain CLI's."""
    wav = tmp_path / "a.wav"
    _write_wav(wav, make_speechy_audio(8.0, seed=4))
    args = [str(wav), "-f", "json", "-o", str(tmp_path), "--model", "test-tiny",
            "--device", "cpu", "--verbose", "False", "--condition-on-previous-text", "False",
            "--temperature-increment-on-fallback", "None"]
    assert t_cli.main(args + ["--output-name", "plain"]) == 0
    calls = []
    real = t_tr.spec_decode_task
    monkeypatch.setattr(t_tr, "spec_decode_task",
                        lambda *a, **k: calls.append((a[4], k["k"])) or real(*a, **k))
    assert t_cli.main(args + ["--output-name", "spec", "--draft-model", "test-tiny",
                              "--spec-k", "2"]) == 0
    assert calls and all(k == 2 for _, k in calls)
    assert calls[0][0].n_text_layer == 2  # the draft's config
    plain, spec = (json.loads((tmp_path / f"{n}.json").read_text()) for n in ("plain", "spec"))
    assert spec["text"] == plain["text"]
    assert len(spec["segments"]) == len(plain["segments"]) > 0
    for a, b in zip(spec["segments"], plain["segments"]):
        np.testing.assert_allclose(a.pop("avg_logprob"), b.pop("avg_logprob"), atol=1e-4)
        assert a == b


# ---------------------------------------------------------------------------
# the Qwen LLM
# ---------------------------------------------------------------------------

QDIMS = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, rope_theta=10_000.0,
             tie_word_embeddings=True, attention_bias=True)
QDRAFT = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=1,
              num_attention_heads=2, num_key_value_heads=1, rope_theta=10_000.0,
              tie_word_embeddings=True, attention_bias=True)


def _jax_interp_flash(q, k, v, **kw):
    return _ORIG_FLASH(q, k, v, **{**kw, "interpret": True, "tile_q": 8, "tile_k": 128})


_ORIG_FLASH = j_fa.flash_attention


@pytest.mark.parametrize("qk_norm", [False, True], ids=["qwen2", "qwen3"])
def test_verify_block_past_zero_matches_jax_grouped_not_flash(monkeypatch, qk_norm):
    """A 5-token block at position 9 with the port's flash on (the verify of
    k = 4) gives JAX's grouped path over the cache (flash off) and not JAX's
    flash branch, which attends within the block only: ROADMAP.md records
    that branch under Queue 3."""
    dims = dict(QDIMS, qk_norm=qk_norm, head_dim=32 if qk_norm else None,
                attention_bias=not qk_norm, tie_word_embeddings=not qk_norm)
    jcfg = jqw.QwenConfig(vocab_size=256, **dims)
    tree = jax.tree.map(np.asarray, jqw.init_params(jcfg, seed=3))
    jparams = jax.tree.map(jnp.asarray, tree)
    tcfg = dataclasses.replace(tqw.QwenConfig(vocab_size=256, **dims), flash_attention=True)
    tparams = qwen_params_from_jax(tree, tcfg)
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, 256, (1, 9)).astype(np.int32)
    block = rng.integers(0, 256, (1, 5)).astype(np.int32)

    tcache = tqw.init_kv_cache(tcfg, 1, 32)
    tqw.decode_step(tparams, torch.from_numpy(prompt).long(), 0, tcache, tcfg)
    got, _ = tqw.decode_step(tparams, torch.from_numpy(block).long(), 9, tcache, tcfg)
    outs = {}
    monkeypatch.setattr(j_fa, "flash_attention", _jax_interp_flash)
    for flash in (False, True):
        jc = dataclasses.replace(jcfg, flash_attention=flash)
        cache = jqw.init_kv_cache(jc, 1, 32)
        _, cache = jqw.decode_step(jparams, jnp.asarray(prompt), jnp.int32(0), cache, jc)
        outs[flash], _ = jqw.decode_step(jparams, jnp.asarray(block), jnp.int32(9), cache, jc)
    ref = np.asarray(outs[False])
    tol = 1e-4 * max(1.0, np.abs(ref).max())
    np.testing.assert_allclose(got.numpy(), ref, atol=tol, rtol=0)
    assert np.abs(got.numpy() - np.asarray(outs[True])).max() > 100 * tol


@pytest.fixture(scope="module")
def qmodels():
    tc = jqw.QwenConfig(vocab_size=256, **QDIMS)
    dc = jqw.QwenConfig(vocab_size=256, **QDRAFT)
    jt, jd = jqw.init_params(tc, seed=0), jqw.init_params(dc, seed=99)
    ttc, tdc = tqw.QwenConfig(vocab_size=256, **QDIMS), tqw.QwenConfig(vocab_size=256, **QDRAFT)
    return dict(jt=jt, tc=tc, jd=jd, dc=dc, tt=tqw.init_params(ttc, seed=0), ttc=ttc,
                td=tqw.init_params(tdc, seed=99), tdc=tdc)


def _greedy(params, config, prompt, max_tokens, stop_ids, max_len=256):
    """The port's vanilla greedy loop: prefill, then one token a step."""
    cache = tqw.init_kv_cache(config, 1, max_len)
    logits, cache = tqw.decode_step(params, torch.tensor([prompt]), 0, cache, config)
    pos, tok, out = len(prompt), int(torch.argmax(logits[0, -1])), []
    while len(out) < max_tokens:
        out.append(tok)
        if tok in stop_ids:
            break
        logits, cache = tqw.decode_step(params, torch.tensor([[tok]]), pos, cache, config)
        pos += 1
        tok = int(torch.argmax(logits[0, -1]))
    return out


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("seed", [0, 1])
def test_speculative_generate_matches_jax_and_greedy(qmodels, k, seed):
    m = qmodels
    prompt = np.random.default_rng(seed).integers(0, 256, size=8).tolist()
    stop_ids = {7}
    ref, rstats = j_lspec.speculative_generate(m["jt"], m["tc"], m["jd"], m["dc"], prompt,
                                               max_tokens=24, stop_ids=stop_ids, k=k,
                                               max_len=256)
    got, stats = t_lspec.speculative_generate(m["tt"], m["ttc"], m["td"], m["tdc"], prompt,
                                              max_tokens=24, stop_ids=stop_ids, k=k,
                                              max_len=256)
    assert got == ref == _greedy(m["tt"], m["ttc"], prompt, 24, stop_ids)
    assert dataclasses.asdict(stats) == dataclasses.asdict(rstats)
    assert stats.proposed >= stats.accepted >= 0 and stats.target_calls >= 1


def test_speculative_self_draft_accepts_everything(qmodels):
    m = qmodels
    prompt = [3, 50, 120]
    got, stats = t_lspec.speculative_generate(m["tt"], m["ttc"], m["tt"], m["ttc"], prompt,
                                              max_tokens=20, stop_ids=set(), k=4, max_len=256)
    assert got == _greedy(m["tt"], m["ttc"], prompt, 20, set())
    assert stats.acceptance_rate == 1.0
    # 20 tokens at k = 4: the prefill and 4 verifies instead of 20 steps
    assert stats.target_calls == 5 and stats.accepted == stats.proposed


def _packed_tree(cfg, seed):
    """Random init with 4-bit layers and a 4-bit tied embedding."""
    params = jax.tree.map(np.asarray, jqw.init_params(cfg, seed=seed))
    layers = jq.quantize_params({"encoder": {"layers": params["layers"]}, "decoder": {}},
                                bits=4, group_size=64)["encoder"]["layers"]
    w_q, s, b = jq.quantize(params["embed"], 4, 64)
    embed = jq.QuantTensor(jnp.asarray(w_q), jnp.asarray(s), jnp.asarray(b), 4, 64)
    return jax.tree.map(np.asarray, dict(params, layers=layers, embed=embed))


def _leaf_type(params):
    return type(params["layers"][0]["mlp"]["down"]["w"]).__name__


@pytest.mark.parametrize("env,leaf", [(None, "QuantTensor"),
                                      ("WTPU_MBT_RESIDENT", "QuantTensorT"),
                                      ("WTPU_QWEN_A8", "A8Tensor")],
                         ids=["packed", "mbt", "a8"])
def test_engine_with_draft_matches_plain_engine(monkeypatch, env, leaf):
    """LLMEngine(draft=...) on packed 4-bit weights: the draft is converted
    as the target is, generate at T = 0 runs speculative_generate and gives
    the plain engine's tokens; sampling and the stream use the target alone."""
    tok = j_tok.ByteFallbackTokenizer()
    dims = dict(QDRAFT, hidden_size=64, intermediate_size=128)  # group 64 divides 64
    tcfg = tqw.QwenConfig(vocab_size=tok.vocab_size, **QDIMS)
    dcfg = tqw.QwenConfig(vocab_size=tok.vocab_size, **dims)
    target = qwen_params_from_jax(_packed_tree(jqw.QwenConfig(vocab_size=tok.vocab_size,
                                                              **QDIMS), 0), tcfg)
    draft = qwen_params_from_jax(_packed_tree(jqw.QwenConfig(vocab_size=tok.vocab_size,
                                                             **dims), 7), dcfg)
    if env:
        monkeypatch.setenv(env, "1")
    plain = tg.LLMEngine(target, tcfg, t_tok.ByteFallbackTokenizer(), max_context=192)
    spec = tg.LLMEngine(target, tcfg, t_tok.ByteFallbackTokenizer(), max_context=192,
                        draft=(draft, dcfg))
    assert _leaf_type(spec.params) == _leaf_type(spec.draft[0]) == leaf
    assert spec.draft[1] is dcfg
    calls = []
    real = t_lspec.speculative_generate
    monkeypatch.setattr(t_lspec, "speculative_generate",
                        lambda *a, **kw: calls.append(a[3]) or real(*a, **kw))
    for text, n in (("hello", 12), ("The quick brown fox", 30)):
        want = plain.generate(text, max_tokens=n, temperature=0.0)
        got = spec.generate(text, max_tokens=n, temperature=0.0)
        assert got.tokens == want.tokens and got.text == want.text
    assert calls == [dcfg, dcfg]
    assert spec.chat([{"role": "user", "content": "hi"}], max_tokens=8,
                     temperature=0.0).tokens == plain.chat(
        [{"role": "user", "content": "hi"}], max_tokens=8, temperature=0.0).tokens
    assert len(calls) == 3
    spec.generate("hello", max_tokens=6, temperature=0.7, seed=1)
    list(spec.stream_generate("hello", max_tokens=6, temperature=0.0))
    assert len(calls) == 3


def test_engine_with_draft_matches_jax_engine(qmodels):
    """The port's engine with a draft against the JAX engine with the same
    draft, fp32 weights: the same tokens and text."""
    tok = j_tok.ByteFallbackTokenizer()
    jtc = jqw.QwenConfig(vocab_size=tok.vocab_size, **QDIMS)
    jdc = jqw.QwenConfig(vocab_size=tok.vocab_size, **QDRAFT)
    jt, jd = jqw.init_params(jtc, seed=0), jqw.init_params(jdc, seed=99)
    tt = qwen_params_from_jax(jax.tree.map(np.asarray, jt),
                              tqw.QwenConfig(vocab_size=tok.vocab_size, **QDIMS))
    tdc = tqw.QwenConfig(vocab_size=tok.vocab_size, **QDRAFT)
    td = qwen_params_from_jax(jax.tree.map(np.asarray, jd), tdc)
    jeng = j_gen_engine(jt, jtc, tok, draft=(jd, jdc))
    teng = tg.LLMEngine(tt, tqw.QwenConfig(vocab_size=tok.vocab_size, **QDIMS),
                        t_tok.ByteFallbackTokenizer(), max_context=192, draft=(td, tdc))
    for text, n in (("hello", 10), ("<|im_start|>user\nnaïve café?<|im_end|>\n", 24)):
        ref = jeng.generate(text, max_tokens=n, temperature=0.0)
        got = teng.generate(text, max_tokens=n, temperature=0.0)
        assert got.tokens == ref.tokens and got.text == ref.text


def j_gen_engine(params, config, tok, draft):
    from whisper_mlx_tpu.inference.generate import LLMEngine

    return LLMEngine(params, config, tok, max_context=192, draft=draft)


def test_qwen_draft_path_loads_the_draft(tmp_path, monkeypatch):
    """QWEN_DRAFT_PATH with QWEN_MODEL_PATH: the port's QwenModel loads the
    draft with its own load_qwen (a tiny mlx-format 4-bit checkpoint written
    here), and chat at T = 0 gives the model without a draft and the JAX
    model with the same draft."""
    from tests.test_torch_qwen import _write_mlx_checkpoint

    target = _write_mlx_checkpoint(tmp_path / "target", "qwen3")
    draft = _write_mlx_checkpoint(tmp_path / "draft", "qwen2")
    monkeypatch.delenv("QWEN_BATCH_SLOTS", raising=False)
    monkeypatch.delenv("QWEN_SCRIPTED_MODEL", raising=False)
    msgs = [{"role": "user", "content": "hi there"}]
    plain = t_chat.QwenModel(model_path=str(target), device="cpu")
    want = plain.generate(msgs, max_tokens=12, temperature=0.0)
    assert plain.engine.draft is None
    monkeypatch.setenv("QWEN_DRAFT_PATH", str(draft))
    model = t_chat.QwenModel(model_path=str(target), device="cpu")
    assert model.engine.draft is not None
    dparams, dcfg = model.engine.draft
    assert dcfg == t_loader.load_qwen(draft)[1]
    assert dcfg.num_hidden_layers == 2 and not dcfg.qk_norm
    assert model.generate(msgs, max_tokens=12, temperature=0.0) == want
    ref = j_chat.QwenModel(model_path=str(target)).generate(msgs, max_tokens=12,
                                                            temperature=0.0)
    assert want == ref
    assert j_loader.load_qwen(draft)[1].num_hidden_layers == dcfg.num_hidden_layers
    # without a model path the tiny default model serves, and the draft is
    # not loaded, as in the reference
    monkeypatch.delenv("QWEN_MODEL_PATH", raising=False)
    assert t_chat.QwenModel(device="cpu").engine.draft is None
