"""Port parity: beam search of whisper_mlx_tpu_torch against the JAX package
on the CPU, on test_beam.py's tiny model (64 wide, 2+2 layers, synthetic
tokenizer, seed 3) with the same numpy weights and mel in both packages.

``beam_decode`` is held token for token (tokens, lengths, fin_count, scores
within rtol 2e-5) against JAX's ``beam_decode`` for every port scheme
(flat, perm, permg, permp, permi), fp and quantized self caches, the
integer-dot mode off and on. A copy of the model whose EOT embedding row is
scaled up finishes hypotheses within the horizon, so the finished pool and
the backfill are both exercised. A host-side reference beam over the port's
own ``decode_step`` pins the selection semantics, zero-weight ties included.
"""

from __future__ import annotations

import copy
import dataclasses
import struct

import numpy as np
import pytest

import torch  # noqa: F401  (torch before jax: see CLAUDE.md)
import jax
import jax.numpy as jnp

from tests.conftest import make_speechy_audio
from whisper_mlx_tpu.decoding import beam as jb
from whisper_mlx_tpu.decoding import task as jt
from whisper_mlx_tpu.decoding.filters import FilterConfig as JFilter
from whisper_mlx_tpu.decoding.filters import make_suppress_mask
from whisper_mlx_tpu.decoding.tokenizer import make_synthetic_tokenizer as j_tokenizer
from whisper_mlx_tpu.inference.transcribe import transcribe as j_transcribe
from whisper_mlx_tpu.models import whisper as jw
from whisper_mlx_tpu_torch import cli as t_cli
from whisper_mlx_tpu_torch.checkpoint.convert import params_from_jax
from whisper_mlx_tpu_torch.decoding import beam as tb
from whisper_mlx_tpu_torch.decoding import task as tt
from whisper_mlx_tpu_torch.decoding.filters import FilterConfig as TFilter
from whisper_mlx_tpu_torch.decoding.filters import apply_filters
from whisper_mlx_tpu_torch.decoding.tokenizer import make_synthetic_tokenizer as t_tokenizer
from whisper_mlx_tpu_torch.inference.transcribe import transcribe as t_transcribe
from whisper_mlx_tpu_torch.models import whisper as tw

DIMS = dict(n_mels=80, n_audio_state=64, n_audio_head=4, n_audio_layer=2,
            n_text_state=64, n_text_head=4, n_text_layer=2)
SAMPLE_LEN = 24
# (kv_bits, self_kv_bits, attn_mxu): fp caches, an int8 self cache, and the
# beam default over quantized caches (integer dots, int4 cross) with int8
# and int4 self caches
CONFIGS = [(0, 0, False), (0, 8, False), (4, 8, True), (4, 4, True), (8, 8, False)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tests run thousands of tiny torch ops; beside other test
    workers on the same cores, intra-op threads only contend. Restored
    after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny():
    tok = j_tokenizer()
    jcfg = jw.WhisperConfig(n_vocab=tok.n_vocab, **DIMS)
    tcfg = tw.WhisperConfig(n_vocab=tok.n_vocab, **DIMS)
    base = jax.tree.map(np.asarray, jw.init_params(jcfg, seed=3))
    models = {}
    for gain in (1.0, 3.0, 6.0, 10.0):
        tree = copy.deepcopy(base)
        tree["decoder"]["token_emb"][tok.eot] *= gain
        models[gain] = (jax.tree.map(jnp.asarray, tree), params_from_jax(tree, tcfg))
    mel = np.random.default_rng(11).standard_normal((2, 3000, 80)).astype(np.float32)
    return dict(tok=tok, jcfg=jcfg, tcfg=tcfg, models=models, mel=mel, refs={}, states={})


def _inputs(tok, beam_size, timestamp_rules=False):
    opts = jt.DecodingOptions(sample_len=SAMPLE_LEN, beam_size=beam_size)
    init, sot_index, sample_begin = jt.build_initial_tokens(tok, opts, 448)
    suppress = jt._resolve_suppress(opts, tok)
    always, begin = make_suppress_mask(tok.n_vocab, suppress, tuple(tok.encode(" ")) + (tok.eot,))
    fc = dict(eot=tok.eot, no_timestamps=tok.no_timestamps, timestamp_begin=tok.timestamp_begin,
              sample_begin=sample_begin, max_initial_timestamp_index=50 if timestamp_rules else None,
              apply_timestamp_rules=timestamp_rules)
    return init, sot_index, always, begin, fc


def _run_pair(tiny, gain, kv, self_kv, mxu, patience=1.0, scheme="flat", beam_size=3):
    """(JAX beam_decode result, port beam_decode result) on the same model
    and encoder states; JAX's is computed once per configuration."""
    tok = tiny["tok"]
    jparams, tparams = tiny["models"][gain]
    jcfg = dataclasses.replace(tiny["jcfg"], kv_bits=kv, self_kv_bits=self_kv, attn_mxu=mxu)
    tcfg = dataclasses.replace(tiny["tcfg"], kv_bits=kv, self_kv_bits=self_kv, attn_mxu=mxu)
    init, sot_index, always, begin, fc = _inputs(tok, beam_size)
    pool = max(round(beam_size * patience), 1)
    key = (gain, kv, self_kv, mxu, pool, beam_size)
    if gain not in tiny["states"]:  # the encoder reads no cache setting
        tiny["states"][gain] = jw.encode(jparams, jnp.asarray(tiny["mel"]), jcfg)
    states = tiny["states"][gain]
    if key not in tiny["refs"]:
        tiny["refs"][key] = jb.beam_decode(
            jparams, states, jnp.tile(jnp.asarray(init, jnp.int32)[None], (2, 1)),
            jnp.asarray(always), jnp.asarray(begin), config=jcfg, filter_cfg=JFilter(**fc),
            sample_len=SAMPLE_LEN, sot_index=sot_index, no_speech_token=tok.no_speech,
            beam_size=beam_size, pool_size=pool)
    got = tb.beam_decode(
        tparams, torch.from_numpy(np.array(states)), torch.tensor([init] * 2),
        torch.from_numpy(always), torch.from_numpy(begin), config=tcfg,
        filter_cfg=TFilter(**fc), sample_len=SAMPLE_LEN, sot_index=sot_index,
        no_speech_token=tok.no_speech, beam_size=beam_size, pool_size=pool, kv_scheme=scheme)
    return tiny["refs"][key], got


def _assert_same(ref, got):
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_array_equal(got.fin_count.numpy(), np.asarray(ref.fin_count))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores), rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(got.no_speech_probs.numpy(), np.asarray(ref.no_speech_probs),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("scheme", tb.SCHEMES)
@pytest.mark.parametrize("kv,self_kv,mxu", CONFIGS)
def test_beam_decode_matches_jax(tiny, scheme, kv, self_kv, mxu):
    """The finished pool fills within the horizon (EOT row gain 6)."""
    ref, got = _run_pair(tiny, 6.0, kv, self_kv, mxu, scheme=scheme)
    assert (np.asarray(ref.lengths) < SAMPLE_LEN).any(), "no hypothesis finished"
    _assert_same(ref, got)


@pytest.mark.parametrize("scheme", ["flat", "permi"])
@pytest.mark.parametrize("kv,self_kv,mxu", [(0, 0, False), (4, 8, True)])
def test_beam_backfill_matches_jax(tiny, scheme, kv, self_kv, mxu):
    """No hypothesis finishes (gain 3) and the pool holds 6 (patience 2):
    the live beams backfill 3 slots and 3 stay empty at -inf."""
    ref, got = _run_pair(tiny, 3.0, kv, self_kv, mxu, patience=2.0, scheme=scheme)
    assert np.isinf(np.asarray(ref.scores)).any()
    _assert_same(ref, got)


@pytest.mark.parametrize("scheme", ["permp", "permi"])
def test_beam_lane_maps_are_int32(tiny, monkeypatch, scheme):
    """The loop hands K9 int32 row maps, its kernel's own type, converted
    once a step: no layer's call converts its map beside the kernel."""
    seen = []
    for name in ("lane_move_inplace", "permute_lanes"):
        def spy(tensors, index, _real=getattr(tb, name)):
            seen.append(index.dtype)
            return _real(tensors, index)
        monkeypatch.setattr(tb, name, spy)
    ref, got = _run_pair(tiny, 6.0, 0, 0, False, scheme=scheme)
    assert seen and set(seen) == {torch.int32}
    _assert_same(ref, got)


@pytest.mark.parametrize("scheme", ["flat", "permi"])
def test_beam_done_check_every_step_equal(tiny, monkeypatch, scheme):
    """Checking the pools every 16 steps gives what checking every step
    gives, though it runs steps past the point where every pool is full."""
    counts = {}
    results = {}
    real_step = tb.decode_step
    for every in (1, tb.DONE_CHECK_EVERY):
        calls = []

        def counting(*a, **kw):
            calls.append(1)
            return real_step(*a, **kw)

        monkeypatch.setattr(tb, "decode_step", counting)
        monkeypatch.setattr(tb, "DONE_CHECK_EVERY", every)
        _, results[every] = _run_pair(tiny, 10.0, 4, 8, True, scheme=scheme)
        counts[every] = len(calls)
    assert counts[1] < counts[16] <= SAMPLE_LEN + 1
    for a, b in zip(results[1], results[16]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# a host reference over the port's own decode_step
# ---------------------------------------------------------------------------


def _host_beam(params, config, tok, states, init_tokens, beam_size, sample_len, fc, always,
               begin):
    """Insertion-ordered reference beam for one window; each beam owns a
    copy of its parent's cache (the port's caches update in place)."""
    xkv = tw.cross_kv(params, states, config)
    cache = tw.init_kv_cache(config, 1, "cpu")
    logits, cache = tw.decode_step(params, torch.tensor([init_tokens]), 0, cache, xkv, config)
    beams = [(tuple(init_tokens), 0.0, cache, logits[:, -1])]
    finished = []
    for _ in range(sample_len):
        candidates = []
        for b, (seq, cum, _, lg) in enumerate(beams):
            buf = torch.zeros((1, config.n_text_ctx), dtype=torch.long)
            buf[0, :len(seq)] = torch.tensor(seq)
            lp = torch.log_softmax(apply_filters(lg, buf, len(seq), always, begin, fc), -1)[0]
            # stable: ties by ascending token id
            for t in np.argsort(-lp.numpy(), kind="stable")[:beam_size + 1]:
                candidates.append((cum + float(lp[t]), int(t), b))
        candidates.sort(key=lambda c: -c[0])
        new_beams = []
        for score, t, b in candidates:
            if t == tok.eot:
                if len(finished) < beam_size:
                    finished.append((beams[b][0] + (t,), score))
            elif len(new_beams) < beam_size:
                new_beams.append((beams[b][0] + (t,), score, beams[b][2]))
        if len(finished) >= beam_size:
            beams = new_beams
            break
        beams = []
        for seq, score, parent_cache in new_beams:
            own = [{k: v.clone() for k, v in e.items()} for e in parent_cache]
            lg, own = tw.decode_step(params, torch.tensor([[seq[-1]]]), len(seq) - 1, own,
                                     xkv, config)
            beams.append((seq, score, own, lg[:, -1]))
    return finished, [(seq, score) for seq, score, *_ in beams]


@pytest.mark.parametrize("zero", [False, True])
def test_beam_matches_host_reference(tiny, zero):
    """decode(beam_size=3) with the timestamp rules on, against the host
    reference; zero weights make every logit tie."""
    tok = tiny["tok"]
    _, tparams = tiny["models"][1.0]
    if zero:
        tparams = jax.tree.map(lambda a: a * 0, tparams)
    cfg = tiny["tcfg"]
    sample_len = 8 if zero else 12
    opts = tt.DecodingOptions(sample_len=sample_len, beam_size=3)
    mel = torch.from_numpy(tiny["mel"])
    results = tt.decode(tparams, mel, t_tokenizer(), cfg, opts)
    init, _, always, begin, fc = _inputs(tok, 3, timestamp_rules=True)
    sample_begin = fc["sample_begin"]
    states = tw.encode(tparams, mel, cfg)
    for w in range(2):
        finished, live = _host_beam(tparams, cfg, tok, states[w:w + 1], init, 3, sample_len,
                                    TFilter(**fc), torch.from_numpy(always),
                                    torch.from_numpy(begin))
        pool = list(finished)
        if len(pool) < 3:
            pool += [(seq + (tok.eot,), score) for seq, score in live]
        best, _ = max(pool, key=lambda it: it[1] / max(len(it[0]) - sample_begin - 1, 1))
        assert results[w].tokens == list(best[sample_begin:-1]), f"window {w}"


@pytest.mark.parametrize("patience", [2.0, 3.0])
def test_beam_pool_has_no_duplicates(tiny, patience):
    _, got = _run_pair(tiny, 6.0, 0, 0, False, patience=patience, beam_size=2)
    sample_begin = _inputs(tiny["tok"], 2)[4]["sample_begin"]
    for w in range(2):
        seqs = [tuple(got.tokens[w, p, sample_begin:sample_begin + got.lengths[w, p]].tolist())
                for p in range(got.tokens.shape[1]) if np.isfinite(float(got.scores[w, p]))]
        assert len(seqs) == int(got.fin_count[w]) and len(set(seqs)) == len(seqs)


# ---------------------------------------------------------------------------
# decode, transcribe and the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv,self_kv", [(0, 0), (4, 8)])
def test_decode_beam_matches_jax(tiny, kv, self_kv):
    """decode(beam_size=3, patience=2), timestamp rules on; quantized caches
    turn the integer-dot mode on in both packages."""
    jparams, tparams = tiny["models"][6.0]
    jcfg = dataclasses.replace(tiny["jcfg"], kv_bits=kv, self_kv_bits=self_kv)
    tcfg = dataclasses.replace(tiny["tcfg"], kv_bits=kv, self_kv_bits=self_kv)
    ref = jt.decode(jparams, jnp.asarray(tiny["mel"]), j_tokenizer(), jcfg,
                    jt.DecodingOptions(sample_len=24, beam_size=3, patience=2.0))
    got = tt.decode(tparams, torch.from_numpy(tiny["mel"]), t_tokenizer(), tcfg,
                    tt.DecodingOptions(sample_len=24, beam_size=3, patience=2.0))
    for r, g in zip(ref, got):
        assert g.tokens == r.tokens and g.text == r.text
        np.testing.assert_allclose(g.avg_logprob, r.avg_logprob, rtol=2e-5)
        np.testing.assert_allclose(g.no_speech_prob, r.no_speech_prob, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("kv,self_kv,env,expected", [
    (4, 8, None, True), (4, 8, "0", False), (0, 0, None, False), (4, 0, None, False)])
def test_decode_beam_integer_dot_default(tiny, monkeypatch, kv, self_kv, env, expected):
    seen = {}

    def capture(params, mel, tok, config, options, **kw):
        seen["attn_mxu"] = config.attn_mxu
        return []

    monkeypatch.setattr(tb, "beam_decode_task", capture)
    if env is not None:
        monkeypatch.setenv("WTPU_BEAM_ATTN_MXU", env)
    tcfg = dataclasses.replace(tiny["tcfg"], kv_bits=kv, self_kv_bits=self_kv)
    tt.decode({}, torch.zeros((1, 1500, 64)), t_tokenizer(), tcfg,
              tt.DecodingOptions(beam_size=2), states_precomputed=True)
    assert seen["attn_mxu"] is expected


def test_beam_shared_scheme_raises_naming_m15(tiny, monkeypatch):
    """kv_scheme='shared' (ROADMAP M15, ported since; the test keeps its
    name): ``WTPU_BEAM_KV=shared`` through ``decode`` on an int8 self cache,
    with its read window ``WTPU_BEAM_WIN`` at 4 (the overflow takes over) and
    its segment bounds ``WTPU_BEAM_PHASES``, gives the JAX package's tokens
    under the same variables; with an int4 self cache both remap it to flat,
    and an unknown scheme raises."""
    jparams, tparams = tiny["models"][6.0]
    mel = tiny["mel"][:1]
    opts = dict(sample_len=40, beam_size=2)
    monkeypatch.setenv("WTPU_BEAM_KV", "shared")
    monkeypatch.setenv("WTPU_BEAM_WIN", "4")
    monkeypatch.setenv("WTPU_BEAM_PHASES", "8")
    cfg8 = dataclasses.replace(tiny["tcfg"], kv_bits=4, self_kv_bits=8)
    shared = tt.decode(tparams, torch.from_numpy(mel), t_tokenizer(), cfg8,
                       tt.DecodingOptions(**opts))
    ref = jt.decode(jparams, jnp.asarray(mel), j_tokenizer(),
                    dataclasses.replace(tiny["jcfg"], kv_bits=4, self_kv_bits=8),
                    jt.DecodingOptions(**opts))
    assert [r.tokens for r in shared] == [r.tokens for r in ref]
    assert all(len(r.tokens) > 0 for r in shared)
    cfg4 = dataclasses.replace(tiny["tcfg"], self_kv_bits=4)
    opts4 = tt.DecodingOptions(sample_len=6, beam_size=2)
    shared = tt.decode(tparams, torch.from_numpy(mel), t_tokenizer(), cfg4, opts4)
    monkeypatch.setenv("WTPU_BEAM_KV", "flat")
    assert [r.tokens for r in shared] == [r.tokens for r in tt.decode(
        tparams, torch.from_numpy(mel), t_tokenizer(), cfg4, opts4)]
    monkeypatch.setenv("WTPU_BEAM_KV", "tmajor")
    with pytest.raises(ValueError, match="unknown beam kv_scheme"):
        tt.decode(tparams, torch.from_numpy(mel), t_tokenizer(), cfg4, opts4)


def _write_wav(path, audio):
    pcm = (np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes()
    hdr = (b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVEfmt "
           + struct.pack("<IHHIIHH", 16, 1, 1, 16000, 32000, 2, 16)
           + b"data" + struct.pack("<I", len(pcm)))
    path.write_bytes(hdr + pcm)


def test_transcribe_beam_matches_jax(tiny, tmp_path):
    """transcribe(beam_size=2) of a 35 s WAV: the T=0 rung is beam search in
    both packages; the same text and segments come out."""
    jparams, tparams = tiny["models"][6.0]
    wav = tmp_path / "in.wav"
    _write_wav(wav, make_speechy_audio(35.0, seed=4))
    kw = dict(temperature=0.0, verbose=False, condition_on_previous_text=False,
              sample_len=24, beam_size=2, patience=1.0)
    ref = j_transcribe(str(wav), params=jparams, config=tiny["jcfg"], tokenizer=j_tokenizer(),
                       **kw)
    got = t_transcribe(str(wav), params=tparams, config=tiny["tcfg"], tokenizer=t_tokenizer(),
                       device="cpu", **kw)
    assert got["text"] == ref["text"]
    assert len(got["segments"]) == len(ref["segments"]) > 0
    for g, r in zip(got["segments"], ref["segments"]):
        for key in ("seek", "start", "end", "text", "tokens"):
            assert g[key] == r[key], key


def test_cli_beam_size_cpu_writes_txt(tmp_path):
    wav = tmp_path / "a.wav"
    _write_wav(wav, make_speechy_audio(3.0))
    rc = t_cli.main([str(wav), "-f", "txt", "--output-name", "out", "-o", str(tmp_path),
                     "--model", "test-tiny", "--device", "cpu", "--verbose", "False",
                     "--beam-size", "2", "--patience", "1.5",
                     "--temperature-increment-on-fallback", "None"])
    assert rc == 0 and (tmp_path / "out.txt").exists()


# ---------------------------------------------------------------------------
# the greedy path's integer-dot branches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("group,self_kv", [(1, 8), (1, 4), (3, 8)])
def test_decode_step_integer_dot_matches_jax(tiny, group, self_kv):
    """attn_mxu: self attention (causal, prefill and steps) and cross
    attention (g = 1, and grouped g = 3) in the integer-dot mode. Bound as
    tests/test_torch_whisper.py bounds quantized steps: K/V from two
    frameworks may land one code apart at a .5 tie, moving logits ~1e-3."""
    jparams, tparams = tiny["models"][1.0]
    jcfg = dataclasses.replace(tiny["jcfg"], kv_bits=4, self_kv_bits=self_kv, attn_mxu=True)
    tcfg = dataclasses.replace(tiny["tcfg"], kv_bits=4, self_kv_bits=self_kv, attn_mxu=True)
    rng = np.random.default_rng(group)
    states = rng.standard_normal((2, 1500, 64)).astype(np.float32)
    rows = 2 * group
    toks = rng.integers(0, tcfg.n_vocab, size=(rows, 7)).astype(np.int32)
    jx = jw.cross_kv(jparams, jnp.asarray(states), jcfg)
    jc = jw.init_kv_cache(jcfg, rows, max_len=16)
    tx = tw.cross_kv(tparams, torch.from_numpy(states), tcfg)
    tc = tw.init_kv_cache(tcfg, rows, "cpu", max_len=16)
    for a, b in [(0, 3)] + [(p, p + 1) for p in range(3, 7)]:
        jl, jc, _ = jw.decode_step(jparams, jnp.asarray(toks[:, a:b]), jnp.int32(a), jc, jx, jcfg,
                                   share_xkv_groups=group)
        tl, tc = tw.decode_step(tparams, torch.from_numpy(toks[:, a:b]).long(), a, tc, tx, tcfg,
                                share_xkv_groups=group)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-3, rtol=1e-4,
                                   err_msg=f"positions [{a}, {b})")
