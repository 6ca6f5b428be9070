"""Port parity: the quantized Qwen KV cache (``config.kv_bits`` 8 / 4,
``WTPU_LLM_KV_BITS``) of whisper_mlx_tpu_torch against the JAX package on
the CPU, at fp32.

- ``quantize_kv`` on Qwen's k and v: codes and scales bit-identical.
- The plain version of K3's GQA mode (``ops/gqa_decode_attention.py``)
  against the reference's grouped path over a quantized cache
  (``whisper_mlx_tpu/models/qwen.py:182-194`` for the masks,
  ``:289-300`` for the attention), transcribed below in JAX because the
  reference has no function of its own for it: scalar and per-row
  positions, Tq 1 and 5, both code widths, a cache past 2,048 positions;
  tolerance 1e-5 * max(1, |ref|) (fp32 sums in another order). Its input
  contract.
- ``decode_step`` over the quantized cache: a 9-token prefill (flash on and
  off), one-token steps, per-row steps at staggered positions and a 5-token
  block past position 0 (the verify), logits within 1e-4 * max(1, |ref|) as
  in tests/test_torch_qwen.py, caches equal after
  ``checkpoint/convert.py:qwen_cache_from_jax``.
- The engines at T = 0, token for token: ``LLMEngine.generate`` under
  ``WTPU_LLM_KV_BITS``, ``speculative_generate`` with a quantized target and
  an fp draft, the continuous-batching engine with requests admitted at
  staggered steps and with an idle slot run past the cache end, and the
  daemon's ``/v1/chat`` with two overlapping requests on two slots.

Tiny configs: Qwen3-shaped (hd 32, rep 2, q/k norm, untied head) and
Qwen2-shaped (hd 16, rep 3, q/k/v bias, tied head), 2 layers.
"""

from __future__ import annotations

import asyncio
import dataclasses
import math
from unittest import mock

import numpy as np
import pytest

import torch  # (torch before jax: the reverse order has deadlocked)
import jax
import jax.numpy as jnp
from aiohttp.test_utils import TestClient, TestServer

from whisper_mlx_tpu.decoding import llm_tokenizer as j_tok
from whisper_mlx_tpu.inference import speculative as j_spec
from whisper_mlx_tpu.inference.generate import LLMEngine as JEngine
from whisper_mlx_tpu.models import qwen as jqw
from whisper_mlx_tpu.ops import flash_attention as j_fa
from whisper_mlx_tpu.ops import kv_quant as j_kvq
from whisper_mlx_tpu.serving import chat as j_chat
from whisper_mlx_tpu.serving import server as j_server
from whisper_mlx_tpu_torch.checkpoint.convert import qwen_cache_from_jax, qwen_params_from_jax
from whisper_mlx_tpu_torch.decoding import llm_tokenizer as t_tok
from whisper_mlx_tpu_torch.inference import generate as tg
from whisper_mlx_tpu_torch.inference import speculative as t_spec
from whisper_mlx_tpu_torch.inference.batch_engine import ContinuousBatchEngine
from whisper_mlx_tpu_torch.models import qwen as tqw
from whisper_mlx_tpu_torch.ops import gqa_decode_attention as gq
from whisper_mlx_tpu_torch.ops import kv_quant as t_kvq
from whisper_mlx_tpu_torch.ops.decode_attention import unpack_int4
from whisper_mlx_tpu_torch.serving import chat as t_chat
from whisper_mlx_tpu_torch.serving import server as t_server

TOL = 1e-4
PLAIN_TOL = 1e-5
CONFIGS = {
    "qwen3_rep2": dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                       num_attention_heads=4, num_key_value_heads=2, head_dim=32,
                       qk_norm=True, attention_bias=False, tie_word_embeddings=False,
                       rope_theta=1e6),
    "qwen2_rep3": dict(hidden_size=96, intermediate_size=128, num_hidden_layers=2,
                       num_attention_heads=6, num_key_value_heads=2, rope_theta=10_000.0),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, ref, tol=TOL):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=tol * max(1.0, np.abs(ref).max()), rtol=0)


def _pair(name, bits, vocab=256, seed=1):
    """The reference's random init (norm gains and biases perturbed so a
    wrong layout shows) in both packages, at kv_bits ``bits``."""
    jcfg = jqw.QwenConfig(vocab_size=vocab, kv_bits=bits, **CONFIGS[name])
    tcfg = tqw.QwenConfig(vocab_size=vocab, kv_bits=bits, **CONFIGS[name])
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, jqw.init_params(jcfg, seed=seed))

    def perturb(node, key=None):
        if isinstance(node, dict):
            return {k: perturb(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [perturb(v) for v in node]
        if node.ndim == 1:
            noise = 0.1 * rng.standard_normal(node.shape).astype(np.float32)
            return noise if key == "b" else 1 + noise
        return node

    tree = perturb(tree)
    return jax.tree.map(jnp.asarray, tree), jcfg, qwen_params_from_jax(tree, tcfg), tcfg


def _assert_caches_equal(jcache, tcache):
    conv = qwen_cache_from_jax(jax.tree.map(np.asarray, jcache))
    assert [sorted(c) for c in conv] == [sorted(c) for c in tcache]
    for a, b in zip(conv, tcache):
        for key in a:
            assert a[key].dtype == b[key].dtype and torch.equal(a[key], b[key]), key


# ---------------------------------------------------------------------------
# quantization and the plain GQA attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("hd", [32, 16, 128])
def test_quantize_kv_on_qwen_kv_bit_identical(bits, hd):
    x = (np.random.default_rng(hd + bits).standard_normal((2, 3, 37, hd)) * 0.7).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero row takes the 1e-8 floor
    jcodes, jscale = j_kvq.quantize_kv(jnp.asarray(x), bits=bits)
    codes, scale = t_kvq.quantize_kv(torch.from_numpy(x), bits)
    assert scale.dtype == torch.bfloat16 and scale.shape == (2, 3, 37)
    assert torch.equal(scale.float(), torch.from_numpy(np.asarray(jscale, np.float32)[..., 0]))
    assert codes.dtype == (torch.int8 if bits == 8 else torch.uint8)
    got = codes if bits == 8 else unpack_int4(codes)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jcodes).astype(np.int8))


def _jax_grouped(q, k8t, ks, v8t, vs, pos, tq, per_row):
    """The reference's masks (models/qwen.py:182-194) and grouped path over a
    quantized cache (:289-300), on its time-minor layout."""
    b, h, _, hd = q.shape
    n_kv, max_len = k8t.shape[1], k8t.shape[3]
    rep, scale = h // n_kv, 1.0 / math.sqrt(hd)
    if per_row:
        q_idx = jnp.arange(tq)[None, :, None] + pos[:, None, None]
        k_idx = jnp.arange(max_len)[None, None, :]
        mask = jnp.where(k_idx <= q_idx, 0.0, -jnp.inf)[:, None]
    else:
        q_idx = jnp.arange(tq)[:, None] + pos
        k_idx = jnp.arange(max_len)[None, :]
        mask = jnp.where(k_idx <= q_idx, 0.0, -jnp.inf)
    q5 = q.reshape(b, n_kv, rep, tq, hd)
    scores = jnp.einsum("bgrqd,bgdk->bgrqk", q5.astype(jnp.float32), k8t.astype(jnp.float32)
                        ) * (ks[..., 0].astype(jnp.float32)[:, :, None, None, :] * scale)
    scores = scores + (mask[:, None] if per_row else mask)
    w = jax.nn.softmax(scores, axis=-1)
    w = w * vs[..., 0].astype(jnp.float32)[:, :, None, None, :]
    attn = jnp.einsum("bgrqk,bgdk->bgrqd", w, v8t.astype(jnp.float32))
    return attn.reshape(b, h, tq, hd)


def _quantized_case(seed, b, n_kv, rep, tq, hd, t, bits):
    """Random q and a cache quantized by the reference: its time-minor
    arrays and the port's converted ones."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, n_kv * rep, tq, hd)).astype(np.float32)
    kx, vx = (rng.standard_normal((b, n_kv, t, hd)).astype(np.float32) for _ in range(2))
    (k8, ks), (v8, vs) = (j_kvq.quantize_kv(jnp.asarray(x), bits=bits) for x in (kx, vx))
    jax_cache = {"k8t": jnp.swapaxes(k8, 2, 3), "ks": ks, "v8t": jnp.swapaxes(v8, 2, 3), "vs": vs}
    port = qwen_cache_from_jax([jax.tree.map(np.asarray, jax_cache)])[0]
    return q, jax_cache, port


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("b,n_kv,rep,tq,hd,t,pos", [
    (1, 2, 2, 1, 32, 40, [17]),         # one decode step
    (1, 2, 3, 5, 16, 40, [20]),         # the verify of k = 4
    (3, 2, 2, 1, 32, 64, [5, 40, 63]),  # continuous batching: a position a row
    (2, 3, 3, 5, 16, 48, [0, 30]),      # per-row verify blocks, one from position 0
    (1, 2, 2, 1, 128, 2100, [2090]),    # past K3's 2,048 positions
    (2, 1, 4, 2, 32, 2300, [2290, 7]),
])
def test_plain_gqa_matches_reference(bits, b, n_kv, rep, tq, hd, t, pos):
    q, jc, pc = _quantized_case(len(pos) + tq + t, b, n_kv, rep, tq, hd, t, bits)
    per_row = len(set(pos)) > 1 or b > 1
    jpos = jnp.asarray(pos, jnp.int32) if per_row else jnp.int32(pos[0])
    ref = _jax_grouped(jnp.asarray(q), jc["k8t"], jc["ks"], jc["v8t"], jc["vs"], jpos, tq, per_row)
    live = min(t, max(pos) + tq)
    before = gq.LAUNCHES
    got = gq.gqa_decode_attention(torch.from_numpy(q), pc["k8"], pc["ks"], pc["v8"], pc["vs"],
                                  torch.tensor(pos, dtype=torch.int32), scale=1.0 / math.sqrt(hd),
                                  live=live)
    assert gq.LAUNCHES == before  # the CPU runs the plain version
    assert got.dtype == torch.float32
    _close(got, ref, PLAIN_TOL)
    bf = gq.gqa_decode_attention_plain(torch.from_numpy(q), pc["k8"], pc["ks"], pc["v8"],
                                       pc["vs"], torch.tensor(pos, dtype=torch.int32),
                                       scale=1.0 / math.sqrt(hd), live=live,
                                       out_dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16 and torch.equal(bf, got.to(torch.bfloat16))


def test_plain_gqa_input_contract():
    q, _, pc = _quantized_case(0, 2, 2, 2, 1, 32, 16, 8)
    q = torch.from_numpy(q)
    pos = torch.tensor([3, 9], dtype=torch.int32)
    args = (pc["k8"], pc["ks"], pc["v8"], pc["vs"])

    def call(*a, p=pos, live=10, **kw):
        return gq.gqa_decode_attention(*a, p, scale=0.1, live=live, **kw)

    call(q, *args)
    bad = [
        ((q.bfloat16(), *args), {}, "float32"),
        ((q[:, :3], *args), {}, "KV heads"),
        ((q, pc["k8"][..., :16].contiguous(), pc["ks"], pc["v8"][..., :16].contiguous(),
          pc["vs"]), {}, "codes must be"),
        ((q, pc["k8"], pc["ks"].float(), pc["v8"], pc["vs"]), {}, "ks must be"),
        ((q, *args), {"p": pos.long()}, "int32"),
        ((q, *args), {"p": pos[:1]}, "pos must be"),
        ((q, *args), {"live": 17}, "past the cache"),
        ((q, *args), {"live": 9}, "past the cache end"),  # row 1 at position 9
        ((q, *args), {"p": torch.tensor([-1, 2], dtype=torch.int32)}, "past the cache end"),
        ((q, *args), {"out_dtype": torch.float16}, "out_dtype"),
        ((q.transpose(0, 1).contiguous().transpose(0, 1), *args), {}, "q must be"),
    ]
    for a, kw, match in bad:
        with pytest.raises(ValueError, match=match):
            call(*a, **kw)
    with pytest.raises(ValueError, match="device"):
        gq.gqa_decode_attention(q.to("meta"), *(t.to("meta") for t in args), pos.to("meta"),
                                scale=0.1, live=10)


# ---------------------------------------------------------------------------
# decode_step over the quantized cache
# ---------------------------------------------------------------------------


def _jax_interp_flash(q, k, v, **kw):
    return _ORIG_FLASH(q, k, v, **{**kw, "interpret": True, "tile_q": 8, "tile_k": 128})


_ORIG_FLASH = j_fa.flash_attention


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("flash", [False, True], ids=["xla", "flash"])
def test_decode_steps_match_jax(name, bits, flash):
    """Prefill, one-token steps, a verify block past position 0 and per-row
    steps at staggered positions; the caches equal after every call. With
    flash on, the reference's flash branch would take the block past 0
    within the block only, so JAX runs that block with flash off, the path
    the port takes (tests/test_torch_speculative.py)."""
    jparams, jcfg, tparams, tcfg = _pair(name, bits)
    jcfg = dataclasses.replace(jcfg, flash_attention=flash)
    tcfg = dataclasses.replace(tcfg, flash_attention=flash)
    rng = np.random.default_rng(bits)
    jcache = jqw.init_kv_cache(jcfg, 2, 48)
    tcache = tqw.init_kv_cache(tcfg, 2, 48)
    calls = [(rng.integers(0, 256, (2, 9)), 0)]
    calls += [(rng.integers(0, 256, (2, 1)), 9 + i) for i in range(3)]
    calls += [(rng.integers(0, 256, (2, 5)), 12)]
    calls += [(rng.integers(0, 256, (2, 1)), [17 + i, 6 + 3 * i]) for i in range(3)]
    for tokens, pos in calls:
        per_row = isinstance(pos, list)
        jc = dataclasses.replace(jcfg, flash_attention=False) if pos else jcfg
        jpos = jnp.asarray(pos, jnp.int32) if per_row else jnp.int32(pos)
        with mock.patch.object(j_fa, "flash_attention", _jax_interp_flash):
            ref, jcache = jqw.decode_step(jparams, jnp.asarray(tokens, jnp.int32), jpos, jcache, jc)
        got, tcache = tqw.decode_step(tparams, torch.from_numpy(tokens).long(), pos, tcache, tcfg)
        assert got.dtype == torch.float32
        _close(got, ref)
        _assert_caches_equal(jcache, tcache)


def test_decode_step_cache_edge_and_past_it():
    """A block that runs past the cache end is written at its last
    positions, as the fp cache and the reference's update slice are, and
    attends to every key; so does a step whose first position is at or past
    the end (an idle slot of the continuous engine keeps advancing), with a
    scalar or a per-row position. Logits and caches as JAX's."""
    jparams, jcfg, tparams, tcfg = _pair("qwen3_rep2", 8)
    jcache = jqw.init_kv_cache(jcfg, 1, 16)
    tcache = tqw.init_kv_cache(tcfg, 1, 16)
    calls = [(np.arange(1, 12)[None], 0),
             (np.array([[7, 8, 9, 10, 11]]), 13),  # positions 13-17: written at 11-15
             (np.array([[5]]), 16), (np.array([[9]]), [17]), (np.array([[4]]), [30])]
    for tokens, pos in calls:
        jpos = jnp.asarray(pos, jnp.int32) if isinstance(pos, list) else jnp.int32(pos)
        ref, jcache = jqw.decode_step(jparams, jnp.asarray(tokens, jnp.int32), jpos, jcache,
                                      jcfg)
        got, tcache = tqw.decode_step(tparams, torch.from_numpy(tokens), pos, tcache, tcfg)
        _close(got, ref)
        _assert_caches_equal(jcache, tcache)


def test_init_kv_cache_layouts():
    for bits, width, dtype in ((8, 32, torch.int8), (4, 16, torch.uint8)):
        cfg = tqw.QwenConfig(vocab_size=64, kv_bits=bits, **CONFIGS["qwen3_rep2"])
        cache = tqw.init_kv_cache(cfg, 3, 40)
        assert len(cache) == 2
        for layer in cache:
            assert layer["k8"].shape == layer["v8"].shape == (3, 2, 40, width)
            assert layer["k8"].dtype == dtype
            assert layer["ks"].shape == layer["vs"].shape == (3, 2, 40)
            assert layer["ks"].dtype == torch.bfloat16
        jcache = jqw.init_kv_cache(jqw.QwenConfig(vocab_size=64, kv_bits=bits,
                                                  **CONFIGS["qwen3_rep2"]), 3, 40)
        _assert_caches_equal(jcache, cache)
    for bits in (0, 2, 16):  # other values keep the fp cache, as in the reference
        cfg = tqw.QwenConfig(vocab_size=64, kv_bits=bits, **CONFIGS["qwen3_rep2"])
        assert sorted(tqw.init_kv_cache(cfg, 1, 8)[0]) == ["k", "v"]


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

ENGINE_DIMS = dict(CONFIGS["qwen3_rep2"], rope_theta=10_000.0)


@pytest.fixture(scope="module")
def fp_models():
    tok = j_tok.ByteFallbackTokenizer()
    jcfg = jqw.QwenConfig(vocab_size=tok.vocab_size, **ENGINE_DIMS)
    tcfg = tqw.QwenConfig(vocab_size=tok.vocab_size, **ENGINE_DIMS)
    jparams = jqw.init_params(jcfg, seed=3)
    return jparams, jcfg, qwen_params_from_jax(jax.tree.map(np.asarray, jparams), tcfg), tcfg


@pytest.mark.parametrize("bits", ["8", "4"])
def test_engine_under_env_matches_jax(fp_models, monkeypatch, bits):
    jparams, jcfg, tparams, tcfg = fp_models
    monkeypatch.setenv("WTPU_LLM_KV_BITS", bits)
    jeng = JEngine(jparams, jcfg, j_tok.ByteFallbackTokenizer(), max_context=192)
    teng = tg.LLMEngine(tparams, tcfg, t_tok.ByteFallbackTokenizer(), max_context=192)
    assert teng.config.kv_bits == int(bits) and tcfg.kv_bits == 0
    for prompt, n in (("hello", 16), ("The quick brown fox", 24)):
        ref = jeng.generate(prompt, max_tokens=n, temperature=0.0)
        got = teng.generate(prompt, max_tokens=n, temperature=0.0)
        assert got.tokens == ref.tokens and got.text == ref.text


def test_speculative_quantized_target_fp_draft_matches_jax():
    jt, jtc, tt, ttc = _pair("qwen3_rep2", 8, seed=5)
    jd, jdc, td, tdc = _pair("qwen2_rep3", 0, seed=9)
    prompt = np.random.default_rng(2).integers(0, 256, size=8).tolist()
    # the reference's steps jitted, as its engines run them (eagerly, each new
    # shape's operations compile one by one: 25 s)
    step = jax.jit(jqw.decode_step, static_argnames="config")
    with mock.patch.object(j_spec, "decode_step",
                           lambda p, t, pos, c, cfg: step(p, t, pos, c, config=cfg)):
        ref, rstats = j_spec.speculative_generate(jt, jtc, jd, jdc, prompt, max_tokens=8,
                                                  stop_ids={7}, k=4, max_len=96)
    got, stats = t_spec.speculative_generate(tt, ttc, td, tdc, prompt, max_tokens=8,
                                             stop_ids={7}, k=4, max_len=96)
    assert got == ref and len(got) == 8
    assert dataclasses.asdict(stats) == dataclasses.asdict(rstats)


def test_engine_draft_keeps_its_config(fp_models, monkeypatch):
    """Under WTPU_LLM_KV_BITS the target's cache is quantized and the
    draft's is not: the draft's config is its own."""
    _, _, tparams, tcfg = fp_models
    monkeypatch.setenv("WTPU_LLM_KV_BITS", "8")
    dcfg = tqw.QwenConfig(vocab_size=tcfg.vocab_size, **CONFIGS["qwen2_rep3"])
    dparams = tqw.init_params(dcfg, seed=4)
    eng = tg.LLMEngine(tparams, tcfg, t_tok.ByteFallbackTokenizer(), max_context=192,
                       draft=(dparams, dcfg))
    seen = []
    real = tqw.init_kv_cache
    with mock.patch.object(t_spec, "init_kv_cache",
                           side_effect=lambda c, *a, **k: seen.append(c.kv_bits) or real(c, *a, **k)):
        got = eng.generate("hello", max_tokens=12, temperature=0.0)
    assert seen == [8, 0] and eng.draft[1] is dcfg
    plain = tg.LLMEngine(tparams, tcfg, t_tok.ByteFallbackTokenizer(), max_context=192)
    assert got.tokens == plain.generate("hello", max_tokens=12, temperature=0.0).tokens


@pytest.mark.parametrize("bits", [8, 4])
def test_continuous_engine_staggered_matches_jax(fp_models, monkeypatch, bits):
    """Requests admitted at staggered steps on two slots of a quantized
    cache (config.kv_bits set; the engine reads no environment variable):
    each request's tokens equal the JAX engine's under WTPU_LLM_KV_BITS."""
    jparams, jcfg, tparams, tcfg = fp_models
    monkeypatch.setenv("WTPU_LLM_KV_BITS", str(bits))
    jeng = JEngine(jparams, jcfg, j_tok.ByteFallbackTokenizer(), max_context=192)
    monkeypatch.delenv("WTPU_LLM_KV_BITS")
    eng = ContinuousBatchEngine(tparams, dataclasses.replace(tcfg, kv_bits=bits),
                                t_tok.ByteFallbackTokenizer(), slots=2, max_len=192)
    try:
        assert sorted(eng._cache[0]) == ["k8", "ks", "v8", "vs"]
        first = eng.submit("long running request", max_tokens=30, temperature=0.0)
        it = first.tokens()
        got_first = [next(it) for _ in range(4)]
        second = eng.submit("late", max_tokens=10, temperature=0.0)
        got_first += [next(it) for _ in range(6)]
        third = eng.submit("third one", max_tokens=8, temperature=0.0)
        got_second, got_third = list(second.tokens()), list(third.tokens())
        got_first += list(it)
        assert max(eng._step_occupancy) == 2
    finally:
        eng.close()
    for prompt, n, got in (("long running request", 30, got_first), ("late", 10, got_second),
                           ("third one", 8, got_third)):
        assert got == jeng.generate(prompt, max_tokens=n, temperature=0.0).tokens


def test_continuous_engine_idle_slot_past_cache_end_matches_jax(fp_models, monkeypatch):
    """Three slots of a 96-position quantized cache, two in use and one
    never admitted, for more steps than the cache holds: the idle slot's
    position runs past the cache end, and a request that reaches the end
    sits there one pipelined step while another request is still active.
    The worker stays alive and every request's tokens equal the JAX
    engine's (the one that reaches the end: its prefix, one token short,
    as the reference's continuous engine stops it)."""
    jparams, jcfg, tparams, tcfg = fp_models
    monkeypatch.setenv("WTPU_LLM_KV_BITS", "8")
    jeng = JEngine(jparams, jcfg, j_tok.ByteFallbackTokenizer(), max_context=96)
    monkeypatch.delenv("WTPU_LLM_KV_BITS")
    eng = ContinuousBatchEngine(tparams, dataclasses.replace(tcfg, kv_bits=8),
                                t_tok.ByteFallbackTokenizer(), slots=3, max_len=96)
    try:
        first = [eng.submit(p, max_tokens=n, temperature=0.0)
                 for p, n in (("first of a pair", 40), ("second", 30))]
        got = {p: list(h.tokens()) for p, h in zip(("first of a pair", "second"), first)}
        to_end = eng.submit("to the end", max_tokens=500, temperature=0.0)
        it = to_end.tokens()
        got["to the end"] = [next(it) for _ in range(70)]
        late = eng.submit("late", max_tokens=20, temperature=0.0)
        got["to the end"] += list(it)
        got["late"] = list(late.tokens())
        assert eng.alive and eng._steps > eng.max_len and eng._pos[2] >= eng.max_len
    finally:
        eng.close()
    for prompt, n in (("first of a pair", 40), ("second", 30), ("late", 20)):
        assert got[prompt] == jeng.generate(prompt, max_tokens=n, temperature=0.0).tokens
    ref = jeng.generate("to the end", max_tokens=500, temperature=0.0).tokens
    assert len(got["to the end"]) == len(ref) - 1 == 96 - len("to the end") - 1
    assert got["to the end"] == ref[:-1]


def test_daemon_two_chats_on_two_slots_match_jax(tmp_path, monkeypatch):
    """The daemon app on the CPU with QWEN_BATCH_SLOTS=2 and
    WTPU_LLM_KV_BITS=8: two overlapping /v1/chat requests at T = 0 on the
    tiny default model, both through the continuous-batching engine over
    the quantized cache, answer as the JAX daemon's do."""
    monkeypatch.setenv("QWEN_BATCH_SLOTS", "2")
    monkeypatch.setenv("WTPU_LLM_KV_BITS", "8")
    for name in ("QWEN_SCRIPTED_MODEL", "QWEN_MODEL_PATH", "QWEN_DRAFT_PATH"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("QWEN_SESSIONS_DIR", str(tmp_path / "sessions"))
    for chat in (t_chat, j_chat):
        monkeypatch.setattr(chat.QwenModel, "_instances", {})

    async def run(app):
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            async def chat(message):
                body = {"message": message, "profile": "code_runner", "temperature": 0.0,
                        "max_tokens": 12}
                async with client.post("/v1/chat", json=body) as r:
                    return r.status, (await r.json())["response"]
            return await asyncio.gather(chat("first question"), chat("a second one"))
        finally:
            await client.close()

    got = asyncio.run(run(t_server.create_app(device="cpu", batch_slots=2)))
    model = t_chat.QwenModel._instances
    engine = next(iter(model.values())).engine
    assert engine.config.kv_bits == 8 and engine._batch_engine is not None
    assert max(engine._batch_engine._step_occupancy) == 2
    engine._batch_engine.close()
    ref = asyncio.run(run(j_server.create_app(batch_slots=2)))
    assert got == ref and [s for s, _ in got] == [200, 200]
