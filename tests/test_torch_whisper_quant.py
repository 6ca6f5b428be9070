"""Port parity: whisper from packed 4/8-bit weights (quantize_params, fused
qkv, the packed / dense / few-row decode policy) against the JAX package on
the CPU.

The same numpy weights go through both packages: the JAX tree is quantized
by the JAX package and carried across by ``params_from_jax``, so both
compute on identical codes, scales and biases. Logits are compared at fp32
within 2e-3 * max(1, |ref|) with the JAX side on its fused Pallas kernel in
interpret mode (its TPU route, forced inside the test only); decodes are
compared token for token at temperature 0.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import torch  # noqa: F401  (torch before jax: the reverse order has deadlocked)
import jax
import jax.numpy as jnp

from tests.conftest import make_speechy_audio
from tests.test_torch_transcribe import _write_wav
from whisper_mlx_tpu.audio.mel import N_SAMPLES, pad_or_trim
from whisper_mlx_tpu.audio.mel import log_mel_spectrogram as j_log_mel
from whisper_mlx_tpu.decoding import task as j_task
from whisper_mlx_tpu.decoding import tokenizer as j_tokenizer
from whisper_mlx_tpu.inference.transcribe import transcribe as j_transcribe
from whisper_mlx_tpu.models import whisper as jw
from whisper_mlx_tpu.ops import quant as jq
from whisper_mlx_tpu.ops import quant_pallas as jqp
from whisper_mlx_tpu.runtime.serving_config import apply_asr_serving_config as j_serving
from whisper_mlx_tpu_torch.checkpoint.convert import params_from_jax
from whisper_mlx_tpu_torch.decoding import task as t_task
from whisper_mlx_tpu_torch.decoding import tokenizer as t_tokenizer
from whisper_mlx_tpu_torch.inference.transcribe import transcribe as t_transcribe
from whisper_mlx_tpu_torch.models import whisper as tw
from whisper_mlx_tpu_torch.ops import quant as tq
from whisper_mlx_tpu_torch.ops import quant_matmul as tqm
from whisper_mlx_tpu_torch.ops import quant_matmul_mb as tmb
from whisper_mlx_tpu_torch.runtime.serving_config import apply_asr_serving_config as t_serving

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


@pytest.fixture(autouse=True)
def fresh_policy_cache():
    tq._DENSE_DECODE_CACHE.clear()
    jq._DENSE_DECODE_CACHE.clear()
    yield
    tq._DENSE_DECODE_CACHE.clear()
    jq._DENSE_DECODE_CACHE.clear()


@pytest.fixture(scope="module")
def tiny():
    """(JAX fp params, JAX config, port fp params, port config, mel): the
    biases and LayerNorm gains randomized so a wrong slice or layout shows."""
    tok = j_tokenizer.make_synthetic_tokenizer()
    jcfg = jw.WhisperConfig(n_vocab=tok.n_vocab, **DIMS)
    tcfg = tw.WhisperConfig(n_vocab=tok.n_vocab, **DIMS)
    rng = np.random.default_rng(11)

    def perturb(node, key=None):
        if isinstance(node, dict):
            return {k: perturb(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [perturb(v) for v in node]
        a = np.asarray(node)
        if key == "b":
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if key == "g":
            return (1.0 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return a

    tree = perturb(jax.tree.map(np.asarray, jw.init_params(jcfg, seed=4)))
    jparams = jax.tree.map(jnp.asarray, tree)
    audio = pad_or_trim(jnp.asarray(make_speechy_audio(6.0)), N_SAMPLES)
    mel = np.array(j_log_mel(audio, n_mels=80))[None]
    return jparams, jcfg, params_from_jax(tree, tcfg), tcfg, mel


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _quant_pair(tiny, bits=4, fuse=True):
    """The JAX tree quantized (and fused) by the JAX package, and the same
    tree carried into the port."""
    jparams, _, _, tcfg, _ = tiny
    jq_tree = jq.quantize_params(jparams, bits=bits, group_size=64)
    if fuse:
        jq_tree = jq.fuse_whisper_qkv(jq_tree)
    return jq_tree, params_from_jax(_np_tree(jq_tree), tcfg)


def _leaves(node, path=""):
    """(path, leaf) of a tree, QuantTensors as leaves."""
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, node


def _assert_same_tree(ttree, jtree):
    """Every leaf of the port's tree equals the JAX tree's, bit for bit:
    QuantTensor words, scales and biases; fp linears transposed back."""
    t_leaves, j_leaves = dict(_leaves(ttree)), dict(_leaves(jtree))
    assert sorted(t_leaves) == sorted(j_leaves)
    n_quant = 0
    for path, t in t_leaves.items():
        j = j_leaves[path]
        if isinstance(t, tq.QuantTensor):
            assert type(j).__name__ == "QuantTensor", path
            assert (t.bits, t.group_size) == (j.bits, j.group_size)
            np.testing.assert_array_equal(t.w_q.numpy().view(np.uint32), np.asarray(j.w_q), path)
            np.testing.assert_array_equal(t.scales.numpy(), np.asarray(j.scales), path)
            np.testing.assert_array_equal(t.biases.numpy(), np.asarray(j.biases), path)
            n_quant += 1
            continue
        want = np.asarray(j)
        if path.endswith("/w"):
            want = want.T if want.ndim == 2 else want.transpose(2, 1, 0)
        np.testing.assert_array_equal(t.numpy(), want, path)
    return n_quant


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_params_bit_identical(tiny, bits):
    jparams, _, tparams, _, _ = tiny
    n = _assert_same_tree(tq.quantize_params(tparams, bits=bits, group_size=64),
                          jq.quantize_params(jparams, bits=bits, group_size=64))
    assert n == 2 * 6 + 2 * 10 + 1  # encoder and decoder linears, the token table


def test_fuse_unfuse_bit_identical(tiny):
    jparams, _, tparams, _, _ = tiny
    jq_tree = jq.quantize_params(jparams, bits=4, group_size=64)
    tq_tree = tq.quantize_params(tparams, bits=4, group_size=64)
    jf, tf = jq.fuse_whisper_qkv(jq_tree), tq.fuse_whisper_qkv(tq_tree)
    attn = tf["decoder"]["blocks"][0]["attn"]
    assert sorted(attn) == ["o", "qkv"] and attn["qkv"]["w"].shape == (192, 64)
    assert "q" in tf["decoder"]["blocks"][0]["cross_attn"]  # cross is not fused
    assert attn["qkv"]["b"].dtype == torch.float32
    assert torch.count_nonzero(attn["qkv"]["b"][64:128]) == 0  # k has no bias
    _assert_same_tree(tf, jf)
    _assert_same_tree(tq.unfuse_whisper_qkv(tf), jq.unfuse_whisper_qkv(jf))
    _assert_same_tree(tq.unfuse_whisper_qkv(tf), jq_tree)
    assert tq.unfuse_whisper_qkv(tq_tree) is not tq_tree  # a copy, nothing to split
    _assert_same_tree(tq.unfuse_whisper_qkv(tq_tree), jq_tree)


@pytest.mark.parametrize("fuse", [False, True])
def test_params_from_jax_carries_quantized_trees(tiny, fuse):
    jq_tree, tparams = _quant_pair(tiny, fuse=fuse)
    assert _assert_same_tree(tparams, jq_tree) == (25 if fuse else 33)


def test_params_from_jax_carries_transposed_leaves(tiny):
    """The few-row transposed layout (QuantTensorT) converts like Qwen's."""
    jq_tree, _ = _quant_pair(tiny)
    tparams = params_from_jax(_np_tree(jq.prepare_mbt_params(jq_tree)), tiny[3])
    leaf = tparams["decoder"]["blocks"][1]["mlp"]["fc2"]["w"]
    assert isinstance(leaf, tmb.QuantTensorT)
    assert isinstance(tparams["decoder"]["token_emb"], tq.QuantTensor)
    want = jq_tree["decoder"]["blocks"][1]["mlp"]["fc2"]["w"].dequantize()
    np.testing.assert_array_equal(leaf.dequantize(torch.float32).numpy(), np.asarray(want))


@pytest.fixture
def jax_fused_kernel(monkeypatch):
    """JAX's quant_matmul takes its TPU branch for calls of at most 512 rows,
    the fused Pallas kernel interpreted. Jit caches cleared around it."""
    jax.clear_caches()
    k5 = jqp.quant_matmul_pallas
    calls = []
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jqp, "quant_matmul_pallas",
                        lambda x, q, **kw: calls.append(1) or k5(x, q, **{**kw, "interpret": True}))
    yield calls
    jax.clear_caches()


def test_decode_step_logits_match_jax_fused_kernel(tiny, jax_fused_kernel, monkeypatch):
    """Prefill and two steps on the quantized fused tree at fp32: the port's
    linears, fused qkv, quantized token table and head (K5's plain version)
    against JAX on its fused kernel."""
    _, jcfg, _, tcfg, mel = tiny
    jq_tree, tparams = _quant_pair(tiny)
    plain_calls = []
    plain = tqm.quant_matmul_plain
    monkeypatch.setattr(tqm, "quant_matmul_plain",
                        lambda *a: plain_calls.append(a[0].shape) or plain(*a))
    jstates = jw.encode(jq_tree, jnp.asarray(mel), jcfg)
    tstates = tw.encode(tparams, torch.from_numpy(mel), tcfg)
    assert not plain_calls  # 1500 rows: dequantize + matmul, as in the reference
    np.testing.assert_allclose(tstates.numpy(), np.asarray(jstates), atol=2e-3)
    jx, tx = jw.cross_kv(jq_tree, jstates, jcfg), tw.cross_kv(tparams, tstates, tcfg)
    jc, tc = jw.init_kv_cache(jcfg, 1), tw.init_kv_cache(tcfg, 1, "cpu")
    rng = np.random.default_rng(2)
    pos = 0
    for t in (3, 1, 1):
        toks = rng.integers(0, tcfg.n_vocab, (1, t))
        ref, jc, _ = jw.decode_step(jq_tree, jnp.asarray(toks, jnp.int32), jnp.int32(pos), jc,
                                    jx, jcfg)
        got, tc = tw.decode_step(tparams, torch.from_numpy(toks), pos, tc, tx, tcfg)
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, atol=2e-3 * max(1.0, np.abs(ref).max()),
                                   rtol=0)
        pos += t
    assert jax_fused_kernel and plain_calls  # both sides went through the fused function
    # per step: qkv, o, cross q, cross o, fc1, fc2 per layer and the head
    assert len(plain_calls) == 3 * (2 * 6 + 1)  # cross k and v see 1500 rows: not the kernel


def test_quantized_decode_equals_dequantized_and_unfused(tiny):
    """As tests/test_quant.py requires of JAX: the packed path adds no error
    of its own (tokens equal the dequantized model's) and fusing is exact."""
    _, _, tparams, tcfg, mel = tiny
    tok = t_tokenizer.make_synthetic_tokenizer()
    qparams = tq.quantize_params(tparams, bits=4, group_size=64)
    opts = t_task.DecodingOptions(sample_len=16)
    mel_t = torch.from_numpy(mel)
    r_q = t_task.decode(qparams, mel_t, tok, tcfg, opts)
    r_fp = t_task.decode(tq.dequantize_params(qparams, torch.float32), mel_t, tok, tcfg, opts)
    r_f = t_task.decode(tq.fuse_whisper_qkv(qparams), mel_t, tok, tcfg, opts)
    assert r_q[0].tokens == r_fp[0].tokens == r_f[0].tokens and r_q[0].tokens
    np.testing.assert_allclose(r_q[0].avg_logprob, r_fp[0].avg_logprob, atol=1e-4)
    np.testing.assert_allclose(r_q[0].avg_logprob, r_f[0].avg_logprob, atol=1e-5)


def _is_quant(tree) -> bool:
    return any(isinstance(leaf, tq.QuantTensor) for _, leaf in _leaves(tree))


@pytest.mark.parametrize("rows,env,route", [
    (8, {}, "packed"), (16, {}, "packed"), (17, {}, "dense"),
    (56, {"WTPU_DENSE_ROWS_MIN": "1000"}, "packed"), (4, {"WTPU_DENSE_ROWS_MIN": "3"}, "dense"),
    (6, {"WTPU_FEWROW_MBT": "1"}, "mbt"), (17, {"WTPU_FEWROW_MBT": "1"}, "dense"),
])
def test_decode_policy_routes(tiny, monkeypatch, rows, env, route):
    """rows <= 16 (or WTPU_DENSE_ROWS_MIN) keep the packed tree, on K6's
    layout under WTPU_FEWROW_MBT=1; more rows unfuse and dequantize once.
    The JAX policy takes the same route on the same tree."""
    jq_tree, tparams = _quant_pair(tiny)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    out = tq.maybe_dense_decode_params(tparams, rows, dtype=torch.float32)
    jout = jq.maybe_dense_decode_params(jq_tree, rows, dtype=jnp.float32)
    attn = out["decoder"]["blocks"][0]["attn"]
    if route == "packed":
        assert out is tparams and jout is jq_tree
    elif route == "mbt":
        assert isinstance(attn["qkv"]["w"], tmb.QuantTensorT)
        assert type(jout["decoder"]["blocks"][0]["attn"]["qkv"]["w"]).__name__ == "QuantTensorT"
        assert isinstance(out["decoder"]["token_emb"], tq.QuantTensor)  # the table stays packed
        np.testing.assert_array_equal(attn["qkv"]["w"].dequantize(torch.float32).numpy(),
                                      tparams["decoder"]["blocks"][0]["attn"]["qkv"]["w"]
                                      .dequantize().numpy())
    else:
        assert not _is_quant(out) and sorted(attn) == ["k", "o", "q", "v"]
        assert "b" not in attn["k"] and attn["q"]["w"].dtype == torch.float32
        _assert_same_tree(out, jout)  # the dense trees agree leaf for leaf
    assert tq.maybe_dense_decode_params(tparams, rows, dtype=torch.float32) is out  # cached


def test_decode_policy_cache_is_bounded_and_keyed_by_identity(tiny):
    _, tparams = _quant_pair(tiny)
    fp = tiny[2]
    assert tq.maybe_dense_decode_params(fp, 64) is fp  # nothing packed: untouched, uncached
    assert not tq._DENSE_DECODE_CACHE
    trees = [dict(tparams) for _ in range(4)]
    outs = [tq.maybe_dense_decode_params(t, 64, dtype=torch.float32) for t in trees]
    assert len(tq._DENSE_DECODE_CACHE) <= 3  # cleared above 2 entries before the next one
    assert tq.maybe_dense_decode_params(trees[3], 64, dtype=torch.float32) is outs[3]
    assert tq.maybe_dense_decode_params(trees[0], 64, dtype=torch.float32) is not outs[0]


def test_decode_reuses_one_conversion_across_the_ladder(tiny, monkeypatch):
    """decode() asks the policy with windows x (beam_size or best_of or 1)
    rows; the best_of rungs of the fallback ladder share one conversion."""
    _, _, _, tcfg, mel = tiny
    _, tparams = _quant_pair(tiny)
    tok = t_tokenizer.make_synthetic_tokenizer()
    seen = []
    unfuse = tq.unfuse_whisper_qkv  # the dense conversion's first step
    monkeypatch.setattr(tq, "unfuse_whisper_qkv", lambda p: seen.append(1) or unfuse(p))
    states = tw.encode(tparams, torch.from_numpy(np.repeat(mel, 4, 0)), tcfg)
    for t in (0.2, 0.4):  # 4 windows x best_of 5 = 20 rows
        opts = t_task.DecodingOptions(sample_len=4, temperature=t, best_of=5)
        t_task.decode(tparams, states, tok, tcfg, opts, states_precomputed=True,
                      generator=torch.Generator().manual_seed(0))
    assert len(seen) == 1
    t_task.decode(tparams, states, tok, tcfg, t_task.DecodingOptions(sample_len=4),
                  states_precomputed=True)  # 4 rows: packed, no conversion
    assert len(seen) == 1


@pytest.mark.parametrize("kv_bits,self_kv_bits", [(0, 0), (4, 8)])
def test_decode_greedy_token_identical_to_jax(tiny, kv_bits, self_kv_bits):
    _, jcfg, _, tcfg, mel = tiny
    jq_tree, tparams = _quant_pair(tiny)
    jcfg = dataclasses.replace(jcfg, kv_bits=kv_bits, self_kv_bits=self_kv_bits)
    tcfg = dataclasses.replace(tcfg, kv_bits=kv_bits, self_kv_bits=self_kv_bits)
    ref = j_task.decode(jq_tree, jnp.asarray(mel), j_tokenizer.make_synthetic_tokenizer(), jcfg,
                        j_task.DecodingOptions(sample_len=24))
    got = t_task.decode(tparams, torch.from_numpy(mel), t_tokenizer.make_synthetic_tokenizer(),
                        tcfg, t_task.DecodingOptions(sample_len=24))
    assert got[0].tokens == ref[0].tokens and got[0].tokens
    np.testing.assert_allclose(got[0].avg_logprob, ref[0].avg_logprob, atol=1e-4)


def test_decode_fewrow_mbt_token_identical(tiny, monkeypatch):
    """WTPU_FEWROW_MBT=1: the few-row decode runs K6's function on the
    transposed tree and emits the packed tree's tokens, and JAX's."""
    _, jcfg, _, tcfg, mel = tiny
    jq_tree, tparams = _quant_pair(tiny)
    tok = t_tokenizer.make_synthetic_tokenizer()
    opts = t_task.DecodingOptions(sample_len=12)
    packed = t_task.decode(tparams, torch.from_numpy(mel), tok, tcfg, opts)
    monkeypatch.setenv("WTPU_FEWROW_MBT", "1")
    calls = []
    plain = tmb.quant_matmul_mbt_plain
    monkeypatch.setattr(tmb, "quant_matmul_mbt_plain", lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    got = t_task.decode(tparams, torch.from_numpy(mel), tok, tcfg, opts)
    ref = j_task.decode(jq_tree, jnp.asarray(mel), j_tokenizer.make_synthetic_tokenizer(), jcfg,
                        j_task.DecodingOptions(sample_len=12))
    assert calls
    assert got[0].tokens == packed[0].tokens == ref[0].tokens


def test_decode_beam_dense_route_token_identical_to_jax(tiny):
    """Beam 5 on 4 windows: 20 rows, so both packages unfuse and dequantize
    the tree once and decode on dense weights."""
    _, jcfg, _, tcfg, mel = tiny
    jq_tree, tparams = _quant_pair(tiny)
    rng = np.random.default_rng(3)
    mel4 = np.concatenate([mel, mel + 0.05 * rng.standard_normal((3, *mel.shape[1:]))
                           .astype(np.float32)])
    ref = j_task.decode(jq_tree, jnp.asarray(mel4), j_tokenizer.make_synthetic_tokenizer(), jcfg,
                        j_task.DecodingOptions(sample_len=12, beam_size=5))
    got = t_task.decode(tparams, torch.from_numpy(mel4), t_tokenizer.make_synthetic_tokenizer(),
                        tcfg, t_task.DecodingOptions(sample_len=12, beam_size=5))
    assert len(tq._DENSE_DECODE_CACHE) == 1
    assert [r.tokens for r in got] == [r.tokens for r in ref]
    np.testing.assert_allclose([r.avg_logprob for r in got], [r.avg_logprob for r in ref],
                               atol=1e-4)


def test_transcribe_quantized_matches_jax(tiny, tmp_path):
    _, jcfg, _, tcfg, _ = tiny
    jq_tree, tparams = _quant_pair(tiny)
    wav = tmp_path / "in.wav"
    _write_wav(wav, make_speechy_audio(35.0, seed=2))
    kw = dict(temperature=0.0, verbose=False, condition_on_previous_text=False, sample_len=24)
    ref = j_transcribe(str(wav), params=jq_tree, config=jcfg,
                       tokenizer=j_tokenizer.make_synthetic_tokenizer(), **kw)
    got = t_transcribe(str(wav), params=tparams, config=tcfg,
                       tokenizer=t_tokenizer.make_synthetic_tokenizer(), device="cpu", **kw)
    assert got["text"] == ref["text"] and len(got["segments"]) == len(ref["segments"]) > 0
    for g, r in zip(got["segments"], ref["segments"]):
        assert g["tokens"] == r["tokens"]


def test_serving_config_leaves_quantized_leaves(tiny, monkeypatch):
    """The bf16 cast walks past QuantTensors (fp32 scales and biases stay)
    and casts the fused bias with the other float leaves, as in JAX."""
    _, jcfg, _, tcfg, _ = tiny
    jq_tree, tparams = _quant_pair(tiny)
    monkeypatch.setenv("WTPU_SERVE_PRECISION", "bfloat16")
    served, cfg = t_serving(tparams, tcfg, "cpu")
    jserved, _ = j_serving(jq_tree, jcfg)
    attn, jattn = (t["decoder"]["blocks"][0]["attn"] for t in (served, jserved))
    assert cfg.dtype == torch.bfloat16
    assert attn["qkv"]["w"] is tparams["decoder"]["blocks"][0]["attn"]["qkv"]["w"]
    assert attn["qkv"]["w"].scales.dtype == torch.float32
    assert attn["qkv"]["b"].dtype == torch.bfloat16 and jattn["qkv"]["b"].dtype == jnp.bfloat16
    assert served["decoder"]["blocks"][0]["attn_ln"]["g"].dtype == torch.bfloat16
    assert served["decoder"]["token_emb"] is tparams["decoder"]["token_emb"]
