"""Port parity: the LLM engine of whisper_mlx_tpu_torch (generate, stream,
chat, sampling, continuous batching, the chat model) against the JAX
package on the CPU, on the reference's engine fixture (tests/test_generate.py)
at fp32; plus the copies of jax-free host code and the opt-ins of the
reference that this slice does not port, which must raise."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch  # noqa: F401  (torch before jax, as in the other test files)
import jax  # noqa: F401

from whisper_mlx_tpu.decoding import llm_tokenizer as j_tok
from whisper_mlx_tpu.inference import generate as j_gen
from whisper_mlx_tpu.inference.generate import LLMEngine as JEngine
from whisper_mlx_tpu.models.qwen import QwenConfig as JConfig
from whisper_mlx_tpu.models.qwen import init_params as j_init
from whisper_mlx_tpu.serving import chat as j_chat
from whisper_mlx_tpu_torch.decoding import llm_tokenizer as t_tok
from whisper_mlx_tpu_torch.inference import generate as tg
from whisper_mlx_tpu_torch.inference.batch_engine import ContinuousBatchEngine
from whisper_mlx_tpu_torch.models import qwen as tqw
from whisper_mlx_tpu_torch.serving import chat as t_chat

ROOT = Path(__file__).resolve().parents[1]
DIMS = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, rope_theta=10_000.0,
            tie_word_embeddings=True, attention_bias=True)
PROMPTS = ["hello", "The quick brown fox", "<|im_start|>user\nnaïve café?<|im_end|>\n"]


@pytest.fixture(scope="module")
def engines():
    tok = j_tok.ByteFallbackTokenizer()
    jeng = JEngine(j_init(JConfig(vocab_size=tok.vocab_size, **DIMS), seed=0),
                   JConfig(vocab_size=tok.vocab_size, **DIMS), tok, max_context=256)
    cfg = tqw.QwenConfig(vocab_size=tok.vocab_size, **DIMS)
    teng = tg.LLMEngine(tqw.init_params(cfg, seed=0), cfg, t_tok.ByteFallbackTokenizer(),
                        max_context=256)
    return jeng, teng


@pytest.mark.parametrize("max_tokens", [1, 12, 40])
@pytest.mark.parametrize("prompt", PROMPTS)
def test_generate_greedy_token_identical(engines, prompt, max_tokens):
    jeng, teng = engines
    ref = jeng.generate(prompt, max_tokens=max_tokens, temperature=0.0)
    got = teng.generate(prompt, max_tokens=max_tokens, temperature=0.0)
    assert got.tokens == ref.tokens
    assert (got.text, got.prompt_tokens, got.generation_tokens) == (
        ref.text, ref.prompt_tokens, ref.generation_tokens)
    assert not set(got.tokens) & set(teng._stop_ids())


@pytest.mark.parametrize("prompt", PROMPTS)
def test_stream_matches_generate(engines, prompt):
    _, teng = engines
    full = teng.generate(prompt, max_tokens=24, temperature=0.0)
    streamed = "".join(teng.stream_generate(prompt, max_tokens=24, temperature=0.0))
    # the stream withholds only a trailing incomplete UTF-8 sequence
    assert full.text.startswith(streamed)
    assert set(full.text[len(streamed):]) <= {"�"}


def test_padded_prompt_slots_do_not_change_tokens(engines, monkeypatch):
    """The bucket's padded positions write garbage K/V that generated tokens
    overwrite before the causal mask exposes them: the same tokens come out
    without any padding."""
    _, teng = engines
    ref = teng.generate(PROMPTS[1], max_tokens=40, temperature=0.0).tokens
    monkeypatch.setattr(teng, "PROMPT_BUCKET", 1)
    assert teng.generate(PROMPTS[1], max_tokens=40, temperature=0.0).tokens == ref


def test_chat_matches_jax(engines):
    jeng, teng = engines
    msgs = [{"role": "system", "content": "be brief"}, {"role": "user", "content": "hi"}]
    assert tg.apply_chat_template(msgs) == j_gen.apply_chat_template(msgs)
    got = teng.chat(msgs, max_tokens=8, temperature=0.0)
    assert got.tokens == jeng.chat(msgs, max_tokens=8, temperature=0.0).tokens
    assert got.generation_tokens <= 8


def test_sampling_respects_stops_and_seeds(engines):
    _, teng = engines
    stops = set(teng._stop_ids())
    runs = [teng.generate("xyz", max_tokens=20, temperature=0.8, seed=s) for s in (3, 4)]
    assert not any(set(r.tokens) & stops for r in runs)
    assert runs[0].tokens != runs[1].tokens
    again = teng.generate("xyz", max_tokens=20, temperature=0.8, seed=3)
    assert again.tokens == runs[0].tokens


def test_sample_token_top_k_picks_argmax():
    logits = torch.tensor([[1.0, 5.0, 3.0, 0.0]])
    for seed in range(5):
        gen = torch.Generator().manual_seed(seed)
        assert int(tg.sample_token(logits, gen, 2.0, top_k=1)[0]) == 1


@pytest.mark.parametrize("top_p", [0.3, 0.6, 0.9])
def test_sample_token_top_p_survivors_match_numpy(top_p):
    """The tokens that can be drawn equal the set the reference's filter
    (generate.py:56-66, rendered in numpy here) keeps."""
    rng = np.random.default_rng(int(top_p * 10))
    logits = rng.standard_normal((1, 12)).astype(np.float32) * 2
    srt = np.sort(logits, axis=-1)[:, ::-1]
    p = np.exp(srt - srt.max()) / np.exp(srt - srt.max()).sum()
    cutoff = srt[0, int(np.sum(np.cumsum(p) < top_p))]
    keep = set(np.flatnonzero(logits[0] >= cutoff).tolist())
    gen = torch.Generator().manual_seed(0)
    drawn = {int(tg.sample_token(torch.from_numpy(logits), gen, 1.0, top_p=top_p)[0])
             for _ in range(400)}
    assert drawn == keep


def test_sample_token_per_row_temperatures():
    logits = torch.tensor([[0.0, 3.0, 1.0], [2.0, 0.0, 1.0]])
    gen = torch.Generator().manual_seed(0)
    toks = tg.sample_token(logits, gen, np.array([0.0, 0.0], np.float32))
    assert toks.tolist() == [1, 0]
    mixed = {tuple(tg.sample_token(logits, gen, [0.0, 5.0]).tolist()) for _ in range(50)}
    assert {t[0] for t in mixed} == {1} and len({t[1] for t in mixed}) > 1


# ---------------------------------------------------------------------------
# continuous batching
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def batch(engines):
    _, teng = engines
    eng = ContinuousBatchEngine(teng.params, teng.config, teng.tokenizer, slots=2,
                                max_len=256)
    yield eng
    eng.close()


def test_batch_greedy_matches_single_request(batch, engines):
    """Three requests on two slots (the third admitted when a slot frees)
    each equal the single-request generate, as the reference's test asserts."""
    _, teng = engines
    prompts = ["Hello batching world", "A different prompt", "short"]
    handles = [batch.submit(p, max_tokens=12, temperature=0.0) for p in prompts]
    for p, h in zip(prompts, handles):
        assert list(h.tokens()) == teng.generate(p, max_tokens=12, temperature=0.0).tokens
    assert max(batch._step_occupancy) == 2


def test_batch_mid_flight_admission(batch, engines):
    _, teng = engines
    first = batch.submit("long running request " * 3, max_tokens=40, temperature=0.0)
    it = first.tokens()
    got_first = [next(it) for _ in range(5)]
    second = batch.submit("late arrival", max_tokens=8, temperature=0.0)
    got_second = list(second.tokens())
    got_first.extend(it)
    assert got_first == teng.generate("long running request " * 3, max_tokens=40,
                                      temperature=0.0).tokens
    assert got_second == teng.generate("late arrival", max_tokens=8, temperature=0.0).tokens
    assert len(got_first) == 40 and len(got_second) == 8


def test_batch_stop_token_frees_slot(engines):
    _, teng = engines
    eng = ContinuousBatchEngine(teng.params, teng.config, teng.tokenizer, slots=2,
                                max_len=256, stop_ids={3})
    try:
        out = list(eng.submit("will stop on token 3", max_tokens=200, temperature=0.0).tokens())
        assert 3 not in out
        assert len(list(eng.submit("next", max_tokens=5, temperature=0.0).tokens())) <= 5
    finally:
        eng.close()
    assert not eng.alive


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_batch_worker_death_closes_waiters(engines, monkeypatch):
    """A worker that dies closes every waiter instead of hanging them, and
    re-raises in its thread (the warning pytest reports for that)."""
    _, teng = engines
    eng = ContinuousBatchEngine(teng.params, teng.config, teng.tokenizer, slots=1,
                                max_len=256)

    def boom(*a, **k):
        raise RuntimeError("device lost")

    monkeypatch.setattr(eng, "_batch_step", boom)
    handles = [eng.submit("a", max_tokens=4, temperature=0.0) for _ in range(3)]
    assert [list(h.tokens()) for h in handles] == [[], [], []]
    eng._worker.join(timeout=10)
    assert not eng.alive
    monkeypatch.undo()


def test_batch_text_stream_matches_tokens(batch):
    toks = list(batch.submit("stream text", max_tokens=24, temperature=0.0).tokens())
    streamed = batch.submit("stream text", max_tokens=24, temperature=0.0).result_text()
    full = batch.tokenizer.decode(toks)
    assert full.startswith(streamed) and set(full[len(streamed):]) <= {"�"}


# ---------------------------------------------------------------------------
# the chat model, copies, raises, no jax
# ---------------------------------------------------------------------------


def test_qwen_model_tiny_default_matches_jax_engine(monkeypatch):
    monkeypatch.delenv("QWEN_MODEL_PATH", raising=False)
    monkeypatch.delenv("QWEN_BATCH_SLOTS", raising=False)
    msgs = [{"role": "user", "content": "hi"}]
    ref = j_chat.QwenModel().generate(msgs, max_tokens=10, temperature=0.0)
    model = t_chat.QwenModel(device="cpu")
    assert model.generate(msgs, max_tokens=10, temperature=0.0) == ref
    chunks = []
    assert model.generate(msgs, max_tokens=10, temperature=0.0, on_token=chunks.append) \
        == "".join(chunks)
    monkeypatch.setenv("QWEN_BATCH_SLOTS", "2")
    assert ref.startswith(model.generate(msgs, max_tokens=10, temperature=0.0))
    model.engine.continuous().close()


def test_qwen_model_cuda_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        t_chat.QwenModel(device="cuda")


def test_model_sizes_match():
    assert [(m.value, m.model_id) for m in t_chat.ModelSize] == \
        [(m.value, m.model_id) for m in j_chat.ModelSize]


def test_llm_tokenizer_copy_matches():
    src = (ROOT / "whisper_mlx_tpu/decoding/llm_tokenizer.py").read_text()
    assert (ROOT / "whisper_mlx_tpu_torch/decoding/llm_tokenizer.py").read_text() == src
    jt, tt = j_tok.ByteFallbackTokenizer(), t_tok.ByteFallbackTokenizer()
    text = "<|im_start|>user\nnaïve ☕<|im_end|>"
    assert tt.encode(text) == jt.encode(text)
    assert tt.decode(jt.encode(text)) == text


@pytest.mark.parametrize("name,value,item", [
    ("WTPU_LLM_KV_BITS", "8", "M12"), ("WTPU_NATIVE_RESIDENT", "1", "M15"),
    ("WTPU_MBT_RESIDENT", "1", "K6"), ("WTPU_QWEN_A8", "1", "K7"),
    ("WTPU_QMM_MB", "4,512", "K6"),
])
def test_engine_opt_ins_raise(engines, monkeypatch, name, value, item):
    _, teng = engines
    monkeypatch.setenv(name, value)
    with pytest.raises(NotImplementedError, match=item):
        tg.LLMEngine(teng.params, teng.config, teng.tokenizer)
    with pytest.raises(NotImplementedError, match=item):
        ContinuousBatchEngine(teng.params, teng.config, teng.tokenizer, slots=1)


def test_draft_and_model_env_opt_ins_raise(engines, monkeypatch):
    _, teng = engines
    with pytest.raises(NotImplementedError, match="M11"):
        tg.LLMEngine(teng.params, teng.config, teng.tokenizer, draft=(teng.params, teng.config))
    for name, item in (("QWEN_DRAFT_PATH", "M11"), ("QWEN_SCRIPTED_MODEL", "M13")):
        monkeypatch.setenv(name, "/nonexistent")
        with pytest.raises(NotImplementedError, match=item):
            t_chat.QwenModel(device="cpu").engine
        monkeypatch.delenv(name)


def test_llm_modules_import_without_jax():
    code = ("import sys\n"
            "import whisper_mlx_tpu_torch.serving.chat, whisper_mlx_tpu_torch.inference.generate\n"
            "import whisper_mlx_tpu_torch.inference.batch_engine\n"
            "import whisper_mlx_tpu_torch.checkpoint.qwen_loader, whisper_mlx_tpu_torch.ops.quant\n"
            "import whisper_mlx_tpu_torch.ops.flash_attention\n"
            "bad = [k for k in ('jax', 'triton', 'whisper_mlx_tpu') if k in sys.modules]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr


def test_jax_fixture_is_reference_init():
    """The port's engine fixture holds the reference's random weights."""
    tok = j_tok.ByteFallbackTokenizer()
    ref = j_init(JConfig(vocab_size=tok.vocab_size, **DIMS), seed=0)
    got = tqw.init_params(tqw.QwenConfig(vocab_size=tok.vocab_size, **DIMS), seed=0)
    np.testing.assert_array_equal(got["layers"][1]["mlp"]["down"]["w"].numpy(),
                                  np.asarray(ref["layers"][1]["mlp"]["down"]["w"]).T)
    np.testing.assert_array_equal(got["embed"].numpy(), np.asarray(ref["embed"]))
