"""Port parity: the W8A8 weights and kernel K7's plain version
(whisper_mlx_tpu_torch/ops/quant_a8.py), prepare_a8_params, the quant_matmul
dispatch and the WTPU_QWEN_A8 engine against the JAX package on the CPU.

requant_a8's codes and scales are bit-identical to the reference's. The
matmul is compared with the reference's Pallas kernel in interpret mode at
the tolerance of tests/test_pallas_kernels.py (rtol 2e-5, atol 1e-5: the
int32 sums are exact, only the two fp32 scale products round).

Off the TPU the reference computes an A8Tensor linear by dequantize +
matmul, which skips the activation quantization; the port's CPU route is
the kernel's function. So the engine test makes the JAX engine take its
TPU route, inside the test only: ``jax.default_backend`` answers "tpu" and
the three Pallas kernels it then reaches run in interpret mode. JAX's jit
caches are cleared before and after, so no trace crosses into other tests.
Its logits bound, 2e-3 * max(1, |ref|), allows an activation code one step
apart where x / sx lands on a .5 tie in one framework and not the other.
"""

from __future__ import annotations

import numpy as np
import pytest

import torch
import jax
import jax.numpy as jnp

from whisper_mlx_tpu.decoding import llm_tokenizer as j_tok
from whisper_mlx_tpu.inference.generate import LLMEngine as JEngine
from whisper_mlx_tpu.models import qwen as jqw
from whisper_mlx_tpu.models.qwen import QwenConfig as JConfig
from whisper_mlx_tpu.models.qwen import init_params as j_init
from whisper_mlx_tpu.ops import quant as jq
from whisper_mlx_tpu.ops import quant_a8 as ja8
from whisper_mlx_tpu.ops import quant_pallas as jqp
from whisper_mlx_tpu.ops import quant_pallas_mb as jmb
from whisper_mlx_tpu_torch.checkpoint.convert import _qwen_leaf, qwen_params_from_jax
from whisper_mlx_tpu_torch.decoding import llm_tokenizer as t_tok
from whisper_mlx_tpu_torch.inference import generate as tg
from whisper_mlx_tpu_torch.models import qwen as tqw
from whisper_mlx_tpu_torch.ops import quant as tq
from whisper_mlx_tpu_torch.ops import quant_a8 as ta8

RTOL, ATOL = 2e-5, 1e-5


def _port(q: "jq.QuantTensor") -> tq.QuantTensor:
    return tq.QuantTensor(torch.from_numpy(np.asarray(q.w_q).view(np.int32).copy()),
                          torch.from_numpy(np.array(q.scales, np.float32)),
                          torch.from_numpy(np.array(q.biases, np.float32)),
                          q.bits, q.group_size)


def _jq(rng, n, k, bits=4) -> "jq.QuantTensor":
    w_q, s, b = jq.quantize(rng.standard_normal((n, k)).astype(np.float32), bits, 64)
    return jq.QuantTensor(jnp.asarray(w_q), jnp.asarray(s), jnp.asarray(b), bits, 64)


@pytest.fixture(autouse=True)
def _reference_env(monkeypatch):
    for name in ("WTPU_A8_CHUNK_ROWS", "WTPU_A8_MAX_VMEM_MB", "WTPU_A8_MAX_N", "WTPU_A8_SKIP",
                 "WTPU_A8_FREE_SRC", "WTPU_A8_XLA", "WTPU_QWEN_A8", "WTPU_MBT_RESIDENT",
                 "WTPU_QMM_MB", "WTPU_QMM_PALLAS_MAX_ROWS"):
        monkeypatch.delenv(name, raising=False)


# ---------------------------------------------------------------------------
# the weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", ["0", "64", "16384"], ids=["whole", "chunked", "default"])
@pytest.mark.parametrize("bits", [4, 8])
def test_requant_a8_bit_identical(monkeypatch, chunk, bits):
    """Codes and scales equal the reference's bit for bit, converted whole
    or 64 rows at a time (300 = 4 x 64 + 44: a ragged last chunk)."""
    monkeypatch.setenv("WTPU_A8_CHUNK_ROWS", chunk)
    q = _jq(np.random.default_rng(bits), 300, 256, bits)
    ref = ja8.requant_a8(q, tile_n=128, depth=2)
    got = ta8.requant_a8(_port(q), tile_n=128, depth=2)
    assert got.shape == ref.shape == (300, 256) and got.n_orig == ref.n_orig
    assert got.codes.dtype == torch.int8 and got.codes.shape == (300, 256)
    np.testing.assert_array_equal(got._codes_2d().numpy(), np.asarray(ref._codes_2d()))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale)[0, :300])
    np.testing.assert_array_equal(got.dequantize().numpy(), np.asarray(ref.dequantize()))


def test_requant_a8_of_fp_weights_matches_jax():
    w = np.random.default_rng(1).standard_normal((70, 128)).astype(np.float32)
    w[3] = 0.0  # an all-zero row: scale 1e-12 / 127
    ref = ja8.requant_a8(w, tile_n=128)
    got = ta8.requant_a8(torch.from_numpy(w), tile_n=128)
    np.testing.assert_array_equal(got._codes_2d().numpy(), np.asarray(ref._codes_2d()))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale)[0, :70])


# ---------------------------------------------------------------------------
# the matmul: plain version against the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,k,rows,tile,depth", [
    (192, 128, (1,), 128, 2),
    (320, 256, (4,), 128, 2),
    (128, 128, (9,), 128, 2),
    (200, 128, (2, 3), 128, 4),  # lead dims, ragged N (pads to 256)
    (70, 256, (17,), 64, 3),
])
def test_a8_plain_matches_pallas(n, k, rows, tile, depth):
    rng = np.random.default_rng(n + k)
    q = _jq(rng, n, k)
    jat = ja8.requant_a8(q, tile_n=tile, depth=depth)
    tat = ta8.requant_a8(_port(q), tile_n=tile, depth=depth)
    x = rng.standard_normal((*rows, k)).astype(np.float32)
    ref = np.asarray(ja8.a8_matmul(jnp.asarray(x), jat, interpret=True))
    got = ta8.a8_matmul(torch.from_numpy(x), tat)
    assert got.dtype == torch.float32 and got.shape == (*rows, n)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_a8_plain_matches_pallas_bf16():
    """bf16 x: quantized from its fp32 value, the result cast once."""
    rng = np.random.default_rng(3)
    q = _jq(rng, 200, 256)
    jat, tat = ja8.requant_a8(q, tile_n=128), ta8.requant_a8(_port(q), tile_n=128)
    x = rng.standard_normal((3, 256)).astype(np.float32)
    ref = np.asarray(ja8.a8_matmul(jnp.asarray(x, jnp.bfloat16), jat, interpret=True)
                     .astype(jnp.float32))
    got = ta8.a8_matmul(torch.from_numpy(x).to(torch.bfloat16), tat)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, atol=1e-2 * max(1.0, np.abs(ref).max()),
                               rtol=0)


def test_a8_footprint_route_matches_jax(monkeypatch):
    """The reference's VMEM rule decides the function: under a 0.06 MB bound
    8 rows take the kernel (activations quantized) and 64 rows take
    dequantize + matmul (not quantized), in the port as in JAX."""
    monkeypatch.setenv("WTPU_A8_MAX_VMEM_MB", "0.06")
    rng = np.random.default_rng(4)
    q = _jq(rng, 256, 128)
    jat, tat = ja8.requant_a8(q, tile_n=128, depth=2), ta8.requant_a8(_port(q), tile_n=128,
                                                                       depth=2)
    calls = []
    orig = ta8.a8_matmul_plain
    monkeypatch.setattr(ta8, "a8_matmul_plain", lambda *a: calls.append(1) or orig(*a))
    for m, kernel in ((8, True), (64, False)):
        assert ta8.a8_fits(tat, m) == kernel
        x = rng.standard_normal((m, 128)).astype(np.float32)
        ref = np.asarray(ja8.a8_matmul(jnp.asarray(x), jat, interpret=True))
        calls.clear()
        got = ta8.a8_matmul(torch.from_numpy(x), tat).numpy()
        assert bool(calls) == kernel
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
        # the two routes are different functions: a wrong route would show
        other = orig(torch.from_numpy(x), tat).numpy() if not kernel else \
            (torch.from_numpy(x) @ tat.dequantize().T).numpy()
        assert np.abs(other - ref).max() > 10 * (ATOL + RTOL * np.abs(ref).max())


def _meta_a8(n: int, k: int) -> ta8.A8Tensor:
    return ta8.A8Tensor(torch.empty((n, k), dtype=torch.int8, device="meta"),
                        torch.empty((n,), device="meta"), tile_n=512, depth=4)


@pytest.mark.parametrize("rows,kernel", [
    (384, {"qkv": True, "o": True, "gate_up": False, "down": False, "lm_head": False}),
    (1, {"qkv": True, "o": True, "gate_up": True, "down": False, "lm_head": True}),
])
def test_a8_footprint_route_at_qwen3_32b(rows, kernel):
    """Qwen3-32B's linears (prepare_a8_params' tile 512, depth 4): at the
    384-row prefill qkv and o take the kernel and gate_up (78.6 MB), down
    (60 MB) and the head dequantize; at decode only down (52.4 MB of code
    slabs: depth x K x tile_n) leaves the kernel."""
    shapes = {"qkv": (10240, 5120), "o": (5120, 8192), "gate_up": (51200, 5120),
              "down": (5120, 25600), "lm_head": (151936, 5120)}
    assert {name: ta8.a8_fits(_meta_a8(*nk), rows) for name, nk in shapes.items()} == kernel


@pytest.mark.parametrize("rows,kernel", [(512, True), (513, False)])
def test_quant_matmul_dispatch_a8(monkeypatch, rows, kernel):
    """At most 512 rows go to a8_matmul (kernel K7 where the VMEM rule
    allows); more rows dequantize + matmul, the reference's policy."""
    monkeypatch.setenv("WTPU_A8_MAX_VMEM_MB", "1000")
    rng = np.random.default_rng(5)
    at = ta8.requant_a8(_port(_jq(rng, 72, 128)), tile_n=64)
    calls = []
    orig = ta8.a8_matmul_plain
    monkeypatch.setattr(ta8, "a8_matmul_plain", lambda *a: calls.append(1) or orig(*a))
    x = torch.from_numpy(rng.standard_normal((rows, 128)).astype(np.float32))
    got = tq.quant_matmul(x, at)
    assert bool(calls) == kernel
    want = orig(x, at) if kernel else x @ at.dequantize().T
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# prepare_a8_params and the converter
# ---------------------------------------------------------------------------


def _types(tree):
    if isinstance(tree, dict):
        return {k: _types(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_types(v) for v in tree]
    return type(tree).__name__


def _port_tree(node):
    if isinstance(node, jq.QuantTensor):
        return _port(node)
    if isinstance(node, dict):
        return {k: _port_tree(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_port_tree(v) for v in node]
    return node


@pytest.mark.parametrize("env,kw", [
    ({}, {}),
    ({"WTPU_A8_SKIP": "down"}, {}),
    ({"WTPU_A8_SKIP": "down,wq"}, {}),
    ({"WTPU_A8_MAX_N": "200"}, {}),
    ({}, {"max_n": 200, "skip_keys": ("qkv",)}),
])
def test_prepare_a8_params_policies_match_jax(monkeypatch, env, kw):
    """Embeddings stay packed; a skipped linear is matched by its own key
    ({"down": {"w": ...}} and a bare {"wq": ...}); max_n keeps wide heads
    packed. The converted leaves equal the reference's."""
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    rng = np.random.default_rng(6)
    jtree = {"embed": _jq(rng, 256, 128),
             "layers": [{"mlp": {"gate_up": {"w": _jq(rng, 256, 128)},
                                 "down": {"w": _jq(rng, 128, 256)}},
                         "attn": {"qkv": {"w": _jq(rng, 192, 128)}, "wq": _jq(rng, 128, 128)}}]}
    ref = ja8.prepare_a8_params(jtree, tile_n=128, **kw)
    got = ta8.prepare_a8_params(_port_tree(jtree), tile_n=128, **kw)
    assert _types(got) == _types(ref)
    up, rup = got["layers"][0]["mlp"]["gate_up"]["w"], ref["layers"][0]["mlp"]["gate_up"]["w"]
    if isinstance(up, ta8.A8Tensor):
        np.testing.assert_array_equal(up._codes_2d().numpy(), np.asarray(rup._codes_2d()))


def test_prepare_a8_free_source_frees_and_protects_tied():
    """free_source frees each packed source's storage after its conversion
    but never storage reachable under an embedding key (a tied head)."""
    def owned(q):  # storage torch owns (torch.from_numpy's is numpy's and stays)
        return tq.QuantTensor(q.w_q.clone(), q.scales.clone(), q.biases.clone(), 4, 64)

    rng = np.random.default_rng(7)
    tied, lin = owned(_port(_jq(rng, 256, 128))), owned(_port(_jq(rng, 128, 128)))
    tree = {"embed": tied, "head": tied, "layers": [{"wq": lin}]}
    out = ta8.prepare_a8_params(tree, tile_n=128, free_source=True)
    assert isinstance(out["head"], ta8.A8Tensor) and out["embed"] is tied
    assert all(t.untyped_storage().size() > 0 for t in (tied.w_q, tied.scales, tied.biases))
    assert all(t.untyped_storage().size() == 0 for t in (lin.w_q, lin.scales, lin.biases))
    ref = ta8.requant_a8(_port(_jq(np.random.default_rng(7), 256, 128)), tile_n=128)
    assert torch.equal(out["head"].codes, ref.codes)
    assert out["layers"][0]["wq"].dequantize().shape == (128, 128)
    kept = ta8.prepare_a8_params({"layers": [{"wq": tied}]}, tile_n=128, free_source=False)
    assert isinstance(kept["layers"][0]["wq"], ta8.A8Tensor) and tied.w_q.numel() > 0
    numpy_owned = _port(_jq(rng, 128, 128))
    ta8.prepare_a8_params({"wq": numpy_owned}, tile_n=128, free_source=True)
    assert numpy_owned.w_q.untyped_storage().size() > 0


@pytest.mark.parametrize("contig", [True, False])
def test_converter_takes_jax_a8_leaves(contig):
    rng = np.random.default_rng(8)
    jat = ja8.requant_a8(_jq(rng, 200, 128), tile_n=128, depth=3, contig=contig)
    got = _qwen_leaf(jax.tree.map(np.asarray, jat), "w", "cpu", torch.float32, True)
    assert isinstance(got, ta8.A8Tensor) and got.shape == (200, 128)
    assert (got.tile_n, got.depth) == (128, 3)
    np.testing.assert_array_equal(got.dequantize().numpy(), np.asarray(jat.dequantize()))
    np.testing.assert_array_equal(got._codes_2d().numpy(), np.asarray(jat._codes_2d()))
    x = rng.standard_normal((2, 128)).astype(np.float32)
    np.testing.assert_allclose(ta8.a8_matmul(torch.from_numpy(x), got).numpy(),
                               np.asarray(ja8.a8_matmul(jnp.asarray(x), jat, interpret=True)),
                               rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the engine under WTPU_QWEN_A8=1, against JAX's engine on its TPU route
# ---------------------------------------------------------------------------

DIMS = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, rope_theta=10_000.0,
            tie_word_embeddings=True, attention_bias=True)
PROMPTS = [("abc", 10), ("The quick brown fox", 16), ("<|im_start|>user\nhi<|im_end|>\n", 12)]


@pytest.fixture
def jax_tpu_route(monkeypatch):
    """JAX's quant_matmul takes its TPU branches, the kernels interpreted."""
    jax.clear_caches()
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    a8, mbt, k5 = ja8.a8_matmul, jmb.quant_matmul_mbt, jqp.quant_matmul_pallas
    monkeypatch.setattr(ja8, "a8_matmul", lambda x, at, interpret=False: a8(x, at, True))
    monkeypatch.setattr(jmb, "quant_matmul_mbt",
                        lambda x, qt, tile_n=None, depth=None, interpret=False:
                        mbt(x, qt, tile_n=tile_n, depth=depth, interpret=True))
    monkeypatch.setattr(jqp, "quant_matmul_pallas",
                        lambda x, q, **kw: k5(x, q, **{**kw, "interpret": True}))
    yield
    jax.clear_caches()


def _a8_tree(jcfg):
    """Random init with 4-bit layers and a 4-bit tied embedding (which stays
    packed: its gather and the tied head, kernel K5, read it)."""
    params = jax.tree.map(np.asarray, j_init(jcfg, seed=0))
    layers = jq.quantize_params({"encoder": {"layers": params["layers"]}, "decoder": {}},
                                bits=4, group_size=64)["encoder"]["layers"]
    w_q, s, b = jq.quantize(params["embed"], 4, 64)
    embed = jq.QuantTensor(jnp.asarray(w_q), jnp.asarray(s), jnp.asarray(b), 4, 64)
    return dict(params, layers=layers, embed=embed)


def test_a8_engine_matches_jax_tpu_route(jax_tpu_route, monkeypatch):
    """The port's engine under WTPU_QWEN_A8=1 emits the tokens of JAX's
    engine on its TPU route at T=0, with prefill and decode logits within
    2e-3 * max(1, |ref|); the batch engine gives the single-request tokens."""
    tok = j_tok.ByteFallbackTokenizer()
    jcfg = JConfig(vocab_size=tok.vocab_size, **DIMS)
    tcfg = tqw.QwenConfig(vocab_size=tok.vocab_size, **DIMS)
    jtree = _a8_tree(jcfg)
    tparams = qwen_params_from_jax(jax.tree.map(np.asarray, jtree), tcfg)
    monkeypatch.setenv("WTPU_QWEN_A8", "1")
    jeng = JEngine(jtree, jcfg, tok, max_context=192)
    teng = tg.LLMEngine(tparams, tcfg, t_tok.ByteFallbackTokenizer(), max_context=192)
    assert _types(teng.params)["layers"][1]["mlp"]["down"]["w"] == "A8Tensor"
    assert isinstance(teng.params["embed"], tq.QuantTensor)

    prompt = np.random.default_rng(9).integers(0, tok.vocab_size, (2, 9)).astype(np.int32)
    steps = np.random.default_rng(10).integers(0, tok.vocab_size, (3, 2, 1)).astype(np.int32)
    jcache, tcache = jqw.init_kv_cache(jcfg, 2, 32), tqw.init_kv_cache(tcfg, 2, 32)
    ref, jcache = jqw.decode_step(jeng.params, jnp.asarray(prompt), jnp.int32(0), jcache, jcfg)
    got, tcache = tqw.decode_step(teng.params, torch.from_numpy(prompt).long(), 0, tcache, tcfg)
    pairs = [(np.asarray(ref), got.numpy())]
    for i, t in enumerate(steps):
        ref, jcache = jqw.decode_step(jeng.params, jnp.asarray(t), jnp.int32(9 + i), jcache, jcfg)
        got, tcache = tqw.decode_step(teng.params, torch.from_numpy(t).long(), 9 + i, tcache,
                                      tcfg)
        pairs.append((np.asarray(ref), got.numpy()))
    for ref, got in pairs:
        np.testing.assert_allclose(got, ref, atol=2e-3 * max(1.0, np.abs(ref).max()), rtol=0)

    for text, max_tokens in PROMPTS:
        want = jeng.generate(text, max_tokens=max_tokens, temperature=0.0)
        got = teng.generate(text, max_tokens=max_tokens, temperature=0.0)
        assert got.tokens == want.tokens and got.text == want.text
    batch = teng.continuous(2)
    try:
        handles = [batch.submit(text, max_tokens=m, temperature=0.0) for text, m in PROMPTS]
        for (text, m), h in zip(PROMPTS, handles):
            assert list(h.tokens()) == teng.generate(text, max_tokens=m, temperature=0.0).tokens
    finally:
        batch.close()


def test_a8_then_mbt_when_both_are_set(monkeypatch):
    """WTPU_QWEN_A8 converts first and WTPU_MBT_RESIDENT then finds no packed
    linear: A8 wins, as in the reference; WTPU_A8_SKIP leaves a linear to
    the transposed layout."""
    tok = j_tok.ByteFallbackTokenizer()
    tcfg = tqw.QwenConfig(vocab_size=tok.vocab_size, **DIMS)
    tparams = qwen_params_from_jax(
        jax.tree.map(np.asarray, _a8_tree(JConfig(vocab_size=tok.vocab_size, **DIMS))), tcfg)
    monkeypatch.setenv("WTPU_QWEN_A8", "1")
    monkeypatch.setenv("WTPU_MBT_RESIDENT", "1")
    monkeypatch.setenv("WTPU_A8_SKIP", "down")
    eng = tg.LLMEngine(tparams, tcfg, t_tok.ByteFallbackTokenizer(), max_context=192)
    mlp = _types(eng.params)["layers"][0]["mlp"]
    assert (mlp["up"]["w"], mlp["down"]["w"]) == ("A8Tensor", "QuantTensorT")
    assert _types(eng.params)["embed"] == "QuantTensor"
    out = eng.generate("abc", max_tokens=6, temperature=0.0)
    assert out.generation_tokens > 0


# the linears K7 runs at decode: Qwen3-32B's fused qkv, o, fused gate_up,
# down (the VMEM rule sends it to dequantize + matmul at the defaults, but a
# smaller depth keeps it on the kernel) and the head
K7_SHAPES = [(10240, 5120), (5120, 8192), (51200, 5120), (5120, 25600), (151936, 5120)]


@pytest.mark.parametrize("n,k", K7_SHAPES + [(200, 96), (130, 256), (1000, 1024)])
def test_a8_gemv_plan_covers_every_chunk_once(n, k):
    """The fused GEMV's launch plan on a 132-SM card, at 1 to 8 rows: the
    cluster's blocks take every 256-k chunk exactly once, a cluster holds 1
    to 8 blocks, the ring two stages, x's rows and the block's shared
    memory fit."""
    chunks = -(-k // ta8._KC)
    for m in range(1, 9):
        cluster, stages = ta8.a8_gemv_plan(m, n, k, 132)
        assert 1 <= cluster <= 8 and cluster <= chunks and stages == 2
        covered = np.zeros(chunks, np.int64)
        for rank in range(cluster):
            first, last = rank * chunks // cluster, (rank + 1) * chunks // cluster
            assert last > first
            covered[first:last] += 1
        assert (covered == 1).all()
        kcap = -(-chunks // cluster) * ta8._KC
        assert m * (kcap + 16) <= ta8._XCAP
        assert ta8._gemv_smem(stages, m, kcap) <= ta8._SMEM_TWO_A_SM
        # the cheapest split: fewest waves of 264 blocks x (chunks a block + 1)
        cost = [-(-(-(-n // 128)) * c // 264) * (-(-chunks // c) + 1)
                for c in range(1, min(8, chunks) + 1) if m * (-(-chunks // c) * ta8._KC + 16) <= ta8._XCAP]
        assert -(-(-(-n // 128)) * cluster // 264) * (-(-chunks // cluster) + 1) == min(cost)


def test_a8_plain_divides_truly():
    """The plain version's activation scale is amax / 127 as a true
    division (the kernel's __fdiv_rn), not a product with 1/127: on CPU
    tensors both agree, so the plain output keeps its values."""
    x = torch.randn((64, 256), generator=torch.Generator().manual_seed(5))
    amax = x.abs().amax(dim=-1, keepdim=True)
    assert torch.equal(torch.clamp(amax, min=1e-8) / torch.full_like(amax, 127.0),
                       torch.clamp(amax, min=1e-8) / 127.0)


# the tiled GEMM's row counts: every edge of its 16-, 32-, 64- and 128-row
# blocks, the prefill lengths, and past 512 rows (the VMEM rule admits qkv
# to about 810 rows and o to about 1,090)
A8_TILED_M = [9, 16, 17, 31, 32, 33, 63, 64, 65, 127, 128, 129, 295, 384, 511, 512, 513,
              810, 1000, 1090]


@pytest.mark.parametrize("n,k", K7_SHAPES + [(200, 320), (130, 2112), (1000, 64), (33, 192)])
def test_a8_tiled_plan_covers_every_unit_once(n, k):
    """The tiled GEMM's launch plan on a 132-SM card above 8 rows: blocks
    of 16, 32 or 64 rows up to 128 rows, then 128, every row and channel in
    one block, each block of a cluster at least one 128-k stage and the
    cluster every stage once, clusters of 1, 2, 4 or 8 only (none of
    128-row blocks), the deepest ring (2-8 stages) and the cluster sum
    within a block's 227 KB of shared memory, and the cheapest split by
    the plan's own cost."""
    units = -(-k // 128)
    for m in A8_TILED_M:
        p = ta8.a8_tiled_plan(m, n, k, 132)
        assert p.nt == (16 if m <= 16 else 32 if m <= 32 else 64 if m <= 128 else 128)
        assert p.cols == (256 if p.nt == 128 else 128) and p.units == units
        assert (p.row_blocks - 1) * p.nt < m <= p.row_blocks * p.nt
        assert (p.col_blocks - 1) * p.cols < n <= p.col_blocks * p.cols
        split = p.cluster
        assert split in (1, 2, 4, 8) and split <= units
        covered = np.zeros(units, np.int64)
        for rank in range(split):
            first, last = rank * units // split, (rank + 1) * units // split
            assert last > first
            covered[first:last] += 1
        assert (covered == 1).all()
        assert 2 <= p.stages <= 8 and p.stages == (4 if p.nt == 128 else 8)
        assert p.smem == ta8._tiled_smem(p.nt, p.stages)[0] <= 227 * 1024
        if p.stages < 8:  # the deepest ring that fits
            assert ta8._tiled_smem(p.nt, p.stages + 1)[0] > 227 * 1024
        if split > 1:  # the cluster's sums: every block's chunks, through the ring
            assert 4 * p.cols * p.nt <= ta8._tiled_smem(p.nt, p.stages)[1]
        blocks = p.row_blocks * p.col_blocks
        charge = ta8.TILED_SPLIT_COST
        cost = {c: -(-blocks * c // 132) * (-(-units // c) + 1 + (charge if c > 1 else 0))
                for c in ((1, 2, 4, 8) if p.nt < 128 else (1,)) if c <= units}
        assert cost[split] == min(cost.values())
        assert min(c for c in cost if cost[c] == min(cost.values())) == split


@pytest.mark.parametrize("m,k", [(8, 512), (9, 96), (100, 100)])
def test_a8_tiled_plan_refuses_gemv_shapes(m, k):
    """At most 8 rows, or K not a multiple of 64, is the fused GEMV's."""
    with pytest.raises(ValueError):
        ta8.a8_tiled_plan(m, 256, k, 132)


@pytest.mark.parametrize("rows", [1, 384])
def test_a8_route_counters(monkeypatch, rows):
    """On the CPU the wrapper runs the plain version and counts no kernel
    launch; the VMEM rule's and the row bound's dequantize + matmul calls
    are counted by route."""
    at = ta8.requant_a8(torch.randn((51200 // 8, 512)), tile_n=512, depth=4)
    monkeypatch.setenv("WTPU_A8_MAX_VMEM_MB", "1")
    before = (ta8.LAUNCHES, ta8.TILED_LAUNCHES, ta8.VMEM_DEQUANT_CALLS, ta8.ROWS_DEQUANT_CALLS)
    x = torch.randn((rows, 512))
    out = ta8.a8_matmul(x, at)
    assert torch.equal(out, torch.matmul(x, at.dequantize(x.dtype).T))
    assert (ta8.LAUNCHES, ta8.TILED_LAUNCHES, ta8.VMEM_DEQUANT_CALLS - 1,
            ta8.ROWS_DEQUANT_CALLS) == before
    monkeypatch.delenv("WTPU_A8_MAX_VMEM_MB")
    tq.quant_matmul(torch.randn((513, 512)), at)
    assert ta8.ROWS_DEQUANT_CALLS == before[3] + 1
