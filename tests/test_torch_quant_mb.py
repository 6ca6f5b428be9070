"""Port parity: the transposed weight layout and kernel K6's plain version
(whisper_mlx_tpu_torch/ops/quant_matmul_mb.py), prepare_mbt_params, the
quant_matmul dispatch and the WTPU_MBT_RESIDENT engine against the JAX
package on the CPU.

The layouts dequantize bit-equal to the reference's. The matmul is compared
with the reference's Pallas kernel in interpret mode at the tolerance of
tests/test_pallas_kernels.py (2e-4 absolute and relative in fp32: the port
adds the bias as xg @ b^T in another summation order), and at one bf16 ulp
of the output scale in bf16. The Hopper kernel itself is tested against the
plain version in tests/test_torch_kernels.py.
"""

from __future__ import annotations

import numpy as np
import pytest

import torch  # noqa: F401  (torch before jax, as in the other test files)
import jax
import jax.numpy as jnp

from whisper_mlx_tpu.decoding import llm_tokenizer as j_tok
from whisper_mlx_tpu.inference.generate import LLMEngine as JEngine
from whisper_mlx_tpu.models.qwen import QwenConfig as JConfig
from whisper_mlx_tpu.models.qwen import init_params as j_init
from whisper_mlx_tpu.ops import quant as jq
from whisper_mlx_tpu.ops import quant_pallas_mb as jmb
from whisper_mlx_tpu.ops.quant_a8 import requant_a8 as j_requant_a8
from whisper_mlx_tpu_torch.checkpoint.convert import qwen_params_from_jax
from whisper_mlx_tpu_torch.decoding import llm_tokenizer as t_tok
from whisper_mlx_tpu_torch.inference import generate as tg
from whisper_mlx_tpu_torch.models import qwen as tqw
from whisper_mlx_tpu_torch.ops import quant as tq
from whisper_mlx_tpu_torch.ops import quant_a8 as ta8
from whisper_mlx_tpu_torch.ops import quant_matmul_mb as tmb

TOL = 2e-4


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
    for name in ("WTPU_MBT_DQ", "WTPU_MBT_CONTIG", "WTPU_MBT_TILE", "WTPU_MBT_DEPTH",
                 "WTPU_MBT_I8_MAX_K", "WTPU_MBT_MAX_K", "WTPU_MBT_MAX_N", "WTPU_QMM_MB",
                 "WTPU_MBT_RESIDENT", "WTPU_QWEN_A8", "WTPU_QMM_PALLAS_MAX_ROWS"):
        monkeypatch.delenv(name, raising=False)


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits,codes", [(4, False), (8, False), (4, True)], ids=["w4", "w8", "i8"])
@pytest.mark.parametrize("contig", [False, True], ids=["flat", "contig"])
@pytest.mark.parametrize("n,k", [(384, 128), (200, 256)])
def test_transpose_quant_dequantizes_bit_equal(bits, codes, contig, n, k):
    """Every layout holds the reference's values: dequantize, the unpadded
    words or codes, and the shape."""
    rng = np.random.default_rng(n + k + bits)
    q = _jq(rng, n, k, bits)
    ref = jmb.transpose_quant(q, tile_n=128, depth=2, codes=codes, contig=contig)
    got = tmb.transpose_quant(_port(q), tile_n=128, depth=2, codes=codes, contig=contig)
    assert got.shape == ref.shape == (n, k)
    assert (got.codes_resident, got.contig, got.tile_n, got.depth) == (
        ref.codes_resident, ref.contig, ref.tile_n, ref.depth)
    np.testing.assert_array_equal(got.dequantize(torch.float32).numpy(),
                                  np.asarray(ref.dequantize(jnp.float32)))
    words = got.wqt[:, :n].numpy()  # the port stores every layout flat
    ref_words = np.asarray(ref._wqt_2d())[:, :n]
    np.testing.assert_array_equal(words if codes else words.view(np.uint32), ref_words)
    assert got.wqt.dim() == 2 and got.scalest.shape[1] % 128 == 0  # N padded once, at setup


@pytest.mark.parametrize("env,n,k,bits,want", [
    ({}, 300, 64, 4, (512, 2, False, False)),
    ({}, 16384, 64, 4, (1024, 8, False, False)),
    ({"WTPU_MBT_DQ": "i8"}, 16384, 64, 4, (1024, 4, True, False)),
    ({"WTPU_MBT_DQ": "i8", "WTPU_MBT_I8_MAX_K": "32"}, 16384, 64, 4, (1024, 8, False, False)),
    ({"WTPU_MBT_DQ": "i8"}, 300, 64, 8, (512, 2, False, False)),
    ({"WTPU_MBT_DQ": "u8", "WTPU_MBT_CONTIG": "1"}, 300, 64, 4, (512, 2, False, True)),
    ({"WTPU_MBT_TILE": "256", "WTPU_MBT_DEPTH": "3"}, 300, 64, 4, (256, 3, False, False)),
])
def test_transpose_quant_defaults_and_knobs_match_jax(monkeypatch, env, n, k, bits, want):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    q = _jq(np.random.default_rng(n), n, k, bits)
    ref = jmb.transpose_quant(q)
    got = tmb.transpose_quant(_port(q))
    assert (got.tile_n, got.depth, got.codes_resident, got.contig) == want
    assert (ref.tile_n, ref.depth, ref.codes_resident, ref.contig) == want


def test_transpose_quant_rejects_codes_for_8_bit_and_odd_tiles():
    q = _port(_jq(np.random.default_rng(0), 64, 64, 8))
    with pytest.raises(ValueError, match="4-bit"):
        tmb.transpose_quant(q, codes=True)
    with pytest.raises(ValueError, match="tile_n"):
        tmb.transpose_quant(q, tile_n=100)


# ---------------------------------------------------------------------------
# the matmul: plain version against the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,n,bits,tile,depth,codes,contig", [
    (1, 128, 384, 4, 128, 2, False, False),  # 3 tiles, the ring wraps
    (3, 128, 256, 8, 128, 2, False, False),  # depth == n_tiles
    (2, 128, 200, 4, 128, 2, False, False),  # ragged N
    (3, 256, 200, 4, 128, 2, True, False),  # int8 codes-resident
    (1, 128, 384, 4, 128, 2, False, True),  # contig
    (3, 256, 200, 4, 128, 2, True, True),  # codes-resident and contig
    (2, 128, 200, 8, 128, 3, False, True),  # 8-bit contig
])
def test_mbt_plain_matches_pallas(m, k, n, bits, tile, depth, codes, contig):
    rng = np.random.default_rng(m * n + k)
    q = _jq(rng, n, k, bits)
    jqt = jmb.transpose_quant(q, tile_n=tile, depth=depth, codes=codes, contig=contig)
    tqt = tmb.transpose_quant(_port(q), tile_n=tile, depth=depth, codes=codes, contig=contig)
    x = rng.standard_normal((m, k)).astype(np.float32)
    ref = np.asarray(jmb.quant_matmul_mbt.__wrapped__(jnp.asarray(x), jqt, None, None, True))
    got = tmb.quant_matmul_mbt(torch.from_numpy(x), tqt)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("codes", [False, True], ids=["packed", "i8"])
def test_mbt_plain_matches_pallas_bf16_and_lead_dims(codes):
    """bf16 x with the kernel's rounding points; (2, 3, K) lead dims."""
    rng = np.random.default_rng(7)
    q = _jq(rng, 200, 256)
    jqt = jmb.transpose_quant(q, tile_n=128, depth=2, codes=codes)
    tqt = tmb.transpose_quant(_port(q), tile_n=128, depth=2, codes=codes)
    x = (rng.standard_normal((2, 3, 256)) / 4).astype(np.float32)
    ref = np.asarray(jmb.quant_matmul_mbt.__wrapped__(
        jnp.asarray(x, jnp.bfloat16), jqt, None, None, True).astype(jnp.float32))
    got = tmb.quant_matmul_mbt(torch.from_numpy(x).to(torch.bfloat16), tqt)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 3, 200)
    np.testing.assert_allclose(got.float().numpy(), ref, atol=1e-2 * max(1.0, np.abs(ref).max()),
                               rtol=0)


def test_qmm_mb_opt_in_matches_pallas(monkeypatch):
    """WTPU_QMM_MB="depth,tile_n" sends packed weights through K6, which
    transposes per call; the reference's quant_matmul_mb is the same."""
    rng = np.random.default_rng(8)
    q = _jq(rng, 384, 128)
    x = rng.standard_normal((2, 128)).astype(np.float32)
    ref = np.asarray(jmb.quant_matmul_mb(jnp.asarray(x), q, tile_n=128, depth=2,
                                         interpret=True))
    calls = []
    orig = tmb.quant_matmul_mbt_plain
    monkeypatch.setattr(tmb, "quant_matmul_mbt_plain",
                        lambda x_, qt: calls.append((qt.tile_n, qt.depth)) or orig(x_, qt))
    monkeypatch.setenv("WTPU_QMM_MB", "2,128")
    got = tq.quant_matmul(torch.from_numpy(x), _port(q))
    assert calls == [(128, 2)]
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=TOL)
    monkeypatch.setenv("WTPU_QMM_MB", "3")  # tile_n defaults to 512
    calls.clear()
    tq.quant_matmul(torch.from_numpy(x), _port(q))
    assert calls == [(512, 3)]


@pytest.mark.parametrize("rows,kernel", [(512, True), (513, False)])
def test_quant_matmul_dispatch_transposed(monkeypatch, rows, kernel):
    """At most 512 rows take K6's function; more rows dequantize + matmul,
    the reference's policy; the two agree."""
    rng = np.random.default_rng(9)
    qt = tmb.transpose_quant(_port(_jq(rng, 72, 128)), tile_n=64)
    calls = []
    orig = tmb.quant_matmul_mbt_plain
    monkeypatch.setattr(tmb, "quant_matmul_mbt_plain",
                        lambda *a: calls.append(1) or orig(*a))
    x = torch.from_numpy(rng.standard_normal((rows, 128)).astype(np.float32))
    got = tq.quant_matmul(x, qt)
    assert bool(calls) == kernel
    np.testing.assert_allclose(got.numpy(), (x @ qt.dequantize().T).numpy(), atol=TOL, rtol=TOL)


# ---------------------------------------------------------------------------
# prepare_mbt_params and the converter
# ---------------------------------------------------------------------------


def _types(tree, path=()):
    if isinstance(tree, dict):
        return {k: _types(v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_types(v, path) for v in tree]
    return type(tree).__name__


@pytest.mark.parametrize("env,kw", [({}, {}), ({}, {"max_k": 128}), ({}, {"max_n": 256}),
                                    ({"WTPU_MBT_MAX_K": "128"}, {}),
                                    ({"WTPU_MBT_MAX_N": "100"}, {})])
def test_prepare_mbt_params_policies_match_jax(monkeypatch, env, kw):
    """Embeddings stay packed, deep (max_k) and wide (max_n, default 65536)
    linears stay packed, other leaves pass through; the rest transpose
    with the reference's per-leaf tile and depth."""
    from whisper_mlx_tpu.ops.quant import prepare_mbt_params as j_prepare

    for name, value in env.items():
        monkeypatch.setenv(name, value)
    rng = np.random.default_rng(10)
    jtree = {"embed": _jq(rng, 512, 128),
             "layers": [{"attn": {"qkv": {"w": _jq(rng, 384, 128)}, "q_norm": np.ones(4)},
                         "mlp": {"down": {"w": _jq(rng, 128, 256)}}}],
             "lm_head": {"w": _jq(rng, 65537, 64)}}
    a8 = ta8.requant_a8(_port(_jq(rng, 64, 64)))

    def port(node):
        if isinstance(node, jq.QuantTensor):
            return _port(node)
        if isinstance(node, dict):
            return {k: port(v) for k, v in node.items()}
        if isinstance(node, list):
            return [port(v) for v in node]
        return node

    ref = j_prepare(jtree, **kw)
    got = tq.prepare_mbt_params(dict(port(jtree), extra={"w": a8}), **kw)
    assert got["extra"]["w"] is a8
    del got["extra"]
    assert _types(got) == _types(ref)
    for path in (("layers", 0, "attn", "qkv", "w"), ("layers", 0, "mlp", "down", "w")):
        g, r = got, ref
        for p in path:
            g, r = g[p], r[p]
        if isinstance(g, tmb.QuantTensorT):
            assert (g.tile_n, g.depth) == (r.tile_n, r.depth)
            np.testing.assert_array_equal(g.dequantize().numpy(), np.asarray(r.dequantize()))


@pytest.mark.parametrize("codes,contig", [(False, False), (False, True), (True, False),
                                          (True, True)])
def test_converter_takes_jax_transposed_leaves(codes, contig):
    """qwen_params_from_jax turns a JAX QuantTensorT in any layout into the
    port's, with an equal dequantize and matmul."""
    from whisper_mlx_tpu_torch.checkpoint.convert import _qwen_leaf

    rng = np.random.default_rng(11)
    jqt = jmb.transpose_quant(_jq(rng, 200, 256), tile_n=128, depth=3, codes=codes,
                              contig=contig)
    got = _qwen_leaf(jax.tree.map(np.asarray, jqt), "w", "cpu", torch.float32, True)
    assert isinstance(got, tmb.QuantTensorT) and got.shape == (200, 256)
    assert (got.codes_resident, got.contig, got.tile_n, got.depth) == (codes, contig, 128, 3)
    assert got.wqt.shape[1] == got.scalest.shape[1] == 256  # flat, N padded to the tile
    np.testing.assert_array_equal(got.dequantize().numpy(), np.asarray(jqt.dequantize()))
    x = rng.standard_normal((2, 256)).astype(np.float32)
    ref = np.asarray(jmb.quant_matmul_mbt.__wrapped__(jnp.asarray(x), jqt, None, None, True))
    np.testing.assert_allclose(tmb.quant_matmul_mbt(torch.from_numpy(x), got).numpy(), ref,
                               atol=TOL, rtol=TOL)


def test_converter_takes_a_tree_of_both_leaf_types():
    """A JAX Qwen tree whose linears are QuantTensorT (flat, codes-resident
    contig) and A8Tensor (contig, flat) converts leaf for leaf: each leaf
    dequantizes bit-equal to JAX's, and the port's decode_step on the
    converted tree equals it on the tree the port converts itself."""
    tok = j_tok.ByteFallbackTokenizer()
    tcfg = tqw.QwenConfig(vocab_size=tok.vocab_size, **DIMS)
    jtree = _quantized_tree(JConfig(vocab_size=tok.vocab_size, **DIMS))
    own = qwen_params_from_jax(jax.tree.map(np.asarray, jtree), tcfg)
    leaves = [((0, "attn", "q"), lambda q: jmb.transpose_quant(q, tile_n=128),
               lambda q: tmb.transpose_quant(q, tile_n=128)),
              ((0, "mlp", "down"), lambda q: jmb.transpose_quant(q, tile_n=128, codes=True,
                                                                 contig=True),
               lambda q: tmb.transpose_quant(q, tile_n=128, codes=True, contig=True)),
              ((1, "mlp", "up"), lambda q: j_requant_a8(q, tile_n=128),
               lambda q: ta8.requant_a8(q, tile_n=128)),
              ((1, "attn", "o"), lambda q: j_requant_a8(q, tile_n=128, contig=False),
               lambda q: ta8.requant_a8(q, tile_n=128))]
    for (i, part, name), j_conv, t_conv in leaves:
        jtree["layers"][i][part][name]["w"] = j_conv(jtree["layers"][i][part][name]["w"])
        own["layers"][i][part][name]["w"] = t_conv(own["layers"][i][part][name]["w"])
    got_tree = qwen_params_from_jax(jax.tree.map(np.asarray, jtree), tcfg)
    assert _types(got_tree) == _types(own)
    for (i, part, name), _, _ in leaves:
        got = got_tree["layers"][i][part][name]["w"]
        np.testing.assert_array_equal(
            got.dequantize().numpy(),
            np.asarray(jtree["layers"][i][part][name]["w"].dequantize(jnp.float32)))
    prompt = torch.from_numpy(np.random.default_rng(12).integers(0, tok.vocab_size, (1, 7)))
    a, _ = tqw.decode_step(got_tree, prompt, 0, tqw.init_kv_cache(tcfg, 1, 16), tcfg)
    b, _ = tqw.decode_step(own, prompt, 0, tqw.init_kv_cache(tcfg, 1, 16), tcfg)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the engine under WTPU_MBT_RESIDENT=1
# ---------------------------------------------------------------------------

DIMS = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, rope_theta=10_000.0,
            tie_word_embeddings=True, attention_bias=True)


def _quantized_tree(jcfg):
    """The reference engine test's tree (random init, 4-bit layers) with a
    4-bit embedding too, which every residency mode leaves packed: the
    token gather and the tied head (kernel K5) read it."""
    params = jax.tree.map(np.asarray, j_init(jcfg, seed=0))
    layers = jq.quantize_params({"encoder": {"layers": params["layers"]}, "decoder": {}},
                                bits=4, group_size=64)["encoder"]["layers"]
    w_q, s, b = jq.quantize(params["embed"], 4, 64)
    embed = jq.QuantTensor(jnp.asarray(w_q), jnp.asarray(s), jnp.asarray(b), 4, 64)
    return dict(params, layers=layers, embed=embed)


@pytest.fixture(scope="module")
def mbt_engines():
    tok = j_tok.ByteFallbackTokenizer()
    jcfg = JConfig(vocab_size=tok.vocab_size, **DIMS)
    tcfg = tqw.QwenConfig(vocab_size=tok.vocab_size, **DIMS)
    jtree = _quantized_tree(jcfg)
    tparams = qwen_params_from_jax(jax.tree.map(np.asarray, jtree), tcfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WTPU_MBT_RESIDENT", "1")
        jeng = JEngine(jtree, jcfg, tok, max_context=256)
        teng = tg.LLMEngine(tparams, tcfg, t_tok.ByteFallbackTokenizer(), max_context=256)
    yield jeng, teng
    if teng._batch_engine is not None:
        teng._batch_engine.close()


@pytest.mark.parametrize("prompt,max_tokens", [("abc", 10), ("The quick brown fox", 24),
                                               ("<|im_start|>user\nhi<|im_end|>\n", 16)])
def test_mbt_engine_tokens_match_jax(mbt_engines, prompt, max_tokens):
    """The port's engine under WTPU_MBT_RESIDENT=1 holds QuantTensorT
    linears (embedding packed) and emits the JAX engine's tokens at T=0."""
    jeng, teng = mbt_engines
    assert _types(teng.params)["layers"][0]["attn"]["q"]["w"] == "QuantTensorT"
    assert isinstance(teng.params["embed"], tq.QuantTensor)
    ref = jeng.generate(prompt, max_tokens=max_tokens, temperature=0.0)
    got = teng.generate(prompt, max_tokens=max_tokens, temperature=0.0)
    assert got.tokens == ref.tokens and got.text == ref.text


def test_mbt_batch_engine_matches_single_request(mbt_engines):
    _, teng = mbt_engines
    batch = teng.continuous(2)
    prompts = ["Hello batching world", "A different prompt", "short"]
    handles = [batch.submit(p, max_tokens=10, temperature=0.0) for p in prompts]
    for p, h in zip(prompts, handles):
        assert list(h.tokens()) == teng.generate(p, max_tokens=10, temperature=0.0).tokens


# the linears that run K6 at decode: Qwen3-32B's fused qkv, o, fused gate_up
# and down (WTPU_MBT_RESIDENT leaves the head packed) and whisper
# large-v3's (WTPU_FEWROW_MBT=1: fused self qkv, the q, o and fc linears)
K6_SHAPES = [(10240, 5120), (5120, 8192), (51200, 5120), (5120, 25600),
             (3840, 1280), (1280, 1280), (5120, 1280), (1280, 5120)]


@pytest.mark.parametrize("codes", [False, True], ids=["packed", "i8"])
@pytest.mark.parametrize("depth", [2, 4, 8])
@pytest.mark.parametrize("n,k", K6_SHAPES)
def test_mbt_gemv_plan_covers_every_row_once(n, k, depth, codes):
    """The tensor-core GEMV's launch plan on a 132-SM card, at 1 to 8 rows:
    the cluster's blocks take every stored row exactly once, a cluster
    holds 1 to 8 blocks, the ring is 1 to ``depth`` stages, and a block's
    shared memory stays within the card's 227 KB."""
    sk = tmb._MMA_STAGE_K[codes]
    srows = sk if codes else sk // 8
    rows = k if codes else k // 8
    nst = -(-k // sk)
    for m in range(1, 9):
        cluster, stages = tmb.mbt_gemv_plan(m, n, k, codes, 64, depth, 132)
        assert 1 <= cluster <= 8 and cluster <= nst and 1 <= stages <= depth
        covered = np.zeros(rows, np.int64)
        for rank in range(cluster):
            first, last = rank * nst // cluster, (rank + 1) * nst // cluster
            assert last > first
            covered[first * srows:min(rows, last * srows)] += 1
        assert (covered == 1).all()
        kcap = -(-nst // cluster) * sk
        assert m * (2 * kcap + 64) <= tmb._XCAP or cluster == min(8, nst)
        assert tmb._mma_smem(codes, 64, stages, m, kcap) <= tmb._SMEM_LIMIT


@pytest.mark.parametrize("dtype,bits,codes,group_size,want", [
    (torch.bfloat16, 4, False, 64, True), (torch.bfloat16, 4, True, 64, True),
    (torch.bfloat16, 4, False, 256, True), (torch.bfloat16, 4, True, 128, True),
    (torch.bfloat16, 4, True, 256, False), (torch.bfloat16, 4, False, 16, False),
    (torch.bfloat16, 8, False, 64, False), (torch.float32, 4, False, 64, False)])
def test_mbt_mma_route_by_shape(dtype, bits, codes, group_size, want):
    """bf16 x with 4-bit codes whose groups (32 k or more) divide a stage
    take the tensor-core GEMV; fp32 x, 8-bit codes and other group sizes
    take the SIMT GEMV."""
    q = tq.quantize(torch.zeros((16, 512)), bits=bits, group_size=group_size)
    qt = tmb.transpose_quant(q, tile_n=16, depth=2, codes=codes)
    assert tmb.mma_route(dtype, qt) is want


@pytest.mark.parametrize("layout", ["packed4", "packed8", "codes"])
@pytest.mark.parametrize("n,k", K6_SHAPES + [(151936, 5120), (51866, 1280)])
def test_mbt_tiled_plan_covers_every_stage_once(n, k, layout):
    """K6's launch of the tiled core (its (G, Np) affines a stage's groups,
    no window; 32 code bytes a column and stage packed at 4 bits, 64 at 8
    bits or one code a byte) at 9-512 rows: the checks of
    tests/test_torch_quant.py:check_tiled_plans."""
    from tests.test_torch_quant import check_tiled_plans

    check_tiled_plans(n, k, 32 if layout == "packed4" else 64, affine_window=False)


# group sizes the reference takes (any multiple of 8 that divides K) that
# neither K6's tensor-core GEMV (groups of 32 k or more dividing a stage) nor
# the tiled core (16, 32, multiples of 64) takes at every row count: the
# SIMT GEMV runs them, its ring slot carrying every group its codes touch
F4_GROUPS = [(4, False, 8), (4, False, 16), (4, False, 48), (4, False, 80), (4, False, 96),
             (4, True, 8), (4, True, 16), (4, True, 48), (4, True, 80), (4, True, 96),
             (8, False, 8), (8, False, 16), (8, False, 48), (8, False, 96)]


@pytest.mark.parametrize("bits,codes,gs", F4_GROUPS)
@pytest.mark.parametrize("n,k", [(300, 1920), (5120, 3840), (151936, 960), (10240, 4800)])
def test_mbt_route_takes_every_group_size(bits, codes, gs, n, k):
    """At 1, 8, 24 and 512 rows, bf16 and fp32 x, K6's route function sends
    each group size to a kernel that takes it: the tensor-core GEMV, the
    tiled core, or the SIMT GEMV with a plan whose slots hold the affines
    of every group their codes touch and whose ring fits shared memory."""
    q = tq.quantize(torch.zeros((16, k)), bits=bits, group_size=gs)
    qt = tmb.transpose_quant(q, tile_n=16, depth=8, codes=codes)
    vpe = 1 if codes else 32 // bits
    slot_k = tmb._SLOT_ROWS[codes] * vpe
    for m in (1, 8, 24, 512):
        for dtype in (torch.bfloat16, torch.float32):
            route = tmb.mbt_route(m, k, dtype, qt)
            if route == "mma":
                assert tmb.mma_route(dtype, qt) and (m <= 8 or k % 64)
            elif route == "tiled":
                assert dtype == torch.bfloat16 and m > 8 and k % 64 == 0
                plan = tmb.tiled_plan(m, n, k, gs, 32 if bits == 4 and not codes else 64, 132)
                assert plan.units * plan.cluster >= plan.cluster
            else:
                assert route == "simt"
                splits, per_split, stages = tmb.simt_plan(m, n, k, qt, 132)
                assert per_split % tmb._SLOT_ROWS[codes] == 0 and splits * per_split >= k // vpe
                assert (splits - 1) * per_split < k // vpe and 1 <= stages <= 8
                # every slot starts on a multiple of slot_k: the groups its
                # codes touch fit the slot's affine room
                ng = -(-slot_k // gs) + 1
                assert ng <= tmb._SIMT_MAX_GROUPS
                touched = max((k0 + slot_k - 1) // gs - k0 // gs + 1
                              for k0 in range(0, k, slot_k))
                assert touched <= ng
                xg = 8 * (per_split * vpe // gs + 2) * 4
                assert stages * (tmb._SLOT_CODES + 2 * ng * 256 * 4) + xg <= tmb._SMEM_LIMIT


@pytest.mark.parametrize("bits,codes,gs", F4_GROUPS)
def test_mbt_plain_matches_pallas_f4_groups(bits, codes, gs):
    """K6's plain version at those group sizes against the reference's
    Pallas kernel in interpret mode, fp32 x."""
    rng = np.random.default_rng(gs * 10 + bits + codes)
    n, k, m = 200, 960, 3
    w_q, s, b = jq.quantize(rng.standard_normal((n, k)).astype(np.float32), bits, gs)
    q = jq.QuantTensor(jnp.asarray(w_q), jnp.asarray(s), jnp.asarray(b), bits, gs)
    jqt = jmb.transpose_quant(q, tile_n=128, depth=2, codes=codes)
    tqt = tmb.transpose_quant(_port(q), tile_n=128, depth=2, codes=codes)
    x = rng.standard_normal((m, k)).astype(np.float32)
    ref = np.asarray(jmb.quant_matmul_mbt.__wrapped__(jnp.asarray(x), jqt, None, None, True))
    got = tmb.quant_matmul_mbt(torch.from_numpy(x), tqt)
    assert got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=TOL)


def test_simt_plan_raises_not_implemented_naming_f4(monkeypatch):
    """A group size whose slot or ring cannot fit raises NotImplementedError
    naming F4, never an opaque CUDA error: here a slot room of one group."""
    q = tq.quantize(torch.zeros((16, 512)), bits=4, group_size=8)
    qt = tmb.transpose_quant(q, tile_n=16, depth=2)
    monkeypatch.setattr(tmb, "_SIMT_MAX_GROUPS", 1)
    with pytest.raises(NotImplementedError, match="F4"):
        tmb.simt_plan(1, 300, 512, qt, 132)
