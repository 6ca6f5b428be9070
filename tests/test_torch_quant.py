"""Port parity: MLX group quantization and the quantized matmul of
whisper_mlx_tpu_torch (ops/quant.py, kernel K5's plain version) against the
JAX package on the CPU. The primitives are bit-identical on identical
inputs; the matmul is compared with the Pallas kernel in interpret mode.
The Hopper kernel itself is tested against the plain version in
tests/test_torch_kernels.py."""

from __future__ import annotations

import numpy as np
import pytest

import torch  # noqa: F401  (torch before jax, as in the other test files)
import jax.numpy as jnp

from whisper_mlx_tpu.ops import quant as jq
from whisper_mlx_tpu.ops.quant_pallas import quant_matmul_pallas
from whisper_mlx_tpu_torch.ops import quant as tq
from whisper_mlx_tpu_torch.ops import quant_matmul as qm


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _port(q: "jq.QuantTensor") -> tq.QuantTensor:
    return tq.QuantTensor(torch.from_numpy(np.asarray(q.w_q).view(np.int32).copy()),
                          torch.from_numpy(np.array(q.scales, np.float32)),
                          torch.from_numpy(np.array(q.biases, np.float32)),
                          q.bits, q.group_size)


def _weights(rng, n, k):
    w = rng.standard_normal((n, k)).astype(np.float32)
    w[0, :64] = 0.25  # a constant group: scale 1e-8
    return w


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_bit_identical(bits):
    """Codes, scales and biases equal the reference's numpy quantize and its
    on-device quantize_jax (including .5 ties, both half to even)."""
    rng = np.random.default_rng(bits)
    w = _weights(rng, 40, 256)
    w[1, :64] = np.arange(64, dtype=np.float32) / 2.0  # codes on exact .5 ties
    np_q, np_s, np_b = jq.quantize(w, bits=bits, group_size=64)
    jx = jq.quantize_jax(jnp.asarray(w), bits=bits, group_size=64)
    t = tq.quantize(torch.from_numpy(w), bits=bits, group_size=64)
    assert t.w_q.dtype == torch.int32 and t.shape == (40, 256)
    np.testing.assert_array_equal(_u32(t.w_q), np_q)
    np.testing.assert_array_equal(_u32(t.w_q), np.asarray(jx.w_q))
    np.testing.assert_array_equal(t.scales.numpy(), np_s)
    np.testing.assert_array_equal(t.biases.numpy(), np_b)
    np.testing.assert_array_equal(t.scales.numpy(), np.asarray(jx.scales))


@pytest.mark.parametrize("bits", [4, 8])
def test_unpack_and_dequantize_bit_identical(bits):
    rng = np.random.default_rng(10 + bits)
    words = rng.integers(0, 2**32, size=(7, 64), dtype=np.uint64).astype(np.uint32)
    got = tq.unpack(torch.from_numpy(words.view(np.int32)), bits)
    np.testing.assert_array_equal(got.numpy(), jq.unpack(words, bits).astype(np.int64))
    w = _weights(rng, 24, 512)
    q = jq.quantize_jax(jnp.asarray(w), bits=bits)
    tqt = _port(q)
    np.testing.assert_array_equal(tqt.dequantize(torch.float32).numpy(),
                                  np.asarray(q.dequantize(jnp.float32)))
    rows = np.array([[3, 0, 23], [5, 5, 1]])
    np.testing.assert_array_equal(
        tq.quant_rows(tqt, torch.from_numpy(rows), torch.float32).numpy(),
        np.asarray(jq.quant_rows(q, jnp.asarray(rows), dtype=jnp.float32)))


def test_stack_and_fuse_qwen_projections_bit_identical():
    rng = np.random.default_rng(3)
    jqs = [jq.quantize_jax(jnp.asarray(_weights(rng, n, 128)), bits=4) for n in (64, 32, 32)]
    stacked = tq.stack_quant([_port(q) for q in jqs])
    ref = jq.stack_quant(jqs)
    np.testing.assert_array_equal(_u32(stacked.w_q), np.asarray(ref.w_q))
    np.testing.assert_array_equal(stacked.scales.numpy(), np.asarray(ref.scales))

    def layer(port):
        mk = _port if port else (lambda q: q)
        wrap = (lambda a: torch.from_numpy(np.asarray(a))) if port else jnp.asarray
        return {"input_ln": wrap(np.ones(128, np.float32)),
                "attn": {"q": {"w": mk(jqs[0]), "b": wrap(np.arange(64, dtype=np.float32))},
                         "k": {"w": mk(jqs[1]), "b": wrap(np.ones(32, np.float32))},
                         "v": {"w": mk(jqs[2]), "b": wrap(np.zeros(32, np.float32))},
                         "o": {"w": mk(jqs[0])}, "q_norm": wrap(np.ones(16, np.float32))},
                "post_ln": wrap(np.ones(128, np.float32)),
                "mlp": {"gate": {"w": mk(jqs[0])}, "up": {"w": mk(jqs[0])},
                        "down": {"w": mk(jqs[1])}}}

    jf = jq.fuse_qwen_projections({"layers": [layer(False)]})["layers"][0]
    tf = tq.fuse_qwen_projections({"layers": [layer(True)]})["layers"][0]
    assert sorted(tf["attn"]) == sorted(jf["attn"]) and sorted(tf["mlp"]) == sorted(jf["mlp"])
    for path in (("attn", "qkv"), ("mlp", "gate_up")):
        t, j = tf[path[0]][path[1]]["w"], jf[path[0]][path[1]]["w"]
        np.testing.assert_array_equal(_u32(t.w_q), np.asarray(j.w_q))
        np.testing.assert_array_equal(t.biases.numpy(), np.asarray(j.biases))
    np.testing.assert_array_equal(tf["attn"]["qkv"]["b"].numpy(),
                                  np.asarray(jf["attn"]["qkv"]["b"]))


def test_dequantize_params_keeps_port_layout():
    rng = np.random.default_rng(4)
    q = jq.quantize_jax(jnp.asarray(_weights(rng, 32, 128)), bits=4)
    tree = {"embed": _port(q), "layers": [{"mlp": {"down": {"w": _port(q)}}}]}
    ref = np.asarray(q.dequantize(jnp.float32))  # (out, in)
    dense = tq.dequantize_params(tree, torch.float32)
    np.testing.assert_array_equal(dense["embed"].numpy(), ref)
    np.testing.assert_array_equal(dense["layers"][0]["mlp"]["down"]["w"].numpy(), ref)
    jdense = jq.dequantize_params({"down": {"w": q}}, dtype=jnp.float32)
    np.testing.assert_array_equal(dense["layers"][0]["mlp"]["down"]["w"].numpy(),
                                  np.asarray(jdense["down"]["w"]).T)


# fp32: sums in another order (~1e-6 relative); bf16: the same bf16 rounding
# points as the Pallas kernel, the output may move by one bf16 ulp
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("rows", [(1,), (3,), (17,), (2, 3)])  # (2, 3): lead dims
def test_quant_matmul_plain_matches_pallas(dtype, tol, bits, rows):
    rng = np.random.default_rng(int(np.prod(rows)) * bits)
    n, k = 200, 256  # ragged N: not a multiple of the TPU's 128/256 tiles
    q = jq.quantize_jax(jnp.asarray(_weights(rng, n, k) / 16.0), bits=bits)
    shape = (*rows, k)
    x = rng.standard_normal(shape).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref = np.asarray(quant_matmul_pallas(jnp.asarray(x, jdt), q, interpret=True)
                     .astype(jnp.float32))
    got = tq.quant_matmul(torch.from_numpy(x).to(tdt), _port(q))
    assert got.dtype == tdt and got.shape == (*shape[:-1], n)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got.float().numpy(), ref, atol=tol * scale, rtol=0)


@pytest.mark.parametrize("rows,launches_plain", [(512, True), (513, False)])
def test_quant_matmul_dispatch(monkeypatch, rows, launches_plain):
    """At most 512 rows take K5's function; more rows dequantize + matmul,
    the reference's policy (WTPU_QMM_PALLAS_MAX_ROWS)."""
    rng = np.random.default_rng(5)
    q = tq.quantize(torch.from_numpy(_weights(rng, 16, 64)))
    calls = []
    orig = qm.quant_matmul_plain
    monkeypatch.setattr(qm, "quant_matmul_plain", lambda *a: calls.append(1) or orig(*a))
    x = torch.from_numpy(rng.standard_normal((rows, 64)).astype(np.float32))
    got = tq.quant_matmul(x, q)
    assert bool(calls) == launches_plain
    np.testing.assert_allclose(got.numpy(), (x @ q.dequantize().T).numpy(), atol=1e-4)
    monkeypatch.setenv("WTPU_QMM_PALLAS_MAX_ROWS", str(rows))
    calls.clear()
    tq.quant_matmul(x, q)
    assert calls


def test_quant_matmul_lower_row_bound_on_cpu(monkeypatch):
    """On CPU tensors a bound below 512 is the reference's knob: those rows
    dequantize + matmul (on CUDA it raises, tests/test_torch_kernels.py)."""
    rng = np.random.default_rng(6)
    q = tq.quantize(torch.from_numpy(_weights(rng, 16, 64)))
    calls = []
    orig = qm.quant_matmul_plain
    monkeypatch.setattr(qm, "quant_matmul_plain", lambda *a: calls.append(1) or orig(*a))
    monkeypatch.setenv("WTPU_QMM_PALLAS_MAX_ROWS", "0")
    x = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    got = tq.quant_matmul(x, q)
    assert not calls
    np.testing.assert_allclose(got.numpy(), (x @ q.dequantize().T).numpy(), atol=1e-4)


@pytest.mark.parametrize("leaf,item", [("NativeQuantTensor", "M15"), ("DenseWeight", "M15")])
def test_unported_leaf_types_raise(leaf, item):
    """The reference's native-code leaves (ROADMAP ``item``, ported since;
    the test keeps its name): the JAX leaf converted by ``params_from_jax``'s
    leaf rule and multiplied by ``quant_matmul`` against the reference's
    ``quant_matmul`` on the same leaf, fp32, within 1e-5 of max(1, |ref|)
    (sums in another order); the native leaf's codes and dequantization are
    the reference's exactly, and an unknown leaf type still raises."""
    from whisper_mlx_tpu_torch.checkpoint.convert import _quant_leaf

    rng = np.random.default_rng(12)
    w = _weights(rng, 48, 256)
    qt = jq.QuantTensor(*(jnp.asarray(a) for a in jq.quantize(w, bits=4, group_size=64)), 4, 64)
    jleaf = jq.to_native(qt) if leaf == "NativeQuantTensor" else jq.DenseWeight(qt.dequantize())
    tleaf = _quant_leaf(jleaf, "cpu")
    assert type(tleaf).__name__ == leaf
    if leaf == "NativeQuantTensor":
        np.testing.assert_array_equal(tleaf.codes.numpy(), np.asarray(jleaf.codes))
    jw = jleaf.w if leaf == "DenseWeight" else jleaf.dequantize()
    np.testing.assert_array_equal(tleaf.dequantize().numpy(), np.asarray(jw))
    for m in (1, 5):
        x = rng.standard_normal((m, 256)).astype(np.float32)
        ref = np.asarray(jq.quant_matmul(jnp.asarray(x), jleaf))
        got = tq.quant_matmul(torch.from_numpy(x), tleaf).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * max(1.0, np.abs(ref).max()))
    with pytest.raises(TypeError, match="QuantTensor"):
        tq.quant_matmul(torch.zeros(1, 64), type(leaf + "Like", (), {})())


def test_cpu_wrapper_uses_plain_version():
    rng = np.random.default_rng(6)
    q = tq.quantize(torch.from_numpy(_weights(rng, 16, 128)), bits=4)
    x = torch.from_numpy(rng.standard_normal((2, 128)).astype(np.float32)).to(torch.bfloat16)
    before = qm.LAUNCHES
    got = qm.quant_matmul_kernel(x, q.w_q, q.scales, q.biases, 4, 64)
    assert torch.equal(got, qm.quant_matmul_plain(x, q.w_q, q.scales, q.biases, 4, 64))
    assert qm.LAUNCHES == before


# ---------------------------------------------------------------------------
# the tiled core's launch plan (bf16 x, 9-512 rows: csrc/quant_tile.cuh)
# ---------------------------------------------------------------------------

# Qwen3-32B's fused qkv, o, fused gate_up, down and head; whisper large-v3's
# fused self qkv, the 1280-wide linears, fc1, fc2 and the ragged logits
TILED_SHAPES = [(10240, 5120), (5120, 8192), (51200, 5120), (5120, 25600), (151936, 5120),
                (3840, 1280), (1280, 1280), (5120, 1280), (1280, 5120), (51866, 1280)]


def check_tiled_plans(n: int, k: int, wbytes: int, affine_window: bool, sms: int = 132) -> None:
    """Every row count 9-512 at group sizes 32, 64 and 128: the blocks' rows
    cover M with the fewest x rows a block, the cluster's blocks take every
    64-k stage of K exactly once and start on a group, the grid fills at
    least half the card unless the cluster is already at its largest or a
    larger split would save a block fewer stages than it costs, and a
    block's shared memory (the ring, its barriers and the cluster sum's
    room) stays within what its blocks an SM may have."""
    for group_size in (32, 64, 128):
        unit = max(1, group_size // 64)
        for m in range(9, 513):
            plan = qm.tiled_plan(m, n, k, group_size, wbytes, sms, affine_window)
            assert plan.nt == next((r for r in qm.TILED_ROWS if m <= r), 128)
            assert plan.row_blocks * plan.nt >= m > (plan.row_blocks - 1) * plan.nt
            assert plan.col_blocks * plan.cols >= n > (plan.col_blocks - 1) * plan.cols
            assert plan.units == k // 64 // unit and plan.cluster in (1, 2, 4, 8)
            assert plan.cluster <= plan.units
            covered = np.zeros(k // 64, np.int64)
            for rank in range(plan.cluster):  # csrc/quant_tile.cuh: the block's kb, ns
                first = rank * plan.units // plan.cluster
                last = (rank + 1) * plan.units // plan.cluster
                assert last > first
                assert first * unit * 64 % group_size == 0  # a block starts on a group
                covered[first * unit:last * unit] += 1
            assert (covered == 1).all()
            blocks = plan.cluster * plan.row_blocks * plan.col_blocks
            largest = max(c for c in (1, 2, 4, 8) if c <= plan.units)
            # a half-empty card only where a larger split would take a block
            # fewer stages than the split costs it (the measured cluster sum)
            assert (2 * blocks >= plan.per_sm * sms or plan.cluster == largest
                    or plan.units // (2 * plan.cluster) * unit <= qm.TILED_SPLIT_COST[plan.nt])
            assert 2 <= plan.stages <= 8
            smem, ring = qm.tiled_smem(plan.nt, wbytes, group_size, plan.stages, affine_window)
            assert smem == plan.smem <= (qm.SMEM_LIMIT if plan.per_sm == 1 else qm.SMEM_TWO_A_SM)
            if plan.cluster > 1:  # every block's accumulators fit the ring for the sum
                assert ring >= 4 * 2 * 64 * (plan.cols // 128) * plan.nt


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("n,k", TILED_SHAPES)
def test_tiled_plan_covers_every_stage_once(n, k, bits):
    """K5's tiled launch plan at the main paths' shapes, 9-512 rows."""
    check_tiled_plans(n, k, 32 if bits == 4 else 64, affine_window=True)


@pytest.mark.parametrize("group_size,want", [(16, True), (32, True), (64, True), (128, True),
                                             (256, True), (48, False), (96, False)])
def test_tiled_route_by_group_size(group_size, want):
    """Groups of 16 or 32 k (several a 64-k stage) or of whole stages take
    the tiled core; other sizes the GEMV, as K not a multiple of 64 does."""
    assert qm.tiled_route(group_size) is want
    if not want:
        with pytest.raises(ValueError):
            qm.tiled_plan(24, 200, 1536, group_size, 64, 132)


def test_tiled_plan_sizes_the_main_path():
    """The Qwen prefill's 384 rows run in three 128-row blocks of 256
    columns, gate_up unsplit (600 blocks fill the card), o and down split
    in two; at 512 rows only down splits; whisper's 24-row SOT step takes
    32-row blocks of 128 columns, two an SM, its 1280-wide linears split
    eight ways."""
    qkv = qm.tiled_plan(384, 10240, 5120, 64, 32, 132, affine_window=True)
    assert (qkv.nt, qkv.cols, qkv.row_blocks, qkv.col_blocks, qkv.cluster) == (128, 256, 3, 40, 1)
    assert qm.tiled_plan(384, 51200, 5120, 64, 32, 132, affine_window=True).cluster == 1
    for n, k in ((5120, 8192), (5120, 25600)):
        assert qm.tiled_plan(384, n, k, 64, 32, 132, affine_window=True).cluster == 2
    # the clusters measured fastest on the H100 at 128 and 512 rows
    assert [qm.tiled_plan(m, n, k, 64, 32, 132, affine_window=True).cluster
            for m in (128, 512) for n, k in ((10240, 5120), (5120, 8192), (5120, 25600))] == \
        [2, 4, 4, 1, 1, 8]
    sot = qm.tiled_plan(24, 1280, 1280, 64, 32, 132, affine_window=True)
    assert (sot.nt, sot.cols, sot.per_sm, sot.cluster) == (32, 128, 2, 8)
