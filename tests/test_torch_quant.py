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


@pytest.mark.parametrize("leaf,item", [("NativeQuantTensor", "M15"), ("QuantTensorT", "K6"),
                                       ("A8Tensor", "K7"), ("DenseWeight", "M9")])
def test_unported_leaf_types_raise(leaf, item):
    fake = type(leaf, (), {})()
    with pytest.raises(NotImplementedError, match=item):
        tq.quant_matmul(torch.zeros(1, 64), fake)


def test_qmm_mb_opt_in_raises(monkeypatch):
    monkeypatch.setenv("WTPU_QMM_MB", "4")
    q = tq.quantize(torch.zeros(8, 64))
    with pytest.raises(NotImplementedError, match="K6"):
        tq.quant_matmul(torch.zeros(1, 64), q)


def test_cpu_wrapper_uses_plain_version():
    rng = np.random.default_rng(6)
    q = tq.quantize(torch.from_numpy(_weights(rng, 16, 128)), bits=4)
    x = torch.from_numpy(rng.standard_normal((2, 128)).astype(np.float32)).to(torch.bfloat16)
    before = qm.LAUNCHES
    got = qm.quant_matmul_kernel(x, q.w_q, q.scales, q.biases, 4, 64)
    assert torch.equal(got, qm.quant_matmul_plain(x, q.w_q, q.scales, q.biases, 4, 64))
    assert qm.LAUNCHES == before
