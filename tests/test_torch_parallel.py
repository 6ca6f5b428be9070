"""Port parity, in process: the mesh, the sharding rules and the memory plan
of ``whisper_mlx_tpu_torch.parallel`` against ``whisper_mlx_tpu.parallel``.

Each rank's local tree is held bit for bit to the data the JAX package puts
on the device at the same mesh coordinate (``jax.Array.addressable_shards``
on the 8 virtual CPU devices of tests/conftest.py), transposed where the
layouts differ (the port's fp linear ``w`` is ``(out, in)``). A rank of a
wider mesh is a :class:`Mesh` built for its coordinate: sharding needs no
process group. The runs over several ranks are in
tests/test_torch_parallel_mp.py.
"""

from __future__ import annotations

import numpy as np
import pytest

import torch  # (torch before jax: the reverse order has deadlocked)
import jax
from jax.sharding import PartitionSpec as P

from whisper_mlx_tpu.decoding import tokenizer as j_tokenizer
from whisper_mlx_tpu.models import qwen as jqw
from whisper_mlx_tpu.models import whisper as jw
from whisper_mlx_tpu.ops import quant as jq
from whisper_mlx_tpu.parallel import memory_plan as jmp
from whisper_mlx_tpu.parallel import mesh as jmesh
from whisper_mlx_tpu.parallel import sharding as jsh
from whisper_mlx_tpu.parallel import sharding_llm as jshl
from whisper_mlx_tpu.runtime.batcher import TranscriptionBatcher as JBatcher
from whisper_mlx_tpu_torch.checkpoint.convert import params_from_jax, qwen_params_from_jax
from whisper_mlx_tpu_torch.decoding import tokenizer as t_tokenizer
from whisper_mlx_tpu_torch.models import qwen as tqw
from whisper_mlx_tpu_torch.models import whisper as tw
from whisper_mlx_tpu_torch.ops import quant as tq
from whisper_mlx_tpu_torch.ops.quant_matmul_mb import transpose_quant
from whisper_mlx_tpu_torch.parallel import memory_plan as tmp
from whisper_mlx_tpu_torch.parallel import sharding as tsh
from whisper_mlx_tpu_torch.parallel import sharding_llm as tshl
from whisper_mlx_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_cat,
    all_sum,
    broadcast,
    init_distributed,
    local_shard,
    local_slice,
    make_mesh,
)
from whisper_mlx_tpu_torch.runtime.batcher import TranscriptionBatcher

TINY = dict(n_mels=80, n_audio_state=64, n_audio_head=4, n_audio_layer=2,
            n_text_state=64, n_text_head=4, n_text_layer=2)
QWEN_TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                 num_attention_heads=4, num_key_value_heads=2, rope_theta=1e4,
                 tie_word_embeddings=False, attention_bias=True)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_mesh(tp: int):
    return jmesh.make_mesh(dp=2, tp=tp, devices=jax.devices()[:2 * tp])


def _jax_shard(arr, jmesh_, d: int, t: int) -> np.ndarray:
    dev = jmesh_.devices[d, t]
    return next(np.asarray(s.data) for s in arr.addressable_shards if s.device == dev)


def _as_port(key: str, a: np.ndarray) -> torch.Tensor:
    """A JAX leaf's data in the port's layout and integer view."""
    if key == "w" and a.ndim == 2:
        a = a.T
    elif key == "w" and a.ndim == 3:  # conv (k, in, out) -> (out, in, k)
        a = a.transpose(2, 1, 0)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a, order="C"))


def _same(port: torch.Tensor, want: torch.Tensor, where: str) -> None:
    assert tuple(port.shape) == tuple(want.shape), (where, port.shape, want.shape)
    assert torch.equal(port, want.to(port.dtype)), where


def _walk_equal(port, jtree, pick, where="params", key=""):
    """Every leaf of the port's local tree equals ``pick(key, jax leaf)``."""
    if isinstance(port, dict):
        assert set(port) == set(jtree), where
        for k in port:
            _walk_equal(port[k], jtree[k], pick, f"{where}.{k}", k)
    elif isinstance(port, list):
        assert len(port) == len(jtree), where
        for i, (p, j) in enumerate(zip(port, jtree)):
            _walk_equal(p, j, pick, f"{where}.{i}")
    elif isinstance(port, tq.QuantTensor):
        for name in ("w_q", "scales", "biases"):
            _same(getattr(port, name), pick(name, getattr(jtree, name)), f"{where}.{name}")
    else:
        _same(port, pick(key, jtree), where)


def _specs_as_tuples(specs):
    """JAX spec trees with ``P`` as tuples and QuantTensor spec nodes as the
    port's ``{"w_q", "scales", "biases"}``."""
    if isinstance(specs, dict):
        return {k: _specs_as_tuples(v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_specs_as_tuples(v) for v in specs]
    if isinstance(specs, jq.QuantTensor):
        return {n: tuple(getattr(specs, n)) for n in ("w_q", "scales", "biases")}
    assert isinstance(specs, P)
    return tuple(specs)


@pytest.fixture(scope="module")
def whisper_pair():
    tok = j_tokenizer.make_synthetic_tokenizer()
    jcfg = jw.WhisperConfig(n_vocab=tok.n_vocab, **TINY)
    jparams = jw.init_params(jcfg, seed=0)
    tcfg = tw.WhisperConfig(n_vocab=tok.n_vocab, **TINY)
    return jparams, params_from_jax(_np_tree(jparams), tcfg), tcfg


@pytest.fixture(scope="module")
def whisper_quant_pair(whisper_pair):
    jparams, _, tcfg = whisper_pair
    jquant = jq.fuse_whisper_qkv(jq.quantize_params(jparams, bits=4, group_size=32))
    return jquant, params_from_jax(_np_tree(jquant), tcfg)


def _qwen_pair(bits: int):
    jcfg = jqw.QwenConfig(**QWEN_TINY)
    jparams = jqw.init_params(jcfg, seed=0)
    if bits:
        layers = jq.quantize_params({"encoder": {"layers": jparams["layers"]}, "decoder": {}},
                                    bits=bits, group_size=64)["encoder"]["layers"]
        jparams = dict(jparams, layers=layers)
    return jparams, qwen_params_from_jax(_np_tree(jparams), tqw.QwenConfig(**QWEN_TINY))


# -- spec trees ----------------------------------------------------------------------


@pytest.mark.parametrize("quantized", [False, True])
def test_whisper_specs_equal_jax(whisper_pair, whisper_quant_pair, quantized):
    jparams, tparams = whisper_quant_pair if quantized else whisper_pair[:2]
    want = _specs_as_tuples(jsh.whisper_param_specs(jparams, tp="tp"))
    assert tsh.whisper_param_specs(tparams, tp="tp") == want
    assert tsh.whisper_param_specs(tparams, tp=None) == _specs_as_tuples(
        jsh.whisper_param_specs(jparams, tp=None))


@pytest.mark.parametrize("bits", [0, 4])
def test_qwen_specs_equal_jax(bits):
    jparams, tparams = _qwen_pair(bits)
    assert tshl.qwen_param_specs(tparams) == _specs_as_tuples(jshl.qwen_param_specs(jparams))


# -- each rank's shards ----------------------------------------------------------------


@pytest.mark.parametrize("tp", [2, 4])
def test_whisper_shards_equal_jax(whisper_pair, tp):
    jparams, tparams, _ = whisper_pair
    jm = _jax_mesh(tp)
    sharded = jsh.shard_params(jparams, jm)
    for d in range(2):
        for t in range(tp):
            local = tsh.shard_params(tparams, Mesh(dp=2, tp=tp, rank=d * tp + t))
            _walk_equal(local, sharded,
                        lambda key, a: _as_port(key, _jax_shard(a, jm, d, t)))


def test_whisper_quantized_tree_replicated(whisper_quant_pair):
    jquant, tquant = whisper_quant_pair
    jm = _jax_mesh(2)
    sharded = jsh.shard_params(jquant, jm)
    for rank in range(4):
        mesh = Mesh(dp=2, tp=2, rank=rank)
        assert tsh.shard_params(tquant, mesh) is tquant
        _walk_equal(tquant, sharded,
                    lambda key, a: _as_port(key, _jax_shard(a, jm, *divmod(rank, 2))))
    params, config = tsh.shard_model(tquant, tw.WhisperConfig(**TINY), Mesh(dp=2, tp=2))
    assert params is tquant and type(config) is tw.WhisperConfig


def test_whisper_uneven_vocabulary(whisper_pair):
    """1,867 rows over tp 4: the JAX package's device_put refuses the split;
    the port takes GSPMD's ceil shares (467, 467, 467, 466), whose
    concatenation is the table, and splits every other leaf evenly."""
    cfg = jw.WhisperConfig(n_vocab=1867, **TINY)
    jparams = jw.init_params(cfg, seed=1)
    with pytest.raises(ValueError, match="divisible by 4"):
        jsh.shard_params(jparams, _jax_mesh(4))
    tparams = params_from_jax(_np_tree(jparams), tw.WhisperConfig(n_vocab=1867, **TINY))
    table = tparams["decoder"]["token_emb"]
    parts = [tsh.shard_params(tparams, Mesh(dp=1, tp=4, rank=r))["decoder"]["token_emb"]
             for r in range(4)]
    assert [p.shape[0] for p in parts] == [467, 467, 467, 466]
    assert torch.equal(torch.cat(parts), table)
    assert [local_slice(1867, 4, r) for r in range(4)] == [
        slice(0, 467), slice(467, 934), slice(934, 1401), slice(1401, 1867)]
    local, config = tsh.shard_model(tparams, tw.WhisperConfig(n_vocab=1867, **TINY),
                                    Mesh(dp=1, tp=4, rank=3))
    assert config.mesh is not None and local["decoder"]["token_emb"].shape == (466, 64)


def _port_tree(jtree, pick, key=""):
    """The JAX tree with every leaf replaced by ``pick(key, leaf)``, in the
    port's node types."""
    if isinstance(jtree, dict):
        return {k: _port_tree(v, pick, k) for k, v in jtree.items()}
    if isinstance(jtree, list):
        return [_port_tree(v, pick) for v in jtree]
    if isinstance(jtree, jq.QuantTensor):
        return tq.QuantTensor(*(pick(n, getattr(jtree, n)) for n in ("w_q", "scales", "biases")),
                              jtree.bits, jtree.group_size)
    return pick(key, jtree)


@pytest.mark.parametrize("bits", [0, 4])
@pytest.mark.parametrize("tp", [2, 4])
def test_qwen_shards_equal_jax(bits, tp):
    """Column splits and fp row splits bit-equal to JAX's shards; a packed
    row split takes JAX's words and, of JAX's replicated scales and biases,
    its own groups, or stays whole where K / tp is under a group (o at tp 2
    and 4, down at tp 4 here)."""
    jparams, tparams = _qwen_pair(bits)
    jm = _jax_mesh(tp)
    sharded = jshl.shard_qwen_params(jparams, jm)
    whole = set()
    for d in range(2):
        for t in range(tp):
            local = tshl.shard_qwen_params(tparams, Mesh(dp=2, tp=tp, rank=d * tp + t))
            want = _port_tree(sharded, lambda key, a: _as_port(key, _jax_shard(a, jm, d, t)))
            for i, blk in enumerate(want["layers"]):
                for part, n in (("attn", "o"), ("mlp", "down")):
                    full = tparams["layers"][i][part][n]["w"]
                    if not isinstance(full, tq.QuantTensor):
                        continue
                    k = full.shape[1] // tp
                    if k % full.group_size:
                        whole.add(n)
                        blk[part][n]["w"] = full
                    else:
                        g = local_slice(full.scales.shape[1], tp, t)
                        blk[part][n]["w"] = tq.QuantTensor(
                            blk[part][n]["w"].w_q, full.scales[:, g], full.biases[:, g],
                            full.bits, full.group_size)
            _walk_equal(local, want, lambda key, a: a)
    if bits:
        assert whole == ({"o"} if tp == 2 else {"o", "down"})


def test_qwen_fused_shards_are_the_parts_shards():
    """A fused qkv / gate_up is split part by part and fused again: the same
    rows as the unfused tree's shards, in one product a rank."""
    _, tparams = _qwen_pair(4)
    config = tqw.QwenConfig(**QWEN_TINY)
    fused = tq.fuse_qwen_projections(tparams)
    for rank in range(2):
        mesh = Mesh(dp=1, tp=2, rank=rank)
        plain = tshl.shard_qwen_params(tparams, mesh)
        local = tshl.shard_qwen_params(fused, mesh, config=config)
        for lb, pb in zip(local["layers"], plain["layers"]):
            qkv = lb["attn"]["qkv"]
            for name in ("w_q", "scales", "biases"):
                assert torch.equal(getattr(qkv["w"], name), torch.cat(
                    [getattr(pb["attn"][n]["w"], name) for n in ("q", "k", "v")]))
            assert torch.equal(qkv["b"], torch.cat([pb["attn"][n]["b"] for n in "qkv"]))
            gu = lb["mlp"]["gate_up"]["w"]
            assert torch.equal(gu.w_q, torch.cat([pb["mlp"][n]["w"].w_q
                                                  for n in ("gate", "up")]))
    with pytest.raises(ValueError, match="config"):
        tshl.shard_qwen_params(fused, Mesh(dp=1, tp=2))


def test_qwen_residency_trees_refused():
    _, tparams = _qwen_pair(4)
    blk = tparams["layers"][0]
    mbt = dict(tparams, layers=[dict(blk, mlp=dict(blk["mlp"], down={
        "w": transpose_quant(blk["mlp"]["down"]["w"])}))])
    with pytest.raises(TypeError, match="QuantTensorT"):
        tshl.shard_qwen_params(mbt, Mesh(dp=1, tp=2))


# -- the mesh ------------------------------------------------------------------------


def test_make_mesh_one_rank_and_errors():
    """Without a process group the job is one rank: JAX's error for a shape
    that is not the job's, a one-rank mesh whose collectives are the
    identity, and init_distributed a no-op for one process."""
    init_distributed(None, 1, 0)
    mesh = make_mesh()
    assert mesh.shape == {"dp": 1, "tp": 1} and mesh.axis_names == ("dp", "tp")
    assert (mesh.index("dp"), mesh.index("tp"), mesh.device) == (0, 0, torch.device("cpu"))
    for dp, tp in ((3, 3), (2, 1), (None, 2)):
        with pytest.raises(ValueError) as port_err:
            make_mesh(dp=dp, tp=tp)
        with pytest.raises(ValueError) as jax_err:
            jmesh.make_mesh(dp=dp, tp=tp, devices=jax.devices()[:1])
        assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="2 devices for 1 ranks"):
        make_mesh(devices=["cpu", "cpu"])
    x = torch.arange(6.0).reshape(2, 3)
    assert all_sum(x, mesh) is x and all_gather_cat(x, mesh, "dp") is x
    assert broadcast(x, mesh) is x


def test_placements():
    x = torch.arange(24.0).reshape(4, 6)
    mesh = Mesh(dp=2, tp=2, rank=3)  # coordinate (1, 1)
    assert local_shard(x, (), mesh) is x  # JAX's replicated(mesh)
    assert torch.equal(local_shard(x, ("dp", None), mesh), x[2:])  # JAX's dp_sharding(mesh, 2)
    assert torch.equal(local_shard(x, (None, "tp"), mesh), x[:, 3:])
    y = torch.arange(32.0).reshape(4, 8)
    assert torch.equal(local_shard(y, (None, ("dp", "tp")), mesh), y[:, 6:])
    assert torch.equal(tsh.shard_batch(x, mesh), x[2:])
    with pytest.raises(ValueError, match="does not divide"):
        tsh.shard_batch(x[:3], mesh)
    assert tsh.shard_batch(x, None) is x and tsh.dp_round(3, mesh) == 4


def test_daemon_follower_exit_fails_startup_fast(monkeypatch):
    """A follower rank that exits before joining fails the daemon's startup
    at once, with its output, instead of a rendezvous wait of the
    collectives' timeout."""
    import time

    from whisper_mlx_tpu_torch.parallel import launch
    from whisper_mlx_tpu_torch.serving import server

    real = launch.start
    monkeypatch.setattr(launch, "start", lambda argv, log, env=None: real(
        ["-c", "import sys; print('no model here'); sys.exit(3)"], log, env))
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="(?s)rank 1 exited with code 3.*no model here"):
        server._start_asr_ranks("tiny", torch.device("cpu"), 2)
    assert time.monotonic() - t0 < 60


def test_batcher_buckets_round_to_dp(whisper_pair, whisper_quant_pair):
    """Buckets (2, 6) at dp 4 become (4, 8), as in the JAX package; a
    quantized tree is held whole (replicated)."""
    jparams, tparams, tcfg = whisper_pair
    jb = JBatcher(jparams, jw.WhisperConfig(n_vocab=tcfg.n_vocab, **TINY),
                  j_tokenizer.make_synthetic_tokenizer(), batch_size=(2, 6),
                  mesh=jmesh.make_mesh(dp=4, tp=1, devices=jax.devices()[:4]))
    mesh = Mesh(dp=4, tp=1, rank=0)
    tb = TranscriptionBatcher(tparams, tcfg, t_tokenizer.make_synthetic_tokenizer(),
                              device="cpu", batch_size=(2, 6), mesh=mesh)
    assert tb.buckets == jb.buckets == (4, 8) and tb.batch_size == 8
    _, tquant = whisper_quant_pair
    tb = TranscriptionBatcher(tquant, tcfg, t_tokenizer.make_synthetic_tokenizer(),
                              device="cpu", batch_size=(2, 6), mesh=mesh)
    assert tb.params is tquant


# -- the memory plan ------------------------------------------------------------------


@pytest.mark.parametrize("tp", [1, 2, 4, 8])
@pytest.mark.parametrize("quant", [4, None])
@pytest.mark.parametrize("kv", [8, 4])
def test_memory_plan_equals_jax(tp, quant, kv):
    """Qwen3-32B at its true shapes, at the JAX package's 16 GiB budget
    (its default, a TPU v5e chip's) given explicitly."""
    cfg_j, cfg_t = jqw.QWEN_CONFIGS["qwen3-32b"], tqw.QWEN_CONFIGS["qwen3-32b"]
    want = jmp.plan_qwen_serving(cfg_j, tp=tp, quant_bits=quant, kv_bits=kv)
    got = tmp.plan_qwen_serving(cfg_t, tp=tp, quant_bits=quant, kv_bits=kv,
                                budget_bytes=16 * 2**30)
    assert (got.total_bytes, got.per_device_bytes, got.kv_cache_bytes, got.headroom_bytes,
            got.fits) == (want.total_bytes, want.per_device_bytes, want.kv_cache_bytes,
                          want.headroom_bytes, want.fits)


def test_memory_plan_bf16_cache_and_abstract_tree():
    cfg_j, cfg_t = jqw.QWEN_CONFIGS["qwen3-32b"], tqw.QWEN_CONFIGS["qwen3-32b"]
    for tp in (1, 2, 8):
        want = jmp.plan_qwen_serving(cfg_j, tp=tp)
        got = tmp.plan_qwen_serving(cfg_t, tp=tp, budget_bytes=16 * 2**30)
        assert got == tmp.MemoryPlan(want.total_bytes, want.per_device_bytes,
                                     want.kv_cache_bytes, want.headroom_bytes)
    tree = tmp.abstract_qwen_params(cfg_t, quant_bits=4)
    leaf = tree["layers"][0]["mlp"]["down"]["w"]
    assert leaf.w_q.device.type == "meta" and leaf.shape == (5120, 25600)


def test_memory_plan_shard_math():
    tree = {"a": torch.empty((8, 64), device="meta"), "b": torch.empty((16,), device="meta")}
    total, per_dev = tmp.plan_param_memory(tree, {"a": (None, "tp"), "b": ()}, {"tp": 4})
    assert total == 8 * 64 * 4 + 16 * 4
    assert per_dev == (8 * 64 * 4) // 4 + 16 * 4


def test_memory_plan_budget_from_card(monkeypatch):
    """No TPU default: the budget is the named CUDA card's memory, or an
    argument; neither raises."""
    cfg = tqw.QWEN_CONFIGS["qwen3-32b"]
    with pytest.raises(ValueError, match="budget_bytes"):
        tmp.plan_qwen_serving(cfg, tp=2, quant_bits=4)

    class Props:
        total_memory = 80 * 2**30

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: Props)
    plan = tmp.plan_qwen_serving(cfg, tp=1, quant_bits=4, kv_bits=8, device="cuda:0")
    ref = tmp.plan_qwen_serving(cfg, tp=1, quant_bits=4, kv_bits=8, budget_bytes=80 * 2**30)
    assert plan == ref and plan.fits
    assert plan.headroom_bytes == 80 * 2**30 - plan.per_device_bytes - plan.kv_cache_bytes
