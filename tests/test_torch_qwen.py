"""Port parity: the Qwen model, its converter and its checkpoint loader in
whisper_mlx_tpu_torch against the JAX package at fp32 on the CPU.

decode_step runs a 9-token prefill and then 6 incremental steps on the
reference's tiny Qwen2 (GQA, q/k/v bias, tied head) and Qwen3 (qk-norm,
head_dim != hidden/heads, untied head) configs, with fp and fused 4-bit
weights, the flash prefill on (the reference's Pallas kernel in interpret
mode) and off, and per-row positions. Norm gains and biases are randomized
so a wrong layout shows. Tolerance 1e-4 * max(1, |ref|): RoPE's cos/sin
differ by an ulp between the libraries, and the quantized matmul adds the
bias as xg @ b^T where the reference dequantizes first (~1e-6 relative).
"""

from __future__ import annotations

import dataclasses
import json
import sys
from unittest import mock

import numpy as np
import pytest

import torch  # noqa: F401  (torch before jax, as in the other test files)
import jax
import jax.numpy as jnp

from whisper_mlx_tpu.checkpoint import io_util as j_io
from whisper_mlx_tpu.checkpoint import qwen_loader as j_loader
from whisper_mlx_tpu.models import qwen as jqw
from whisper_mlx_tpu.ops import flash_attention as j_fa
from whisper_mlx_tpu.ops import quant as jq
from whisper_mlx_tpu_torch.checkpoint import io_util as t_io
from whisper_mlx_tpu_torch.checkpoint import qwen_loader as t_loader
from whisper_mlx_tpu_torch.checkpoint.convert import qwen_params_from_jax
from whisper_mlx_tpu_torch.models import qwen as tqw
from whisper_mlx_tpu_torch.ops import quant as tq

QWEN2_TINY = dict(
    model_type="qwen2", vocab_size=512, hidden_size=64, intermediate_size=128,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
    rope_theta=10_000.0, rms_norm_eps=1e-6, tie_word_embeddings=True,
    max_position_embeddings=512,
)
QWEN3_TINY = dict(
    model_type="qwen3", vocab_size=512, hidden_size=64, intermediate_size=128,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
    head_dim=32, rope_theta=1e6, rms_norm_eps=1e-6, tie_word_embeddings=False,
    max_position_embeddings=512,
)
TINY = {"qwen2": QWEN2_TINY, "qwen3": QWEN3_TINY}
TOL = 1e-4


def _perturb(tree, rng):
    """Randomize norm gains (1-D leaves other than biases) and biases."""
    if isinstance(tree, dict):
        return {k: _perturb(v, rng) if isinstance(v, (dict, list)) else
                ((0.1 * rng.standard_normal(v.shape)).astype(np.float32) if k == "b"
                 else (1 + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
                 if v.ndim == 1 else v)
                for k, v in tree.items()}
    return [_perturb(v, rng) for v in tree]


def _quantize_layers(tree):
    """The reference's 4-bit walker over the layers, then its fusion."""
    layers = jq.quantize_params({"encoder": {"layers": tree["layers"]}, "decoder": {}},
                                bits=4, group_size=64)["encoder"]["layers"]
    return jq.fuse_qwen_projections(dict(tree, layers=layers))


def _pair(name: str, quant: bool):
    jcfg = j_loader.config_from_hf(TINY[name])
    tcfg = t_loader.config_from_hf(TINY[name])
    tree = _perturb(jax.tree.map(np.asarray, jqw.init_params(jcfg, seed=1)),
                    np.random.default_rng(1))
    if quant:
        tree = jax.tree.map(np.asarray, _quantize_layers(tree))
    return jax.tree.map(jnp.asarray, tree), jcfg, qwen_params_from_jax(tree, tcfg), tcfg


def _jax_interp_flash(q, k, v, **kw):
    return _ORIG_FLASH(q, k, v, **{**kw, "interpret": True, "tile_q": 8, "tile_k": 128})


_ORIG_FLASH = j_fa.flash_attention


def _compare(name, quant, flash, per_row):
    jparams, jcfg, tparams, tcfg = _pair(name, quant)
    jcfg = dataclasses.replace(jcfg, flash_attention=flash)
    tcfg = dataclasses.replace(tcfg, flash_attention=flash)
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, 512, size=(2, 9)).astype(np.int32)
    steps = rng.integers(0, 512, size=(6, 2, 1)).astype(np.int32)
    jcache = jqw.init_kv_cache(jcfg, 2, 32)
    tcache = tqw.init_kv_cache(tcfg, 2, 32)
    with mock.patch.object(j_fa, "flash_attention", _jax_interp_flash):
        ref, jcache = jqw.decode_step(jparams, jnp.asarray(prompt), jnp.int32(0), jcache, jcfg)
    got, tcache = tqw.decode_step(tparams, torch.from_numpy(prompt).long(), 0, tcache, tcfg)
    outs = [(np.asarray(ref), got.numpy())]
    for i, tok in enumerate(steps):
        pos = [9 + i, 5 + 2 * i] if per_row else 9 + i
        jpos = jnp.asarray(pos, jnp.int32) if per_row else jnp.int32(pos)
        ref, jcache = jqw.decode_step(jparams, jnp.asarray(tok), jpos, jcache, jcfg)
        got, tcache = tqw.decode_step(tparams, torch.from_numpy(tok).long(), pos, tcache, tcfg)
        outs.append((np.asarray(ref), got.numpy()))
    for ref, got in outs:
        assert got.shape == ref.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, ref, atol=TOL * max(1.0, np.abs(ref).max()), rtol=0)


@pytest.mark.parametrize("name", ["qwen2", "qwen3"])
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int4"])
@pytest.mark.parametrize("flash", [False, True], ids=["xla", "flash"])
def test_decode_steps_match_jax(name, quant, flash):
    _compare(name, quant, flash, per_row=False)


@pytest.mark.parametrize("name", ["qwen2", "qwen3"])
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int4"])
def test_decode_steps_per_row_positions_match_jax(name, quant):
    _compare(name, quant, flash=True, per_row=True)


def test_configs_match_jax():
    assert sorted(tqw.QWEN_CONFIGS) == sorted(jqw.QWEN_CONFIGS)
    fields = [f.name for f in dataclasses.fields(tqw.QwenConfig) if f.name != "dtype"]
    for name, tcfg in tqw.QWEN_CONFIGS.items():
        jcfg = jqw.QWEN_CONFIGS[name]
        assert {f: getattr(tcfg, f) for f in fields} == {f: getattr(jcfg, f) for f in fields}
        assert tcfg.hd == jcfg.hd
    big = tqw.QWEN_CONFIGS["qwen3-32b"]
    assert (big.num_hidden_layers, big.hidden_size, big.num_attention_heads,
            big.num_key_value_heads, big.hd, big.intermediate_size, big.vocab_size) == (
        64, 5120, 64, 8, 128, 25600, 151936)


@pytest.mark.parametrize("name", ["qwen2", "qwen3"])
def test_init_params_equals_converted_jax_init(name):
    jcfg = j_loader.config_from_hf(TINY[name])
    tcfg = t_loader.config_from_hf(TINY[name])
    ref = qwen_params_from_jax(jax.tree.map(np.asarray, jqw.init_params(jcfg, seed=4)), tcfg)
    got = tqw.init_params(tcfg, seed=4)
    flat_ref, flat_got = jax.tree.leaves(ref), jax.tree.leaves(got)
    assert jax.tree.structure(ref) == jax.tree.structure(got)
    for a, b in zip(flat_ref, flat_got):
        assert torch.equal(a, b)


def test_rope_tables_match_jax():
    pos = np.arange(0, 4096, 37)
    jc, js = jqw.rope_cos_sin(jnp.asarray(pos), 128, 1e6, jnp.float32)
    tc, ts = tqw.rope_cos_sin(torch.from_numpy(pos), 128, 1e6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-6)


def test_converter_keeps_quant_leaves_and_rejects_others():
    jparams, _, tparams, tcfg = _pair("qwen3", quant=True)
    qkv = tparams["layers"][0]["attn"]["qkv"]["w"]
    ref = jparams["layers"][0]["attn"]["qkv"]["w"]
    assert isinstance(qkv, tq.QuantTensor) and qkv.shape == ref.shape
    np.testing.assert_array_equal(qkv.w_q.numpy().view(np.uint32), np.asarray(ref.w_q))
    np.testing.assert_array_equal(tparams["lm_head"]["w"].numpy(),
                                  np.asarray(jparams["lm_head"]["w"]).T)
    bad = jax.tree.map(np.asarray, jparams)
    bad["layers"][0]["post_ln"] = np.zeros(64, np.int8)
    with pytest.raises(NotImplementedError, match="qwen_params_from_jax"):
        qwen_params_from_jax(bad, tcfg)
    with pytest.raises(ValueError, match="lm_head"):
        qwen_params_from_jax({k: v for k, v in bad.items() if k != "lm_head"}, tcfg)


def test_flash_prefill_raises_off_position_zero():
    cfg = dataclasses.replace(t_loader.config_from_hf(QWEN2_TINY), flash_attention=True)
    params = tqw.init_params(cfg, seed=0)
    with pytest.raises(ValueError, match="position 0"):
        tqw.decode_step(params, torch.zeros((1, 4), dtype=torch.long), 3,
                        tqw.init_kv_cache(cfg, 1, 16), cfg)


@pytest.mark.parametrize("pos", [3, [3, 4]], ids=["scalar", "per_row"])
def test_kv_bits_raises(pos):
    cfg = t_loader.config_from_hf(QWEN2_TINY)
    params = tqw.init_params(cfg, seed=0)
    cache = tqw.init_kv_cache(cfg, 2, 16)
    with pytest.raises(NotImplementedError, match="M12"):
        tqw.decode_step(params, torch.zeros((2, 1), dtype=torch.long), pos, cache,
                        dataclasses.replace(cfg, kv_bits=8))
    with pytest.raises(NotImplementedError, match="M12"):
        tqw.init_kv_cache(dataclasses.replace(cfg, kv_bits=4), 1, 16)


@pytest.mark.parametrize("name", ["qwen2", "qwen3"])
def test_random_quant_params(name):
    """Random packed weights at a tiny width: fused layout, std ~ 1/sqrt(in)."""
    cfg = dataclasses.replace(t_loader.config_from_hf(TINY[name]), hidden_size=256,
                              intermediate_size=512, vocab_size=300)
    params = tqw.init_random_quant_params(cfg, seed=0, device="cpu")
    blk = params["layers"][0]
    attn = ["k_norm", "o", "q_norm", "qkv"] if name == "qwen3" else ["o", "qkv"]
    assert sorted(blk["attn"]) == attn and ("b" in blk["attn"]["qkv"]) == (name == "qwen2")
    assert blk["attn"]["qkv"]["w"].shape == (cfg.hd * (4 + 2 * 2), 256)
    assert ("lm_head" in params) == (name == "qwen3")
    assert blk["mlp"]["gate_up"]["w"].shape == (1024, 256)
    w = blk["mlp"]["down"]["w"].dequantize()
    assert abs(float(w.std()) * 512 ** 0.5 - 1.0) < 0.1 and abs(float(w.mean())) < 0.01
    logits, _ = tqw.decode_step(params, torch.tensor([[1, 2, 3]]), 0,
                                tqw.init_kv_cache(cfg, 1, 8), cfg)
    assert logits.shape == (1, 3, 300) and torch.isfinite(logits).all()


# ---------------------------------------------------------------------------
# checkpoint loading
# ---------------------------------------------------------------------------


def _write_mlx_checkpoint(path, name: str = "qwen3"):
    """A tiny mlx-community-style checkpoint: 4-bit linears (U32 codes, F16
    scales and biases), quantized embedding, F32 norms, one shard."""
    from safetensors.numpy import save_file

    cfg = dict(TINY[name], quantization={"group_size": 64, "bits": 4})
    jcfg = j_loader.config_from_hf(cfg)
    tree = _perturb(jax.tree.map(np.asarray, jqw.init_params(jcfg, seed=5)),
                    np.random.default_rng(5))
    state = {}

    def put_linear(prefix, node):
        w_q, s, b = jq.quantize(np.asarray(node["w"]).T, bits=4, group_size=64)
        state[f"{prefix}.weight"] = w_q
        state[f"{prefix}.scales"] = s.astype(np.float16)
        state[f"{prefix}.biases"] = b.astype(np.float16)
        if "b" in node:
            state[f"{prefix}.bias"] = node["b"]

    for i, blk in enumerate(tree["layers"]):
        pre = f"model.layers.{i}"
        for k in ("q", "k", "v", "o"):
            put_linear(f"{pre}.self_attn.{k}_proj", blk["attn"][k])
        for k in ("q_norm", "k_norm"):
            if k in blk["attn"]:
                state[f"{pre}.self_attn.{k}.weight"] = blk["attn"][k]
        for k in ("gate", "up", "down"):
            put_linear(f"{pre}.mlp.{k}_proj", blk["mlp"][k])
        state[f"{pre}.input_layernorm.weight"] = blk["input_ln"]
        state[f"{pre}.post_attention_layernorm.weight"] = blk["post_ln"]
    w_q, s, b = jq.quantize(tree["embed"], bits=4, group_size=64)
    state.update({"model.embed_tokens.weight": w_q, "model.embed_tokens.scales": s,
                  "model.embed_tokens.biases": b, "model.norm.weight": tree["final_ln"]})
    if "lm_head" in tree:
        w_q, s, b = jq.quantize(np.asarray(tree["lm_head"]["w"]).T, bits=4, group_size=64)
        state.update({"lm_head.weight": w_q, "lm_head.scales": s, "lm_head.biases": b})
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(cfg))
    save_file({k: np.ascontiguousarray(v) for k, v in state.items()},
              str(path / "model.safetensors"))
    return path


def _assert_same_params(jparams, jcfg, tparams, tcfg):
    fields = [f.name for f in dataclasses.fields(tcfg) if f.name != "dtype"]
    assert {f: getattr(tcfg, f) for f in fields} == {f: getattr(jcfg, f) for f in fields}
    ref = qwen_params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    leaves = lambda t: jax.tree.leaves(t, is_leaf=lambda n: isinstance(n, tq.QuantTensor))  # noqa: E731
    assert jax.tree.structure(ref, is_leaf=lambda n: isinstance(n, tq.QuantTensor)) == \
        jax.tree.structure(tparams, is_leaf=lambda n: isinstance(n, tq.QuantTensor))
    for a, b in zip(leaves(ref), leaves(tparams)):
        if isinstance(a, tq.QuantTensor):
            assert (a.bits, a.group_size) == (b.bits, b.group_size)
            for f in ("w_q", "scales", "biases"):
                assert torch.equal(getattr(a, f), getattr(b, f)), f
        else:
            assert torch.equal(a, b)


@pytest.mark.parametrize("hide_safetensors", [False, True])
@pytest.mark.parametrize("name", ["qwen2", "qwen3"])
def test_load_qwen_matches_jax(tmp_path, monkeypatch, name, hide_safetensors):
    path = _write_mlx_checkpoint(tmp_path / "ckpt", name)
    jparams, jcfg = j_loader.load_qwen(path)
    if hide_safetensors:  # the GPU machine has no safetensors package
        monkeypatch.setitem(sys.modules, "safetensors", None)
        monkeypatch.setitem(sys.modules, "safetensors.numpy", None)
    tparams, tcfg = t_loader.load_qwen(path, device="cpu")
    assert "qkv" in tparams["layers"][0]["attn"]
    _assert_same_params(jparams, jcfg, tparams, tcfg)


def test_safetensors_reader_matches_jax_with_bf16(tmp_path):
    """Every stored dtype is kept but bf16, which numpy lacks: the port
    returns it as fp32 (the reference returns fp32 or an ml_dtypes bf16,
    depending on its safetensors version); the values are equal."""
    from safetensors.torch import save_file

    rng = np.random.default_rng(9)
    tensors = {"a": torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32)),
               "b": torch.from_numpy(rng.standard_normal((4,)).astype(np.float16)),
               "c": torch.from_numpy(rng.standard_normal((2, 8)).astype(np.float32)).bfloat16(),
               "d": torch.from_numpy(rng.integers(0, 2**31, (2, 3)).astype(np.int32))}
    save_file(tensors, str(tmp_path / "x.safetensors"))
    ref = j_io.load_safetensors_file(tmp_path / "x.safetensors")
    got = t_io.load_safetensors_file(tmp_path / "x.safetensors")
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == (np.float32 if k == "c" else ref[k].dtype), k
        np.testing.assert_array_equal(got[k], ref[k].astype(got[k].dtype))
    with pytest.raises(FileNotFoundError):
        t_io.load_safetensors_dir(tmp_path / "missing")


@pytest.mark.parametrize("name", ["qwen2", "qwen3"])
def test_loaded_checkpoint_decode_matches_jax(tmp_path, name):
    """A loaded mlx checkpoint (quantized embedding; Qwen2's head tied
    through embed_logits, Qwen3's a quantized lm_head) decodes as JAX's."""
    path = _write_mlx_checkpoint(tmp_path / "ckpt", name)
    jparams, jcfg = j_loader.load_qwen(path)
    tparams, tcfg = t_loader.load_qwen(path, device="cpu")
    assert isinstance(tparams["embed"], tq.QuantTensor)
    toks = np.random.default_rng(3).integers(0, 512, size=(1, 7)).astype(np.int32)
    jcache, tcache = jqw.init_kv_cache(jcfg, 1, 16), tqw.init_kv_cache(tcfg, 1, 16)
    for pos, chunk in ((0, toks[:, :5]), (5, toks[:, 5:6]), (6, toks[:, 6:7])):
        ref, jcache = jqw.decode_step(jparams, jnp.asarray(chunk), jnp.int32(pos), jcache, jcfg)
        got, tcache = tqw.decode_step(tparams, torch.from_numpy(chunk).long(), pos, tcache, tcfg)
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, atol=TOL * max(1.0, np.abs(ref).max()),
                                   rtol=0)
