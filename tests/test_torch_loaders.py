"""Port parity: the whisper checkpoint loaders of whisper_mlx_tpu_torch
(mlx-format, HF, OpenAI ``.pt``, native files, ``load_model``) and its
safetensors writer, against the JAX package and the ``safetensors`` package
on the CPU. Every checkpoint is written here from seeded random weights; the
same file or state dict goes through both packages and the trees must agree
leaf for leaf (linears and convs in each package's own layout)."""

from __future__ import annotations

import json

import numpy as np
import pytest

import torch  # noqa: F401  (torch before jax: the reverse order has deadlocked)
import jax
import jax.numpy as jnp

from tests.conftest import make_speechy_audio
from tests.test_torch_transcribe import _write_wav
from tests.test_torch_whisper_quant import _assert_same_tree
from whisper_mlx_tpu.checkpoint import hf_loader as j_hf
from whisper_mlx_tpu.checkpoint import openai_loader as j_openai
from whisper_mlx_tpu.checkpoint import quant_loader as j_mlx
from whisper_mlx_tpu.decoding import tokenizer as j_tokenizer
from whisper_mlx_tpu.models import whisper as jw
from whisper_mlx_tpu.ops import quant as jq
from whisper_mlx_tpu_torch import cli as t_cli
from whisper_mlx_tpu_torch.checkpoint import hf_loader as t_hf
from whisper_mlx_tpu_torch.checkpoint import io_util as t_io
from whisper_mlx_tpu_torch.checkpoint import native_io as t_native
from whisper_mlx_tpu_torch.checkpoint import openai_loader as t_openai
from whisper_mlx_tpu_torch.checkpoint import quant_loader as t_mlx
from whisper_mlx_tpu_torch.checkpoint.convert import params_from_jax
from whisper_mlx_tpu_torch.decoding import task as t_task
from whisper_mlx_tpu_torch.decoding import tokenizer as t_tokenizer
from whisper_mlx_tpu_torch.models import whisper as tw
from whisper_mlx_tpu_torch.ops import quant as tq

DIMS = dict(n_mels=80, n_audio_state=64, n_audio_head=4, n_audio_layer=2,
            n_text_state=64, n_text_head=4, n_text_layer=2)
QUANT = {"bits": 4, "group_size": 64}


@pytest.fixture(scope="module")
def tiny():
    tok = j_tokenizer.make_synthetic_tokenizer()
    jcfg = jw.WhisperConfig(n_vocab=tok.n_vocab, alignment_heads=((1, 0), (1, 2)), **DIMS)
    tcfg = tw.WhisperConfig(n_vocab=tok.n_vocab, alignment_heads=((1, 0), (1, 2)), **DIMS)
    tree = jax.tree.map(np.asarray, jw.init_params(jcfg, seed=7))
    rng = np.random.default_rng(7)
    for blk in tree["decoder"]["blocks"] + tree["encoder"]["blocks"]:
        blk["attn"]["q"]["b"] = (0.1 * rng.standard_normal(64)).astype(np.float32)
        blk["mlp_ln"]["g"] = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    return jax.tree.map(jnp.asarray, tree), jcfg, params_from_jax(tree, tcfg), tcfg


def _dims(config) -> dict:
    return {k: getattr(config, k) for k in ("n_vocab", "n_audio_ctx", "n_text_ctx", *DIMS)}


@pytest.mark.parametrize("quantized", [False, True])
def test_mlx_directory_written_by_jax_loads_in_port(tiny, tmp_path, quantized):
    jparams, jcfg, _, tcfg = tiny
    tree = jq.quantize_params(jparams, **QUANT) if quantized else jparams
    j_mlx.export_mlx_whisper(tree, jcfg, tmp_path, quantization=QUANT if quantized else None)
    jloaded, jc = j_mlx.load_mlx_whisper(tmp_path)
    tloaded, tc = t_mlx.load_mlx_whisper(tmp_path)
    assert tc == tcfg and _dims(tc) == _dims(jc) and tc.alignment_heads == jc.alignment_heads
    n_quant = _assert_same_tree(tloaded, jloaded)
    assert n_quant == (25 if quantized else 0)  # fused qkv: 33 - 4 blocks x 2
    assert ("qkv" in tloaded["decoder"]["blocks"][0]["attn"]) == quantized
    unfused, _ = t_mlx.load_mlx_whisper(tmp_path, fuse_qkv=False)
    assert "q" in unfused["encoder"]["blocks"][0]["attn"]


@pytest.mark.parametrize("quantized", [False, True])
def test_mlx_directory_written_by_port_loads_in_jax(tiny, tmp_path, quantized):
    _, _, tparams, tcfg = tiny
    tree = tq.quantize_params(tparams, **QUANT) if quantized else tparams
    t_mlx.export_mlx_whisper(tree, tcfg, tmp_path, quantization=QUANT if quantized else None)
    cfg = json.loads((tmp_path / "config.json").read_text())
    assert cfg.get("quantization") == (QUANT if quantized else None)
    assert cfg["alignment_heads"] == [[1, 0], [1, 2]]
    jloaded, jc = j_mlx.load_mlx_whisper(tmp_path, fuse_qkv=False)
    assert _dims(jc) == _dims(tcfg)
    _assert_same_tree(tree, jloaded)
    back, _ = t_mlx.load_mlx_whisper(tmp_path, fuse_qkv=False)
    _assert_same_tree(back, jloaded)


def test_mlx_roundtrip_decodes_identically(tiny, tmp_path):
    """As tests/test_quant.py asks of JAX: a quantized export, loaded back
    (fused), decodes token for token like the tree it was written from."""
    _, _, tparams, tcfg = tiny
    qparams = tq.quantize_params(tparams, **QUANT)
    t_mlx.export_mlx_whisper(qparams, tcfg, tmp_path, quantization=QUANT)
    loaded, cfg = t_mlx.load_mlx_whisper(tmp_path)
    tok = t_tokenizer.make_synthetic_tokenizer()
    mel = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 3000, 80))
                           .astype(np.float32))
    opts = t_task.DecodingOptions(sample_len=8)
    a = t_task.decode(qparams, mel, tok, tcfg, opts)
    b = t_task.decode(loaded, mel, tok, cfg, opts)
    assert a[0].tokens == b[0].tokens and a[0].tokens


def test_dequant_at_load(tiny, tmp_path, monkeypatch):
    """WTPU_DEQUANT_AT_LOAD=1 (or dequant=True): dense bf16 weights, unfused,
    the values of JAX's load under the same switch."""
    jparams, jcfg, _, _ = tiny
    j_mlx.export_mlx_whisper(jq.quantize_params(jparams, **QUANT), jcfg, tmp_path,
                             quantization=QUANT)
    packed, _ = t_mlx.load_mlx_whisper(tmp_path, fuse_qkv=False)
    monkeypatch.setenv("WTPU_DEQUANT_AT_LOAD", "1")
    dense, _ = t_mlx.load_mlx_whisper(tmp_path)
    jdense, _ = j_mlx.load_mlx_whisper(tmp_path)
    w = dense["decoder"]["blocks"][0]["attn"]["q"]["w"]
    assert w.dtype == torch.bfloat16 and "qkv" not in dense["decoder"]["blocks"][0]["attn"]
    assert torch.equal(w, packed["decoder"]["blocks"][0]["attn"]["q"]["w"].dequantize(
        torch.bfloat16))
    to_f32 = lambda t: jax.tree.map(lambda a: a.float() if a.dtype == torch.bfloat16 else a, t)  # noqa: E731
    _assert_same_tree(to_f32(dense), jax.tree.map(lambda a: np.asarray(a, np.float32), jdense))
    monkeypatch.delenv("WTPU_DEQUANT_AT_LOAD")
    assert isinstance(t_mlx.load_mlx_whisper(tmp_path)[0]["decoder"]["token_emb"], tq.QuantTensor)
    assert not isinstance(t_mlx.load_mlx_whisper(tmp_path, dequant=True)[0]["decoder"]["token_emb"],
                          tq.QuantTensor)


def _openai_state(jparams) -> dict:
    """The original release's naming from the JAX tree (torch tensors), as
    tests/test_quant.py builds it."""
    sd = {}

    def t(a, perm=None):
        a = np.asarray(a, np.float32)
        return torch.from_numpy(np.array(a if perm is None else a.transpose(perm), order="C"))

    def put_dense(prefix, node):
        sd[f"{prefix}.weight"] = t(node["w"], (1, 0))
        if "b" in node:
            sd[f"{prefix}.bias"] = t(node["b"])

    def put_ln(prefix, node):
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = t(node["g"]), t(node["b"])

    def put_block(pre, blk):
        for part in ("attn", "cross_attn"):
            if part in blk:
                put_ln(f"{pre}.{part}_ln", blk[f"{part}_ln"])
                for k, name in (("q", "query"), ("k", "key"), ("v", "value"), ("o", "out")):
                    put_dense(f"{pre}.{part}.{name}", blk[part][k])
        put_ln(f"{pre}.mlp_ln", blk["mlp_ln"])
        put_dense(f"{pre}.mlp.0", blk["mlp"]["fc1"])
        put_dense(f"{pre}.mlp.2", blk["mlp"]["fc2"])

    enc, dec = jparams["encoder"], jparams["decoder"]
    for name in ("conv1", "conv2"):
        sd[f"encoder.{name}.weight"] = t(enc[name]["w"], (2, 1, 0))
        sd[f"encoder.{name}.bias"] = t(enc[name]["b"])
    sd["encoder.positional_embedding"] = t(enc["pos_emb"])
    for i, blk in enumerate(enc["blocks"]):
        put_block(f"encoder.blocks.{i}", blk)
    put_ln("encoder.ln_post", enc["ln_post"])
    sd["decoder.token_embedding.weight"] = t(dec["token_emb"])
    sd["decoder.positional_embedding"] = t(dec["pos_emb"])
    for i, blk in enumerate(dec["blocks"]):
        put_block(f"decoder.blocks.{i}", blk)
    put_ln("decoder.ln", dec["ln"])
    return sd


def _write_openai_pt(tiny, path) -> None:
    jparams, jcfg, _, _ = tiny
    torch.save({"dims": _dims(jcfg), "model_state_dict": _openai_state(jparams)}, path)


def test_openai_pt_loader(tiny, tmp_path):
    jparams, jcfg, tparams, _ = tiny
    pt = tmp_path / "model.pt"
    _write_openai_pt(tiny, pt)
    tloaded, tc = t_openai.load_openai_whisper(pt)
    jloaded, jc = j_openai.load_openai_whisper(pt)
    assert _dims(tc) == _dims(jc) == _dims(jcfg)
    _assert_same_tree(tloaded, jloaded)
    _assert_same_tree(tloaded, jparams)
    assert tloaded["encoder"]["conv1"]["w"].shape == tparams["encoder"]["conv1"]["w"].shape
    half, _ = t_openai.load_openai_whisper(pt, dtype=torch.bfloat16)
    assert half["decoder"]["ln"]["g"].dtype == torch.bfloat16


HF_ATTN = (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("o", "out_proj"))


def _hf_state(jparams) -> dict:
    """An HF-named state dict of numpy arrays from the JAX tree."""
    sd = {}

    def put_dense(prefix, node):
        sd[f"{prefix}.weight"] = np.ascontiguousarray(np.asarray(node["w"], np.float32).T)
        if "b" in node:
            sd[f"{prefix}.bias"] = np.asarray(node["b"], np.float32)

    def put_ln(prefix, node):
        sd[f"{prefix}.weight"] = np.asarray(node["g"], np.float32)
        sd[f"{prefix}.bias"] = np.asarray(node["b"], np.float32)

    for side in ("encoder", "decoder"):
        part = jparams[side]
        for i, blk in enumerate(part["blocks"]):
            pre = f"model.{side}.layers.{i}"
            put_ln(f"{pre}.self_attn_layer_norm", blk["attn_ln"])
            for k, name in HF_ATTN:
                put_dense(f"{pre}.self_attn.{name}", blk["attn"][k])
            if "cross_attn" in blk:
                put_ln(f"{pre}.encoder_attn_layer_norm", blk["cross_attn_ln"])
                for k, name in HF_ATTN:
                    put_dense(f"{pre}.encoder_attn.{name}", blk["cross_attn"][k])
            put_ln(f"{pre}.final_layer_norm", blk["mlp_ln"])
            put_dense(f"{pre}.fc1", blk["mlp"]["fc1"])
            put_dense(f"{pre}.fc2", blk["mlp"]["fc2"])
    enc, dec = jparams["encoder"], jparams["decoder"]
    for name in ("conv1", "conv2"):
        sd[f"model.encoder.{name}.weight"] = np.ascontiguousarray(
            np.asarray(enc[name]["w"], np.float32).transpose(2, 1, 0))
        sd[f"model.encoder.{name}.bias"] = np.asarray(enc[name]["b"], np.float32)
    sd["model.encoder.embed_positions.weight"] = np.asarray(enc["pos_emb"], np.float32)
    put_ln("model.encoder.layer_norm", enc["ln_post"])
    sd["model.decoder.embed_tokens.weight"] = np.asarray(dec["token_emb"], np.float32)
    sd["model.decoder.embed_positions.weight"] = np.asarray(dec["pos_emb"], np.float32)
    put_ln("model.decoder.layer_norm", dec["ln"])
    return sd


def _hf_config(config) -> dict:
    return dict(num_mel_bins=config.n_mels, vocab_size=config.n_vocab,
                d_model=config.n_audio_state, encoder_attention_heads=config.n_audio_head,
                encoder_layers=config.n_audio_layer, decoder_attention_heads=config.n_text_head,
                decoder_layers=config.n_text_layer, max_source_positions=1500,
                max_target_positions=448)


def test_hf_state_dict_converts_like_jax(tiny, tmp_path):
    jparams, jcfg, _, _ = tiny
    state = _hf_state(jparams)
    tc, jc = t_hf.config_from_hf(_hf_config(jcfg)), j_hf.config_from_hf(_hf_config(jcfg))
    assert _dims(tc) == _dims(jc) == _dims(jcfg)
    tloaded = t_hf.convert_hf_whisper_state(state, tc)
    _assert_same_tree(tloaded, j_hf.convert_hf_whisper_state(state, jc))
    _assert_same_tree(tloaded, jparams)
    as_torch = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    _assert_same_tree(t_hf.convert_hf_whisper_state(as_torch, tc), jparams)
    # a directory: config.json and a shard written by the port's own writer
    (tmp_path / "config.json").write_text(json.dumps(_hf_config(jcfg)))
    t_io.save_safetensors_file(tmp_path / "model.safetensors", state)
    from_dir, dc = t_hf.load_whisper(tmp_path)
    assert _dims(dc) == _dims(jcfg)
    _assert_same_tree(from_dir, j_hf.load_whisper(tmp_path)[0])


@pytest.mark.parametrize("quantized", [False, True])
def test_native_io_roundtrip(tiny, tmp_path, quantized):
    """save_params / load_params keep fp and quantized (fused) trees exactly."""
    _, _, tparams, tcfg = tiny
    tree = tq.fuse_whisper_qkv(tq.quantize_params(tparams, **QUANT)) if quantized else tparams
    path = t_native.save_params(tree, tmp_path / "sub" / "p.safetensors")
    back = t_native.load_params(path)
    assert isinstance(back["decoder"]["blocks"], list) and len(back["decoder"]["blocks"]) == 2
    leaves = lambda t: jax.tree.leaves(jax.tree.map(lambda a: a, t,  # noqa: E731
                                                    is_leaf=lambda n: isinstance(n, tq.QuantTensor)),
                                       is_leaf=lambda n: isinstance(n, tq.QuantTensor))
    n_quant = 0
    for a, b in zip(leaves(tree), leaves(back), strict=True):
        if isinstance(a, tq.QuantTensor):
            assert (a.bits, a.group_size) == (b.bits, b.group_size)
            assert torch.equal(a.w_q, b.w_q) and torch.equal(a.scales, b.scales)
            assert torch.equal(a.biases, b.biases)
            n_quant += 1
        else:
            assert torch.equal(a, b)
    assert n_quant == (25 if quantized else 0)
    half = t_native.load_params(path, dtype=torch.bfloat16)
    assert half["encoder"]["ln_post"]["g"].dtype == torch.bfloat16
    if quantized:
        assert half["decoder"]["token_emb"].scales.dtype == torch.float32
    bf = t_native.save_params({"x": [torch.arange(6).reshape(2, 3).to(torch.bfloat16)]},
                              tmp_path / "bf.safetensors")
    assert torch.equal(t_native.load_params(bf)["x"][0], torch.arange(6.0).reshape(2, 3))


def test_safetensors_writer_against_the_package(tmp_path):
    """Both directions: a file of the port's writer read by ``safetensors``,
    and a file of the package read by the port's reader."""
    st_numpy = pytest.importorskip("safetensors.numpy")
    st_torch = pytest.importorskip("safetensors.torch")
    rng = np.random.default_rng(0)
    tensors = {
        "w.weight": rng.integers(0, 2**32, (5, 8), dtype=np.uint32),
        "w.scales": rng.standard_normal((5, 1)).astype(np.float16),
        "b": rng.standard_normal(7).astype(np.float32),
        "ids": np.arange(-3, 3, dtype=np.int64),
        "codes": rng.integers(-127, 128, (2, 3, 4)).astype(np.int8),
        "scalar": np.array(2.5, np.float32),
        "empty": np.zeros((0, 4), np.float32),
    }
    t_io.save_safetensors_file(tmp_path / "ours.safetensors", tensors)
    theirs = st_numpy.load_file(str(tmp_path / "ours.safetensors"))
    assert sorted(theirs) == sorted(tensors)
    for name, a in tensors.items():
        assert theirs[name].dtype == a.dtype and theirs[name].shape == a.shape
        np.testing.assert_array_equal(theirs[name], a)
    st_numpy.save_file(tensors, str(tmp_path / "theirs.safetensors"))
    ours = t_io.load_safetensors_file(tmp_path / "theirs.safetensors")
    for name, a in tensors.items():
        assert ours[name].dtype == a.dtype
        np.testing.assert_array_equal(ours[name], a)
    # bf16, which numpy lacks, through torch tensors
    bf = {"x": torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32)).bfloat16(),
          "n": torch.arange(4, dtype=torch.int32)}
    t_io.save_safetensors_file(tmp_path / "bf.safetensors", bf)
    back = st_torch.load_file(str(tmp_path / "bf.safetensors"))
    assert back["x"].dtype == torch.bfloat16 and torch.equal(back["x"], bf["x"])
    assert torch.equal(back["n"], bf["n"])
    np.testing.assert_array_equal(t_io.load_safetensors_file(tmp_path / "bf.safetensors")["x"],
                                  bf["x"].float().numpy())
    with pytest.raises(ValueError, match="unsupported dtype"):
        t_io.save_safetensors_file(tmp_path / "bad.safetensors",
                                   {"c": np.zeros(2, np.complex64)})


@pytest.mark.parametrize("kind", ["openai_pt", "mlx_q4", "mlx_fp", "hf", "model_dir"])
def test_load_model_resolves_each_kind_of_path(tiny, tmp_path, kind):
    """``--model`` as a .pt file, an mlx-format directory (packed, fused), an
    HF directory, or a name under ``--model-dir``; the synthetic tokenizer
    where the directory has none."""
    jparams, jcfg, tparams, tcfg = tiny
    model_dir = None
    if kind == "openai_pt":
        model = tmp_path / "tiny.pt"
        _write_openai_pt(tiny, model)
    elif kind in ("mlx_q4", "mlx_fp", "model_dir"):
        model = tmp_path / ("org--whisper-tiny-q4" if kind == "model_dir" else "ckpt")
        quant = kind != "mlx_fp"
        t_mlx.export_mlx_whisper(tq.quantize_params(tparams, **QUANT) if quant else tparams,
                                 tcfg, model, quantization=QUANT if quant else None)
        if kind == "model_dir":
            model, model_dir = "org/whisper-tiny-q4", str(tmp_path)
    else:
        model = tmp_path / "hf"
        model.mkdir()
        (model / "config.json").write_text(json.dumps(_hf_config(jcfg)))
        t_io.save_safetensors_file(model / "model.safetensors", _hf_state(jparams))
    params, config, tokenizer = t_cli.load_model(str(model), model_dir, torch.device("cpu"))
    assert _dims(config) == _dims(tcfg)
    assert tokenizer.n_vocab == t_tokenizer.make_synthetic_tokenizer().n_vocab
    attn = params["decoder"]["blocks"][0]["attn"]
    if kind in ("mlx_q4", "model_dir"):
        assert isinstance(attn["qkv"]["w"], tq.QuantTensor)
        assert isinstance(params["decoder"]["token_emb"], tq.QuantTensor)
    else:
        _assert_same_tree(params, jparams)


def test_cli_transcribes_from_a_checkpoint_directory(tiny, tmp_path):
    """The CLI with --model <mlx-format 4-bit directory> on the CPU."""
    _, _, tparams, tcfg = tiny
    ckpt = tmp_path / "ckpt"
    t_mlx.export_mlx_whisper(tq.quantize_params(tparams, **QUANT), tcfg, ckpt, quantization=QUANT)
    wav = tmp_path / "a.wav"
    _write_wav(wav, make_speechy_audio(3.0))
    rc = t_cli.main([str(wav), "-f", "txt", "--output-name", "out", "-o", str(tmp_path),
                     "--model", str(ckpt), "--device", "cpu", "--verbose", "False",
                     "--condition-on-previous-text", "False",
                     "--temperature-increment-on-fallback", "None"])
    assert rc == 0 and (tmp_path / "out.txt").exists()
    with pytest.raises(SystemExit, match="model not found"):
        t_cli.load_model("no-such-model", None, torch.device("cpu"))
