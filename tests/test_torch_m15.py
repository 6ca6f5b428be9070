"""Port parity for the reference's last opt-ins (ROADMAP M15) and fault F9,
on the CPU against the JAX package, the same seeded numpy inputs in both:

- K8's split mode (the shared-prefix beam scheme) and its per-lane layout
  (``decode_step(beam_ancestry=)`` over a per-lane cache), plain versions
  against ``attention_int8_shared`` / ``attention_fp_shared`` (the S buffer
  built the reference's way) and ``attention_int8_ancestry`` /
  ``attention_fp_ancestry``; F9 through ``decode_step``;
- the time-major layouts: the plain ports of the reference's three
  time-major attentions against JAX's and against K3's plain version
  through ``tmajor_cache_from_jax``; greedy and beam under each field;
- native-code residency: ``native_group_matmul`` by the row rule,
  ``prepare_native_params``, ``promote_resident_native`` and the LLM engine
  (with a draft, and beside A8 and MBT) against the reference's;
- ``beam_decode(kv_scheme="shared")`` token for token, with its split
  trajectory (s_fill at every split step) equal to the reference's.

Tolerances are stated at each comparison: fp32 sums in another order.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import pytest

import torch  # noqa: F401  (torch before jax: the reverse order has deadlocked)
import jax
import jax.numpy as jnp

from tests.test_torch_beam import DIMS as BEAM_DIMS
from tests.test_torch_beam import _inputs as beam_inputs
from whisper_mlx_tpu.decoding import beam as jb
from whisper_mlx_tpu.decoding import task as jt
from whisper_mlx_tpu.decoding.filters import FilterConfig as JFilter
from whisper_mlx_tpu.decoding.llm_tokenizer import ByteFallbackTokenizer as JTok
from whisper_mlx_tpu.decoding.tokenizer import make_synthetic_tokenizer as j_tokenizer
from whisper_mlx_tpu.inference.generate import LLMEngine as JEngine
from whisper_mlx_tpu.models import qwen as jqw
from whisper_mlx_tpu.models import whisper as jw
from whisper_mlx_tpu.ops import kv_quant as jkv
from whisper_mlx_tpu.ops import quant as jq
from whisper_mlx_tpu_torch.checkpoint.convert import (
    params_from_jax,
    qwen_params_from_jax,
    tmajor_cache_from_jax,
)
from whisper_mlx_tpu_torch.decoding import beam as tb
from whisper_mlx_tpu_torch.decoding import task as tt
from whisper_mlx_tpu_torch.decoding.filters import FilterConfig as TFilter
from whisper_mlx_tpu_torch.decoding.llm_tokenizer import ByteFallbackTokenizer as TTok
from whisper_mlx_tpu_torch.decoding.tokenizer import make_synthetic_tokenizer as t_tokenizer
from whisper_mlx_tpu_torch.inference import generate as tg
from whisper_mlx_tpu_torch.models import qwen as tqw
from whisper_mlx_tpu_torch.models import whisper as tw
from whisper_mlx_tpu_torch.ops import beamflat_attention as bf
from whisper_mlx_tpu_torch.ops import decode_attention as da
from whisper_mlx_tpu_torch.ops import kv_quant as tkv
from whisper_mlx_tpu_torch.ops import quant as tq

ATOL = 1e-5  # times max(1, |ref|max): fp32 attention and matmuls, sums in another order


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got, ref, tol=ATOL):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=0,
                               atol=tol * max(1.0, float(np.abs(ref).max())))


def _codes(x, bits):
    """JAX quantize_kv on numpy x (b, h, t, d) -> (JAX codes, JAX scales
    (b, h, t, 1), the port's codes (int4 packed), the port's bf16 scales)."""
    c, s = jkv.quantize_kv(jnp.asarray(x), bits)
    tc = _t(np.asarray(c.astype(jnp.int8)))
    if bits == 4:
        tc = da.pack_int4(tc)
    return c, s, tc, _t(np.asarray(s[..., 0].astype(jnp.float32))).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# K8's split mode and per-lane layout: plain versions against the reference
# ---------------------------------------------------------------------------


def _agreed_ancestry(rng, n, g, t_pos, fills):
    """Random lanes, each window's lanes agreeing below its s_fill, as the
    shared scheme's commits keep them."""
    anc = rng.integers(0, g, (n, g, t_pos)).astype(np.int32)
    for w, f in enumerate(fills):
        anc[w, :, :f] = anc[w, 0, :f]
    return anc.reshape(n * g, t_pos)


def _s_buffer(a, anc, n, g, ts, axis):
    """The reference's S buffer (``beam.py:_build_S``): the agreed lane's
    flat-cache column of each position below ``ts``."""
    idx = np.arange(ts)[None, :] * g + anc.reshape(n, g, -1)[:, 0, :ts]
    shape = [n, 1, 1, 1][:a.ndim]
    shape[axis] = ts
    return jnp.take_along_axis(a, jnp.asarray(idx).reshape(shape), axis=axis)


# (W, pos, s_fill a window): s_fill 0, mid and pos; [s_fill, pos] inside W,
# as the beam loop's overflow rule keeps it
SPLIT_CASES = [(64, 30, (0, 0)), (64, 30, (15, 9)), (64, 30, (30, 30)), (4, 3, (0, 0)),
               (4, 30, (28, 27)), (4, 30, (30, 29))]


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("window,pos,fills", SPLIT_CASES)
def test_split_plain_matches_attention_int8_shared(mxu, window, pos, fills):
    rng = np.random.default_rng(pos + window)
    n, g, h, t_pos, d = 2, 3, 4, 40, 64
    kx = rng.standard_normal((n, h, t_pos * g, d)).astype(np.float32) * 0.35
    vx = rng.standard_normal((n, h, t_pos * g, d)).astype(np.float32)
    q = rng.standard_normal((n * g, h, 1, d)).astype(np.float32) * 0.35
    anc = _agreed_ancestry(rng, n, g, t_pos, fills)
    k8, ks, tk, tks = _codes(kx, 8)
    v8, vs, tv, tvs = _codes(vx, 8)
    k8t, v8t = jnp.swapaxes(k8, 2, 3), jnp.swapaxes(v8, 2, 3)
    s_fill = np.array(fills, np.int32)
    ref = jkv.attention_int8_shared(
        jnp.asarray(q), _s_buffer(k8t, anc, n, g, t_pos, 3), _s_buffer(ks, anc, n, g, t_pos, 2),
        _s_buffer(v8t, anc, n, g, t_pos, 3), _s_buffer(vs, anc, n, g, t_pos, 2), k8t, ks, v8t,
        vs, jnp.asarray(anc), jnp.asarray(s_fill), pos, g, window, mxu=mxu)
    got = bf.beamflat_attention(_t(q), tk, tks, tv, tvs, _t(anc), pos, g, int_dot=mxu,
                                s_fill=_t(s_fill))
    _close(got, ref)
    # the overflow flag: the flat function, K8's flat mode
    flat = bf.beamflat_attention(_t(q), tk, tks, tv, tvs, _t(anc), pos, g, int_dot=mxu)
    over = bf.beamflat_attention(_t(q), tk, tks, tv, tvs, _t(anc), pos, g, int_dot=mxu,
                                 s_fill=_t(s_fill), overflow=torch.ones((), dtype=torch.bool))
    assert torch.equal(over, flat)
    _close(flat, jkv.attention_int8_beamflat(jnp.asarray(q), k8t, ks, v8t, vs,
                                             jnp.asarray(anc), pos, g, mxu=mxu))


@pytest.mark.parametrize("window,pos,fills", SPLIT_CASES[:3] + SPLIT_CASES[4:5])
def test_split_fp_cache_matches_attention_fp_shared(window, pos, fills):
    rng = np.random.default_rng(pos)
    n, g, h, t_pos, d = 2, 3, 4, 40, 64
    kf = rng.standard_normal((n, h, t_pos * g, d)).astype(np.float32)
    vf = rng.standard_normal((n, h, t_pos * g, d)).astype(np.float32)
    q = rng.standard_normal((n * g, h, 1, d)).astype(np.float32)
    anc = _agreed_ancestry(rng, n, g, t_pos, fills)
    s_fill = np.array(fills, np.int32)
    ref = jkv.attention_fp_shared(
        jnp.asarray(q), _s_buffer(jnp.asarray(kf), anc, n, g, t_pos, 2),
        _s_buffer(jnp.asarray(vf), anc, n, g, t_pos, 2), jnp.asarray(kf), jnp.asarray(vf),
        jnp.asarray(anc), jnp.asarray(s_fill), pos, g, window)
    got = bf.attention_fp_shared(_t(q), _t(kf), _t(vf), _t(anc), _t(s_fill), pos, g)
    _close(got, ref)
    over = bf.attention_fp_shared(_t(q), _t(kf), _t(vf), _t(anc), _t(s_fill), pos, g,
                                  overflow=torch.ones((), dtype=torch.bool))
    assert torch.equal(over, bf.attention_fp_beamflat(_t(q), _t(kf), _t(vf), _t(anc), pos, g))


def _disagreeing_ancestry(rng, n, g, t_pos, fills):
    """Random lanes that disagree below s_fill (each window's lanes own
    different rows at some position under it)."""
    anc = rng.integers(0, g, (n, g, t_pos)).astype(np.int32)
    for w, f in enumerate(fills):
        if f:
            anc[w, 0, 0], anc[w, 1, 0] = 0, 1
    return anc.reshape(n * g, t_pos)


# SPLIT_CASES with an S block in some window
DISAGREE_CASES = [c for c in SPLIT_CASES if max(c[2]) > 0]


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("window,pos,fills", DISAGREE_CASES)
def test_split_plain_reads_the_first_lane_below_s_fill(mxu, window, pos, fills):
    """Lanes that disagree below s_fill: block S reads the window's first
    lane's rows for every lane, as the reference's S buffer holds them
    (built from lane 0 by ``beam.py:_build_S``, here ``_s_buffer``)."""
    rng = np.random.default_rng(pos + window + 1)
    n, g, h, t_pos, d = 2, 3, 4, 40, 64
    kx = rng.standard_normal((n, h, t_pos * g, d)).astype(np.float32) * 0.35
    vx = rng.standard_normal((n, h, t_pos * g, d)).astype(np.float32)
    q = rng.standard_normal((n * g, h, 1, d)).astype(np.float32) * 0.35
    anc = _disagreeing_ancestry(rng, n, g, t_pos, fills)
    k8, ks, tk, tks = _codes(kx, 8)
    v8, vs, tv, tvs = _codes(vx, 8)
    k8t, v8t = jnp.swapaxes(k8, 2, 3), jnp.swapaxes(v8, 2, 3)
    s_fill = np.array(fills, np.int32)
    ref = jkv.attention_int8_shared(
        jnp.asarray(q), _s_buffer(k8t, anc, n, g, t_pos, 3), _s_buffer(ks, anc, n, g, t_pos, 2),
        _s_buffer(v8t, anc, n, g, t_pos, 3), _s_buffer(vs, anc, n, g, t_pos, 2), k8t, ks, v8t,
        vs, jnp.asarray(anc), jnp.asarray(s_fill), pos, g, window, mxu=mxu)
    got = bf.beamflat_attention(_t(q), tk, tks, tv, tvs, _t(anc), pos, g, int_dot=mxu,
                                s_fill=_t(s_fill))
    _close(got, ref)
    # the lanes' own rows (the flat function) give another answer here
    flat = bf.beamflat_attention(_t(q), tk, tks, tv, tvs, _t(anc), pos, g, int_dot=mxu)
    assert float((flat - got).abs().max()) > 1e-3


@pytest.mark.parametrize("window,pos,fills", DISAGREE_CASES[:2] + DISAGREE_CASES[3:4])
def test_split_fp_cache_reads_the_first_lane_below_s_fill(window, pos, fills):
    """``attention_fp_shared`` on lanes that disagree below s_fill, S built
    from lane 0 as the reference builds it."""
    rng = np.random.default_rng(pos + 1)
    n, g, h, t_pos, d = 2, 3, 4, 40, 64
    kf = rng.standard_normal((n, h, t_pos * g, d)).astype(np.float32)
    vf = rng.standard_normal((n, h, t_pos * g, d)).astype(np.float32)
    q = rng.standard_normal((n * g, h, 1, d)).astype(np.float32)
    anc = _disagreeing_ancestry(rng, n, g, t_pos, fills)
    s_fill = np.array(fills, np.int32)
    ref = jkv.attention_fp_shared(
        jnp.asarray(q), _s_buffer(jnp.asarray(kf), anc, n, g, t_pos, 2),
        _s_buffer(jnp.asarray(vf), anc, n, g, t_pos, 2), jnp.asarray(kf), jnp.asarray(vf),
        jnp.asarray(anc), jnp.asarray(s_fill), pos, g, window)
    _close(bf.attention_fp_shared(_t(q), _t(kf), _t(vf), _t(anc), _t(s_fill), pos, g), ref)


def test_split_masks_partition_the_flat_mask():
    """The port of ``_shared_masks`` over the flat cache: on lanes that
    agree below s_fill (the shared scheme's commits keep them so), blocks S
    and W are disjoint and together the flat mask, S holding exactly the
    positions below each window's s_fill; where the lanes disagree, S names
    the window's first lane's row at each of those positions, for every
    lane."""
    rng = np.random.default_rng(0)
    n, g, t_pos, pos = 3, 4, 20, 14
    fills = (0, 7, 15)
    s_fill = torch.tensor(fills, dtype=torch.int32)
    anc = _t(_agreed_ancestry(rng, n, g, t_pos, fills))
    mask_s, mask_w = bf.split_masks(anc, s_fill, g, t_pos * g, pos)
    flat = bf.beamflat_mask(anc, g, t_pos * g, pos)
    assert not (mask_s & mask_w).any() and torch.equal(mask_s | mask_w, flat)
    t_idx = torch.arange(t_pos * g) // g
    for w in range(n):
        assert torch.equal(mask_s[w], flat[w] & (t_idx < min(int(s_fill[w]), pos + 1)))
    # lanes that disagree below s_fill
    anc = _t(rng.integers(0, g, (n * g, t_pos)).astype(np.int32))
    mask_s, mask_w = bf.split_masks(anc, s_fill, g, t_pos * g, pos)
    flat = bf.beamflat_mask(anc, g, t_pos * g, pos)
    for w in range(n):
        below = t_idx < min(int(s_fill[w]), pos + 1)
        lane0 = flat[w, 0] & below
        assert all(torch.equal(mask_s[w, b], lane0) for b in range(g))
        assert torch.equal(mask_w[w], flat[w] & ~below)
        if fills[w]:  # some lane's own rows differ from lane 0's there
            assert not torch.equal(mask_s[w], flat[w] & below)


def test_split_rows_needed_count_the_first_lane_below_s_fill():
    """K8's bound for the split: below s_fill the window's first lane's row
    once a position, above it every lane's distinct rows, as a loop
    counts them."""
    rng = np.random.default_rng(3)
    n, g, t_pos, pos = 3, 5, 40, 33
    anc = rng.integers(0, g, (n * g, t_pos)).astype(np.int32)
    fills = (0, 12, 34)
    got = bf.beamflat_rows_needed(_t(anc), g, pos, torch.tensor(fills, dtype=torch.int32))
    for w, fill in enumerate(fills):
        lanes = anc.reshape(n, g, t_pos)[w]
        want = sum(1 if t < fill else len(set(lanes[:, t])) for t in range(pos + 1))
        assert int(got[w]) == want
    assert torch.equal(bf.beamflat_rows_needed(_t(anc), g, pos, torch.zeros(n, dtype=torch.int32)),
                       bf.beamflat_rows_needed(_t(anc), g, pos))


@pytest.mark.parametrize("g,pos,cluster", [(5, 30, 1), (5, 226, 1), (11, 300, 2), (1, 40, 3),
                                           (8, 447, 2), (3, 2047, 8)])
def test_agreed_runs_match_a_numpy_loop(g, pos, cluster):
    """``beamflat_agreed_runs`` (the positions K8's flat mode and per-lane
    layout read through the agreed-run route) against a loop: each block's
    leading positions at which every lane of a pass names one lane."""
    rng = np.random.default_rng(pos + g)
    n, t_pos = 3, pos + 5
    anc = rng.integers(0, 2, (n, g, t_pos)).astype(np.int32)
    for w, run in enumerate((0, pos // 3, pos + 1)):  # agreement, then random
        anc[w, :, :run] = anc[w, :1, :run]
    got = bf.beamflat_agreed_runs(_t(anc.reshape(n * g, t_pos)), g, pos, cluster).numpy()
    live = pos + 1
    for w in range(n):
        for p, r0 in enumerate(range(0, g, 8)):
            lanes = anc[w, r0:r0 + 8]
            for r in range(cluster):
                t, want = r * live // cluster, 0
                while t < (r + 1) * live // cluster and (lanes[:, t] == lanes[0, t]).all():
                    t, want = t + 1, want + 1
                assert got[w, p, r] == want, (w, p, r)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("pos", [0, 17, 23])
def test_ancestry_plain_matches_attention_int8_ancestry(bits, pos):
    rng = np.random.default_rng(bits + pos)
    n, g, h, t_pos, d = 2, 3, 4, 24, 64
    kx = rng.standard_normal((n * g, h, t_pos, d)).astype(np.float32) * 0.35
    vx = rng.standard_normal((n * g, h, t_pos, d)).astype(np.float32)
    q = rng.standard_normal((n * g, h, 1, d)).astype(np.float32) * 0.35
    anc = rng.integers(0, g, (n * g, t_pos)).astype(np.int32)
    k8, ks, tk, tks = _codes(kx, bits)
    v8, vs, tv, tvs = _codes(vx, bits)
    ref = jkv.attention_int8_ancestry(jnp.asarray(q), jnp.swapaxes(k8, 2, 3), ks,
                                      jnp.swapaxes(v8, 2, 3), vs, jnp.asarray(anc), pos, g)
    _close(bf.ancestry_attention(_t(q), tk, tks, tv, tvs, _t(anc), pos, g), ref)
    kf, vf = kx * 3, vx
    ref = jkv.attention_fp_ancestry(jnp.asarray(q * 3), jnp.asarray(kf), jnp.asarray(vf),
                                    jnp.asarray(anc), pos, g)
    _close(bf.attention_fp_ancestry(_t(q * 3), _t(kf), _t(vf), _t(anc), pos, g), ref)


# ---------------------------------------------------------------------------
# F9 and the time-major layouts through the tiny model
# ---------------------------------------------------------------------------

TINY = dict(n_mels=80, n_audio_state=64, n_audio_head=4, n_audio_layer=2, n_text_state=64,
            n_text_head=4, n_text_layer=2)


@pytest.fixture(scope="module")
def tiny():
    tok = j_tokenizer()
    jcfg = jw.WhisperConfig(n_vocab=tok.n_vocab, **TINY)
    tcfg = tw.WhisperConfig(n_vocab=tok.n_vocab, **TINY)
    tree = jax.tree.map(np.asarray, jw.init_params(jcfg, seed=5))
    mel = np.random.default_rng(5).standard_normal((1, 3000, 80)).astype(np.float32)
    return dict(tok=tok, jcfg=jcfg, tcfg=tcfg, jparams=jax.tree.map(jnp.asarray, tree),
                tparams=params_from_jax(tree, tcfg), mel=mel)


@pytest.mark.parametrize("kv,self_kv", [(8, 8), (4, 4), (0, 0)])
def test_decode_step_beam_ancestry_on_a_per_lane_cache(tiny, kv, self_kv):
    """F9: ``decode_step(beam_ancestry=)`` over a per-lane cache (int8,
    int4, fp) reads each position from the lane the ancestry names, as the
    reference's ``attention_*_ancestry`` does: logits against JAX's within
    1e-4 of max(1, |ref|). The lanes' prompts differ, so a lane attending
    its own rows gives other logits (the fault, before it was fixed)."""
    jcfg = dataclasses.replace(tiny["jcfg"], kv_bits=kv, self_kv_bits=self_kv)
    tcfg = dataclasses.replace(tiny["tcfg"], kv_bits=kv, self_kv_bits=self_kv)
    states = jw.encode(tiny["jparams"], jnp.asarray(tiny["mel"]), jcfg)
    n, g = 1, 3
    prompt = np.array([[1, 11, 12], [2, 21, 22], [3, 31, 32]], np.int32)
    anc = np.zeros((n * g, 128), np.int32)
    anc[:, :3] = [[1, 2, 0], [2, 0, 1], [0, 1, 2]]
    anc[:, 3] = np.arange(g)
    step = np.array([[5], [6], [7]], np.int32)

    jcache = jw.init_kv_cache(jcfg, n * g, max_len=16)
    jx = jw.cross_kv(tiny["jparams"], states, jcfg)
    _, jcache, _ = jw.decode_step(tiny["jparams"], jnp.asarray(prompt), jnp.int32(0), jcache, jx,
                                  jcfg, share_xkv_groups=g)
    ref, _, _ = jw.decode_step(tiny["jparams"], jnp.asarray(step), jnp.int32(3), jcache, jx, jcfg,
                               share_xkv_groups=g, beam_ancestry=jnp.asarray(anc))
    tcache = tw.init_kv_cache(tcfg, n * g, "cpu", max_len=16)
    tx = tw.cross_kv(tiny["tparams"], _t(np.asarray(states)), tcfg)
    tw.decode_step(tiny["tparams"], _t(prompt).long(), 0, tcache, tx, tcfg, share_xkv_groups=g)
    got, _ = tw.decode_step(tiny["tparams"], _t(step).long(), 3, tcache, tx, tcfg,
                            share_xkv_groups=g, beam_ancestry=_t(anc))
    _close(got.numpy(), ref, 1e-4)
    own = np.broadcast_to(np.arange(g, dtype=np.int32)[:, None], anc.shape).copy()
    mine, _ = tw.decode_step(tiny["tparams"], _t(step).long(), 3, tcache, tx, tcfg,
                             share_xkv_groups=g, beam_ancestry=_t(own))
    assert np.abs(mine.numpy() - np.asarray(ref)).max() > 1e-2


def _tmajor_inputs(rng, b, h, t_len, d, bits):
    """A JAX time-major cache ``(T, b, h * d)`` / ``(T, b, h)`` of random
    codes, and queries."""
    x = rng.standard_normal((b, h, t_len, d)).astype(np.float32)
    c, s = jkv.quantize_kv(jnp.asarray(x), bits)
    kT = c.transpose(2, 0, 1, 3).reshape(t_len, b, h * d)
    ksT = s[..., 0].transpose(2, 0, 1)
    return kT, ksT


@pytest.mark.parametrize("bits", [8, 4])
def test_tmajor_plain_versions_match_jax_and_k3(bits):
    """The three time-major attentions: the port's plain versions against
    the reference's, and against K3's plain version (fp mode) over the cache
    converted by ``tmajor_cache_from_jax``, within 1e-5 of max(1, |ref|)."""
    rng = np.random.default_rng(bits)
    b, h, t_len, d, g = 2, 4, 30, 64, 3
    kT, ksT = _tmajor_inputs(rng, b, h, t_len, d, bits)
    vT, vsT = _tmajor_inputs(rng, b, h, t_len, d, bits)
    port = tmajor_cache_from_jax([{"kT": np.asarray(kT), "ksT": np.asarray(ksT),
                                   "vT": np.asarray(vT), "vsT": np.asarray(vsT)}])[0]
    assert port["k8"].dtype == (torch.int8 if bits == 8 else torch.uint8)
    np.testing.assert_array_equal(
        da.unpack_codes(port["k8"]).numpy(),
        np.asarray(kT.astype(jnp.int8)).reshape(t_len, b, h, d).transpose(1, 2, 0, 3))
    tT = [_t(np.asarray(a.astype(jnp.int8 if a.dtype.name.startswith("int") else jnp.float32)))
          for a in (kT, ksT, vT, vsT)]
    tT[1], tT[3] = tT[1].to(torch.bfloat16), tT[3].to(torch.bfloat16)
    cache = (port["k8"], port["ks"], port["v8"], port["vs"])
    for tq_len, pos in ((1, 17), (3, 0), (2, 28)):
        q = rng.standard_normal((b, h, tq_len, d)).astype(np.float32) * 0.35
        ref = jkv.attention_int8_tmajor(jnp.asarray(q), kT, ksT, vT, vsT, pos)
        got = tkv.attention_int8_tmajor(_t(q), *tT, pos)
        _close(got, ref)
        _close(got, da.decode_attention_plain(_t(q), *cache, pos=pos, causal=True))
        ref = jkv.attention_int8_tmajor_cross(jnp.asarray(q), kT, ksT, vT, vsT)
        got = tkv.attention_int8_tmajor_cross(_t(q), *tT)
        _close(got, ref)
        _close(got, da.decode_attention_plain(_t(q), *cache, valid_len=t_len))
        q5 = rng.standard_normal((b, g, h, tq_len, d)).astype(np.float32) * 0.35
        ref = jkv.attention_int8_tmajor_grouped(jnp.asarray(q5), kT, ksT, vT, vsT)
        got = tkv.attention_int8_tmajor_grouped(_t(q5), *tT)
        _close(got, ref)
        _close(got.reshape(b * g, h, tq_len, d),
               da.decode_attention_plain(_t(q5).reshape(b * g, h, tq_len, d), *cache,
                                         valid_len=t_len, group=g))


def _decode_both(tiny, jcfg, tcfg, opts: dict):
    ref = jt.decode(tiny["jparams"], jnp.asarray(tiny["mel"]), j_tokenizer(), jcfg,
                    jt.DecodingOptions(**opts))
    got = tt.decode(tiny["tparams"], _t(tiny["mel"]), t_tokenizer(), tcfg,
                    tt.DecodingOptions(**opts))
    return [r.tokens for r in ref], [r.tokens for r in got]


@pytest.mark.parametrize("field", ["self_kv_layout", "kv_layout"])
@pytest.mark.parametrize("beam", [None, 3])
def test_tmajor_greedy_and_beam_match_jax(tiny, monkeypatch, field, beam):
    """Greedy (with integer dots asked for, which the time-major branch
    overrides) and beam under each time-major field, int8 self and int4
    cross caches: the port's tokens against JAX's. Under beam the self
    cache is the beam's own (the reference forces it time-minor) and a
    time-major cross cache runs in fp; the K3 calls the field steers run in
    K3's fp mode."""
    kw = dict(kv_bits=4, self_kv_bits=8, attn_mxu=beam is None, **{field: "tmajor"})
    jcfg = dataclasses.replace(tiny["jcfg"], **kw)
    tcfg = dataclasses.replace(tiny["tcfg"], **kw)
    modes = []
    real = da.decode_attention
    monkeypatch.setattr(tw, "decode_attention", lambda *a, **k: modes.append(
        (k.get("causal", False), k.get("int_dot"))) or real(*a, **k))
    ref, got = _decode_both(tiny, jcfg, tcfg, dict(sample_len=24, beam_size=beam))
    assert got == ref and all(len(t) > 0 for t in got)
    # K3's calls (self: causal; cross): those of a time-major cache in fp,
    # the others in integer dots; beam drops the self field
    if field == "self_kv_layout":
        fp = (lambda causal: causal) if beam is None else (lambda causal: False)
    else:
        fp = (lambda causal: not causal)
    assert modes and all(int_dot == (not fp(causal)) for causal, int_dot in modes)


# ---------------------------------------------------------------------------
# native-code residency
# ---------------------------------------------------------------------------


def _jax_leaf(rng, n, k, bits=4):
    w = rng.standard_normal((n, k)).astype(np.float32) / 8
    return jq.QuantTensor(*(jnp.asarray(a) for a in jq.quantize(w, bits, 64)), bits, 64)


def _port_native(leaf) -> tq.NativeQuantTensor:
    nat = jq.to_native(leaf)
    return tq.native_from_codes(_t(np.asarray(nat.codes)), _t(np.asarray(nat.scales)),
                                _t(np.asarray(nat.biases)), nat.bits, nat.group_size)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("rows", [1, 32, 33])
def test_native_group_matmul_row_rule(monkeypatch, bits, rows):
    """``native_group_matmul`` at the grouped form's last row (32) and past
    it (33) against the reference's, fp32, within 1e-5 of max(1, |ref|):
    K5's plain version at up to 32 rows, dequantize + matmul above (the
    kernel not reached); the codes re-encode exactly."""
    rng = np.random.default_rng(rows + bits)
    leaf = _jax_leaf(rng, 96, 256, bits)
    nat = _port_native(leaf)
    np.testing.assert_array_equal(nat.codes.numpy(), np.asarray(jq.to_native(leaf).codes))
    assert torch.equal(nat.w_q, tq.to_native(params_from_jax_leaf(leaf)).w_q)
    x = rng.standard_normal((rows, 256)).astype(np.float32)
    calls = []
    real = tq.quant_matmul_kernel
    monkeypatch.setattr(tq, "quant_matmul_kernel", lambda *a: calls.append(1) or real(*a))
    got = tq.quant_matmul(_t(x), nat)
    _close(got, jq.quant_matmul(jnp.asarray(x), jq.to_native(leaf)))
    assert bool(calls) == (rows <= 32)


def params_from_jax_leaf(leaf) -> tq.QuantTensor:
    from whisper_mlx_tpu_torch.checkpoint.convert import _quant_leaf

    return _quant_leaf(jax.tree.map(np.asarray, leaf), "cpu")


def test_native_group_matmul_partial_cap(monkeypatch):
    """The 768 MiB cap on the grouped partial ``rows * out * groups * 4``:
    the reference's rule, met exactly stays grouped, one byte over goes
    dense; at a small cap (patched) the dense route gives the reference's
    dequantize + matmul."""
    assert tq.NATIVE_MAX_PARTIAL == 768 * 1024 * 1024 and tq.NATIVE_MAX_ROWS == 32
    rng = np.random.default_rng(3)
    leaf = _jax_leaf(rng, 96, 256)
    nat = _port_native(leaf)
    x = rng.standard_normal((4, 256)).astype(np.float32)
    calls = []
    real = tq.quant_matmul_kernel
    monkeypatch.setattr(tq, "quant_matmul_kernel", lambda *a: calls.append(1) or real(*a))
    partial = 4 * 96 * 4 * 4
    monkeypatch.setattr(tq, "NATIVE_MAX_PARTIAL", partial)
    tq.quant_matmul(_t(x), nat)
    assert calls == [1]
    monkeypatch.setattr(tq, "NATIVE_MAX_PARTIAL", partial - 1)
    got = tq.quant_matmul(_t(x), nat)
    assert calls == [1]
    _close(got, jnp.asarray(x) @ jq.to_native(leaf).dequantize(jnp.float32).T)


def _whisper_quant_tree(seed=2):
    tok = j_tokenizer()
    jcfg = jw.WhisperConfig(n_vocab=tok.n_vocab, **TINY)
    tree = jq.quantize_params(jw.init_params(jcfg, seed=seed), bits=4, group_size=64)
    return tok, jcfg, tree


def _kinds(node, path="") -> dict:
    if isinstance(node, dict):
        return {k: v for key, val in node.items() for k, v in _kinds(val, f"{path}.{key}").items()}
    if isinstance(node, (list, tuple)):
        return {k: v for i, val in enumerate(node) for k, v in _kinds(val, f"{path}.{i}").items()}
    return {path: type(node).__name__}


@pytest.mark.parametrize("decode_rows", [1, 64])
def test_prepare_native_params_matches_jax(decode_rows):
    """``prepare_native_params`` at few decode rows (native leaves, the
    embedding dequantized) and at many (DenseWeight): the port's tree has
    the reference's leaf kinds at every path and the same values; a decode
    step on it gives the reference's logits within 1e-4 of max(1, |ref|)."""
    tok, jcfg, qtree = _whisper_quant_tree()
    jtree = jq.prepare_native_params(qtree, embed_dtype=jnp.float32, decode_rows=decode_rows)
    tcfg = tw.WhisperConfig(n_vocab=tok.n_vocab, **TINY)
    tpacked = params_from_jax(jax.tree.map(np.asarray, qtree), tcfg)
    tnative = tq.prepare_native_params(tpacked, embed_dtype=torch.float32,
                                       decode_rows=decode_rows)
    quant = ("NativeQuantTensor", "DenseWeight", "QuantTensor")
    want = {k: (v if v in quant else "Tensor") for k, v in _kinds(jtree).items()}
    assert _kinds(tnative) == want
    assert {"DenseWeight" if decode_rows > 16 else "NativeQuantTensor"} == \
        {v for v in want.values() if v in quant}
    assert want[".decoder.token_emb"] == "Tensor"
    converted = params_from_jax(jax.tree.map(np.asarray, jtree), tcfg)
    for a, b in zip(_flat(converted), _flat(tnative)):
        assert type(a) is type(b)
        np.testing.assert_array_equal(_dense(a), _dense(b))
    mel = np.random.default_rng(1).standard_normal((1, 3000, 80)).astype(np.float32)
    states = jw.encode(jax.tree.map(jnp.asarray, qtree), jnp.asarray(mel), jcfg)
    prompt = np.array([tok.sot_sequence], np.int32)
    ref, _, _ = jw.decode_step(jtree, jnp.asarray(prompt), jnp.int32(0),
                               jw.init_kv_cache(jcfg, 1, max_len=8),
                               jw.cross_kv(jtree, states, jcfg), jcfg)
    tstates = _t(np.asarray(states))
    got, _ = tw.decode_step(tnative, _t(prompt).long(), 0, tw.init_kv_cache(tcfg, 1, "cpu", 8),
                            tw.cross_kv(tnative, tstates, tcfg), tcfg)
    _close(got.numpy(), ref, 1e-4)


def _flat(node):
    if isinstance(node, dict):
        return [leaf for key in sorted(node) for leaf in _flat(node[key])]
    if isinstance(node, list):
        return [leaf for v in node for leaf in _flat(v)]
    return [node]


def _dense(leaf) -> np.ndarray:
    return (leaf if isinstance(leaf, torch.Tensor) else leaf.dequantize(torch.float32)).numpy()


@pytest.mark.parametrize("mode", ["1", "auto", "auto_over_budget"])
def test_promote_resident_native_matches_jax(mode):
    """``promote_resident_native`` under ``1`` (no budget), ``auto`` (9 <<
    30 elements) and a budget below the tree: the same ``promoted`` flag as
    the reference and native leaves where it has them, the same codes."""
    _, _, qtree = _whisper_quant_tree()
    budget = {"1": None, "auto": 9 << 30, "auto_over_budget": 1000}[mode]
    jtree, jpromoted = jq.promote_resident_native(qtree, budget_bytes=budget)
    tcfg = tw.WhisperConfig(n_vocab=j_tokenizer().n_vocab, **TINY)
    ttree, tpromoted = tq.promote_resident_native(
        params_from_jax(jax.tree.map(np.asarray, qtree), tcfg), budget_bytes=budget)
    assert tpromoted == jpromoted == (mode != "auto_over_budget")
    jk, tk = _kinds(jtree), _kinds(ttree)
    for path, kind in jk.items():
        if kind in ("NativeQuantTensor", "QuantTensor"):
            assert tk[path] == kind, path
    assert tq.promote_resident_native({"w": torch.zeros(3)})[1] is False  # nothing packed
    if jpromoted:
        emb_j, emb_t = jtree["decoder"]["token_emb"], ttree["decoder"]["token_emb"]
        np.testing.assert_array_equal(emb_t.codes.numpy(), np.asarray(emb_j.codes))


QWEN = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, rope_theta=10_000.0, tie_word_embeddings=True,
            attention_bias=True)


def _qwen_pair(seed, layers=2):
    """A tiny Qwen with 4-bit layers and embedding, as numpy-leaf JAX tree
    and the port's converted tree."""
    tok = JTok()
    dims = dict(QWEN, num_hidden_layers=layers)
    jcfg = jqw.QwenConfig(vocab_size=tok.vocab_size, **dims)
    tcfg = tqw.QwenConfig(vocab_size=tok.vocab_size, **dims)
    tree = jax.tree.map(np.asarray, jqw.init_params(jcfg, seed=seed))
    qlayers = jq.quantize_params({"encoder": {"layers": tree["layers"]}, "decoder": {}},
                                 bits=4, group_size=64)["encoder"]["layers"]
    emb = jq.quantize(np.asarray(tree["embed"], np.float32), bits=4, group_size=64)
    jtree = dict(jax.tree.map(jnp.asarray, tree), layers=qlayers,
                 embed=jq.QuantTensor(*(jnp.asarray(a) for a in emb), 4, 64))
    return jtree, jcfg, qwen_params_from_jax(jax.tree.map(np.asarray, jtree), tcfg), tcfg


@pytest.mark.parametrize("also", ["", "WTPU_QWEN_A8", "WTPU_MBT_RESIDENT"])
def test_llm_engine_native_resident_matches_jax(monkeypatch, also):
    """``WTPU_NATIVE_RESIDENT=1`` through LLMEngine with a draft, alone and
    beside A8 or MBT (which then find no packed leaf and change nothing, in
    both packages): the target's and the draft's leaf kinds are the
    reference's, and the greedy tokens (speculative decoding with the draft,
    the plain loop and the stream) equal the JAX engine's."""
    jtree, jcfg, ttree, tcfg = _qwen_pair(0)
    jdraft, jdcfg, tdraft, tdcfg = _qwen_pair(1, layers=1)
    monkeypatch.setenv("WTPU_NATIVE_RESIDENT", "1")
    if also:
        monkeypatch.setenv(also, "1")
    jeng = JEngine(jtree, jcfg, JTok(), max_context=256, draft=(jdraft, jdcfg))
    teng = tg.LLMEngine(ttree, tcfg, TTok(), max_context=256, draft=(tdraft, tdcfg))
    for jp, tp in ((jeng.params, teng.params), (jeng.draft[0], teng.draft[0])):
        jk, tk = _kinds(jp), _kinds(tp)
        assert {p for p, k in jk.items() if k == "NativeQuantTensor"} == \
            {p for p, k in tk.items() if k == "NativeQuantTensor"} != set()
        assert "QuantTensor" not in tk.values()
    for prompt in ("hello", "The quick brown fox"):
        want = jeng.generate(prompt, max_tokens=16, temperature=0.0).tokens
        assert teng.generate(prompt, max_tokens=16, temperature=0.0).tokens == want
    ref = "".join(jeng.stream_generate("hello", max_tokens=10, temperature=0.0))
    assert "".join(teng.stream_generate("hello", max_tokens=10, temperature=0.0)) == ref


def test_llm_engine_native_auto_budget(monkeypatch):
    """``auto``: a tree within the budget is promoted, the draft with it;
    under the reference's rule a target that is not promoted leaves the
    draft packed too."""
    jtree, jcfg, ttree, tcfg = _qwen_pair(0)
    _, _, tdraft, tdcfg = _qwen_pair(1, layers=1)
    monkeypatch.setenv("WTPU_NATIVE_RESIDENT", "auto")
    eng = tg.LLMEngine(ttree, tcfg, TTok(), max_context=256, draft=(tdraft, tdcfg))
    assert isinstance(eng.params["embed"], tq.NativeQuantTensor)
    assert isinstance(eng.draft[0]["embed"], tq.NativeQuantTensor)
    monkeypatch.setattr(tq, "promote_resident_native",
                        lambda p, budget_bytes=None: (p, False) if budget_bytes else (p, True))
    eng = tg.LLMEngine(ttree, tcfg, TTok(), max_context=256, draft=(tdraft, tdcfg))
    assert isinstance(eng.params["embed"], tq.QuantTensor)
    assert isinstance(eng.draft[0]["embed"], tq.QuantTensor)


# ---------------------------------------------------------------------------
# beam_decode(kv_scheme="shared") against the reference
# ---------------------------------------------------------------------------

SHARED_LEN = 48  # a horizon past 16 + 32: phases (16,) sets one segment bound


@pytest.fixture(scope="module")
def beam_tiny():
    tok = j_tokenizer()
    jcfg = jw.WhisperConfig(n_vocab=tok.n_vocab, **BEAM_DIMS)
    tcfg = tw.WhisperConfig(n_vocab=tok.n_vocab, **BEAM_DIMS)
    tree = copy.deepcopy(jax.tree.map(np.array, jw.init_params(jcfg, seed=3)))
    tree["decoder"]["token_emb"][tok.eot] *= 3.0
    jparams = jax.tree.map(jnp.asarray, tree)
    mel = np.random.default_rng(11).standard_normal((2, 3000, 80)).astype(np.float32)
    states = jw.encode(jparams, jnp.asarray(mel), jcfg)
    return dict(tok=tok, jcfg=jcfg, tcfg=tcfg, jparams=jparams,
                tparams=params_from_jax(tree, tcfg), states=states)


def _shared_pair(bt, kv, self_kv, mxu, window, phases):
    tok = bt["tok"]
    init, sot_index, always, begin, fc = beam_inputs(tok, 3)
    jcfg = dataclasses.replace(bt["jcfg"], kv_bits=kv, self_kv_bits=self_kv, attn_mxu=mxu)
    tcfg = dataclasses.replace(bt["tcfg"], kv_bits=kv, self_kv_bits=self_kv, attn_mxu=mxu)
    common = dict(sample_len=SHARED_LEN, sot_index=sot_index, no_speech_token=tok.no_speech,
                  beam_size=3, pool_size=3, kv_scheme="shared", phases=phases, window=window)
    ref = jb.beam_decode(bt["jparams"], bt["states"],
                         jnp.tile(jnp.asarray(init, jnp.int32)[None], (2, 1)),
                         jnp.asarray(always), jnp.asarray(begin), config=jcfg,
                         filter_cfg=JFilter(**fc), **common)
    got = tb.beam_decode(bt["tparams"], _t(np.asarray(bt["states"])), torch.tensor([init] * 2),
                         _t(always), _t(begin), config=tcfg, filter_cfg=TFilter(**fc), **common)
    return ref, got


def _assert_same(ref, got):
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_array_equal(got.fin_count.numpy(), np.asarray(ref.fin_count))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores), rtol=3e-5, atol=1e-5)


@pytest.mark.parametrize("phases", [(16,), None])
@pytest.mark.parametrize("window", [4, 12, 40])
@pytest.mark.parametrize("kv,self_kv,mxu", [(0, 0, False), (0, 8, False), (4, 8, True)])
def test_shared_beam_decode_matches_jax(beam_tiny, kv, self_kv, mxu, window, phases):
    """fp and int8 self caches, integer dots off and on, read windows 4
    (the overflow takes over), 12 and 40, one segment bound at 16 and none:
    tokens, lengths and fin_count equal, scores within rtol 3e-5 (the
    reference's own shared-vs-flat bound)."""
    _assert_same(*_shared_pair(beam_tiny, kv, self_kv, mxu, window, phases))


@pytest.mark.parametrize("window", [4, 12])
def test_shared_beam_trajectory_matches_jax(beam_tiny, monkeypatch, window):
    """The split point of every split step, int8 self cache with integer
    dots, a bound at 16: the port's (position, s_fill) at each step whose
    overflow flag is clear equal the reference's at each step of its fast
    loop (read from its traced loop), the overflow took over in a segment
    and the split resumed after the bound."""
    seen_j, seen_t = [], []
    real_j, real_t = jb.decode_step, tb.decode_step

    def spy_j(*a, beam_s_fill=None, **kw):
        if beam_s_fill is not None:
            jax.debug.callback(lambda p, f: seen_j.append((int(p), tuple(np.asarray(f)))),
                               a[2], beam_s_fill)
        return real_j(*a, beam_s_fill=beam_s_fill, **kw)

    def spy_t(*a, beam_s_fill=None, beam_overflow=None, **kw):
        if beam_s_fill is not None:
            seen_t.append((a[2], tuple(beam_s_fill.tolist()), bool(beam_overflow)))
        return real_t(*a, beam_s_fill=beam_s_fill, beam_overflow=beam_overflow, **kw)

    monkeypatch.setattr(jb, "decode_step", spy_j)
    monkeypatch.setattr(tb, "decode_step", spy_t)
    jax.clear_caches()  # the spy enters when the loop is traced
    try:
        ref, got = _shared_pair(beam_tiny, 4, 8, True, window, (16,))
        jax.effects_barrier()
    finally:
        jax.clear_caches()
    _assert_same(ref, got)
    split = sorted((p, f) for p, f, over in seen_t if not over)
    assert split == sorted(seen_j)
    overflowed = {p for p, _, over in seen_t if over}
    if window == 4:
        assert overflowed and any(p > 16 for p, _ in split)


def test_dense_weight_row_gather_is_rejected_as_in_the_reference():
    """A ``DenseWeight`` never reaches an embedding lookup in either
    package (``prepare_native_params`` dequantizes embedding tables to
    plain arrays); handed one anyway, both refuse it."""
    w = np.random.default_rng(0).standard_normal((8, 64)).astype(np.float32)
    with pytest.raises(AttributeError):
        jq.quant_rows(jq.DenseWeight(jnp.asarray(w)), jnp.asarray([1, 2]))
    with pytest.raises(TypeError, match="QuantTensor"):
        tq.quant_rows(tq.DenseWeight(_t(w)), torch.tensor([1, 2]))
