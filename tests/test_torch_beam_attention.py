"""Port parity: the beam path's attention and lane functions of
whisper_mlx_tpu_torch against the JAX package on the CPU, on shared codes
and scales made with numpy: the integer-dot mode of K3 (``attention_int8_mxu``
/ ``_grouped_mxu``), K8's plain version in both modes (against
``attention_int8_beamflat`` and the Pallas ``beamflat_attention_kernel`` in
interpret mode), ``attention_fp_beamflat``, K9's plain versions (against the
Pallas ``permute_lanes`` / ``lane_move_inplace`` in interpret mode), the
flat-cache converter and the beam top-k. The Hopper kernels themselves are
held against these plain versions in tests/test_torch_kernels.py."""

from __future__ import annotations

import numpy as np
import pytest

import torch  # noqa: F401  (torch before jax: see CLAUDE.md)
import jax
import jax.numpy as jnp

from whisper_mlx_tpu.ops import kv_quant as jk
from whisper_mlx_tpu.ops.beamflat_attention import beamflat_attention_kernel
from whisper_mlx_tpu.ops.lane_permute import lane_move_inplace as j_move
from whisper_mlx_tpu.ops.lane_permute import permute_lanes as j_permute
from whisper_mlx_tpu_torch.decoding.beam import _topk_flat
from whisper_mlx_tpu_torch.models.whisper import beam_flat_cache
from whisper_mlx_tpu_torch.ops import beamflat_attention as bf
from whisper_mlx_tpu_torch.ops import kv_quant as kq
from whisper_mlx_tpu_torch.ops import lane_permute as lp

# fp mode: fp32 sums in another order (XLA vs torch). Integer-dot mode: the
# integer dots are exact on both sides and the dynamic int8 codes of q and
# w * vs come out identical on these inputs, so only the fp32 ulps of the
# softmax and the scale products remain: 1e-6 * max(1, |ref|max). (A code
# one step apart at a rounding tie would move an output by about
# max(w * vs) * |v code|, far above this bound.)
FP_TOL = 2e-5
INT_TOL = 1e-6


def _int_tol(ref) -> float:
    return INT_TOL * max(1.0, float(np.abs(ref).max()))


def _codes(rng, shape, bits):
    """Random codes of the grid (the full range) and bf16-exact scales."""
    qmax = 127 if bits == 8 else 7
    codes = rng.integers(-qmax, qmax + 1, size=shape).astype(np.int8)
    scale = rng.uniform(0.005, 0.05, size=shape[:-1]).astype(np.float32)
    scale = torch.from_numpy(scale).to(torch.bfloat16).float().numpy()
    return codes, scale


def _port_codes(codes, bits):
    c = torch.from_numpy(codes)
    return kq.pack_int4(c) if bits == 4 else c


def _jax_codes(codes, bits):
    return jnp.asarray(codes).astype(jnp.int4 if bits == 4 else jnp.int8)


# ---------------------------------------------------------------------------
# _quantize_rows and the integer-dot mode of K3
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 3, 5, 64), (4, 1500), (7,)])
def test_quantize_rows_bit_identical(shape):
    rng = np.random.default_rng(len(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    x[..., 0] = 0.0
    x.reshape(-1, shape[-1])[0] = 0.0  # an all-zero row takes the 1e-30 floor
    jc, js = jk._quantize_rows(jnp.asarray(x))
    tc, ts = kq._quantize_rows(torch.from_numpy(x))
    assert tc.dtype == torch.int8
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _k3_cache(rng, n, h, t, bits):
    k, ks = _codes(rng, (n, h, t, 64), bits)
    v, vs = _codes(rng, (n, h, t, 64), bits)
    jax_cache = (jnp.swapaxes(_jax_codes(k, bits), 2, 3), jnp.asarray(ks)[..., None],
                 jnp.swapaxes(_jax_codes(v, bits), 2, 3), jnp.asarray(vs)[..., None])
    bf16 = lambda s: torch.from_numpy(s).to(torch.bfloat16)  # noqa: E731
    port = (_port_codes(k, bits), bf16(ks), _port_codes(v, bits), bf16(vs))
    return jax_cache, port


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("tq,t,kw", [
    (1, 256, dict(pos=100, causal=True)),   # self, mid-decode
    (1, 256, dict(pos=0, causal=True)),     # self, first step
    (3, 256, dict(pos=0, causal=True)),     # self, prefill
    (1, 1500, dict(valid_len=1500)),        # cross
    (3, 384, dict(valid_len=333)),          # cross prefill, padded keys
])
def test_k3_int_dot_plain_matches_mxu(bits, tq, t, kw):
    rng = np.random.default_rng(tq * 7 + t)
    jc, tc = _k3_cache(rng, 2, 3, t, bits)
    q = (rng.standard_normal((2, 3, tq, 64)) * 2.0).astype(np.float32)
    ref = np.asarray(jk.attention_int8_mxu(jnp.asarray(q), *jc, **kw))
    got = kq.attention_int8_mxu(torch.from_numpy(q), *tc, **kw)
    np.testing.assert_allclose(got.numpy(), ref, atol=_int_tol(ref), rtol=0)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("tq", [1, 3])
def test_k3_int_dot_plain_matches_grouped_mxu(bits, tq):
    """Beam cross attention: g = 5 lanes share each window's cache."""
    rng = np.random.default_rng(bits + tq)
    n, g, h = 2, 5, 3
    jc, tc = _k3_cache(rng, n, h, 1500, bits)
    q = (rng.standard_normal((n, g, h, tq, 64)) * 2.0).astype(np.float32)
    ref = np.asarray(jk.attention_int8_grouped_mxu(jnp.asarray(q), *jc, valid_len=1500))
    got = kq.attention_int8_grouped_mxu(torch.from_numpy(q.reshape(n * g, h, tq, 64)), *tc,
                                        group=g, valid_len=1500)
    np.testing.assert_allclose(got.numpy(), ref.reshape(n * g, h, tq, 64), atol=_int_tol(ref),
                               rtol=0)


def test_k3_int_dot_bf16_queries_round_output():
    """bf16 queries: the result is the fp32 function rounded to bf16."""
    rng = np.random.default_rng(9)
    _, tc = _k3_cache(rng, 2, 3, 256, 8)
    q = torch.from_numpy(rng.standard_normal((2, 3, 1, 64)).astype(np.float32))
    got = kq.attention_int8_mxu(q.to(torch.bfloat16), *tc, pos=50, causal=True)
    ref = kq.attention_int8_mxu(q.to(torch.bfloat16).float(), *tc, pos=50, causal=True)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, ref.to(torch.bfloat16))


# ---------------------------------------------------------------------------
# K8: beam self-attention over the flat cache
# ---------------------------------------------------------------------------


def _ancestry(rng, n, g, t_pos):
    """A lane-ownership map as a beam builds it: each step every lane takes
    a random parent's history and owns its newest position."""
    anc = np.tile(np.arange(g, dtype=np.int32)[:, None], (n, 1, t_pos))
    for t in range(1, t_pos):
        parent = rng.integers(0, g, size=(n, g))
        anc[:, :, :t] = np.take_along_axis(anc[:, :, :t], parent[:, :, None], axis=1)
    return anc.reshape(n * g, t_pos)


def _flat_cache(rng, n, h, rows, bits):
    k, ks = _codes(rng, (n, h, rows, 64), bits)
    v, vs = _codes(rng, (n, h, rows, 64), bits)
    jax_cache = (jnp.swapaxes(_jax_codes(k, bits), 2, 3), jnp.asarray(ks)[..., None],
                 jnp.swapaxes(_jax_codes(v, bits), 2, 3), jnp.asarray(vs)[..., None])
    bf16 = lambda s: torch.from_numpy(s).to(torch.bfloat16)  # noqa: E731
    return jax_cache, (_port_codes(k, bits), bf16(ks), _port_codes(v, bits), bf16(vs))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("int_dot", [False, True])
@pytest.mark.parametrize("pos", [0, 37, 63])
def test_beamflat_plain_matches_jax(bits, int_dot, pos):
    rng = np.random.default_rng(pos + bits)
    n, g, h, t_pos = 2, 3, 4, 64
    jc, tc = _flat_cache(rng, n, h, t_pos * g, bits)
    anc = _ancestry(rng, n, g, t_pos)
    q = (rng.standard_normal((n * g, h, 1, 64)) * (2.0 if int_dot else 0.3)).astype(np.float32)
    ref = np.asarray(jk.attention_int8_beamflat(jnp.asarray(q), *jc, jnp.asarray(anc),
                                                jnp.int32(pos), g, mxu=int_dot))
    got = bf.beamflat_attention(torch.from_numpy(q), *tc, torch.from_numpy(anc), pos, g,
                                int_dot=int_dot)
    np.testing.assert_allclose(got.numpy(), ref, atol=_int_tol(ref) if int_dot else FP_TOL,
                               rtol=0)


@pytest.mark.parametrize("pos", [5, 63])
def test_beamflat_plain_matches_pallas_kernel(pos):
    """The TPU kernel (int8, fp mode, precomputed mask) in interpret mode."""
    rng = np.random.default_rng(pos)
    n, g, h, t_pos = 2, 5, 3, 64
    jc, tc = _flat_cache(rng, n, h, t_pos * g, 8)
    anc = _ancestry(rng, n, g, t_pos)
    q = (rng.standard_normal((n * g, h, 1, 64)) * 0.3).astype(np.float32)
    mask = jk._beamflat_mask(jnp.asarray(anc), n, g, t_pos * g, jnp.int32(pos))
    ref = np.asarray(beamflat_attention_kernel(jnp.asarray(q), *jc, mask, groups=g,
                                               interpret=True))
    got = bf.beamflat_attention_plain(torch.from_numpy(q), *tc, torch.from_numpy(anc), pos, g)
    np.testing.assert_allclose(got.numpy(), ref, atol=FP_TOL, rtol=0)
    np.testing.assert_array_equal(
        bf.beamflat_mask(torch.from_numpy(anc), g, t_pos * g, pos).numpy(), np.asarray(mask))


def test_attention_fp_beamflat_matches_jax():
    rng = np.random.default_rng(4)
    n, g, h, t_pos, pos = 2, 3, 4, 20, 13
    kf = rng.standard_normal((n, h, t_pos * g, 64)).astype(np.float32)
    vf = rng.standard_normal((n, h, t_pos * g, 64)).astype(np.float32)
    q = rng.standard_normal((n * g, h, 1, 64)).astype(np.float32)
    anc = _ancestry(rng, n, g, t_pos)
    ref = np.asarray(jk.attention_fp_beamflat(jnp.asarray(q), jnp.asarray(kf), jnp.asarray(vf),
                                              jnp.asarray(anc), jnp.int32(pos), g))
    got = bf.attention_fp_beamflat(*(torch.from_numpy(a) for a in (q, kf, vf, anc)), pos, g)
    np.testing.assert_allclose(got.numpy(), ref, atol=FP_TOL, rtol=0)


def test_beamflat_gather_equals_mask():
    """What the kernel computes (each lane's pos + 1 rows gathered) equals
    the masked form over all rows: K3's plain version over the gathered
    rows, lane by lane."""
    rng = np.random.default_rng(8)
    n, g, h, t_pos, pos = 2, 3, 2, 16, 11
    _, (k, ks, v, vs) = _flat_cache(rng, n, h, t_pos * g, 8)
    anc = torch.from_numpy(_ancestry(rng, n, g, t_pos))
    q = torch.from_numpy((rng.standard_normal((n * g, h, 1, 64)) * 2.0).astype(np.float32))
    for int_dot in (False, True):
        full = bf.beamflat_attention(q, k, ks, v, vs, anc, pos, g, int_dot=int_dot)
        for b in range(n * g):
            rows = torch.arange(pos + 1) * g + anc[b, :pos + 1].long()
            pick = lambda a: a[b // g][:, rows][None].contiguous()  # noqa: E731
            one = kq.decode_attention(q[b:b + 1], pick(k), pick(ks), pick(v), pick(vs),
                                      int_dot=int_dot)
            torch.testing.assert_close(full[b:b + 1], one, atol=FP_TOL, rtol=0)


@pytest.mark.parametrize("n,g,t_pos,pos", [(2, 3, 16, 0), (2, 3, 16, 11), (3, 5, 40, 39),
                                            (1, 1, 8, 7), (2, 11, 24, 20)])
def test_beamflat_rows_needed_matches_mask(n, g, t_pos, pos):
    """K8's distinct rows a window are the rows the reference's mask marks
    for any of its lanes."""
    rng = np.random.default_rng(pos + g)
    anc = torch.from_numpy(_ancestry(rng, n, g, t_pos))
    marked = bf.beamflat_mask(anc, g, t_pos * g, pos).any(dim=1).sum(dim=1)
    assert torch.equal(bf.beamflat_rows_needed(anc, g, pos), marked)


@pytest.mark.parametrize("g", [1, 3, 5, 9])
@pytest.mark.parametrize("pos", [0, 17, 31])
def test_beamflat_rows_needed_shared_and_distinct(g, pos):
    """pos + 1 rows a window when its lanes share one history (any owner),
    g * (pos + 1) when every lane's history is its own."""
    n, t_pos = 2, 32
    rng = np.random.default_rng(g)
    owner = torch.from_numpy(rng.integers(0, g, size=(n, 1, t_pos)).astype(np.int32))
    shared = owner.expand(n, g, t_pos).reshape(n * g, t_pos).contiguous()
    assert bf.beamflat_rows_needed(shared, g, pos).tolist() == [pos + 1] * n
    distinct = (torch.arange(n * g, dtype=torch.int32) % g)[:, None].repeat(1, t_pos)
    assert bf.beamflat_rows_needed(distinct, g, pos).tolist() == [g * (pos + 1)] * n


@pytest.mark.parametrize("limit", [1, 2, 63, 64, 65, 227, 448, 512, 513, 1000, 2047, 2048])
@pytest.mark.parametrize("g", [1, 5, 8, 11])
def test_beamflat_plan_covers_every_position_once(limit, g):
    """K8's plan: 1 to 8 blocks a (window, head), every live position in
    exactly one block's span, in block order, at most MAX_SPAN a block (the
    kernel's 8-bit position); chunks of whole 16-row tiles, at most CAP
    rows, holding a pass's most distinct rows where CAP allows."""
    cluster, cap = bf.beamflat_plan(limit, g)
    assert 1 <= cluster <= bf.MAX_CLUSTER and cluster <= limit
    # block r's positions, as the kernel splits them
    spans = [range(r * limit // cluster, (r + 1) * limit // cluster) for r in range(cluster)]
    assert [t for span in spans for t in span] == list(range(limit))
    assert all(1 <= len(span) <= bf.MAX_SPAN for span in spans)
    most = max(len(span) for span in spans)
    assert cap % 16 == 0 and 16 <= cap <= bf.CAP
    assert cap >= min(most * min(g, bf.LANES), bf.CAP)
    assert cap - most * min(g, bf.LANES) < 16 or cap == 16


@pytest.mark.parametrize("limit,g", [(0, 5), (2049, 5), (10, 0)])
def test_beamflat_plan_rejects_bad_shapes(limit, g):
    with pytest.raises(ValueError, match="beamflat_plan"):
        bf.beamflat_plan(limit, g)


@pytest.mark.parametrize("limit", [1, 20, 61, 227, 2048])
@pytest.mark.parametrize("span", [1, 3, 29, 64, 256])
def test_beamflat_plan_span_bounds_each_block(limit, span):
    """A smaller span splits the positions over more blocks (at most 8),
    each block's share within the span wherever 8 blocks allow it."""
    cluster, _ = bf.beamflat_plan(limit, 5, span=span)
    assert cluster == min(bf.MAX_CLUSTER, limit, -(-limit // span))
    most = -(-limit // cluster)
    assert most <= span or cluster == bf.MAX_CLUSTER
    assert bf.beamflat_plan(limit, 5) == bf.beamflat_plan(limit, 5, span=bf.MAX_SPAN)


@pytest.mark.parametrize("span", [0, bf.MAX_SPAN + 1])
def test_beamflat_plan_rejects_bad_span(span):
    with pytest.raises(ValueError, match="beamflat_plan"):
        bf.beamflat_plan(100, 5, span=span)


@pytest.mark.parametrize("bad", ["tq", "ancestry_dtype", "pos", "group"])
def test_beamflat_rejects_bad_inputs(bad):
    rng = np.random.default_rng(0)
    _, (k, ks, v, vs) = _flat_cache(rng, 2, 2, 12, 8)
    q = torch.zeros((6, 2, 1, 64))
    anc = torch.zeros((6, 4), dtype=torch.int32)
    pos, g = 2, 3
    if bad == "tq":
        q = torch.zeros((6, 2, 2, 64))
    elif bad == "ancestry_dtype":
        anc = anc.long()
    elif bad == "pos":
        pos = 4
    else:
        g = 2
    with pytest.raises(ValueError, match="beamflat_attention"):
        bf.beamflat_attention(q, k, ks, v, vs, anc, pos, g)


# ---------------------------------------------------------------------------
# K9: lane permute and in-place move
# ---------------------------------------------------------------------------


def _layer(rng, nb, t=32):
    """One layer's per-lane self cache: int8 codes, packed int4 codes (plain
    bytes to the kernel) and bf16 scales."""
    k8 = rng.integers(-127, 128, size=(nb, 4, t, 64)).astype(np.int8)
    k4 = rng.integers(0, 256, size=(nb, 4, t, 32)).astype(np.uint8)
    ks = rng.uniform(0.01, 1.0, size=(nb, 4, t)).astype(np.float32)
    return [k8, k4, ks]


def test_permute_lanes_matches_pallas():
    rng = np.random.default_rng(1)
    nb = 12
    arrays = _layer(rng, nb)
    parent = np.array([0, 0, 2, 1, 4, 4, 4, 7, 6, 9, 11, 9], np.int32)
    ref = j_permute([jnp.asarray(a) for a in arrays], jnp.asarray(parent), interpret=True)
    ts = [torch.from_numpy(a) for a in arrays]
    ts[2] = ts[2].to(torch.bfloat16)
    got = lp.permute_lanes(ts, torch.from_numpy(parent).long())
    for g_, r in zip(got[:2], ref[:2]):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(r))
    np.testing.assert_array_equal(got[2].float().numpy(),
                                  ts[2].float().numpy()[parent])
    assert all(g_ is not t for g_, t in zip(got, ts))  # out of place


def test_lane_move_inplace_matches_pallas():
    rng = np.random.default_rng(2)
    nb = 10
    arrays = _layer(rng, nb)
    # lanes 1, 4, 9 take copies of the fixed points 0, 3, 8
    src = np.array([0, 0, 2, 3, 3, 5, 6, 7, 8, 8], np.int32)
    ref = j_move([jnp.asarray(a) for a in arrays[:2]], jnp.asarray(src), interpret=True)
    ts = [torch.from_numpy(a.copy()) for a in arrays[:2]]
    got = lp.lane_move_inplace(ts, torch.from_numpy(src))
    for g_, t, r in zip(got, ts, ref):
        assert g_ is t  # in place
        np.testing.assert_array_equal(g_.numpy(), np.asarray(r))


def test_lane_move_rejects_moved_source():
    t = torch.arange(4 * 16, dtype=torch.int8).reshape(4, 16)
    with pytest.raises(ValueError, match="source row is itself moved"):
        lp.lane_move_inplace([t], torch.tensor([0, 2, 1, 3]))


def test_lane_functions_reject_bad_inputs():
    t = torch.zeros((4, 16), dtype=torch.int8)
    with pytest.raises(ValueError, match="row map"):
        lp.permute_lanes([t], torch.zeros(3, dtype=torch.long))
    with pytest.raises(ValueError, match="contiguous"):
        lp.permute_lanes([t, torch.zeros((16, 4)).T], torch.zeros(4, dtype=torch.long))
    with pytest.raises(ValueError, match="tensors"):
        lp.permute_lanes([t] * 9, torch.zeros(4, dtype=torch.long))


# ---------------------------------------------------------------------------
# the flat-cache converter and the beam top-k
# ---------------------------------------------------------------------------


def test_beam_flat_cache_layout():
    """Row t*g + k of window w is lane w*g + k's position t, for codes,
    scales and fp rows (the reference's _to_flat, position-major)."""
    rng = np.random.default_rng(3)
    n, g, h, t = 2, 3, 4, 8
    entry = {"k8": torch.from_numpy(rng.integers(-127, 128, (n * g, h, t, 64)).astype(np.int8)),
             "ks": torch.from_numpy(rng.standard_normal((n * g, h, t)).astype(np.float32)),
             "v8": torch.from_numpy(rng.integers(0, 256, (n * g, h, t, 32)).astype(np.uint8)),
             "vs": torch.from_numpy(rng.standard_normal((n * g, h, t)).astype(np.float32))}
    flat = beam_flat_cache([entry, {"k": entry["ks"][..., None], "v": entry["ks"][..., None]}],
                           g)
    assert sorted(flat[0]) == ["k8f", "ksf", "v8f", "vsf"] and sorted(flat[1]) == ["kf", "vf"]
    for src, dst in (("k8", "k8f"), ("ks", "ksf"), ("v8", "v8f"), ("vs", "vsf")):
        a, f = entry[src], flat[0][dst]
        assert f.shape == (n, h, t * g, *a.shape[3:]) and f.is_contiguous()
        for w in range(n):
            for k in range(g):
                assert torch.equal(f[w, :, k::g], a[w * g + k])
    # the reference's time-minor form of the same converter
    jt = np.asarray(entry["k8"]).reshape(n, g, h, t, 64).transpose(0, 2, 4, 3, 1).reshape(
        n, h, 64, t * g)
    np.testing.assert_array_equal(flat[0]["k8f"].numpy(), np.swapaxes(jt, 2, 3))


@pytest.mark.parametrize("k", [6, 10])
def test_topk_flat_matches_lax_topk(k):
    """Values and indices equal lax.top_k, on tie-heavy and -inf rows."""
    rng = np.random.default_rng(7)
    cand = np.round(rng.standard_normal((6, 4096)).astype(np.float32) * 2) / 2
    cand[2, :] = -np.inf
    cand[3, 100:] = -np.inf
    cand[4, :5] = 3.25
    cand[5, ::2] = 0.0
    ref_s, ref_i = jax.lax.top_k(jnp.asarray(cand), k)
    got_s, got_i = _topk_flat(torch.from_numpy(cand), k)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
