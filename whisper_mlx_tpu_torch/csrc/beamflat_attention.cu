// Beam self-attention over a lane-addressed self cache for Hopper (sm_90a).
//
// Replaces: whisper_mlx_tpu/ops/beamflat_attention.py:beamflat_attention_kernel
// (_kernel), the fused form of ops/kv_quant.py:attention_int8_beamflat; with
// int_dot it computes that function's integer-dot branch (mxu=True, the beam
// default over quantized caches). Two more modes compute functions the
// reference leaves to XLA: the per-lane layout (ops/kv_quant.py:
// attention_int8_ancestry, decode_step(beam_ancestry=) over a per-lane cache)
// and the split mode (ops/kv_quant.py:attention_int8_shared, the shared-prefix
// beam scheme).
//
// Layouts (position-major, like the port's other caches). A window's g beam
// lanes each own a row per position; row (t, k) of a window's head is at
//   base(n, h) + t * stride_t + k * stride_k  (in rows):
//   flat     codes (n, H, T * g, 64) int8 or (n, H, T * g, 32) packed int4,
//            row t * g + k: stride_t = g, stride_k = 1
//   per-lane codes (n * g, H, T, ...), row (n g + k, h, t): stride_t = 1,
//            stride_k = H * T
//   scales (..., rows) bf16, addressed as the rows are
//   ancestry (n * g, T_anc) int32 in [0, g): lane owning position t of lane
//            b's hypothesis
// Query row b (window b / g) attends positions t <= pos, position t at row
// (t, ancestry[b, t]). The TPU kernel takes a precomputed (n, g, T * g)
// ancestry-and-causal mask and scans every column; exactly one column per
// (lane, position) is unmasked. Softmax over the masked columns equals
// softmax over those rows alone, and in the integer mode the absmax of w * vs
// is unchanged (the masked entries are 0).
//   fp mode:   s = (q . k) * ks in fp32; w = softmax(s); out = sum (w vs) v,
//              w vs kept to about 16 bits (a bf16 pair hi + lo on the mma)
//   int mode:  q re-quantized per row over d (absmax / 127, round half to
//              even, clip +-127); s = s32 * qs * ks with s32 an s8 x s8 -> s32
//              dot; w = softmax(s); wv = w * vs re-quantized over the row's
//              keys the same way; out = (sum w8 v, exact) * ws
//   split:     a per-window s_fill (device int32) splits the positions into
//              block S (t < s_fill) and block W (t >= s_fill). Block S is
//              the reference's single copy S (decoding/beam.py:_build_S and
//              its commits, which take the window's first lane): position t
//              reads row (t, ancestry[w g, t]) for every lane of window w.
//              Block W reads each lane's own rows. Each block has its own
//              max m and sum l of e = exp(s - m) and, in the int mode, its
//              own code scale of e * vs over its positions; out = (oS cS +
//              oW cW) / (lS cS + lW cW) with cX = exp(mX - max(mS, mW)), an
//              empty block at m = -1e30 (kv_quant.py:588-603). When the
//              device overflow flag is set, the launch computes the flat
//              function instead, through the flat mode's code.
//
// What bounds it on the H100: device-memory bytes, the distinct rows a
// window's lanes need: K and V codes (64 + 64 B int8, 32 + 32 B int4) and
// scales of each row once. A beam's lanes share most of their history (about
// 1.05 distinct rows a position at large-v3 beam 5), so a layer's step reads
// about 5 MB, 1.5 us at 3.35 TB/s; with every history distinct, g rows a
// position. The dots are 2 operations per code. At a beam step's sizes the
// time is a chain of dependent steps instead (launch, ancestry, rows, QK,
// softmax, PV), each one or two device-memory round trips or block barriers,
// and the instructions each step issues for every position and lane.
//
// Design: one block per (window, head) up to 256 live positions, a cluster
// of C blocks beyond (the plan, ops/beamflat_attention.py:beamflat_plan),
// block r taking positions [r * L / C, (r + 1) * L / C) of the L = pos + 1
// live ones, a thread a position: on the H100 a cluster's two exchanges
// cost more than splitting 256 positions saves. A pass serves up to 8 of the
// window's lanes (the mma's n), a warp each in the softmax. A block's span
// starts with its agreed run: the positions [0, ns) at which every lane of
// the pass reads one row. In the split it starts with block S (positions
// [0, ls), ls = s_fill - t0 clamped to the span), where a position's thread
// loads the one ancestry entry of the window's first lane (beside s_fill,
// which decides ls) and takes no part in the scan. In every mode it goes on
// over the positions at which the pass's lanes agree, up to the first
// disagreement, found by the scan's own barrier (a ballot a warp, the
// first one a block). The run's rows are slots [0, ns), slot j position j,
// and its tiles are padded to whole 16-row mma tiles. The other positions
// (W) go through the distinct-row scan: each finds the distinct rows its
// lanes use (a row and the set of lanes that use it), numbered in position
// order through a block scan after the run's tiles. After the scan's
// barrier each warp copies the run's rows of its 32 positions, then the
// block W's. Copies are cp.async, 16 B a
// piece of consecutive slots' rows, with the scales as 4-byte pairs, up to
// CAP rows a chunk (later chunks through the slot list, the whole block).
// QK takes the run's tiles as soon as their copies have landed, while W's
// may still be in flight.
// Both products run on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
// out) as in K3 (decode_attention.cu): codes become exact bf16x2 pairs, the
// lanes' queries (int mode: their int8 codes) the other operand. A run tile
// is a dense 16-position x 8-lane tile, each score every lane's, stored as
// it comes and read back in PV without a slot lookup; in a W tile a slot's
// score counts for the lanes that use it and for no other, so each (lane,
// position) gets exactly one score. The weights enter PV as bf16 (int mode:
// their codes, exact; fp mode: hi and lo halves, two products). Each block
// pushes its lanes' max, sum of exp(s - max) and (int mode) max of
// exp(s - max) * vs, one triple a block of the split (flat: block W alone),
// to every block of its cluster (a block alone: to itself) through
// distributed shared memory; after one barrier each combines them in block
// order and runs PV over its slots (the int split mode: S's tiles, which come
// first, then W's, two integer sums); in a cluster it pushes its partial
// outputs to their owner block, and after a second barrier each owner sums
// them in block order and writes. No atomics: a repeat is bit-equal.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include <algorithm>
#include <stdint.h>

#include "quant_tile.cuh"
#include "sm90_async.cuh"

namespace {

using namespace wmt_async;
using wmt_quant::dequant_bf16x2;
using wmt_quant::mma_16816;

constexpr int HD = 64;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_T = 2048;
constexpr int MAX_CLUSTER = 8;                // the portable cluster size
constexpr int MAX_SPAN = MAX_T / MAX_CLUSTER;  // most positions a block takes (8 bits)
constexpr int LANES = 8;                      // lanes of a pass: the mma's n, a warp each
constexpr int CAP = 512;                      // most rows a chunk holds
static_assert(WARPS == LANES, "the softmax statistics take one warp a lane");
static_assert(MAX_SPAN == THREADS, "a thread a position of the span");
constexpr unsigned FULL = 0xffffffffu;

// A slot (one distinct row of a block's span for a pass's lanes), packed:
// bits 0-7 its position in the span, 8-15 the lanes that use it, 16-31 the
// lane k that owns the row (row (t0 + position) * g + k).
__device__ __forceinline__ int slot_pos(uint32_t s) { return (int)(s & 0xffu); }
__device__ __forceinline__ uint32_t slot_lanes(uint32_t s) { return (s >> 8) & 0xffu; }
__device__ __forceinline__ int slot_owner(uint32_t s) { return (int)(s >> 16); }

struct Fixed {
  // QK's B: the lanes' q (int mode: their int8 codes) as bf16 in the mma's
  // dim order (qpos)
  alignas(16) __nv_bfloat16 qb[LANES][HD];
  float qscale[LANES];
  // pushed here by every block of the cluster: its (max, sum of exp(s - max),
  // int mode: max exp(s - max) vs) of each lane, for block S then block W
  float stat[MAX_CLUSTER][LANES][6];
  // a lane's factors to w (S, W), its code scales of w * vs (S, W) and the
  // int split mode's factors to the two integer sums (S, W)
  float row[LANES][6];
  int scan[WARPS];   // each warp's distinct rows
  int first[WARPS];  // each warp's first position where the pass's lanes disagree
};

constexpr int WSUM_FLOATS = WARPS * LANES * HD;  // a part's per-warp partial outputs
constexpr int POUT_FLOATS = LANES * HD + MAX_CLUSTER;  // a part's pushed partials

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// The block's arrays in dynamic shared memory, sized by the launch: `cap`
// rows a chunk (a multiple of 16), `span` positions (a multiple of 4),
// `slots` most slots a pass (distinct rows and the run's tile padding),
// `parts` partial outputs (2: the int split mode's two integer sums). The K
// chunk's room holds the warps' partial outputs and the pushed ones once QK
// is done.
struct Layout {
  int k, v, ksp, vsp, slot, s, vsl, wsum, pout, total;
  __host__ __device__ Layout(int bits, int cap, int span, int slots, int parts) {
    const int rowb = bits * HD / 8;
    const int outs = parts * (WSUM_FLOATS + POUT_FLOATS) * 4;
    k = round_up((int)sizeof(Fixed), 128);
    wsum = k;
    pout = k + parts * WSUM_FLOATS * 4;
    v = k + round_up(cap * rowb > outs ? cap * rowb : outs, 128);
    ksp = v + cap * rowb;   // each slot's K scale as the aligned bf16 pair holding it
    vsp = ksp + cap * 4;
    slot = vsp + cap * 4;
    s = slot + round_up(slots * 4, 16);  // [LANES][span]: scores, then exp, then weights
    vsl = s + LANES * span * 4;          // [LANES][span]: V scale of each lane's row
    total = vsl + LANES * span * 4;
  }
};

// Where a window's rows lie (in rows): base win * n + h * h_, row (t, k) at
// base + t * t_ + k * k_.
struct RowMap {
  long long n, h;
  int t, k;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

// Per-row symmetric int8 code of x under scale (absmax/127 recipe).
__device__ __forceinline__ float quantize_code(float x, float scale) {
  return fminf(fmaxf(rintf(x / scale), -127.f), 127.f);
}

// Codes to bf16x2 pairs for the mma, as in decode_attention.cu: the nibbles
// at bits 0-3 and 16-19 of x, offset by 8 (int4 codes and int8 high
// nibbles, after an xor with 0x88888888 or 0x80808080) or as they are (int8
// low nibbles, 0..15). Exact in bf16.
constexpr uint32_t BF16_ONE2 = 0x3F803F80u;    // (1, 1)
constexpr uint32_t BF16_M136 = 0xC308C308u;    // (-136, -136): 128 + u - 136 = u - 8
constexpr uint32_t BF16_M128 = 0xC300C300u;    // (-128, -128)

__device__ __forceinline__ uint32_t pair_signed(uint32_t x) {
  return dequant_bf16x2(x, BF16_ONE2, BF16_M136);
}

__device__ __forceinline__ uint32_t pair_low(uint32_t x) {
  return dequant_bf16x2(x, BF16_ONE2, BF16_M128);
}

// where dim d of a query row sits in qb: the order in which a lane's k-steps
// take the codes (decode_attention.cu:qpos)
template <int BITS>
__device__ __forceinline__ int qpos(int d) {
  return BITS == 4 ? (d & ~7) | (((d & 3) << 1) | ((d >> 2) & 1))
                   : (d & ~3) | (((d & 1) << 1) | ((d >> 1) & 1));
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// the bf16 of a scale pair that holds element e (its low bits suffice)
__device__ __forceinline__ float scale_of(uint32_t pair, uint32_t e) {
  return __uint_as_float(((e & 1u) ? pair >> 16 : pair & 0xffffu) << 16);
}

template <int BITS, bool INT_DOT>
__global__ void __launch_bounds__(THREADS, 2)
beamflat_attn_kernel(const __nv_bfloat16* __restrict__ q, const uint8_t* __restrict__ k,
                     const __nv_bfloat16* __restrict__ ks, const uint8_t* __restrict__ v,
                     const __nv_bfloat16* __restrict__ vs, const int* __restrict__ anc,
                     const int* __restrict__ s_fill, const uint8_t* __restrict__ overflow,
                     __nv_bfloat16* __restrict__ out, int n_head, RowMap map, int t_anc,
                     int group, int limit, int cap, int span, int slots_max, int parts,
                     long long scale_count) {
  constexpr int ROWB = BITS * HD / 8;
  constexpr int PIECES = ROWB / 16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Fixed& fx = *reinterpret_cast<Fixed*>(smem_raw);
  const Layout lay(BITS, cap, span, slots_max, parts);
  uint8_t* kbuf = smem_raw + lay.k;
  uint8_t* vbuf = smem_raw + lay.v;
  uint32_t* ksp = reinterpret_cast<uint32_t*>(smem_raw + lay.ksp);
  uint32_t* vsp = reinterpret_cast<uint32_t*>(smem_raw + lay.vsp);
  uint32_t* slot = reinterpret_cast<uint32_t*>(smem_raw + lay.slot);
  float* sc_s = reinterpret_cast<float*>(smem_raw + lay.s);
  float* vsl = reinterpret_cast<float*>(smem_raw + lay.vsl);
  float* wsum = reinterpret_cast<float*>(smem_raw + lay.wsum);  // [parts][WARPS][LANES][HD]
  float* pout = reinterpret_cast<float*>(smem_raw + lay.pout);  // [parts][POUT_FLOATS]

  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;
  const int cq = lane & 3;
  const int h = blockIdx.y;
  const int win = blockIdx.z;
  // the block's positions [t0, t0 + cnt): at least one, since C <= limit
  const int t0 = (int)((long long)rank * limit / csize);
  const int cnt = (int)((long long)(rank + 1) * limit / csize) - t0;
  const long long head = (long long)win * map.n + (long long)h * map.h;  // the head's base row
  const uint8_t* kh = k + head * ROWB;
  const uint8_t* vh = v + head * ROWB;
  // the split: block S is the block's positions [0, ls); the flat mode (no
  // s_fill, or the overflow flag set) is block W alone
  const int fill = s_fill != nullptr ? s_fill[win] : 0;  // loaded beside the flag
  const bool split = s_fill != nullptr && !(overflow != nullptr && overflow[0] != 0);
  const bool int_split = INT_DOT && split;
  const int ls = split ? min(max(fill - t0, 0), cnt) : 0;
  const int tl = tid;  // the thread's position in the span
  const bool live = tl < cnt;
  // a slot's row, relative to the head's base
  auto slot_row = [&](uint32_t sl) {
    return (long long)(t0 + slot_pos(sl)) * map.t + (long long)slot_owner(sl) * map.k;
  };
  // slots [lo, hi) of the chunk from slot j0 (none when lo >= hi), their
  // rows read from the slot list, by `n` threads of which this is `me`:
  // 16-byte pieces of consecutive slots' rows, K's codes and both scale
  // pairs (keys) or V's codes, one copy group. Every thread commits four
  // groups in chunk 0 of a pass: the run's K and V (a warp each 32
  // positions), then W's (the block), so that QK can take the run's tiles
  // while W's copies are in flight. A slot's word must be visible to the
  // copying threads.
  auto issue = [&](int j0, int lo, int hi, bool keys, int me, int n) {
    uint8_t* dst = keys ? kbuf : vbuf;
    const uint8_t* src = keys ? kh : vh;
    for (int i = me; i < (hi - lo) * PIECES; i += n) {
      const int j = lo + i / PIECES;
      const int p = i % PIECES;
      cp_async16(dst + (j - j0) * ROWB + p * 16, src + slot_row(slot[j]) * ROWB + p * 16, true);
    }
    if (keys) {
      for (int j = lo + me; j < hi; j += n) {
        const long long e2 = (head + slot_row(slot[j])) & ~1LL;
        const int sb = e2 + 1 < scale_count ? 4 : 2;
        cp_async4_part(&ksp[j - j0], ks + e2, sb);
        cp_async4_part(&vsp[j - j0], vs + e2, sb);
      }
    }
    cp_async_commit();
  };
  if (csize > 1) cluster_arrive_relaxed();  // waited before the first push to another block

  for (int r0 = 0; r0 < group; r0 += LANES) {
    const int nr = min(LANES, group - r0);
    const int lane0 = win * group + r0;  // the pass's first query row
    const uint32_t all = (1u << nr) - 1u;
    if (r0 > 0) __syncthreads();  // the last pass is done with the chunk buffers
    auto q_off = [&](int rr) { return ((size_t)(lane0 + rr) * n_head + h) * HD; };

    // the pass's queries, lane `warp`'s two dims a thread, loaded now so
    // that they travel with the ancestry loads
    __nv_bfloat16 qv[2];
    if (warp < nr) {
      qv[0] = q[q_off(warp) + lane];
      qv[1] = q[q_off(warp) + lane + 32];
    }

    // the window's first lane's ancestry entry, loaded beside s_fill: block
    // S of the split reads that one entry a position and no other
    const int lead = live ? anc[(size_t)win * group * t_anc + t0 + tl] : -1;
    const bool in_s = tl < ls;
    // the rest of the span: the pass's lanes' ancestry, the distinct rows
    // they use (a slot each), numbered in position order by a block scan
    // after the agreed run's tiles; the same barrier finds where the run
    // ends, the first position at which the pass's lanes disagree
    const bool scanned = live && !in_s;
    int a[LANES];
    uint32_t first = 0u;  // bit r: lane r is the first lane using its row
    uint32_t users[LANES];
    int count = 0;
#pragma unroll
    for (int r = 0; r < LANES; ++r) {
      a[r] = -1;
      users[r] = 0u;
      if (r < nr && scanned) {
        a[r] = r == 0 && r0 == 0 ? lead : anc[(size_t)(lane0 + r) * t_anc + t0 + tl];
      }
    }
    bool agree = true;
#pragma unroll
    for (int r = 1; r < LANES; ++r) agree = agree && (r >= nr || a[r] == a[0]);
    if (scanned && agree) {  // one row for every lane
      first = 1u;
      count = 1;
      users[0] = all;
    } else if (scanned) {
#pragma unroll
      for (int r = 0; r < LANES; ++r) {
        bool is_first = r < nr;
#pragma unroll
        for (int r2 = 0; r2 < r; ++r2) is_first = is_first && a[r2] != a[r];
        if (is_first) {
          first |= 1u << r;
          ++count;
          uint32_t m = 0u;
#pragma unroll
          for (int r2 = r; r2 < LANES; ++r2) m |= (r2 < nr && a[r2] == a[r]) ? 1u << r2 : 0u;
          users[r] = m;
        }
      }
    }
    int x = count;  // inclusive scan over the warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL, x, off);
      if (lane >= off) x += y;
    }
    const uint32_t apart = __ballot_sync(FULL, scanned && !agree);
    if (lane == 31) fx.scan[warp] = x;
    if (lane == 0) fx.first[warp] = apart ? warp * 32 + __ffs(apart) - 1 : THREADS;
    __syncthreads();
    int before = 0;  // the distinct rows of the warps before this one
    int total = 0;
    int run = THREADS;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      before += w < warp ? fx.scan[w] : 0;
      total += fx.scan[w];
      run = min(run, fx.first[w]);
    }
    // the agreed run: positions [0, ns) (block S's, which are never apart,
    // then W's up to the first disagreement), slot j position j, padded to
    // the run's tiles, slots [0, ns16)
    const int ns = min(run, cnt);
    const int ns16 = round_up(ns, 16);
    // W's first slot, less the rows the scan counted in the run (one a position)
    const int base = ns16 - (ns - ls);
    const int n_slots = base + total;
    if (tl < ns) {
      slot[tl] = (uint32_t)tl | (all << 8) | ((uint32_t)(in_s ? lead : a[0]) << 16);
    } else if (scanned) {
      int at = base + before + x - count;
#pragma unroll
      for (int r = 0; r < LANES; ++r) {
        if (first & (1u << r)) {
          slot[at++] = (uint32_t)tl | (users[r] << 8) | ((uint32_t)a[r] << 16);
        }
      }
    }
    __syncwarp();
    const int r_lo = 32 * warp;  // the warp's run positions: slots [r_lo, r_hi)
    const int r_hi = min(r_lo + 32, ns);
    issue(0, r_lo, r_hi, true, lane, 32);
    issue(0, r_lo, r_hi, false, lane, 32);
    // W's slots of chunk 0, spread over the block once every word is written
    const int w_hi = min(cap, n_slots);
    if (w_hi > ns16) __syncthreads();
    issue(0, ns16, w_hi, true, tid, THREADS);
    issue(0, ns16, w_hi, false, tid, THREADS);
    const int n_chunks = (n_slots + cap - 1) / cap;

    // the queries into qb (int mode: each lane's int8 codes and scale)
    if (warp < nr) {
      if constexpr (INT_DOT) {
        const float x0 = __bfloat162float(qv[0]);
        const float x1 = __bfloat162float(qv[1]);
        const float amax = warp_max(fmaxf(fabsf(x0), fabsf(x1)));
        const float qs = fmaxf(amax, 1e-30f) / 127.f;
        fx.qb[warp][qpos<BITS>(lane)] = __float2bfloat16(quantize_code(x0, qs));
        fx.qb[warp][qpos<BITS>(lane + 32)] = __float2bfloat16(quantize_code(x1, qs));
        if (lane == 0) fx.qscale[warp] = qs;
      } else {
        fx.qb[warp][qpos<BITS>(lane)] = qv[0];
        fx.qb[warp][qpos<BITS>(lane + 32)] = qv[1];
      }
    }
    // the run's copies (the first two groups) landed, every slot word written
    cp_async_wait(2);
    __syncthreads();

    // QK on the tensor cores, chunk by chunk: S (16 slots x 8 lanes) += K
    // (16 slots x 16 dims) Q^T, warp w taking slot tiles w, w + 8, ... (the
    // operand layout of decode_attention.cu). A run tile's scores are every
    // lane's; a W slot's score is kept for each lane that uses it: one score
    // a (lane, position).
    uint32_t bq[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
    if (gq < nr) {
      const uint4* p = reinterpret_cast<const uint4*>(&fx.qb[gq][16 * cq]);
      const uint4 u0 = p[0];
      const uint4 u1 = p[1];
      bq[0] = u0.x, bq[1] = u0.y, bq[2] = u0.z, bq[3] = u0.w;
      bq[4] = u1.x, bq[5] = u1.y, bq[6] = u1.z, bq[7] = u1.w;
    }
    // tile kt of the chunk from j0 (n slots)
    auto qk_tile = [&](int j0, int n, int kt) {
      const uint8_t* ra = kbuf + (16 * kt + gq) * ROWB;  // slot gq of the tile
      const uint8_t* rb = ra + 8 * ROWB;                 // slot gq + 8
      float sc[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (BITS == 4) {
        const uint2 u0 = *reinterpret_cast<const uint2*>(ra + 8 * cq);
        const uint2 u1 = *reinterpret_cast<const uint2*>(rb + 8 * cq);
        const uint32_t w0[2] = {u0.x ^ 0x88888888u, u0.y ^ 0x88888888u};
        const uint32_t w1[2] = {u1.x ^ 0x88888888u, u1.y ^ 0x88888888u};
#pragma unroll
        for (int st = 0; st < 4; ++st) {
          const int j = st >> 1;
          const int sh = 8 * (st & 1);
          mma_16816(sc, pair_signed(w0[j] >> sh), pair_signed(w1[j] >> sh),
                    pair_signed(w0[j] >> (sh + 4)), pair_signed(w1[j] >> (sh + 4)), bq[2 * st],
                    bq[2 * st + 1]);
        }
      } else {
        const uint4 u0 = *reinterpret_cast<const uint4*>(ra + 16 * cq);
        const uint4 u1 = *reinterpret_cast<const uint4*>(rb + 16 * cq);
        const uint32_t w0[4] = {u0.x ^ 0x80808080u, u0.y ^ 0x80808080u, u0.z ^ 0x80808080u,
                                u0.w ^ 0x80808080u};
        const uint32_t w1[4] = {u1.x ^ 0x80808080u, u1.y ^ 0x80808080u, u1.z ^ 0x80808080u,
                                u1.w ^ 0x80808080u};
        float hi[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int st = 0; st < 4; ++st) {
          mma_16816(sc, pair_low(w0[st]), pair_low(w1[st]), pair_low(w0[st] >> 8),
                    pair_low(w1[st] >> 8), bq[2 * st], bq[2 * st + 1]);
          mma_16816(hi, pair_signed(w0[st] >> 4), pair_signed(w1[st] >> 4),
                    pair_signed(w0[st] >> 12), pair_signed(w1[st] >> 12), bq[2 * st],
                    bq[2 * st + 1]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[i] = fmaf(16.f, hi[i], sc[i]);
      }
      // sc: slots gq (0, 1) and gq + 8 (2, 3) at lanes 2 cq, 2 cq + 1
      if (j0 + 16 * kt < ns16) {  // a run tile: slot j is position j for every lane
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = 16 * kt + gq + 8 * half;
          if (j < ns) {
            const uint32_t e = (uint32_t)head + (uint32_t)(t0 + j) * (uint32_t)map.t +
                               (uint32_t)slot_owner(slot[j]) * (uint32_t)map.k;
            const float kscale = scale_of(ksp[j], e);
            const float vscale = scale_of(vsp[j], e);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int rr = 2 * cq + i;
              if (rr < nr) {
                const float x = sc[2 * half + i];
                sc_s[rr * span + j] = INT_DOT ? x * fx.qscale[rr] * kscale : x * kscale;
                vsl[rr * span + j] = vscale;
              }
            }
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = 16 * kt + gq + (i >> 1) * 8;
          const int rr = 2 * cq + (i & 1);
          if (rr < nr && j < n) {
            const uint32_t sl = slot[j0 + j];
            if (slot_lanes(sl) & (1u << rr)) {
              const int t = slot_pos(sl);
              const uint32_t e = (uint32_t)(head + slot_row(sl));
              const float kscale = scale_of(ksp[j], e);
              sc_s[rr * span + t] = INT_DOT ? sc[i] * fx.qscale[rr] * kscale : sc[i] * kscale;
              vsl[rr * span + t] = scale_of(vsp[j], e);
            }
          }
        }
      }
    };
    // chunk 0: the run's tiles, then W's once their K has landed (V may be
    // in flight)
    const int n0 = min(cap, n_slots);
    for (int kt = warp; kt * 16 < ns16; kt += WARPS) qk_tile(0, n0, kt);
    if (n0 > ns16) {
      cp_async_wait(1);
      __syncthreads();
      for (int kt = ns16 / 16 + warp; kt * 16 < n0; kt += WARPS) qk_tile(0, n0, kt);
    }
    for (int c = 1; c < n_chunks; ++c) {
      const int j0 = c * cap;
      const int n = min(cap, n_slots - j0);
      __syncthreads();  // every warp is done with the last chunk's K
      issue(j0, j0, j0 + n, true, tid, THREADS);
      cp_async_wait(0);
      __syncthreads();
      for (int kt = warp; kt * 16 < n; kt += WARPS) qk_tile(j0, n, kt);
    }
    __syncthreads();

    // softmax: warp rr takes lane rr, over the block's span: for each block
    // of the split (S: positions [0, ls), W: the rest) its max, its sum of
    // exp(s - max) (the exps kept) and, int mode, its max of exp(s - max) *
    // vs, pushed to every block of the cluster (a block alone: to itself);
    // one barrier; each block combines them in block order into factors a
    // lane, w = exp(s - its max) * f, and the int mode's code scales, then
    // forms its weights w vs (int mode: their codes). The flat mode is
    // block W alone: the same code with ls = 0.
    if (csize > 1 && r0 == 0) cluster_wait();  // every block of the cluster has started
    if (warp < nr) {
      float* srow = sc_s + warp * span;
      const float* vrow = vsl + warp * span;
      float m0 = -INFINITY;
      float m1 = -INFINITY;
      for (int t = lane; t < cnt; t += 32) {
        if (t < ls) {
          m0 = fmaxf(m0, srow[t]);
        } else {
          m1 = fmaxf(m1, srow[t]);
        }
      }
      m0 = warp_max(m0);
      m1 = warp_max(m1);
      float l0 = 0.f, l1 = 0.f, a0 = 0.f, a1 = 0.f;
      for (int t = lane; t < cnt; t += 32) {
        const bool in_s = t < ls;
        const float p = expf(srow[t] - (in_s ? m0 : m1));
        srow[t] = p;
        if (in_s) {
          l0 += p;
          if constexpr (INT_DOT) a0 = fmaxf(a0, p * vrow[t]);
        } else {
          l1 += p;
          if constexpr (INT_DOT) a1 = fmaxf(a1, p * vrow[t]);
        }
      }
      l0 = warp_sum(l0);
      l1 = warp_sum(l1);
      if constexpr (INT_DOT) {
        a0 = warp_max(a0);
        a1 = warp_max(a1);
      }
      if (lane < csize) {
        float* dst = cluster.map_shared_rank(&fx.stat[rank][warp][0], lane);
        dst[0] = m0;
        dst[1] = l0;
        dst[2] = a0;
        dst[3] = m1;
        dst[4] = l1;
        dst[5] = a1;
      }
    }
    if (csize > 1) {
      cluster.sync();
    } else {
      __syncthreads();
    }
    if (tid < nr) {
      float m[2], l[2], amax[2], own[2];
#pragma unroll
      for (int part = 0; part < 2; ++part) {
        m[part] = -INFINITY;
        for (int src = 0; src < csize; ++src) m[part] = fmaxf(m[part], fx.stat[src][tid][3 * part]);
        l[part] = 0.f;
        amax[part] = 0.f;
        for (int src = 0; src < csize; ++src) {  // block 0 first: a fixed order
          const float ms = fx.stat[src][tid][3 * part];
          const float f = ms == -INFINITY ? 0.f : expf(ms - m[part]);
          l[part] += fx.stat[src][tid][3 * part + 1] * f;
          amax[part] = fmaxf(amax[part], fx.stat[src][tid][3 * part + 2] * f);
        }
        // this block's exp(s - its max) to exp(s - the block's max)
        const float mine = fx.stat[rank][tid][3 * part];
        own[part] = mine == -INFINITY ? 0.f : expf(mine - m[part]);
      }
      if (!split) {  // w = exp(s - m) / l
        fx.row[tid][1] = own[1] / l[1];
        fx.row[tid][3] = fmaxf(amax[1] / l[1], 1e-30f) / 127.f;  // int mode: the absmax of w * vs
      } else {
        // the two blocks' merge (kv_quant.py:_merge_two_block)
        const float ms0 = m[0] == -INFINITY ? -1e30f : m[0];
        const float ms1 = m[1] == -INFINITY ? -1e30f : m[1];
        const float mm = fmaxf(ms0, ms1);
        const float c0 = expf(ms0 - mm);
        const float c1 = expf(ms1 - mm);
        const float denom = l[0] * c0 + l[1] * c1;
        if constexpr (INT_DOT) {  // each block's e vs coded on its own scale
          fx.row[tid][0] = own[0];
          fx.row[tid][1] = own[1];
          fx.row[tid][2] = fmaxf(amax[0], 1e-30f) / 127.f;
          fx.row[tid][3] = fmaxf(amax[1], 1e-30f) / 127.f;
          fx.row[tid][4] = fx.row[tid][2] * c0 / denom;
          fx.row[tid][5] = fx.row[tid][3] * c1 / denom;
        } else {  // one weighted sum: each block's weights carry its share
          fx.row[tid][0] = own[0] * c0 / denom;
          fx.row[tid][1] = own[1] * c1 / denom;
        }
      }
    }
    __syncthreads();
    for (int t = tid; t < cnt; t += THREADS) {
      const int part = t < ls ? 0 : 1;
#pragma unroll
      for (int rr = 0; rr < LANES; ++rr) {
        if (rr < nr) {
          const float wv = sc_s[rr * span + t] * fx.row[rr][part] * vsl[rr * span + t];
          sc_s[rr * span + t] = INT_DOT ? quantize_code(wv, fx.row[rr][2 + part]) : wv;
        }
      }
    }

    // PV on the tensor cores, chunk by chunk: O^T (16 dims x 8 lanes) += V^T
    // (16 dims x 16 slots) W^T, warp w taking slot tiles w, w + 8, ... Lane
    // (gq, cq) holds A of its dims 8 gq .. 8 gq + 7 at slots 2 cq, 2 cq + 1,
    // 2 cq + 8, 2 cq + 9 of the tile (decode_attention.cu's layout) and B of
    // lane gq's weights at those slots: in a run tile its weight at that
    // position, in a W tile its weight where it uses the slot, else 0. Exact
    // products, fp32 sums (exact in the integer mode). The int split mode
    // sums block S's positions, in chunk 0's first run tiles, and block W's
    // apart (a run tile holding both, twice, each time with one block's
    // weights).
    float acc[4][4];
    float acch[4][4];
    auto zero_acc = [&]() {
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[tt][i] = acch[tt][i] = 0.f;
      }
    };
    zero_acc();
    // tile kt's product into acc, lane gq's weights at its slots kb0, kb0 + 1,
    // kb0 + 8 and kb0 + 9 (kb0 = 16 kt + 2 cq) given
    auto pv_tile = [&](int kt, const float (&w4)[4]) {
      const int kb0 = 16 * kt + 2 * cq;
      uint32_t b0[2], b1[2];  // [0]: the weights (int mode: codes); [1]: fp mode's low halves
      b0[0] = bf16_pair(w4[0], w4[1]);
      b1[0] = bf16_pair(w4[2], w4[3]);
      if constexpr (!INT_DOT) {
        float lo4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) lo4[i] = w4[i] - __bfloat162float(__float2bfloat16(w4[i]));
        b0[1] = bf16_pair(lo4[0], lo4[1]);
        b1[1] = bf16_pair(lo4[2], lo4[3]);
      }
      constexpr int PARTS = INT_DOT ? 1 : 2;
      const int keys[4] = {kb0, kb0 + 1, kb0 + 8, kb0 + 9};
      if constexpr (BITS == 4) {
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          w[i] = *reinterpret_cast<const uint32_t*>(vbuf + keys[i] * ROWB + 4 * gq) ^ 0x88888888u;
        }
#pragma unroll
        for (int tt = 0; tt < 4; ++tt) {  // byte tt of the word: dims 8 gq + 2 tt, + 1
          const uint32_t sel = (uint32_t)tt | ((uint32_t)(4 + tt) << 8);
          const uint32_t p01 = __byte_perm(w[0], w[1], sel);
          const uint32_t p89 = __byte_perm(w[2], w[3], sel);
#pragma unroll
          for (int part = 0; part < PARTS; ++part) {
            mma_16816(acc[tt], pair_signed(p01), pair_signed(p01 >> 4), pair_signed(p89),
                      pair_signed(p89 >> 4), b0[part], b1[part]);
          }
        }
      } else {
        uint2 w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint2 u = *reinterpret_cast<const uint2*>(vbuf + keys[i] * ROWB + 8 * gq);
          w[i] = make_uint2(u.x ^ 0x80808080u, u.y ^ 0x80808080u);
        }
#pragma unroll
        for (int tt = 0; tt < 4; ++tt) {  // bytes 2 tt (dim 8 gq + 2 tt) and 2 tt + 1
          const int bb = 2 * (tt & 1);
          const uint32_t sa = (uint32_t)bb | ((uint32_t)(4 + bb) << 8);
          const uint32_t sb = (uint32_t)(bb + 1) | ((uint32_t)(5 + bb) << 8);
          const uint32_t x0 = tt < 2 ? w[0].x : w[0].y, x1 = tt < 2 ? w[1].x : w[1].y;
          const uint32_t x8 = tt < 2 ? w[2].x : w[2].y, x9 = tt < 2 ? w[3].x : w[3].y;
          const uint32_t pa = __byte_perm(x0, x1, sa), pb = __byte_perm(x0, x1, sb);
          const uint32_t qa = __byte_perm(x8, x9, sa), qb = __byte_perm(x8, x9, sb);
#pragma unroll
          for (int part = 0; part < PARTS; ++part) {
            mma_16816(acc[tt], pair_low(pa), pair_low(pb), pair_low(qa), pair_low(qb),
                      b0[part], b1[part]);
            mma_16816(acch[tt], pair_signed(pa >> 4), pair_signed(pb >> 4),
                      pair_signed(qa >> 4), pair_signed(qb >> 4), b0[part], b1[part]);
          }
        }
      }
    };
    // the run's tiles holding positions [lo, hi), with the weights of those
    // positions alone: slot j is position j for every lane
    auto pv_run = [&](int lo, int hi) {
      for (int kt = lo / 16 + warp; kt * 16 < hi; kt += WARPS) {
        const int kb0 = 16 * kt + 2 * cq;
        const int keys[4] = {kb0, kb0 + 1, kb0 + 8, kb0 + 9};
        float w4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          w4[i] = gq < nr && keys[i] >= lo && keys[i] < hi ? sc_s[gq * span + keys[i]] : 0.f;
        }
        pv_tile(kt, w4);
      }
    };
    // W's tiles of the chunk from j0 (n slots), from tile kt0 on: lane gq's
    // weight where it uses the slot, else 0
    auto pv_w = [&](int j0, int n, int kt0) {
      auto weight = [&](int j) -> float {
        if (gq >= nr || j >= n) return 0.f;
        const uint32_t sl = slot[j0 + j];
        return (slot_lanes(sl) & (1u << gq)) ? sc_s[gq * span + slot_pos(sl)] : 0.f;
      };
      for (int kt = kt0 + warp; kt * 16 < n; kt += WARPS) {
        const int kb0 = 16 * kt + 2 * cq;
        const float w4[4] = {weight(kb0), weight(kb0 + 1), weight(kb0 + 8), weight(kb0 + 9)};
        pv_tile(kt, w4);
      }
    };
    // acc[tt]: dims 8 gq + 2 tt (0, 1) and + 1 (2, 3) at lanes 2 cq, 2 cq + 1;
    // the warps' partials of sum `part` go where the K chunk was (QK is done)
    auto flush = [&](int part) {
      float* dst = wsum + part * WSUM_FLOATS;
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int rr = 2 * cq + (i & 1);
          if (rr < nr) {
            const float o = BITS == 8 ? fmaf(16.f, acch[tt][i], acc[tt][i]) : acc[tt][i];
            dst[(warp * LANES + rr) * HD + 8 * gq + 2 * tt + (i >> 1)] =
                INT_DOT ? __int_as_float(__float2int_rn(o)) : o;
          }
        }
      }
    };
    for (int c = 0; c < n_chunks; ++c) {
      const int j0 = c * cap;
      const int n = min(cap, n_slots - j0);
      if (c > 0) {
        __syncthreads();  // every warp is done with the last chunk's V
        issue(j0, j0, j0 + n, false, tid, THREADS);
      }
      cp_async_wait(0);
      __syncthreads();
      if (c == 0) {
        if (int_split) {  // block S's sum to the partials, then W's run
          pv_run(0, ls);
          flush(0);
          zero_acc();
          pv_run(ls, ns);
        } else {
          pv_run(0, ns);
        }
      }
      pv_w(j0, n, c == 0 ? ns16 / 16 : 0);
    }
    const int n_sums = int_split ? 2 : 1;
    flush(n_sums - 1);
    __syncthreads();
    // the block's integer (int mode) or fp sum `part` of lane rr, dim d: its
    // warps' partials in warp order
    auto block_out = [&](int part, int rr, int d) {
      const float* src = wsum + part * WSUM_FLOATS;
      if constexpr (INT_DOT) {
        int io = 0;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) io += __float_as_int(src[(w * LANES + rr) * HD + d]);
        return __int_as_float(io);
      } else {
        float o = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) o += src[(w * LANES + rr) * HD + d];
        return o;
      }
    };
    // lane rr's output from its sums (int mode: integers as floats' bits)
    auto finish = [&](int rr, float o0, float o1) {
      if constexpr (INT_DOT) {
        return int_split ? (float)__float_as_int(o0) * fx.row[rr][4] +
                               (float)__float_as_int(o1) * fx.row[rr][5]
                         : (float)__float_as_int(o0) * fx.row[rr][3];
      } else {
        return o0;
      }
    };
    if (csize == 1) {  // the whole span in one block: write
      for (int e = tid; e < nr * HD; e += THREADS) {
        const int rr = e / HD;
        const float o1 = int_split ? block_out(1, rr, e % HD) : 0.f;
        out[q_off(rr) + e % HD] = __float2bfloat16(finish(rr, block_out(0, rr, e % HD), o1));
      }
      continue;
    }
    // output e = lane * HD + d belongs to block e % C: every block pushes its
    // partials into the owner's slots, one cluster barrier, and each owner
    // sums its slots in block order and writes. After the barrier no block
    // reads another's shared memory, so none waits for the others to leave.
    const int owned = (nr * HD + csize - 1) / csize;
    for (int e = tid; e < nr * HD; e += THREADS) {
      float* dst = cluster.map_shared_rank(pout, e % csize);
      for (int part = 0; part < n_sums; ++part) {
        dst[part * POUT_FLOATS + rank * owned + e / csize] = block_out(part, e / HD, e % HD);
      }
    }
    cluster.sync();
    for (int i = tid; i < owned; i += THREADS) {
      const int e = i * csize + rank;
      if (e < nr * HD) {
        float o[2] = {0.f, 0.f};
        for (int part = 0; part < n_sums; ++part) {
          if constexpr (INT_DOT) {
            int io = 0;
            for (int src = 0; src < csize; ++src) {
              io += __float_as_int(pout[part * POUT_FLOATS + src * owned + i]);
            }
            o[part] = __int_as_float(io);
          } else {
            for (int src = 0; src < csize; ++src) {
              o[part] += pout[part * POUT_FLOATS + src * owned + i];
            }
          }
        }
        out[q_off(e / HD) + e % HD] = __float2bfloat16(finish(e / HD, o[0], o[1]));
      }
    }
  }
}

template <int BITS, bool INT_DOT>
cudaError_t launch(dim3 grid, int cluster, int smem, cudaStream_t s, const void* q,
                   const void* k, const void* ks, const void* v, const void* vs,
                   const void* anc, const void* s_fill, const void* overflow, void* out,
                   int n_head, RowMap map, int t_anc, int group, int limit, int cap, int span,
                   int slots, int parts, long long scale_count) {
  return launch_cluster<beamflat_attn_kernel<BITS, INT_DOT>>(
      grid, THREADS, smem, cluster, s, (const __nv_bfloat16*)q, (const uint8_t*)k,
      (const __nv_bfloat16*)ks, (const uint8_t*)v, (const __nv_bfloat16*)vs, (const int*)anc,
      (const int*)s_fill, (const uint8_t*)overflow, (__nv_bfloat16*)out, n_head, map, t_anc,
      group, limit, cap, span, slots, parts, scale_count);
}

}  // namespace

// cluster: blocks a (window, head) and cap: rows a chunk, from
// ops/beamflat_attention.py:beamflat_plan. t_pos: positions a lane in the
// cache (flat: rows / group). per_lane: the (n g, H, T, ...) layout instead
// of the flat one. s_fill: null, or (n,) int32 for the split mode, with
// overflow null or one byte (a bool) that turns the split off.
extern "C" int wmt_beamflat_attention(const void* q, const void* k, const void* ks,
                                      const void* v, const void* vs, const void* anc,
                                      const void* s_fill, const void* overflow, void* out,
                                      int nb, int n_head, int t_pos, int t_anc, int group,
                                      int limit, int bits, int int_dot, int per_lane,
                                      int cluster, int cap, void* stream) {
  if (group < 1 || group > 65535 || nb < 1 || nb % group != 0 || nb / group > 65535 ||
      n_head < 1 || n_head > 65535 || t_pos < 1 || limit < 1 || limit > t_pos ||
      limit > t_anc || limit > MAX_T || cluster < 1 || cluster > MAX_CLUSTER ||
      cluster > limit || (limit + cluster - 1) / cluster > MAX_SPAN || cap < 16 || cap > CAP ||
      cap % 16 != 0 || (bits != 4 && bits != 8) || (overflow != nullptr && s_fill == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int most = (limit + cluster - 1) / cluster;  // the longest span
  const int span = round_up(most, 4);
  const int slots = most * std::min(group, LANES) + 16;  // with the run's tile padding
  const int parts = s_fill != nullptr && int_dot ? 2 : 1;
  const int smem = Layout(bits, cap, span, slots, parts).total;
  const dim3 grid(cluster, n_head, nb / group);
  const long long t_rows = (long long)t_pos * group;  // a head's rows of a window
  const RowMap map = per_lane ? RowMap{t_rows * n_head, t_pos, 1, n_head * t_pos}
                              : RowMap{t_rows * n_head, t_rows, group, 1};
  const long long scale_count = (long long)nb * n_head * t_pos;
  const cudaStream_t s = (cudaStream_t)stream;
#define WMT_BF(B, I)                                                                          \
  launch<B, I>(grid, cluster, smem, s, q, k, ks, v, vs, anc, s_fill, overflow, out, n_head, map, \
               t_anc, group, limit, cap, span, slots, parts, scale_count)
  cudaError_t e;
  if (bits == 8) {
    e = int_dot ? WMT_BF(8, true) : WMT_BF(8, false);
  } else {
    e = int_dot ? WMT_BF(4, true) : WMT_BF(4, false);
  }
#undef WMT_BF
  return (int)e;
}
